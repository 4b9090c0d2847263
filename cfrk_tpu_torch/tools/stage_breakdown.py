"""Stage breakdown of the per-read main path on one file.

    python -m cfrk_tpu_torch.tools.stage_breakdown IN.fasta OUT.cfrk K \
        [--canonical] [--nonzero] [--device cuda|cpu]

Runs the calls of ``pipeline/count.count_file_sparse_rows`` one by one
and prints one JSON object:

* ``host_s`` — host wall seconds of each stage (``time.perf_counter``,
  with a ``torch.cuda.synchronize`` after each device stage, so a stage
  holds its own device work): parse, pad, h2d, rows (the dispatcher,
  wrapper and kernel), drain (narrow + device→host copy), format (the
  `.cfrk` writer), and ``wall`` over all of them;
* ``device_ms`` — on a CUDA device, a second pass of the device stages
  (h2d, rows, drain) under ``torch.profiler``, summed by kind from the
  card's own events: the rowsort kernels, other kernels (the narrowing
  casts), host→device and device→host copies, and ``busy``, the union
  of all device intervals;
* ``device_busy_share`` — ``busy`` over the first pass's wall: the share
  of the main path's run in which the card does any work.

On the CPU the device fields are null.  The output file is written by
the first pass and equals the CLI's output for the same arguments.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..cli import _resolve_device
from ..format import CfrkWriter
from ..io.fasta import read_fasta_encoded
from ..ops.perread_sparse import count_perread_rows, narrow_for_fetch, pairs_to_host
from ..pipeline.batch import iter_batches
from ..pipeline.count import _plan_shapes

__all__ = ["stage_breakdown"]


def _device_ms(batches, device, k: int, canonical: bool) -> dict:
    """Device time by kind over one pass of the device stages, from the
    profiler's CUDA events (µs → ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            codes = torch.from_numpy(batch.codes).to(device)
            pairs_to_host(narrow_for_fetch(count_perread_rows(codes, k, canonical), k),
                          batch.n_reads)
        torch.cuda.synchronize()
    spans = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    if not spans:
        raise RuntimeError("torch.profiler recorded no device events")
    out = dict.fromkeys(("rowsort_kernels", "other_kernels", "h2d", "d2h"), 0.0)
    for ev in spans:
        if ev.name.startswith("Memcpy HtoD"):
            kind = "h2d"
        elif ev.name.startswith("Memcpy DtoH"):
            kind = "d2h"
        elif "rowsort" in ev.name:
            kind = "rowsort_kernels"
        else:
            kind = "other_kernels"
        out[kind] += ev.time_range.elapsed_us() / 1e3
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((ev.time_range.start, ev.time_range.end) for ev in spans):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    out["busy"] = busy / 1e3
    return out


def stage_breakdown(path, out_path, k: int, *, device, canonical: bool = False,
                    nonzero: bool = True) -> dict:
    """The stage times of one main-path run (see the module docstring)."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    host = dict.fromkeys(("parse", "pad", "h2d", "rows", "drain", "format"), 0.0)
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    reads = read_fasta_encoded(path)
    host["parse"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bs, ml = _plan_shapes(reads, k, None, None)
    batches = list(iter_batches(reads, bs, ml))
    host["pad"] = time.perf_counter() - t0
    with CfrkWriter(out_path) as w:
        for batch in batches:
            t0 = time.perf_counter()
            codes = torch.from_numpy(batch.codes).to(device)
            sync()
            t1 = time.perf_counter()
            rows = count_perread_rows(codes, k, canonical)
            sync()
            t2 = time.perf_counter()
            idx, counts = pairs_to_host(narrow_for_fetch(rows, k), batch.n_reads)
            t3 = time.perf_counter()
            if nonzero:
                w.write_pairs(idx, counts)
            else:
                w.write_pairs_dense(idx, counts, 4**k)
            t4 = time.perf_counter()
            host["h2d"] += t1 - t0
            host["rows"] += t2 - t1
            host["drain"] += t3 - t2
            host["format"] += t4 - t3
    host["wall"] = time.perf_counter() - t_all
    bases = sum(len(r) for r in reads)
    dev = _device_ms(batches, device, k, canonical) if cuda else None
    return {
        "reads": len(reads),
        "bases": bases,
        "batches": len(batches),
        "k": k,
        "canonical": canonical,
        "nonzero": nonzero,
        "host_s": host,
        "bases_per_s": bases / host["wall"],
        "device_ms": dev,
        "device_busy_share": dev["busy"] / 1e3 / host["wall"] if dev else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("k", type=int)
    ap.add_argument("--canonical", action="store_true")
    ap.add_argument("--nonzero", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    res = stage_breakdown(args.input, args.output, args.k,
                          device=_resolve_device(args.device),
                          canonical=args.canonical, nonzero=args.nonzero)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
