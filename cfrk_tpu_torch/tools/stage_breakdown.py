"""Stage breakdown of one CLI run on one file.

    python -m cfrk_tpu_torch.tools.stage_breakdown IN.fasta OUT K \
        [--mode perread|spectrum|sparse] [--canonical] [--nonzero] \
        [--impl IMPL] [--spectrum-format FMT] [--device cuda|cpu]

Runs the calls of the mode's driver in ``pipeline/count.py`` one by one
and prints one JSON object:

* ``route`` — ``perread`` (per-read sort + RLE rows), ``dense_rows``
  (the dense per-read API: per-read ``--impl`` other than auto),
  ``dense`` (the spectrum on the device, one running table) or
  ``sorted`` (per-read row sorts and a host fold: the spectrum at
  ``--impl sort`` or k >= 11 on CUDA, and ``--mode sparse``);
* ``host_s`` — host wall seconds of each stage (``time.perf_counter``,
  with a ``torch.cuda.synchronize`` after each device stage, so a stage
  holds its own device work), and ``wall`` over all of them:
  - perread: parse, pad, h2d, rows (dispatcher, wrapper and kernel),
    drain (narrow + device→host copy), format (the `.cfrk` writer);
  - dense_rows: parse, pad, h2d, kernel (the dense counts on the
    device, packed where pipeline/count.py packs), d2h, unpack (the packed
    layout, or the int16 rows, to int32 on the host), format;
  - dense: parse, pad, spectrum (host→device copy and the spectrum op
    into the running table), drain (the table's copy into the int64
    host table), format;
  - sorted: parse, pad, h2d, rows, drain (narrow + device→host copy +
    flat triples), fold (the host accumulator, and the dense table for
    the spectrum), format;
* ``device_ms`` — on a CUDA device, a second pass of the device stages
  under ``torch.profiler`` (the dense route's pass adds into one
  running table and copies it to the host once, as the driver does),
  summed by kind from the card's own events:
  the rowsort kernels, the per-read histogram kernel, the spectrum
  kernel, other kernels, host→device and device→host copies, and
  ``busy``, the union of all device intervals;
* ``device_busy_share`` — ``busy`` over the first pass's wall: the share
  of the run in which the card does any work.

On the CPU the device fields are null.  The output file is written by
the first pass and equals the CLI's output for the same arguments.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..cli import _resolve_device, _write_sparse, _write_spectrum
from ..format import CfrkWriter
from ..io.fasta import read_fasta_encoded
from ..ops.perread_sparse import (
    count_perread_rows,
    narrow_for_fetch,
    pairs_to_host,
    valid_pair_prefix,
)
from ..ops.sparse import DenseFoldAccumulator, SparseAccumulator, fetched_to_triples
from ..ops.spectrum import spectrum as spectrum_op
from ..pipeline.batch import iter_batches
from ..pipeline.count import (
    DenseSpectrumAccumulator,
    _plan_shapes,
    _use_sorted_spectrum,
    dense_counts_on_device,
    dense_counts_to_host,
)

__all__ = ["stage_breakdown"]


def _device_ms(batches, step, finish=None) -> dict:
    """Device time by kind over one pass of ``step(batch)`` for every
    batch and then ``finish()``, from the profiler's CUDA events (µs →
    ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            step(batch)
        if finish is not None:
            finish()
        torch.cuda.synchronize()
    spans = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    if not spans:
        raise RuntimeError("torch.profiler recorded no device events")
    out = dict.fromkeys(
        ("rowsort_kernels", "perread_kernels", "spectrum_kernels", "other_kernels",
         "h2d", "d2h"), 0.0
    )
    for ev in spans:
        if ev.name.startswith("Memcpy HtoD"):
            kind = "h2d"
        elif ev.name.startswith("Memcpy DtoH"):
            kind = "d2h"
        elif "rowsort" in ev.name:
            kind = "rowsort_kernels"
        elif "perread_hist" in ev.name:
            kind = "perread_kernels"
        elif "spectrum" in ev.name:
            kind = "spectrum_kernels"
        else:
            kind = "other_kernels"
        out[kind] += ev.time_range.elapsed_us() / 1e3
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((ev.time_range.start, ev.time_range.end) for ev in spans):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    out["busy"] = busy / 1e3
    return out


def stage_breakdown(path, out_path, k: int, *, device, mode: str = "perread",
                    canonical: bool = False, nonzero: bool = True,
                    impl: str = "auto", spectrum_format: str = "cfrk") -> dict:
    """The stage times of one run (see the module docstring)."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(stage, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync()
        host[stage] = host.get(stage, 0.0) + time.perf_counter() - t0
        return out

    def h2d(batch):
        return torch.from_numpy(batch.codes).to(device)

    host: dict = {}
    if cuda:  # the CUDA context's creation belongs to no stage
        torch.zeros(1, device=device)
        sync()
    t_all = time.perf_counter()
    reads = timed("parse", read_fasta_encoded, path)
    bs, ml = _plan_shapes(reads, k, None, None)
    batches = timed("pad", lambda: list(iter_batches(reads, bs, ml)))
    finish = None

    if mode == "perread" and impl != "auto" and not (nonzero and k > 8):
        route = "dense_rows"

        def step(batch):
            return dense_counts_on_device(h2d(batch), k, canonical, impl)[0].cpu()

        with CfrkWriter(out_path, nonzero=nonzero) as w:
            for batch in batches:
                codes = timed("h2d", h2d, batch)
                counts, packing = timed("kernel", dense_counts_on_device, codes, k,
                                        canonical, impl)
                host_counts = timed("d2h", counts.cpu)
                rows = timed("unpack", dense_counts_to_host, host_counts,
                             batch.n_reads, packing)
                timed("format", w.write_batch, rows)
    elif mode == "perread":
        route = "perread"

        def step(batch):
            rows = count_perread_rows(h2d(batch), k, canonical)
            return pairs_to_host(narrow_for_fetch(rows, k), batch.n_reads)

        with CfrkWriter(out_path) as w:
            for batch in batches:
                codes = timed("h2d", h2d, batch)
                rows = timed("rows", count_perread_rows, codes, k, canonical)
                idx, counts = timed("drain", pairs_to_host,
                                    narrow_for_fetch(rows, k), batch.n_reads)
                if nonzero:
                    timed("format", w.write_pairs, idx, counts)
                else:
                    timed("format", w.write_pairs_dense, idx, counts, 4**k)
    elif mode == "sparse" or _use_sorted_spectrum(k, impl, device):
        route = "sorted"

        def drain(rows, batch):
            w = max(int(batch.lengths.max(initial=0)) or batch.codes.shape[-1], k) - k + 1
            rows = valid_pair_prefix(narrow_for_fetch(rows, k), w)
            return fetched_to_triples([a.cpu().numpy() for a in rows], k)

        def step(batch):
            return drain(count_perread_rows(h2d(batch), k, canonical), batch)

        acc = (DenseFoldAccumulator(k) if mode == "spectrum" and k <= 10
               else SparseAccumulator())
        for batch in batches:
            codes = timed("h2d", h2d, batch)
            rows = timed("rows", count_perread_rows, codes, k, canonical)
            triples = timed("drain", drain, rows, batch)
            timed("fold", acc.add, *triples)
        keys, counts = timed("fold", acc.result_arrays)
        if mode == "sparse":
            timed("format", _write_sparse, out_path, keys, counts, k,
                  spectrum_format)
        else:
            table = np.zeros(4**k, dtype=np.int64)
            timed("fold", table.__setitem__, keys, counts)
            timed("format", _write_spectrum, out_path, table, spectrum_format)
    else:
        route = "dense"

        def dispatch(arr, table):
            return spectrum_op(arr, k, canonical=canonical, impl=impl, out=table)

        running = []

        def step(batch):
            running[:] = [dispatch(h2d(batch), running[0] if running else None)]

        def finish():
            return running[0].cpu()

        acc = DenseSpectrumAccumulator(
            k, dispatch, np.zeros(4**k, dtype=np.int64), device=device
        )
        for batch in batches:
            timed("spectrum", acc.add, batch.codes)
        table = timed("drain", acc.total)
        timed("format", _write_spectrum, out_path, table, spectrum_format)
    host["wall"] = time.perf_counter() - t_all
    bases = sum(len(r) for r in reads)
    dev = _device_ms(batches, step, finish) if cuda else None
    return {
        "mode": mode,
        "route": route,
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
    ap.add_argument("--mode", choices=("perread", "spectrum", "sparse"),
                    default="perread")
    ap.add_argument("--canonical", action="store_true")
    ap.add_argument("--nonzero", action="store_true")
    ap.add_argument("--impl", default="auto",
                    choices=("auto", "compare", "scatter", "matmul", "pallas", "host",
                             "sort"))
    ap.add_argument("--spectrum-format", choices=("cfrk", "tsv", "npy", "hist"),
                    default="cfrk")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    res = stage_breakdown(args.input, args.output, args.k,
                          device=_resolve_device(args.device), mode=args.mode,
                          canonical=args.canonical, nonzero=args.nonzero,
                          impl=args.impl, spectrum_format=args.spectrum_format)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
