"""Step-time decomposition of the rowsort kernel on a CUDA device.

    python -m cfrk_tpu_torch.tools.rowsort_probe --variant full|sortonly|rleonly|noop \
        [--keys 1|2] [--k K] [--len 150] [--batch 8192] [--steps 64]

The port of ``tools/rowsort_probe.py``.  Each variant is the production
kernel of ``csrc/rowsort.cu`` with stages left out, writing one checksum
per row (``ops/cuda/rowsort.PROBE_VARIANTS``): ``noop`` builds the keys
(on the card the kernel builds its own keys, so this is the prep cost),
``sortonly`` adds the bitonic sort, ``rleonly`` the run-end search
without the sort, ``full`` both.  Checksums differ between variants by
design; only times compare.

``--keys 1`` drives the uint32-key kernel (k <= 15, forward keys),
``--keys 2`` the uint64-key kernel (16 <= k <= 31, canonical keys, as
the JAX tool's ``kmer_keys(codes, k, True)``).  Where ``--keys 2`` takes
the prefix path (rows of up to 256 keys), the line also holds its
readout over the 4 batches (``rowsort_fallbacks``): ``rows``,
``rows_repaired`` (their warp repaired the gathered keys) and
``fallback_share``, their ratio.  Inputs are 4 distinct
seeded batches of random bases, cycled, so no launch sees the input of
the one before.  The ``--steps`` launches are captured once in a CUDA
graph and its replay is timed with CUDA events, after a warm-up
replay: like the JAX tool's ``lax.scan``, the timed run has no host
work between launches (an eager loop of the fastest variants times the
host's launch rate instead).  Prints one JSON line: ``variant``, ``k``,
``n`` (the padded sort width), ``step_ms``, ``mbases_per_s``, ``chk``
(the sum of every launch's checksums) and the ``device``.  Needs a CUDA
device: without one it exits non-zero, and it never runs the plain
twins.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops.cuda.rowsort import PROBE_VARIANTS, prefix_path, rowsort_fallbacks, rowsort_probe

__all__ = ["probe", "probe_batches"]


def probe_batches(batch: int, length: int, seed: int = 0) -> list:
    """The probe's 4 distinct seeded batches of random bases (int8
    codes, numpy)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, size=(batch, length)).astype(np.int8)
            for _ in range(4)]


def probe(variant: str, *, keys: int = 1, k: int | None = None,
          length: int = 150, batch: int = 8192, steps: int = 64,
          seed: int = 0) -> dict:
    """Time ``steps`` launches of one probe variant on the current CUDA
    device; returns the JSON record."""
    if k is None:
        k = 8 if keys == 1 else 31
    if keys == 1 and not 1 <= k <= 15:
        raise ValueError(f"--keys 1 needs 1 <= k <= 15, got k={k}")
    if keys == 2 and not 16 <= k <= 31:
        raise ValueError(f"--keys 2 needs 16 <= k <= 31, got k={k}")
    canonical = keys == 2
    xs = [torch.from_numpy(x).cuda() for x in probe_batches(batch, length, seed)]
    for i in range(3):  # builds the library and sets its attributes
        rowsort_probe(xs[i % 4], k, variant, canonical)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [rowsort_probe(xs[i % 4], k, variant, canonical) for i in range(steps)]
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / steps
    w = length - k + 1
    record = {
        "variant": variant,
        "k": k,
        "n": 1 << max(w - 1, 0).bit_length(),
        "step_ms": ms,
        "mbases_per_s": batch * length / ms / 1e3,
        "chk": int(torch.stack(outs).sum()),
        "device": torch.cuda.get_device_name(0),
    }
    if keys == 2 and prefix_path(w, k):
        repaired = sum(int((rowsort_fallbacks(x, k, canonical) > 0).sum()) for x in xs)
        record.update(rows=4 * batch, rows_repaired=repaired,
                      fallback_share=repaired / (4 * batch))
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", default="full", choices=list(PROBE_VARIANTS))
    ap.add_argument("--keys", type=int, default=1, choices=[1, 2],
                    help="1: uint32 keys (k <= 15); 2: uint64 canonical keys "
                         "(16 <= k <= 31)")
    ap.add_argument("--k", type=int, default=None,
                    help="k-mer length (default 8 for --keys 1, 31 for --keys 2)")
    ap.add_argument("--len", dest="length", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rowsort_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    print(json.dumps(probe(args.variant, keys=args.keys, k=args.k,
                           length=args.length, batch=args.batch,
                           steps=args.steps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
