"""Times of the two rowsort kernels on a CUDA device, shape by shape.

    python cfrk_tpu_torch/tools/rowsort_times.py [--seed 0] [--iters 50] [--plain] \
        [--shapes main short70 ...] [--probe-lens 150 ...] [--probe-batch 8192]

For each shape below, at k = 8 (``rowsort_rle``, two 16-bit keys a
register up to 4096 keys a row), k = 12 (``rowsort_rle``, uint32 keys)
and k = 31 canonical (``rowsort_rle_large``, uint64 keys): ms per launch
of the kernel, and with ``--plain`` of its plain twin on the card.  Then the
probe's four variants at k = 8 and k = 31 (``tools/rowsort_probe.py``),
at each read length of ``--probe-lens`` in batches of ``--probe-batch``
reads: a sweep of the row width W = length - k + 1 (``--shapes`` with
no name times no shape).  One JSON object per line; the first line is the card.

    main      [8192, 256]   150 bp reads (152 at k = 31) padded to the
                            256-column length bucket: the main path's batch
    reads150  [8192, 150]   150 bp reads unpadded (W = 143 at k = 8)
    cell150   [100000, 150] a shard of the benchmark's cfg2_k8 cell
    short70   [8192, 128]   70 bp reads in the 128-column bucket
    w512      [4096, 512]   random bases, every width the kernel treats
    w1024     [2048, 1024]  differently (see csrc/rowsort.cu)
    w2048     [1024, 2048]
    contig4k  [256, 4096]   4 kb contigs
    w8192     [128, 8192]   the first width of the shared-memory network
    ceiling   [64, ceiling + k - 1]  the widest row one launch takes

Run as a script, it imports whichever ``cfrk_tpu_torch`` is first on
``PYTHONPATH``: to compare two checkouts on one card, run it once with
each checkout's root there, in one job.

A kernel is timed as one CUDA-graph replay of ``iters`` launches through
its wrapper, between CUDA events, after a warm-up replay: an eager loop
of 20 us kernels times the host's launch rate instead.  The plain twins
synchronise inside (``rowsort_probe_plain``) or run for milliseconds, so
an eager loop times them.  Needs a CUDA device: without one it exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

__all__ = ["SHAPES", "shape_codes", "time_graph", "time_eager", "time_shape"]

# name: (reads, columns, valid bases per read; None = every column, and
# "ceiling" = the widest row of one launch)
SHAPES = {
    "main": (8192, 256, 150),
    "reads150": (8192, 150, None),
    "cell150": (100000, 150, None),
    "short70": (8192, 128, 70),
    "w512": (4096, 512, None),
    "w1024": (2048, 1024, None),
    "w2048": (1024, 2048, None),
    "contig4k": (256, 4096, None),
    "w8192": (128, 8192, None),
    "ceiling": (64, "ceiling", None),
}


def shape_codes(name: str, k: int, seed: int) -> np.ndarray:
    """The seeded int8 code batch of one shape: random bases, N at rate
    0.002, -1 past the read's end (the main shape's reads are two bases
    longer at k > 15, as the 152 bp reads of the k = 31 legs)."""
    from cfrk_tpu_torch.ops.cuda.rowsort import rowsort_max_windows

    reads, cols, valid = SHAPES[name]
    if cols == "ceiling":
        cols = rowsort_max_windows(k) + k - 1
    if name == "main" and k > 15:
        valid += 2
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(reads, cols)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.002] = -1
    if valid is not None:
        codes[:, valid:] = -1
    return codes


def time_graph(fn, iters: int = 50) -> float:
    """ms per call of ``fn()``: ``iters`` calls captured in one CUDA
    graph, its second replay timed with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        keep = [fn() for _ in range(iters)]
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del keep
    return e0.elapsed_time(e1) / iters


def time_eager(fn, iters: int = 20) -> float:
    """ms per call of ``fn()``: CUDA events around ``iters`` eager calls
    after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def time_shape(name: str, k: int, canonical: bool, seed: int, iters: int,
               plain: bool = False) -> dict:
    """One shape at one k: the kernel's ms (kernel, then again after the
    plain twin when ``plain``), through the wrapper a caller uses."""
    from cfrk_tpu_torch.ops.cuda import rowsort as R

    kern, twin = ((R.rowsort_rle, R.rowsort_rle_plain) if k <= 15
                  else (R.rowsort_rle_large, R.rowsort_rle_large_plain))
    codes = torch.from_numpy(shape_codes(name, k, seed)).cuda()
    # A graph keeps every launch's outputs (16-25 MB each): at most 1 GB.
    n = max(4, min(iters, (1 << 30) // (codes.shape[0] * codes.shape[1] * 12)))
    rec = {"shape": name, "codes": list(codes.shape), "k": k,
           "canonical": canonical, "kernel": kern.__name__,
           "ms": time_graph(lambda: kern(codes, k, canonical), n)}
    if plain:
        rec["plain_ms"] = time_eager(lambda: twin(codes, k, canonical), 5)
        rec["ms_again"] = time_graph(lambda: kern(codes, k, canonical), n)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--plain", action="store_true",
                    help="also time the plain twins on the card")
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES), choices=list(SHAPES),
                    help="the shapes to time (default: all)")
    ap.add_argument("--probe-lens", nargs="+", type=int, default=[150],
                    help="the probe's read lengths (default: 150)")
    ap.add_argument("--probe-batch", type=int, default=8192,
                    help="the probe's reads a batch (default: 8192)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rowsort_times: no CUDA device is visible", file=sys.stderr)
        return 2
    import cfrk_tpu_torch
    from cfrk_tpu_torch.ops.cuda.rowsort import PROBE_VARIANTS
    from cfrk_tpu_torch.tools.rowsort_probe import probe

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "package": cfrk_tpu_torch.__file__}), flush=True)
    for name in args.shapes:
        for k, canonical in ((8, False), (12, False), (31, True)):
            print(json.dumps(time_shape(name, k, canonical, args.seed,
                                        args.iters, args.plain)), flush=True)
    for keys in (1, 2):
        for length in args.probe_lens:
            for variant in PROBE_VARIANTS:
                rec = probe(variant, keys=keys, length=length, batch=args.probe_batch)
                print(json.dumps({"probe": rec, "length": length,
                                  "batch": args.probe_batch}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
