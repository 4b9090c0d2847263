"""Single-core native formatter microbenchmark (MB/s of .cfrk bytes).

The port of ``tools/bench_format.py``: the four emitter shapes of the
host library (``csrc/fastaio.cpp`` through ``io/native``) with its
segment-parallel path forced off (``CFRK_FORMAT_THREADS=1``; sizes
below its 4 MB threshold stay serial anyway), so the number is the
per-core emitter speed that the segments then multiply.  Each shape is
the best of 5 calls; the library builds at the first call (host
compiler, ~9 s), before any timing.

    python -m cfrk_tpu_torch.tools.bench_format

Prints one JSON line: ``{shape: {"mb_s": ..., "out_mb": ...}}`` for
``pairs_k8``, ``pairs64_k31``, ``dense_k2`` and ``dense_pairs_k8``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from ..io import native

__all__ = ["main"]


def _time_mb_s(fn, reps: int = 5) -> tuple:
    """(MB/s of output at the best of ``reps`` calls, output bytes)."""
    best, n = float("inf"), 0
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
        n = len(out)
    return n / best / 1e6, n


def main(argv=None) -> int:
    # Single-core numbers by construction: the library reads this cap at
    # each call.
    before = os.environ.get("CFRK_FORMAT_THREADS")
    os.environ["CFRK_FORMAT_THREADS"] = "1"
    try:
        results = _measure()
    finally:
        if before is None:
            del os.environ["CFRK_FORMAT_THREADS"]
        else:
            os.environ["CFRK_FORMAT_THREADS"] = before
    print(json.dumps(results))
    return 0


def _measure() -> dict:
    rng = np.random.default_rng(0)

    # sparse pairs, k=8-shaped: 8192 rows x 143 window slots, ~all real.
    n_rows, w = 8192, 143
    idx = np.sort(rng.integers(0, 4**8, size=(n_rows, w)), axis=1).astype(np.int32)
    cnt = rng.integers(1, 5, size=(n_rows, w)).astype(np.int32)
    # 64-bit pairs, k=31-shaped.
    idx64 = np.sort(rng.integers(0, 4**31, size=(2048, 122), dtype=np.uint64), axis=1)
    cnt2 = np.ones((2048, 122), dtype=np.int32)
    # dense rows, k=2-shaped (the reference's own at-scale workload):
    # 16 cells a row, mostly nonzero, so the emitter dominates.
    dense = rng.integers(0, 50, size=(65536, 16)).astype(np.int32)
    shapes = {
        "pairs_k8": lambda: native.format_pairs_bytes(idx, cnt),
        "pairs64_k31": lambda: native.format_pairs_bytes(idx64, cnt2),
        "dense_k2": lambda: native.format_rows_bytes(dense),
        # the dense .cfrk route: sparse pairs densified in the bin walk.
        "dense_pairs_k8": lambda: native.format_dense_pairs_bytes(idx[:512], cnt[:512], 4**8),
    }
    native.format_rows_bytes(dense[:1])  # builds the library outside the timing
    results = {}
    for name, fn in shapes.items():
        mbs, nbytes = _time_mb_s(fn)
        results[name] = {"mb_s": mbs, "out_mb": nbytes / 1e6}
    return results


if __name__ == "__main__":
    sys.exit(main())
