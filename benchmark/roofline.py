"""The yardstick of the kernels' roofline shares, frozen here.

A copy of the arithmetic of ``cfrk_tpu_torch/ops/roofline.py`` that the
row-sort kernels' bound needs, so that no later change to the program
moves the yardstick: the same work gives the same bound whatever
implements it.  A bound comes from the work alone: each input byte read
once and each output byte written once at the memory rate, or the
integer operations that the work cannot avoid at the integer rate,
whichever is longer.  The rates are NVIDIA's H100 SXM data sheet at its
700 W limit; a share of them is quoted with the card's power limit
beside it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes/s.
HBM_BW = 3.35e12
# NVIDIA H100 SXM data sheet: 67 TFLOP/s float32 outside the tensor
# cores, which counts a fused multiply-add as two operations; an int32
# operation of those cores is one a lane a clock, half of that.
INT_OPS = 33.5e12


def bound(nbytes: float, ops: float) -> tuple:
    """(ms, "bytes" | "operations"): the least time the card could take
    to move ``nbytes`` through device memory or to do ``ops`` integer
    operations, whichever is longer."""
    by_bytes = nbytes / HBM_BW * 1e3
    by_ops = ops / INT_OPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sort_ops(rows: int, w: int) -> int:
    """Comparisons a sort of ``rows`` rows of ``w`` keys cannot avoid,
    w * ceil(log2 w) a row, plus one operation a key to build it."""
    return rows * w * (max(w - 1, 1).bit_length() + 1)


def rows_bytes(batch: int, read_len: int, k: int) -> int:
    """Bytes of one call of the per-read rows on ``[batch, read_len]``
    int8 codes, in the dispatcher's documented layout: the codes read
    once, and ``[batch, W]`` int32 words written once, two of them (idx,
    counts) for k <= 15 and three (hi, lo, counts) above, W = read_len -
    k + 1."""
    w = read_len - k + 1
    if w <= 0:
        raise ValueError(f"read length {read_len} < k={k}")
    words = 2 if k <= 15 else 3
    return batch * read_len + batch * w * 4 * words


def rowsort_bound(batch: int, read_len: int, k: int, canonical: bool = False) -> tuple:
    """One call of the row-sort kernels: :func:`rows_bytes`, and the
    sort of each row's windows; a canonical key adds its reverse
    complement and one comparison a window."""
    w = read_len - k + 1
    ops = sort_ops(batch, w) + (2 * batch * w if canonical else 0)
    return bound(rows_bytes(batch, read_len, k), ops)
