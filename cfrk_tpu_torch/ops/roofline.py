"""Speed-of-light bounds of the port's device routes on an NVIDIA H100:
the one place they are computed (``chip_smoke.py``, ``bench.py`` and
``tools/bench_suite.py`` import them).

A port of ``cfrk_tpu/ops/roofline.py``, whose constants are a TPU v5e's.
A bound here comes from the work alone, never from how a kernel does
it: each input read once and each output written once at the memory
rate, or the integer operations that the work cannot avoid (the
comparisons of a sort, one key built a window, one table update a
window) at the integer rate, whichever is longer.  The constants are
NVIDIA's H100 SXM data sheet at its 700 W limit; a card set below that
limit runs slower under load, so a share of these bounds is quoted with
the card's power limit beside it.

:func:`bound` gives ``(ms, "bytes" | "operations")``; the route bounds
take the shapes of one call: :func:`rowsort_bound` (``rowsort_rle`` /
``rowsort_rle_large``), :func:`spectrum_bound` (``spectrum_hist`` and
any dense-table update), :func:`perread_bound` (``perread_hist`` in
each emit) and :func:`probe_bound` (``rowsort_probe``).  The JAX names
that keep their meaning give bases/s: :func:`dense_emit_sol`,
:func:`sort_sol`, :func:`scatter_sol`; :func:`bases_per_s` turns any
route bound into bases/s.
"""

from __future__ import annotations

__all__ = [
    "HBM_BW",
    "INT_OPS",
    "bound",
    "sort_ops",
    "rowsort_bound",
    "spectrum_bound",
    "perread_bound",
    "probe_bound",
    "pad_pow2",
    "bases_per_s",
    "dense_emit_sol",
    "sort_sol",
    "scatter_sol",
]

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes/s.
HBM_BW = 3.35e12
# NVIDIA H100 SXM data sheet: 67 TFLOP/s float32 outside the tensor
# cores, which counts a fused multiply-add as two operations; an int32
# operation of those cores is one a lane a clock, half of that.
INT_OPS = 33.5e12

# Bytes an emit of perread_hist writes a table cell: "b4" packs four
# counts into a 32-bit word, "fh" two, and the unpacked table is int32.
_CELL_BYTES = {"b4": 1, "fh": 2, None: 4}


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


def _windows(read_len: int, k: int) -> int:
    w = read_len - k + 1
    if w <= 0:
        raise ValueError(f"read length {read_len} < k={k}")
    return w


def rowsort_bound(batch: int, read_len: int, k: int, canonical: bool = False) -> tuple:
    """One call of the row-sort kernels on ``[batch, read_len]`` int8
    codes: the codes read, two int32 words a window written (idx,
    counts; three above k = 15: hi, lo, counts), and the sort of each
    row's windows; a canonical key adds its reverse complement and one
    comparison a window."""
    w = _windows(read_len, k)
    words = 2 if k <= 15 else 3
    ops = sort_ops(batch, w) + (2 * batch * w if canonical else 0)
    return bound(batch * read_len + batch * w * 4 * words, ops)


def spectrum_bound(batch: int, read_len: int, k: int) -> tuple:
    """One dense-spectrum update from ``[batch, read_len]`` int8 codes:
    the codes read, the int32 table cells the batch can touch written
    (every one of the 4**k cells, or one a window where the windows are
    fewer: a running 4**15 table is not rewritten by each batch), and
    one update a window."""
    windows = batch * _windows(read_len, k)
    return bound(batch * read_len + min(4**k, windows) * 4, windows)


def perread_bound(batch: int, read_len: int, k: int, emit: str | None = "b4") -> tuple:
    """One call of ``perread_hist``: the codes read, the ``[batch,
    4**k]`` per-read table written in ``emit``'s cells ("b4": one byte,
    "fh": two, None: an int32), and one update a window."""
    return bound(batch * read_len + batch * 4**k * _CELL_BYTES[emit],
                 batch * _windows(read_len, k))


def probe_bound(batch: int, read_len: int, k: int) -> tuple:
    """One call of ``rowsort_probe``: the codes read, one int64
    checksum a row written, and the sort of each row's windows."""
    return bound(batch * read_len + batch * 8, sort_ops(batch, _windows(read_len, k)))


def pad_pow2(w: int, floor: int = 128) -> int:
    """The power of two >= ``w`` and >= ``floor``."""
    n = floor
    while n < w:
        n *= 2
    return n


def bases_per_s(batch: int, read_len: int, bound_ms: tuple) -> float:
    """The bases/s of ``batch`` reads of ``read_len`` at a bound's time
    (``(ms, by)``, as the route bounds give it)."""
    return batch * read_len / (bound_ms[0] / 1e3)


def dense_emit_sol(batch: int, read_len: int, k: int, *, bytes_per_bin: float = 1.0) -> float:
    """bases/s bar of an ideal dense per-read emitter: one write of the
    ``[batch, 4**k]`` count matrix (``bytes_per_bin`` a cell, the "b4"
    packing by default) at the memory rate."""
    return batch * read_len / (batch * 4**k * bytes_per_bin / HBM_BW)


def sort_sol(batch: int, read_len: int, k: int, *, canonical: bool = False) -> float:
    """bases/s bound of the fused per-read sort + RLE route
    (:func:`rowsort_bound`)."""
    return bases_per_s(batch, read_len, rowsort_bound(batch, read_len, k, canonical))


def scatter_sol(batch: int, read_len: int, k: int) -> float:
    """bases/s bound of a dense-table update, one update a window
    (:func:`spectrum_bound`)."""
    return bases_per_s(batch, read_len, spectrum_bound(batch, read_len, k))
