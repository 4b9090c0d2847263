"""Sparse per-read k-mer rows (sort + run-length encode), PyTorch.

The counterpart of ``cfrk_tpu/ops/perread_sparse.py``.  Each read's
window keys are sorted and run-length encoded; a row position holds a
distinct key and its count iff it starts a run, else the sentinel and
count 0.  That is the ``--nonzero`` `.cfrk` row (ascending
``idx:count`` cells) and, densified on host, the dense row.

Two halves:

* the plain route — :func:`count_perread_sparse` (k <= 15) and
  :func:`count_perread_sparse_large` (16 <= k <= 31) on ``torch.sort``
  — runs on any device; it is the CPU route and the kernels' oracle, and
  lives beside the kernels in ``ops/cuda/rowsort.py``;
* the dispatcher :func:`count_perread_rows`, which every driver calls:
  it sends each row to the wrappers of ``ops/cuda/rowsort.py`` (rows
  past the kernels' shared-memory ceiling through
  :func:`count_perread_rows_tiled`), and the wrappers choose by the
  tensor's device: a CUDA tensor launches the hand-written kernel, a CPU
  tensor takes the plain route.

The sorted spectrum routes feed the same rows to the host accumulators
of ``ops/sparse.py``: :func:`batch_spectrum_triples` and
:func:`rows_to_triples` (in ``cfrk_tpu/ops/sparse.py`` in the JAX
package; here beside the drain they run, so that ``ops/sparse.py``
imports nothing of this module).

Dtypes: torch has few uint16/uint32 operations, so the uint32 (hi, lo)
words of k > 15 travel as int32 bit views, and :func:`narrow_for_fetch`
narrows with int16 bit views; :func:`pairs_to_host` reinterprets them
with ``numpy.view``.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda.rowsort import (
    KEY64_SENTINEL,
    LO_MASK,
    MAX_SPARSE_PERREAD_K,
    rle_rows,
    rowsort_max_windows,
    rowsort_rle,
    rowsort_rle_large,
    rowsort_rle_large_plain,
    rowsort_rle_plain,
)
from .sparse import INVALID_SENTINEL, LO_BASES, fetched_to_triples

__all__ = [
    "MAX_SPARSE_PERREAD_K",
    "rle_rows",
    "count_perread_sparse",
    "count_perread_sparse_large",
    "count_perread_rows",
    "count_perread_rows_tiled",
    "compact_pairs",
    "narrow_for_fetch",
    "valid_pair_prefix",
    "pairs_to_host",
    "rows_to_triples",
    "batch_spectrum_triples",
]

# The plain route lives beside the kernels it checks; these are its
# names in the JAX package's module.
count_perread_sparse = rowsort_rle_plain
count_perread_sparse_large = rowsort_rle_large_plain


def count_perread_rows(codes: torch.Tensor, k: int, canonical: bool = False):
    """Per-read sparse rows — the one dispatcher every driver calls.

    Returns the row layout of :func:`count_perread_sparse` ((idx,
    counts) for k <= 15) or :func:`count_perread_sparse_large` ((hi, lo,
    counts) for 16 <= k <= 31).  Rows longer than the kernel's window
    ceiling go through :func:`count_perread_rows_tiled`; every row then
    reaches a wrapper of ``ops/cuda/rowsort.py``, which alone picks the
    device route (a CUDA tensor launches the kernel, a CPU tensor takes
    the plain twin).
    """
    w = codes.shape[-1] - k + 1
    if w > rowsort_max_windows(k):
        return count_perread_rows_tiled(
            codes, k, canonical, step=rowsort_max_windows(k)
        )
    if k <= MAX_SPARSE_PERREAD_K:
        return rowsort_rle(codes, k, canonical)
    return rowsort_rle_large(codes, k, canonical)


def count_perread_rows_tiled(codes: torch.Tensor, k: int,
                             canonical: bool = False, *, step: int):
    """Per-read sparse rows for reads longer than the kernel ceiling.

    Splits the position axis into tiles of ``step`` windows with k-1
    halo columns (every window lands in exactly one tile), runs every
    tile of every read through :func:`count_perread_rows` on the codes'
    device, and merges each read's per-tile (key, count) pairs on host.
    The result is array-equal to the single-shot plain route: a run
    start's position in the sorted row is the exclusive prefix sum of
    the preceding run counts, so the exact layout rebuilds from the
    merged aggregates.  Returns CPU tensors in the single-shot dtypes.
    """
    codes_np = codes.cpu().numpy()
    b, length = codes_np.shape
    w = length - k + 1
    if w <= 0:
        raise ValueError(f"read length {length} < k={k}")
    tl = step + k - 1
    tiles = []
    for s in range(0, w, step):
        sl = codes_np[:, s : min(s + tl, length)]
        if sl.shape[1] < tl:
            sl = np.pad(sl, ((0, 0), (0, tl - sl.shape[1])), constant_values=-1)
        tiles.append(sl)
    n_tiles = len(tiles)
    stacked = np.concatenate(tiles, axis=0)  # tile-major
    # Bound each dispatch at ~8 Mi windows so tens-of-Mb contigs do not
    # hold every tile's key and pair streams on the device at once.
    rows_per = max(1, (8 << 20) // step)
    key_parts, cnt_parts = [], []
    for s in range(0, stacked.shape[0], rows_per):
        chunk = torch.from_numpy(stacked[s : s + rows_per]).to(codes.device)
        keys_c, cnt_c = pairs_to_host(
            narrow_for_fetch(count_perread_rows(chunk, k, canonical), k),
            chunk.shape[0],
        )
        key_parts.append(keys_c)
        cnt_parts.append(cnt_c)
    keys_t = np.concatenate(key_parts, axis=0)
    cnt_t = np.concatenate(cnt_parts, axis=0)

    two_key = k > MAX_SPARSE_PERREAD_K
    key_out = np.full((b, w), KEY64_SENTINEL if two_key else 4**k, np.int64)
    cnt_out = np.zeros((b, w), np.int32)
    for r in range(b):
        ks = np.concatenate([keys_t[t * b + r] for t in range(n_tiles)])
        cs = np.concatenate([cnt_t[t * b + r] for t in range(n_tiles)])
        m = cs > 0  # narrowed sentinels may have wrapped: mask by count
        ks, cs = ks[m].astype(np.int64), cs[m].astype(np.int64)
        if not ks.size:
            continue
        order = np.argsort(ks, kind="stable")
        ks, cs = ks[order], cs[order]
        firstm = np.ones(ks.size, bool)
        firstm[1:] = ks[1:] != ks[:-1]
        sums = np.add.reduceat(cs, np.nonzero(firstm)[0])
        pos = np.zeros(sums.size, np.int64)
        np.cumsum(sums[:-1], out=pos[1:])
        key_out[r, pos] = ks[firstm]
        cnt_out[r, pos] = sums
    cnt_out = torch.from_numpy(cnt_out)
    if not two_key:
        return torch.from_numpy(key_out.astype(np.int32)), cnt_out
    real = key_out != KEY64_SENTINEL
    hi = np.where(real, key_out >> (2 * LO_BASES), INVALID_SENTINEL)
    lo = np.where(real, key_out & LO_MASK, INVALID_SENTINEL)
    return (
        torch.from_numpy(hi.astype(np.uint32).view(np.int32)),
        torch.from_numpy(lo.astype(np.uint32).view(np.int32)),
        cnt_out,
    )


def _narrow_counts(counts: torch.Tensor) -> torch.Tensor:
    """Counts are bounded by windows/read: uint8 below 256 windows,
    int16 below 2**15."""
    w = counts.shape[-1]
    if w < 256:
        return counts.to(torch.uint8)
    if w < 2**15:
        return counts.to(torch.int16)
    return counts


def compact_pairs(idx: torch.Tensor, counts: torch.Tensor, k: int):
    """Narrow an (idx, counts) pair before the device→host copy.

    For k <= 8 every real index fits 16 bits; idx travels as an int16
    bit view of uint16, in which the sentinel 4**k wraps to 0.  Only
    count-0 cells carry it, and every consumer skips those, so the wrap
    is unobservable.  :func:`pairs_to_host` widens back.
    """
    if k <= 8:
        idx = idx.to(torch.int16)
    return idx, _narrow_counts(counts)


def narrow_for_fetch(device_out, k: int):
    """The one device→host narrowing policy for a per-read result:
    :func:`compact_pairs` for an (idx, counts) pair, count narrowing for
    a (hi, lo, counts) triple.  Every drain goes through it."""
    if len(device_out) == 2:
        return compact_pairs(*device_out, k)
    hi, lo, cnt = device_out
    return hi, lo, _narrow_counts(cnt)


def valid_pair_prefix(rows, w: int):
    """The first ``w`` columns of per-read pair rows.  Exact for any
    sorted-RLE layout: real keys sort ahead of the sentinels, so every
    run start (the only cells with count > 0) lies in the first
    ``n_real <= w`` positions."""
    return tuple(a[..., :w] for a in rows)


def pairs_to_host(device_out, n_reads: int):
    """A (narrowed) per-read result → host numpy (keys, counts int32).

    For the (idx, counts) pair the keys are int32 indices (an int16 bit
    view is read as uint16); for the (hi, lo, counts) triple they are the
    uint64 combined code ``hi * 4**LO_BASES + lo``.  Sentinel cells keep
    count 0 and are skipped by the formatter.
    """
    def host(t):
        return t[:n_reads].cpu().numpy()

    if len(device_out) == 2:
        idx, counts = map(host, device_out)
        if idx.dtype == np.int16:
            idx = idx.view(np.uint16)
        return idx.astype(np.int32, copy=False), counts.astype(np.int32, copy=False)
    hi, lo, counts = map(host, device_out)
    combined = (hi.view(np.uint32).astype(np.uint64) << np.uint64(2 * LO_BASES)) | (
        lo.view(np.uint32).astype(np.uint64)
    )
    return combined, counts.astype(np.int32, copy=False)


def rows_to_triples(rows, k: int):
    """Per-read sorted-RLE rows (any device) → host (hi, lo, counts)
    triple for the accumulators of ``ops/sparse.py``."""
    rows = narrow_for_fetch(rows, k)
    return fetched_to_triples([a.cpu().numpy() for a in rows], k)


def batch_spectrum_triples(codes, k: int, canonical: bool = False,
                           max_len: int | None = None, *,
                           device: torch.device | str):
    """Host (hi, lo, counts) of ONE numpy code batch for the sparse
    accumulators, counted by per-read row sorts on ``device`` (the
    rowsort kernels on a GPU): the accumulators merge row-level
    uniques exactly like batch-level ones.

    ``max_len``: the batch's true longest read, not the padded width;
    the rows are cut to its window count before the device→host copy
    (:func:`valid_pair_prefix`; the pad columns hold no run start).
    """
    w = max(max_len or codes.shape[-1], k) - k + 1
    rows = count_perread_rows(torch.from_numpy(codes).to(device), k, canonical)
    rows = valid_pair_prefix(narrow_for_fetch(rows, k), w)
    return fetched_to_triples([a.cpu().numpy() for a in rows], k)
