"""Sparse k-mer spectra: the (hi, lo) key split and the host side of
``cfrk_tpu/ops/sparse.py``.

A k-mer (k <= 31) is the pair of uint32 words

    hi = first k-15 bases (<= 16 bases = 32 bits),
    lo = last 15 bases   (30 bits),

and invalid windows carry ``INVALID_SENTINEL`` in both words.  torch has
few uint32 operations, so :func:`kmer_keys` returns the words in int64
tensors holding the uint32 values.

The rest is host code, as in the JAX package: :func:`fetched_to_triples`
turns a drained batch of per-read rows into flat (hi, lo, counts)
triples, and the accumulators fold them across batches --
:class:`SparseAccumulator` (sorted (keys uint64, counts int64) arrays,
numpy) for any k, :class:`DenseFoldAccumulator` (an int64 ``4**k``
table, through the host library's threaded fold, ``io/native``) for
k <= 10.  Both take the JAX
package's accumulator arrays as they are (``load_arrays``).  The
device half (``batch_spectrum_triples``, ``rows_to_triples``) lives in
``ops/perread_sparse.py``, beside the drain it runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io import native
from .encode import horner, shifted_views

__all__ = [
    "MAX_SPARSE_K",
    "LO_BASES",
    "INVALID_SENTINEL",
    "kmer_keys",
    "fetched_to_triples",
    "merge_sorted_key_counts",
    "SparseAccumulator",
    "DenseFoldAccumulator",
    "fold_pairs_into",
    "decode_key",
]

MAX_SPARSE_K = 31
LO_BASES = 15
INVALID_SENTINEL = 0xFFFFFFFF


def kmer_keys(codes: torch.Tensor, k: int, canonical: bool = False):
    """All window keys of a padded batch.

    codes: [..., L] int8 → (hi, lo) int64 tensors of uint32 values,
    shape [..., L-k+1]; invalid windows have hi == lo == INVALID_SENTINEL.
    Canonical keys are the lexicographic (hi, lo) minimum with the
    reverse complement (a tie keeps the forward key, which is equal).
    """
    if not 1 <= k <= MAX_SPARSE_K:
        raise ValueError(f"k must be in [1, {MAX_SPARSE_K}]")
    views, valid = shifted_views(codes, k, torch.int64)
    kh = max(k - LO_BASES, 0)  # leading bases in hi (0 for k <= 15)
    hi, lo = horner(views[:kh], views[0]), horner(views[kh:], views[0])
    if canonical:
        rviews = [3 - v for v in reversed(views)]
        rc_hi = horner(rviews[:kh], views[0])
        rc_lo = horner(rviews[kh:], views[0])
        fwd_smaller = (hi < rc_hi) | ((hi == rc_hi) & (lo <= rc_lo))
        hi = torch.where(fwd_smaller, hi, rc_hi)
        lo = torch.where(fwd_smaller, lo, rc_lo)
    hi = torch.where(valid, hi, INVALID_SENTINEL)
    lo = torch.where(valid, lo, INVALID_SENTINEL)
    return hi, lo


def fetched_to_triples(arrs, k: int):
    """Drained host arrays of per-read rows → flat (hi, lo, counts).

    ``arrs`` are the numpy copies of a :func:`narrow_for_fetch` result:
    (idx, counts) for k <= 15, (hi, lo, counts) above.  The drain's
    int16 and int32 bit views are read back as the JAX package's uint16
    idx and uint32 key words; counts keep their narrow dtype (both
    accumulators consume them as they are).  A uint16 idx wraps the
    sentinel to 0, but sentinel cells carry count 0 and every consumer
    masks counts > 0.
    """
    if len(arrs) == 2:
        idx, cnt = arrs
        if idx.dtype == np.int16:
            idx = idx.view(np.uint16)
        lo = idx.reshape(-1)
        # hi is structurally zero for k <= 15: a broadcast view.
        return np.broadcast_to(np.uint32(0), lo.shape), lo, cnt.reshape(-1)
    hi, lo, counts = (a.reshape(-1) for a in arrs)
    return hi.view(np.uint32), lo.view(np.uint32), counts


def merge_sorted_key_counts(parts):
    """Merge [(keys uint64 sorted-unique, counts int64), ...] pairs into
    one sorted-unique (keys, counts) pair, summing duplicate keys
    (argsort + ``add.reduceat``)."""
    ks = [np.asarray(k, dtype=np.uint64) for k, _ in parts]
    cs = [np.asarray(c, dtype=np.int64) for _, c in parts]
    if not ks:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    all_k = np.concatenate(ks)
    all_c = np.concatenate(cs)
    if not len(all_k):
        return all_k, all_c
    order = np.argsort(all_k, kind="stable")
    sk = all_k[order]
    sc = all_c[order]
    starts = np.r_[0, np.flatnonzero(sk[1:] != sk[:-1]) + 1]
    return sk[starts], np.add.reduceat(sc, starts)


class SparseAccumulator:
    """Bounded-memory accumulator for sparse spectra across batches.

    Holds one merged, key-sorted (keys uint64, counts int64) pair of
    arrays; incoming batch triples are buffered and folded in every
    ``merge_every`` batches, so peak memory is O(distinct k-mers +
    merge_every x batch windows).
    """

    def __init__(self, merge_every: int = 32):
        self.keys = np.empty(0, dtype=np.uint64)
        self.counts = np.empty(0, dtype=np.int64)
        self._pending: list = []
        self._merge_every = merge_every

    def add(self, hi, lo, counts) -> None:
        mask = counts > 0
        keys = (hi[mask].astype(np.uint64) << np.uint64(2 * LO_BASES)) | lo[
            mask
        ].astype(np.uint64)
        self._pending.append((keys, counts[mask].astype(np.int64)))
        if len(self._pending) >= self._merge_every:
            self._fold()

    def _fold(self) -> None:
        """Fold the pending triples into the sorted arrays: collapse the
        pending buffer alone (argsort + ``add.reduceat``), then one
        searchsorted pass against the accumulator -- hits add in place,
        new keys are interleaved in one allocation."""
        if not self._pending:
            return
        pk = np.concatenate([k for k, _ in self._pending])
        pc = np.concatenate([c for _, c in self._pending])
        self._pending = []
        if not len(pk):
            return
        pk, pc = merge_sorted_key_counts([(pk, pc)])
        if not len(self.keys):
            self.keys, self.counts = pk, pc
            return
        pos = np.searchsorted(self.keys, pk)
        pos_c = np.minimum(pos, len(self.keys) - 1)
        hit = self.keys[pos_c] == pk
        out_c = self.counts.copy()
        out_c[pos_c[hit]] += pc[hit]  # collapsed keys are unique
        new_k = pk[~hit]
        new_c = pc[~hit]
        if not len(new_k):
            self.counts = out_c
            return
        # Each old row shifts right by the number of new keys before it;
        # each new row lands at its insertion point plus its own rank.
        idx = np.arange(len(self.keys)) + np.searchsorted(
            new_k, self.keys, side="right"
        )
        nidx = np.searchsorted(self.keys, new_k) + np.arange(len(new_k))
        out_keys = np.empty(len(self.keys) + len(new_k), dtype=np.uint64)
        out_counts = np.empty(len(out_keys), dtype=np.int64)
        out_keys[idx] = self.keys
        out_counts[idx] = out_c
        out_keys[nidx] = new_k
        out_counts[nidx] = new_c
        self.keys, self.counts = out_keys, out_counts

    def result_arrays(self):
        """Final (keys uint64, counts int64), sorted by key."""
        self._fold()
        return self.keys, self.counts

    def load_arrays(self, keys, counts) -> None:
        """Restore (keys, counts) state, such as another accumulator's
        ``result_arrays``."""
        self.keys = np.asarray(keys, dtype=np.uint64)
        self.counts = np.asarray(counts, dtype=np.int64)
        self._pending = []


def fold_pairs_into(table: np.ndarray, idx: np.ndarray, counts: np.ndarray) -> None:
    """Add (idx, count) cells into a dense int64 ``table`` in place.

    ``idx``/``counts``: any shape, same size, in the drain's narrow
    dtypes; cells with count <= 0 (sentinels, padding) or an index
    outside the table are skipped.  A weighted bincount (float64
    weights, exact for any batch below 2**53 windows): the oracle of
    the host library's fold, ``io.native.fold_pairs_into``, which
    :class:`DenseFoldAccumulator` runs.
    """
    if table.dtype != np.int64 or not table.flags.writeable:
        raise ValueError("table must be a writable int64 array")
    if idx.size != counts.size:
        raise ValueError("idx/counts size mismatch")
    fi = idx.reshape(-1).astype(np.int64, copy=False)
    fc = counts.reshape(-1).astype(np.int64, copy=False)
    keep = (fc > 0) & (fi >= 0) & (fi < table.size)
    table += np.bincount(
        fi[keep], weights=fc[keep], minlength=table.size
    ).astype(np.int64)


class DenseFoldAccumulator:
    """:class:`SparseAccumulator` drop-in for small key spaces (k <= 10):
    each batch's (key, count) cells fold straight into a dense int64
    ``4**k`` table (<= 8 MB) instead of the searchsorted merge."""

    def __init__(self, k: int):
        if not 1 <= k <= 10:
            raise ValueError("DenseFoldAccumulator supports k <= 10")
        self.table = np.zeros(4**k, dtype=np.int64)

    def add(self, hi, lo, counts) -> None:
        # hi is structurally zero for every k <= 15 pair row.
        native.fold_pairs_into(self.table, np.asarray(lo), np.asarray(counts))

    def result_arrays(self):
        keys = np.flatnonzero(self.table)
        return keys.astype(np.uint64), self.table[keys]

    def load_arrays(self, keys, counts) -> None:
        self.table[:] = 0
        self.table[np.asarray(keys, dtype=np.int64)] = np.asarray(
            counts, dtype=np.int64
        )


def decode_key(key: int, k: int) -> str:
    """Integer k-mer code → base string."""
    bases = "ACGT"
    return "".join(bases[(key >> (2 * (k - 1 - i))) & 3] for i in range(k))
