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
triples (:func:`fetch_triples` a mesh's bucket-routed spectrum), and the accumulators fold them across batches --
:class:`SparseAccumulator` (sorted (keys uint64, counts int64) arrays,
numpy) for any k; :class:`SpillingSparseAccumulator`, the same under a
host-memory budget, which spills sorted runs to disk (``.npy`` pairs,
read back by offset, never mmap) and merges them in bounded chunks;
:class:`DenseFoldAccumulator` (an int64 ``4**k`` table, through the
host library's threaded fold, ``io/native``) for k <= 10.  All take the
JAX package's accumulator arrays and spill runs as they are.  The
device half (``batch_spectrum_triples``, ``rows_to_triples``) lives in
``ops/perread_sparse.py``, beside the drain it runs.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from ..io import native
from .encode import horner, shifted_views

__all__ = [
    "MAX_SPARSE_K",
    "LO_BASES",
    "INVALID_SENTINEL",
    "kmer_keys",
    "sparse_spectrum",
    "fetch_triples",
    "fetched_to_triples",
    "merge_sorted_key_counts",
    "merge_sorted_spectra",
    "SparseAccumulator",
    "SpillingSparseAccumulator",
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


def sparse_spectrum(codes: torch.Tensor, k: int, canonical: bool = False):
    """Distinct-k-mer counts of one batch, sort-based, on the batch's
    device (``torch.sort``, as the JAX package's is XLA's sort).

    codes: [B, L] int8 → (hi, lo, counts), each [B*(L-k+1)]: the keys
    sorted, position i holding a distinct key and its int32 count iff it
    starts a run, else ``INVALID_SENTINEL`` in both words and count 0.
    hi and lo are int64 tensors of uint32 values, as from
    :func:`kmer_keys`.
    """
    from .cuda.rowsort import rle_rows

    hi, lo = kmer_keys(codes, k, canonical)
    lo = lo.reshape(-1)
    if k <= LO_BASES:
        # hi is 0 for every valid key and the sentinel exactly when lo
        # is: lo alone sorts in the (hi, lo) order.
        lo = torch.sort(lo).values
        ulo, counts = rle_rows(lo[None, :], (lo != INVALID_SENTINEL)[None, :],
                               INVALID_SENTINEL)
        ulo, counts = ulo[0], counts[0]
        return torch.where(counts > 0, 0, INVALID_SENTINEL), ulo, counts
    # One int64 key hi * 4**15 + lo orders valid keys as (hi, lo) does
    # (lo < 4**15); invalid windows sort last under the largest key.
    # Validity is judged on lo: at k = 31 a hi of 16 T bases equals the
    # sentinel.
    last = torch.iinfo(torch.int64).max
    key = torch.where(lo != INVALID_SENTINEL, (hi.reshape(-1) << (2 * LO_BASES)) | lo,
                      last)
    key = torch.sort(key).values
    ukey, counts = rle_rows(key[None, :], (key != last)[None, :], last)
    ukey, counts = ukey[0], counts[0]
    run = counts > 0
    return (torch.where(run, ukey >> (2 * LO_BASES), INVALID_SENTINEL),
            torch.where(run, ukey & (4**LO_BASES - 1), INVALID_SENTINEL), counts)


def fetch_triples(hi, lo, counts, k: int):
    """Device (hi, lo, counts) tensors of a sparse spectrum → host
    (hi uint32, lo uint32, counts int32) for the accumulators.  For
    k <= LO_BASES hi is 0 for every valid key, so it is not copied:
    host zeros stand for it (sentinel cells carry count 0, which every
    consumer masks)."""
    nplo = lo.cpu().numpy().astype(np.uint32)
    if k <= LO_BASES:
        nphi = np.zeros(nplo.shape, dtype=np.uint32)
    else:
        nphi = hi.cpu().numpy().astype(np.uint32)
    return nphi, nplo, counts.cpu().numpy()


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


def _pack_keys(hi, lo, counts):
    """(hi, lo, counts) cells with count > 0 → (keys uint64, counts
    int64).  The mask comes first: a sentinel cell's words (or a uint16
    idx that wrapped) never reach a key."""
    mask = counts > 0
    keys = (hi[mask].astype(np.uint64) << np.uint64(2 * LO_BASES)) | lo[
        mask
    ].astype(np.uint64)
    return keys, counts[mask].astype(np.int64)


def merge_sorted_spectra(parts) -> dict:
    """Per-batch (hi, lo, counts) triples → {int_kmer_code: count}, the
    full code being ``hi * 4**LO_BASES + lo``; one vectorised reduction
    over all batches."""
    uniq, sums = merge_sorted_key_counts([_pack_keys(*t) for t in parts])
    return dict(zip(uniq.tolist(), sums.tolist()))


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
        self._pending.append(_pack_keys(hi, lo, counts))
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

    def result(self) -> dict:
        """Final {int_kmer_code: count} dict (the JAX package's API)."""
        keys, counts = self.result_arrays()
        return dict(zip(keys.tolist(), counts.tolist()))

    def result_arrays(self):
        """Final (keys uint64, counts int64), sorted by key."""
        self._fold()
        return self.keys, self.counts

    def load_arrays(self, keys, counts) -> None:
        """Restore (keys, counts) state, such as another accumulator's
        ``result_arrays`` or a checkpoint's."""
        self.keys = np.asarray(keys, dtype=np.uint64)
        self.counts = np.asarray(counts, dtype=np.int64)
        self._pending = []

    def iter_merged_chunks(self, chunk: int | None = None):
        """Ascending (keys, counts) chunks: the streamed-output interface
        of every accumulator (the spilling one merges its disk runs
        here)."""
        yield from _chunks(*self.result_arrays(), chunk)


def _chunks(keys, counts, chunk):
    chunk = chunk or (1 << 24)
    for s in range(0, len(keys), chunk):
        yield keys[s : s + chunk], counts[s : s + chunk]


class _RunArray:
    """Bounded-memory reader over one spilled ``.npy`` run.  Slices come
    by offset reads (``np.fromfile``), never mmap: in a multiway merge
    every page an mmap touches stays resident, and the resident set
    grows by the TOTAL run bytes (the JAX package measured 16 GB at a
    429M-key merge)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            self._off = f.tell()
        if fortran or len(shape) != 1:
            raise ValueError(f"unexpected spill run layout in {path}")
        self._n = int(shape[0])
        self.dtype = np.dtype(dtype)

    def __len__(self) -> int:
        return self._n

    def read(self, start: int, count: int) -> np.ndarray:
        count = max(0, min(count, self._n - start))
        return np.fromfile(
            self.path, dtype=self.dtype, count=count,
            offset=self._off + start * self.dtype.itemsize,
        )

    def key_at(self, i: int):
        return self.read(i, 1)[0]


class _MemArray:
    """The in-memory (keys or counts) remainder, with :class:`_RunArray`'s
    interface."""

    def __init__(self, a: np.ndarray):
        self._a = a

    def __len__(self) -> int:
        return len(self._a)

    def read(self, start: int, count: int) -> np.ndarray:
        return self._a[start : start + count]

    def key_at(self, i: int):
        return self._a[i]


# Bytes a merge pass holds per key of its window, per run: the key and
# count read (16 B), their concatenation, the argsort's index and the
# gathered copies -- about six times the 16 B.
_MERGE_BYTES_PER_KEY = 6 * 16


class SpillingSparseAccumulator(SparseAccumulator):
    """:class:`SparseAccumulator` under a host-memory budget.

    When the merged arrays plus the pending batches reach a quarter of
    ``budget_bytes`` (the fold inside :meth:`spill_run` transiently
    holds about twice that), they are folded and written to
    ``spill_dir`` as one sorted-unique run (``runNNNNN.keys.npy`` /
    ``runNNNNN.counts.npy``, fsynced) and accumulation restarts empty.
    The result is a bounded-memory multiway merge of the runs and the
    in-memory remainder (:meth:`iter_merged_chunks`).  Runs are also
    the checkpoint unit: a checkpoint spills the in-memory state and
    records the run list, O(new data) per checkpoint.  The run files
    and their names are the JAX package's, so either package adopts the
    other's runs.
    """

    def __init__(self, spill_dir: str, budget_bytes: int,
                 merge_every: int = 32):
        super().__init__(merge_every=merge_every)
        self.spill_dir = str(spill_dir)
        self.budget_bytes = int(budget_bytes)
        self.run_files: list[str] = []  # run basenames, spill order
        self._run_seq = 0

    def add(self, hi, lo, counts) -> None:
        super().add(hi, lo, counts)
        # The budget sees everything held: the merged arrays AND the
        # pending batches (up to merge_every of them between folds).
        pend = sum(pk.nbytes + pc.nbytes for pk, pc in self._pending)
        if (
            self.keys.nbytes + self.counts.nbytes + pend
            >= max(self.budget_bytes // 4, 1 << 12)
        ):
            self.spill_run()

    def spill_run(self) -> None:
        """Write the merged in-memory arrays to disk as one sorted run
        (durable: the data fsynced, then the rename, then the
        directory)."""
        self._fold()
        if not len(self.keys):
            return
        os.makedirs(self.spill_dir, exist_ok=True)
        base = f"run{self._run_seq:05d}"
        self._run_seq += 1
        for name, arr in (("keys", self.keys), ("counts", self.counts)):
            p = os.path.join(self.spill_dir, f"{base}.{name}.npy")
            tmp = p + ".tmp.npy"
            with open(tmp, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, p)
        dfd = os.open(self.spill_dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self.run_files.append(base)
        self.keys = np.empty(0, dtype=np.uint64)
        self.counts = np.empty(0, dtype=np.int64)

    def checkpoint_runs(self) -> list[str]:
        """Spill the pending and in-memory state; returns the run list
        for the checkpoint JSON."""
        self.spill_run()
        return list(self.run_files)

    def adopt_runs(self, run_files) -> None:
        """Resume from a checkpointed run list: keep exactly those runs
        and delete every other file of the spill directory (runs spilled
        after the last durable checkpoint would double-count the batches
        the resume replays).  A listed run that is missing raises
        ValueError."""
        self.run_files = [str(b) for b in run_files]
        seqs = [
            int(b[3:]) for b in self.run_files
            if b.startswith("run") and b[3:].isdigit()
        ]
        self._run_seq = max(seqs, default=-1) + 1
        keep = {
            f"{b}.{part}.npy"
            for b in self.run_files
            for part in ("keys", "counts")
        }
        if os.path.isdir(self.spill_dir):
            for fn in os.listdir(self.spill_dir):
                if fn not in keep:
                    try:
                        os.remove(os.path.join(self.spill_dir, fn))
                    except OSError:
                        pass
        missing = sorted(
            fn for fn in keep
            if not os.path.exists(os.path.join(self.spill_dir, fn))
        )
        if missing:
            raise ValueError(f"checkpoint spill runs missing: {missing}")
        self.keys = np.empty(0, dtype=np.uint64)
        self.counts = np.empty(0, dtype=np.int64)
        self._pending = []

    def _open_runs(self):
        return [
            (_RunArray(os.path.join(self.spill_dir, f"{b}.keys.npy")),
             _RunArray(os.path.join(self.spill_dir, f"{b}.counts.npy")))
            for b in self.run_files
        ]

    def merge_chunk(self, n_runs: int) -> int:
        """Keys a merge pass reads from each of ``n_runs`` runs so that
        the pass stays within the budget (at least 1)."""
        return int(min(
            max(self.budget_bytes // (_MERGE_BYTES_PER_KEY * max(n_runs, 1)), 1),
            1 << 25,
        ))

    def iter_merged_chunks(self, chunk: int | None = None):
        """The merged spectrum as ascending (keys, counts) chunks: every
        key lies in exactly ONE chunk (so chunk-local duplicate sums are
        exact) and keys strictly increase across chunks.  Runs are read
        by window (:class:`_RunArray`), so the peak is O(runs x chunk),
        and the default chunk keeps it within the budget."""
        self._fold()
        runs = self._open_runs()
        if len(self.keys):
            runs.append((_MemArray(self.keys), _MemArray(self.counts)))
        if not runs:
            return
        chunk = chunk or self.merge_chunk(len(runs))
        cursors = [0] * len(runs)
        while True:
            # Pivot: the smallest window-end key over the active runs.
            # Runs are sorted-unique, so every element <= pivot of ANY
            # run lies within that run's next (chunk+1)-wide window: one
            # pass takes exactly the global prefix <= pivot.
            pivot = None
            for (ks, _), c in zip(runs, cursors):
                if c < len(ks):
                    cand = ks.key_at(min(c + chunk, len(ks) - 1))
                    if pivot is None or cand < pivot:
                        pivot = cand
            if pivot is None:
                return
            parts_k: list = []
            parts_c: list = []
            for r, (ks, cs) in enumerate(runs):
                c = cursors[r]
                if c >= len(ks):
                    continue
                win = ks.read(c, chunk + 1)
                e = int(np.searchsorted(win, pivot, side="right"))
                if e == 0:
                    continue
                parts_k.append(win[:e])
                parts_c.append(cs.read(c, e))
                cursors[r] = c + e
            if len(parts_k) == 1:
                # One run in this key range: already sorted-unique.
                yield parts_k[0], parts_c[0]
                continue
            yield merge_sorted_key_counts(list(zip(parts_k, parts_c)))

    def result_arrays(self):
        if not self.run_files:
            return super().result_arrays()
        # A run is never empty (spill_run skips an empty state), so there
        # is at least one chunk.
        ks, cs = zip(*self.iter_merged_chunks())
        return np.concatenate(ks), np.concatenate(cs)

    def cleanup_spill(self) -> None:
        """Remove every spill file and the directory (end of run)."""
        shutil.rmtree(self.spill_dir, ignore_errors=True)


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
        self.add_pairs(lo, counts)

    def add_pairs(self, idx, counts) -> None:
        """Fold a drained (idx, counts) pair as it is: the host
        library's fold reads the uint16 / int32 idx and the uint8 /
        int16 counts directly, so no widening copy touches the pair
        buffers.  An int16 idx is the drain's bit view of uint16."""
        idx = np.asarray(idx)
        if idx.dtype == np.int16:
            idx = idx.view(np.uint16)
        native.fold_pairs_into(self.table, idx, np.asarray(counts))

    def result_arrays(self):
        keys = np.flatnonzero(self.table)
        return keys.astype(np.uint64), self.table[keys]

    def iter_merged_chunks(self, chunk: int | None = None):
        yield from _chunks(*self.result_arrays(), chunk)

    def load_arrays(self, keys, counts) -> None:
        self.table[:] = 0
        self.table[np.asarray(keys, dtype=np.int64)] = np.asarray(
            counts, dtype=np.int64
        )


def decode_key(key: int, k: int) -> str:
    """Integer k-mer code → base string."""
    bases = "ACGT"
    return "".join(bases[(key >> (2 * (k - 1 - i))) & 3] for i in range(k))
