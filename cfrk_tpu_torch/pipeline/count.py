"""End-to-end file counting: FASTA in → `.cfrk` rows or spectra out.

The counterpart of the single-device, in-memory drivers of
``cfrk_tpu/pipeline/count.py``; each takes the ``device`` its batches
run on (a CUDA device goes through the CUDA kernels, the CPU through
the plain route):

* :func:`count_file_sparse_rows`: parse → fixed-shape padded batches →
  the per-read sort + RLE → narrowed device→host copy → `.cfrk` writer;
* :func:`count_reads` / :func:`count_file`: the dense per-read API,
  ``[n_reads, 4**k]`` int32 (at k = 8, 256 KB per read on the host);
  :func:`count_file_dense_rows` writes the same counts to a `.cfrk`
  file one batch at a time, so host memory holds one batch;
* :func:`spectrum_file`: one dense ``4**k`` spectrum, either on the
  device per batch (:class:`DenseSpectrumAccumulator`, int32 table with
  an int64 host spill) or through the sorted route (per-read row sorts,
  host fold; :func:`_use_sorted_spectrum`);
* :func:`sparse_spectrum_arrays` / :func:`sparse_spectrum_file`: the
  sparse spectrum for any k <= 31 through the sorted route.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..format import CfrkWriter
from ..io.fasta import read_fasta_encoded
from ..ops.cuda.perread import (
    DEFAULT_READ_BLOCK,
    packed_auto,
    perread_hist,
    resolve_packed,
    unpack_counts,
)
from ..ops.perread import count_perread
from ..ops.perread_sparse import (
    batch_spectrum_triples,
    count_perread_rows,
    narrow_for_fetch,
    pairs_to_host,
)
from ..ops.sparse import DenseFoldAccumulator, SparseAccumulator
from ..ops.cuda.spectrum import SPECTRUM_MAX_K
from ..ops.spectrum import spectrum as spectrum_op
from .batch import auto_batch_size, iter_batches, round_up

__all__ = [
    "count_reads",
    "count_file",
    "count_file_dense_rows",
    "count_file_sparse_rows",
    "write_cfrk",
    "spectrum_file",
    "sparse_spectrum_arrays",
    "sparse_spectrum_file",
    "SPILL_LIMIT",
    "iter_spill_chunks",
    "DenseSpectrumAccumulator",
]

# Dense-spectrum device tables accumulate in int32; any single bin is
# bounded by the windows accumulated since the last spill, so staying
# below this keeps every bin exact.  The 2**27 headroom keeps the
# comparison itself safely signed.
SPILL_LIMIT = 2**31 - 2**27


def iter_spill_chunks(codes: np.ndarray, k: int, limit: int = SPILL_LIMIT):
    """Split one numpy batch so no single dispatch sees >= ``limit``
    windows.

    A lone batch of long repeat-dominated contigs could otherwise wrap
    an int32 bin inside one dispatch, before the accumulator's spill
    guard runs.  Splits rows first; if even one row reaches the limit,
    slices the position axis with k-1 overlap, which is exact for a
    global spectrum because every window lands in exactly one slice.
    """
    b, length = codes.shape
    w = length - k + 1
    if b * w < limit:
        yield codes
        return
    rows = max(1, (limit - 1) // max(w, 1))
    if rows * w < limit:
        for s in range(0, b, rows):
            yield codes[s : s + rows]
        return
    step = max(1, (limit - 1) // rows)
    for r in range(0, b, rows):
        rchunk = codes[r : r + rows]
        for s in range(0, w, step):
            yield rchunk[:, s : min(s + step + k - 1, length)]


class DenseSpectrumAccumulator:
    """int32-on-device dense-spectrum accumulation with int64 host spill.

    The overflow discipline of the JAX package: every dispatch AND the
    running device table stay below ``limit`` windows, so no int32 bin
    can wrap.  ``dispatch(codes, table)`` adds a code tensor's counts
    into ``table`` in place and returns it (``table`` is None for the
    first batch after a spill, and the dispatch makes a zeroed one), so
    one device table serves every batch; at k = 15 it is 4 GB.  ``base``
    is the flattened int64 host table; a spill adds into it in place.
    """

    def __init__(self, k: int, dispatch, base: np.ndarray, *,
                 device: torch.device | str, limit: int = SPILL_LIMIT):
        self.k = k
        self.base = base
        self._dispatch = dispatch
        self._device = torch.device(device)
        self._dev = None
        self._windows = 0
        self._limit = limit

    def add(self, codes: np.ndarray) -> None:
        for chunk in iter_spill_chunks(codes, self.k, self._limit):
            bw = chunk.shape[0] * (chunk.shape[1] - self.k + 1)
            if self._windows + bw >= self._limit:
                self.spill()
            arr = torch.from_numpy(np.ascontiguousarray(chunk)).to(self._device)
            self._dev = self._dispatch(arr, self._dev)
            self._windows += bw

    @property
    def windows(self) -> int:
        """Windows accumulated on the device since the last spill."""
        return self._windows

    def spill(self) -> None:
        """Fold the device table into the host int64 base."""
        if self._dev is not None:
            np.add(self.base, self._dev.cpu().numpy(), out=self.base)
            self._dev = None
        self._windows = 0

    def total(self) -> np.ndarray:
        self.spill()
        return self.base


def _plan_shapes(reads: Sequence[np.ndarray], k: int, batch_size: int | None,
                 max_len: int | None) -> tuple[int, int | None]:
    """Batch size + pad length.  ``None`` pad length means per-batch
    geometric buckets (iter_batches): a lone long contig then widens
    only its own batch."""
    bs = min(batch_size or auto_batch_size(), max(len(reads), 1))
    if max_len is not None:
        return bs, max_len
    longest = max((len(r) for r in reads), default=1)
    if longest <= 512:
        # Uniform short reads: one shared batch shape.
        return bs, round_up(max(longest, k), 128)
    return bs, None


def dense_counts_on_device(codes: torch.Tensor, k: int, canonical: bool,
                           impl: str):
    """One padded batch's dense counts on its device: ``(counts, packing)``.

    Where :func:`packed_auto` holds (CUDA, 5 <= k <= 8, short rows) the
    kernel emits the densest safe packed layout, 1 or 2 bytes per bin
    of device write and device→host copy; ``packing`` names it.
    Otherwise ``count_perread`` runs ``impl`` with int16 counts (exact:
    they are bounded by the windows per read) where the rows allow,
    and ``packing`` is False.
    """
    w = codes.shape[1] - k + 1
    if packed_auto(impl, k, w, codes.device):
        packing = resolve_packed(True, w)
        return perread_hist(codes, k, canonical, packed=packing,
                            read_block=DEFAULT_READ_BLOCK), packing
    odt = torch.int16 if w < 2**15 else torch.int32
    return count_perread(codes, k, canonical=canonical, impl=impl,
                         out_dtype=odt), False


def dense_counts_to_host(counts, n_reads: int, packing) -> np.ndarray:
    """A batch's device counts → its ``[n_reads, 4**k]`` int32 rows
    (the packed layouts unpack on the host)."""
    host = counts.cpu().numpy()
    if packing:
        return unpack_counts(host, n_reads, mode=packing)
    return host[:n_reads].astype(np.int32)


def iter_dense_counts(reads: Sequence[np.ndarray], k: int, *,
                      device: torch.device | str, canonical: bool = False,
                      impl: str = "auto", batch_size: int | None = None,
                      max_len: int | None = None):
    """Each batch's ``[n_reads, 4**k]`` int32 counts, in read order.

    A plain loop: the device→host copy of a batch synchronises before
    the next batch is dispatched (the JAX package keeps two batches in
    flight behind XLA's asynchronous dispatch).
    """
    if not reads:
        return
    device = torch.device(device)
    bs, ml = _plan_shapes(reads, k, batch_size, max_len)
    for batch in iter_batches(reads, bs, ml):
        codes = torch.from_numpy(batch.codes).to(device)
        counts, packing = dense_counts_on_device(codes, k, canonical, impl)
        yield dense_counts_to_host(counts, batch.n_reads, packing)


def count_reads(reads: Sequence[np.ndarray], k: int, *,
                device: torch.device | str, canonical: bool = False,
                impl: str = "auto", batch_size: int | None = None,
                max_len: int | None = None) -> np.ndarray:
    """Per-read dense histograms of a ragged list of encoded reads:
    ``[n_reads, 4**k]`` int32, batches run on ``device``."""
    out = np.zeros((len(reads), 4**k), dtype=np.int32)
    row = 0
    for counts in iter_dense_counts(reads, k, device=device, canonical=canonical,
                                    impl=impl, batch_size=batch_size,
                                    max_len=max_len):
        out[row : row + len(counts)] = counts
        row += len(counts)
    return out


def count_file(path, k: int, *, device: torch.device | str, min_qual: int = 0,
               **kw) -> np.ndarray:
    """Count a FASTA/FASTQ file: returns ``[n_reads, 4**k]`` int32.

    ``min_qual`` masks FASTQ bases below that Phred quality."""
    return count_reads(read_fasta_encoded(path, min_qual), k, device=device, **kw)


def count_file_dense_rows(
    path,
    out_path,
    k: int,
    *,
    device: torch.device | str,
    canonical: bool = False,
    impl: str = "auto",
    batch_size: int | None = None,
    max_len: int | None = None,
    min_qual: int = 0,
    nonzero: bool = False,
) -> int:
    """:func:`count_file` straight to a `.cfrk` file, batch by batch:
    the bytes of ``CfrkWriter(out_path, nonzero=nonzero).write_batch``
    over the whole matrix, with one batch on the host at a time.
    Returns the number of reads written."""
    reads = read_fasta_encoded(path, min_qual)
    n_written = 0
    with CfrkWriter(out_path, nonzero=nonzero) as w:
        for counts in iter_dense_counts(reads, k, device=device,
                                        canonical=canonical, impl=impl,
                                        batch_size=batch_size, max_len=max_len):
            w.write_batch(counts)
            n_written += len(counts)
    return n_written


def write_cfrk(path, counts: np.ndarray) -> None:
    """Write counts to a `.cfrk` file (exact reference byte format)."""
    with CfrkWriter(path) as w:
        w.write_batch(counts)


def count_file_sparse_rows(
    path,
    out_path,
    k: int,
    *,
    device: torch.device | str,
    canonical: bool = False,
    batch_size: int | None = None,
    max_len: int | None = None,
    min_qual: int = 0,
    nonzero: bool = True,
) -> int:
    """Per-read rows of a FASTA/FASTQ file, streamed straight to disk.

    ``nonzero=True`` writes the ``idx:count`` cells of each read (for
    k > 15 the idx is the combined code ``hi * 4**15 + lo``);
    ``nonzero=False`` (k <= 8 only) writes dense rows, densified on host
    from the same pairs.  The batches run on ``device``: a CUDA device
    goes through the CUDA kernels, the CPU through the plain route.
    Returns the number of reads written.
    """
    if not nonzero and k > 8:
        raise ValueError("dense rows require k <= 8")
    device = torch.device(device)
    reads = read_fasta_encoded(path, min_qual)
    n_written = 0
    with CfrkWriter(out_path) as w:
        if not reads:
            return 0
        bs, ml = _plan_shapes(reads, k, batch_size, max_len)
        for batch in iter_batches(reads, bs, ml):
            codes = torch.from_numpy(batch.codes).to(device)
            out = count_perread_rows(codes, k, canonical)
            idx, counts = pairs_to_host(narrow_for_fetch(out, k), batch.n_reads)
            if nonzero:
                w.write_pairs(idx, counts)
            else:
                w.write_pairs_dense(idx, counts, 4**k)
            n_written += batch.n_reads
    return n_written


def spectrum_file(
    path,
    k: int,
    *,
    device: torch.device | str,
    canonical: bool = False,
    impl: str = "auto",
    batch_size: int | None = None,
    max_len: int | None = None,
    min_qual: int = 0,
) -> np.ndarray:
    """Global spectrum of a FASTA/FASTQ file: returns [4**k] int64."""
    device = torch.device(device)
    reads = read_fasta_encoded(path, min_qual)
    total = np.zeros(4**k, dtype=np.int64)
    if not reads:
        return total
    bs, ml = _plan_shapes(reads, k, batch_size, max_len)
    if _use_sorted_spectrum(k, impl, device):
        keys, counts = _sorted_spectrum_batches(
            iter_batches(reads, bs, ml), k, canonical, device
        )
        total[keys] = counts
        return total

    def dispatch(arr, table):
        return spectrum_op(arr, k, canonical=canonical, impl=impl, out=table)

    acc = DenseSpectrumAccumulator(k, dispatch, total, device=device)
    for batch in iter_batches(reads, bs, ml):
        acc.add(batch.codes)
    return acc.total()


def _use_sorted_spectrum(k: int, impl: str, device: torch.device) -> bool:
    """Route a dense spectrum through the per-read sort + RLE rows.

    ``impl='sort'`` forces it for any k on any device.  ``auto`` takes it
    on a CUDA device for k above the histogram kernel's range (k >= 11).
    The JAX package crosses over at k >= 9 on a TPU, where its one-hot
    kernel's cost grows with 4**ceil(k/2); on an H100 the histogram
    kernel into one running device table is faster than the sorted
    route per batch by far more than 10x at k = 9 and 10, on random and
    on skewed reads alike (``chip_smoke.py`` times both; PERF.md), and
    it needs no per-batch copy to the host.  k = 11-15 keeps the JAX
    package's rule.
    """
    if impl == "sort":
        return True
    if k <= SPECTRUM_MAX_K:
        return False
    return impl == "auto" and device.type == "cuda"


def _sorted_spectrum_batches(batches, k: int, canonical: bool,
                             device: torch.device):
    """Accumulate batches through per-read row sorts on ``device``;
    returns the merged, key-sorted (keys, counts) arrays.  k <= 10 folds
    into a dense host table (<= 8 MB), larger k merges sparsely."""
    acc = DenseFoldAccumulator(k) if k <= 10 else SparseAccumulator()
    for batch in batches:
        acc.add(*batch_spectrum_triples(
            batch.codes, k, canonical,
            max_len=int(batch.lengths.max(initial=0)), device=device,
        ))
    return acc.result_arrays()


def sparse_spectrum_arrays(
    path,
    k: int,
    *,
    device: torch.device | str,
    canonical: bool = False,
    batch_size: int | None = None,
    max_len: int | None = None,
    min_qual: int = 0,
):
    """Sparse spectrum of a FASTA/FASTQ file for any k <= 31: the
    key-sorted (keys uint64, counts int64) arrays of every distinct
    k-mer, ``key = hi * 4**15 + lo`` (the k-mer's base-4 code).  Each
    batch's per-read rows are sorted and run-length encoded on
    ``device``; the batches merge on the host."""
    device = torch.device(device)
    reads = read_fasta_encoded(path, min_qual)
    acc = SparseAccumulator()
    if reads:
        bs, ml = _plan_shapes(reads, k, batch_size, max_len)
        for batch in iter_batches(reads, bs, ml):
            acc.add(*batch_spectrum_triples(
                batch.codes, k, canonical,
                max_len=int(batch.lengths.max(initial=0)), device=device,
            ))
    return acc.result_arrays()


def sparse_spectrum_file(path, k: int, **kw) -> dict:
    """:func:`sparse_spectrum_arrays` as the JAX package returns it:
    {int_kmer_code: count}."""
    keys, counts = sparse_spectrum_arrays(path, k, **kw)
    return dict(zip(keys.tolist(), counts.tolist()))
