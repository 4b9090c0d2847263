"""End-to-end file counting: FASTA in → `.cfrk` rows or spectra out.

The counterpart of the in-memory drivers of ``cfrk_tpu/pipeline/count.py``;
each takes the ``device`` its batches run on (a CUDA device goes through
the CUDA kernels, the CPU through the plain route) or a ``mesh`` of
devices (``parallel/``: rows over the devices, or with ``seqpar`` the
positions of long reads):

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
    rows_to_triples,
)
from ..ops.sparse import DenseFoldAccumulator, SparseAccumulator, fetch_triples
from ..ops.cuda.spectrum import SPECTRUM_MAX_K
from ..ops.encode import default_device
from ..ops.spectrum import spectrum as spectrum_op
from ..parallel.bucket import sparse_spectrum_sharded_retry
from ..parallel.seqpar import (
    count_perread_seqpar,
    spectrum_seqpar,
    spectrum_seqpar_triples,
)
from ..parallel.sharded import (
    count_perread_sharded,
    count_perread_sharded_packed,
    count_perread_sparse_sharded,
    spectrum_sharded,
)
from ..runtime.metrics import span
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


def iter_spill_chunks(codes: np.ndarray, k: int, row_multiple: int = 1,
                      len_multiple: int = 1, limit: int = SPILL_LIMIT):
    """Split one numpy batch so no single dispatch sees >= ``limit``
    windows.

    A lone batch of long repeat-dominated contigs could otherwise wrap
    an int32 bin inside one dispatch, before the accumulator's spill
    guard runs.  Splits rows first (chunks stay divisible by
    ``row_multiple`` for a dp mesh); if even the smallest row chunk
    reaches the limit, slices the position axis with k-1 overlap, which
    is exact for a global spectrum because every window lands in exactly
    one slice.  Position slices are padded with -1 columns to
    ``len_multiple`` (an sp mesh's divisibility); padding windows are
    invalid and count nothing.
    """
    b, length = codes.shape
    w = length - k + 1
    if b * w < limit:
        yield codes
        return
    rows = max(1, (limit - 1) // max(w, 1))
    rows = max(rows - rows % row_multiple, row_multiple)
    if rows * w < limit:
        for s in range(0, b, rows):
            yield codes[s : s + rows]
        return
    step = max(1, (limit - 1) // rows)
    for r in range(0, b, rows):
        rchunk = codes[r : r + rows]
        for s in range(0, w, step):
            sl = rchunk[:, s : min(s + step + k - 1, length)]
            pad = -sl.shape[1] % len_multiple
            if pad:
                sl = np.pad(sl, ((0, 0), (0, pad)), constant_values=-1)
            yield sl


class DenseSpectrumAccumulator:
    """int32-on-device dense-spectrum accumulation with int64 host spill.

    The overflow discipline of the JAX package: every dispatch AND the
    running device table stay below ``limit`` windows, so no int32 bin
    can wrap.  ``dispatch(codes, table)`` adds a code tensor's counts
    into ``table`` in place and returns it (``table`` is None for the
    first batch after a spill, and the dispatch makes a zeroed one), so
    one device table serves every batch; at k = 15 it is 4 GB.  ``base``
    is the flattened int64 host table; a spill adds into it in place.
    ``row_multiple`` / ``len_multiple`` keep the chunks of a split batch
    divisible by a mesh (:func:`iter_spill_chunks`).
    """

    def __init__(self, k: int, dispatch, base: np.ndarray, *,
                 device: torch.device | str, row_multiple: int = 1,
                 len_multiple: int = 1, limit: int = SPILL_LIMIT):
        self.k = k
        self.base = base
        self._dispatch = dispatch
        self._device = torch.device(device)
        self._dev = None
        self._windows = 0
        self._row_multiple = row_multiple
        self._len_multiple = len_multiple
        self._limit = limit

    def add(self, codes: np.ndarray) -> None:
        for chunk in iter_spill_chunks(codes, self.k, self._row_multiple,
                                       self._len_multiple, self._limit):
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
                 max_len: int | None, mesh=None,
                 seqpar: bool = False) -> tuple[int, int | None]:
    """Batch size + pad length.  ``None`` pad length means per-batch
    geometric buckets (iter_batches): a lone long contig then widens
    only its own batch.  On a row-sharded mesh the batch size rounds up
    to a multiple of the mesh, so that every device takes a row block."""
    bs = min(batch_size or auto_batch_size(), max(len(reads), 1))
    if mesh is not None and not seqpar:
        bs = -(-bs // mesh.size) * mesh.size
    if max_len is not None:
        return bs, max_len
    longest = max((len(r) for r in reads), default=1)
    if longest <= 512:
        # Uniform short reads: one shared batch shape.
        return bs, round_up(max(longest, k), 128)
    return bs, None


def run_device(device, mesh) -> torch.device:
    """Where a driver puts its batches: the mesh's first device (whose
    functions copy each block on to its own device), else ``device``,
    else the card (``ops.encode.default_device``: with no card visible
    it raises, and the caller passes ``device="cpu"``)."""
    if mesh is not None:
        return mesh.home
    if device is None:
        return default_device()
    return torch.device(device)


def dense_counts_on_device(codes: torch.Tensor, k: int, canonical: bool,
                           impl: str, packed: bool = False, mesh=None,
                           seqpar: bool = False):
    """One padded batch's dense counts on its device: ``(counts, packing)``.

    Where :func:`packed_auto` holds (CUDA, 5 <= k <= 8, short rows), or
    the caller asks for ``packed`` rows (any device, k <= 8) and they
    fit, the kernel emits the densest safe packed layout, 1 or 2 bytes
    per bin of device write and device→host copy; ``packing`` names it.
    Otherwise ``count_perread`` runs ``impl`` with int16 counts (exact:
    they are bounded by the windows per read) where the rows allow,
    and ``packing`` is False.  On a mesh the rows shard over its devices
    (packed where a device's rows cover whole read blocks), or with
    ``seqpar`` the positions over its ``sp`` axis, in int32.
    """
    w = codes.shape[1] - k + 1
    if mesh is not None and seqpar:
        return count_perread_seqpar(codes, k, mesh, canonical=canonical,
                                    impl=impl), False
    pk_ok = (packed and w < 2**15) or packed_auto(impl, k, w, codes.device)
    if mesh is not None:
        if pk_ok and (codes.shape[0] // mesh.size) % DEFAULT_READ_BLOCK == 0:
            packing = resolve_packed(True, w)
            return count_perread_sharded_packed(
                codes, k, mesh, canonical=canonical, packed=packing,
                read_block=DEFAULT_READ_BLOCK), packing
        return count_perread_sharded(codes, k, mesh, canonical=canonical,
                                     impl=impl), False
    if pk_ok:
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
                      device: torch.device | str | None = None,
                      canonical: bool = False, impl: str = "auto",
                      batch_size: int | None = None, max_len: int | None = None,
                      mesh=None, seqpar: bool = False):
    """Each batch's ``[n_reads, 4**k]`` int32 counts, in read order.

    A plain loop: the device→host copy of a batch synchronises before
    the next batch is dispatched (the JAX package keeps two batches in
    flight behind XLA's asynchronous dispatch).
    """
    device = run_device(device, mesh)
    if not reads:
        return
    bs, ml = _plan_shapes(reads, k, batch_size, max_len, mesh, seqpar)
    for batch in iter_batches(reads, bs, ml):
        codes = torch.from_numpy(batch.codes).to(device)
        counts, packing = dense_counts_on_device(codes, k, canonical, impl,
                                                 mesh=mesh, seqpar=seqpar)
        yield dense_counts_to_host(counts, batch.n_reads, packing)


def count_reads(reads: Sequence[np.ndarray], k: int, *,
                device: torch.device | str | None = None, canonical: bool = False,
                impl: str = "auto", batch_size: int | None = None,
                max_len: int | None = None, mesh=None,
                seqpar: bool = False) -> np.ndarray:
    """Per-read dense histograms of a ragged list of encoded reads:
    ``[n_reads, 4**k]`` int32, batches run on ``device``.

    ``mesh``: shard the batch rows over a (dp, tp) mesh
    (``parallel/sharded.py``, no collective); with ``seqpar``, shard the
    POSITION axis of a 1-D ``sp`` mesh instead (few very long contigs;
    ``parallel/seqpar.py``).  A mesh's devices replace ``device``.
    """
    out = np.zeros((len(reads), 4**k), dtype=np.int32)
    row = 0
    for counts in iter_dense_counts(reads, k, device=device, canonical=canonical,
                                    impl=impl, batch_size=batch_size,
                                    max_len=max_len, mesh=mesh, seqpar=seqpar):
        out[row : row + len(counts)] = counts
        row += len(counts)
    return out


def count_file(path, k: int, min_qual: int = 0, *,
               device: torch.device | str | None = None, **kw) -> np.ndarray:
    """Count a FASTA/FASTQ file: returns ``[n_reads, 4**k]`` int32.

    ``min_qual`` masks FASTQ bases below that Phred quality."""
    return count_reads(read_fasta_encoded(path, min_qual), k, device=device, **kw)


def count_file_dense_rows(
    path,
    out_path,
    k: int,
    *,
    device: torch.device | str | None = None,
    canonical: bool = False,
    impl: str = "auto",
    batch_size: int | None = None,
    max_len: int | None = None,
    min_qual: int = 0,
    nonzero: bool = False,
    mesh=None,
    seqpar: bool = False,
) -> int:
    """:func:`count_file` straight to a `.cfrk` file, batch by batch:
    the bytes of ``CfrkWriter(out_path, nonzero=nonzero).write_batch``
    over the whole matrix, with one batch on the host at a time.
    Returns the number of reads written."""
    device = run_device(device, mesh)
    reads = read_fasta_encoded(path, min_qual)
    n_written = 0
    with CfrkWriter(out_path, nonzero=nonzero) as w:
        for counts in iter_dense_counts(reads, k, device=device,
                                        canonical=canonical, impl=impl,
                                        batch_size=batch_size, max_len=max_len,
                                        mesh=mesh, seqpar=seqpar):
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
    device: torch.device | str | None = None,
    canonical: bool = False,
    batch_size: int | None = None,
    max_len: int | None = None,
    min_qual: int = 0,
    nonzero: bool = True,
    mesh=None,
) -> int:
    """Per-read rows of a FASTA/FASTQ file, streamed straight to disk.

    ``nonzero=True`` writes the ``idx:count`` cells of each read (for
    k > 15 the idx is the combined code ``hi * 4**15 + lo``);
    ``nonzero=False`` (k <= 8 only) writes dense rows, densified on host
    from the same pairs.  The batches run on ``device``: a CUDA device
    goes through the CUDA kernels, the CPU through the plain route; with
    ``mesh`` the rows shard over its devices (no collective).  Returns
    the number of reads written.  Its stages are the spans
    ``cfrk.stage.<name>`` of ``tools/stage_breakdown.py``'s names: parse,
    pad, h2d, rows, drain, format.
    """
    if not nonzero and k > 8:
        raise ValueError("dense rows require k <= 8")
    device = run_device(device, mesh)
    with span("cfrk.stage.parse"):
        reads = read_fasta_encoded(path, min_qual)
    n_written = 0
    with CfrkWriter(out_path) as w:
        if not reads:
            return 0
        bs, ml = _plan_shapes(reads, k, batch_size, max_len, mesh)
        batches = iter_batches(reads, bs, ml)
        while True:
            with span("cfrk.stage.pad"):
                batch = next(batches, None)
            if batch is None:
                break
            with span("cfrk.stage.h2d"):
                codes = torch.from_numpy(batch.codes).to(device)
            with span("cfrk.stage.rows"):
                if mesh is not None:
                    out = count_perread_sparse_sharded(codes, k, mesh, canonical=canonical)
                else:
                    out = count_perread_rows(codes, k, canonical)
            with span("cfrk.stage.drain"):
                idx, counts = pairs_to_host(narrow_for_fetch(out, k), batch.n_reads)
            with span("cfrk.stage.format"):
                if nonzero:
                    w.write_pairs(idx, counts)
                else:
                    w.write_pairs_dense(idx, counts, 4**k)
            n_written += batch.n_reads
    return n_written


def spectrum_dispatch(k: int, canonical: bool, impl: str, mesh=None,
                      seqpar: bool = False):
    """The dense spectrum's ``dispatch(codes, table)`` for
    :class:`DenseSpectrumAccumulator`: one device's histogram into the
    running table in place, or on a mesh the batch's global table
    (``spectrum_sharded`` / ``spectrum_seqpar``) added into it."""
    if mesh is None:
        return lambda arr, table: spectrum_op(arr, k, canonical=canonical,
                                              impl=impl, out=table)
    fn = spectrum_seqpar if seqpar else spectrum_sharded

    def dispatch(arr, table):
        part = fn(arr, k, mesh, canonical=canonical, impl=impl)
        return part if table is None else table.add_(part)

    return dispatch


def spectrum_accumulator(k: int, dispatch, base: np.ndarray, device, mesh=None,
                         seqpar: bool = False) -> "DenseSpectrumAccumulator":
    """A :class:`DenseSpectrumAccumulator` whose split batches stay
    divisible by the mesh: rows by its size, or positions by its sp."""
    return DenseSpectrumAccumulator(
        k, dispatch, base, device=device,
        row_multiple=mesh.size if mesh is not None and not seqpar else 1,
        len_multiple=mesh.shape.get("sp", 1) if mesh is not None and seqpar else 1,
    )


def spectrum_file(
    path,
    k: int,
    *,
    device: torch.device | str | None = None,
    canonical: bool = False,
    impl: str = "auto",
    batch_size: int | None = None,
    max_len: int | None = None,
    min_qual: int = 0,
    mesh=None,
    seqpar: bool = False,
) -> np.ndarray:
    """Global spectrum of a FASTA/FASTQ file: returns [4**k] int64.

    With ``mesh``, each batch's table is computed sharded (summed over
    dp, reduce-scattered over tp; ``parallel/sharded.py``), or with
    ``seqpar`` over the positions of an ``sp`` mesh; the sorted route
    routes keys through the bucket exchange (``parallel/bucket.py``) or,
    under seqpar, sorts each device's position slice."""
    device = run_device(device, mesh)
    reads = read_fasta_encoded(path, min_qual)
    total = np.zeros(4**k, dtype=np.int64)
    if not reads:
        return total
    bs, ml = _plan_shapes(reads, k, batch_size, max_len, mesh, seqpar)
    if _use_sorted_spectrum(k, impl, device):
        keys, counts = _sorted_spectrum_batches(
            iter_batches(reads, bs, ml), k, canonical, device, mesh, seqpar
        )
        total[keys] = counts
        return total
    acc = spectrum_accumulator(k, spectrum_dispatch(k, canonical, impl, mesh, seqpar),
                               total, device, mesh, seqpar)
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
    package's rule.  On a mesh ``device`` is its first device.
    """
    if impl == "sort":
        return True
    if k <= SPECTRUM_MAX_K:
        return False
    return impl == "auto" and device.type == "cuda"


def mesh_triples(codes: torch.Tensor, k: int, canonical: bool, mesh, seqpar: bool,
                 slack: float):
    """One batch's sparse spectrum on a mesh → ((hi, lo, counts) on the
    host, the slack it ended at): under ``seqpar`` each device sorts its
    own position slice, else the keys route through the bucket exchange
    with overflow retry, starting at ``slack``."""
    if seqpar:
        return rows_to_triples(spectrum_seqpar_triples(
            codes, k, mesh, canonical=canonical), k), slack
    hi, lo, counts, slack = sparse_spectrum_sharded_retry(
        codes, k, mesh, canonical=canonical, slack=slack)
    return fetch_triples(hi, lo, counts, k), slack


def _sorted_spectrum_batches(batches, k: int, canonical: bool,
                             device: torch.device, mesh=None, seqpar: bool = False,
                             slack: float = 2.0):
    """Accumulate batches through per-read row sorts on ``device`` (or a
    mesh, :func:`mesh_triples`, carrying the bucket slack from batch to
    batch); returns the merged, key-sorted (keys, counts) arrays.  k <= 10
    folds into a dense host table (<= 8 MB), larger k merges sparsely."""
    acc = DenseFoldAccumulator(k) if k <= 10 else SparseAccumulator()
    for batch in batches:
        if mesh is not None:
            triples, slack = mesh_triples(torch.from_numpy(batch.codes).to(device),
                                          k, canonical, mesh, seqpar, slack)
            acc.add(*triples)
            continue
        acc.add(*batch_spectrum_triples(
            batch.codes, k, canonical,
            max_len=int(batch.lengths.max(initial=0)), device=device,
        ))
    return acc.result_arrays()


def sparse_spectrum_arrays(
    path,
    k: int,
    *,
    device: torch.device | str | None = None,
    canonical: bool = False,
    batch_size: int | None = None,
    max_len: int | None = None,
    min_qual: int = 0,
    mesh=None,
    slack: float = 2.0,
    seqpar: bool = False,
):
    """Sparse spectrum of a FASTA/FASTQ file for any k <= 31: the
    key-sorted (keys uint64, counts int64) arrays of every distinct
    k-mer, ``key = hi * 4**15 + lo`` (the k-mer's base-4 code).  Each
    batch's per-read rows are sorted and run-length encoded on
    ``device``; the batches merge on the host.  With ``mesh`` the keys
    route through the all_to_all bucket exchange (``parallel/bucket.py``)
    from ``slack`` with overflow retry, or under ``seqpar`` each device
    sorts its own position slice (``parallel/seqpar.py``)."""
    device = run_device(device, mesh)
    reads = read_fasta_encoded(path, min_qual)
    if not reads:
        return SparseAccumulator().result_arrays()
    bs, ml = _plan_shapes(reads, k, batch_size, max_len, mesh, seqpar)
    acc = SparseAccumulator()
    for batch in iter_batches(reads, bs, ml):
        if mesh is not None:
            triples, slack = mesh_triples(torch.from_numpy(batch.codes).to(device),
                                          k, canonical, mesh, seqpar, slack)
            acc.add(*triples)
            continue
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
