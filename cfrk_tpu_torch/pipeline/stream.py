"""Constant-memory streaming drivers: FASTA of any size → `.cfrk` rows,
a dense spectrum or a sparse one, with checkpoint and resume.

The counterpart of the single-device half of
``cfrk_tpu/pipeline/stream.py``.  The in-memory drivers
(``pipeline/count.py``) hold every read; these hold a few batches:

* **few batch shapes**: each batch is padded to a geometric length
  bucket (128·2^j), so a run touches a handful of shapes and its pinned
  host buffers are reused;
* **parse/compute overlap**: a background thread packs the next
  batches into a bounded queue while the device runs, from blocks that
  the host library's chunked parser (``io/native``) reads and parses
  one block ahead on a thread of its own;
* **two batches in flight**: a batch's rows are taken from the device
  two batches behind its launch.  On a CUDA device
  (:class:`_BatchPipeline`) the codes go up from pinned staging buffers
  and the results come down into pinned host buffers on a copy stream
  of its own, so the host waits on an event only when it takes a
  batch's rows; on the CPU the same loop runs with plain calls;
* **checkpoint/resume** after every flushed batch
  (``runtime/checkpoint.py``): the output is fsynced before the
  checkpoint claims it, and a resumed run truncates the torn tail,
  seeks the input (plain and bgzf files) and writes the same bytes;
* **a host fold behind the device** (:func:`stream_sparse_spectrum_file`,
  the sparse spectrum and the dense spectrum's sorted route): each
  batch's per-read pairs fold into a host accumulator on a worker
  thread while the next batches run and copy; under a memory budget the
  accumulator spills sorted runs to disk and the result is merged from
  them in bounded chunks.

A path of ``-`` streams stdin (plain or gzip bytes) in one pass: no
offsets, no resume.  With a ``mesh`` (``parallel/``) each batch goes up
to the mesh's first device and is sharded from there: rows over the
devices, the positions of an ``sp`` mesh with ``seqpar``, or the sparse
spectrum's keys through the bucket exchange; the results come back
assembled on the first device, where the pipeline takes them.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import queue
import sys
import threading
import time
from typing import Iterator

import numpy as np
import torch

from ..format import CfrkWriter
from ..io.bgzf import is_bgzf
from ..io.fasta import is_stdin, iter_encoded_with_offsets, open_stdin_reads
from ..io.native import iter_record_blocks_native
from ..ops.cuda.perread import DEFAULT_READ_BLOCK
from ..ops.perread_sparse import (
    count_perread_rows,
    narrow_for_fetch,
    pairs_to_host,
    valid_pair_prefix,
)
from ..ops.sparse import (
    LO_BASES,
    DenseFoldAccumulator,
    SparseAccumulator,
    SpillingSparseAccumulator,
    fetched_to_triples,
)
from ..parallel.bucket import sparse_spectrum_sharded_retry
from ..parallel.seqpar import spectrum_seqpar_triples
from ..parallel.sharded import count_perread_sparse_sharded
from ..runtime import faults
from ..runtime.checkpoint import StreamCheckpoint, checkpoint_path, spill_dir_path
from ..runtime.metrics import RunMetrics, malloc_trim
from .batch import ReadBatch, len_bucket, pad_reads, pad_reads_flat
from .count import (
    SPILL_LIMIT,
    _use_sorted_spectrum,
    dense_counts_on_device,
    dense_counts_to_host,
    run_device,
    spectrum_accumulator,
    spectrum_dispatch,
)

__all__ = [
    "stream_batches",
    "stream_count_file",
    "stream_spectrum_file",
    "stream_sparse_spectrum_file",
]

_SENTINEL = None


def stream_batches(
    path,
    k: int,
    batch_size: int,
    *,
    skip_reads: int = 0,
    start_offset: int | None = None,
    limit_offset: int | None = None,
    len_base: int = 128,
    min_qual: int = 0,
) -> Iterator[ReadBatch]:
    """Stream fixed-shape batches from a FASTA/FASTQ file, in read order.

    Each batch is padded to the geometric length bucket of its longest
    read and carries ``end_offset`` (the input byte position past its
    last record; plain and bgzf files).  Resume paths: ``start_offset``
    seeks straight to a record boundary; ``skip_reads`` drops that many
    leading records by re-parsing (plain gzip).  ``limit_offset`` stops
    before the first record STARTING at or past it (byte-range sharding
    of one file over several processes).

    The records come from the host library's chunked parser as flat
    blocks (``io.native.iter_record_blocks_native``, one block read and
    parsed ahead) and are cut into batches by ``pad_reads_flat``, with
    the shapes of the per-record loop (:func:`_record_batches`): the tail
    batch keeps the full batch_size shape, so it runs at the shape of
    every other batch of its length bucket.  ``skip_reads`` drops
    leading records block-wise (the gzip resume's re-parse, at parser
    speed).  A gzip input streams decompressed; its batches carry
    ``end_offset=None`` unless it is bgzf.  ``-`` reads stdin in order
    (a gzip pipe decompresses), with ``end_offset=None`` and no offsets.
    """
    if is_stdin(path):
        if start_offset or limit_offset is not None:
            raise ValueError(
                "byte offsets cannot address a pipe; '-' reads stdin "
                "sequentially"
            )
        source, gz, offsets_ok = _Borrowed(open_stdin_reads()), False, False
    else:
        source, gz = path, _is_gzip(path)
        # bgzf offsets are decompressed positions and remain valid resume
        # points (BgzfReader.seek_decompressed); plain-gzip offsets are not.
        offsets_ok = not gz or is_bgzf(path)
    if gz and (start_offset or limit_offset is not None) and not is_bgzf(path):
        # Raise here, not just in stream_count_file: a limit_offset the
        # gzip path cannot observe (its offsets are all None) would
        # otherwise stream the WHOLE file, which in a ranged run counts
        # reads twice.  bgzf offsets are DECOMPRESSED positions, reached
        # through block metadata, so there both resume and ranges work.
        raise ValueError(
            "byte offsets cannot address a gzip stream; "
            "decompress the input first (or recompress with bgzip)"
        )
    flat = np.empty(0, np.int8)
    lens = np.empty(0, np.int64)
    offs = np.empty(0, np.int64)

    def cut_batch(n: int) -> ReadBatch:
        nonlocal flat, lens, offs
        nbytes = int(lens[:n].sum())
        longest = max(int(lens[:n].max(initial=0)), k)
        b = pad_reads_flat(
            flat[:nbytes], lens[:n], batch_size, len_bucket(longest, len_base)
        )
        b = dataclasses.replace(
            b, end_offset=int(offs[n - 1]) if offsets_ok else None
        )
        flat = flat[nbytes:]
        lens = lens[n:]
        offs = offs[n:]
        return b

    for bflat, blens, boffs in iter_record_blocks_native(
        source, start_offset=start_offset, limit_offset=limit_offset,
        decompress=gz, min_qual=min_qual,
    ):
        if skip_reads:
            n = min(skip_reads, len(blens))
            nbytes = int(blens[:n].sum())
            bflat = bflat[nbytes:]
            blens = blens[n:]
            boffs = boffs[n:]
            skip_reads -= n
            if not len(blens):
                continue
        flat = np.concatenate([flat, bflat]) if flat.size else bflat
        lens = np.concatenate([lens, blens]) if lens.size else blens
        offs = np.concatenate([offs, boffs]) if offs.size else boffs
        while len(lens) >= batch_size:
            yield cut_batch(batch_size)
    if len(lens):
        yield cut_batch(len(lens))


class _Borrowed:
    """An open stream lent to a reader that closes what it has read
    (``iter_record_blocks_native``): closing it leaves the stream, such
    as ``sys.stdin.buffer``, open for its owner."""

    def __init__(self, f):
        self._f = f

    def read(self, n: int = -1) -> bytes:
        return self._f.read(n)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


def _record_batches(
    path,
    k: int,
    batch_size: int,
    *,
    skip_reads: int = 0,
    start_offset: int | None = None,
    limit_offset: int | None = None,
    len_base: int = 128,
    min_qual: int = 0,
) -> Iterator[ReadBatch]:
    """:func:`stream_batches` by the per-record loop of
    ``io.fasta.iter_encoded_with_offsets``: the same batches, the
    oracle of the native ingest in the tests."""
    buf: list[np.ndarray] = []
    last_off: int | None = None
    prev_end = start_offset or 0  # start position of the next record

    def flush() -> ReadBatch:
        longest = max(max(len(r) for r in buf), k)
        b = pad_reads(buf, batch_size, len_bucket(longest, len_base))
        return dataclasses.replace(b, end_offset=last_off)

    for i, (codes, off) in enumerate(
        iter_encoded_with_offsets(
            path, start_offset=start_offset, min_qual=min_qual
        )
    ):
        if limit_offset is not None and prev_end >= limit_offset:
            break
        if off is not None:
            prev_end = off
        if i < skip_reads:
            continue
        buf.append(codes)
        last_off = off
        if len(buf) == batch_size:
            yield flush()
            buf = []
    if buf:
        yield flush()


def _is_gzip(path) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def _resume_fingerprint(path, k, mode_tag, canonical, out_path, byte_range,
                        min_qual=0, resume=False):
    """Shared resume plumbing of the stream drivers: reject gzip byte
    ranges, tag ranged runs as a distinct unit of work (resume must
    never mix a ranged checkpoint with a whole-file one), and build the
    (fingerprint, checkpoint-path) pair."""
    cpath = checkpoint_path(out_path) if out_path else None
    if is_stdin(path):
        # A pipe is a one-shot stream: a resumed re-run would read a
        # DIFFERENT stream, and ranges have nothing to address.
        if byte_range is not None:
            raise ValueError("byte_range cannot address a pipe ('-')")
        if resume:
            raise ValueError(
                "cannot resume from a pipe ('-'); stream from a file "
                "for checkpoint/resume"
            )
        fp = {"input": "<stdin>", "k": k, "mode": mode_tag,
              "canonical": bool(canonical)}
        if min_qual:
            fp["min_qual"] = int(min_qual)
        return fp, cpath
    if byte_range is not None:
        if _is_gzip(path) and not is_bgzf(path):
            raise ValueError(
                "byte_range needs a plain or bgzf input: a plain "
                "gzip stream has no random access"
            )
        mode_tag += f"-range{byte_range[0]}-{byte_range[1]}"
    fp = StreamCheckpoint.fingerprint_of(path, k, mode_tag, canonical)
    if min_qual:
        # Part of the unit-of-work identity: resuming a min_qual run
        # without the flag (or the reverse) would splice differently
        # masked counts.  Only set when active, so checkpoints written
        # without the flag still match unmasked runs.
        fp["min_qual"] = int(min_qual)
    return fp, cpath


def _batch_feeder(gen: Iterator[ReadBatch], q: queue.Queue, err: list,
                  stop: threading.Event) -> None:
    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    try:
        for b in gen:
            if not put(b):
                return
    except BaseException as e:  # surface parser errors in the consumer
        err.append(e)
    finally:
        put(_SENTINEL)
        gen.close()  # release the input file handle promptly


def _prefetched(
    gen: Iterator[ReadBatch],
    depth: int = 4,
    metrics: RunMetrics | None = None,
) -> Iterator[ReadBatch]:
    """Run ``gen`` in a background thread with a bounded queue.

    If the consumer stops early (an error downstream), the feeder is
    signalled through ``stop``, so it does not block forever on a full
    queue holding the input file open.  With ``metrics``, the time the
    CONSUMER blocks waiting for the parser is accumulated under the
    "parse_wait" stage: the *exposed* ingest time (zero when parsing
    fully overlaps the rest)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()
    t = threading.Thread(
        target=_batch_feeder, args=(gen, q, err, stop), daemon=True
    )
    t.start()
    try:
        while True:
            if metrics is not None:
                with metrics.stage("parse_wait"):
                    item = q.get()
            else:
                item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        t.join(timeout=5)


def _resume_batches(
    path, k: int, batch_size: int, ckpt, byte_range=None, min_qual=0
) -> Iterator[ReadBatch]:
    """Batch stream honouring a checkpoint: a seek for plain and bgzf
    files, re-parse + skip for plain gzip (with a loud warning: a gzip
    stream has no random access, so decompress large inputs first).
    ``byte_range=(start, limit)`` restricts the stream to records
    starting in that range."""
    start = byte_range[0] if byte_range else None
    limit = byte_range[1] if byte_range else None
    if ckpt.reads_done and ckpt.input_offset is not None:
        return stream_batches(
            path, k, batch_size, start_offset=ckpt.input_offset,
            limit_offset=limit, min_qual=min_qual,
        )
    if ckpt.reads_done and _is_gzip(path):
        print(
            f"# resume on gzip input re-parses {ckpt.reads_done} records "
            "from the start (no random access in a gzip stream); "
            "decompress the input first for large runs",
            file=sys.stderr,
        )
    return stream_batches(
        path, k, batch_size, skip_reads=ckpt.reads_done,
        start_offset=start, limit_offset=limit, min_qual=min_qual,
    )


@dataclasses.dataclass
class _InFlight:
    """One launched batch: its results on their way to the host."""

    n_reads: int
    end_offset: int | None
    tag: object  # what ``compute`` said of the layout (the packing)
    host: tuple  # CPU tensors the results arrive in
    done: object  # torch.cuda.Event behind the last copy; None on the CPU
    held: tuple = ()  # pinned buffers and device tensors the copies use


class _BatchPipeline:
    """Launches batches on one device and brings their results to the
    host without holding the host.

    ``compute(codes, batch)`` takes a batch's ``[B, L]`` int8 codes on
    the device (and the :class:`ReadBatch` they came from) and returns
    ``(outputs, tag)``: a tuple of tensors whose first axis is the
    batch's rows, and whatever the caller needs to read them.  Only the
    first ``n_reads`` rows of each output travel, unless ``cut_rows`` is
    False (outputs whose first axis is not the rows: they travel whole).

    On a CUDA device the codes go up from a pinned staging buffer with a
    non-blocking copy; the kernels run on the current stream; a copy
    stream waits for them and copies each output into a pinned host
    buffer, then records the event that :meth:`wait` synchronises on.
    An :class:`_InFlight` holds its staging buffer, its device outputs
    (the caching allocator does not know that the copy stream reads
    them, so they must outlive the copy) and its host buffers until
    :meth:`release` hands the pinned ones back for the next batch: with
    two batches pending and one being written, three sets of a shape
    exist.  On the CPU every step is a plain call.
    """

    def __init__(self, device: torch.device, compute, cut_rows: bool = True):
        self.device = device
        self._compute = compute
        self._cut_rows = cut_rows
        self._cuda = device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(device) if self._cuda else None
        self._free: dict = {}  # (shape, dtype) -> free pinned tensors

    def _pinned(self, shape, dtype) -> torch.Tensor:
        free = self._free.setdefault((tuple(shape), dtype), [])
        return free.pop() if free else torch.empty(
            tuple(shape), dtype=dtype, pin_memory=True)

    def submit(self, batch: ReadBatch) -> _InFlight:
        n = batch.n_reads
        if not self._cuda:
            outs, tag = self._compute(torch.from_numpy(batch.codes), batch)
            return _InFlight(n, batch.end_offset, tag,
                             tuple(o[:n] if self._cut_rows else o for o in outs),
                             None)
        with torch.cuda.device(self.device):
            staging = self._pinned(batch.codes.shape, torch.int8)
            staging.numpy()[...] = batch.codes
            outs, tag = self._compute(
                staging.to(self.device, non_blocking=True), batch)
            computed = torch.cuda.Event()
            computed.record()
            held, host = [staging], []
            with torch.cuda.stream(self._copy_stream):
                self._copy_stream.wait_event(computed)
                for o in outs:
                    m = n if self._cut_rows else o.shape[0]
                    if not o.is_cuda:  # rows past the kernels' ceiling
                        host.append(o[:m])
                        continue
                    buf = self._pinned(o.shape, o.dtype)
                    buf[:m].copy_(o[:m], non_blocking=True)
                    held += [buf, o]
                    host.append(buf[:m])
                done = torch.cuda.Event()
                done.record()
        return _InFlight(n, batch.end_offset, tag, tuple(host), done, tuple(held))

    def wait(self, job: _InFlight) -> tuple:
        """The batch's results as CPU tensors, valid until :meth:`release`."""
        if job.done is not None:
            job.done.synchronize()
        return job.host

    def release(self, job: _InFlight) -> None:
        for t in job.held:
            if not t.is_cuda:
                self._free[(tuple(t.shape), t.dtype)].append(t)
        job.held = job.host = ()


def _perread_compute(k: int, canonical: bool, impl: str, packed: bool,
                     sparse_rows: bool, mesh=None, seqpar: bool = False):
    """Batch → device results of the per-read drivers' two routes: the
    narrowed (idx, counts) / (hi, lo, counts) rows of the per-read sort +
    RLE (rows sharded over ``mesh``), or dense counts in the layout
    ``dense_counts_on_device`` picks (the tag is its packing)."""
    if sparse_rows:
        if mesh is not None:
            return lambda codes, batch: (narrow_for_fetch(
                count_perread_sparse_sharded(codes, k, mesh, canonical=canonical),
                k), None)
        return lambda codes, batch: (
            narrow_for_fetch(count_perread_rows(codes, k, canonical), k), None
        )

    def dense(codes, batch):
        counts, packing = dense_counts_on_device(codes, k, canonical, impl, packed,
                                                 mesh, seqpar)
        return (counts,), packing

    return dense


def _check_mesh_batch(mesh, batch_size: int) -> None:
    if mesh is not None and batch_size % mesh.size:
        raise ValueError(
            f"batch_size {batch_size} not divisible by mesh size {mesh.size}"
        )


def stream_count_file(
    path,
    out_path,
    k: int,
    *,
    device: torch.device | str | None = None,
    canonical: bool = False,
    impl: str = "auto",
    batch_size: int = 8192,
    resume: bool = False,
    checkpoint_every: int = 1,
    nonzero: bool = False,
    mesh=None,
    seqpar: bool = False,
    packed: bool = False,
    byte_range=None,
    metrics: RunMetrics | None = None,
    min_qual: int = 0,
) -> RunMetrics:
    """Stream a FASTA/FASTQ file into a `.cfrk` file with bounded memory,
    its batches run on ``device``.

    Checkpoints after every ``checkpoint_every`` flushed batches; with
    ``resume=True`` a matching checkpoint restarts the run where it
    stopped.  The checkpoint sidecar is removed on successful completion.
    ``packed=True`` (k <= 8) runs the dense per-read histogram kernel in
    its packed emit (1 or 2 bytes a bin, by the read length): less device
    write and device→host copy, unpacked on the host.  With ``mesh`` each
    batch's rows shard over its devices (batch_size must divide evenly;
    packed rows a device must cover whole read blocks); with ``seqpar``
    the positions of an ``sp`` mesh do (dense counts only).

    Whenever the kernel choice is ours (``impl='auto'``, not ``packed``
    or ``seqpar``) the rows go through the per-read sort + RLE: the drain
    ships (idx, count) pairs instead of the dense matrix, mandatory past
    k = 8 and far less to copy below it; the bytes are the same either
    way.
    """
    if packed:
        if k > 8:
            raise ValueError("packed mode needs k <= 8")
        if seqpar:
            raise ValueError("packed mode does not compose with --seqpar")
        if impl not in ("auto", "pallas"):
            # Packed IS the per-read histogram kernel: an explicit
            # --impl scatter/matmul/host contradicts it.
            raise ValueError(
                f"packed mode uses the pallas kernel; drop --packed or "
                f"use --impl auto/pallas (got --impl {impl})"
            )
        if mesh is not None and (batch_size // mesh.size) % DEFAULT_READ_BLOCK:
            raise ValueError(
                "packed mesh runs need batch_size/device divisible by "
                f"the read block ({DEFAULT_READ_BLOCK}): got "
                f"{batch_size} over {mesh.size} devices"
            )
    if str(out_path).endswith(".gz"):
        raise ValueError(
            "streaming .gz output is unsupported (checkpoints need byte "
            "offsets); write plain .cfrk and compress afterwards, or use "
            "the in-memory driver (count_file + write_cfrk)"
        )
    if k > 8 and not nonzero:
        raise ValueError(
            f"per-read k={k} > 8 requires nonzero=True (dense 4**k "
            "rows would be gigabytes per read)"
        )
    device = run_device(device, mesh)
    # An explicit impl or packed request keeps the dense kernel the
    # caller asked for; dense OUTPUT does not (the formatter densifies
    # the pairs); seqpar keeps the dense position-sharded path (a row
    # sort needs the whole row on one device).
    sparse_rows = (nonzero and k > 8) or (
        impl == "auto" and not packed and not seqpar)
    if sparse_rows and seqpar:
        raise ValueError(
            "sparse per-read rows do not compose with seqpar "
            "(per-row sort needs the whole row on one device)"
        )
    if not seqpar:  # seqpar shards positions, not batch rows
        _check_mesh_batch(mesh, batch_size)
    pipe = _BatchPipeline(
        device, _perread_compute(k, canonical, impl, packed, sparse_rows, mesh,
                                 seqpar)
    )
    m = metrics or RunMetrics(k=k, mode="perread")
    fp, cpath = _resume_fingerprint(
        path, k, "perread-nonzero" if nonzero else "perread",
        canonical, out_path, byte_range, min_qual, resume,
    )

    ckpt = StreamCheckpoint(fingerprint=fp)
    if resume and os.path.exists(cpath):
        prev = StreamCheckpoint.load_if_valid(cpath)
        if prev is not None and prev.matches(fp):
            # The checkpoint only counts if the output really contains
            # the bytes it promises: a missing or short file (a crash
            # before the data hit disk) would otherwise be NUL-extended
            # by truncate() and silently lose the first reads_done reads.
            if (
                os.path.exists(out_path)
                and os.path.getsize(out_path) >= prev.out_bytes
            ):
                ckpt = prev

    mode = "r+b" if (ckpt.reads_done and os.path.exists(out_path)) else "wb"
    with open(out_path, mode) as f:
        if ckpt.reads_done:
            f.truncate(ckpt.out_bytes)  # drop any torn tail
            f.seek(ckpt.out_bytes)
        w = CfrkWriter(f, continuing=ckpt.reads_done > 0, nonzero=nonzero)

        gen = _resume_batches(path, k, batch_size, ckpt, byte_range, min_qual)
        pending: list[_InFlight] = []
        since_ckpt = 0

        def drain_one() -> None:
            nonlocal since_ckpt
            job = pending.pop(0)
            with m.stage("materialize"):
                host = pipe.wait(job)
                if sparse_rows:
                    pairs = pairs_to_host(host, job.n_reads)
                else:
                    counts = dense_counts_to_host(host[0], job.n_reads, job.tag)
            with m.stage("write"):
                if sparse_rows and nonzero:
                    w.write_pairs(*pairs)
                elif sparse_rows:
                    w.write_pairs_dense(*pairs, 4**k)
                else:
                    w.write_batch(counts)
            pipe.release(job)  # the formatter has consumed the host buffers
            # Fault site: dies with this batch's rows written but NOT
            # checkpointed; resume must truncate the torn tail and redo
            # the batch (runtime/faults.py; a no-op unless armed).
            faults.trip("batch-written")
            ckpt.reads_done += job.n_reads
            ckpt.input_offset = job.end_offset
            since_ckpt += 1
            if since_ckpt >= checkpoint_every:
                with m.stage("checkpoint"):
                    # fsync the DATA before the fsynced checkpoint JSON
                    # claims it exists (write-ahead ordering).
                    f.flush()
                    os.fsync(f.fileno())
                    ckpt.out_bytes = f.tell()
                    ckpt.save(cpath)
                since_ckpt = 0

        for batch in _prefetched(gen, metrics=m):
            with m.stage("dispatch"):
                pending.append(pipe.submit(batch))
            m.batches += 1
            m.reads += batch.n_reads
            m.bases += int(batch.lengths.sum())
            if len(pending) > 2:
                drain_one()
        while pending:
            drain_one()
        # Make the tail durable BEFORE the checkpoint is removed: a
        # crash after cleanup must not leave a silently truncated file.
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(cpath):
        ckpt.cleanup(cpath)
    m.total_reads = ckpt.reads_done
    return m


def stream_spectrum_file(
    path,
    k: int,
    *,
    device: torch.device | str | None = None,
    canonical: bool = False,
    impl: str = "auto",
    batch_size: int = 8192,
    out_path=None,
    resume: bool = False,
    checkpoint_every: int = 16,
    mesh=None,
    seqpar: bool = False,
    cleanup: bool = True,
    byte_range=None,
    metrics: RunMetrics | None = None,
    min_qual: int = 0,
) -> tuple[np.ndarray, RunMetrics]:
    """Stream a FASTA/FASTQ file into one global dense spectrum
    ``[4**k]`` int64, its batches run on ``device``.

    The table lives ON THE DEVICE (int32, one kernel launch a batch) and
    comes to the host only at checkpoints and at the end: a 4**15 table
    is 4 GB, so a copy per batch would dominate the run.  ``out_path``
    only places the checkpoint sidecar; pass the eventual output path.
    ``cleanup=False`` keeps the checkpoint until the CALLER has written
    the real output (``runtime.checkpoint.cleanup_checkpoint``), so that
    a crash during that write stays resumable.  Where the sorted route
    holds (``pipeline.count._use_sorted_spectrum``) the batches go
    through :func:`stream_sparse_spectrum_file` instead, whose
    checkpoints are the sparse driver's.  With ``mesh`` each batch's
    table is computed sharded (summed over dp, reduce-scattered over tp,
    or over the positions of an ``sp`` mesh with ``seqpar``) before it
    is added to the running table on the mesh's first device.
    """
    device = run_device(device, mesh)
    if _use_sorted_spectrum(k, impl, device):
        # The sorted route (``--impl sort``; ``auto`` at k = 11-15 on a
        # CUDA device) streams through the sparse driver (the same
        # computation and checkpoints) and densifies once at the end;
        # k <= 10 folds each batch straight into a dense host table.
        keys, counts, m2 = stream_sparse_spectrum_file(
            path, k, device=device, canonical=canonical,
            batch_size=batch_size, out_path=out_path, resume=resume,
            checkpoint_every=checkpoint_every, cleanup=cleanup,
            byte_range=byte_range, metrics=metrics, min_qual=min_qual,
            mesh=mesh, seqpar=seqpar,
        )
        total = np.zeros(4**k, dtype=np.int64)
        total[keys] = counts
        return total, m2

    if not seqpar:  # seqpar shards positions, not batch rows
        _check_mesh_batch(mesh, batch_size)
    m = metrics or RunMetrics(k=k, mode="spectrum")
    fp, cpath = _resume_fingerprint(
        path, k, "spectrum", canonical, out_path, byte_range, min_qual, resume
    )

    ckpt = StreamCheckpoint(fingerprint=fp)
    base = np.zeros(4**k, dtype=np.int64)
    if resume and cpath and os.path.exists(cpath):
        prev = StreamCheckpoint.load_if_valid(cpath)
        if prev is not None and prev.matches(fp):
            try:
                base = prev.load_spectrum()
                ckpt = prev
            except (OSError, ValueError, KeyError):
                pass  # torn sidecar: restart from scratch

    # The device table is int32; it spills into the int64 host base
    # before the windows added since the last spill could overflow any
    # single bin (pipeline/count.DenseSpectrumAccumulator).
    acc = spectrum_accumulator(k, spectrum_dispatch(k, canonical, impl, mesh, seqpar),
                               base, device, mesh, seqpar)

    gen = _resume_batches(path, k, batch_size, ckpt, byte_range, min_qual)
    since_ckpt = 0
    for batch in _prefetched(gen, metrics=m):
        batch_windows = batch.codes.shape[0] * (batch.codes.shape[1] - k + 1)
        if acc.windows + batch_windows >= SPILL_LIMIT:
            with m.stage("drain"):
                acc.spill()
        with m.stage("dispatch"):
            acc.add(batch.codes)
        m.batches += 1
        m.reads += batch.n_reads
        m.bases += int(batch.lengths.sum())
        ckpt.reads_done += batch.n_reads
        ckpt.input_offset = batch.end_offset
        since_ckpt += 1
        if cpath and since_ckpt >= checkpoint_every:
            # "drain" waits for every launched batch and copies the
            # table down; it is device time, not checkpoint I/O.
            with m.stage("drain"):
                acc.spill()
            with m.stage("checkpoint"):
                ckpt.save_spectrum(cpath, acc.base)
                ckpt.save(cpath)
            since_ckpt = 0

    with m.stage("drain"):
        total = acc.total()
    if cleanup and cpath and os.path.exists(cpath):
        ckpt.cleanup(cpath)
    m.total_reads = ckpt.reads_done
    return total, m


# Folds that may wait for the worker: each holds its batch's pinned host
# buffers (about 9 MB at k = 31 and 8192 reads of 150 bp).
_MAX_FOLD_QUEUE = 4


def _sparse_spectrum_compute(k: int, canonical: bool, mesh=None,
                             seqpar: bool = False, slack: float = 2.0):
    """Batch → the narrowed per-read sort + RLE rows of the sparse
    spectrum, cut on the device to the batch's true window count
    (:func:`valid_pair_prefix`: the bucket's pad columns hold no run
    start, e.g. 142 of 248 columns for 150 bp reads in a 256 bucket).

    On a mesh: under ``seqpar`` the narrowed rows of each device's
    position slice; else the bucket exchange's (lo, counts) for
    k <= 15 or (hi, lo, counts) above, the key words as int32 bit views,
    with the slack that a batch's overflow retry reached carried to the
    next batch."""
    if mesh is not None and seqpar:
        return lambda codes, batch: (tuple(a.contiguous() for a in narrow_for_fetch(
            spectrum_seqpar_triples(codes, k, mesh, canonical=canonical), k)), None)
    if mesh is not None:
        def routed(codes, batch):
            nonlocal slack
            hi, lo, counts, slack = sparse_spectrum_sharded_retry(
                codes, k, mesh, canonical=canonical, slack=slack)
            words = (lo,) if k <= LO_BASES else (hi, lo)
            return tuple(w.to(torch.int32) for w in words) + (counts,), None

        return routed

    def compute(codes, batch):
        w = max(int(batch.lengths.max(initial=0)), k) - k + 1
        rows = valid_pair_prefix(
            narrow_for_fetch(count_perread_rows(codes, k, canonical), k), w
        )
        return tuple(a.contiguous() for a in rows), None

    return compute


def stream_sparse_spectrum_file(
    path,
    k: int,
    *,
    device: torch.device | str | None = None,
    canonical: bool = False,
    batch_size: int = 8192,
    out_path=None,
    resume: bool = False,
    checkpoint_every: int = 64,
    merge_every: int = 32,
    cleanup: bool = True,
    mesh=None,
    slack: float = 2.0,
    byte_range=None,
    metrics: RunMetrics | None = None,
    min_qual: int = 0,
    seqpar: bool = False,
    mem_budget_mb: int | None = None,
    finalize: str = "arrays",
):
    """Stream a FASTA/FASTQ file into a sparse spectrum (any k <= 31),
    its batches run on ``device``.

    Returns (keys uint64 sorted, counts int64, metrics).  Each batch's
    per-read rows are sorted and run-length encoded on the device (the
    rowsort kernels on a GPU), cut to the batch's true window count and
    copied down narrowed; the host folds them into one accumulator:
    :class:`DenseFoldAccumulator` for k <= 10, else
    :class:`SparseAccumulator` (merged every ``merge_every`` batches).
    Checkpoints every ``checkpoint_every`` batches persist its merged
    arrays as ``.npz``.

    ``mem_budget_mb`` caps the host accumulator for k >= 11: merged
    arrays beyond the budget spill to sorted runs under
    ``<out>.ckpt.json.spill/`` and the result multiway-merges them in
    bounded chunks (:class:`SpillingSparseAccumulator`); checkpoints
    then record the append-only run list.  It needs ``out_path``, and
    the result is the same as without it.  A resumed run honours the
    checkpoint's run list whatever this call's budget.

    Two batches are in flight on the device (:class:`_BatchPipeline`),
    and the fold runs on one worker thread, so that it overlaps the next
    batches' copies; a batch's host buffers go back to the pipeline only
    after its fold has read them, and at most ``_MAX_FOLD_QUEUE`` folds
    wait.  Only folded batches are checkpointed.  Stages: "dispatch"
    (launch), "materialize" (the wait for the batch's copy), "fold_bg"
    (fold work on the worker), "fold_wait" (the main thread's wait for
    folds: the exposed fold), "checkpoint".

    ``finalize="accumulator"`` returns ``(accumulator, None, metrics)``:
    the caller streams ``iter_merged_chunks()`` into its writer and
    then removes the checkpoint and the spill runs
    (``runtime.checkpoint.cleanup_checkpoint``).

    With ``mesh`` (1-axis or (dp, tp)) each batch's keys route through
    the all_to_all bucket exchange (``parallel/bucket.py``), whose
    overflow retries double ``slack``, and later batches start at the
    slack reached; with ``seqpar`` each device of an ``sp`` mesh sorts
    its own position slice (``parallel/seqpar.py``).
    """
    device = run_device(device, mesh)
    if mesh is not None and not seqpar:
        _check_mesh_batch(mesh, batch_size)
    m = metrics or RunMetrics(k=k, mode="sparse")
    fp, cpath = _resume_fingerprint(
        path, k, "sparse", canonical, out_path, byte_range, min_qual, resume
    )

    ckpt = StreamCheckpoint(fingerprint=fp)
    prev = None
    if resume and cpath and os.path.exists(cpath):
        prev = StreamCheckpoint.load_if_valid(cpath)
        if prev is not None and not prev.matches(fp):
            prev = None

    spilling = False
    if k <= 10:
        acc = DenseFoldAccumulator(k)  # <= 8 MB: no budget needed
    elif mem_budget_mb or (prev is not None and prev.sparse_runs is not None):
        # A budget was asked for, or the checkpoint is a budgeted run's:
        # its run list defines the state, whatever this call asks.
        if cpath is None:
            raise ValueError(
                "mem_budget_mb needs an out_path (spill runs live next "
                "to the checkpoint sidecar)"
            )
        acc = SpillingSparseAccumulator(
            spill_dir_path(cpath),
            (mem_budget_mb or 8192) * (1 << 20),
            merge_every=merge_every,
        )
        spilling = True
    else:
        acc = SparseAccumulator(merge_every=merge_every)
    if prev is not None:
        try:
            if prev.sparse_runs is not None:
                acc.adopt_runs(prev.sparse_runs)
            else:
                acc.load_arrays(*prev.load_sparse())
            ckpt = prev
        except (OSError, ValueError, KeyError):
            # Torn sidecar or missing runs: restart from scratch, and
            # clear stale spill files so that they cannot double-count.
            ckpt = StreamCheckpoint(fingerprint=fp)
            if spilling:
                acc.adopt_runs([])

    dense_fold = isinstance(acc, DenseFoldAccumulator)
    # The bucket exchange's outputs are key streams, not rows.
    pipe = _BatchPipeline(device, _sparse_spectrum_compute(k, canonical, mesh, seqpar,
                                                            slack),
                          cut_rows=mesh is None or seqpar)

    def fold(host) -> None:
        t0 = time.perf_counter()
        arrs = [t.numpy() for t in host]
        if dense_fold and len(arrs) == 2:
            acc.add_pairs(*arrs)
        else:
            acc.add(*fetched_to_triples(arrs, k))
        m.stages["fold_bg"] = m.stages.get("fold_bg", 0.0) + (
            time.perf_counter() - t0
        )

    pending: list[_InFlight] = []
    folds: list = []  # (future, job) in submission order
    since_ckpt = 0
    folder = concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="cfrk-fold"
    )

    def wait_folds(keep: int = 0) -> None:
        """Join folds, oldest first, until ``keep`` remain; each joined
        fold's host buffers go back to the pipeline."""
        with m.stage("fold_wait"):
            while len(folds) > keep:
                fut, job = folds.pop(0)
                fut.result()  # re-raise the worker's error
                pipe.release(job)

    def drain_one() -> None:
        nonlocal since_ckpt
        job = pending.pop(0)
        with m.stage("materialize"):
            host = pipe.wait(job)
        folds.append((folder.submit(fold, host), job))
        while folds and folds[0][0].done():
            fut, done_job = folds.pop(0)
            fut.result()
            pipe.release(done_job)
        if len(folds) > _MAX_FOLD_QUEUE:
            wait_folds(_MAX_FOLD_QUEUE)
        # reads_done never runs ahead of the state a checkpoint holds:
        # every outstanding fold is joined before one is written.
        ckpt.reads_done += job.n_reads
        ckpt.input_offset = job.end_offset
        since_ckpt += 1
        if cpath and since_ckpt >= checkpoint_every:
            wait_folds()
            with m.stage("checkpoint"):
                if spilling:
                    ckpt.sparse_runs = acc.checkpoint_runs()
                else:
                    ckpt.save_sparse(cpath, *acc.result_arrays())
                ckpt.save(cpath)
                malloc_trim()  # return freed arena pages at the quiet point
            since_ckpt = 0

    gen = _resume_batches(path, k, batch_size, ckpt, byte_range, min_qual)
    batches = _prefetched(gen, metrics=m)
    try:
        for batch in batches:
            with m.stage("dispatch"):
                pending.append(pipe.submit(batch))
            m.batches += 1
            m.reads += batch.n_reads
            m.bases += int(batch.lengths.sum())
            if len(pending) > 2:
                drain_one()
        while pending:
            drain_one()
        wait_folds()
    finally:
        batches.close()
        folder.shutdown(wait=True, cancel_futures=True)

    m.total_reads = ckpt.reads_done
    if finalize == "accumulator":
        return acc, None, m
    keys, counts = acc.result_arrays()
    if cleanup:
        if cpath and os.path.exists(cpath):
            ckpt.cleanup(cpath)
        elif spilling:
            acc.cleanup_spill()
    return keys, counts, m
