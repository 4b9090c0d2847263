"""The host library: FASTA/FASTQ parse, batch packing, the `.cfrk` / tsv
formatters and the dense fold, in C++.

ctypes wrappers over ``csrc/fastaio.cpp``, a plain-C port of the JAX
package's extension (``cfrk_tpu/io/native``), under that package's
names and contracts.  The library is built by the host C++ compiler at
the first call (``ops/cuda/build.py``; ``$CXX``, else ``c++``/``g++``),
never at import.  There is no fallback: a missing compiler or a failed
build raises.  The numpy functions of ``format.py``, the record loops
of ``io/fasta.py`` and ``ops/sparse.fold_pairs_into`` compute the same
bytes and arrays, and are the tests' and the chip smoke's oracle.

ctypes releases the interpreter lock for each call, so a parse in the
streaming driver's feeder thread runs beside the formatter and the
device copies.  Every array handed to C is held by a local name until
the call returns.

Each wrapper counts the library calls it makes in its ``calls``
attribute (:data:`COUNTED` lists them), as the kernel wrappers count
their launches.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ...ops.cuda.build import load_library, once

__all__ = [
    "COUNTED",
    "parse_encode_bytes",
    "read_fasta_encoded_native",
    "iter_record_blocks_native",
    "pack_records",
    "format_rows_bytes",
    "format_pairs_bytes",
    "format_dense_pairs_bytes",
    "format_kmer_tsv_bytes",
    "fold_pairs_into",
]

_PTR = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_OUT = ctypes.POINTER(_I64)
_TEXT = ctypes.POINTER(ctypes.c_void_p)

# Error codes of csrc/fastaio.cpp that are not input errors.
_ERR_NOMEM = 9
_ERR_INTERNAL = 10

_count_lock = threading.Lock()

# A bytes object filled in place: the formatters' text is copied once,
# from the library's row segments into the bytes the caller gets.
_new_bytes = ctypes.pythonapi.PyBytes_FromStringAndSize
_new_bytes.argtypes = (ctypes.c_char_p, ctypes.c_ssize_t)
_new_bytes.restype = ctypes.py_object
_bytes_data = ctypes.pythonapi.PyBytes_AsString
_bytes_data.argtypes = (ctypes.py_object,)
_bytes_data.restype = _PTR


@once
def _library() -> ctypes.CDLL:
    """The built library with its signatures declared, once per process
    (a failed build is not cached: the next call builds again)."""
    lib = load_library("fastaio")
    lib.cfrk_strerror.argtypes = [_INT]
    lib.cfrk_strerror.restype = ctypes.c_char_p
    lib.cfrk_count_lines.argtypes = [_PTR, _I64]
    lib.cfrk_count_lines.restype = _I64
    lib.cfrk_parse_encode.argtypes = [_PTR, _I64, _INT, _PTR, _PTR, _OUT, _OUT]
    lib.cfrk_parse_encode_stream.argtypes = (
        [_PTR, _I64, _INT, _INT, _INT, _PTR, _PTR, _PTR] + [_OUT] * 3
    )
    lib.cfrk_pack_records.argtypes = [_PTR, _I64, _PTR, _I64, _I64, _I64, _PTR]
    lib.cfrk_format_rows.argtypes = [_PTR, _INT, _I64, _I64, _INT, _TEXT, _OUT]
    lib.cfrk_format_pairs.argtypes = [_PTR, _PTR, _I64, _I64, _INT, _TEXT, _OUT]
    lib.cfrk_format_pairs64.argtypes = lib.cfrk_format_pairs.argtypes
    lib.cfrk_format_dense_pairs.argtypes = (
        [_PTR, _PTR, _I64, _I64, _I64, _INT, _TEXT, _OUT]
    )
    lib.cfrk_format_kmer_tsv.argtypes = [_PTR, _PTR, _I64, _I64, _I64, _TEXT, _OUT]
    lib.cfrk_text_take.argtypes = [_PTR, _PTR]
    lib.cfrk_text_take.restype = None
    lib.cfrk_text_free.argtypes = [_PTR]
    lib.cfrk_text_free.restype = None
    lib.cfrk_fold_pairs.argtypes = [_PTR, _INT, _PTR, _INT, _I64, _PTR, _I64]
    for fn in (lib.cfrk_parse_encode, lib.cfrk_parse_encode_stream,
               lib.cfrk_pack_records, lib.cfrk_format_rows, lib.cfrk_format_pairs,
               lib.cfrk_format_pairs64, lib.cfrk_format_dense_pairs,
               lib.cfrk_format_kmer_tsv, lib.cfrk_fold_pairs):
        fn.restype = _INT
    return lib


def _check(lib, rc: int) -> None:
    """Raise for a library error code: the JAX package's ValueError texts
    for input errors."""
    if rc == 0:
        return
    text = lib.cfrk_strerror(rc).decode()
    if rc == _ERR_NOMEM:
        raise MemoryError(text)
    if rc == _ERR_INTERNAL:
        raise RuntimeError(text)
    raise ValueError(text)


def _count(fn) -> None:
    with _count_lock:
        fn.calls += 1


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _text(lib, entry, *args) -> bytes:
    """Call a formatter entry point; copy its text into a new bytes
    object and free it (also when the copy cannot be made)."""
    text, size = ctypes.c_void_p(), _I64()
    _check(lib, entry(*args, ctypes.byref(text), ctypes.byref(size)))
    try:
        if size.value == 0:
            return b""
        out = _new_bytes(None, size.value)
        lib.cfrk_text_take(text, _bytes_data(out))
        text = None
        return out
    finally:
        if text is not None:
            lib.cfrk_text_free(text)


def _qual_byte(min_qual: int) -> int:
    """The Phred+33 byte below which a FASTQ base is masked, 0 for none."""
    return 33 + min_qual if min_qual else 0


def _parse_outputs(lib, buf: np.ndarray, streams: int):
    """Caller-owned parse outputs: codes (at most one a byte) and
    ``streams`` int64 arrays of one slot a line (a bound on records)."""
    lines = lib.cfrk_count_lines(_ptr(buf), buf.size)
    return (np.empty(buf.size, np.int8),
            *(np.empty(lines, np.int64) for _ in range(streams)))


def parse_encode_bytes(data, min_qual: int = 0) -> list[np.ndarray]:
    """Parse a raw (already decompressed) FASTA or FASTQ buffer into
    encoded reads, one int8 array each (views of one code buffer).

    ``min_qual`` masks FASTQ bases below that Phred+33 quality to the
    invalid code (no-op for FASTA)."""
    lib = _library()
    buf = np.frombuffer(data, dtype=np.uint8)
    codes, lengths = _parse_outputs(lib, buf, 1)
    n_codes, n_rec = _I64(), _I64()
    _check(lib, lib.cfrk_parse_encode(
        _ptr(buf), buf.size, _qual_byte(min_qual), _ptr(codes), _ptr(lengths),
        ctypes.byref(n_codes), ctypes.byref(n_rec)))
    _count(parse_encode_bytes)
    ends = np.cumsum(lengths[: n_rec.value]).tolist()
    return [codes[a:b] for a, b in zip([0] + ends, ends)]


def _parse_stream(lib, data: bytes, fastq: bool, final: bool, qthr: int):
    """One block of the chunked parser: (codes, lengths, end offsets
    relative to the block, consumed bytes)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    codes, lengths, offsets = _parse_outputs(lib, buf, 2)
    n_codes, n_rec, consumed = _I64(), _I64(), _I64()
    _check(lib, lib.cfrk_parse_encode_stream(
        _ptr(buf), buf.size, int(fastq), int(final), qthr, _ptr(codes),
        _ptr(lengths), _ptr(offsets), ctypes.byref(n_codes),
        ctypes.byref(n_rec), ctypes.byref(consumed)))
    _count(iter_record_blocks_native)
    n = n_rec.value
    return codes[: n_codes.value], lengths[:n], offsets[:n], consumed.value


def iter_record_blocks_native(
    path,
    start_offset: int | None = None,
    block_size: int = 64 << 20,
    limit_offset: int | None = None,
    decompress: bool = False,
    min_qual: int = 0,
):
    """Stream (flat_codes int8, lengths int64, end_offsets int64) blocks
    through the chunked parser.

    Each block holds the records COMPLETED within ~block_size bytes of
    input; ``end_offsets`` are absolute positions just past each record,
    the checkpoint seek points (the contract of
    io.fasta.iter_encoded_with_offsets).  An incomplete trailing record
    carries over to the next block; a record larger than the block
    doubles the read size until it fits.  One block is read and parsed
    ahead of the consumer, on a thread of its own.

    ``limit_offset``: stop BEFORE the first record whose start position
    is >= limit (a FASTA record's start is the previous record's end
    offset, so byte ranges that abut at record boundaries cover every
    record once).

    ``decompress=True`` streams a gzip input through the same parser
    (``io/bgzf.open_maybe_bgzf``).  Offsets are then positions in the
    DECOMPRESSED stream: resume points for bgzf (its reader seeks them
    from block metadata), but not for plain gzip, where ``start_offset``
    and ``limit_offset`` are refused (callers checkpoint by record count
    instead).

    ``path`` may also be an open binary stream: it is read sequentially
    and closed at EOF; offsets are stream positions, and
    ``start_offset`` / ``decompress`` must be unset.
    """
    from concurrent.futures import ThreadPoolExecutor

    lib = _library()
    qthr = _qual_byte(min_qual)
    if hasattr(path, "read"):  # an already open stream
        if start_offset or decompress:
            raise ValueError("a stream input has no random access")
        opened = path
    elif decompress:
        from ..bgzf import open_maybe_bgzf

        opened = open_maybe_bgzf(path)
        seekable = hasattr(getattr(opened, "raw", None), "seek_decompressed")
        if (start_offset or limit_offset is not None) and not seekable:
            opened.close()
            raise ValueError(
                "byte offsets cannot address a gzip stream; "
                "decompress the input first (or recompress with bgzip "
                "— bgzf offsets are decompressed positions and work "
                "for both resume and byte-range sharding)"
            )
    else:
        opened = open(path, "rb")
    with opened as f, ThreadPoolExecutor(1) as pool:
        if start_offset:
            if decompress:
                f.raw.seek_decompressed(start_offset)
            else:
                f.seek(start_offset)
        base = start_offset or 0
        bs = block_size

        def read_parse(carry, bs, fastq):
            """Read and parse one block; returns the format, whether the
            input has ended, the bytes to carry into the next block and
            the parse."""
            data = f.read(bs)
            final = len(data) == 0
            buf = carry + data if carry else data
            if not buf:
                return None
            fq = buf.lstrip(b"\r\n")[:1] == b"@" if fastq is None else fastq
            parsed = _parse_stream(lib, buf, fq, final, qthr)
            return fq, final, buf[parsed[3]:], parsed

        rec_start = base  # start position of the next record to yield
        fut = pool.submit(read_parse, b"", bs, None)
        while True:
            got = fut.result()
            if got is None:
                return
            fastq, final, carry, (codes, lens, offs, consumed) = got
            if not final:
                if consumed == 0:
                    bs *= 2  # a record larger than the block: widen
                fut = pool.submit(read_parse, carry, bs, fastq)
            if len(lens):
                offs = offs + base
                if limit_offset is not None:
                    # record i starts at offs[i-1] (rec_start for i=0):
                    # keep the records starting BEFORE the limit.
                    starts = np.concatenate(([rec_start], offs[:-1]))
                    keep = int(np.searchsorted(starts, limit_offset, "left"))
                    if keep < len(lens):
                        nbytes = int(lens[:keep].sum())
                        if keep:
                            yield codes[:nbytes], lens[:keep], offs[:keep]
                        return
                    rec_start = int(offs[-1])
                yield codes, lens, offs
            if final:
                return
            base += consumed


def read_fasta_encoded_native(path, min_qual: int = 0) -> list[np.ndarray]:
    """Read and encode a FASTA/FASTQ file (gzip and bgzf read whole and
    decompressed first) through the whole-buffer parser."""
    from ..fasta import _open_maybe_gzip

    with _open_maybe_gzip(path) as f:
        return parse_encode_bytes(f.read(), min_qual)


def pack_records(flat: np.ndarray, lengths: np.ndarray, batch_rows: int,
                 row_len: int) -> np.ndarray:
    """A padded ``[batch_rows, row_len]`` int8 batch from a flat code
    buffer and per-record lengths: row i is record i's codes then -1
    padding; rows past the records are all -1."""
    flat = np.ascontiguousarray(flat, dtype=np.int8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    out = np.empty((batch_rows, row_len), dtype=np.int8)
    lib = _library()
    _check(lib, lib.cfrk_pack_records(
        _ptr(flat), flat.size, _ptr(lengths), lengths.size, batch_rows, row_len,
        _ptr(out)))
    _count(pack_records)
    return out


def format_rows_bytes(counts: np.ndarray, *, first: bool = True) -> bytes:
    """`.cfrk` bytes of a dense ``[n, 4**k]`` count block (every cell);
    ``first=False`` prefixes a newline (continuation of a started file).
    int64 counts (a spectrum row) print in full; others as int32."""
    counts = np.asarray(counts)
    if counts.ndim != 2:
        raise ValueError(f"counts must be 2-D [n_reads, 4**k], got {counts.shape}")
    wide = counts.dtype.itemsize == 8
    counts = np.ascontiguousarray(counts, dtype=np.int64 if wide else np.int32)
    lib = _library()
    out = _text(lib, lib.cfrk_format_rows, _ptr(counts), counts.itemsize,
                counts.shape[0], counts.shape[1], int(first))
    _count(format_rows_bytes)
    return out


def _pair_matrices(idx, counts, idx_dtype):
    idx = np.ascontiguousarray(idx, dtype=idx_dtype)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    if idx.shape != counts.shape or idx.ndim != 2:
        raise ValueError("idx/counts must be equal-shape 2-D")
    return idx, counts


def format_pairs_bytes(idx: np.ndarray, counts: np.ndarray, *,
                       first: bool = True) -> bytes:
    """`.cfrk` bytes of sparse per-read (idx, counts) pair rows: cells
    with count <= 0 are skipped, rows ascend in idx.  64-bit indices
    (the combined code of k > 15) take the uint64 formatter."""
    wide = np.asarray(idx).dtype.itemsize > 4
    idx, counts = _pair_matrices(idx, counts, np.uint64 if wide else np.int32)
    lib = _library()
    entry = lib.cfrk_format_pairs64 if wide else lib.cfrk_format_pairs
    out = _text(lib, entry, _ptr(idx), _ptr(counts), idx.shape[0], idx.shape[1],
                int(first))
    _count(format_pairs_bytes)
    return out


def format_dense_pairs_bytes(idx: np.ndarray, counts: np.ndarray, fk: int, *,
                             first: bool = True) -> bytes:
    """DENSE `.cfrk` rows (all ``fk`` bins a row) from sparse per-read
    (idx, counts) pair matrices, byte-identical to
    :func:`format_rows_bytes` on the densified matrix, which is never
    built.  Rows ascend in idx; count <= 0 cells are padding."""
    idx, counts = _pair_matrices(idx, counts, np.int32)
    if fk <= 0:
        raise ValueError("pair buffer size mismatch")
    lib = _library()
    out = _text(lib, lib.cfrk_format_dense_pairs, _ptr(idx), _ptr(counts),
                idx.shape[0], idx.shape[1], int(fk), int(first))
    _count(format_dense_pairs_bytes)
    return out


def format_kmer_tsv_bytes(keys, counts, k: int, min_count: int = 1) -> bytes:
    """``KMER<TAB>count`` lines of a sparse spectrum, one for each key
    with count >= max(min_count, 1), in the given order (the threaded
    formatter of cfrk_tpu's ``_write_sparse``)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    if keys.shape != counts.shape:
        raise ValueError("keys/counts size mismatch")
    lib = _library()
    out = _text(lib, lib.cfrk_format_kmer_tsv, _ptr(keys), _ptr(counts),
                keys.size, int(k), int(min_count))
    _count(format_kmer_tsv_bytes)
    return out


def fold_pairs_into(table: np.ndarray, idx: np.ndarray, counts: np.ndarray) -> None:
    """Add (idx, count) cells into a dense int64 ``table`` in place.

    ``idx`` / ``counts``: any shape, same size, in the drain's narrow
    dtypes, read as they are (uint16 / int32 idx; uint8 / int16 / int32
    / int64 counts); cells with count <= 0 (sentinels, padding) or an
    index outside the table are skipped.  A threaded typed loop with
    private tables."""
    if (table.dtype != np.int64 or not table.flags.writeable
            or not table.flags.c_contiguous):
        raise ValueError("table must be a writable int64 array")
    idx = np.ascontiguousarray(idx)
    counts = np.ascontiguousarray(counts)
    if idx.size != counts.size:
        raise ValueError("idx/counts size mismatch")
    if idx.dtype == np.uint32:
        # lo keys are < 2**31 for every k <= 15; the uint32 sentinel
        # reads as negative and fails the bounds check (zero-copy view).
        idx = idx.view(np.int32)
    if idx.dtype not in (np.uint16, np.int32):
        idx = idx.astype(np.int32)
    if counts.dtype not in (np.uint8, np.int16, np.int32, np.int64):
        counts = counts.astype(np.int32)
    lib = _library()
    _check(lib, lib.cfrk_fold_pairs(
        _ptr(idx), idx.itemsize, _ptr(counts), counts.itemsize, idx.size,
        _ptr(table), table.size))
    _count(fold_pairs_into)


# The counted wrappers; a block of the chunked parser counts under
# iter_record_blocks_native.
COUNTED = (parse_encode_bytes, iter_record_blocks_native, pack_records,
           format_rows_bytes, format_pairs_bytes, format_dense_pairs_bytes,
           format_kmer_tsv_bytes, fold_pairs_into)
for _fn in COUNTED:
    _fn.calls = 0
del _fn
