"""FASTA/FASTQ parsing and 2-bit base encoding (host side).

A copy of the parts of ``cfrk_tpu/io/fasta.py`` the drivers need: the
whole-file reader of the in-memory drivers, which parses through the
host library (``io/native``, C++) as the JAX package's does, stdin
(``-``, plain or gzip bytes), and the record loops in numpy and Python,
among them the record stream with input byte offsets, the oracle of the
streaming drivers' chunked native ingest.  The port cannot import that
module: any ``cfrk_tpu`` import runs the JAX package's ``__init__``,
which imports jax.

Encoding contract: A/a→0, C/c→1, G/g→2, T/t→3, anything else→-1.
Multi-line records are concatenated without their newlines; gzip inputs
are read transparently, BGZF ones through the block reader of
``io/bgzf.py``.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import os
import sys
from typing import IO, Iterator

import numpy as np

from .bgzf import is_bgzf, open_maybe_bgzf

__all__ = [
    "ENCODE_LUT",
    "DECODE_LUT",
    "encode_seq",
    "decode_codes",
    "is_stdin",
    "open_stdin_reads",
    "read_fasta",
    "iter_fasta",
    "iter_fastq",
    "iter_reads",
    "iter_fasta_encoded",
    "iter_encoded_with_offsets",
    "read_fasta_encoded",
]

# 256-entry LUT: byte -> 2-bit code, -1 for anything not in ACGTacgt.
ENCODE_LUT = np.full(256, -1, dtype=np.int8)
for _b, _v in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"Tt", 3)):
    ENCODE_LUT[_b[0]] = _v
    ENCODE_LUT[_b[1]] = _v
DECODE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_seq(seq: bytes | np.ndarray) -> np.ndarray:
    """Encode raw bases into int8 codes (0..3 valid, -1 invalid)."""
    buf = (
        np.frombuffer(seq, dtype=np.uint8)
        if isinstance(seq, (bytes, bytearray))
        else seq
    )
    return ENCODE_LUT[buf]


def decode_codes(codes: np.ndarray, invalid: bytes = b"N") -> bytes:
    """Decode int8 codes back to bases (invalid/-1 → ``invalid`` byte)."""
    codes = np.asarray(codes)
    out = np.where(codes >= 0, DECODE_LUT[np.clip(codes, 0, 3)], ord(invalid))
    return out.astype(np.uint8).tobytes()


def is_stdin(path) -> bool:
    """True for the conventional ``-`` stdin path (pipe ingest)."""
    return isinstance(path, (str, os.PathLike)) and str(path) == "-"


def open_stdin_reads() -> IO[bytes]:
    """Binary stdin as a buffered reader, gzip-decompressed when the
    pipe carries gzip bytes (``zcat x.gz | … -`` works either way).  A
    pipe has no random access: no offsets, no resume."""
    f: IO[bytes] = sys.stdin.buffer
    if not hasattr(f, "peek"):
        f = io.BufferedReader(f)  # type: ignore[arg-type]
    if f.peek(2)[:2] == b"\x1f\x8b":
        # GzipFile reads multi-member streams, so a bgzf pipe inflates
        # too (in order: blocks in parallel need a seekable file).
        return io.BufferedReader(gzip.GzipFile(fileobj=f))  # type: ignore[arg-type]
    return f


def _mask_low_qual(seq: bytes, qual: bytes, min_qual: int) -> bytes:
    """Replace bases whose Phred+33 quality is below ``min_qual`` with
    ``N`` (so every window covering them is invalid)."""
    s = np.frombuffer(seq, dtype=np.uint8).copy()
    q = np.frombuffer(qual, dtype=np.uint8)
    s[q < 33 + min_qual] = ord("N")
    return s.tobytes()


def _open_maybe_gzip(path: str | os.PathLike) -> IO[bytes]:
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        if is_bgzf(path):  # blocked gzip: parallel-inflating reader
            f.close()
            return open_maybe_bgzf(path)
        return gzip.open(f, "rb")  # type: ignore[return-value]
    return f


@contextlib.contextmanager
def _reading(path_or_file):
    """A path opened for reading (gzip and bgzf transparent) and closed
    on exit, or the caller's open binary stream, left open."""
    if isinstance(path_or_file, (str, os.PathLike)):
        with _open_maybe_gzip(path_or_file) as f:
            yield f
    else:
        yield path_or_file


def iter_fasta(path_or_file) -> Iterator[tuple[bytes, bytes]]:
    """Yield ``(header, sequence)`` pairs from a FASTA path or open
    binary stream; header excludes ``>``, sequence joins all its lines."""
    with _reading(path_or_file) as f:
        header: bytes | None = None
        parts: list[bytes] = []
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if header is not None:
                    yield header, b"".join(parts)
                header = line[1:]
                parts = []
            elif line:
                parts.append(line)
        if header is not None:
            yield header, b"".join(parts)


def read_fasta(path) -> tuple[list[bytes], list[bytes]]:
    """Read all FASTA records of a path (gzip and bgzf transparent) or
    an open binary stream; returns (headers, sequences)."""
    pairs = list(iter_fasta(path))
    return [h for h, _ in pairs], [s for _, s in pairs]


def iter_fastq(path_or_file, min_qual: int = 0) -> Iterator[tuple[bytes, bytes]]:
    """Yield ``(header, sequence)`` from a 4-line-record FASTQ path or
    open binary stream; ``min_qual`` > 0 masks bases below that Phred
    quality to N."""
    with _reading(path_or_file) as f:
        while True:
            hdr = f.readline()
            if not hdr:
                return
            hdr = hdr.rstrip(b"\r\n")
            if not hdr:
                continue
            if not hdr.startswith(b"@"):
                raise ValueError(f"malformed FASTQ header: {hdr[:40]!r}")
            seq = f.readline().rstrip(b"\r\n")
            plus = f.readline()
            if not plus.startswith(b"+"):
                raise ValueError("malformed FASTQ record: missing '+' line")
            qual = f.readline().rstrip(b"\r\n")
            if len(qual) != len(seq):
                raise ValueError("malformed FASTQ record: quality length mismatch")
            if min_qual:
                seq = _mask_low_qual(seq, qual, min_qual)
            yield hdr[1:], seq


def iter_reads(path_or_file, min_qual: int = 0) -> Iterator[tuple[bytes, bytes]]:
    """Yield ``(header, sequence)`` from a FASTA or FASTQ path or open
    binary stream, sniffed by the first non-blank byte (``>`` vs ``@``);
    gzip is transparent for paths."""
    with _reading(path_or_file) as f:
        if hasattr(f, "peek"):
            head = f.peek(64)
        else:
            pos = f.tell()
            head = f.read(64)
            f.seek(pos)
        if head.lstrip(b"\r\n")[:1] == b"@":
            yield from iter_fastq(f, min_qual)
        else:
            yield from iter_fasta(f)


def iter_fasta_encoded(path, min_qual: int = 0) -> Iterator[np.ndarray]:
    """Stream encoded records one at a time (constant memory): FASTA or
    FASTQ (sniffed), plain or gzipped."""
    for _, s in iter_reads(path, min_qual):
        yield encode_seq(s)


def iter_encoded_with_offsets(
    path, start_offset: int | None = None, min_qual: int = 0
) -> Iterator[tuple[np.ndarray, int | None]]:
    """Stream ``(codes, end_offset)`` with input byte offsets.

    ``end_offset`` is the byte position just PAST each record: the file
    position for plain files, the decompressed position for bgzf.  The
    streaming driver checkpoints it so that resume can seek instead of
    re-parsing gigabytes.  For plain gzip inputs offsets are None
    (resume falls back to record skipping).  ``start_offset`` seeks
    there before parsing; it must point at a record boundary, i.e. a
    previously yielded end_offset.
    """
    f = open(path, "rb")
    if f.peek(2)[:2] == b"\x1f\x8b":
        f.close()
        if not is_bgzf(path):
            # plain gzip: no random access, offsets meaningless
            if start_offset:
                raise ValueError("start_offset unsupported for gzip input")
            for codes in iter_fasta_encoded(path, min_qual):
                yield codes, None
            return
        # bgzf: decompressed offsets are valid resume points
        # (BgzfReader.seek_decompressed) — count positions manually,
        # since tell() on the unseekable raw stream is unavailable.
        bf = open_maybe_bgzf(path)
        try:
            if start_offset:
                bf.raw.seek_decompressed(start_offset)
            yield from _offset_records(
                _CountingReader(bf, start_offset or 0), min_qual
            )
        finally:
            bf.close()
        return
    try:
        if start_offset:
            f.seek(start_offset)
        yield from _offset_records(f, min_qual)
    finally:
        f.close()


class _CountingReader:
    """readline/tell/peek over an unseekable stream, counting positions
    (bgzf path of :func:`iter_encoded_with_offsets`)."""

    def __init__(self, f, pos: int):
        self._f = f
        self._pos = pos

    def readline(self) -> bytes:
        line = self._f.readline()
        self._pos += len(line)
        return line

    def tell(self) -> int:
        return self._pos

    def peek(self, n: int = 64) -> bytes:
        return self._f.peek(n)


def _offset_records(f, min_qual: int = 0) -> Iterator[tuple[np.ndarray, int]]:
    """The (codes, end_offset) record loop over an open byte stream
    positioned at a record boundary (shared by the plain-file and
    bgzf branches of :func:`iter_encoded_with_offsets`)."""
    head = f.peek(64)
    fastq = head.lstrip(b"\r\n")[:1] == b"@"
    if fastq:
        while True:
            hdr = f.readline()
            if not hdr:
                return
            if not hdr.rstrip(b"\r\n"):
                continue
            if not hdr.startswith(b"@"):
                raise ValueError(f"malformed FASTQ header: {hdr[:40]!r}")
            seq = f.readline().rstrip(b"\r\n")
            plus = f.readline()
            if not plus.startswith(b"+"):
                raise ValueError("malformed FASTQ record: missing '+' line")
            qual = f.readline().rstrip(b"\r\n")
            if len(qual) != len(seq):
                raise ValueError(
                    "malformed FASTQ record: quality length mismatch"
                )
            if min_qual:
                seq = _mask_low_qual(seq, qual, min_qual)
            yield encode_seq(seq), f.tell()
    else:
        parts: list[bytes] = []
        in_record = False
        while True:
            line_start = f.tell()
            line = f.readline()
            if not line:
                if in_record:
                    yield encode_seq(b"".join(parts)), f.tell()
                return
            stripped = line.rstrip(b"\r\n")
            if stripped.startswith(b">"):
                if in_record:
                    yield encode_seq(b"".join(parts)), line_start
                in_record = True
                parts = []
            elif stripped and in_record:
                parts.append(stripped)


def read_fasta_encoded(path, min_qual: int = 0) -> list[np.ndarray]:
    """Read and encode all records into a ragged list of int8 code
    arrays, through the host library's parser (gzip and bgzf inputs are
    read whole and decompressed first); the records of
    :func:`iter_fasta_encoded`.  ``-`` reads stdin whole (a gzip pipe
    decompresses)."""
    from .native import parse_encode_bytes, read_fasta_encoded_native

    if is_stdin(path):
        return parse_encode_bytes(open_stdin_reads().read(), min_qual)
    return read_fasta_encoded_native(path, min_qual)
