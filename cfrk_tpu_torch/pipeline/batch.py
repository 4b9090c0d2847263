"""Ragged reads → fixed-shape padded batches (host side).

A copy of ``cfrk_tpu/pipeline/batch.py``: :func:`pad_reads` packs a list
of reads in numpy, :func:`pad_reads_flat` a flat code buffer through the
host library (``io/native``).

Layout: ``codes[B, L]`` int8 with 0..3 = bases and -1 = invalid/padding,
``lengths[B]`` int32.  Padding with -1 makes window validity purely
local: a window is valid iff all its codes are >= 0, so no kernel needs
a separate length mask.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

import numpy as np

__all__ = [
    "ReadBatch",
    "pad_reads",
    "pad_reads_flat",
    "iter_batches",
    "len_bucket",
    "round_up",
    "auto_batch_size",
]

PAD = -1


def auto_batch_size(read_len_hint: int | None = None,
                    backend: str | None = None) -> int:
    """Reads per device batch.  The historical 8192 for every read
    length: the JAX package's length-scaled rule was tuned to a TPU's
    dispatch cost and is not carried over until it is measured on the
    GPU, so the JAX signature's read-length hint and backend are taken
    and not read."""
    return 8192


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ReadBatch:
    """A fixed-shape batch of encoded reads.

    codes:    [B, L] int8, 0..3 valid, -1 invalid/pad.
    lengths:  [B] int32 true read lengths (0 for padding rows).
    n_reads:  number of real (non-padding) rows.
    """

    codes: np.ndarray
    lengths: np.ndarray
    n_reads: int
    # Input byte offset just past this batch's last record, where the
    # source has one (plain and bgzf files): a checkpointed run resumes
    # by seeking there instead of re-parsing.
    end_offset: int | None = None

    @property
    def batch_size(self) -> int:
        return self.codes.shape[0]

    @property
    def max_len(self) -> int:
        return self.codes.shape[1]


def pad_reads(
    reads: Sequence[np.ndarray],
    batch_size: int | None = None,
    max_len: int | None = None,
    len_multiple: int = 128,
) -> ReadBatch:
    """Pack a ragged list of code arrays into one padded batch (width
    ``max_len``, default the longest read rounded up to ``len_multiple``);
    a read longer than ``max_len`` raises (reads are never truncated)."""
    n = len(reads)
    b = batch_size or n
    if n > b:
        raise ValueError(f"{n} reads > batch_size {b}")
    longest = max((len(r) for r in reads), default=0)
    ml = max_len or round_up(max(longest, 1), len_multiple)
    if longest > ml:
        raise ValueError(f"read of length {longest} exceeds max_len {ml}")
    codes = np.full((b, ml), PAD, dtype=np.int8)
    lengths = np.zeros(b, dtype=np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = r
        lengths[i] = len(r)
    return ReadBatch(codes=codes, lengths=lengths, n_reads=n)


def pad_reads_flat(
    flat: np.ndarray,
    lengths: np.ndarray,
    batch_size: int | None = None,
    max_len: int | None = None,
    len_multiple: int = 128,
) -> ReadBatch:
    """:func:`pad_reads` for a FLAT code buffer + lengths: ``flat`` is
    the reads' codes laid end to end (the chunked parser's output,
    ``io.native.iter_record_blocks_native``), ``lengths`` their lengths.
    The host library's ``pack_records`` writes each padded row with one
    memcpy and one memset, no Python loop over the reads."""
    from ..io.native import pack_records

    lengths = np.asarray(lengths, dtype=np.int64)
    n = len(lengths)
    b = batch_size or n
    if n > b:
        raise ValueError(f"{n} reads > batch_size {b}")
    longest = int(lengths.max(initial=0))
    ml = max_len or round_up(max(longest, 1), len_multiple)
    if longest > ml:
        raise ValueError(f"read of length {longest} exceeds max_len {ml}")
    if int(lengths.sum()) != len(flat):
        raise ValueError("lengths do not sum to the flat buffer size")
    out_lengths = np.zeros(b, dtype=np.int32)
    out_lengths[:n] = lengths
    return ReadBatch(codes=pack_records(flat, lengths, b, ml),
                     lengths=out_lengths, n_reads=n)


def len_bucket(n: int, base: int = 128) -> int:
    """Smallest base·2^j >= n: bounds the set of batch shapes to O(log L)."""
    b = base
    while b < n:
        b *= 2
    return b


def iter_batches(
    reads: Iterable[np.ndarray],
    batch_size: int,
    max_len: int | None = None,
) -> Iterator[ReadBatch]:
    """Chunk a read stream into fixed-shape batches.  With
    ``max_len=None`` each batch pads to the length bucket of its own
    longest read, so one long contig widens only its own batch."""
    buf: list[np.ndarray] = []

    def flush():
        ml = max_len if max_len is not None else len_bucket(
            max(max(len(r) for r in buf), 1)
        )
        return pad_reads(buf, batch_size, ml)

    for r in reads:
        buf.append(np.asarray(r, dtype=np.int8))
        if len(buf) == batch_size:
            yield flush()
            buf = []
    if buf:
        yield flush()
