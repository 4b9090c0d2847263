"""The `.cfrk` output format and the spectrum text writers (host side).

A numpy copy of ``cfrk_tpu/format.py``; its bytes are identical (pinned
by tests/test_torch_format.py and the goldens).
The contract, from the reference writer (``src/main.cu:26-62``):

* one row per read, in input order;
* a row is ``"<index>:<count> "`` cells, each with a trailing space —
  every index in ``[0, 4**k)`` for dense rows, only nonzero cells for
  ``--nonzero`` rows (an empty row is empty);
* rows are joined by a single ``"\\n"``; no trailing newline.

:class:`CfrkWriter` formats through the host library
(``io/native``, C++), as the JAX package's writer does.  The numpy
functions here write the same bytes and are its oracle in the tests and
the chip smoke: every cell is formatted by one vectorised numpy pass
(:func:`_cells_bytes`): decimal digits are written into a preallocated
byte buffer one digit position at a time, so the cost is a few array
passes per digit, not a Python f-string per cell.  Rows go through in
slabs of about :data:`_SLAB_CELLS` cells to bound the temporaries.

The spectrum modes' tab-separated lines are written the same way:
:func:`format_spectrum_tsv_bytes` (``index<TAB>count`` of a dense table,
the writer the CLI uses, as the JAX CLI's is Python) and
:func:`format_kmer_tsv_bytes` (``KMER<TAB>count`` of a sparse spectrum,
the oracle of the host library's ``format_kmer_tsv``), each byte-equal
to the JAX CLI's Python line loop.
"""

from __future__ import annotations

import gzip
import os
from typing import IO

import numpy as np

from .io import native

__all__ = [
    "CfrkWriter",
    "parse_cfrk",
    "format_rows",
    "format_rows_nonzero",
    "format_file_bytes",
    "format_rows_pairs",
    "format_pairs_bytes",
    "format_dense_pairs_bytes",
    "format_rows_bytes",
    "format_spectrum_tsv_bytes",
    "format_kmer_tsv_bytes",
]

# Cells per formatting slab: ~25 bytes of temporaries per cell.
_SLAB_CELLS = 1 << 22
_POW10 = [np.uint64(10**p) for p in range(20)]


def _n_digits(v: np.ndarray) -> np.ndarray:
    """Decimal digit count (>= 1) of each uint64 value."""
    nd = np.ones(v.shape, dtype=np.int64)
    top = int(v.max(initial=0))
    for p in range(1, 20):
        if 10**p > top:
            break
        nd += v >= _POW10[p]
    return nd


def _put_decimal(out: np.ndarray, end: np.ndarray, v: np.ndarray,
                 nd: np.ndarray) -> None:
    """Write each ``v`` in ASCII decimal into ``out[end - nd : end]``."""
    pos = end - 1
    for d in range(int(nd.max(initial=0))):
        if d:
            keep = nd > d
            pos, v, nd = pos[keep], v[keep], nd[keep]
        out[pos] = 48 + (v % 10).astype(np.uint8)
        v = v // 10
        pos = pos - 1


def _cells_bytes(n_rows: int, row_of_cell: np.ndarray, keys: np.ndarray,
                 counts: np.ndarray, first: bool) -> bytes:
    """``"key:count "`` cells grouped into rows, rows joined by ``\\n``.

    Cells come in row-major order (``row_of_cell`` ascending); a row
    with no cells is an empty row.  ``first=False`` prefixes a newline
    (the continuation of a started file).
    """
    if n_rows == 0:
        return b""
    keys = keys.astype(np.uint64, copy=False)
    counts = counts.astype(np.uint64, copy=False)
    nd_k = _n_digits(keys)
    nd_c = _n_digits(counts)
    width = nd_k + nd_c + 2
    # Newlines before row r: r, or r + 1 when continuing a file.
    nl_before = np.arange(n_rows, dtype=np.int64) + (0 if first else 1)
    row_len = np.bincount(row_of_cell, weights=width, minlength=n_rows)
    row_len = row_len.astype(np.int64)
    row_start = np.zeros(n_rows, dtype=np.int64)
    np.cumsum(row_len[:-1], out=row_start[1:])
    row_start += nl_before
    cell_start = np.zeros(width.size, dtype=np.int64)
    np.cumsum(width[:-1], out=cell_start[1:])
    cell_start += nl_before[row_of_cell]
    total = int(row_start[-1] + row_len[-1])
    out = np.empty(total, dtype=np.uint8)
    newline_rows = row_start[(1 if first else 0):]
    out[newline_rows - 1] = ord("\n")
    colon = cell_start + nd_k
    out[colon] = ord(":")
    space = colon + 1 + nd_c
    out[space] = ord(" ")
    _put_decimal(out, colon, keys, nd_k)
    _put_decimal(out, space, counts, nd_c)
    return out.tobytes()


def format_pairs_bytes(idx: np.ndarray, counts: np.ndarray, *,
                       first: bool = True) -> bytes:
    """`.cfrk` bytes of sparse per-read (idx, counts) pair rows.

    idx/counts: [B, W]; cells with count <= 0 are skipped (they carry
    the sparse sentinel, which may have wrapped in a narrowed dtype).
    Rows must already be ascending in idx, as the sort-based per-read
    ops emit them.  idx may be int32 or the uint64 combined code of
    k > 15.
    """
    idx = np.asarray(idx)
    counts = np.asarray(counts)
    if idx.shape != counts.shape or idx.ndim != 2:
        raise ValueError("idx/counts must be equal-shape 2-D")
    n = idx.shape[0]
    rows = max(1, _SLAB_CELLS // max(idx.shape[1], 1))
    parts = []
    for s in range(0, n, rows):
        cnt = counts[s : s + rows]
        r, c = np.nonzero(cnt > 0)
        parts.append(_cells_bytes(
            cnt.shape[0], r, idx[s : s + rows][r, c], cnt[r, c],
            first and s == 0,
        ))
    return b"".join(parts)


def format_rows_bytes(counts: np.ndarray, *, first: bool = True) -> bytes:
    """`.cfrk` bytes of a dense ``[n, 4**k]`` count block (every cell)."""
    counts = np.asarray(counts)
    if counts.ndim != 2:
        raise ValueError(f"counts must be 2-D [n_reads, 4**k], got {counts.shape}")
    n, fk = counts.shape
    rows = max(1, _SLAB_CELLS // max(fk, 1))
    parts = []
    for s in range(0, n, rows):
        block = counts[s : s + rows]
        m = block.shape[0]
        parts.append(_cells_bytes(
            m, np.repeat(np.arange(m), fk), np.tile(np.arange(fk), m),
            block.reshape(-1), first and s == 0,
        ))
    return b"".join(parts)


def format_dense_pairs_bytes(idx: np.ndarray, counts: np.ndarray, fk: int,
                             *, first: bool = True) -> bytes:
    """DENSE rows (all ``fk`` bins) from sparse (idx, counts) pair rows —
    byte-identical to :func:`format_rows_bytes` on the densified block.
    Densifies one slab at a time, never the whole matrix."""
    idx = np.asarray(idx)
    counts = np.asarray(counts)
    if idx.shape != counts.shape or idx.ndim != 2:
        raise ValueError("idx/counts must be equal-shape 2-D")
    rows = max(1, _SLAB_CELLS // max(fk, 1))
    parts = []
    for s in range(0, idx.shape[0], rows):
        cnt = counts[s : s + rows]
        r, c = np.nonzero(cnt > 0)
        dense = np.zeros((cnt.shape[0], fk), dtype=np.int64)
        dense[r, idx[s : s + rows][r, c].astype(np.int64)] = cnt[r, c]
        parts.append(format_rows_bytes(dense, first=first and s == 0))
    return b"".join(parts)


def format_rows_pairs(idx: np.ndarray, counts: np.ndarray) -> list[bytes]:
    """Per-read row bytes from (idx, counts) pair matrices (the cells of
    :func:`format_pairs_bytes`, one list entry per row)."""
    if np.asarray(idx).shape[0] == 0:
        return []
    return format_pairs_bytes(idx, counts).split(b"\n")


def format_rows(counts: np.ndarray) -> list[bytes]:
    """Per-read row bytes of a dense ``[n_reads, 4**k]`` count matrix
    (every cell), one list entry per row."""
    body = format_rows_bytes(counts)
    return body.split(b"\n") if np.asarray(counts).shape[0] else []


def format_rows_nonzero(counts: np.ndarray) -> list[bytes]:
    """Per-read row bytes listing only the NONZERO ``idx:count`` cells
    of a dense count matrix (the ``--nonzero`` rows); a row with no
    k-mers is an empty byte string."""
    return format_rows_pairs(*_dense_to_pairs(counts))


def format_file_bytes(counts: np.ndarray) -> bytes:
    """A full dense `.cfrk` file: rows joined by b"\\n", no trailing newline."""
    return format_rows_bytes(counts)


def _dense_to_pairs(counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dense ``[n, 4**k]`` block → rectangular (idx, counts) pair
    matrices whose count-0 cells are padding (the cell contract of
    :func:`format_pairs_bytes`).  A row with no nonzero cells stays a
    row."""
    counts = np.asarray(counts)
    n = counts.shape[0]
    nzr, nzc = np.nonzero(counts)
    rowcnt = np.bincount(nzr, minlength=n)
    m = int(rowcnt.max(initial=0))
    if m == 0:
        z = np.zeros((n, 1), dtype=np.int32)
        return z, z
    starts = np.concatenate([[0], np.cumsum(rowcnt)[:-1]])
    pos = np.arange(len(nzr)) - starts[nzr]
    idx = np.zeros((n, m), dtype=np.int32)
    cnt = np.zeros((n, m), dtype=np.int32)
    idx[nzr, pos] = nzc
    cnt[nzr, pos] = counts[nzr, nzc]
    return idx, cnt


def _tsv_lines(first_width: np.ndarray, counts: np.ndarray):
    """A buffer of lines ``<first field><TAB><count><LF>`` with the tabs,
    the counts' digits and the newlines written; returns ``(buf,
    line_start)`` for the caller to fill each line's first
    ``first_width`` bytes."""
    counts = counts.astype(np.uint64, copy=False)
    nd = _n_digits(counts)
    end = np.cumsum(first_width + nd + 2)
    start = end - (first_width + nd + 2)
    buf = np.empty(int(end[-1]) if end.size else 0, dtype=np.uint8)
    buf[start + first_width] = ord("\t")
    buf[end - 1] = ord("\n")
    _put_decimal(buf, end - 1, counts, nd)
    return buf, start


def format_spectrum_tsv_bytes(table: np.ndarray, min_count: int = 1) -> bytes:
    """``index<TAB>count`` lines of a dense spectrum, one for each bin
    with count >= max(min_count, 1), in index order."""
    table = np.asarray(table)
    (nz,) = np.nonzero(table >= max(min_count, 1))
    parts = []
    for s in range(0, nz.size, _SLAB_CELLS):
        idx = nz[s : s + _SLAB_CELLS].astype(np.uint64)
        nd = _n_digits(idx)
        buf, start = _tsv_lines(nd, table[nz[s : s + _SLAB_CELLS]])
        _put_decimal(buf, start + nd, idx, nd)
        parts.append(buf.tobytes())
    return b"".join(parts)


_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def format_kmer_tsv_bytes(keys: np.ndarray, counts: np.ndarray, k: int,
                          min_count: int = 1) -> bytes:
    """``KMER<TAB>count`` lines of a sparse spectrum, one for each key
    with count >= max(min_count, 1), in the given order.  A key is the
    k-mer's base-4 code, first base most significant."""
    keys = np.asarray(keys, dtype=np.uint64)
    counts = np.asarray(counts)
    if keys.shape != counts.shape:
        raise ValueError("keys/counts size mismatch")
    mask = counts >= max(min_count, 1)
    keys, counts = keys[mask], counts[mask]
    # About k + 20 bytes of temporaries per line and base.
    slab = max(1, _SLAB_CELLS // k)
    parts = []
    for s in range(0, keys.size, slab):
        kk = keys[s : s + slab]
        buf, start = _tsv_lines(np.full(kk.size, k, np.int64), counts[s : s + slab])
        for j in range(k):
            base = (kk >> np.uint64(2 * (k - 1 - j))) & np.uint64(3)
            buf[start + j] = _BASES[base]
        parts.append(buf.tobytes())
    return b"".join(parts)


class CfrkWriter:
    """Streaming `.cfrk` writer: batches arrive one at a time while the
    file contract holds — a newline before every row but the first.
    Rows are formatted by the host library (``io/native``).
    A path ending in ``.gz`` is written gzip-compressed.  ``nonzero=True``
    makes :meth:`write_batch` write only the nonzero cells of each row.
    ``continuing=True`` resumes mid-file: rows already exist, so the next
    row written is preceded by a newline (checkpoint resume; for a path
    the caller opens the file itself, since a path is opened anew)."""

    def __init__(self, f: IO[bytes] | str | os.PathLike, *,
                 continuing: bool = False, nonzero: bool = False):
        if isinstance(f, (str, os.PathLike)):
            self._f: IO[bytes] = (
                gzip.open(f, "wb") if str(f).endswith(".gz") else open(f, "wb")
            )
            self._owns = True
        else:
            self._f = f
            self._owns = False
        self._first = not continuing
        self._nonzero = nonzero

    def _write(self, data: bytes, n_rows: int) -> None:
        if n_rows:
            self._f.write(data)
            self._first = False

    def write_batch(self, counts: np.ndarray) -> None:
        """The rows of a ``[n, 4**k]`` count block: every cell, or its
        nonzero cells with ``nonzero=True``."""
        counts = np.asarray(counts)
        if counts.shape[0] == 0:
            return
        if not self._nonzero:
            self._write(native.format_rows_bytes(counts, first=self._first),
                        counts.shape[0])
            return
        # Row slabs of ~64 MB of counts bound the pair matrices.
        rows = max(1, (1 << 26) // max(counts[0].nbytes, 1))
        for s in range(0, counts.shape[0], rows):
            block = counts[s : s + rows]
            self._write(
                native.format_pairs_bytes(*_dense_to_pairs(block), first=self._first),
                block.shape[0])

    def write_pairs(self, idx: np.ndarray, counts: np.ndarray) -> None:
        """Nonzero rows from (idx, counts) pair matrices."""
        self._write(
            native.format_pairs_bytes(idx, counts, first=self._first), len(idx)
        )

    def write_pairs_dense(self, idx: np.ndarray, counts: np.ndarray,
                          fk: int) -> None:
        """Dense rows (all ``fk`` bins) from (idx, counts) pair matrices."""
        self._write(
            native.format_dense_pairs_bytes(idx, counts, fk, first=self._first),
            len(idx),
        )

    def close(self) -> None:
        if self._owns:
            self._f.close()

    def __enter__(self) -> "CfrkWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def parse_cfrk(data: bytes) -> np.ndarray:
    """Parse dense `.cfrk` bytes back into a ``[n_reads, 4**k]`` int64
    matrix; tolerant only of the exact reference format."""
    rows = data.split(b"\n")
    out: list[list[int]] = []
    for row in rows:
        cells = row.strip().split(b" ")
        vals = []
        for cell in cells:
            idx, cnt = cell.split(b":")
            if int(idx) != len(vals):
                raise ValueError("non-dense or out-of-order .cfrk row")
            vals.append(int(cnt))
        out.append(vals)
    width = len(out[0])
    if any(len(v) != width for v in out):
        raise ValueError("ragged .cfrk rows")
    return np.array(out, dtype=np.int64)
