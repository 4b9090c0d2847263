"""BGZF (blocked gzip) support: parallel-inflating reader + writer.

A copy of ``cfrk_tpu/io/bgzf.py`` (standard library only).  BGZF, the
htslib/bgzip "blocked gzip" framing, stores many small gzip members
whose compressed size is recorded in a ``BC`` extra subfield, so member
boundaries are known WITHOUT inflating:

* :class:`BgzfReader` inflates upcoming blocks on a thread pool (zlib
  releases the GIL) and serves them in order through an ordinary
  ``read(n)`` interface, a drop-in for ``gzip.open`` on bgzf files;
  :meth:`BgzfReader.seek_decompressed` positions it at a decompressed
  offset from block metadata alone, which is what lets a streamed run
  resume on a bgzf input by seeking;
* :func:`write_bgzf` produces spec-conforming bgzf;
* :func:`is_bgzf` sniffs the framing; non-bgzf gzip falls back to the
  single-stream path.

Every bgzf file is a valid multi-member gzip file, so the correctness
oracle is ``gzip.decompress``.
"""

from __future__ import annotations

import functools
import io
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

__all__ = [
    "is_bgzf",
    "BgzfReader",
    "write_bgzf",
    "open_maybe_bgzf",
    "decompressed_size",
]

_EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)  # the 28-byte empty terminator block bgzip appends


def _block_size_from_header(head: bytes) -> int | None:
    """Total compressed block size from a bgzf member header, or None
    if the member is not bgzf-framed.  ``head`` must hold at least the
    12-byte fixed header + XLEN bytes of extra field."""
    if len(head) < 14 or head[:2] != b"\x1f\x8b" or head[2] != 8:
        return None
    if not head[3] & 4:  # FEXTRA
        return None
    xlen = int.from_bytes(head[10:12], "little")
    extra = head[12 : 12 + xlen]
    if len(extra) < xlen:
        return None
    pos = 0
    while pos + 4 <= xlen:
        si1, si2 = extra[pos], extra[pos + 1]
        slen = int.from_bytes(extra[pos + 2 : pos + 4], "little")
        if si1 == 66 and si2 == 67 and slen == 2:  # 'B','C'
            bsize = int.from_bytes(extra[pos + 4 : pos + 6], "little")
            return bsize + 1
        pos += 4 + slen
    return None


def is_bgzf(path: str | os.PathLike) -> bool:
    """True when the file's first gzip member carries the BC subfield."""
    try:
        with open(path, "rb") as f:
            head = f.read(64)
    except OSError:
        return False
    return _block_size_from_header(head) is not None


def _inflate_group(raw: bytes, sizes: list[int]) -> bytes:
    """Inflate a GROUP of consecutive bgzf members (one pool task).

    Grouping several MB per task keeps the per-future Python overhead
    and GIL ping-pong negligible next to the zlib work (single blocks
    are ~60 KB: task overhead then eats the parallel win)."""
    out = []
    pos = 0
    for bsize in sizes:
        block = raw[pos : pos + bsize]
        pos += bsize
        xlen = int.from_bytes(block[10:12], "little")
        payload = block[12 + xlen : -8]  # strip hdr+extra and CRC+ISIZE
        data = zlib.decompress(payload, wbits=-15)
        isize = int.from_bytes(block[-4:], "little")
        crc = int.from_bytes(block[-8:-4], "little")
        if len(data) != isize or zlib.crc32(data) != crc:
            raise OSError(
                f"bgzf block corrupt: ISIZE {isize} vs {len(data)} "
                f"or CRC mismatch"
            )
        out.append(data)
    return b"".join(out)


class BgzfReader(io.RawIOBase):
    """Parallel-inflating reader over a BGZF file.

    Block boundaries come from the BC subfield, so the (cheap) file
    reads run ahead and the (expensive) inflates fan out over
    ``threads`` workers; ``read`` stitches the results back in order.
    Wrap in ``io.BufferedReader`` (see :func:`open_maybe_bgzf`) for
    ``peek``/``readline`` — the interface the pure-Python parsers use.
    """

    def __init__(self, path, threads: int | None = None,
                 group_bytes: int = 2 << 20, lookahead: int = 8):
        super().__init__()
        if threads is None:
            threads = min(os.cpu_count() or 1, 4)
        self._f = open(path, "rb")
        self._pool = ThreadPoolExecutor(max_workers=max(threads, 1))
        self._pending: list = []  # inflate-group futures, in file order
        self._group_bytes = group_bytes
        self._lookahead = max(lookahead, 1)
        self._buf = b""
        self._buf_pos = 0
        self._next_read_off = 0
        self._eof = False

    # -- block pipeline ------------------------------------------------
    def _read_group(self):
        """Read ~group_bytes of consecutive blocks (sizes from headers,
        no inflation): returns (raw, sizes) or None at EOF."""
        start = self._next_read_off
        sizes: list[int] = []
        total = 0
        self._f.seek(start)
        while total < self._group_bytes:
            fixed = self._f.read(12)
            if not fixed:
                self._eof = True
                break
            if len(fixed) < 12:
                raise OSError("truncated bgzf header")
            xlen = int.from_bytes(fixed[10:12], "little")
            extra = self._f.read(xlen)
            bsize = _block_size_from_header(fixed + extra)
            if bsize is None:
                raise OSError(
                    "not a bgzf block at offset "
                    f"{self._next_read_off} (corrupt or plain gzip)"
                )
            skip = bsize - 12 - xlen
            if len(self._f.read(skip)) < skip:
                raise OSError("truncated bgzf block")
            sizes.append(bsize)
            total += bsize
            self._next_read_off += bsize
        if not sizes:
            return None
        self._f.seek(start)
        raw = self._f.read(total)
        return raw, sizes

    def _enqueue(self) -> None:
        while not self._eof and len(self._pending) < self._lookahead:
            group = self._read_group()
            if group is None:
                return
            raw, sizes = group
            self._pending.append(self._pool.submit(_inflate_group, raw, sizes))

    def _fill(self) -> bool:
        """Advance to the next non-empty group; False at EOF."""
        while True:
            self._enqueue()
            if not self._pending:
                return False
            out = self._pending.pop(0).result()
            if out:
                self._buf = out
                self._buf_pos = 0
                return True
            # all-empty group (EOF marker): keep draining

    # -- io.RawIOBase --------------------------------------------------
    def readable(self) -> bool:
        return True

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            chunks = []
            while True:
                c = self.read(1 << 20)
                if not c:
                    return b"".join(chunks)
                chunks.append(c)
        out = []
        need = n
        while need > 0:
            if self._buf_pos >= len(self._buf):
                if not self._fill():
                    break
            take = self._buf[self._buf_pos : self._buf_pos + need]
            self._buf_pos += len(take)
            need -= len(take)
            out.append(take)
        return b"".join(out)

    def readinto(self, b) -> int:
        # BufferedReader drives RawIOBase via readinto.
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def seek_decompressed(self, target: int) -> None:
        """Position the stream at DECOMPRESSED offset ``target`` in
        O(#blocks) metadata reads — no inflation.  Each block's
        uncompressed size (ISIZE) sits in its last 4 bytes and its
        compressed size in the BC header subfield, so the cumulative
        decompressed offset of every block boundary is computable from
        headers+trailers alone.  This is what makes checkpoint resume
        on bgzf inputs O(metadata) instead of a full re-inflation
        (plain gzip has no such framing and still re-parses)."""
        if target < 0:
            raise ValueError("negative seek target")
        for fut in self._pending:
            fut.cancel()
        self._pending.clear()
        self._buf = b""
        self._buf_pos = 0
        self._eof = False
        off = 0  # compressed position of the current block
        cum = 0  # decompressed position of the current block's start
        while True:
            self._f.seek(off)
            fixed = self._f.read(12)
            if not fixed:
                # target at/past EOF: subsequent reads return b""
                self._next_read_off = off
                self._eof = True
                return
            if len(fixed) < 12:
                raise OSError("truncated bgzf header")
            xlen = int.from_bytes(fixed[10:12], "little")
            extra = self._f.read(xlen)
            bsize = _block_size_from_header(fixed + extra)
            if bsize is None:
                raise OSError(f"not a bgzf block at offset {off}")
            self._f.seek(off + bsize - 4)
            isize = int.from_bytes(self._f.read(4), "little")
            if cum + isize > target:
                break
            cum += isize
            off += bsize
        self._next_read_off = off
        skip = target - cum
        if skip:
            if not self._fill():
                raise OSError("bgzf seek target past end of data")
            # the group read by _fill starts at this block, so the
            # in-group skip equals the in-block skip
            self._buf_pos = skip

    def close(self) -> None:
        if not self.closed:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._f.close()
        super().close()


def write_bgzf(path_or_file, data: bytes, block: int = 1 << 16) -> None:
    """Write ``data`` as spec-conforming BGZF (incl. the EOF block).

    ``block`` is the UNCOMPRESSED payload per member (bgzip caps the
    compressed member at 2**16, hence the conservative default minus
    slack below)."""
    block = min(block, (1 << 16) - 4096)  # keep compressed size < 2**16
    owns = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file, "wb") if owns else path_or_file
    try:
        for s in range(0, len(data), block):
            chunk = data[s : s + block]
            co = zlib.compressobj(6, zlib.DEFLATED, -15)
            payload = co.compress(chunk) + co.flush()
            bsize = 12 + 6 + len(payload) + 8  # hdr + extra + deflate + tail
            if bsize > 1 << 16:
                raise ValueError("bgzf block compressed past 64 KiB")
            f.write(b"\x1f\x8b\x08\x04" + b"\x00" * 6)  # hdr, FEXTRA
            f.write(struct.pack("<H", 6))  # XLEN
            f.write(b"BC" + struct.pack("<HH", 2, bsize - 1))
            f.write(payload)
            f.write(struct.pack("<II", zlib.crc32(chunk), len(chunk) & 0xFFFFFFFF))
        f.write(_EOF_BLOCK)
    finally:
        if owns:
            f.close()


def decompressed_size(path) -> int:
    """Total decompressed size of a bgzf file from block metadata alone
    (sum of ISIZE trailers; no inflation — O(#blocks) seeks).  Lets
    byte-range host sharding address bgzf inputs in decompressed
    coordinates.  Cached per
    (path, size, mtime): a ranged launch asks several times and the
    scan is seconds on a 100 GB file."""
    st = os.stat(path)
    return _decompressed_size_cached(
        str(path), st.st_size, st.st_mtime_ns
    )


@functools.lru_cache(maxsize=64)
def _decompressed_size_cached(path: str, _size: int, _mtime_ns: int) -> int:
    total = 0
    with open(path, "rb") as f:
        off = 0
        while True:
            f.seek(off)
            fixed = f.read(12)
            if not fixed:
                return total
            if len(fixed) < 12:
                raise OSError("truncated bgzf header")
            xlen = int.from_bytes(fixed[10:12], "little")
            extra = f.read(xlen)
            bsize = _block_size_from_header(fixed + extra)
            if bsize is None:
                raise OSError(f"not a bgzf block at offset {off}")
            f.seek(off + bsize - 4)
            total += int.from_bytes(f.read(4), "little")
            off += bsize


def open_maybe_bgzf(path):
    """Buffered BgzfReader for bgzf files (parallel inflate), gzip.open
    otherwise (single deflate stream — no parallelism possible)."""
    if is_bgzf(path):
        return io.BufferedReader(BgzfReader(path), buffer_size=1 << 20)
    import gzip

    return gzip.open(path, "rb")
