"""The yardstick of the dense per-read histogram's roofline share.

One call turns a ``[batch, read_len]`` int8 batch into every read's
``[4**k]`` int32 counts, zeros included, written to device memory.  No
design that writes that matrix can move fewer bytes than these: the
codes read once and the ``[batch, 4**k]`` int32 matrix written once.
The bound is the work alone, whatever implements it, at
``roofline.HBM_BW``.
"""

from __future__ import annotations

from benchmark.roofline import bound

COUNT_BYTES = 4  # int32


def dense_bytes(batch: int, read_len: int, k: int) -> int:
    """The codes' bytes and the matrix's."""
    return batch * read_len + batch * 4**k * COUNT_BYTES


def dense_bound(batch: int, read_len: int, k: int) -> tuple:
    """(ms, "bytes"): one call's least time."""
    return bound(dense_bytes(batch, read_len, k), 0)
