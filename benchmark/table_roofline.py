"""The yardstick of a dense table's roofline share.

One call adds a ``[batch, read_len]`` int8 batch's window counts into a
``[4**k]`` int32 table held in device memory.  No design that keeps the
table there can move fewer bytes than these: the codes read once, and
each distinct 32-byte sector of the table that the call's keys touch
read once and written once (64 bytes a sector, the unit in which the L2
and HBM move data).  The sectors come from the call's own keys (the
plain reference's), so the bound is the work alone, whatever implements
it.  The rate is ``roofline.HBM_BW``.
"""

from __future__ import annotations

import torch

from benchmark.roofline import bound

SECTOR_BYTES = 32
BIN_BYTES = 4  # int32


def sectors(keys: torch.Tensor) -> int:
    """Distinct 32-byte sectors of an int32 table that the keys touch."""
    return int(torch.unique(keys // (SECTOR_BYTES // BIN_BYTES)).numel())


def table_bound(batch: int, read_len: int, n_sectors: int) -> tuple:
    """(ms, "bytes"): one call's least time, from the codes' bytes and
    ``n_sectors`` sectors each read and written once."""
    return bound(batch * read_len + 2 * SECTOR_BYTES * n_sectors, 0)
