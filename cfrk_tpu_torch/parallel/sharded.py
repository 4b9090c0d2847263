"""Sharded counting over a (dp, tp) mesh.

The counterpart of ``cfrk_tpu/parallel/sharded.py``, where each function
is a ``shard_map`` of the single-device op.  Here the batch's row blocks
are copied to their devices (:func:`shard_batch`), the op runs on each
block on its device, and the per-device results are brought together:

* ``count_perread_sharded`` / ``_packed`` / ``count_perread_sparse_sharded``:
  per-read rows, no collective; the row blocks are concatenated back in
  mesh order on the mesh's first device;
* ``spectrum_sharded``: each device counts a full local table from its
  rows; the tables are summed over ``dp`` and, with tp > 1,
  reduce-scattered over ``tp`` (each device sums ``4**k / tp`` bins);
  the bin blocks are then put together in bin order on the first device.

Every function takes the ``[B, L]`` batch as numpy, as a tensor on any
device, or as the per-device blocks that :func:`shard_batch` returns.
Tensors come back on the mesh's first device, as the global arrays of
the JAX functions (``np.asarray`` of one is the host copy).
"""

from __future__ import annotations

from ..ops.cuda.perread import DEFAULT_READ_BLOCK, perread_hist
from ..ops.perread import count_perread
from ..ops.perread_sparse import count_perread_rows
from ..ops.spectrum import spectrum
from .mesh import (
    DP_AXIS,
    TP_AXIS,
    Mesh,
    batch_sharding,
    psum,
    psum_scatter,
    table_sharding,
)

__all__ = [
    "count_perread_sharded",
    "count_perread_sharded_packed",
    "count_perread_sparse_sharded",
    "spectrum_sharded",
    "shard_batch",
]


def shard_batch(codes, mesh: Mesh) -> list:
    """A ``[B, L]`` batch → its row blocks, each on its device (block
    ``i * tp + j`` on ``devices[i, j]``).  B must be divisible by the
    mesh size (pad with -1 rows upstream: padding rows count nothing and
    callers slice them off)."""
    return batch_sharding(mesh).split(codes)


def _blocks(codes, mesh: Mesh) -> list:
    if isinstance(codes, (list, tuple)):
        if len(codes) != mesh.size:
            raise ValueError(f"{len(codes)} blocks for a mesh of {mesh.size}")
        return list(codes)
    return shard_batch(codes, mesh)


def count_perread_sharded(codes, k: int, mesh: Mesh, *, canonical: bool = False,
                          impl: str = "auto"):
    """Per-read dense counts with rows sharded over the mesh: ``[B,
    4**k]`` int32.  Data-parallel per-read counting needs no collective.
    ``impl='host'`` runs as ``'scatter'`` on each block, as it does under
    the JAX package's ``shard_map`` trace (the same counts)."""
    if impl == "host":
        impl = "scatter"
    parts = [count_perread(blk, k, canonical=canonical, impl=impl)
             for blk in _blocks(codes, mesh)]
    return batch_sharding(mesh).unsplit(parts)


def count_perread_sharded_packed(codes, k: int, mesh: Mesh, *,
                                 canonical: bool = False, packed: str = "b4",
                                 read_block: int | None = None):
    """Per-read counts, rows over the mesh, in the per-read histogram
    kernel's packed emit (``"b4"``: one byte a bin, ``"fh"``: two):
    each device writes its row block packed, and the blocks are
    concatenated (unpack on the host with ``unpack_counts``).  A device's
    row count must be a multiple of ``read_block``: a local pad would
    change the concatenated row count, so it is refused, not padded."""
    if read_block is None:
        read_block = DEFAULT_READ_BLOCK
    b = codes[0].shape[0] * mesh.size if isinstance(codes, (list, tuple)) else (
        codes.shape[0])
    ndev = mesh.size
    if b % ndev or (b // ndev) % read_block:
        raise ValueError(
            f"packed sharded rows/device must be a multiple of "
            f"read_block={read_block}: got {b} rows on {ndev} devices"
        )
    parts = [perread_hist(blk, k, canonical, packed=packed, read_block=read_block)
             for blk in _blocks(codes, mesh)]
    return batch_sharding(mesh).unsplit(parts)


def count_perread_sparse_sharded(codes, k: int, mesh: Mesh, *,
                                 canonical: bool = False):
    """Per-read SPARSE rows with rows sharded over the mesh: the layout
    of ``ops.perread_sparse.count_perread_rows`` ((idx, counts) for
    k <= 15, (hi, lo, counts) above, each ``[B, W]``).  No collective:
    each device sorts its own rows."""
    parts = [count_perread_rows(blk, k, canonical) for blk in _blocks(codes, mesh)]
    rows = batch_sharding(mesh)
    return tuple(rows.unsplit([p[i] for p in parts]) for i in range(len(parts[0])))


def spectrum_sharded(codes, k: int, mesh: Mesh, *, canonical: bool = False,
                     impl: str = "auto"):
    """Global ``[4**k]`` int32 spectrum of a batch on a (dp, tp) mesh:
    local tables summed over dp and, with tp > 1, reduce-scattered over
    tp (the sum of bin block j on the devices of tp column j), then put
    together in bin order."""
    tp = mesh.shape[TP_AXIS]
    if 4**k % tp:
        raise ValueError(f"4**{k} bins not divisible by tp={tp}")
    tables = [spectrum(blk, k, canonical=canonical, impl=impl)
              for blk in _blocks(codes, mesh)]
    if tp > 1:
        tables = psum_scatter(psum(tables, mesh, DP_AXIS), mesh, TP_AXIS)
        return table_sharding(mesh).unsplit(tables)
    return psum(tables, mesh, (DP_AXIS, TP_AXIS))[0]
