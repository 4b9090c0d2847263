"""Sequence parallelism over very long reads (contigs).

The counterpart of ``cfrk_tpu/parallel/seqpar.py``: the POSITION axis of
a batch is cut over a 1-D ``sp`` mesh; each device holds a contiguous
slice of every read, counts the windows that start inside its slice, and
the per-read histograms (or the spectrum tables) are summed (``psum``).

A window that straddles a slice boundary needs the first ``k-1`` codes
of the right neighbour's slice: a halo exchange, one ``ppermute`` along
the ring (``parallel/mesh.py``).  The last device's halo is ``-1``
padding, which makes the windows that would run off the end of the read
invalid, as on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.perread import count_perread
from ..ops.perread_sparse import count_perread_rows
from ..ops.spectrum import spectrum
from .mesh import Mesh, Sharding, local_devices, ppermute, psum

__all__ = [
    "make_seq_mesh",
    "SP_AXIS",
    "count_perread_seqpar",
    "spectrum_seqpar",
    "spectrum_seqpar_triples",
]

SP_AXIS = "sp"


def make_seq_mesh(devices=None) -> Mesh:
    """1-D mesh over the sequence (position) axis (default: every CUDA
    device of this process)."""
    if devices is None:
        devices = local_devices(torch.device("cuda"))
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr, (SP_AXIS,))


def _check_slice_width(codes, k: int, mesh: Mesh) -> None:
    """The one-hop halo takes k-1 columns from the right neighbour only:
    a slice narrower than k-1 would silently drop windows that span two
    slice boundaries, so it is refused."""
    n = mesh.shape[SP_AXIS]
    length = codes.shape[-1]
    if length % n:
        raise ValueError(f"position axis {length} not divisible by sp={n}")
    if n > 1 and length // n < k - 1:
        raise ValueError(
            f"per-device slice {length // n} < k-1={k - 1}: windows would "
            f"span >2 slices; use fewer devices or longer reads"
        )


def _slices(codes, k: int, mesh: Mesh) -> list:
    """Each device's slice of the positions, extended by the right
    neighbour's first k-1 columns (``-1`` on the last slice)."""
    blocks = Sharding(mesh, (SP_AXIS,), dim=1).split(codes)
    if k <= 1:
        return blocks
    n = mesh.size
    # Each device sends its leading columns to its LEFT neighbour.
    halos = ppermute([b[:, : k - 1] for b in blocks], mesh, SP_AXIS,
                     [(j, (j - 1) % n) for j in range(n)])
    halos[-1] = torch.full_like(halos[-1], -1)
    return [torch.cat([b, h], dim=-1) for b, h in zip(blocks, halos)]


def count_perread_seqpar(codes, k: int, mesh: Mesh, *, canonical: bool = False,
                         impl: str = "auto"):
    """Per-read counts with the position axis sharded over ``sp``.

    codes: ``[B, L]`` int8, L divisible by the sp size.  Returns ``[B,
    4**k]`` int32 on the mesh's first device.  ``impl='host'`` runs as
    ``'scatter'``, as under the JAX package's trace."""
    if k < 1:
        raise ValueError("k must be >= 1")
    _check_slice_width(codes, k, mesh)
    if impl == "host":
        impl = "scatter"
    parts = [count_perread(ext, k, canonical=canonical, impl=impl)
             for ext in _slices(codes, k, mesh)]
    return psum(parts, mesh, SP_AXIS)[0]


def spectrum_seqpar(codes, k: int, mesh: Mesh, *, canonical: bool = False,
                    impl: str = "auto"):
    """Global ``[4**k]`` int32 spectrum with the position axis sharded
    over ``sp``."""
    _check_slice_width(codes, k, mesh)
    parts = [spectrum(ext, k, canonical=canonical, impl=impl)
             for ext in _slices(codes, k, mesh)]
    return psum(parts, mesh, SP_AXIS)[0]


def spectrum_seqpar_triples(codes, k: int, mesh: Mesh, *, canonical: bool = False):
    """Sorted-route spectrum with the position axis sharded over ``sp``:
    each device sorts and run-length encodes its own slice's windows
    (``count_perread_rows``, the row-sort kernels on a GPU), with no
    merge between devices.  Returns the per-read rows layout ((idx,
    counts) for k <= 15, (hi, lo, counts) above), ``[B, n_slices *
    W_slice]`` with the slices' windows side by side, on the mesh's
    first device; the host accumulators (``rows_to_triples``) merge
    duplicate keys across slices as across batches."""
    _check_slice_width(codes, k, mesh)
    parts = [count_perread_rows(ext, k, canonical) for ext in _slices(codes, k, mesh)]
    cols = Sharding(mesh, (SP_AXIS,), dim=1)
    return tuple(cols.unsplit([p[i] for p in parts]) for i in range(len(parts[0])))
