"""Device meshes for multi-device runs, and their collectives.

The counterpart of ``cfrk_tpu/parallel/mesh.py``.  There a mesh is a
``jax.sharding.Mesh`` and one process drives every local device with
``shard_map`` (single-controller SPMD); here it is the same: one process
drives a list of ``torch.device`` objects.  No ``torch.distributed`` and
no NCCL take part: a device-local step is an ordinary call of the port's
ops on the block that lives on that device (on a CUDA device it launches
the CUDA kernels, on the CPU it runs the plain twins), and a collective
is a plain sequence of tensor copies between devices and sums, maxima or
concatenations on one of them.

Axes:

* ``dp``: data parallel over reads.  Per-read counting needs no
  communication on this axis.
* ``tp``: table parallel over the ``4**k`` spectrum bins.  Global spectra
  are summed over ``dp`` and reduce-scattered over ``tp``, so that each
  device sums ``4**k / tp`` bins.

Sequence parallelism over very long reads uses its own 1-D mesh
(``seqpar.py``).

Per-device values are lists with one entry a device, in the row-major
order of ``Mesh.devices`` (the order of ``Mesh.devices.flat``).  A
device may appear more than once in a mesh: a mesh of one card repeated
runs every mesh path on a machine with one card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "Mesh",
    "DP_AXIS",
    "TP_AXIS",
    "make_mesh",
    "local_devices",
    "repeat_devices",
    "Sharding",
    "batch_sharding",
    "table_sharding",
    "psum",
    "psum_scatter",
    "all_to_all",
    "pmax",
    "ppermute",
]

DP_AXIS = "dp"
TP_AXIS = "tp"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The stand-in for ``jax.sharding.Mesh``: ``devices`` is a numpy
    object array of ``torch.device``, one axis for each name of
    ``axis_names``."""

    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{self.devices.ndim}-d devices for axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def flat(self) -> list:
        """The devices in row-major order: where entry i of a
        per-device list lives."""
        return list(self.devices.flat)

    @property
    def home(self) -> torch.device:
        """The first device: where a function of the mesh assembles the
        global array it returns."""
        return self.devices.flat[0]


# The counterpart of XLA's --xla_force_host_platform_device_count: when
# set, ``local_devices(device)`` is ``device`` this many times.  Only the
# tools and the tests set it, each for its own process; the CLI never does.
_REPEAT: int | None = None


def repeat_devices(n: int | None) -> int | None:
    """Make :func:`local_devices` return its device ``n`` times, so that
    one card (or the CPU) stands for ``n`` devices, for the rest of this
    process (``None``: every distinct device again).  Returns the
    setting it replaced."""
    global _REPEAT
    if n is not None and n < 1:
        raise ValueError(f"a device repeated {n} times")
    prev, _REPEAT = _REPEAT, n
    return prev


def local_devices(device) -> list:
    """Every device of this process of ``device``'s type: the CUDA
    devices for a CUDA device (``jax.local_devices()``), the one CPU for
    the CPU; or, under :func:`repeat_devices`, ``device`` itself
    repeated (a bare ``cuda`` names the current card)."""
    device = torch.device(device)
    if _REPEAT is not None:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return [device] * _REPEAT
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device.type)]


def make_mesh(devices=None, *, tp: int = 1) -> Mesh:
    """Build a (dp, tp) mesh over the given devices (default: every CUDA
    device of this process).  dp = n_devices // tp; tp = 1 is pure data
    parallelism."""
    if devices is None:
        devices = local_devices(torch.device("cuda"))
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // tp, tp), (DP_AXIS, TP_AXIS))


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """The split rule of ``NamedSharding(mesh, P(...))`` for one sharded
    dimension: dimension ``dim`` of a global array is cut into as many
    equal blocks as the mesh axes ``axes`` hold devices together, and
    the device at mesh coordinates c holds the block whose index is c
    along ``axes`` (row-major), replicated over the other axes."""

    mesh: Mesh
    axes: tuple
    dim: int = 0

    @property
    def n_blocks(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.axes)

    def block_of(self) -> list:
        """The block index that each device (in mesh order) holds."""
        names = self.mesh.axis_names
        sizes = self.mesh.devices.shape
        out = []
        for coords in np.ndindex(*sizes):
            sel = [coords[names.index(a)] for a in self.axes]
            out.append(int(np.ravel_multi_index(
                sel, [sizes[names.index(a)] for a in self.axes])) if sel else 0)
        return out

    def split(self, x) -> list:
        """A global array (numpy or a tensor on any device) → the block
        each device holds, copied to it.  Host blocks go to a CUDA device
        from pinned memory, without blocking the host."""
        x = torch.as_tensor(x)
        size = x.shape[self.dim]
        if size % self.n_blocks:
            raise ValueError(
                f"dimension {self.dim} of size {size} is not divisible by the "
                f"{self.n_blocks} blocks of mesh axes {self.axes}")
        devs = self.mesh.flat
        if x.device.type == "cpu" and any(d.type == "cuda" for d in devs):
            x = x.contiguous().pin_memory()
        blocks = torch.chunk(x, self.n_blocks, dim=self.dim) if size else (
            [x] * self.n_blocks)
        return [blocks[b].contiguous().to(d, non_blocking=True)
                for b, d in zip(self.block_of(), devs)]

    def unsplit(self, parts: list) -> torch.Tensor:
        """Per-device blocks → the global array on the mesh's first
        device: each block taken from the first device that holds it,
        concatenated in block order along ``dim``."""
        first = {}
        for b, part in zip(self.block_of(), parts):
            first.setdefault(b, part)
        home = self.mesh.home
        return torch.cat([first[b].to(home) for b in range(self.n_blocks)],
                         dim=self.dim)


def batch_sharding(mesh: Mesh) -> Sharding:
    """A ``[B, L]`` code batch: rows over both mesh axes, so every
    device, the tp columns included, takes a distinct row block (block
    ``i * tp + j`` on ``devices[i, j]``).  B must be divisible by
    dp * tp."""
    return Sharding(mesh, tuple(mesh.axis_names))


def table_sharding(mesh: Mesh) -> Sharding:
    """A ``[4**k]`` spectrum table: bins over tp, replicated over dp."""
    return Sharding(mesh, (TP_AXIS,))


# ---------------------------------------------------------------- collectives


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _groups(mesh: Mesh, axes) -> list:
    """Lists of mesh positions that differ only along ``axes``: the
    participants of one collective, each list ordered by the position
    along ``axes`` (row-major)."""
    axes = _axes(axes)
    names = mesh.axis_names
    idx = np.arange(mesh.size).reshape(mesh.devices.shape)
    moved = np.moveaxis(idx, [names.index(a) for a in axes],
                        list(range(len(names) - len(axes), len(names))))
    n = math.prod(mesh.shape[a] for a in axes)
    return [list(g) for g in moved.reshape(-1, n)]


def _reduce(parts: list, op) -> torch.Tensor:
    acc = parts[0].clone()
    for p in parts[1:]:
        acc = op(acc, p.to(acc.device))
    return acc


def psum(parts: list, mesh: Mesh, axes) -> list:
    """``jax.lax.psum``: each device gets the sum of the values over its
    group along ``axes``."""
    out = [None] * mesh.size
    devs = mesh.flat
    for g in _groups(mesh, axes):
        total = _reduce([parts[i] for i in g], torch.add)
        for i in g:
            out[i] = total.to(devs[i])
    return out


def pmax(parts: list, mesh: Mesh, axes) -> list:
    """``jax.lax.pmax``: the elementwise maximum over each group."""
    out = [None] * mesh.size
    devs = mesh.flat
    for g in _groups(mesh, axes):
        top = _reduce([parts[i] for i in g], torch.maximum)
        for i in g:
            out[i] = top.to(devs[i])
    return out


def psum_scatter(parts: list, mesh: Mesh, axis: str) -> list:
    """``jax.lax.psum_scatter(..., scatter_dimension=0, tiled=True)``:
    the group's sum cut into as many blocks of dimension 0 as the group
    has devices; the r-th device along ``axis`` keeps block r."""
    out = [None] * mesh.size
    devs = mesh.flat
    for g in _groups(mesh, axis):
        total = _reduce([parts[i] for i in g], torch.add)
        if total.shape[0] % len(g):
            raise ValueError(
                f"dimension 0 of size {total.shape[0]} is not divisible by "
                f"{axis}={len(g)}")
        for r, blk in enumerate(torch.chunk(total, len(g))):
            out[g[r]] = blk.to(devs[g[r]])
    return out


def all_to_all(parts: list, mesh: Mesh, axis: str) -> list:
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``: each device
    cuts its value into as many blocks of dimension 0 as the group has
    devices; the r-th device receives block r of every device of its
    group, concatenated in the group's order."""
    out = [None] * mesh.size
    devs = mesh.flat
    for g in _groups(mesh, axis):
        cut = [torch.chunk(parts[i], len(g)) for i in g]
        for r, i in enumerate(g):
            out[i] = torch.cat([c[r].to(devs[i]) for c in cut])
    return out


def ppermute(parts: list, mesh: Mesh, axis: str, perm) -> list:
    """``jax.lax.ppermute``: for each (src, dst) pair of positions along
    ``axis``, the device at dst receives the value of the device at src;
    a device that receives nothing gets zeros."""
    out = [None] * mesh.size
    devs = mesh.flat
    for g in _groups(mesh, axis):
        for src, dst in perm:
            out[g[dst]] = parts[g[src]].to(devs[g[dst]])
        for i in g:
            if out[i] is None:
                out[i] = torch.zeros_like(parts[i])
    return out
