"""Multi-process initialisation and host-sharded input planning.

The counterpart of ``cfrk_tpu/parallel/distributed.py`` over
``torch.distributed``.  The reference's multi-node story was "run a
separate process per FASTA shard" (reference ``swift/cfrk.swf:14-20``);
here, as in the JAX package, it is one process per host or card:

* :func:`maybe_initialize_distributed` starts a process group from the
  JAX package's coordinator variables, so one launch script drives
  either package (a no-op without them, or when a group exists);
* :func:`host_byte_range` splits ONE plain or BGZF FASTA into
  record-aligned byte ranges, one a process;
* :func:`host_shard` deals a file list across processes round-robin.

The planning functions are numpy-free host code over the port's own
``io/bgzf``; without a process group they plan for a world of one.
"""

from __future__ import annotations

import os

__all__ = [
    "maybe_initialize_distributed",
    "host_shard",
    "align_to_record",
    "host_byte_range",
]

_COORD_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
)
_TRIPLET = "JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID"


def maybe_initialize_distributed(force: bool = False) -> bool:
    """Start the ``torch.distributed`` process group when a coordinator
    is configured; returns True if this call started it.

    Reads the JAX package's triplet: ``JAX_COORDINATOR_ADDRESS`` (or
    ``COORDINATOR_ADDRESS``, ``host:port``), ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``.  Without a coordinator and without ``force`` it
    is a no-op, so single-process runs need no changes; a group that
    already exists is left as it is (False).  A partial triplet, or
    ``force`` with no coordinator at all, raises ValueError: there is
    no silent world of one and no cluster auto-detection.

    The backend is gloo on every machine: the only collective is a
    barrier, which carries no tensor, and NCCL refuses two ranks on one
    GPU, which is how a one-card machine runs several processes.
    """
    import torch.distributed as dist

    addr = next((os.environ[v] for v in _COORD_VARS if os.environ.get(v)), None)
    if not force and not addr:
        return False
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    if addr and (nproc is None or pid is None):
        missing = [name for name, val in (("JAX_NUM_PROCESSES", nproc),
                                          ("JAX_PROCESS_ID", pid)) if val is None]
        raise ValueError(
            f"{_COORD_VARS[0]} is set but {' and '.join(missing)} "
            f"is missing — a manual multi-process launch needs all of {_TRIPLET}"
        )
    if dist.is_initialized():
        return False
    if not addr:
        raise ValueError(
            f"no coordinator is defined: a multi-process launch sets {_TRIPLET} "
            "(COORDINATOR_ADDRESS may stand for the first) in every process"
        )
    world, rank = int(nproc), int(pid)
    if not 0 <= rank < world:
        raise ValueError(f"JAX_PROCESS_ID={rank} is not in [0, JAX_NUM_PROCESSES={world})")
    dist.init_process_group("gloo", init_method=f"tcp://{addr}", rank=rank,
                            world_size=world)
    return True


def _process_index_count(process_index, process_count) -> tuple[int, int]:
    """The explicit (index, count), else the process group's rank and
    world size, else 0 and 1."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if grouped else 0
    if process_count is None:
        process_count = dist.get_world_size() if grouped else 1
    return process_index, process_count


def _input_geometry(path):
    """(total_size, open_at(offset) -> readable) in the coordinate
    system byte ranges use: raw file bytes for plain inputs,
    DECOMPRESSED positions for bgzf (block metadata makes them
    seekable; see io/bgzf.py).  Plain gzip has no random access and is
    rejected by the callers' rangeable checks."""
    from ..io.bgzf import decompressed_size, is_bgzf, open_maybe_bgzf

    if is_bgzf(path):
        size = decompressed_size(path)

        def open_at(offset: int):
            f = open_maybe_bgzf(path)
            f.raw.seek_decompressed(offset)
            return f

        return size, open_at

    def open_at_plain(offset: int):
        f = open(path, "rb")
        f.seek(offset)
        return f

    return os.path.getsize(path), open_at_plain


def align_to_record(path, target: int) -> int:
    """Smallest FASTA record-start offset >= target (plain or bgzf
    files; offsets are decompressed positions for bgzf).

    A record starts at a '>' that begins a line, i.e. at position 0 or
    just after a newline; scanning for b"\\n>" from target-1 finds it.
    Used to split ONE large file into per-process byte ranges that
    cover every record exactly once: process i streams records whose
    start lies in [align(size*i/n), size*(i+1)/n) — no record can start
    between a raw cut and its aligned position, so abutting raw cuts
    partition the record set exactly.
    """
    if target <= 0:
        return 0
    size, open_at = _input_geometry(path)
    if target >= size:
        return size
    pos = target - 1  # include a preceding '\n' at target-1
    with open_at(pos) as f:
        prev = b""
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return size
            buf = prev + chunk
            i = buf.find(b"\n>")
            if i >= 0:
                return pos - len(prev) + i + 1
            pos += len(chunk)
            prev = buf[-1:]


def host_byte_range(
    path, process_index: int | None = None, process_count: int | None = None
) -> tuple[int, int]:
    """This process's (start, limit) byte range of a single shared FASTA.

    ``start`` is record-aligned; ``limit`` is the raw cut — consumers
    stop before the first record STARTING at or past it (the next
    process's aligned start), so ranges partition the records exactly.
    The index and count default to the process group's rank and world
    size (0 and 1 without a group).
    """
    pi, pc = _process_index_count(process_index, process_count)
    size, _ = _input_geometry(path)
    start = align_to_record(path, size * pi // pc)
    limit = size * (pi + 1) // pc if pi + 1 < pc else size
    return start, limit


def host_shard(paths: list, process_index: int | None = None,
               process_count: int | None = None) -> list:
    """The subset of ``paths`` this process owns (round-robin deal).

    Per-read counting needs no data exchange between processes, so each
    streams only its own files — the multi-process analog of the
    reference's one-process-per-shard layout.
    """
    pi, pc = _process_index_count(process_index, process_count)
    return [p for i, p in enumerate(paths) if i % pc == pi]
