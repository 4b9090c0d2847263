"""Multi-process initialisation and host-sharded input planning.

The counterpart of ``cfrk_tpu/parallel/distributed.py`` over
``torch.distributed``.  The reference's multi-node story was "run a
separate process per FASTA shard" (reference ``swift/cfrk.swf:14-20``);
here, as in the JAX package, it is one process per host or card:

* :func:`maybe_initialize_distributed` starts a process group from the
  JAX package's coordinator variables, so one launch script drives
  either package (a no-op without them, or when a group exists), or,
  when asked to (``force``, the CLI's ``--distributed``) and they are
  absent, from an Open MPI or SLURM job's own variables, detected as
  ``jax.distributed.initialize()`` detects them (:func:`detect_cluster`);
* :func:`host_byte_range` splits ONE plain or BGZF FASTA into
  record-aligned byte ranges, one a process;
* :func:`host_shard` deals a file list across processes round-robin.

The planning functions are numpy-free host code over the port's own
``io/bgzf``; without a process group they plan for a world of one.
"""

from __future__ import annotations

import os
import re

__all__ = [
    "maybe_initialize_distributed",
    "detect_cluster",
    "local_process_id",
    "host_shard",
    "align_to_record",
    "host_byte_range",
]

_COORD_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
)
_TRIPLET = "JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID"
# The override of a detected job's coordinator port, JAX's name.
_PORT_VAR = "JAX_COORDINATOR_PORT"
# A job id's port: one of the 4096 ports [61440, 65535] (JAX's rule).
_PORT_SPAN = 2**12
_PORT_BASE = 65535 - _PORT_SPAN + 1


class _Cluster:
    """A launcher's variables: ``COUNT``, ``ID`` and ``LOCAL_ID`` name
    the process count, this process's rank and its index on its host."""

    COUNT = ID = LOCAL_ID = ""

    @classmethod
    def process_count(cls) -> int:
        return int(os.environ[cls.COUNT])

    @classmethod
    def process_id(cls) -> int:
        return int(os.environ[cls.ID])

    @classmethod
    def local_process_id(cls) -> int:
        return int(os.environ[cls.LOCAL_ID])


class OmpiCluster(_Cluster):
    """A process started by Open MPI's ``mpirun`` / ``mpiexec``: the
    copy of ``jax._src.clusters.ompi_cluster.OmpiCluster``."""

    URI = "OMPI_MCA_orte_hnp_uri"  # set only under mpirun / mpiexec
    COUNT, ID, LOCAL_ID = ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
                           "OMPI_COMM_WORLD_LOCAL_RANK")

    @classmethod
    def is_env_present(cls) -> bool:
        return cls.URI in os.environ

    @classmethod
    def coordinator_address(cls, port: str | None = None) -> str:
        """``launcher_ip:port`` from the ORTE URI, e.g.
        ``1531576320.0;tcp://10.96.0.1,10.148.0.1:34911`` or
        ``1314521088.0;tcp6://[fe80::b9b,2620:10d::2]:43370``: the first
        address; the port from the job id (a multiple of 2**12, divided
        by it first), unless ``port`` is given."""
        uri = os.environ[cls.URI]
        if not port:
            job_id = int(uri.split(".", maxsplit=1)[0]) // _PORT_SPAN
            port = str(job_id % _PORT_SPAN + _PORT_BASE)
        match = re.search(r"tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]", uri)
        if match is None:
            raise RuntimeError("Could not parse coordinator IP address from Open MPI "
                               "environment.")
        ip = next(g for g in match.groups() if g is not None)
        return f"{ip}:{port}"


class SlurmCluster(_Cluster):
    """A task of a SLURM job step (``srun``): the copy of
    ``jax._src.clusters.slurm_cluster.SlurmCluster``."""

    COUNT, ID, LOCAL_ID = "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID"

    @classmethod
    def is_env_present(cls) -> bool:
        return all(var in os.environ for var in (
            "SLURM_JOB_ID", "SLURM_STEP_NODELIST", cls.COUNT, cls.ID, cls.LOCAL_ID))

    @classmethod
    def coordinator_address(cls, port: str | None = None) -> str:
        """``first_host:port``: the first host of the step's node list
        (``node001``, ``node001,host2``, ``node[001-0015],host2`` and
        ``node[001,007-015],host2`` all give ``node001``); the port from
        the job id, unless ``port`` is given."""
        if not port:
            port = str(int(os.environ["SLURM_JOB_ID"]) % _PORT_SPAN + _PORT_BASE)
        nodes = os.environ["SLURM_STEP_NODELIST"]
        cut = next((i for i, ch in enumerate(nodes) if ch in ",["), len(nodes))
        if cut == len(nodes) or nodes[cut] == ",":
            return f"{nodes[:cut]}:{port}"
        prefix, suffix = nodes[:cut], nodes[cut + 1:]
        end = next((i for i, ch in enumerate(suffix) if ch in ",-"), None)
        return f"{prefix}{suffix[:end]}:{port}"


# JAX's order of detection (jax/_src/clusters/__init__.py): Open MPI
# first.  Its TPU metadata clusters, its Kubernetes cluster (it needs the
# kubernetes package) and its opt-in mpi4py cluster are not carried.
CLUSTERS = (OmpiCluster, SlurmCluster)


def detect_cluster():
    """The first cluster of :data:`CLUSTERS` whose variables are set, or
    None."""
    return next((c for c in CLUSTERS if c.is_env_present()), None)


def local_process_id() -> int | None:
    """This process's index among the processes of its host, where a
    detected cluster gives it: it picks the process's card, as JAX's
    ``local_device_ids = [local_process_id]`` does.  None without a
    cluster (every card stays visible)."""
    cluster = detect_cluster()
    return cluster.local_process_id() if cluster else None


def maybe_initialize_distributed(force: bool = False) -> bool:
    """Start the ``torch.distributed`` process group when a coordinator
    is configured; returns True if this call started it.

    Reads the JAX package's triplet: ``JAX_COORDINATOR_ADDRESS`` (or
    ``COORDINATOR_ADDRESS``, ``host:port``), ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``.  Without a coordinator and without ``force`` it
    is a no-op, so single-process runs need no changes; a group that
    already exists is left as it is (False).  What the triplet leaves
    unset comes, as ``jax.distributed.initialize()`` finds it, from an
    Open MPI or SLURM job (:func:`detect_cluster`; the coordinator's port
    from the job id unless ``JAX_COORDINATOR_PORT`` gives it).  A partial
    triplet that no cluster completes, or ``force`` with neither a
    coordinator nor a cluster, raises ValueError: there is no silent
    world of one.

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
    cluster = detect_cluster()
    if addr and (nproc is None or pid is None) and (
            nproc is not None or pid is not None or cluster is None):
        missing = [name for name, val in (("JAX_NUM_PROCESSES", nproc),
                                          ("JAX_PROCESS_ID", pid)) if val is None]
        raise ValueError(
            f"{_COORD_VARS[0]} is set but {' and '.join(missing)} "
            f"is missing — a manual multi-process launch needs all of {_TRIPLET}"
        )
    if dist.is_initialized():
        return False
    if not addr and cluster is None:
        raise ValueError(
            f"no coordinator is defined: a multi-process launch sets {_TRIPLET} "
            "(COORDINATOR_ADDRESS may stand for the first) in every process, "
            "or runs as a SLURM job step (srun: SLURM_JOB_ID, SLURM_STEP_NODELIST, "
            "SLURM_NTASKS, SLURM_PROCID, SLURM_LOCALID) or under Open MPI's "
            "mpirun (OMPI_MCA_orte_hnp_uri, OMPI_COMM_WORLD_SIZE, "
            "OMPI_COMM_WORLD_RANK, OMPI_COMM_WORLD_LOCAL_RANK)"
        )
    if not addr:
        addr = cluster.coordinator_address(os.environ.get(_PORT_VAR))
    if pid is not None:
        world, rank, names = int(nproc), int(pid), ("JAX_PROCESS_ID", "JAX_NUM_PROCESSES")
    else:
        world, rank = cluster.process_count(), cluster.process_id()
        names = (cluster.ID, cluster.COUNT)
    if not 0 <= rank < world:
        raise ValueError(f"{names[0]}={rank} is not in [0, {names[1]}={world})")
    dist.init_process_group("gloo", init_method=f"tcp://{_bracketed(addr)}", rank=rank,
                            world_size=world)
    return True


def _bracketed(addr: str) -> str:
    """``host:port`` for a URL: an IPv6 host (from a ``tcp6://`` ORTE
    URI) goes in brackets."""
    host, _, port = addr.rpartition(":")
    return f"[{host}]:{port}" if ":" in host and not host.startswith("[") else addr


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
