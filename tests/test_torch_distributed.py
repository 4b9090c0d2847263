"""``--distributed`` with one input (``cfrk_tpu_torch/parallel`` and the
CLI's byte-ranged run) against cfrk_tpu.

The planning functions are held to ``cfrk_tpu.parallel.distributed``
with an explicit process index and count (no ``jax.distributed``);
``maybe_initialize_distributed`` to its no-op, its partial-triplet
message and its refusals.  The byte-ranged run goes through 2 and 3
real processes (gloo, one temporary directory) and each spliced or
merged output is held to the bytes of ``cfrk_tpu``'s CLI on the same
file: never to the port's own single-process run.  Tolerance: exact
equality of bytes and offsets.

Every process test starts its ranks through ``_launch``: each rank in a
session of its own (a signal to its process group cannot reach pytest),
with stdin from ``/dev/null`` and one torch thread, and the whole session
killed when the launch ends.  A process test fails, never skips, when a
rank dies or a launch outlives its timeout, with a report that says
which of the two it was: the wall time and attempt, each rank's return
code (a signal by name), peak RSS and stderr tail, and the host's load
and available memory at that moment.  The coordinator ports lie
below the kernel's ephemeral port range, in a slice of their own for
each pytest-xdist worker (``_held_ports``): no other worker, and no
socket bound to port 0 (gloo's pair sockets, the other files' groups),
can draw one of them.  Each port is held by a bound socket for as long
as its launch runs, so that another test run on the same host, whose
workers have the same slices, cannot pick it and join its ranks to ours.
A launch is made again on fresh ports, up to ``_ATTEMPTS`` times in all,
only when a rank's stderr says that its address was in use.
"""

import contextlib
import gzip
import itertools
import json
import os
import random
import re
import resource
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest

from cfrk_tpu.cli import main as jax_main
from cfrk_tpu.parallel import distributed as jdist
from cfrk_tpu_torch.cli import _splice_perread_parts, main
from cfrk_tpu_torch.io.bgzf import write_bgzf
from cfrk_tpu_torch.io.fasta import decode_codes
from cfrk_tpu_torch.parallel import distributed as tdist

ROOT = Path(__file__).resolve().parent.parent
_TRIPLET = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
            "JAX_PROCESS_ID")
LAUNCH_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _clean_env(tmp_path, monkeypatch):
    """An empty working directory (no ``cfrk.json``), and no coordinator
    variables and no SLURM or Open MPI job from around the test run (a
    runner inside a SLURM job stays steady)."""
    monkeypatch.chdir(tmp_path)
    for name in (*_TRIPLET, "JAX_COORDINATOR_PORT"):
        monkeypatch.delenv(name, raising=False)
    for name in list(os.environ):
        if name.startswith(("SLURM_", "OMPI_")):
            monkeypatch.delenv(name)


def _fasta_blob(seed: int, n: int) -> bytes:
    """Seeded FASTA: reads of 0-90 bases with N and lower-case bases,
    long headers, records wrapped at 37 columns, blank lines."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        codes = rng.integers(0, 4, size=int(rng.integers(0, 91))).astype(np.int8)
        codes[rng.random(codes.size) < 0.03] = -1
        seq = decode_codes(codes)
        if i % 7 == 3:
            seq = seq.lower()
        lines = [seq[j : j + 37] for j in range(0, len(seq), 37)]
        out.append(b">read%d %s\n" % (i, b"x" * int(rng.integers(0, 30)))
                   + b"".join(line + b"\n" for line in lines)
                   + (b"\n" if i % 11 == 5 else b""))
    return b"".join(out)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs of every process test: a plain FASTA, its BGZF copy in
    small blocks, a file whose second half is one read with no 8-mer,
    a two-record file, a plain gzip copy and a FASTQ."""
    d = tmp_path_factory.mktemp("inputs")
    blob = _fasta_blob(7, 150)
    paths = {"plain": d / "r.fasta", "bgzf": d / "r.fasta.gz", "empty_row": d / "e.fasta",
             "two_records": d / "two.fasta", "gzip": d / "g.fasta.gz",
             "fastq": d / "q.fastq"}
    paths["plain"].write_bytes(blob)
    write_bgzf(paths["bgzf"], blob, block=700)
    paths["empty_row"].write_bytes(b">r0\n" + b"ACGT" * 60 + b"\n>r1\nACGNNT\n")
    paths["two_records"].write_bytes(b">a\nACGTACGTAC\n>b\nTTGCATGCAAT\n")
    paths["gzip"].write_bytes(gzip.compress(blob))
    paths["fastq"].write_bytes(b"@q0\nACGTACGTAA\n+\nIIIIIIIIII\n@q1\nGGGTTTAAAC\n+\nIIIIIIIIII\n")
    return {name: str(p) for name, p in paths.items()}


# ---------------------------------------------------------------- planning


@pytest.mark.parametrize("kind", ["plain", "bgzf"])
def test_align_to_record_matches_jax(tmp_path, kind):
    blob = _fasta_blob(3, 12)
    path = tmp_path / ("r.fasta" if kind == "plain" else "r.fasta.gz")
    if kind == "plain":
        path.write_bytes(blob)
    else:
        write_bgzf(path, blob, block=64)
    # Every offset: on a '>', inside a header or a sequence, on a
    # newline, at and past the end.
    targets = list(range(len(blob) + 3))
    assert any(blob[t : t + 1] == b">" for t in targets)
    got = [tdist.align_to_record(path, t) for t in targets]
    assert got == [jdist.align_to_record(path, t) for t in targets]
    starts = {0} | {i + 1 for i in range(len(blob)) if blob[i : i + 2] == b"\n>"}
    assert set(got) == starts | {len(blob)}


@pytest.mark.parametrize("kind", ["plain", "bgzf"])
@pytest.mark.parametrize("count", [1, 2, 3, 5, 16, 40])
def test_host_byte_range_matches_jax(tmp_path, kind, count):
    """Ranges for every index of ``count`` processes, up to more
    processes than the file's 12 records: equal to cfrk_tpu's, abutting,
    and covering every record once."""
    blob = _fasta_blob(4, 12)
    path = tmp_path / ("r.fasta" if kind == "plain" else "r.fasta.gz")
    if kind == "plain":
        path.write_bytes(blob)
    else:
        write_bgzf(path, blob, block=100)
    got = [tdist.host_byte_range(path, i, count) for i in range(count)]
    assert got == [jdist.host_byte_range(path, i, count) for i in range(count)]
    assert got[0][0] == 0 and got[-1][1] == len(blob)
    starts = [i for i in range(len(blob)) if blob[i : i + 1] == b">"
              and (i == 0 or blob[i - 1 : i] == b"\n")]
    owners = [[r for r, (s, lim) in enumerate(got) if s <= p < lim] for p in starts]
    assert all(len(o) == 1 for o in owners)
    assert tdist.host_shard(list("abcdefg"), 1, count) == jdist.host_shard(
        list("abcdefg"), 1, count)


def test_planning_defaults_to_a_world_of_one(tmp_path):
    """Without a process group the index and count are 0 and 1."""
    path = tmp_path / "r.fasta"
    path.write_bytes(_fasta_blob(5, 4))
    assert tdist.host_byte_range(path) == (0, path.stat().st_size)
    assert tdist.host_shard(["a", "b"]) == ["a", "b"]


# ------------------------------------------------------------ initialisation


def test_initialize_is_a_no_op_without_a_coordinator():
    import torch.distributed as dist

    assert tdist.maybe_initialize_distributed() is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("present", ["JAX_NUM_PROCESSES", "JAX_PROCESS_ID"])
@pytest.mark.parametrize("coordinator", ["JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"])
def test_partial_triplet_message_matches_jax(monkeypatch, present, coordinator):
    monkeypatch.setenv(coordinator, "127.0.0.1:1")
    monkeypatch.setenv(present, "2")
    missing = "JAX_PROCESS_ID" if present == "JAX_NUM_PROCESSES" else "JAX_NUM_PROCESSES"
    with pytest.raises(ValueError, match=f"but {missing} is missing") as port:
        tdist.maybe_initialize_distributed()
    with pytest.raises(ValueError) as jax:
        jdist.maybe_initialize_distributed()
    assert str(port.value) == str(jax.value)


def test_force_without_a_coordinator_raises():
    """Where ``jax.distributed.initialize()`` raises for want of a
    coordinator (no triplet, no SLURM or Open MPI job), the port raises
    naming the three variables and the two launchers' variables: no
    silent world of one.  Through the CLI, both packages raise
    ValueError."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, "
                                         "JAX_PROCESS_ID") as err:
        tdist.maybe_initialize_distributed(force=True)
    for launcher in ("SLURM", "SLURM_STEP_NODELIST", "Open MPI", "OMPI_MCA_orte_hnp_uri"):
        assert launcher in str(err.value)
    assert not dist.is_initialized()
    fa = Path("r.fasta")
    fa.write_bytes(_fasta_blob(1, 3))
    with pytest.raises(ValueError, match="no coordinator is defined"):
        main([str(fa), "-k", "2", "-o", "t.cfrk", "--distributed", "--device", "cpu"])
    assert not dist.is_initialized()
    # cfrk_tpu in a fresh interpreter: jax.distributed.initialize() must
    # come before any use of the XLA backend, which this process has made.
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)}
    jax_run = subprocess.run(
        [sys.executable, "-c", "from cfrk_tpu.cli import main; import sys; "
         "main(sys.argv[1:])", str(fa), "-k", "2", "-o", "j.cfrk", "--distributed",
         "--devices", "1"], env=env, capture_output=True, text=True, timeout=120)
    assert jax_run.returncode != 0
    assert "ValueError: coordinator_address should be defined" in jax_run.stderr


def test_rank_outside_the_world_is_refused(monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    with pytest.raises(ValueError, match=r"JAX_PROCESS_ID=2 is not in \[0, JAX_NUM_PROCESSES=2\)"):
        tdist.maybe_initialize_distributed()


# ------------------------------------------------------- cluster detection

_NODELISTS = ["node001", "node001,host2", "node[001-0015],host2", "node[001,007-015],host2",
              "localhost"]
_ORTE_URIS = ["1531576320.0;tcp://10.96.0.1,10.148.0.1,10.108.0.1:34911",
              "1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,2620:10d:c083:150e::3000:2]:43370",
              "4096.0;tcp://127.0.0.1:1024"]


def _slurm(monkeypatch, nodelist="node001", procid=1, ntasks=4, localid=1, job="81234"):
    for name, value in (("SLURM_JOB_ID", job), ("SLURM_STEP_NODELIST", nodelist),
                        ("SLURM_NTASKS", ntasks), ("SLURM_PROCID", procid),
                        ("SLURM_LOCALID", localid)):
        monkeypatch.setenv(name, str(value))


def _ompi(monkeypatch, uri=_ORTE_URIS[0], rank=2, size=3, local=0):
    for name, value in (("OMPI_MCA_orte_hnp_uri", uri), ("OMPI_COMM_WORLD_SIZE", size),
                        ("OMPI_COMM_WORLD_RANK", rank),
                        ("OMPI_COMM_WORLD_LOCAL_RANK", local)):
        monkeypatch.setenv(name, str(value))


def _params(cluster, jax_style: bool):
    """(address, count, id, local id) as a cluster class gives them."""
    port = os.environ.get("JAX_COORDINATOR_PORT")
    if jax_style:
        return (cluster.get_coordinator_address(None, port), cluster.get_process_count(),
                cluster.get_process_id(), cluster.get_local_process_id())
    return (cluster.coordinator_address(port), cluster.process_count(),
            cluster.process_id(), cluster.local_process_id())


@pytest.mark.parametrize("port", [None, "12345"], ids=["job_port", "port_override"])
@pytest.mark.parametrize("nodelist", _NODELISTS)
def test_slurm_detection_matches_jax(monkeypatch, nodelist, port):
    from jax._src.clusters import SlurmCluster

    _slurm(monkeypatch, nodelist)
    if port:
        monkeypatch.setenv("JAX_COORDINATOR_PORT", port)
    assert SlurmCluster.is_env_present() and tdist.SlurmCluster.is_env_present()
    got = _params(tdist.SlurmCluster, False)
    assert got == _params(SlurmCluster, True)
    assert got[0].split(":")[0] == ("localhost" if nodelist == "localhost" else "node001")
    assert tdist.detect_cluster() is tdist.SlurmCluster
    assert tdist.local_process_id() == 1
    monkeypatch.delenv("SLURM_LOCALID")
    assert not SlurmCluster.is_env_present() and tdist.detect_cluster() is None


@pytest.mark.parametrize("port", [None, "12345"], ids=["job_port", "port_override"])
@pytest.mark.parametrize("uri", _ORTE_URIS, ids=["tcp", "tcp6", "tcp_low_job"])
def test_open_mpi_detection_matches_jax(monkeypatch, uri, port):
    from jax._src.clusters import OmpiCluster

    _ompi(monkeypatch, uri)
    if port:
        monkeypatch.setenv("JAX_COORDINATOR_PORT", port)
    assert OmpiCluster.is_env_present() and tdist.OmpiCluster.is_env_present()
    assert _params(tdist.OmpiCluster, False) == _params(OmpiCluster, True)
    assert tdist.detect_cluster() is tdist.OmpiCluster


def test_open_mpi_wins_over_slurm_in_both(monkeypatch):
    """Both launchers' variables set: JAX's order takes Open MPI, and so
    does the port."""
    from jax._src.clusters import ClusterEnv

    _slurm(monkeypatch, "node[001-0015],host2", procid=0, ntasks=2, localid=0)
    _ompi(monkeypatch, _ORTE_URIS[0], rank=2, size=3, local=1)
    addr, count, pid, local_ids = ClusterEnv.auto_detect_unset_distributed_params(
        None, None, None, None, None, None)
    assert tdist.detect_cluster() is tdist.OmpiCluster
    assert _params(tdist.OmpiCluster, False) == (addr, count, pid, 1)
    assert local_ids in ([1], None)  # None only where JAX runs on a Cloud TPU VM


def _captured_init(monkeypatch) -> list:
    import torch.distributed as dist

    seen = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    return seen


@pytest.mark.parametrize("launch", ["slurm", "ompi", "address_and_slurm", "triplet_and_slurm"])
def test_group_starts_from_a_detected_cluster(monkeypatch, launch):
    """The group's address, size and rank, as ``jax.distributed.
    initialize()`` fills what the triplet leaves unset: from SLURM, from
    Open MPI, the address from ``JAX_COORDINATOR_ADDRESS`` and the rest
    from SLURM, or the whole triplet (the cluster then only gives the
    local id)."""
    seen = _captured_init(monkeypatch)
    _slurm(monkeypatch, "node[001-0015],host2", procid=1, ntasks=4, job="81234")
    if launch == "ompi":
        _ompi(monkeypatch, _ORTE_URIS[1], rank=2, size=3)
    if launch in ("address_and_slurm", "triplet_and_slurm"):
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.1.2.3:5555")
    if launch == "triplet_and_slurm":
        monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
        monkeypatch.setenv("JAX_PROCESS_ID", "0")
    assert tdist.maybe_initialize_distributed(force=launch in ("slurm", "ompi")) is True
    slurm_port = 81234 % 4096 + 61440
    want = {
        "slurm": (f"tcp://node001:{slurm_port}", 1, 4),
        "ompi": (f"tcp://[fe80::b9b:ac5d:9cf0:b858]:{1314521088 // 4096 % 4096 + 61440}",
                 2, 3),
        "address_and_slurm": ("tcp://10.1.2.3:5555", 1, 4),
        "triplet_and_slurm": ("tcp://10.1.2.3:5555", 0, 2),
    }[launch]
    assert seen == [("gloo", {"init_method": want[0], "rank": want[1],
                              "world_size": want[2]})]
    assert tdist.local_process_id() == (0 if launch == "ompi" else 1)


def test_without_force_a_cluster_alone_starts_nothing(monkeypatch):
    """As in cfrk_tpu: detection runs only for ``--distributed``."""
    seen = _captured_init(monkeypatch)
    _slurm(monkeypatch)
    assert tdist.maybe_initialize_distributed() is False and seen == []


def test_slurm_rank_outside_the_world_is_refused(monkeypatch):
    _slurm(monkeypatch, procid=4, ntasks=4)
    with pytest.raises(ValueError, match=r"SLURM_PROCID=4 is not in \[0, SLURM_NTASKS=4\)"):
        tdist.maybe_initialize_distributed(force=True)


@pytest.mark.parametrize("local", [0, 1, 2])
def test_local_id_picks_the_card(monkeypatch, local):
    """``--distributed`` on ``--device cuda`` under a detected cluster:
    the card ``cuda:<local id>``; an id at or above the card count
    exits; on the CPU, or with no cluster, no card is picked."""
    import torch

    from cfrk_tpu_torch import cli as tcli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = torch.device("cuda")
    assert tcli._rank_card(cuda) is None
    _slurm(monkeypatch, localid=local)
    assert tcli._rank_card(torch.device("cpu")) is None
    if local < 2:
        assert tcli._rank_card(cuda) == torch.device("cuda", local)
    else:
        with pytest.raises(SystemExit, match="local id is 2, but only 2 CUDA"):
            tcli._rank_card(cuda)


# Ports a worker's slice holds, and the slots of slices below the
# ephemeral range (xdist numbers a replacement worker on from the last).
_SLICE, _SLOTS = 256, 32


def _port_slice() -> range:
    """This worker's coordinator ports: slice ``PYTEST_XDIST_WORKER``
    (gw0, gw1, ...; 0 without xdist) of ``_SLOTS`` slices that end at the
    low bound of ``/proc/sys/net/ipv4/ip_local_port_range``, from which
    the kernel draws every port-0 bind."""
    try:
        low = int(Path("/proc/sys/net/ipv4/ip_local_port_range").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")[2:]
    slot = int(worker) % _SLOTS if worker.isdigit() else 0
    start = max(1024, low - _SLOTS * _SLICE) + slot * _SLICE
    return range(start, start + _SLICE)


_SLICE_PORTS = _port_slice()
# From a random place in the slice: two test runs on one host have the
# same slices, and would otherwise try the same ports in the same order.
_FIRST = random.SystemRandom().randrange(_SLICE)
_PORTS = itertools.cycle([*_SLICE_PORTS[_FIRST:], *_SLICE_PORTS[:_FIRST]])


def _bindable(port: int) -> bool:
    with socket.socket() as sock:
        try:
            sock.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


@contextlib.contextmanager
def _held_ports(n: int):
    """``n`` ports of this worker's slice, in turn, each free when picked
    and held for the block by a socket bound to it; a port is used again
    only after the rest of the slice.  While it is held, a plain bind of
    the port fails (another run's pick included), and the process that
    hosts a group's store binds and listens on it all the same: the
    holder sets SO_REUSEADDR after its bind, as the store does, and never
    listens."""
    held = []
    try:
        for port in itertools.islice(_PORTS, len(_SLICE_PORTS)):
            sock = socket.socket()
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                sock.close()
                continue
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            held.append(sock)
            if len(held) == n:
                yield [s.getsockname()[1] for s in held]
                return
        raise RuntimeError(f"fewer than {n} free ports in {_SLICE_PORTS}")
    finally:
        for sock in held:
            sock.close()


@pytest.mark.parametrize("worker", ["gw0", "gw5", "gw37", None])
def test_coordinator_ports_lie_below_the_ephemeral_range(monkeypatch, worker):
    """Each worker's slice lies below the range that port-0 binds draw
    from, apart from every other worker's (a replacement worker's too,
    up to ``_SLOTS`` workers); the picks are distinct and free."""
    low = int(Path("/proc/sys/net/ipv4/ip_local_port_range").read_text().split()[0])
    slices = []
    for name in (worker, "gw1"):
        if name is None:
            monkeypatch.delenv("PYTEST_XDIST_WORKER", raising=False)
        else:
            monkeypatch.setenv("PYTEST_XDIST_WORKER", name)
        slices.append(set(_port_slice()))
    assert len(slices[0]) == _SLICE and max(slices[0]) < low and min(slices[0]) >= 1024
    assert not slices[0] & slices[1]
    with _held_ports(5) as ports:
        assert len(set(ports)) == 5 and set(ports) <= set(_SLICE_PORTS)
        assert not any(_bindable(p) for p in ports)
    assert all(_bindable(p) for p in ports)


def test_existing_group_is_left_alone_and_world_of_one_runs(monkeypatch, inputs):
    """A group that exists makes initialisation a no-op (False), with or
    without ``force``, and the CLI neither replaces nor destroys it; a
    world of one is the ordinary single-process run, to cfrk_tpu's
    bytes, and the CLI destroys the group it started."""
    import torch.distributed as dist

    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    argv = [inputs["plain"], "8", "--nonzero"]
    assert jax_main([argv[0], "j.cfrk", *argv[1:], "--devices", "1"]) == 0
    with _held_ports(1) as (port,):
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
        assert main([argv[0], "t.cfrk", *argv[1:], "--distributed", "--device", "cpu"]) == 0
    assert not dist.is_initialized()
    assert Path("t.cfrk").read_bytes() == Path("j.cfrk").read_bytes()
    assert not [p for p in os.listdir() if ".part" in p]

    with _held_ports(1) as (port,):
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                                world_size=1)
    try:
        assert tdist.maybe_initialize_distributed() is False
        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
        assert tdist.maybe_initialize_distributed(force=True) is False
        assert main([argv[0], "u.cfrk", *argv[1:], "--distributed", "--device", "cpu"]) == 0
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    assert Path("u.cfrk").read_bytes() == Path("j.cfrk").read_bytes()


# ---------------------------------------------------------------- refusals


def test_stdin_is_refused_like_jax():
    for cli_main, extra in ((main, ["--device", "cpu"]), (jax_main, ["--devices", "1"])):
        with pytest.raises(SystemExit, match=r"^--distributed needs file inputs \(a pipe "
                                             r"cannot be byte-range sharded\)$"):
            cli_main(["-", "-k", "2", "-o", "o.cfrk", "--distributed", *extra])




def test_splice_keeps_an_empty_row_and_skips_an_empty_part(tmp_path):
    """A 0-byte part of one read (its ``--nonzero`` row is empty) is a
    row; a part of no reads is not."""
    parts = []
    for i, (body, n) in enumerate(((b"0:1 ", 1), (b"", 0), (b"", 1), (b"1:2 \n", 2))):
        p = tmp_path / f"o.part{i}"
        p.write_bytes(body)
        (tmp_path / f"o.part{i}.nreads").write_text(str(n))
        parts.append(str(p))
    _splice_perread_parts(parts, str(tmp_path / "o"))
    assert (tmp_path / "o").read_bytes() == b"0:1 \n\n1:2 \n"


# ---------------------------------------------------------------- processes

# The head of every rank's script: one intra-op and one inter-op torch
# thread (the ranks run --device cpu on batches of 8 and need no thread
# pool; ``_launch`` also sets OMP_NUM_THREADS and MKL_NUM_THREADS to 1),
# and the rank's end once the process that started it (its pid in
# TEST_LAUNCHER_PID) is gone: a rank leads a session of its own, so a
# signal to the test run's process group, as a timeout sends it, does not
# reach the rank.
_RANK_HEAD = """import os, threading, time, torch
torch.set_num_threads(1)
torch.set_num_interop_threads(1)
def _orphaned():
    while os.getppid() == int(os.environ["TEST_LAUNCHER_PID"]):
        time.sleep(0.5)
    os._exit(70)
threading.Thread(target=_orphaned, daemon=True).start()
"""

# One rank: runs each leg's argv through the CLI's main in turn, each on
# its own coordinator port, and prints each leg's outcome as one JSON
# line at the end.  A leg whose group could not bind its port ends the
# rank at once, so that the launch is made again.
_RANK = _RANK_HEAD + """
import json, os, sys, traceback
from cfrk_tpu_torch.cli import main
rank, world, legs = int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3])
os.environ.update(JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(rank))
out = {}
for name, port, argv in legs:
    os.environ["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    try:
        out[name] = {"rc": main(argv)}
    except SystemExit as e:
        out[name] = {"exit": str(e.code)}
    except Exception as e:
        traceback.print_exc()
        if "address already in use" in str(e).lower():
            sys.exit(75)
        out[name] = {"error": f"{type(e).__name__}: {e}"}
print(json.dumps(out))
"""


_ATTEMPTS = 5


def _taken(err: str) -> bool:
    return "address already in use" in err.lower()


class Launch(NamedTuple):
    """One launch: each rank's (returncode, stdout, stderr), pid (also its
    session's id) and peak RSS (KiB), the launch's wall time (s) and
    which attempt it was (from 1)."""

    runs: list
    pids: list
    rss_kib: list
    wall: float
    attempt: int


def _report(what: str, launch: Launch) -> str:
    """Why a launch failed (``what``: a timeout or a rank death), with the
    host's state at this moment: its load and available memory, and the
    peak RSS of this process's largest child so far."""
    avail = re.search(r"MemAvailable:\s*(\d+ kB)", Path("/proc/meminfo").read_text())
    lines = [f"{what}: {len(launch.runs)} ranks, attempt {launch.attempt} of {_ATTEMPTS}, "
             f"{launch.wall:.1f} s wall",
             f"loadavg {Path('/proc/loadavg').read_text().strip()}; MemAvailable "
             f"{avail.group(1) if avail else '?'}; children's peak RSS "
             f"{resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss} KiB"]
    for rank, ((rc, _, err), pid, rss) in enumerate(zip(launch.runs, launch.pids,
                                                        launch.rss_kib)):
        code = f"{rc} ({signal.Signals(-rc).name})" if rc < 0 else str(rc)
        lines.append(f"--- rank {rank} (pid {pid}): rc {code}, peak RSS {rss} KiB, "
                     f"stderr tail ---\n{err[-3000:]}")
    return "\n".join(lines)


def _exit_code(proc):
    """The rank's return code once it has ended (minus the signal that
    killed it), else None.  The rank is not reaped, so that its pid, which
    is also its session's and process group's id, cannot be reused before
    :func:`_launch` kills that group."""
    info = os.waitid(os.P_PID, proc.pid, os.WEXITED | os.WNOHANG | os.WNOWAIT)
    if info is None:
        return None
    return info.si_status if info.si_code == os.CLD_EXITED else -info.si_status


def _launch(world: int, script: str, args, cwd: Path, env_of_rank,
            timeout: float = LAUNCH_TIMEOUT_S, attempt: int = 1) -> Launch:
    """``world`` processes of ``python -c script`` (rank i gets
    ``args(i)`` and the environment ``env_of_rank(i)``), each in a session
    of its own with stdin from ``/dev/null``, one OpenMP / MKL thread and
    this process's pid in ``TEST_LAUNCHER_PID`` (``_RANK_HEAD``).
    A rank alive past ``timeout`` fails the test with :func:`_report`; a
    rank that died because its coordinator port was taken ends the launch
    at once.  However the launch ends, every rank's session is killed
    (children of a rank included) before the ranks are reaped."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               TEST_LAUNCHER_PID=str(os.getpid()))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs, logs = [], []
    start = time.monotonic()
    timed_out = False
    try:
        for rank in range(world):
            out, err = cwd / f"rank{rank}.out", cwd / f"rank{rank}.err"
            logs.append((out, err))
            with open(out, "w") as o, open(err, "w") as e:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", script, *args(rank)], cwd=cwd,
                    stdin=subprocess.DEVNULL, stdout=o, stderr=e,
                    env={**env, **env_of_rank(rank)}, start_new_session=True))
        while any(_exit_code(p) is None for p in procs):
            if time.monotonic() - start > timeout:
                timed_out = True
                break
            if any(_exit_code(p) not in (None, 0) and _taken(err.read_text())
                   for p, (_, err) in zip(procs, logs)):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        rss = []
        for p in procs:
            _, status, usage = os.wait4(p.pid, 0)
            p.returncode = os.waitstatus_to_exitcode(status)
            rss.append(usage.ru_maxrss)
    launch = Launch([(p.returncode, out.read_text(), err.read_text())
                     for p, (out, err) in zip(procs, logs)], [p.pid for p in procs], rss,
                    time.monotonic() - start, attempt)
    if timed_out:
        pytest.fail(_report(f"timeout: a rank outlived {timeout} s", launch))
    return launch


def _all_ok(launch: Launch) -> list:
    """The runs of a launch whose ranks all returned 0; else the test
    fails with :func:`_report`."""
    if any(rc for rc, _, _ in launch.runs):
        pytest.fail(_report("rank death: a rank returned non-zero", launch))
    return launch.runs


def _launch_on_ports(world: int, script: str, n_ports: int, args, cwd: Path,
                     env_of_rank) -> Launch:
    """:func:`_launch` on ``n_ports`` fresh ports, held while it runs (rank i gets
    ``args(ports, i)`` and ``env_of_rank(ports, i)``), made again on fresh
    ports while a rank's stderr says that its address was in use, up to
    ``_ATTEMPTS`` launches in all.  Returns the last launch."""
    for attempt in range(1, _ATTEMPTS + 1):
        with _held_ports(n_ports) as ports:
            launch = _launch(world, script, lambda r: args(ports, r), cwd,
                             lambda r: env_of_rank(ports, r), attempt=attempt)
        if not any(_taken(err) for _, _, err in launch.runs):
            break
    return launch


def _run_legs(world: int, legs: dict, cwd: Path) -> dict:
    """Every leg ({name: argv}) on ``world`` ranks, in one launch, each
    leg on a port of its own.  Returns {name: [each rank's outcome]}."""
    def args(ports, rank):
        plan = [[name, port, argv] for (name, argv), port in zip(legs.items(), ports)]
        return [str(rank), str(world), json.dumps(plan)]

    runs = _all_ok(_launch_on_ports(world, _RANK, len(legs), args, cwd, lambda ports, r: {}))
    results = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in runs]
    return {name: [r[name] for r in results] for name in legs}


# The JAX CLI's refusals; the gzip hint names the port's make_synthetic.
_REFUSAL_MESSAGE = {
    "gzip": "--distributed with a single input needs a byte-rangeable file, and {inp!r} "
            "is not: plain (non-BGZF) gzip permits no random access, so byte-range "
            "sharding is impossible.  Recompress with bgzip (`python -m "
            "cfrk_tpu_torch.tools.make_synthetic --help`, "
            "cfrk_tpu_torch/tools/make_synthetic.py, shows the --bgzf writer; any "
            "htslib bgzip works) or pre-shard the file; or drop --distributed to run "
            "on one host",
    "fastq": "--distributed with a single input needs a byte-rangeable file, and "
             "{inp!r} is not: FASTQ record starts are ambiguous for byte-range "
             "sharding ('@' also begins quality lines).  Pre-shard the input into one "
             "file per host, or convert to FASTA/bgzf; or drop --distributed to run on "
             "one host",
}

# name: (input, flags, output name).  Each runs with --batch-size 8 and
# --device cpu, so every rank streams several batches and checkpoints.
_LEGS = {
    "perread_plain": ("plain", ["8", "--nonzero", "--stats"], "o.cfrk"),
    "perread_bgzf": ("bgzf", ["4"], "o.cfrk"),
    "perread_gz_out": ("plain", ["5", "--nonzero"], "o.cfrk.gz"),
    "spectrum_tsv": ("plain", ["-k", "6", "--mode", "spectrum", "--spectrum-format",
                               "tsv"], None),
    "spectrum_bgzf_cfrk": ("bgzf", ["-k", "3", "--mode", "spectrum"], None),
    "sparse_k19": ("plain", ["-k", "19", "--canonical", "--mode", "sparse"], None),
    "sparse_bgzf_hist": ("bgzf", ["-k", "12", "--mode", "sparse", "--spectrum-format",
                                  "hist"], None),
    "empty_row": ("empty_row", ["8", "--nonzero"], "o.cfrk"),
    "two_records": ("two_records", ["3", "--nonzero"], "o.cfrk"),
}
_REFUSALS = ("gzip", "fastq")


def _leg_argv(inputs, name: str, out: Path) -> list:
    inp, flags, positional_out = _LEGS[name]
    if positional_out:
        return [inputs[inp], str(out / positional_out), *flags]
    return [inputs[inp], "-o", str(out / "o.out"), *flags]


@pytest.fixture(scope="module")
def jax_bytes(inputs, tmp_path_factory) -> dict:
    """The JAX CLI's bytes of each leg, run once on one device (a
    ``.gz`` output name stripped: its splice writes plain bytes)."""
    root = tmp_path_factory.mktemp("jax")
    want = {}
    for name in _LEGS:
        (root / name).mkdir()
        argv = _leg_argv(inputs, name, root / name)
        if argv[1].endswith(".gz"):
            argv[1] = argv[1][:-3]
        assert jax_main([*argv, "--devices", "1"]) == 0
        (path,) = (root / name).iterdir()
        want[name] = path.read_bytes()
    return want


@pytest.fixture(scope="module", params=[2, 3], ids=["2ranks", "3ranks"])
def ranked(request, inputs, jax_bytes, tmp_path_factory):
    """Every leg and refusal on 2 (then 3) ranks in one launch, and the
    JAX CLI's bytes for each leg."""
    world = request.param
    root = tmp_path_factory.mktemp(f"world{world}")
    legs = {}
    for name in _LEGS:
        (root / name).mkdir()
        legs[name] = [*_leg_argv(inputs, name, root / name), "--distributed",
                      "--device", "cpu", "--batch-size", "8"]
    for kind in _REFUSALS:
        legs[f"refuse_{kind}"] = [inputs[kind], "-k", "2", "-o", str(root / f"{kind}.out"),
                                  "--distributed", "--device", "cpu"]
    return {"world": world, "root": root, "results": _run_legs(world, legs, root),
            "jax": jax_bytes}


@pytest.mark.parametrize("leg", sorted(_LEGS))
def test_byte_ranged_output_matches_jax_cli(ranked, leg):
    """Every rank returns 0; process 0's output is cfrk_tpu's bytes (a
    ``.gz`` output gzipped, where cfrk_tpu's splice writes plain bytes
    under that name); no part, sidecar or checkpoint is left."""
    assert ranked["results"][leg] == [{"rc": 0}] * ranked["world"]
    (out,) = (ranked["root"] / leg).iterdir()
    got = out.read_bytes()
    if out.name.endswith(".gz"):
        got = gzip.decompress(got)
    assert got == ranked["jax"][leg] and got


def test_empty_row_part_is_one_read(ranked, inputs):
    """The last range holds one read whose ``--nonzero`` row is empty:
    it still makes a row (the output ends in a newline)."""
    path = inputs["empty_row"]
    start, limit = tdist.host_byte_range(path, ranked["world"] - 1, ranked["world"])
    assert Path(path).read_bytes()[start:limit].count(b">") == 1
    assert ranked["jax"]["empty_row"].endswith(b"\n")


@pytest.mark.parametrize("kind", _REFUSALS)
def test_unrangeable_single_input_is_refused(ranked, inputs, kind):
    want = _REFUSAL_MESSAGE[kind].format(inp=inputs[kind])
    assert ranked["results"][f"refuse_{kind}"] == [{"exit": want}] * ranked["world"]


_CLI = _RANK_HEAD + ("import sys\nfrom cfrk_tpu_torch.cli import main\n"
                      "sys.exit(main(sys.argv[1:]))\n")


def _cli_ranks(world, argv, cwd, fault_of_rank, script: str = _CLI) -> Launch:
    """One CLI run on ``world`` ranks, rank i armed with
    ``CFRK_FAULT_INJECT=fault_of_rank(i)`` where that is not None."""
    def env_of_rank(ports, rank):
        env = {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{ports[0]}",
               "JAX_NUM_PROCESSES": str(world), "JAX_PROCESS_ID": str(rank)}
        if fault_of_rank(rank):
            env["CFRK_FAULT_INJECT"] = fault_of_rank(rank)
        return env

    return _launch_on_ports(world, script, 1, lambda ports, r: argv, cwd, env_of_rank)


def test_ranks_started_by_slurm_write_one_process_bytes(tmp_path, inputs, jax_bytes):
    """2 gloo ranks started from SLURM's variables alone (each task on a
    node of its own, ``SLURM_LOCALID=0``; the port from
    ``JAX_COORDINATOR_PORT``): the byte-ranged run writes the bytes of
    one process, and no part is left."""
    out = tmp_path / "o.cfrk"
    argv = [inputs["plain"], str(out), *_LEGS["perread_plain"][1], "--distributed",
            "--device", "cpu", "--batch-size", "8"]
    launch = _launch_on_ports(2, _CLI, 1, lambda ports, r: argv, tmp_path, lambda ports, r: {
        "SLURM_JOB_ID": "777", "SLURM_STEP_NODELIST": "localhost", "SLURM_NTASKS": "2",
        "SLURM_PROCID": str(r), "SLURM_LOCALID": "0", "JAX_COORDINATOR_PORT": str(ports[0])})
    _all_ok(launch)
    assert out.read_bytes() == jax_bytes["perread_plain"]
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("o.")) == ["o.cfrk"]


@pytest.mark.parametrize("killed", ["both", "rank1"])
def test_killed_ranks_resume_to_jax_bytes(tmp_path, inputs, jax_bytes, killed):
    """Ranks killed at their second checkpoint (both, or rank 1 alone:
    rank 0 then fails at the barrier and splices nothing) exit non-zero
    and leave their checkpoints; the same command with ``--resume``
    writes cfrk_tpu's bytes and leaves no part or checkpoint."""
    out = tmp_path / "o.cfrk"
    argv = [inputs["bgzf"], str(out), *_LEGS["perread_bgzf"][1], "--distributed",
            "--device", "cpu", "--batch-size", "8"]
    fault = (lambda r: "checkpoint:2") if killed == "both" else (
        lambda r: "checkpoint:2" if r == 1 else None)
    launch = _cli_ranks(2, argv, tmp_path, fault)
    runs = launch.runs
    assert all(rc != 0 for rc, _, _ in runs), _report("a rank returned 0", launch)
    assert "InjectedFault" in runs[1][2]
    if killed == "rank1":
        assert "InjectedFault" not in runs[0][2]
    assert not out.exists()
    assert (tmp_path / "o.cfrk.part1.ckpt.json").exists()
    _all_ok(_cli_ranks(2, [*argv, "--resume"], tmp_path, lambda r: None))
    assert out.read_bytes() == jax_bytes["perread_bgzf"]
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("o.")) == ["o.cfrk"]


# The CLI with its group's start and end stamped on stderr, the last rank
# slow to finish joining (as a rank the host has not scheduled yet is).
_JOIN_PROBE = _RANK_HEAD + """
import sys, time
import torch.distributed as dist
from cfrk_tpu_torch.cli import main
join, leave = dist.init_process_group, dist.destroy_process_group
def init(*args, **kwargs):
    join(*args, **kwargs)
    if dist.get_rank() == dist.get_world_size() - 1:
        time.sleep(1)
    print("joined", time.monotonic(), file=sys.stderr, flush=True)
def destroy(*args, **kwargs):
    print("leaving", time.monotonic(), file=sys.stderr, flush=True)
    leave(*args, **kwargs)
dist.init_process_group, dist.destroy_process_group = init, destroy
sys.exit(main(sys.argv[1:]))
"""


def test_no_rank_leaves_the_group_before_every_rank_has_joined(tmp_path, inputs):
    """Three ranks refuse a FASTQ input, the last one slow to finish
    joining the group: each exits with the JAX CLI's refusal (none with a
    broken connection), and none leaves the group before the last has
    joined it."""
    argv = [inputs["fastq"], "-k", "2", "-o", str(tmp_path / "o.out"), "--distributed",
            "--device", "cpu"]
    launch = _cli_ranks(3, argv, tmp_path, lambda r: None, script=_JOIN_PROBE)
    want = _REFUSAL_MESSAGE["fastq"].format(inp=inputs["fastq"])
    assert all(rc == 1 and err.rstrip().endswith(want) for rc, _, err in launch.runs), \
        _report("a rank did not refuse", launch)
    stamps = [{key: float(t) for key, t in re.findall(r"^(joined|leaving) (\S+)$", err, re.M)}
              for _, _, err in launch.runs]
    assert max(s["joined"] for s in stamps) <= min(s["leaving"] for s in stamps)


def _dealt_run(tmp_path, inputs, world: int, names: list, flags: list) -> list:
    """``--distributed`` with several inputs on ``world`` ranks into one
    ``--out-dir``: every rank exits 0, the directory holds one output an
    input, each the JAX CLI's bytes of that input alone.  Returns each
    rank's ``--stats`` line."""
    paths = [inputs[n] for n in names]
    out = tmp_path / "out"
    runs = _all_ok(_cli_ranks(world, [*paths, *flags, "--out-dir", str(out), "--distributed",
                                      "--device", "cpu", "--stats"], tmp_path, lambda r: None))
    assert len(runs) == world
    for path in paths:
        assert jax_main([path, *flags, "--out-dir", str(tmp_path / "jax"),
                         "--devices", "1"]) == 0
    want = {p.name: p.read_bytes() for p in (tmp_path / "jax").iterdir()}
    assert len(want) == len(paths)
    assert sorted(p.name for p in out.iterdir()) == sorted(want)
    for name, data in want.items():
        assert (out / name).read_bytes() == data, name
    return [json.loads(err.strip().splitlines()[-1]) for _, _, err in runs]


def test_several_inputs_are_not_yet_ported(tmp_path, inputs):
    """Three inputs on 2 ranks: dealt round-robin, rank 0 runs its two
    as a workflow and rank 1 its one, with no barrier; each output is the
    JAX CLI's bytes of its input."""
    stats = _dealt_run(tmp_path, inputs, 2, ["plain", "empty_row", "two_records"],
                       ["-k", "8", "--nonzero"])
    assert [(s["files"], s["reads"]) for s in stats] == [(2, 152), (1, 2)]
    assert stats[0]["failed"] == 0


def test_several_inputs_on_more_ranks_than_inputs(tmp_path, inputs):
    """Two inputs on 3 ranks: the rank dealt none writes nothing and
    exits 0, as in cfrk_tpu."""
    stats = _dealt_run(tmp_path, inputs, 3, ["plain", "two_records"],
                       ["-k", "5", "--mode", "spectrum"])
    assert [s["files"] for s in stats] == [1, 1, 0]


# ----------------------------------------------------------------- harness


def _live_session(sid: int) -> list:
    """The pids of the processes of session ``sid`` that are not zombies."""
    alive = []
    for entry in Path("/proc").iterdir():
        try:
            fields = (entry / "stat").read_text().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if int(fields[3]) == sid and fields[0] != "Z":
            alive.append(int(entry.name))
    return alive


def test_rank_that_signals_its_group_dies_alone(tmp_path):
    """A rank that sends SIGTERM to its own process group ends only
    itself: this process lives on, the other rank's session is its own,
    and the launch reports a rank death with the signal by name."""
    script = ("import os, signal, sys, time\n"
              "if sys.argv[1] == '0':\n    os.killpg(0, signal.SIGTERM)\n"
              "time.sleep(1)\n")
    launch = _launch(2, script, lambda r: [str(r)], tmp_path, lambda r: {})
    assert [rc for rc, _, _ in launch.runs] == [-signal.SIGTERM, 0]
    with pytest.raises(pytest.fail.Exception,
                       match=r"^rank death(.|\n)*rank 0 \(pid \d+\): rc -15 \(SIGTERM\), "
                             r"peak RSS \d+ KiB"):
        _all_ok(launch)


def test_rank_past_its_timeout_is_reported_and_its_session_killed(tmp_path):
    """A rank (and a child it started) still alive at the launch's
    timeout: the test fails as a timeout, with the rank's stderr, and no
    process of the rank's session survives the launch."""
    script = ("import subprocess, sys, time\n"
              "print('started', file=sys.stderr, flush=True)\n"
              "subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(120)'])\n"
              "time.sleep(120)\n")
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match=r"^timeout: a rank outlived 5 s") as failed:
        _launch(1, script, lambda r: [], tmp_path, lambda r: {}, timeout=5)
    assert time.monotonic() - start < 60
    message = str(failed.value)
    assert "attempt 1 of" in message and "\nstarted\n" in message
    sid = int(re.search(r"rank 0 \(pid (\d+)\): rc -9 \(SIGKILL\)", message).group(1))
    deadline = time.monotonic() + 10
    while _live_session(sid) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _live_session(sid) == []


def test_ranks_run_single_threaded_in_a_session_of_their_own(tmp_path):
    """Each rank's torch has one intra-op thread from its environment
    alone, and one of each once a rank script's head has run; stdin reads
    EOF from ``/dev/null``; the rank leads a session of its own.  Both
    rank scripts start with that head."""
    probe = ("import torch\nn = torch.get_num_threads()\n" + _RANK_HEAD
             + "import json, sys\nprint(json.dumps([n, torch.get_num_threads(), "
               "torch.get_num_interop_threads(), sys.stdin.read(), "
               "os.readlink('/proc/self/fd/0'), os.getsid(0) == os.getpid()]))\n")
    runs = _all_ok(_launch(2, probe, lambda r: [], tmp_path, lambda r: {}))
    assert [json.loads(out) for _, out, _ in runs] == [[1, 1, 1, "", os.devnull, True]] * 2
    assert _RANK.startswith(_RANK_HEAD) and _CLI.startswith(_RANK_HEAD)


def test_rank_ends_when_its_launcher_is_gone(tmp_path):
    """A rank whose starting process exits without ending it (as a test
    process killed with its process group does) ends by itself."""
    launcher = ("import os, subprocess, sys\n"
                "rank = subprocess.Popen([sys.executable, '-c', sys.argv[1]], "
                "start_new_session=True, stderr=subprocess.DEVNULL, "
                "env={**os.environ, 'TEST_LAUNCHER_PID': str(os.getpid())})\n"
                "print(rank.pid)\n")
    started = subprocess.run([sys.executable, "-c", launcher, _RANK_HEAD + "time.sleep(120)\n"],
                             capture_output=True, text=True, timeout=60, check=True)
    pid = int(started.stdout)
    deadline = time.monotonic() + 60
    while _live_session(pid) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _live_session(pid) == []
