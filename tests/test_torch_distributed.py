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

A process test fails, with every rank's stderr, when a rank dies or a
launch outlives its timeout; it never skips.  The coordinator ports
come from binding to port 0, and a launch is made again once only when
a rank's stderr says that its address was in use.
"""

import gzip
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

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
    """An empty working directory (no ``cfrk.json``) and no coordinator
    variables from around the test run."""
    monkeypatch.chdir(tmp_path)
    for name in _TRIPLET:
        monkeypatch.delenv(name, raising=False)


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
    coordinator, the port raises naming the three variables: no silent
    world of one.  Through the CLI, both packages raise ValueError."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, "
                                         "JAX_PROCESS_ID"):
        tdist.maybe_initialize_distributed(force=True)
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


def _free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def test_existing_group_is_left_alone_and_world_of_one_runs(monkeypatch, inputs):
    """A group that exists makes initialisation a no-op (False), with or
    without ``force``, and the CLI neither replaces nor destroys it; a
    world of one is the ordinary single-process run, to cfrk_tpu's
    bytes, and the CLI destroys the group it started."""
    import torch.distributed as dist

    port = _free_ports(1)[0]
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    argv = [inputs["plain"], "8", "--nonzero"]
    assert jax_main([argv[0], "j.cfrk", *argv[1:], "--devices", "1"]) == 0
    assert main([argv[0], "t.cfrk", *argv[1:], "--distributed", "--device", "cpu"]) == 0
    assert not dist.is_initialized()
    assert Path("t.cfrk").read_bytes() == Path("j.cfrk").read_bytes()
    assert not [p for p in os.listdir() if ".part" in p]

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_ports(1)[0]}",
                            rank=0, world_size=1)
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

# One rank: runs each leg's argv through the CLI's main in turn, each on
# its own coordinator port, and prints each leg's outcome as one JSON
# line at the end.  A leg whose group could not bind its port ends the
# rank at once, so that the launch is made again.
_RANK = """
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


def _taken(err: str) -> bool:
    return "address already in use" in err.lower()


def _launch(world: int, script: str, args, cwd: Path, env_of_rank) -> list:
    """``world`` processes of ``python -c script`` (rank i gets
    ``args(i)`` and the environment ``env_of_rank(i)``): returns each
    rank's (returncode, stdout, stderr).  A rank alive past the timeout
    fails the test with every rank's stderr; a rank that died because
    its coordinator port was taken ends the launch at once."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs, logs = [], []
    for rank in range(world):
        out, err = cwd / f"rank{rank}.out", cwd / f"rank{rank}.err"
        logs.append((out, err))
        with open(out, "w") as o, open(err, "w") as e:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, *args(rank)], cwd=cwd, stdout=o,
                stderr=e, env={**env, **env_of_rank(rank)}))
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                pytest.fail(f"a rank outlived {LAUNCH_TIMEOUT_S} s:\n" + "\n".join(
                    f"--- rank {r} ---\n{err.read_text()[-3000:]}"
                    for r, (_, err) in enumerate(logs)))
            if any(p.poll() not in (None, 0) and _taken(err.read_text())
                   for p, (_, err) in zip(procs, logs)):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [(p.returncode, out.read_text(), err.read_text())
            for p, (out, err) in zip(procs, logs)]


def _run_legs(world: int, legs: dict, cwd: Path) -> dict:
    """Every leg ({name: argv}) on ``world`` ranks, in one launch; a
    launch whose port was taken is made once more on fresh ports.
    Returns {name: [each rank's outcome]}."""
    for attempt in (0, 1):
        plan = json.dumps([[name, port, argv] for (name, argv), port
                           in zip(legs.items(), _free_ports(len(legs)))])
        runs = _launch(world, _RANK, lambda r: [str(r), str(world), plan], cwd,
                       lambda r: {})
        if attempt == 0 and any(_taken(err) for _, _, err in runs):
            continue
        bad = [(rank, rc, err[-3000:]) for rank, (rc, _, err) in enumerate(runs) if rc]
        assert not bad, f"ranks died: {bad}"
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


_CLI = "import sys\nfrom cfrk_tpu_torch.cli import main\nsys.exit(main(sys.argv[1:]))\n"


def _cli_ranks(world, argv, cwd, fault_of_rank) -> list:
    """One CLI run on ``world`` ranks, rank i armed with
    ``CFRK_FAULT_INJECT=fault_of_rank(i)`` where that is not None."""
    for attempt in (0, 1):
        port = _free_ports(1)[0]

        def env_of_rank(rank):
            env = {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                   "JAX_NUM_PROCESSES": str(world), "JAX_PROCESS_ID": str(rank)}
            if fault_of_rank(rank):
                env["CFRK_FAULT_INJECT"] = fault_of_rank(rank)
            return env

        runs = _launch(world, _CLI, lambda r: argv, cwd, env_of_rank)
        if attempt == 0 and any(_taken(err) for _, _, err in runs):
            continue
        return runs


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
    runs = _cli_ranks(2, argv, tmp_path, fault)
    assert all(rc != 0 for rc, _, _ in runs), [r[2][-2000:] for r in runs]
    assert "InjectedFault" in runs[1][2]
    if killed == "rank1":
        assert "InjectedFault" not in runs[0][2]
    assert not out.exists()
    assert (tmp_path / "o.cfrk.part1.ckpt.json").exists()
    runs = _cli_ranks(2, [*argv, "--resume"], tmp_path, lambda r: None)
    assert [rc for rc, _, _ in runs] == [0, 0], [r[2][-2000:] for r in runs]
    assert out.read_bytes() == jax_bytes["perread_bgzf"]
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("o.")) == ["o.cfrk"]


def _dealt_run(tmp_path, inputs, world: int, names: list, flags: list) -> list:
    """``--distributed`` with several inputs on ``world`` ranks into one
    ``--out-dir``: every rank exits 0, the directory holds one output an
    input, each the JAX CLI's bytes of that input alone.  Returns each
    rank's ``--stats`` line."""
    paths = [inputs[n] for n in names]
    out = tmp_path / "out"
    runs = _cli_ranks(world, [*paths, *flags, "--out-dir", str(out), "--distributed",
                              "--device", "cpu", "--stats"], tmp_path, lambda r: None)
    assert [rc for rc, _, _ in runs] == [0] * world, [r[2][-2000:] for r in runs]
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
