"""The user and validation tools of ``cfrk_tpu_torch/tools`` against the
JAX package's scripts in ``tools/``.

Each JAX tool runs in this process, loaded from ``tools/`` by path (the
scripts are not a package and are not edited); the port runs with
``--device cpu``, where every kernel wrapper takes its plain twin.
Tolerance: all exact.  The host-only tools (``make_synthetic``,
``query_spectrum``, ``reconstruct_fasta``) must give the JAX tools'
bytes and exit codes; the fuzzers must draw the JAX tools' trials for
one seed, and the port's rows of each trial must equal the JAX
package's on the same inputs; ``onchip_validate`` and ``scale_demo``
must write their records, every check ok.  Each test runs in its own
empty working directory, so that no ``cfrk.json`` supplies CLI flags.
"""

import argparse
import gzip
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cfrk_tpu_torch.cli import main as cli_main
from cfrk_tpu_torch.parallel import mesh as pmesh
from cfrk_tpu_torch.tools import (
    fuzz_cli,
    make_synthetic,
    onchip_fuzz,
    onchip_validate,
    query_spectrum,
    reconstruct_fasta,
    scale_demo,
    scaling_bench,
    sweep,
)

ROOT = Path(__file__).resolve().parent.parent
DATA = Path(__file__).parent / "data"
MANIFEST = json.loads((DATA / "goldens.json").read_text())


@pytest.fixture(autouse=True)
def _empty_cwd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


@pytest.fixture(autouse=True)
def _device_repeat():
    """A tool that sets ``parallel.mesh.repeat_devices`` sets it for its
    process; each test gets the setting back as it found it."""
    prev = pmesh.repeat_devices(None)
    pmesh.repeat_devices(prev)
    yield
    pmesh.repeat_devices(prev)


def _jax_tool(name: str):
    """``tools/<name>.py``, the JAX package's script, as a module."""
    path = ROOT / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(mod, argv: list, monkeypatch, capsys) -> tuple:
    """A JAX tool's ``main()`` (which reads ``sys.argv``) in process:
    (exit code, stdout)."""
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    capsys.readouterr()
    try:
        rc = mod.main()
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    return rc or 0, capsys.readouterr().out


def _run_port_main(fn, argv: list, capsys) -> tuple:
    capsys.readouterr()
    try:
        rc = fn(argv)
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    return rc or 0, capsys.readouterr().out


# ------------------------------------------------------------ make_synthetic


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind,flags", [
    ("fasta", []),
    ("fastq", ["--fastq"]),
    ("bgzf", ["--bgzf"]),
    ("gzip", ["--gzip"]),
    ("fasta_no_n", ["--n-rate", "0", "--mut-rate", "0.05"]),
])
def test_make_synthetic_bytes_equal_jax(tmp_path, monkeypatch, capsys, kind, flags, seed):
    """12 000 reads: two chunks of the draw loop and, with --bgzf, a
    1 MiB flush between bgzf blocks.  --gzip is compared decompressed
    (the gzip header holds an mtime)."""
    args = ["--reads", "12000", "--read-len", "90", "--genome-len", "4000",
            "--genomes", "3", "--seed", str(seed), *flags]
    want, got = tmp_path / "jax.out", tmp_path / "port.out"
    rc, _ = _run_jax_main(_jax_tool("make_synthetic"), [str(want), *args],
                          monkeypatch, capsys)
    assert rc == 0
    assert make_synthetic.main([str(got), *args]) == 0
    if kind == "gzip":
        assert gzip.decompress(got.read_bytes()) == gzip.decompress(want.read_bytes())
    else:
        assert got.read_bytes() == want.read_bytes()


def test_make_synthetic_refuses_what_jax_refuses(tmp_path):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        make_synthetic.main([str(tmp_path / "x"), "--gzip", "--bgzf"])
    with pytest.raises(SystemExit, match="exceeds --genome-len"):
        make_synthetic.main([str(tmp_path / "x"), "--read-len", "200", "--genome-len", "100"])


# ------------------------------------------------------------ query_spectrum


@pytest.fixture(scope="module")
def spectrum_artifacts(tmp_path_factory):
    """Every spectrum artifact the CLI writes, from one seeded FASTA at
    k=5 (dense) and k=6 (sparse), on the port's CPU route: 40 reads, so
    that some k-mers are absent."""
    d = tmp_path_factory.mktemp("spectra")
    rng = np.random.default_rng(3)
    fa = d / "r.fa"
    lut = np.frombuffer(b"ACGTN", np.uint8)
    fa.write_bytes(b"".join(
        b">r%d\n%s\n" % (i, lut[rng.choice(5, int(rng.integers(3, 120)),
                                           p=[0.3, 0.2, 0.2, 0.28, 0.02])].tobytes())
        for i in range(40)))
    paths = {}
    for name, argv in (
        ("npy", ["-k", "5", "--mode", "spectrum", "--spectrum-format", "npy"]),
        ("tsv", ["-k", "5", "--mode", "spectrum", "--spectrum-format", "tsv"]),
        ("cfrk", ["-k", "5", "--mode", "spectrum"]),
        ("kmers.tsv", ["-k", "6", "--mode", "sparse"]),
        ("kmers.tsv.gz", ["-k", "6", "--mode", "sparse"]),
    ):
        paths[name] = str(d / f"spect.{name}")
        assert cli_main([str(fa), "-o", paths[name], *argv, "--device", "cpu"]) == 0
    return paths


@pytest.mark.parametrize("artifact", ["npy", "tsv", "cfrk", "kmers.tsv", "kmers.tsv.gz"])
@pytest.mark.parametrize("query", [
    ["--stats"],
    ["--top", "5"],
    ["--hist"],
    ["--hist", "3"],
    ["--stats", "--top", "3", "--hist", "4"],
    ["present"],
    ["absent"],
    ["present", "absent"],
    ["wrong_length"],
    [],
])
def test_query_spectrum_matches_jax(spectrum_artifacts, monkeypatch, capsys, artifact, query):
    """stdout and exit code equal to the JAX tool's on every artifact
    kind: stats, top-N, the multiplicity histogram, a present k-mer (exit
    0), an absent one (exit 1), the wrong-length error and the
    nothing-to-do error (exit 2)."""
    path = spectrum_artifacts[artifact]
    k = 6 if artifact.startswith("kmers") else 5
    keys, counts, _ = query_spectrum.load_table(path)
    present = query_spectrum.decode_key(int(keys[np.argmax(counts)]), k)
    absent_code = next(c for c in range(4**k) if c not in set(keys.tolist()))
    words = {"present": present, "absent": query_spectrum.decode_key(absent_code, k),
             "wrong_length": "A" * (k + 1)}
    argv = [path, *(words.get(q, q) for q in query)]
    if not artifact.startswith("kmers"):
        argv += ["--k", str(k)]
    want = _run_jax_main(_jax_tool("query_spectrum"), argv, monkeypatch, capsys)
    got = _run_port_main(query_spectrum.main, argv, capsys)
    assert got == want
    if query == ["absent"]:
        assert got[0] == 1
    if query == ["present"]:
        assert got[0] == 0


# ------------------------------------------------------------ reconstruct_fasta


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_reconstruct_fasta_matches_jax_and_golden(tmp_path, monkeypatch, name):
    """The k=2 .cfrk of a golden input (the port's CLI on the CPU route)
    reconstructs to the JAX tool's FASTA bytes, and the port's CLI on
    that FASTA writes the golden sha256 again."""
    golden = tmp_path / "golden.cfrk"
    assert cli_main([str(DATA / name), str(golden), "2", "--device", "cpu"]) == 0
    assert hashlib.sha256(golden.read_bytes()).hexdigest() == MANIFEST["files"][name]["sha256"]
    jax_tool = _jax_tool("reconstruct_fasta")
    want, got = tmp_path / "jax.fa", tmp_path / "port.fa"
    assert jax_tool.reconstruct(str(golden), str(want)) == MANIFEST["files"][name]["n_reads"]
    assert reconstruct_fasta.main([str(golden), str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
    again = tmp_path / "again.cfrk"
    assert cli_main([str(got), str(again), "2", "--device", "cpu"]) == 0
    assert hashlib.sha256(again.read_bytes()).hexdigest() == MANIFEST["files"][name]["sha256"]


def test_reconstruct_fasta_refuses_other_k(tmp_path):
    from cfrk_tpu_torch.format import format_file_bytes

    path = tmp_path / "k3.cfrk"
    path.write_bytes(format_file_bytes(np.ones((2, 64), np.int64)))
    with pytest.raises(ValueError, match="k=2"):
        reconstruct_fasta.reconstruct(str(path), str(tmp_path / "out.fa"))


# ------------------------------------------------------------ onchip_fuzz


def test_onchip_fuzz_draws_jax_trials_and_matches_jax_rows(monkeypatch, capsys):
    """The JAX tool runs with its Pallas calls replaced by a recorder
    that returns the JAX package's XLA rows (``count_perread_sparse`` /
    ``_large``); the port draws the same configs and codes for the seed,
    and its rows (kernel route or tiled, on the CPU) equal the JAX rows
    of every trial.  Seed 1 draws a 23 635 bp row at k=20 first, past
    the kernel ceiling: the tiled route."""
    import cfrk_tpu.ops.pallas.rowsort as jax_rowsort
    from cfrk_tpu.ops.perread_sparse import (
        count_perread_sparse,
        count_perread_sparse_large,
    )

    seen = []

    def recorder(oracle):
        def call(x, k, canonical=False):
            out = oracle(x, k, canonical)
            seen.append((np.asarray(x), k, canonical, [np.asarray(a) for a in out]))
            return out
        return call

    monkeypatch.setattr(jax_rowsort, "rowsort_rle_pallas", recorder(count_perread_sparse))
    monkeypatch.setattr(jax_rowsort, "rowsort_rle_pallas_large",
                        recorder(count_perread_sparse_large))
    trials = 5
    rc, out = _run_jax_main(_jax_tool("onchip_fuzz"), ["--trials", str(trials), "--seed", "1"],
                            monkeypatch, capsys)
    assert rc == 0 and len(seen) == trials
    jax_cfgs = [json.loads(line.split(" ok ", 1)[1]) for line in out.splitlines()
                if line.startswith("# ")]
    rng = np.random.default_rng(1)
    routes = []
    for (x, k, canonical, want), jcfg in zip(seen, jax_cfgs):
        cfg, codes = onchip_fuzz.draw_trial(rng)
        assert cfg == jcfg
        assert np.array_equal(codes, x) and (k, canonical) == (cfg["k"], cfg["canonical"])
        got = onchip_fuzz.rows(torch.from_numpy(codes), cfg)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy().view(np.uint32), w.astype(np.uint32))
        routes.append(onchip_fuzz.route(cfg))
    assert routes[0] == "tiled" and "kernel" in routes


def test_onchip_fuzz_main_reports_routes(capsys):
    """40 trials of seed 0 on the CPU route: the twin against the route
    in every trial, four of them past the kernel ceiling."""
    assert onchip_fuzz.main(["--trials", "40", "--seed", "0", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["ok"] and rec["platform"] == "cpu" and rec["trials"] == 40
    assert rec["routes"] == {"kernel": 36, "tiled": 4}


def test_onchip_fuzz_catches_a_wrong_row(monkeypatch):
    """A route that differs from the twin in one cell fails the trial."""
    real = onchip_fuzz.rows

    def off_by_one(x, cfg):
        out = [a.clone() for a in real(x, cfg)]
        out[-1][0, 0] += 1
        return tuple(out)

    monkeypatch.setattr(onchip_fuzz, "rows", off_by_one)
    cfg, codes = onchip_fuzz.draw_trial(np.random.default_rng(0))
    with pytest.raises(AssertionError, match="differs"):
        onchip_fuzz.check_trial(cfg, codes, torch.device("cpu"))


# ------------------------------------------------------------ fuzz_cli


def test_fuzz_cli_draws_jax_configs(tmp_path, monkeypatch):
    """Three trials side by side from one seed: the port's run_trial
    (CPU route) returns the JAX run_trial's config dicts (no mesh)."""
    jax_fuzz = _jax_tool("fuzz_cli")
    runs = {"jax": lambda r, d: jax_fuzz.run_trial(r, d, use_mesh=False),
            "port": lambda r, d: fuzz_cli.run_trial(r, d, "cpu")}
    cfgs = {}
    for name, run in runs.items():
        rng = np.random.default_rng(1000)
        cfgs[name] = []
        for t in range(3):
            d = tmp_path / f"{name}{t}"
            d.mkdir()
            monkeypatch.chdir(d)
            cfgs[name].append(run(rng, str(d)))
    got, want = cfgs["port"], cfgs["jax"]
    assert got == want
    assert all(cfg["mesh"] == 0 for cfg in got)


def test_fuzz_cli_draws_jax_mesh_configs(tmp_path, monkeypatch):
    """With mesh trials drawn, three trials of seed 18 side by side: the
    JAX tool on conftest's 8 virtual devices, the port on the CPU
    repeated 8 times; the same config dicts, among them meshes of 2 and
    4 devices and a seqpar trial (``--impl sort`` on the spectrum), each
    output held to the numpy spec."""
    jax_fuzz = _jax_tool("fuzz_cli")
    pmesh.repeat_devices(8)
    runs = {"jax": lambda r, d: jax_fuzz.run_trial(r, d, use_mesh=True),
            "port": lambda r, d: fuzz_cli.run_trial(r, d, "cpu", use_mesh=True)}
    cfgs = {}
    for name, run in runs.items():
        rng = np.random.default_rng(18)
        cfgs[name] = []
        for t in range(3):
            d = tmp_path / f"{name}{t}"
            d.mkdir()
            monkeypatch.chdir(d)
            cfgs[name].append(run(rng, str(d)))
    got, want = cfgs["port"], cfgs["jax"]
    assert got == want
    assert [cfg["mesh"] for cfg in got] == [2, 4, 2]
    assert [cfg.get("seqpar") for cfg in got] == [False, True, True]


def test_fuzz_cli_mesh_campaign_on_cpu(capsys):
    """``--devices 8`` on the CPU: the campaign draws mesh and seqpar
    trials and counts them."""
    assert fuzz_cli.main(["--trials", "3", "--seed", "18", "--devices", "8",
                          "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["ok"] and rec["mesh_trials"] == {"2": 2, "4": 1}
    assert rec["seqpar_trials"] == 2
    assert pmesh.local_devices("cpu") == [torch.device("cpu")] * 8


@pytest.mark.parametrize("devices", [2, 7])
def test_fuzz_cli_refuses_a_mesh_campaign_below_8_devices(devices, capsys):
    with pytest.raises(SystemExit):
        fuzz_cli.main(["--trials", "1", "--devices", str(devices), "--device", "cpu"])
    assert "needs --devices 8 or more" in capsys.readouterr().err
    assert pmesh.local_devices("cpu") == [torch.device("cpu")]


def test_fuzz_cli_campaign_on_cpu(capsys):
    """A bounded port-only campaign: 12 trials, each output file parsed
    back and held to the numpy spec (exact)."""
    assert fuzz_cli.main(["--trials", "12", "--seed", "5", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["ok"] and rec["trials"] == 12 and sum(rec["modes"].values()) == 12


# ------------------------------------------------------------ onchip_validate


def test_onchip_validate_on_cpu(tmp_path, monkeypatch):
    """Every check ok on the CPU route and the artifact's schema; the
    production-batch check runs at 64 reads here (8192 reads of k=8
    dense rows are 2 GB of plain-route tables)."""
    monkeypatch.setattr(onchip_validate, "auto_batch_size", lambda: 64)
    out = tmp_path / "GPU_VALID.json"
    assert onchip_validate.main(["--out", str(out), "--device", "cpu"]) == 0
    rec = json.loads(out.read_text())
    assert {"platform", "device_kind", "card", "torch", "cuda", "timestamp", "checks",
            "launches", "ok"} <= set(rec)
    assert rec["ok"] is True and rec["platform"] == "cpu" and rec["card"] is None
    assert list(rec["checks"]) == list(onchip_validate.CHECKS)
    assert all(c["ok"] and c["wall_s"] >= 0 for c in rec["checks"].values())
    assert rec["checks"]["golden_byte_exact"]["sha256"] == {
        name: meta["sha256"] for name, meta in MANIFEST["files"].items()}
    assert rec["checks"]["auto_batch_capacity"]["batch"] == 64
    assert rec["checks"]["rowsort_kernel_parity"]["contig_128kb_tiles"] == 4
    # The CPU route launches no kernel.
    assert set(rec["launches"].values()) == {0}


def test_onchip_validate_failed_check_exits_1(tmp_path, monkeypatch):
    """A check that raises is recorded with its error, the other checks
    still run, ``ok`` is false and the exit code is 1."""
    def broken(device):
        raise AssertionError("planted")

    checks = {name: (lambda device: {"ran": True}) for name in onchip_validate.CHECKS}
    checks["spectrum_kernel_parity"] = broken
    monkeypatch.setattr(onchip_validate, "CHECKS", checks)
    out = tmp_path / "v.json"
    assert onchip_validate.main(["--out", str(out), "--device", "cpu"]) == 1
    rec = json.loads(out.read_text())
    assert rec["ok"] is False
    assert rec["checks"]["spectrum_kernel_parity"]["error"] == "AssertionError: planted"
    assert all(rec["checks"][name] == {"ok": True, "ran": True, "wall_s": rec["checks"][name]["wall_s"]}
               for name in checks if name != "spectrum_kernel_parity")


def test_mesh_probes_match_jax(tmp_path, monkeypatch, capsys):
    """The port's ``mesh_kernel_probes`` on the CPU returns the probes
    of the JAX tool's ``mesh_compiled_probes``, run in process on its
    one-device CPU mesh (``--skip-pallas``; the JAX tool's other
    row-sort parity check takes the XLA rows in place of the Pallas
    kernel, whose interpret mode would take minutes here).  The port's
    check sits where JAX's does: after the row-sort parity, before
    ``auto_batch_capacity``."""
    from cfrk_tpu.ops.pallas import rowsort as jax_rowsort
    from cfrk_tpu.ops.perread_sparse import (
        count_perread_sparse,
        count_perread_sparse_large,
    )

    def rows(x, k, canonical=False, checksum=False):
        idx, counts = count_perread_sparse(x, k, canonical)
        if not checksum:
            return idx, counts
        return idx, counts, (((counts & 3) + (idx & 3)) * (counts > 0)).sum()

    monkeypatch.setattr(jax_rowsort, "rowsort_rle_pallas", rows)
    monkeypatch.setattr(jax_rowsort, "rowsort_rle_pallas_large",
                        lambda x, k, canonical=False, **kw:
                        count_perread_sparse_large(x, k, canonical))
    out = tmp_path / "tpu.json"
    rc, _ = _run_jax_main(_jax_tool("onchip_validate"), ["--skip-pallas", "--out", str(out)],
                          monkeypatch, capsys)
    want = json.loads(out.read_text())["checks"]["mesh_compiled_probes"]
    assert rc == 0 and want["ok"]
    got = onchip_validate.mesh_kernel_probes(torch.device("cpu"))
    assert got == {"probes": want["probes"]}
    names = list(onchip_validate.CHECKS)
    assert names.index("mesh_kernel_probes") == names.index("rowsort_kernel_parity") + 1
    assert names[-1] == "auto_batch_capacity"


def test_mesh_probe_catches_a_wrong_shard(monkeypatch):
    """A sharded row sort that differs from the plain rows fails the
    check."""
    real = onchip_validate.count_perread_sparse_sharded

    def off_by_one(codes, k, mesh, **kw):
        out = [a.clone() for a in real(codes, k, mesh, **kw)]
        out[-1][0, 0] += 1
        return tuple(out)

    monkeypatch.setattr(onchip_validate, "count_perread_sparse_sharded", off_by_one)
    with pytest.raises(AssertionError, match="rowsort_mesh"):
        onchip_validate.mesh_kernel_probes(torch.device("cpu"))


# ------------------------------------------------------------ scaling_bench


@pytest.mark.parametrize("mode", ["perread", "rows", "spectrum"])
def test_scaling_bench_ladder_matches_jax(monkeypatch, capsys, mode):
    """``--cpu --reads-per-device 16 --steps 1``: the port on the CPU
    repeated 8 times gives the JAX tool's ladder on its 8 virtual
    devices, rung by rung: devices, reads and checksum."""
    argv = ["--cpu", "--mode", mode, "--reads-per-device", "16", "--steps", "1"]
    rc, out = _run_jax_main(_jax_tool("scaling_bench"), argv, monkeypatch, capsys)
    assert rc == 0
    want = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    rc, out = _run_port_main(scaling_bench.main, argv, capsys)
    assert rc == 0
    got = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    keys = ("devices", "mode", "k", "reads", "checksum")
    assert [[r[key] for key in keys] for r in got] == [[r[key] for key in keys] for r in want]
    assert [r["devices"] for r in got] == [1, 2, 4, 8]
    assert all(set(r) == set(w) for r, w in zip(got, want))
    assert scaling_bench.sharded_checksums(
        [torch.device("cpu")] * 8, mode, 8, 16, 150) == [
            (r["devices"], r["checksum"]) for r in want]


def test_scaling_bench_json_out(tmp_path, capsys):
    """The ``--json-out`` document: one run a mode (a second run of a
    mode replaces the first), the device record, and the label that a
    ladder of one device repeated is no performance measurement."""
    path = tmp_path / "scaling.json"
    for mode in ("rows", "spectrum", "rows"):
        assert scaling_bench.main(["--cpu", "--mode", mode, "--reads-per-device", "8",
                                   "--steps", "1", "--json-out", str(path)]) == 0
    doc = json.loads(path.read_text())
    assert [run["ladder"][0]["mode"] for run in doc["runs"]] == ["spectrum", "rows"]
    run = doc["runs"][1]
    assert run["spmd_validation_only"] is True and run["platform"] == "cpu"
    assert run["reads_per_device"] == 8 and run["devices"] == ["cpu"] * 8
    assert [r["reads"] for r in run["ladder"]] == [8, 16, 32, 64]
    assert run["ladder"][0]["efficiency_vs_1dev"] == 1.0


def test_scaling_bench_needs_the_card_without_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        scaling_bench.main(["--mode", "rows", "--steps", "1"])


# ------------------------------------------------------------ scale_demo


def test_scale_demo_on_cpu(tmp_path):
    """4000 reads in batches of 128 with a checkpoint every 2: the three
    legs, each child on the CPU route; the sparse child killed mid-run
    and resumed to the uninterrupted bytes; each leg's sha256 equal to
    the JAX package's CLI on the same file."""
    from cfrk_tpu.cli import main as jax_cli_main

    out = tmp_path / "GPU_SCALE.json"
    wd = tmp_path / "wd"
    assert scale_demo.main([
        "--reads", "4000", "--genome-len", "100000", "--workdir", str(wd),
        "--json-out", str(out), "--scale-check-reads", "0", "--batch-size", "128",
        "--checkpoint-every", "2", "--device", "cpu",
    ]) == 0
    rec = json.loads(out.read_text())
    assert rec["platform"] == "cpu" and rec["card"] is None and rec["nproc"] >= 1
    legs = rec["legs"]
    assert set(legs) == {"perread_k8_nonzero", "spectrum_k8", "sparse_k31_resume"}
    sparse = legs["sparse_k31_resume"]
    assert sparse["was_killed_midrun"] is True and sparse["byte_equal"] is True
    assert 0 < sparse["checkpoint_at_kill"]["reads_done"] < 4000
    fasta = wd / "reads_4000.fasta.bgz"
    for leg, argv in (("perread_k8_nonzero", ["-k", "8", "--nonzero"]),
                      ("spectrum_k8", ["-k", "8", "--mode", "spectrum"]),
                      ("sparse_k31_resume", ["-k", "31", "--canonical", "--mode", "sparse"])):
        want = tmp_path / f"{leg}.want"
        assert jax_cli_main([str(fasta), "-o", str(want), *argv, "--devices", "1"]) == 0
        rec_leg = legs[leg]["full"] if leg == "sparse_k31_resume" else legs[leg]
        assert rec_leg["sha256"] == hashlib.sha256(want.read_bytes()).hexdigest()
        assert rec_leg["bases_per_s"] > 0 and rec_leg["peak_rss_mb"] > 0
        assert rec_leg["stats"]["stages_s"]


def test_scale_demo_count_mass_and_model(tmp_path):
    """The scale check's two integrity numbers on a small file: the count
    column's sum and the N-rate model's valid windows."""
    fa = tmp_path / "r.fa.bgz"
    assert make_synthetic.main([str(fa), "--reads", "3000", "--genome-len", "5000",
                                "--n-rate", "0.02", "--bgzf"]) == 0
    out = tmp_path / "s.tsv"
    assert cli_main([str(fa), "-o", str(out), "-k", "31", "--mode", "sparse",
                     "--device", "cpu"]) == 0
    from cfrk_tpu_torch.io.fasta import read_fasta_encoded

    reads = read_fasta_encoded(fa)
    valid = sum(int(((np.convolve(r < 0, np.ones(31), "valid")) == 0).sum()) for r in reads)
    assert scale_demo.count_mass(str(out), chunk=1000) == valid
    assert scale_demo.valid_windows_per_read(str(fa), 31) * len(reads) == pytest.approx(valid)


# ------------------------------------------------------------ the device rule


@pytest.mark.parametrize("tool", [onchip_validate, onchip_fuzz, fuzz_cli, scale_demo])
def test_counting_tools_refuse_cuda_without_a_card(tool, tmp_path):
    """The counting tools default to the card; with no visible GPU they
    exit with an error instead of running the CPU route."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(["--workdir", str(tmp_path)] if tool is scale_demo else [])


# ------------------------------------------------------------ the sweep tool


def test_sweep_rewrites_only_the_named_constants_in_a_copy(tmp_path, monkeypatch):
    """A variant is a copy of the package whose source differs from the
    checkout's in the named constants alone; a name the source does not
    hold once, or an item that is not NAME=value, is refused."""
    monkeypatch.setattr(sweep, "WORK", tmp_path)
    constants = sweep.parse_variant("kLogKeys=2,kRegThreads=128")
    assert constants == {"kLogKeys": 2, "kRegThreads": 128}
    root = sweep.make_variant("rowsort.cu", constants, "v1")
    got = (root / "cfrk_tpu_torch" / "csrc" / "rowsort.cu").read_text().splitlines()
    own = (sweep.PKG / "csrc" / "rowsort.cu").read_text().splitlines()
    assert [(a, b) for a, b in zip(own, got) if a != b] == [
        ("constexpr int kLogKeys = 3;", "constexpr int kLogKeys = 2;"),
        ("constexpr int kRegThreads = 256;", "constexpr int kRegThreads = 128;"),
    ]
    assert len(got) == len(own)
    assert (root / "cfrk_tpu_torch" / "tools" / "rowsort_times.py").is_file()
    with pytest.raises(RuntimeError, match="kNoSuch not found once"):
        sweep.make_variant("rowsort.cu", {"kNoSuch": 1}, "v2")
    for bad in ("kLogKeys", "kLogKeys=x", "=3"):
        with pytest.raises(argparse.ArgumentTypeError):
            sweep.parse_variant(bad)
