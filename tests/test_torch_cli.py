"""The cfrk_tpu_torch CLI (``--device cpu``) against the goldens and
against cfrk_tpu's CLI bytes.

The whole per-read slice runs here: FASTA parse → batches → the plain
PyTorch route of the per-read sort + RLE → narrowed drain → formatter;
and the entry layer: stdin, multi-file runs into ``--out-dir``, the
``--stats`` line, ``--list-devices``, ``--profile``.  Tolerance: exact
equality of the output bytes.  Each test runs in its own empty working
directory, so that no ``cfrk.json`` around the checkout supplies flags.
"""

import gzip
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cfrk_tpu.cli import main as jax_main
from cfrk_tpu_torch.cli import main

ROOT = Path(__file__).resolve().parent.parent
DATA = Path(__file__).parent / "data"
MANIFEST = json.loads((DATA / "goldens.json").read_text())


@pytest.fixture(autouse=True)
def _empty_cwd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_module_entry_matches_golden_k2(tmp_path, name):
    """``python -m cfrk_tpu_torch <fasta> <out> 2`` — the reference's
    positional form — writes the golden bytes."""
    out = tmp_path / "out.cfrk"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    subprocess.run(
        [sys.executable, "-m", "cfrk_tpu_torch", str(DATA / name), str(out),
         str(MANIFEST["k"]), "--device", "cpu"],
        cwd=tmp_path, env=env, check=True, timeout=300,
    )
    digest = hashlib.sha256(out.read_bytes()).hexdigest()
    assert digest == MANIFEST["files"][name]["sha256"]


def _prefix_fasta(tmp_path, name, n_reads):
    """The first reads of a reconstructed golden FASTA, as plain FASTA."""
    recs = gzip.decompress((DATA / name).read_bytes()).split(b">")[1 : n_reads + 1]
    path = tmp_path / f"head_{name[:-3]}"
    path.write_bytes(b"".join(b">" + r for r in recs))
    return str(path)


def _both(tmp_path, inp, *flags, jax_flags=()):
    """Output bytes of the port (--device cpu) and of cfrk_tpu's CLI."""
    a, b = tmp_path / "torch.cfrk", tmp_path / "jax.cfrk"
    assert main([inp, str(a), *flags, "--device", "cpu"]) == 0
    assert jax_main([inp, str(b), *flags, *jax_flags]) == 0
    return a.read_bytes(), b.read_bytes()


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
@pytest.mark.parametrize(
    "flags",
    [("8", "--nonzero"), ("31", "--canonical", "--nonzero"), ("12", "--nonzero")],
    ids=["k8_nonzero", "k31_canonical", "k12_nonzero"],
)
def test_nonzero_rows_match_jax_cli(tmp_path, name, flags):
    got, want = _both(tmp_path, str(DATA / name), *flags)
    assert got == want and got


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
@pytest.mark.parametrize("canonical", [False, True])
def test_dense_k8_rows_match_jax_cli(tmp_path, name, canonical):
    inp = _prefix_fasta(tmp_path, name, 24)
    flags = ["-k", "8"] + (["--canonical"] if canonical else [])
    got, want = _both(tmp_path, inp, *flags)
    assert got == want and got.count(b"\n") == 23


def test_fastq_min_qual_batches_and_gz_output(tmp_path):
    fq = tmp_path / "r.fastq"
    fq.write_bytes(
        b"@a\nACGTNACGTTAGGA\n+\nIIII#II!IIIIII\n@b\nggccaattgg\n+\n55555I5555\n"
        b"@c\nAC\n+\nII\n"
    )
    got, want = _both(tmp_path, str(fq), "3", "--min-qual", "20",
                      "--batch-size", "2", "--max-len", "16")
    assert got == want
    out = tmp_path / "o.cfrk.gz"
    assert main([str(fq), str(out), "3", "--min-qual", "20", "--device", "cpu"]) == 0
    assert gzip.decompress(out.read_bytes()) == got


def test_empty_input_and_default_output_name(tmp_path, monkeypatch):
    empty = tmp_path / "none.fa"
    empty.write_bytes(b"")
    monkeypatch.chdir(tmp_path)
    assert main([str(empty), "-k", "4", "--device", "cpu"]) == 0
    assert (tmp_path / "none.cfrk").read_bytes() == b""


def test_stats_line(tmp_path, capsys):
    out = tmp_path / "o.cfrk"
    assert main([str(DATA / "seq2.fasta.gz"), str(out), "2", "--device", "cpu",
                 "--stats"]) == 0
    line = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert line["reads"] == MANIFEST["files"]["seq2.fasta.gz"]["n_reads"]
    assert set(line) == {"files", "reads", "k", "mode", "wall_s"}
    assert (line["files"], line["k"], line["mode"]) == (1, 2, "perread")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize(
    "argv,message",
    [
        (["--tp", "2"], "^1 devices not divisible by tp=2$"),
        (["--devices=2"], r"^--devices 2 but only 1 addressable \(use --list-devices\)$"),
        (["--distributed"], None),
        (["--impl", "scatter", "--seqpar"], None),
    ],
)
def test_unported_flags_fail_clearly(tmp_path, monkeypatch, argv, message):
    """On ``--device cpu`` (one device) a mesh value that needs more
    devices fails with the JAX CLI's words; ``--seqpar`` over the one
    device writes cfrk_tpu's bytes (which runs it over its 8); and
    ``--distributed`` with several inputs in a group of one process runs
    them all, each to the JAX CLI's bytes of that input."""
    fa = str(DATA / "seq2.fasta.gz")
    if message is not None:
        with pytest.raises(SystemExit, match=message):
            main([fa, str(tmp_path / "o.cfrk"), "2", "--device", "cpu", *argv])
        return
    if "--distributed" not in argv:
        got, want = _both(tmp_path, fa, "3", *argv)
        assert got == want and got
        return
    import torch.distributed as dist

    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    inputs = [fa, str(DATA / "seq1.fasta.gz")]
    assert main([*inputs, "-k", "2", "--out-dir", "parts", "--device", "cpu",
                 *argv]) == 0
    assert not dist.is_initialized()
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    assert jax_main([*inputs, "-k", "2", "--out-dir", "jparts"]) == 0
    for name in ("seq2.cfrk", "seq1.cfrk"):
        got = (tmp_path / "parts" / name).read_bytes()
        assert got == (tmp_path / "jparts" / name).read_bytes() and got


@pytest.mark.parametrize(
    "flags",
    [("--devices", "1"), ("--devices", "0"), ("--tp", "1"), ("--slack", "3"),
     ("--devices", "1", "--tp", "1", "--slack", "2.0")],
    ids=["devices1", "devices0", "tp1", "slack3", "all"],
)
@pytest.mark.parametrize("mode", ["perread", "sparse"])
def test_one_device_scale_out_values_match_jax_cli(tmp_path, flags, mode):
    """The values that mean one device run as without the flag, to
    cfrk_tpu's bytes (``--slack`` is read only by a sparse mesh).  The
    JAX CLI sees 8 devices here, so it is given ``--devices 1`` where the
    flags leave its device count at its default of all of them."""
    inp = _prefix_fasta(tmp_path, "seq2.fasta.gz", 30)
    argv = ["8", "--nonzero"] if mode == "perread" else ["12", "--mode", "sparse"]
    got, want = _both(tmp_path, inp, *argv, *flags,
                      jax_flags=() if "--devices" in flags else ("--devices", "1"))
    assert got == want and got


def test_one_device_scale_out_config_matches_jax_cli(tmp_path):
    """A ``cfrk.json`` with the one-device values runs too."""
    inp = _prefix_fasta(tmp_path, "seq1.fasta.gz", 30)
    (tmp_path / "cfrk.json").write_text(json.dumps(
        {"devices": 1, "tp": 1, "slack": 3.0, "seqpar": False, "distributed": False}))
    got, want = _both(tmp_path, inp, "8", "--nonzero")
    assert got == want and got


@pytest.mark.parametrize(
    "flags,message",
    [
        (["--devices", "9"], r"^--devices 9 but only 8 addressable \(use --list-devices\)$"),
        (["--devices", "6", "--tp", "4"], "^6 devices not divisible by tp=4$"),
        (["--seqpar", "--tp", "2"], "^--seqpar and --tp are mutually exclusive$"),
        (["--mode", "sparse", "--devices", "2", "--tp", "2"],
         "^--mode sparse shards keys over one axis; use --tp 1$"),
    ],
    ids=["devices_above_visible", "tp_not_dividing", "seqpar_and_tp", "sparse_tp"],
)
def test_mesh_errors_match_jax_cli_on_eight_devices(tmp_path, eight_cpus, flags, message):
    """Where cfrk_tpu's ``_build_mesh`` refuses, the port refuses in its
    words, over the port's local devices: 8 CPU devices here
    (``local_devices`` patched), as the JAX CLI sees 8 virtual devices
    under tests/conftest.py."""
    fa = str(DATA / "seq2.fasta.gz")
    for cli_main, extra in ((main, ["--device", "cpu"]), (jax_main, [])):
        with pytest.raises(SystemExit, match=message):
            cli_main([fa, str(tmp_path / "o.cfrk"), "2", *flags, *extra])


@pytest.fixture
def eight_cpus(monkeypatch):
    """The port's local devices: 8 CPU devices, as the JAX package has 8
    virtual host devices under tests/conftest.py (``--device cpu`` then
    defaults to a mesh over all 8, as the JAX CLI does)."""
    import torch

    from cfrk_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "local_devices",
                        lambda device: [torch.device("cpu")] * 8)


@pytest.mark.parametrize(
    "flags,flag",
    [(["--devices", "2"], "--devices"), (["--devices", "8"], "--devices"),
     (["--devices", "4", "--tp", "2"], "--tp"), (["--seqpar"], "--seqpar"),
     (["--devices", "1", "--seqpar"], "--seqpar")],
    ids=["devices2", "devices8", "tp2_of_4", "seqpar", "seqpar_one_device"],
)
def test_mesh_values_are_not_yet_ported(tmp_path, eight_cpus, flags, flag):
    """Every value that builds a mesh writes cfrk_tpu's bytes on 8
    devices: the per-read rows (``--impl scatter`` under ``--seqpar``,
    whose dense position-sharded path the default route refuses) and the
    dense spectrum."""
    fa = _prefix_fasta(tmp_path, "seq2.fasta.gz", 40)
    impl = ["--impl", "scatter"] if flag == "--seqpar" else []
    got, want = _both(tmp_path, fa, "5", *impl, *flags)
    assert got == want and got
    for name, cli_main, extra in (("t.spectrum", main, ["--device", "cpu"]),
                                  ("j.spectrum", jax_main, [])):
        assert cli_main([fa, "-o", str(tmp_path / name), "-k", "4", "--mode",
                         "spectrum", *flags, *extra]) == 0
    spec = (tmp_path / "t.spectrum").read_bytes()
    assert spec == (tmp_path / "j.spectrum").read_bytes() and spec


@pytest.mark.parametrize(
    "argv",
    [
        ["--mode", "sparse", "--stream"],
        ["--mode", "sparse", "--resume"],
        ["--stream", "--mem-budget-mb", "64"],
        ["--mode", "sparse", "--mem-budget-mb", "64"],
    ],
    ids=["sparse_stream", "sparse_resume", "stream_budget", "sparse_budget"],
)
def test_sparse_stream_flags_match_jax_cli(tmp_path, argv):
    """The flags of the sparse streaming slice write cfrk_tpu's bytes:
    ``--mode sparse --stream`` (and ``--resume`` with no checkpoint, a
    fresh streamed run); ``--mem-budget-mb`` is read only by a streamed
    sparse run at k >= 11 and changes no byte anywhere."""
    fa = _prefix_fasta(tmp_path, "seq2.fasta.gz", 60)
    k = "17" if "sparse" in argv else "2"
    a, b = tmp_path / "torch.out", tmp_path / "jax.out"
    assert main([fa, "-o", str(a), "-k", k, *argv, "--batch-size", "16",
                 "--device", "cpu"]) == 0
    assert jax_main([fa, "-o", str(b), "-k", k, *argv, "--batch-size", "16",
                     "--devices", "1"]) == 0
    assert a.read_bytes() == b.read_bytes() and a.read_bytes()
    assert not list(tmp_path.glob("*.ckpt.json*"))


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
@pytest.mark.parametrize("nonzero", [False, True], ids=["dense", "nonzero"])
@pytest.mark.parametrize(
    "impl,k", [("compare", "3"), ("matmul", "4"), ("scatter", "6"), ("pallas", "5"),
               ("host", "5")],
)
def test_dense_api_impl_rows_match_jax_cli(tmp_path, name, nonzero, impl, k):
    """``--impl`` other than auto runs the dense per-read API
    (count_file → CfrkWriter(nonzero=...)), as the JAX CLI does."""
    inp = _prefix_fasta(tmp_path, name, 24)
    flags = [k, "--impl", impl, "--canonical"] + (["--nonzero"] if nonzero else [])
    got, want = _both(tmp_path, inp, *flags, "--batch-size", "10")
    assert got == want and got.count(b"\n") == 23


def test_dense_api_k8_and_gz_match_jax_cli(tmp_path):
    """k=8 through the kernel's route, to a gzipped output."""
    inp = _prefix_fasta(tmp_path, "seq2.fasta.gz", 12)
    a, b = tmp_path / "torch.cfrk.gz", tmp_path / "jax.cfrk.gz"
    for nonzero in ([], ["--nonzero"]):
        assert main([inp, str(a), "8", "--impl", "pallas", *nonzero, "--device", "cpu"]) == 0
        assert jax_main([inp, str(b), "8", "--impl", "pallas", *nonzero]) == 0
        assert gzip.decompress(a.read_bytes()) == gzip.decompress(b.read_bytes())


def test_dense_api_k_above_8_routing(tmp_path):
    """Past k=8 an explicit --impl with --nonzero takes the sparse rows
    (bytes equal to the JAX CLI); without --nonzero both refuse."""
    fa = str(DATA / "seq2.fasta.gz")
    got, want = _both(tmp_path, fa, "9", "--nonzero", "--impl", "scatter")
    assert got == want and got
    for cli_main in (main, jax_main):
        with pytest.raises(SystemExit, match="requires --nonzero"):
            cli_main([fa, str(tmp_path / "o.cfrk"), "9", "--impl", "pallas"])


def test_argument_errors(tmp_path):
    fa = str(DATA / "seq2.fasta.gz")
    out = str(tmp_path / "o.cfrk")
    with pytest.raises(SystemExit, match="requires --nonzero"):
        main([fa, out, "9", "--device", "cpu"])
    with pytest.raises(SystemExit, match="out of range"):
        main([fa, out, "32", "--device", "cpu"])
    with pytest.raises(SystemExit, match="k is required"):
        main([fa, "-o", out, "--device", "cpu"])
    with pytest.raises(SystemExit, match="input not found"):
        main([str(tmp_path / "missing.fa"), out, "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="multiple inputs require --out-dir"):
        main([fa, fa, "-k", "2", "--device", "cpu"])


def _both_spectrum(tmp_path, inp, out_name, *flags):
    """Output bytes of the port (--device cpu) and of cfrk_tpu's CLI for
    a spectrum mode, written to ``out_name`` (``.gz`` decompressed)."""
    a, b = tmp_path / "torch" / out_name, tmp_path / "jax" / out_name
    a.parent.mkdir(exist_ok=True)
    b.parent.mkdir(exist_ok=True)
    assert main([inp, "-o", str(a), *flags, "--device", "cpu"]) == 0
    assert jax_main([inp, "-o", str(b), *flags]) == 0
    read = (lambda p: gzip.decompress(p.read_bytes())) if out_name.endswith(".gz") \
        else (lambda p: p.read_bytes())
    return read(a), read(b)


@pytest.mark.parametrize("fmt", ["cfrk", "tsv", "npy", "hist"])
@pytest.mark.parametrize(
    "flags",
    [("-k", "5"), ("-k", "6", "--canonical", "--impl", "scatter"),
     ("-k", "4", "--impl", "matmul", "--min-count", "3"),
     ("-k", "7", "--impl", "pallas"), ("-k", "9", "--impl", "sort", "--canonical")],
    ids=["k5_auto", "k6_canonical_scatter", "k4_matmul_min3", "k7_pallas",
         "k9_sort_canonical"],
)
def test_spectrum_mode_matches_jax_cli(tmp_path, fmt, flags):
    inp = str(DATA / "seq2.fasta.gz")
    got, want = _both_spectrum(tmp_path, inp, "out.spec", *flags,
                               "--mode", "spectrum", "--spectrum-format", fmt)
    assert got == want and got


@pytest.mark.parametrize("fmt", ["tsv", "hist"])
@pytest.mark.parametrize("flags", [("-k", "9"), ("-k", "10", "--canonical")],
                         ids=["k9", "k10_canonical"])
def test_spectrum_k9_k10_routes_match_jax_cli(tmp_path, fmt, flags):
    """k = 9 and 10, where ``auto`` on CUDA takes the histogram kernel
    and not the sorted route: ``auto`` and the kernel route (its plain
    twin here) write the JAX CLI's bytes."""
    inp = str(DATA / "seq2.fasta.gz")
    mode = ("--mode", "spectrum", "--spectrum-format", fmt)
    got, want = _both_spectrum(tmp_path, inp, "out.spec", *flags, *mode)
    assert got == want and got
    kernel = tmp_path / "kernel.spec"
    assert main([inp, "-o", str(kernel), *flags, *mode, "--impl", "pallas",
                 "--device", "cpu"]) == 0
    assert kernel.read_bytes() == want


@pytest.mark.parametrize("fmt", ["tsv", "npy", "hist"])
def test_spectrum_gz_outputs_match_jax_cli(tmp_path, fmt):
    inp = _prefix_fasta(tmp_path, "seq1.fasta.gz", 30)
    got, want = _both_spectrum(tmp_path, inp, "out.spec.gz", "-k", "6",
                               "--mode", "spectrum", "--spectrum-format", fmt,
                               "--min-count", "2")
    assert got == want and got


@pytest.mark.parametrize("fmt", ["tsv", "hist", "cfrk"])
@pytest.mark.parametrize(
    "flags",
    [("-k", "31", "--canonical"), ("-k", "21", "--min-count", "2"),
     ("-k", "12", "--canonical", "--min-count", "3")],
    ids=["k31_canonical", "k21_min2", "k12_canonical_min3"],
)
def test_sparse_mode_matches_jax_cli(tmp_path, fmt, flags):
    """--mode sparse writes hist, or KMER<TAB>count tsv for any other
    --spectrum-format (cfrk included), as the JAX CLI does."""
    inp = str(DATA / "seq1.fasta.gz")
    got, want = _both_spectrum(tmp_path, inp, "out.kmers.tsv.gz", *flags,
                               "--mode", "sparse", "--spectrum-format", fmt)
    assert got == want and got


def test_int64_count_in_the_cfrk_spectrum_row(tmp_path):
    """A bin of 2**31 or more windows formats as its int64 value, as the
    JAX CLI's writer does."""
    from cfrk_tpu import cli as jcli
    from cfrk_tpu_torch import cli as tcli

    table = np.arange(4**3, dtype=np.int64) * 3
    table[5] = 2**31
    table[63] = 2**40 + 7
    a, b = tmp_path / "a.spectrum", tmp_path / "b.spectrum"
    tcli._write_spectrum(str(a), table, "cfrk")
    jcli._write_spectrum(str(b), table, "cfrk")
    assert a.read_bytes() == b.read_bytes()
    assert b"5:2147483648 " in a.read_bytes()


@pytest.mark.parametrize(
    "mode,flags,suffix",
    [("perread", (), ".cfrk"), ("spectrum", (), ".spectrum"),
     ("sparse", ("--canonical",), ".kmers.tsv")],
)
def test_default_output_suffixes(tmp_path, monkeypatch, mode, flags, suffix):
    monkeypatch.chdir(tmp_path)
    assert main([str(DATA / "seq2.fasta.gz"), "-k", "3", "--mode", mode,
                 *flags, "--device", "cpu"]) == 0
    assert (tmp_path / f"seq2{suffix}").stat().st_size > 0


def test_spectrum_argument_errors(tmp_path):
    """The JAX CLI's messages for k > 15 in the dense spectrum and for
    --impl sort outside it."""
    fa = str(DATA / "seq2.fasta.gz")
    out = str(tmp_path / "o")
    for cli_main in (main, jax_main):
        with pytest.raises(SystemExit, match="dense spectrum needs k <= 15"):
            cli_main([fa, "-o", out, "-k", "16", "--mode", "spectrum"])
        for mode in ("sparse", "perread"):
            with pytest.raises(SystemExit, match="only applies to --mode spectrum"):
                cli_main([fa, "-o", out, "-k", "5", "--mode", mode, "--impl", "sort"])


def test_device_cuda_without_gpu_refuses(tmp_path):
    """``--device cuda`` never carries on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    out = tmp_path / "o.cfrk"
    with pytest.raises(SystemExit, match="no CUDA device is visible"):
        main([str(DATA / "seq2.fasta.gz"), str(out), "2"])
    assert not out.exists()


@pytest.mark.parametrize(
    "flags",
    [("8",), ("8", "--nonzero"), ("31", "--canonical", "--nonzero")],
    ids=["k8_dense", "k8_nonzero", "k31_canonical"],
)
def test_stage_breakdown_writes_the_cli_bytes(tmp_path, capsys, flags):
    """The stage-breakdown tool runs the main path's calls one by one:
    its output file equals the CLI's, and on the CPU it reports host
    stages only."""
    from cfrk_tpu_torch.tools.stage_breakdown import main as breakdown_main

    inp = _prefix_fasta(tmp_path, sorted(MANIFEST["files"])[0], 40)
    a, b = tmp_path / "cli.cfrk", tmp_path / "breakdown.cfrk"
    assert main([inp, str(a), *flags, "--device", "cpu"]) == 0
    capsys.readouterr()
    assert breakdown_main([inp, str(b), *flags, "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert b.read_bytes() == a.read_bytes()
    assert res["reads"] == 40 and res["batches"] == 1
    assert set(res["host_s"]) == {"parse", "pad", "h2d", "rows", "drain", "format", "wall"}
    assert res["device_ms"] is None and res["device_busy_share"] is None


@pytest.mark.parametrize(
    "flags", [("8", "--nonzero", "--impl", "pallas"), ("4", "--impl", "pallas"),
              ("5", "--impl", "host", "--canonical")],
    ids=["k8_nonzero_pallas", "k4_pallas", "k5_host_canonical"],
)
def test_stage_breakdown_dense_api_writes_the_cli_bytes(tmp_path, capsys, flags):
    """The breakdown's dense per-read route: same bytes as the CLI, its
    stages named, host stages only on the CPU."""
    from cfrk_tpu_torch.tools.stage_breakdown import main as breakdown_main

    inp = _prefix_fasta(tmp_path, sorted(MANIFEST["files"])[0], 40)
    a, b = tmp_path / "cli.cfrk", tmp_path / "breakdown.cfrk"
    assert main([inp, str(a), *flags, "--device", "cpu"]) == 0
    capsys.readouterr()
    assert breakdown_main([inp, str(b), *flags, "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert b.read_bytes() == a.read_bytes() and a.read_bytes()
    assert res["route"] == "dense_rows" and res["reads"] == 40
    assert set(res["host_s"]) == {"parse", "pad", "h2d", "kernel", "d2h", "unpack",
                                  "format", "wall"}
    assert res["device_ms"] is None and res["device_busy_share"] is None


@pytest.mark.parametrize(
    "flags,route,stages",
    [
        (("-k", "6", "--mode", "spectrum"), "dense", {"spectrum"}),
        (("-k", "5", "--mode", "spectrum", "--impl", "sort", "--spectrum-format", "tsv"),
         "sorted", {"h2d", "rows", "drain", "fold"}),
        (("-k", "31", "--canonical", "--mode", "sparse"), "sorted",
         {"h2d", "rows", "drain", "fold"}),
    ],
    ids=["spectrum_dense", "spectrum_sort_tsv", "sparse_k31"],
)
def test_stage_breakdown_spectrum_modes_write_the_cli_bytes(tmp_path, capsys, flags,
                                                           route, stages):
    """The breakdown runs the spectrum drivers' calls one by one: same
    bytes as the CLI, its route named, host stages only on the CPU."""
    from cfrk_tpu_torch.tools.stage_breakdown import main as breakdown_main

    inp = _prefix_fasta(tmp_path, sorted(MANIFEST["files"])[0], 40)
    a, b = tmp_path / "cli.out", tmp_path / "breakdown.out"
    assert main([inp, "-o", str(a), *flags, "--device", "cpu"]) == 0
    capsys.readouterr()
    k = flags[1]
    rest = [f for f in flags if f not in ("-k", k)]
    assert breakdown_main([inp, str(b), k, *rest, "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert b.read_bytes() == a.read_bytes() and a.read_bytes()
    assert res["route"] == route and res["reads"] == 40
    assert set(res["host_s"]) == {"parse", "pad", "format", "wall"} | stages | (
        {"drain"} if route == "dense" else set())
    assert res["device_ms"] is None and res["device_busy_share"] is None


def test_leg_breakdowns_runs_each_kind_from_the_tree(tmp_path, monkeypatch, capsys):
    """The per-leg tool runs an in-memory leg through stage_breakdown and
    a streamed leg through the CLI's ``--stats`` line, each in a process
    started from the given tree's root, and appends one JSON line a run
    to ``--out``."""
    from cfrk_tpu_torch.tools import leg_breakdowns as L

    for leg in ("k8_nonzero", "spectrum_k8_stream"):
        kind, name, args = L.LEGS[leg]
        monkeypatch.setitem(L.LEGS, leg, (kind, name, [*args, "--device", "cpu"]))
    work = tmp_path / "work"
    work.mkdir()
    src = Path(_prefix_fasta(tmp_path, sorted(MANIFEST["files"])[0], 30)).read_bytes()
    for name in ("r150.fa", "r1m.fa"):
        (work / name).write_bytes(src)
    out = tmp_path / "legs.jsonl"
    assert L.main(["--tree", str(ROOT), "--work", str(work), "--legs",
                   "k8_nonzero,spectrum_k8_stream", "--out", str(out)]) == 0
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert capsys.readouterr().out.count("\n") == 2
    assert [r["leg"] for r in lines] == ["k8_nonzero", "spectrum_k8_stream"]
    assert lines[0]["result"]["reads"] == 30 and "format" in lines[0]["result"]["host_s"]
    assert "parse_wait" in lines[1]["result"]["stages_s"]
    assert not list(work.glob("breakdown_*"))
    with pytest.raises(SystemExit):
        L.main(["--tree", str(ROOT), "--legs", "no_such_leg"])


def test_int64_cfrk_spectrum_row_to_gz_is_compressed(tmp_path):
    """A `.gz` path always holds gzip bytes, int64 counts included; the
    JAX CLI writes that row uncompressed (cli.py:373-377, ROADMAP
    Queue 3), so the port is held to its decompressed bytes."""
    from cfrk_tpu import cli as jcli
    from cfrk_tpu_torch import cli as tcli

    table = np.zeros(4**2, dtype=np.int64)
    table[3] = 2**33
    a, b = tmp_path / "a.spectrum.gz", tmp_path / "b.spectrum.gz"
    tcli._write_spectrum(str(a), table, "cfrk")
    jcli._write_spectrum(str(b), table, "cfrk")
    assert gzip.decompress(a.read_bytes()) == b.read_bytes()


# ------------------------------------------------------------- streaming


@pytest.mark.parametrize(
    "flags",
    [("2",), ("8", "--nonzero"), ("8", "--nonzero", "--packed"), ("6", "--packed"),
     ("31", "--canonical", "--nonzero"), ("5", "--impl", "scatter", "--canonical"),
     ("8", "--nonzero", "--checkpoint-every", "3")],
    ids=["k2_dense", "k8_nonzero", "k8_nonzero_packed", "k6_packed", "k31_canonical",
         "k5_scatter_canonical", "k8_checkpoint_every3"],
)
def test_stream_rows_match_jax_cli_and_one_shot(tmp_path, flags):
    """``--stream`` writes the bytes of cfrk_tpu's ``--stream`` and of the
    port's own in-memory run (``--packed`` is a streaming flag: the
    in-memory run goes without it), and leaves no checkpoint.  The JAX
    CLI runs on one device, as the port does."""
    inp = _prefix_fasta(tmp_path, "seq1.fasta.gz", 40)
    got, want = _both(tmp_path, inp, *flags, "--stream", "--batch-size", "16",
                      jax_flags=("--devices", "1"))
    assert got == want and got.count(b"\n") == 39
    shot = tmp_path / "shot.cfrk"
    one_shot = [f for f in flags if f != "--packed"]
    if "--checkpoint-every" in one_shot:
        one_shot = one_shot[:one_shot.index("--checkpoint-every")]
    assert main([inp, str(shot), *one_shot, "--batch-size", "16", "--device", "cpu"]) == 0
    assert shot.read_bytes() == got
    assert not list(tmp_path.glob("*.ckpt.json*"))


@pytest.mark.parametrize("first", ["jax", "torch"])
@pytest.mark.parametrize(
    "flags", [("8", "--nonzero"), ("4",), ("7", "--packed", "--nonzero")],
    ids=["k8_nonzero", "k4_dense", "k7_packed_nonzero"],
)
def test_resume_flag_finishes_a_killed_stream_of_either_cli(tmp_path, capsys, first, flags):
    """A ``--stream`` run of one CLI killed after its third batch is
    finished by the other CLI's ``--resume`` (which implies ``--stream``)
    to the bytes of an uninterrupted run; ``--stats`` prints the
    streamed run's metrics line."""
    from cfrk_tpu.runtime import faults as jfaults
    from cfrk_tpu_torch.runtime import faults

    inp = _prefix_fasta(tmp_path, "seq2.fasta.gz", 40)
    full, out = tmp_path / "full.cfrk", tmp_path / "x.cfrk"
    common = [*flags, "--batch-size", "8"]
    assert main([inp, str(full), *common, "--stream", "--device", "cpu"]) == 0
    clis = {"jax": (jax_main, jfaults, ["--devices", "1"]),
            "torch": (main, faults, ["--device", "cpu"])}
    start, start_faults, start_extra = clis[first]
    finish, _, finish_extra = clis["torch" if first == "jax" else "jax"]
    start_faults.arm("batch-written", 3)
    try:
        with pytest.raises(start_faults.InjectedFault):
            start([inp, str(out), *common, "--stream", *start_extra])
    finally:
        start_faults.disarm()
    assert (tmp_path / "x.cfrk.ckpt.json").exists()
    assert out.read_bytes() != full.read_bytes()
    capsys.readouterr()
    assert finish([inp, str(out), *common, "--resume", "--stats", *finish_extra]) == 0
    assert out.read_bytes() == full.read_bytes()
    assert not list(tmp_path.glob("x.cfrk.ckpt.json*"))
    line, summary = map(json.loads, capsys.readouterr().err.strip().splitlines()[-2:])
    assert (line["reads"], line["batches"], line["mode"]) == (24, 3, "perread")
    assert {"parse_wait", "dispatch", "materialize", "write", "checkpoint"} == set(
        line["stages_s"])
    assert set(summary) == {"files", "reads", "k", "mode", "wall_s"}
    assert summary["reads"] == 24


@pytest.mark.parametrize("fmt", ["cfrk", "tsv", "hist"])
@pytest.mark.parametrize(
    "flags", [("-k", "8"), ("-k", "6", "--canonical", "--impl", "scatter", "--min-count", "2")],
    ids=["k8_auto", "k6_canonical_scatter_min2"],
)
def test_stream_spectrum_matches_jax_cli_and_one_shot(tmp_path, fmt, flags):
    inp = _prefix_fasta(tmp_path, "seq1.fasta.gz", 40)
    mode = ("--mode", "spectrum", "--spectrum-format", fmt, "--batch-size", "8")
    got, want = _both_spectrum(tmp_path, inp, "out.spec", *flags, *mode, "--stream",
                               "--checkpoint-every", "2")
    assert got == want and got
    shot = tmp_path / "shot.spec"
    assert main([inp, "-o", str(shot), *flags, *mode, "--device", "cpu"]) == 0
    assert shot.read_bytes() == got
    assert not list(tmp_path.glob("*/*.ckpt.json*"))


def test_stream_spectrum_resume_flag(tmp_path):
    """``--mode spectrum --resume`` after a kill at the second checkpoint
    writes the uninterrupted run's bytes and removes the checkpoint with
    its table only once the output exists."""
    from cfrk_tpu_torch.runtime import faults

    inp = _prefix_fasta(tmp_path, "seq2.fasta.gz", 40)
    full, out = tmp_path / "full.spectrum", tmp_path / "x.spectrum"
    common = ["-k", "7", "--mode", "spectrum", "--batch-size", "8", "--checkpoint-every",
              "2", "--device", "cpu"]
    assert main([inp, "-o", str(full), *common, "--stream"]) == 0
    faults.arm("checkpoint", 2)
    try:
        with pytest.raises(faults.InjectedFault):
            main([inp, "-o", str(out), *common, "--stream"])
    finally:
        faults.disarm()
    assert not out.exists() and len(list(tmp_path.glob("x.spectrum.ckpt.json*"))) == 2
    assert main([inp, "-o", str(out), *common, "--resume"]) == 0
    assert out.read_bytes() == full.read_bytes()
    assert not list(tmp_path.glob("x.spectrum.ckpt.json*"))


@pytest.mark.parametrize(
    "argv,message",
    [
        (["-k", "9", "--nonzero", "--packed"], "packed mode needs k <= 8"),
        (["-k", "5", "--packed", "--impl", "scatter"], "use --impl auto/pallas"),
        (["-k", "16", "--mode", "spectrum", "--impl", "sort"],
         "dense spectrum needs k <= 15"),
    ],
    ids=["packed_k9", "packed_scatter", "spectrum_sort"],
)
def test_stream_argument_errors_exit_cleanly(tmp_path, argv, message):
    fa = str(DATA / "seq2.fasta.gz")
    with pytest.raises(SystemExit, match=message):
        main([fa, "-o", str(tmp_path / "o.out"), *argv, "--stream", "--device", "cpu"])
    with pytest.raises(SystemExit, match="streaming .gz output is unsupported"):
        main([fa, str(tmp_path / "o.cfrk.gz"), "3", "--stream", "--device", "cpu"])


def test_large_input_note_names_stream(tmp_path, capsys, monkeypatch):
    """Above 4 GiB of input an in-memory run says that ``--stream`` runs
    in constant memory, as the JAX CLI does; a streamed run does not."""
    from cfrk_tpu_torch import cli as tcli

    fa = str(DATA / "seq2.fasta.gz")
    monkeypatch.setattr(tcli.os.path, "getsize", lambda p: 5 << 30)
    assert main([fa, str(tmp_path / "o.cfrk"), "2", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "5.0 GiB of input will be held in memory; --stream runs in constant memory" in err
    monkeypatch.undo()
    assert main([fa, str(tmp_path / "s.cfrk"), "2", "--stream", "--device", "cpu"]) == 0
    assert "held in memory" not in capsys.readouterr().err
    assert (tmp_path / "s.cfrk").read_bytes() == (tmp_path / "o.cfrk").read_bytes()


# ------------------------------------------------ sparse streaming


def _seeded_fasta(path, n, length, seed, genome=None):
    """n random reads, or n reads sampled from a random genome of
    ``genome`` bases (so that k-mers repeat)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    src = rng.integers(0, 4, genome) if genome else None
    with open(path, "wb") as f:
        for i in range(n):
            if genome:
                s = int(rng.integers(0, genome - length))
                codes = src[s:s + length]
            else:
                codes = rng.integers(0, 4, length)
            f.write(b">r%d\n" % i + bases[codes].tobytes() + b"\n")
    return str(path)


def test_cli_stream_sparse_mode(tmp_path):
    """``-k 19 --mode sparse --stream`` writes one KMER<TAB>count line per
    distinct k-mer of the one-shot spectrum, the JAX CLI's bytes."""
    from cfrk_tpu_torch.ops.sparse import decode_key
    from cfrk_tpu_torch.pipeline.count import sparse_spectrum_file

    fa = _seeded_fasta(tmp_path / "r.fasta", 10, 60, 5)
    got, want = _both_spectrum(tmp_path, fa, "o.kmers.tsv", "-k", "19", "--mode",
                               "sparse", "--stream", "--batch-size", "4")
    assert got == want
    spec = sparse_spectrum_file(fa, 19, device="cpu")
    lines = got.decode().strip().splitlines()
    assert dict(line.split("\t") for line in lines) == {
        decode_key(key, 19): str(c) for key, c in spec.items()}


def test_sparse_hist_format_streamed(tmp_path):
    """``--spectrum-format hist`` streamed equals the in-memory hist, the
    count-of-counts of the tsv, and the JAX CLI's streamed hist."""
    from collections import Counter

    fa = _seeded_fasta(tmp_path / "h.fasta", 12, 50, 4)
    tsv, hist, hist2 = (tmp_path / n for n in ("o.kmers.tsv", "o.hist", "o2.hist"))
    assert main([fa, "-k", "17", "--mode", "sparse", "-o", str(tsv), "--device", "cpu"]) == 0
    assert main([fa, "-k", "17", "--mode", "sparse", "-o", str(hist),
                 "--spectrum-format", "hist", "--device", "cpu"]) == 0
    occ = Counter(int(line.split("\t")[1]) for line in tsv.read_text().splitlines())
    assert dict(map(int, line.split("\t")) for line in hist.read_text().splitlines()) \
        == dict(occ)
    assert main([fa, "-k", "17", "--mode", "sparse", "-o", str(hist2), "--device", "cpu",
                 "--spectrum-format", "hist", "--stream", "--batch-size", "4"]) == 0
    assert hist2.read_text() == hist.read_text()
    got, want = _both_spectrum(tmp_path, fa, "s.hist", "-k", "17", "--mode", "sparse",
                               "--spectrum-format", "hist", "--stream", "--batch-size", "4")
    assert got == want == hist.read_bytes()


@pytest.mark.parametrize("fmt", ["tsv", "hist"])
@pytest.mark.parametrize("extra", [["--min-count", "2"], []], ids=["min2", "min1"])
def test_sparse_stream_budget_chunked_writer_byte_identical(tmp_path, fmt, extra):
    """``--mem-budget-mb`` routes the output through the chunked writer
    over spilled runs: the bytes equal the unbudgeted streamed run, the
    in-memory run and the JAX CLI's budgeted run, and no spill
    directory is left."""
    fa = _seeded_fasta(tmp_path / "in.fasta", 300, 90, 5, genome=8000)
    mode = ["-k", "16", "--mode", "sparse", "--spectrum-format", fmt, *extra]
    outs = []
    for i, flags in enumerate((["--stream", "--mem-budget-mb", "1", "--batch-size", "64"],
                               ["--stream", "--batch-size", "64"], [])):
        out = tmp_path / f"{i}.out"
        assert main([fa, "-o", str(out), *mode, *flags, "--device", "cpu"]) == 0
        outs.append(out.read_bytes())
    jout = tmp_path / "jax.out"
    assert jax_main([fa, "-o", str(jout), *mode, "--stream", "--mem-budget-mb", "1",
                     "--batch-size", "64", "--devices", "1"]) == 0
    assert outs[0] == outs[1] == outs[2] == jout.read_bytes() and outs[0]
    assert not [p for p in os.listdir(tmp_path) if ".spill" in p or ".ckpt" in p]


def test_write_sparse_chunks_equals_write_sparse(tmp_path):
    """The chunked writer equals the one-shot writer for any chunking,
    tsv and hist, min-count included."""
    from cfrk_tpu_torch import cli as tcli

    rng = np.random.default_rng(2)
    keys = np.unique(rng.integers(0, 4**21, 500).astype(np.uint64))
    counts = rng.integers(1, 6, keys.size).astype(np.int64)
    for fmt in ("tsv", "hist"):
        for min_count in (1, 3):
            a, b = tmp_path / f"a.{fmt}", tmp_path / f"b.{fmt}"
            tcli._write_sparse(str(a), keys, counts, 21, fmt, min_count)
            chunks = ((keys[s:s + 37], counts[s:s + 37]) for s in range(0, keys.size, 37))
            tcli._write_sparse_chunks(str(b), chunks, 21, fmt, min_count)
            assert a.read_bytes() == b.read_bytes() and a.read_bytes()


@pytest.mark.parametrize("first", ["jax", "torch"])
@pytest.mark.parametrize("budget", [[], ["--mem-budget-mb", "1"]], ids=["npz", "spill"])
def test_sparse_resume_flag_finishes_a_killed_stream_of_either_cli(tmp_path, capsys,
                                                                  first, budget):
    """A ``--mode sparse --stream`` run of one CLI killed at its second
    checkpoint is finished by the other CLI's ``--resume`` (the budget
    given to the first run only: the run list is honoured without it),
    and ``--stats`` prints the streamed run's metrics line."""
    from cfrk_tpu.runtime import faults as jfaults
    from cfrk_tpu_torch.runtime import faults

    fa = _seeded_fasta(tmp_path / "in.fasta", 80, 70, 9)
    full, out = tmp_path / "full.tsv", tmp_path / "x.tsv"
    common = ["-k", "21", "--canonical", "--mode", "sparse", "--batch-size", "8",
              "--checkpoint-every", "2"]
    assert main([fa, "-o", str(full), *common, "--stream", "--device", "cpu"]) == 0
    clis = {"jax": (jax_main, jfaults, ["--devices", "1"]),
            "torch": (main, faults, ["--device", "cpu"])}
    start, start_faults, start_extra = clis[first]
    finish, _, finish_extra = clis["torch" if first == "jax" else "jax"]
    start_faults.arm("checkpoint", 2)
    try:
        with pytest.raises(start_faults.InjectedFault):
            start([fa, "-o", str(out), *common, "--stream", *budget, *start_extra])
    finally:
        start_faults.disarm()
    state = json.loads((tmp_path / "x.tsv.ckpt.json").read_text())
    assert state["reads_done"] == 32 and (state["sparse_runs"] is not None) == bool(budget)
    assert not out.exists()
    capsys.readouterr()
    assert finish([fa, "-o", str(out), *common, "--resume", "--stats", *finish_extra]) == 0
    assert out.read_bytes() == full.read_bytes()
    assert not list(tmp_path.glob("x.tsv.ckpt.json*"))
    if finish is main:
        line, summary = map(json.loads, capsys.readouterr().err.strip().splitlines()[-2:])
        assert (line["reads"], line["batches"], line["mode"]) == (48, 6, "sparse")
        assert {"parse_wait", "dispatch", "materialize", "fold_bg", "fold_wait",
                "checkpoint"} == set(line["stages_s"])
        assert summary["reads"] == 48 and summary["mode"] == "sparse"


@pytest.mark.parametrize("k,impl", [("12", "sort"), ("9", "sort"), ("13", "scatter")])
def test_stream_spectrum_sort_route_matches_jax_cli(tmp_path, k, impl):
    """``--mode spectrum --stream --impl sort`` (the sorted route through
    the sparse driver) writes the JAX CLI's bytes and the one-shot
    run's; ``scatter`` at k = 13 stays on the dense table."""
    fa = _prefix_fasta(tmp_path, "seq1.fasta.gz", 40)
    mode = ["-k", k, "--mode", "spectrum", "--impl", impl, "--spectrum-format", "tsv",
            "--batch-size", "8"]
    got, want = _both_spectrum(tmp_path, fa, "o.spec", *mode, "--stream",
                               "--checkpoint-every", "2")
    assert got == want and got
    shot = tmp_path / "shot.spec"
    assert main([fa, "-o", str(shot), *mode, "--device", "cpu"]) == 0
    assert shot.read_bytes() == got
    assert not list(tmp_path.glob("*/*.ckpt.json*"))


def test_pin_malloc_only_for_sparse_and_sorted_streams(tmp_path, monkeypatch):
    """The CLI, which owns its process, pins glibc's mmap threshold once
    for a streamed sparse or sorted-spectrum run and for nothing else;
    the drivers never do."""
    from cfrk_tpu_torch.runtime import metrics

    calls = []
    monkeypatch.setattr(metrics, "pin_malloc_for_streaming", lambda: calls.append(1))
    fa = _prefix_fasta(tmp_path, "seq2.fasta.gz", 20)
    out = str(tmp_path / "o")
    for argv, pins in ((["-k", "3", "--stream"], 0),
                       (["-k", "5", "--mode", "spectrum", "--stream"], 0),
                       (["-k", "17", "--mode", "sparse"], 0),
                       (["-k", "17", "--mode", "sparse", "--stream"], 1),
                       (["-k", "5", "--mode", "spectrum", "--impl", "sort", "--stream"], 1)):
        calls.clear()
        assert main([fa, "-o", out, *argv, "--device", "cpu"]) == 0
        assert len(calls) == pins, argv
    from cfrk_tpu_torch.pipeline import stream as tstream

    calls.clear()
    tstream.stream_sparse_spectrum_file(fa, 17, device="cpu", out_path=out,
                                        checkpoint_every=1)
    assert not calls


# ------------------------------------------------------------ entry layer


def _last_json(err: str) -> dict:
    return json.loads(err.strip().splitlines()[-1])


@pytest.mark.parametrize("stream", [False, True], ids=["in_memory", "stream"])
@pytest.mark.parametrize(
    "mode,flags",
    [("perread", ("-k", "5", "--nonzero")), ("spectrum", ("-k", "5")),
     ("sparse", ("-k", "17", "--canonical"))],
)
def test_stats_line_matches_jax_cli(tmp_path, capsys, mode, flags, stream):
    """Every key of the ``--stats`` summary but ``wall_s`` equals
    cfrk_tpu's: ``reads`` is 0 for an in-memory spectrum or sparse run
    and the reads counted when streamed."""
    fa = _prefix_fasta(tmp_path, "seq2.fasta.gz", 30)
    extra = ["--mode", mode, *flags, "--stats"] + (["--stream"] if stream else [])
    assert main([fa, "-o", str(tmp_path / "a"), *extra, "--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().err)
    assert jax_main([fa, "-o", str(tmp_path / "b"), *extra]) == 0
    want = _last_json(capsys.readouterr().err)
    got.pop("wall_s"), want.pop("wall_s")
    assert got == want
    assert got["reads"] == (30 if stream or mode == "perread" else 0)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


def test_abbreviated_long_options_match_jax_cli(tmp_path):
    """Both packages take an unambiguous prefix of a long option
    (``--batch 64``, ``--seqp`` for ``--seqpar``) to the same bytes."""
    fa = _prefix_fasta(tmp_path, "seq1.fasta.gz", 20)
    got, want = _both(tmp_path, fa, "4", "--batch", "64", "--nonz")
    assert got == want and got.count(b"\n") == 19
    got, want = _both(tmp_path, fa, "4", "--impl", "scatter", "--seqp")
    assert got == want and got.count(b"\n") == 19


class _FakeStdin:
    def __init__(self, data: bytes):
        import io

        self.buffer = io.BufferedReader(io.BytesIO(data))


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize(
    "flags",
    [("-k", "8", "--nonzero"), ("-k", "8", "--nonzero", "--stream"), ("-k", "3"),
     ("-k", "6", "--mode", "spectrum", "--stream"),
     ("-k", "19", "--canonical", "--mode", "sparse", "--stream")],
    ids=["k8_nonzero", "k8_nonzero_stream", "k3_dense", "spectrum_stream",
         "sparse_stream"],
)
def test_stdin_matches_file_and_jax_cli(tmp_path, monkeypatch, gz, flags):
    """``-`` reads stdin, plain or gzip bytes, in memory and streamed:
    the bytes of the same file run and of cfrk_tpu's stdin run.  The
    port leaves the pipe open for its owner (cfrk_tpu's streamed run
    closes it)."""
    fa = _prefix_fasta(tmp_path, "seq2.fasta.gz", 40)
    data = Path(fa).read_bytes()
    blob = gzip.compress(data) if gz else data
    out = {}
    for name, cli_main, dev in (("file", main, ["--device", "cpu"]),
                                ("torch", main, ["--device", "cpu"]),
                                ("jax", jax_main, [])):
        out[name] = tmp_path / f"{name}.out"
        src = fa if name == "file" else "-"
        stdin = _FakeStdin(blob)
        monkeypatch.setattr(sys, "stdin", stdin)
        assert cli_main([src, "-o", str(out[name]), *flags, *dev]) == 0
        assert name == "jax" or not stdin.buffer.closed
    got = out["torch"].read_bytes()
    assert got and got == out["file"].read_bytes() == out["jax"].read_bytes()
    assert not list(tmp_path.glob("*.ckpt.json*"))


@pytest.mark.parametrize(
    "argv,message",
    [(["-", "-k", "2", "-o", "o", "--resume"], "cannot --resume from a pipe"),
     (["-", "-k", "2"], "stdin input needs an explicit -o/--output"),
     (["-", "IN", "-k", "2", "-o", "o"], "'-' \\(stdin\\) cannot mix with file inputs")],
    ids=["resume", "no_output", "mixed"],
)
def test_stdin_refusals_match_jax_cli(tmp_path, argv, message):
    fa = _prefix_fasta(tmp_path, "seq2.fasta.gz", 2)
    argv = [fa if a == "IN" else a for a in argv]
    for cli_main in (main, jax_main):
        with pytest.raises(SystemExit, match=message):
            cli_main(argv)


def test_stream_driver_refuses_pipe_offsets_and_resume(monkeypatch):
    """The streaming drivers' own refusals for a pipe, with the JAX
    package's messages."""
    from cfrk_tpu.pipeline import stream as jstream
    from cfrk_tpu_torch.pipeline import stream as tstream

    for mod in (tstream, jstream):
        with pytest.raises(ValueError, match="byte offsets cannot address a pipe"):
            next(mod.stream_batches("-", 3, 4, start_offset=10))
        with pytest.raises(ValueError, match="cannot resume from a pipe"):
            mod._resume_fingerprint("-", 3, "perread", False, "o", None, 0, True)
    want = jstream._resume_fingerprint("-", 3, "perread", True, "o", None, 20)
    assert tstream._resume_fingerprint("-", 3, "perread", True, "o", None, 20) == want
    assert want[0]["input"] == "<stdin>"


def _shards(tmp_path, n=3, reads=12, seed=4):
    """``n`` FASTA shards of seeded reads (with N bases and a read
    shorter than k)."""
    from cfrk_tpu_torch.io.fasta import decode_codes

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = tmp_path / f"shard{i}.fa"
        p.write_bytes(b"".join(
            b">r%d\n" % j + decode_codes(rng.integers(-1, 4, int(rng.integers(2, 90)))
                                         .astype(np.int8)) + b"\n"
            for j in range(reads)))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("stream", [False, True], ids=["in_memory", "stream"])
@pytest.mark.parametrize(
    "flags,suffix",
    [(("-k", "4"), ".cfrk"), (("-k", "9", "--nonzero"), ".cfrk"),
     (("-k", "5", "--mode", "spectrum", "--spectrum-format", "tsv"), ".spectrum"),
     (("-k", "21", "--canonical", "--mode", "sparse"), ".kmers.tsv")],
    ids=["perread_dense", "perread_k9_nonzero", "spectrum_tsv", "sparse"],
)
def test_multi_file_out_dir_matches_jax_cli(tmp_path, capsys, flags, suffix, stream):
    """Three inputs into ``--out-dir``: each shard's bytes and the
    ``--stats`` line (but ``wall_s``) equal cfrk_tpu's; the provenance
    holds one successful attempt a file."""
    shards = _shards(tmp_path)
    extra = [*flags, "--stats", "--max-parallel-tasks", "3"] + (["--stream"] if stream else [])
    prov = tmp_path / "prov.jsonl"
    assert main([*shards, "--out-dir", str(tmp_path / "t"), *extra, "--device", "cpu",
                 "--provenance", str(prov)]) == 0
    got = _last_json(capsys.readouterr().err)
    assert jax_main([*shards, "--out-dir", str(tmp_path / "j"), *extra]) == 0
    want = _last_json(capsys.readouterr().err)
    got.pop("wall_s"), want.pop("wall_s")
    assert got == want and got["files"] == 3 and got["failed"] == 0
    for shard in shards:
        name = Path(shard).stem + suffix
        a, b = (tmp_path / d / name for d in ("t", "j"))
        assert a.read_bytes() == b.read_bytes(), name
    from cfrk_tpu_torch.runtime.workflow import query_provenance

    records = query_provenance(str(prov))
    assert sorted(r["input"] for r in records) == shards
    assert all(r["ok"] and r["attempt"] == 0 for r in records)


def test_multi_file_failure_lines_and_exit_code(tmp_path, capsys):
    """A shard that fails (malformed FASTQ) leaves the others written,
    prints ``FAILED <input>`` and exits 1, as cfrk_tpu does; with
    ``--no-lazy-errors`` the run raises."""
    shards = _shards(tmp_path, n=2)
    bad = tmp_path / "bad.fq"
    bad.write_bytes(b"@r\nACGT\n+\nII\n")
    argv = [shards[0], str(bad), shards[1], "-k", "3", "--stats"]
    assert main([*argv, "--out-dir", str(tmp_path / "t"), "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert jax_main([*argv, "--out-dir", str(tmp_path / "j")]) == 1
    jerr = capsys.readouterr().err
    for text in (err, jerr):
        assert f"FAILED {bad}:" in text and "quality length mismatch" in text
    stats = [json.loads(next(line for line in t.splitlines() if line.startswith("{")))
             for t in (err, jerr)]
    assert [(s["files"], s["failed"], s["reads"]) for s in stats] == [(3, 1, 24)] * 2
    for shard in shards:
        name = Path(shard).stem + ".cfrk"
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    with pytest.raises(RuntimeError, match="workflow task failed"):
        main([*argv, "--out-dir", str(tmp_path / "s"), "--device", "cpu",
              "--no-lazy-errors"])


@pytest.mark.parametrize("mode,suffix", [("perread", ".cfrk"), ("spectrum", ".spectrum")])
def test_out_dir_single_input_matches_jax_cli(tmp_path, mode, suffix):
    """One input with ``--out-dir`` writes its default name there."""
    fa = _prefix_fasta(tmp_path, "seq1.fasta.gz", 10)
    assert main([fa, "-k", "3", "--mode", mode, "--out-dir", "t", "--device", "cpu"]) == 0
    assert jax_main([fa, "-k", "3", "--mode", mode, "--out-dir", "j"]) == 0
    name = "head_seq1" + suffix
    assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_list_devices_on_a_cpu_host(capsys):
    """``--list-devices`` prints cfrk_tpu's CPU line where no CUDA device
    is visible, and needs no input."""
    assert main(["--list-devices"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert jax_main(["--list-devices"]) == 0
    jax_first = capsys.readouterr().out.strip().splitlines()[0]
    assert json.loads(lines[0]) == json.loads(jax_first) == {
        "id": 0, "platform": "cpu", "kind": "cpu", "process": 0}


def test_profile_writes_a_trace(tmp_path):
    """``--profile DIR`` on ``--device cpu`` writes one Chrome trace of
    the run into DIR, and the output is unchanged."""
    fa = _prefix_fasta(tmp_path, "seq2.fasta.gz", 20)
    assert main([fa, "a.cfrk", "4", "--device", "cpu", "--profile", "trace"]) == 0
    assert main([fa, "b.cfrk", "4", "--device", "cpu"]) == 0
    assert (tmp_path / "a.cfrk").read_bytes() == (tmp_path / "b.cfrk").read_bytes()
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_multi_file_dense_k9_fails_each_task_as_jax_cli(tmp_path, capsys):
    """Per-read k > 8 without ``--nonzero`` over many inputs: as in
    cfrk_tpu, every task fails, each prints its ``FAILED`` line and the
    run exits 1; a single input is refused before it starts."""
    shards = _shards(tmp_path, n=2)
    for cli_main, dev in ((main, ["--device", "cpu"]), (jax_main, [])):
        assert cli_main([*shards, "-k", "9", "--out-dir", "o", *dev]) == 1
        err = capsys.readouterr().err
        assert [line.split(":")[0] for line in err.splitlines()
                if line.startswith("FAILED")] == [f"FAILED {s}" for s in shards]
        with pytest.raises(SystemExit, match="requires --nonzero"):
            cli_main([shards[0], "-k", "9", "-o", "x", *dev])
