"""The cfrk_tpu_torch CLI (``--device cpu``) against the goldens and
against cfrk_tpu's CLI bytes.

The whole per-read slice runs here: FASTA parse → batches → the plain
PyTorch route of the per-read sort + RLE → narrowed drain → formatter.
Tolerance: exact equality of the output bytes.
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


def _both(tmp_path, inp, *flags):
    """Output bytes of the port (--device cpu) and of cfrk_tpu's CLI."""
    a, b = tmp_path / "torch.cfrk", tmp_path / "jax.cfrk"
    assert main([inp, str(a), *flags, "--device", "cpu"]) == 0
    assert jax_main([inp, str(b), *flags]) == 0
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


@pytest.mark.parametrize(
    "argv,message",
    [
        (["--stream"], "--stream is not yet ported"),
        (["--impl", "pallas", "--packed"], "--packed is not yet ported"),
        (["--devices=2"], "--devices is not yet ported"),
        (["--mode", "spectrum", "--stream"], "--stream is not yet ported"),
        (["--mode", "sparse", "--mem-budget-mb", "64"],
         "--mem-budget-mb is not yet ported"),
        (["--impl", "scatter", "--seqpar"], "--seqpar is not yet ported"),
    ],
)
def test_unported_flags_fail_clearly(tmp_path, argv, message):
    fa = str(DATA / "seq2.fasta.gz")
    with pytest.raises(SystemExit, match=message):
        main([fa, str(tmp_path / "o.cfrk"), "2", "--device", "cpu", *argv])


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
    with pytest.raises(SystemExit, match="multi-file run is not yet ported"):
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
