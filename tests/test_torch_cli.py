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
        (["--impl", "pallas"], "--impl is not yet ported"),
        (["--devices=2"], "--devices is not yet ported"),
        (["--mode", "spectrum"], "--mode spectrum is not yet ported"),
        (["--mode", "sparse"], "--mode sparse is not yet ported"),
    ],
)
def test_unported_flags_fail_clearly(tmp_path, argv, message):
    fa = str(DATA / "seq2.fasta.gz")
    with pytest.raises(SystemExit, match=message):
        main([fa, str(tmp_path / "o.cfrk"), "2", "--device", "cpu", *argv])


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
