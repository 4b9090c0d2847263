"""Fault injection of cfrk_tpu_torch (``runtime/faults.py``): the port's
counterpart of tests/test_faults.py.

The streaming drivers are crashed at their two fault sites and resumed;
the bytes must equal an uninterrupted run of the port AND of cfrk_tpu.
Everything runs on ``device="cpu"`` (the plain route); tolerance: exact.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cfrk_tpu.pipeline import stream as jstream
from cfrk_tpu.runtime import faults as jfaults
from cfrk_tpu_torch.pipeline.stream import stream_count_file, stream_spectrum_file
from cfrk_tpu_torch.runtime import faults
from cfrk_tpu_torch.runtime.checkpoint import checkpoint_path, cleanup_checkpoint

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    jfaults.disarm()


def _fasta(path, seed, n=20, lo=20, hi=60):
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for i in range(n):
            seq = _BASES[rng.integers(0, 4, size=int(rng.integers(lo, hi)))]
            f.write(b">r%d\n" % i + seq.tobytes() + b"\n")
    return path


def _jax_bytes(tmp_path, fasta, k, **kw):
    out = tmp_path / "jax_full.cfrk"
    jstream.stream_count_file(fasta, out, k, **kw)
    return out.read_bytes()


def test_trip_semantics():
    faults.arm("site", 2)
    faults.trip("site")  # 1st pass: survives
    with pytest.raises(faults.InjectedFault):
        faults.trip("site")  # 2nd pass: fires
    faults.trip("site")  # self-disarmed: no re-fire


def test_arm_validates():
    with pytest.raises(ValueError):
        faults.arm("site", 0)


def test_env_spec_parsing(monkeypatch):
    monkeypatch.setitem(faults._armed, "x", 99)
    faults.disarm()
    monkeypatch.setenv("CFRK_FAULT_INJECT", "checkpoint:3, other:1")
    faults._load_env()
    assert faults._armed == {"checkpoint": 3, "other": 1}
    faults.disarm()
    monkeypatch.setenv("CFRK_FAULT_INJECT", "bogus:notanint")
    with pytest.raises(ValueError):
        faults._load_env()


def test_faults_module_is_a_copy(monkeypatch):
    """Same names, same armed state for the same spec, same exception
    base as the JAX package's module; the two do not share state."""
    assert faults.__all__ == jfaults.__all__
    assert issubclass(faults.InjectedFault, RuntimeError)
    monkeypatch.setenv("CFRK_FAULT_INJECT", "batch-written:7,checkpoint:2")
    for mod in (faults, jfaults):
        mod.disarm()
        mod._load_env()
    assert faults._armed == jfaults._armed == {"batch-written": 7, "checkpoint": 2}
    faults.disarm("checkpoint")
    assert "checkpoint" in jfaults._armed and "checkpoint" not in faults._armed


@pytest.mark.parametrize("crash_after", [1, 2, 4])
def test_stream_count_crash_resume(tmp_path, crash_after):
    """Die right after the Nth durable checkpoint; resume must finish
    the run with the bytes of an uninterrupted one."""
    fasta = _fasta(tmp_path / "in.fasta", 7)
    k, bs = 3, 4
    full = tmp_path / "full.cfrk"
    stream_count_file(fasta, full, k, device="cpu", batch_size=bs)
    want = full.read_bytes()
    assert want == _jax_bytes(tmp_path, fasta, k, batch_size=bs)

    out = tmp_path / "crashed.cfrk"
    faults.arm("checkpoint", crash_after)
    with pytest.raises(faults.InjectedFault):
        stream_count_file(fasta, out, k, device="cpu", batch_size=bs)
    assert (tmp_path / (out.name + ".ckpt.json")).exists()

    m = stream_count_file(fasta, out, k, device="cpu", batch_size=bs, resume=True)
    assert m.reads == 20 - crash_after * bs and m.total_reads == 20
    assert out.read_bytes() == want
    assert not (tmp_path / (out.name + ".ckpt.json")).exists()


def test_stream_spectrum_crash_resume(tmp_path):
    """Spectrum driver: the checkpointed table sidecar carries the
    partial counts across the crash, with no double counting."""
    fasta = _fasta(tmp_path / "in.fasta", 11, n=24)
    k, bs = 3, 4
    want, _ = stream_spectrum_file(fasta, k, device="cpu", batch_size=bs)
    jwant, _ = jstream.stream_spectrum_file(fasta, k, batch_size=bs)
    np.testing.assert_array_equal(want, np.asarray(jwant))

    out = tmp_path / "crashed.spec"
    faults.arm("checkpoint", 2)
    with pytest.raises(faults.InjectedFault):
        stream_spectrum_file(fasta, k, device="cpu", batch_size=bs, out_path=out,
                             checkpoint_every=1, cleanup=False)
    got, m = stream_spectrum_file(fasta, k, device="cpu", batch_size=bs, out_path=out,
                                  checkpoint_every=1, resume=True, cleanup=False)
    assert m.reads == 24 - 2 * bs and m.total_reads == 24
    assert list(tmp_path.glob("crashed.spec.ckpt.json*"))
    cleanup_checkpoint(out)
    assert not list(tmp_path.glob("crashed.spec.ckpt.json*"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("crash_after", [1, 3])
def test_stream_count_torn_tail_resume(tmp_path, crash_after):
    """Die AFTER a batch's rows are written but BEFORE its checkpoint:
    the file has a torn, unclaimed tail.  Resume must truncate it, redo
    the batch, and still end on the same bytes."""
    fasta = _fasta(tmp_path / "in.fasta", 13)
    k, bs = 3, 4
    want = _jax_bytes(tmp_path, fasta, k, batch_size=bs)

    out = tmp_path / "torn.cfrk"
    faults.arm("batch-written", crash_after)
    with pytest.raises(faults.InjectedFault):
        stream_count_file(fasta, out, k, device="cpu", batch_size=bs)
    ckpt_file = tmp_path / (out.name + ".ckpt.json")
    if crash_after > 1:
        claimed = json.loads(ckpt_file.read_text())["out_bytes"]
        assert out.stat().st_size > claimed
    else:
        assert not ckpt_file.exists()  # died before the first checkpoint

    m = stream_count_file(fasta, out, k, device="cpu", batch_size=bs, resume=True)
    assert m.reads == 20 - (crash_after - 1) * bs
    assert out.read_bytes() == want


def test_checkpoint_trip_is_noop_when_disarmed(tmp_path):
    fasta = _fasta(tmp_path / "in.fasta", 3, n=8)
    out = tmp_path / "out.cfrk"
    m = stream_count_file(fasta, out, 2, device="cpu", batch_size=4)
    assert m.reads == 8
    assert not (tmp_path / (out.name + ".ckpt.json")).exists()
    assert checkpoint_path(out).endswith(".ckpt.json")


@pytest.mark.parametrize("spec,reads_done", [("batch-written:2", 4), ("checkpoint:3", 12)])
def test_cli_child_killed_through_the_environment(tmp_path, monkeypatch, spec,
                                                   reads_done):
    """``CFRK_FAULT_INJECT=site:N`` arms a child process at import, as in
    the JAX package: the streamed CLI run dies non-zero with its
    checkpoint left, and ``--resume`` writes the uninterrupted bytes."""
    from cfrk_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)  # no cfrk.json around the checkout applies

    root = Path(__file__).resolve().parent.parent
    fasta = _fasta(tmp_path / "r.fasta", 17)
    full, out = tmp_path / "full.cfrk", tmp_path / "x.cfrk"
    argv = ["6", "--nonzero", "--batch-size", "4", "--device", "cpu"]
    assert main([str(fasta), str(full), *argv, "--stream"]) == 0
    env = dict(os.environ, CFRK_FAULT_INJECT=spec)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run(
        [sys.executable, "-m", "cfrk_tpu_torch", str(fasta), str(out), *argv, "--stream"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "InjectedFault" in proc.stderr
    state = json.loads(Path(checkpoint_path(out)).read_text())
    assert state["reads_done"] == reads_done
    assert out.stat().st_size >= state["out_bytes"] > 0
    assert main([str(fasta), str(out), *argv, "--resume"]) == 0
    assert out.read_bytes() == full.read_bytes()
    assert not os.path.exists(checkpoint_path(out))


# ------------------------------------------------- sparse spilling runs


def _sparse(path, k, **kw):
    from cfrk_tpu_torch.pipeline.stream import stream_sparse_spectrum_file

    return stream_sparse_spectrum_file(path, k, device="cpu", **kw)


def _spill_runs(tmp_path, out):
    return json.loads((tmp_path / (out.name + ".ckpt.json")).read_text())["sparse_runs"]


@pytest.mark.parametrize("crash_after", [1, 2, 3, 4, 5])
def test_stream_sparse_spill_crash_resume(tmp_path, crash_after):
    """A budgeted run checkpoints an append-only run list: die right
    after each of its five checkpoints in turn, resume, and the result
    equals the uninterrupted run of both packages; a run spilled after
    the last durable checkpoint is dropped, and the spill directory goes
    with the checkpoint."""
    fasta = _fasta(tmp_path / "in.fasta", 17, n=40, lo=40, hi=80)
    k, bs = 16, 8
    want = _sparse(fasta, k, batch_size=bs)
    jwant = jstream.stream_sparse_spectrum_file(fasta, k, batch_size=bs)
    np.testing.assert_array_equal(want[0], jwant[0])
    np.testing.assert_array_equal(want[1], jwant[1])

    out = tmp_path / "crashed.tsv"
    faults.arm("checkpoint", crash_after)
    with pytest.raises(faults.InjectedFault):
        _sparse(fasta, k, batch_size=bs, out_path=out, mem_budget_mb=1,
                checkpoint_every=1, cleanup=False)
    runs = _spill_runs(tmp_path, out)
    assert runs == [f"run{i:05d}" for i in range(crash_after)]
    # A run spilled after the checkpoint, which the resume must drop.
    spill = tmp_path / (out.name + ".ckpt.json.spill")
    for part in ("keys", "counts"):
        (spill / f"run{crash_after:05d}.{part}.npy").write_bytes(
            (spill / f"run00000.{part}.npy").read_bytes())

    gk, gc, m = _sparse(fasta, k, batch_size=bs, out_path=out, mem_budget_mb=1,
                        checkpoint_every=1, resume=True, cleanup=False)
    assert m.reads == 40 - crash_after * bs and m.total_reads == 40
    np.testing.assert_array_equal(gk, want[0])
    np.testing.assert_array_equal(gc, want[1])
    assert spill.is_dir()
    cleanup_checkpoint(out)
    assert not spill.exists() and not list(tmp_path.glob("crashed.tsv.ckpt*"))


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_stream_sparse_spill_resume_without_budget(tmp_path, first):
    """Resuming a budgeted run WITHOUT a budget still honours the
    checkpointed run list (the run list, not the caller's flags, is the
    accumulator's state), from either package's run."""
    fasta = _fasta(tmp_path / "in.fasta", 23, n=30, lo=40, hi=80)
    k, bs = 16, 8
    want = _sparse(fasta, k, batch_size=bs)
    out = tmp_path / "crashed.tsv"
    start, fl = {"jax": (jstream.stream_sparse_spectrum_file, jfaults),
                 "torch": (_sparse, faults)}[first]
    fl.arm("checkpoint", 2)
    with pytest.raises(fl.InjectedFault):
        start(fasta, k, batch_size=bs, out_path=out, mem_budget_mb=1,
              checkpoint_every=1, cleanup=False)
    assert _spill_runs(tmp_path, out) == ["run00000", "run00001"]
    gk, gc, m = _sparse(fasta, k, batch_size=bs, out_path=out, checkpoint_every=1,
                        resume=True)
    np.testing.assert_array_equal(gk, want[0])
    np.testing.assert_array_equal(gc, want[1])
    assert m.reads == 14 and not list(tmp_path.glob("crashed.tsv.ckpt*"))


def test_stream_sparse_missing_spill_run_restarts(tmp_path):
    """A checkpoint whose listed run is gone restarts from scratch (and
    clears the directory) instead of undercounting."""
    fasta = _fasta(tmp_path / "in.fasta", 29, n=30, lo=40, hi=80)
    want = _sparse(fasta, 16, batch_size=8)
    out = tmp_path / "x.tsv"
    faults.arm("checkpoint", 2)
    with pytest.raises(faults.InjectedFault):
        _sparse(fasta, 16, batch_size=8, out_path=out, mem_budget_mb=1,
                checkpoint_every=1, cleanup=False)
    os.remove(tmp_path / "x.tsv.ckpt.json.spill" / "run00001.counts.npy")
    gk, gc, m = _sparse(fasta, 16, batch_size=8, out_path=out, mem_budget_mb=1,
                        checkpoint_every=1, resume=True)
    assert m.reads == 30
    np.testing.assert_array_equal(gk, want[0])
    np.testing.assert_array_equal(gc, want[1])


def test_cli_sparse_budget_child_killed_through_the_environment(tmp_path, monkeypatch):
    """A budgeted ``--mode sparse --stream`` child armed with
    ``CFRK_FAULT_INJECT=checkpoint:2`` dies with its run list and runs
    on disk and no output; ``--resume`` writes the uninterrupted bytes
    and removes the checkpoint and the runs."""
    from cfrk_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)  # no cfrk.json around the checkout applies

    root = Path(__file__).resolve().parent.parent
    fasta = _fasta(tmp_path / "r.fasta", 31, n=40, lo=40, hi=80)
    full, out = tmp_path / "full.tsv", tmp_path / "x.tsv"
    argv = ["-k", "18", "--canonical", "--mode", "sparse", "--batch-size", "8",
            "--checkpoint-every", "1", "--mem-budget-mb", "1", "--device", "cpu"]
    assert main([str(fasta), "-o", str(full), *argv, "--stream"]) == 0
    env = dict(os.environ, CFRK_FAULT_INJECT="checkpoint:2")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run(
        [sys.executable, "-m", "cfrk_tpu_torch", str(fasta), "-o", str(out), *argv,
         "--stream"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "InjectedFault" in proc.stderr
    assert _spill_runs(tmp_path, out) == ["run00000", "run00001"] and not out.exists()
    assert main([str(fasta), "-o", str(out), *argv, "--resume"]) == 0
    assert out.read_bytes() == full.read_bytes()
    assert not list(tmp_path.glob("x.tsv.ckpt*"))
