"""cfrk_tpu_torch's multi-file workflow (``runtime/workflow.py``) against
cfrk_tpu's: per-shard output bytes of both packages' ``count_one_factory``
in every mode, retries, lazy and strict errors, provenance records, and
a crashed streamed task that resumes on retry.  The port runs on the
CPU route; every comparison is exact."""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from cfrk_tpu.pipeline.stream import stream_count_file as jax_stream_count_file
from cfrk_tpu.runtime import workflow as jwf
from cfrk_tpu_torch.io.fasta import decode_codes
from cfrk_tpu_torch.runtime import faults
from cfrk_tpu_torch.runtime import workflow as twf


def _shards(tmp_path, n=3, reads=10, seed=0):
    """``n`` seeded FASTA shards (N bases, reads shorter than k)."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = tmp_path / f"shard{i}.fa"
        p.write_bytes(b"".join(
            b">r%d\n" % j + decode_codes(rng.integers(-1, 4, int(rng.integers(3, 80)))
                                         .astype(np.int8)) + b"\n"
            for j in range(reads)))
        paths.append(str(p))
    return paths


_SUFFIX = {"perread": ".cfrk", "spectrum": ".spec", "sparse": ".tsv"}


@pytest.mark.parametrize("stream", [False, True], ids=["in_memory", "stream"])
@pytest.mark.parametrize(
    "k,opts",
    [(4, dict(mode="perread")),
     (9, dict(mode="perread", nonzero=True)),
     (3, dict(mode="perread", impl="scatter", nonzero=True)),
     (5, dict(mode="spectrum")),
     (6, dict(mode="spectrum", impl="sort", spectrum_format="tsv", min_count=2)),
     (4, dict(mode="spectrum", spectrum_format="npy", canonical=True)),
     (21, dict(mode="sparse", canonical=True)),
     (17, dict(mode="sparse", spectrum_format="hist"))],
    ids=["perread_dense", "perread_k9_nonzero", "perread_scatter", "spectrum_cfrk",
         "spectrum_sort_tsv", "spectrum_npy", "sparse_tsv", "sparse_hist"],
)
def test_factory_bytes_match_jax(tmp_path, k, opts, stream):
    """Both factories over three shards write the same bytes per shard
    and report the same reads per task."""
    shards = _shards(tmp_path)
    suffix = _SUFFIX[opts["mode"]]
    results = {}
    for name, wf, extra in (("torch", twf, {"device": "cpu"}), ("jax", jwf, {})):
        pairs = [(s, str(tmp_path / f"{name}_{i}{suffix}")) for i, s in enumerate(shards)]
        fn = wf.count_one_factory(k, stream=stream, batch_size=4, **opts, **extra)
        results[name] = wf.run_workflow(pairs, fn, max_parallel_tasks=2)
    got, want = results["torch"], results["jax"]
    assert got.ok and want.ok
    assert [t.reads for t in got.tasks] == [t.reads for t in want.tasks]
    for a, b in zip(got.tasks, want.tasks):
        assert Path(a.output).read_bytes() == Path(b.output).read_bytes(), a.output
    assert not list(tmp_path.glob("*.ckpt.json*"))


def _flaky(fail_first: int):
    """A count_one that fails its first ``fail_first`` calls on input
    ``bad`` and always on ``never``."""
    calls = {}
    lock = threading.Lock()

    def count_one(inp, out):
        with lock:
            calls[inp] = calls.get(inp, 0) + 1
            n = calls[inp]
        if inp == "never" or (inp == "bad" and n <= fail_first):
            raise ValueError(f"boom {inp} {n}")
        Path(out).write_text(inp)
        return len(inp)

    return count_one


@pytest.mark.parametrize(
    "retries,lazy,fail_first",
    [(2, True, 1), (0, True, 1), (1, True, 5), (0, False, 1), (3, False, 2)],
    ids=["retry_succeeds", "no_retry_lazy", "retries_exhausted", "strict",
         "strict_retried"],
)
def test_retries_and_errors_match_jax(tmp_path, retries, lazy, fail_first):
    """The same failing callables give the same tasks (ok, attempts,
    reads, error) in both packages, lazy or strict; provenance records
    carry the same keys and values but for times and traceback paths."""
    outcome = {}
    for name, wf in (("torch", twf), ("jax", jwf)):
        d = tmp_path / name
        d.mkdir()
        pairs = [(inp, str(d / f"{inp}.out")) for inp in ("ok1", "bad", "ok2")]
        prov = d / "prov.jsonl"
        try:
            res = wf.run_workflow(pairs, _flaky(fail_first), retries=retries,
                                  lazy_errors=lazy, max_parallel_tasks=1,
                                  provenance_path=str(prov))
            outcome[name] = [(t.ok, t.attempts, t.reads,
                              t.error and t.error.strip().splitlines()[-1])
                             for t in res.tasks]
        except RuntimeError as e:
            outcome[name] = ("raised", str(e).splitlines()[0],
                             str(e).strip().splitlines()[-1])
        records = wf.query_provenance(str(prov))
        outcome[name + "_prov"] = [
            ({key: r[key] for key in r
              if key not in ("ts", "duration_s", "error", "output")},
             set(r), r["error"] and r["error"].strip().splitlines()[-1])
            for r in records]
    assert outcome["torch"] == outcome["jax"]
    assert outcome["torch_prov"] == outcome["jax_prov"]
    assert outcome["torch_prov"]


def test_strict_errors_report_a_real_traceback(tmp_path):
    """With lazy errors off, the error raised names a task that failed
    with a traceback, not one that was aborted."""
    def count_one(inp, out):
        raise ValueError(f"boom {inp}")

    pairs = [(f"in{i}", str(tmp_path / f"{i}.out")) for i in range(4)]
    with pytest.raises(RuntimeError,
                       match=r"(?s)workflow task failed \(in\d\).*ValueError: boom"):
        twf.run_workflow(pairs, count_one, lazy_errors=False, max_parallel_tasks=2)


def test_retry_resumes_from_checkpoint(tmp_path):
    """A streamed task that crashes after its second checkpoint is
    retried and resumes from that checkpoint: the retry counts only the
    remaining reads, and the output equals cfrk_tpu's uninterrupted
    streamed run."""
    (fasta,) = _shards(tmp_path, n=1, reads=20, seed=17)
    k, bs = 3, 4
    full = tmp_path / "full.cfrk"
    jax_stream_count_file(fasta, full, k, batch_size=bs)
    out = tmp_path / "wf.cfrk"
    prov = tmp_path / "prov.jsonl"
    count_one = twf.count_one_factory(k, device="cpu", stream=True, batch_size=bs)
    faults.arm("checkpoint", 2)
    try:
        res = twf.run_workflow([(fasta, str(out))], count_one, retries=1,
                               provenance_path=str(prov))
    finally:
        faults.disarm()
    assert res.ok
    task = res.tasks[0]
    assert task.attempts == 2
    assert task.reads == 20 - 2 * bs
    assert out.read_bytes() == full.read_bytes()
    records = twf.query_provenance(str(prov))
    assert [(r["attempt"], r["ok"]) for r in records] == [(0, False), (1, True)]
    assert "InjectedFault: checkpoint" in records[0]["error"]


def test_factory_refuses_scale_out_options(tmp_path):
    """mesh, seqpar and slack, the JAX package's scale-out, run: each
    factory over a mesh (4 CPU devices for the port, 4 of the JAX
    package's 8 virtual ones) writes cfrk_tpu's bytes and reads per
    shard, streamed and in memory; per-read k > 8 rows under seqpar are
    refused in the JAX package's words."""
    import jax
    import torch

    from cfrk_tpu.parallel import make_mesh as jax_mesh
    from cfrk_tpu.parallel import make_seq_mesh as jax_seq_mesh
    from cfrk_tpu_torch.parallel import make_mesh, make_seq_mesh

    cpus = [torch.device("cpu")] * 4
    shards = _shards(tmp_path, n=2, reads=40)
    for label, k, kw, jkw in (
        ("rows", 9, dict(mode="perread", nonzero=True, mesh=make_mesh(cpus)),
         dict(mode="perread", nonzero=True, mesh=jax_mesh(jax.devices()[:4]))),
        ("tp", 4, dict(mode="spectrum", mesh=make_mesh(cpus, tp=2)),
         dict(mode="spectrum", mesh=jax_mesh(jax.devices()[:4], tp=2))),
        ("seqpar", 3, dict(mode="perread", impl="scatter", seqpar=True,
                           mesh=make_seq_mesh(cpus)),
         dict(mode="perread", impl="scatter", seqpar=True,
              mesh=jax_seq_mesh(jax.devices()[:4]))),
        ("slack", 16, dict(mode="sparse", slack=0.25, mesh=make_mesh(cpus)),
         dict(mode="sparse", slack=0.25, mesh=jax_mesh(jax.devices()[:4]))),
    ):
        for stream in (False, True):
            outs = {}
            for name, wf, opts in (("torch", twf, kw), ("jax", jwf, jkw)):
                fn = wf.count_one_factory(k, stream=stream, batch_size=8, **opts)
                outs[name] = [(fn(s, str(tmp_path / f"{name}_{label}_{i}")),
                               (tmp_path / f"{name}_{label}_{i}").read_bytes())
                              for i, s in enumerate(shards)]
            assert outs["torch"] == outs["jax"], (label, stream)
            assert all(b for _, b in outs["torch"]), (label, stream)
    fn = twf.count_one_factory(12, device="cpu", nonzero=True, seqpar=True,
                               mesh=make_seq_mesh(cpus))
    with pytest.raises(ValueError, match="^seqpar does not compose with per-read k > 8"):
        fn(shards[0], str(tmp_path / "refused"))


def test_many_tasks_on_many_threads(tmp_path):
    """More workers than cores, a short switch interval: every shard's
    bytes are its single-task run's, each task is booked once in the
    provenance."""
    shards = _shards(tmp_path, n=12, reads=6, seed=3)
    fn = twf.count_one_factory(5, device="cpu", nonzero=True)
    want = []
    for i, s in enumerate(shards):
        fn(s, str(tmp_path / f"one{i}.cfrk"))
        want.append((tmp_path / f"one{i}.cfrk").read_bytes())
    prov = tmp_path / "prov.jsonl"
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        res = twf.run_workflow(
            [(s, str(tmp_path / f"many{i}.cfrk")) for i, s in enumerate(shards)], fn,
            max_parallel_tasks=16, provenance_path=str(prov))
    finally:
        sys.setswitchinterval(old)
    assert res.ok and [t.reads for t in res.tasks] == [6] * 12
    assert [Path(t.output).read_bytes() for t in res.tasks] == want
    records = twf.query_provenance(str(prov))
    assert sorted(r["input"] for r in records) == sorted(shards)


def _jax_merge_tool():
    """tools/merge_outputs.py, the JAX package's script, as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent.parent / "tools" / "merge_outputs.py"
    spec = importlib.util.spec_from_file_location("jax_merge_outputs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "mode,argv,fmt,out_name",
    [("perread", ["-k", "4", "--nonzero"], None, "all.cfrk"),
     ("perread", ["-k", "3"], None, "all.cfrk.gz"),
     ("spectrum", ["-k", "5", "--mode", "spectrum"], "cfrk", "all.spectrum"),
     ("spectrum", ["-k", "5", "--mode", "spectrum", "--spectrum-format", "npy"], "npy",
      "all.npy"),
     ("spectrum", ["-k", "5", "--mode", "spectrum", "--spectrum-format", "tsv"], "tsv",
      "all.tsv.gz"),
     ("sparse", ["-k", "19", "--canonical", "--mode", "sparse"], None, "all.kmers.tsv")],
    ids=["perread_nonzero", "perread_dense_gz", "spectrum_cfrk", "spectrum_npy",
         "spectrum_tsv_gz", "sparse"],
)
def test_merge_outputs_matches_jax_tool_and_single_run(tmp_path, monkeypatch, mode, argv,
                                                       fmt, out_name):
    """A multi-file run's parts (one of them empty) merge to the bytes
    of tools/merge_outputs.py over the same parts, and to the bytes of
    one run over the concatenated shards."""
    import gzip

    from cfrk_tpu_torch.cli import main
    from cfrk_tpu_torch.tools import merge_outputs

    monkeypatch.chdir(tmp_path)
    shards = _shards(tmp_path, n=3, reads=8, seed=9)
    Path(shards[1]).write_bytes(b"")
    assert main([*shards, *argv, "--out-dir", "parts", "--device", "cpu"]) == 0
    suffix = {"perread": ".cfrk", "spectrum": ".spectrum", "sparse": ".kmers.tsv"}[mode]
    parts = [str(tmp_path / "parts" / (Path(s).stem + suffix)) for s in shards]
    if mode == "spectrum" and fmt != "cfrk":
        parts = parts[::2]  # an empty shard's npy/tsv part sums like any other
    flags = ["--mode", mode] + (["--format", fmt] if fmt else [])
    assert merge_outputs.main([*parts, "-o", "torch_" + out_name, *flags]) == 0
    jtool = _jax_merge_tool()
    monkeypatch.setattr(sys, "argv", ["merge_outputs.py", *parts, "-o", "jax_" + out_name,
                                      *flags])
    assert jtool.main() == 0
    read = (lambda p: gzip.decompress(Path(p).read_bytes())) if out_name.endswith(".gz") \
        else (lambda p: Path(p).read_bytes())
    got = read("torch_" + out_name)
    assert got and got == read("jax_" + out_name)
    (tmp_path / "all.fa").write_bytes(b"".join(Path(s).read_bytes() for s in shards))
    single = "single_" + out_name
    extra = [] if fmt in (None, "cfrk") else ["--spectrum-format", fmt]
    assert main(["all.fa", "-o", single, *argv, *extra, "--device", "cpu"]) == 0
    assert read(single) == got


def test_merge_outputs_refuses_hist_parts(tmp_path):
    from cfrk_tpu_torch.tools import merge_outputs

    part = tmp_path / "p.hist"
    part.write_text("1\t3\n")
    with pytest.raises(SystemExit, match="not mergeable"):
        merge_outputs.main([str(part), "-o", str(tmp_path / "o"), "--mode", "spectrum",
                            "--format", "hist"])
    with pytest.raises(SystemExit, match="missing part"):
        merge_outputs.main([str(tmp_path / "none"), "-o", "o", "--mode", "perread"])
