"""The sorted and sparse streaming spectra of cfrk_tpu_torch
(``pipeline/stream.stream_sparse_spectrum_file``, the sorted hand-over
of ``stream_spectrum_file``) and the spilling accumulator
(``ops/sparse.SpillingSparseAccumulator``): the port's counterpart of
the sparse cases of tests/test_stream.py and tests/test_sparse.py.

The same seeded inputs go through the port (``device="cpu"``, the plain
route) and through ``cfrk_tpu`` (run as the JAX package's own tests run
it on the CPU).  Tolerance: exact equality of keys, counts, tables,
checkpoint files and spill runs.
"""

import concurrent.futures
import gzip
import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cfrk_tpu.ops import sparse as jsparse
from cfrk_tpu.pipeline import stream as jstream
from cfrk_tpu.runtime import faults as jfaults
from cfrk_tpu_torch.ops import sparse as tsparse
from cfrk_tpu_torch.ops.sparse import SparseAccumulator, SpillingSparseAccumulator
from cfrk_tpu_torch.pipeline import stream as tstream
from cfrk_tpu_torch.pipeline.count import _use_sorted_spectrum, sparse_spectrum_file
from cfrk_tpu_torch.runtime import faults
from cfrk_tpu_torch.runtime.checkpoint import (
    StreamCheckpoint,
    checkpoint_path,
    cleanup_checkpoint,
    spill_dir_path,
)
from cfrk_tpu_torch.runtime.metrics import malloc_trim, pin_malloc_for_streaming

_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    jfaults.disarm()


def _random_reads(n, seed, lo=40, hi=90, n_frac=0.02):
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi))
        r = rng.integers(0, 4, size=ln).astype(np.int8)
        r[rng.random(ln) < n_frac] = -1
        reads.append(r)
    return reads


def _write_fasta(path, reads):
    with open(path, "wb") as f:
        for i, codes in enumerate(reads):
            f.write(b">r%d\n" % i + _LUT[np.where(codes < 0, 4, codes)].tobytes() + b"\n")
    return path


def _torch_sparse(path, k, **kw):
    return tstream.stream_sparse_spectrum_file(path, k, device="cpu", **kw)


def _assert_same(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int64


# ------------------------------------------------------------ the driver


@pytest.mark.parametrize("k,canonical", [(4, False), (9, True), (13, False),
                                         (15, True), (21, False), (31, True)])
def test_stream_sparse_spectrum_matches_jax(tmp_path, k, canonical):
    """Keys and counts equal cfrk_tpu's streamed run and the port's
    one-shot driver, with interior folds (merge_every=2)."""
    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(30, 11))
    got = _torch_sparse(fasta, k, canonical=canonical, batch_size=8, merge_every=2)
    want = jstream.stream_sparse_spectrum_file(
        fasta, k, canonical=canonical, batch_size=8, merge_every=2)
    _assert_same(got, want)
    assert dict(zip(got[0].tolist(), got[1].tolist())) == sparse_spectrum_file(
        fasta, k, device="cpu", canonical=canonical)
    assert got[2].reads == got[2].total_reads == 30 and got[2].batches == 4


def _all_t_windows(reads, k):
    return sum(int((np.convolve(r == 3, np.ones(k, int), "valid") == k).sum())
               for r in reads if len(r) >= k)


def test_stream_sparse_16T_prefix_at_k31(tmp_path):
    """Reads holding 16 or more T bases: at k = 31 the JAX package's hi
    word of those k-mers equals its hi sentinel; the port packs one
    uint64 key and masks by count before packing, so both count them
    alike."""
    reads = _random_reads(12, 3)
    reads[4] = np.concatenate([np.full(40, 3, np.int8), reads[4]])
    reads[7] = np.concatenate([reads[7][:10], np.full(31, 3, np.int8)])
    reads[9] = np.concatenate([np.full(16, 3, np.int8), reads[9]])
    fasta = _write_fasta(tmp_path / "t.fasta", reads)
    for canonical in (False, True):
        got = _torch_sparse(fasta, 31, canonical=canonical, batch_size=4)
        _assert_same(got, jstream.stream_sparse_spectrum_file(
            fasta, 31, canonical=canonical, batch_size=4))
        if not canonical:
            polyt = 4**31 - 1  # 31 T bases
            assert dict(zip(got[0].tolist(), got[1].tolist()))[polyt] == \
                _all_t_windows(reads, 31) >= 11


@pytest.mark.parametrize("writer", ["torch", "jax"])
@pytest.mark.parametrize("resumer", ["torch", "jax"])
def test_stream_sparse_resume_from_either_package(tmp_path, writer, resumer):
    """A checkpoint written with either package's ``save_sparse`` after 2
    of 3 batches is resumed by either package to the uninterrupted
    result; the ``.npz`` sidecar has the same name and members."""
    from cfrk_tpu.runtime.checkpoint import StreamCheckpoint as JaxCheckpoint
    from cfrk_tpu_torch.ops.perread_sparse import batch_spectrum_triples

    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(24, 12, lo=40, hi=80))
    k = 17
    want = _torch_sparse(fasta, k, batch_size=8)
    acc = SparseAccumulator()
    for batch in list(tstream.stream_batches(fasta, k, 8))[:2]:
        acc.add(*batch_spectrum_triples(batch.codes, k, device="cpu"))
    cls = {"torch": StreamCheckpoint, "jax": JaxCheckpoint}[writer]
    out = tmp_path / "o.kmers"
    cpath = checkpoint_path(out)
    ckpt = cls(fingerprint=cls.fingerprint_of(fasta, k, "sparse", False), reads_done=16)
    ckpt.save_sparse(cpath, *acc.result_arrays())
    ckpt.save(cpath)
    assert Path(ckpt.spectrum_path).name == "o.kmers.ckpt.json.sparse.16.npz"
    with np.load(ckpt.spectrum_path) as z:
        assert sorted(z.files) == ["counts", "keys"]
    finish = {"torch": _torch_sparse, "jax": jstream.stream_sparse_spectrum_file}[resumer]
    got = finish(fasta, k, batch_size=8, out_path=out, resume=True)
    _assert_same(got, want)
    assert got[2].reads == 8 and got[2].total_reads == 24
    assert not list(tmp_path.glob("o.kmers.ckpt.json*"))
    with pytest.raises(ValueError, match="no sparse accumulator"):
        StreamCheckpoint(fingerprint={}).load_sparse()


@pytest.mark.parametrize("first", ["jax", "torch"])
@pytest.mark.parametrize("budget", [None, 1], ids=["npz", "spill"])
@pytest.mark.parametrize("k", [8, 16])
def test_cross_package_sparse_checkpoint(tmp_path, first, budget, k):
    """A sparse run of one package killed at its 2nd checkpoint is
    resumed by the other to the uninterrupted result: the JSON, the
    ``.npz`` sidecar and the spill runs are interchangeable."""
    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(40, 17))
    kw = dict(batch_size=8, checkpoint_every=1, mem_budget_mb=budget)
    want = _torch_sparse(fasta, k, batch_size=8)
    out = tmp_path / "x.kmers"
    runs = {"jax": (jstream.stream_sparse_spectrum_file, jfaults),
            "torch": (_torch_sparse, faults)}
    (start, start_faults), (finish, _) = runs[first], runs["torch" if first == "jax" else "jax"]
    start_faults.arm("checkpoint", 2)
    with pytest.raises(start_faults.InjectedFault):
        start(fasta, k, out_path=out, cleanup=False, **kw)
    state = json.loads(Path(checkpoint_path(out)).read_text())
    assert state["reads_done"] == 16
    if budget and k > 10:  # k <= 10 folds densely, with no budget
        assert state["sparse_runs"] == ["run00000", "run00001"]
        assert state["spectrum_path"] is None
    else:
        assert state["sparse_runs"] is None and state["spectrum_path"].endswith(".16.npz")
    got = finish(fasta, k, out_path=out, resume=True, **kw)
    _assert_same(got, want)
    assert got[2].reads == 24 and got[2].total_reads == 40
    assert not list(tmp_path.glob("x.kmers.ckpt.json*"))


@pytest.mark.parametrize("k", [12, 16])
def test_checkpoint_and_spill_runs_equal_the_jax_packages(tmp_path, k):
    """The same budgeted run killed at the same checkpoint leaves the
    same JSON (apart from its directory) and byte-identical spill runs
    in both packages."""
    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(40, 19))
    states, runs = {}, {}
    for name, fn, fl in (("torch", _torch_sparse, faults),
                         ("jax", jstream.stream_sparse_spectrum_file, jfaults)):
        d = tmp_path / name
        d.mkdir()
        fl.arm("checkpoint", 3)
        with pytest.raises(fl.InjectedFault):
            fn(fasta, k, batch_size=8, out_path=d / "o", mem_budget_mb=1,
               checkpoint_every=1, cleanup=False)
        states[name] = json.loads((d / "o.ckpt.json").read_text())
        spill = Path(spill_dir_path(str(d / "o.ckpt.json")))
        runs[name] = {p.name: p.read_bytes() for p in sorted(spill.iterdir())}
    assert states["torch"] == states["jax"]
    assert sorted(runs["torch"]) == [f"run0000{i}.{p}.npy" for i in range(3)
                                     for p in ("counts", "keys")]
    assert runs["torch"] == runs["jax"]


def test_stream_sparse_mem_budget_byte_identical(tmp_path):
    """Disk-spilled runs and the chunked merge equal the unbounded
    accumulator and cfrk_tpu's budgeted run; no spill directory
    remains after a clean finish."""
    rng = np.random.default_rng(31)
    reads = [rng.integers(0, 4, size=100).astype(np.int8) for _ in range(600)]
    fasta = _write_fasta(tmp_path / "in.fasta", reads)
    k, bs = 16, 64
    want = _torch_sparse(fasta, k, batch_size=bs)
    got = _torch_sparse(fasta, k, batch_size=bs, out_path=tmp_path / "s.tsv",
                        mem_budget_mb=1, checkpoint_every=2)
    _assert_same(got, want)
    _assert_same(got, jstream.stream_sparse_spectrum_file(
        fasta, k, batch_size=bs, out_path=tmp_path / "j.tsv", mem_budget_mb=1,
        checkpoint_every=2))
    assert not [p for p in os.listdir(tmp_path) if ".spill" in p or ".ckpt" in p]


def test_stream_sparse_budget_without_checkpoints_spills_and_cleans(tmp_path):
    """A budget with no checkpoint written (the run is shorter than
    ``checkpoint_every``) still spills by the budget and removes its
    runs; ``finalize="accumulator"`` leaves them to the caller."""
    rng = np.random.default_rng(32)
    reads = [rng.integers(0, 4, size=120).astype(np.int8) for _ in range(900)]
    fasta = _write_fasta(tmp_path / "in.fasta", reads)
    want = _torch_sparse(fasta, 20, batch_size=64)
    out = tmp_path / "s.tsv"
    acc, none, m = _torch_sparse(fasta, 20, batch_size=64, out_path=out, mem_budget_mb=1,
                                 checkpoint_every=10**6, finalize="accumulator")
    assert none is None and isinstance(acc, SpillingSparseAccumulator)
    assert len(acc.run_files) >= 2 and os.path.isdir(acc.spill_dir)
    got = [np.concatenate(x) for x in zip(*acc.iter_merged_chunks())]
    _assert_same(got, want)
    cleanup_checkpoint(out)
    assert not os.path.exists(acc.spill_dir)
    got = _torch_sparse(fasta, 20, batch_size=64, out_path=out, mem_budget_mb=1,
                        checkpoint_every=10**6)
    _assert_same(got, want)
    assert not os.path.exists(acc.spill_dir)


def test_stream_sparse_budget_needs_out_path(tmp_path):
    fasta = _write_fasta(tmp_path / "in.fasta", _random_reads(1, 0))
    with pytest.raises(ValueError, match="out_path"):
        _torch_sparse(fasta, 16, mem_budget_mb=1)
    with pytest.raises(ValueError, match="out_path"):
        jstream.stream_sparse_spectrum_file(fasta, 16, mem_budget_mb=1)


def test_stream_sparse_gzip_byte_range_rejected(tmp_path):
    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(3, 1))
    gz = tmp_path / "r.fasta.gz"
    gz.write_bytes(gzip.compress(fasta.read_bytes()))
    with pytest.raises(ValueError, match="gzip"):
        _torch_sparse(gz, 31, byte_range=(0, 100))
    with pytest.raises(ValueError, match="gzip"):
        jstream.stream_sparse_spectrum_file(gz, 31, byte_range=(0, 100))


@pytest.mark.parametrize("kind", ["gzip", "bgzf", "byte_range"])
def test_stream_sparse_inputs_match_jax(tmp_path, kind):
    """Gzip and bgzf inputs, and a byte range of a plain file."""
    from cfrk_tpu_torch.io.bgzf import write_bgzf

    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(30, 13))
    kw = {}
    if kind == "gzip":
        path = tmp_path / "r.fasta.gz"
        path.write_bytes(gzip.compress(fasta.read_bytes()))
    elif kind == "bgzf":
        path = tmp_path / "r.bgzf.gz"
        write_bgzf(path, fasta.read_bytes())
    else:
        path = fasta
        size = os.path.getsize(fasta)
        kw["byte_range"] = (size // 3, 2 * size // 3)
    got = _torch_sparse(path, 14, batch_size=8, **kw)
    _assert_same(got, jstream.stream_sparse_spectrum_file(path, 14, batch_size=8, **kw))


def test_stream_sparse_stage_names_match_jax(tmp_path):
    """The same stage names as the JAX driver; the fold is booked once,
    under "fold_bg" (never also under "fold"), and a checkpointed run
    books "checkpoint"."""
    fasta = _write_fasta(tmp_path / "in.fasta", _random_reads(40, 3, lo=60, hi=61))
    _, _, m = _torch_sparse(fasta, 16, batch_size=8)
    _, _, jm = jstream.stream_sparse_spectrum_file(fasta, 16, batch_size=8)
    assert set(m.stages) == set(jm.stages) == {"parse_wait", "dispatch", "materialize",
                                               "fold_bg", "fold_wait"}
    _, _, m = _torch_sparse(fasta, 16, batch_size=8, out_path=tmp_path / "o",
                            checkpoint_every=2)
    assert "checkpoint" in m.stages and "fold" not in m.stages


def test_fold_booked_once(tmp_path, monkeypatch):
    """Each batch's fold lands in "fold_bg" exactly once: with every fold
    made to take 50 ms, "fold_bg" holds the folds' own time (not twice
    it), they ran on the worker, and no "fold" stage exists; the main
    thread's waits are "fold_wait"."""
    fasta = _write_fasta(tmp_path / "in.fasta", _random_reads(40, 5))
    real_add = SparseAccumulator.add
    calls = []

    def slow_add(self, *a):
        t0 = time.perf_counter()
        time.sleep(0.05)
        real_add(self, *a)
        calls.append((threading.current_thread().name, time.perf_counter() - t0))

    monkeypatch.setattr(SparseAccumulator, "add", slow_add)
    _, _, m = _torch_sparse(fasta, 20, batch_size=8)
    assert len(calls) == 5 and all(n.startswith("cfrk-fold") for n, _ in calls)
    spent = sum(t for _, t in calls)
    assert "fold" not in m.stages and "fold_wait" in m.stages
    assert spent <= m.stages["fold_bg"] < 1.5 * spent


def test_fold_error_shuts_the_executor_down(tmp_path, monkeypatch):
    """A fold that raises surfaces in the caller, and the fold thread
    does not outlive the call."""
    fasta = _write_fasta(tmp_path / "in.fasta", _random_reads(40, 6))

    def broken(self, *a):
        raise RuntimeError("fold failed")

    monkeypatch.setattr(SparseAccumulator, "add", broken)
    shut = []
    real_shutdown = concurrent.futures.ThreadPoolExecutor.shutdown

    def shutdown(self, *a, **kw):
        shut.append(kw)
        return real_shutdown(self, *a, **kw)

    monkeypatch.setattr(concurrent.futures.ThreadPoolExecutor, "shutdown", shutdown)
    with pytest.raises(RuntimeError, match="fold failed"):
        _torch_sparse(fasta, 20, batch_size=8)
    assert shut and shut[-1].get("wait", True)
    assert not [t for t in threading.enumerate() if t.name.startswith("cfrk-fold")]


def test_host_buffers_released_only_after_their_fold(tmp_path, monkeypatch):
    """A batch's host buffers go back to the pipeline only once its fold
    has finished reading them (on the card they are pinned buffers that
    the next batch reuses)."""
    fasta = _write_fasta(tmp_path / "in.fasta", _random_reads(60, 7))
    order = []
    real_add = SparseAccumulator.add

    def add(self, *a):
        time.sleep(0.02)
        real_add(self, *a)
        order.append("folded")

    real_release = tstream._BatchPipeline.release

    def release(self, job):
        order.append("released")
        real_release(self, job)

    monkeypatch.setattr(SparseAccumulator, "add", add)
    monkeypatch.setattr(tstream._BatchPipeline, "release", release)
    got = _torch_sparse(fasta, 12, batch_size=8)
    assert order.count("released") == order.count("folded") == 8
    # Folds finish in order on one worker and jobs are released in
    # order, so the n-th release must come after the n-th fold.
    for i in range(len(order)):
        assert order[: i + 1].count("released") <= order[: i + 1].count("folded")
    monkeypatch.undo()
    _assert_same(got, jstream.stream_sparse_spectrum_file(fasta, 12, batch_size=8))


def test_stream_sparse_total_reads_of_a_complete_run(tmp_path):
    """A resume whose checkpoint already covers every read counts none
    anew and reports them all in ``total_reads``."""
    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(16, 21))
    out = tmp_path / "o"
    want = _torch_sparse(fasta, 18, batch_size=8)
    ckpt = StreamCheckpoint(
        fingerprint=StreamCheckpoint.fingerprint_of(fasta, 18, "sparse", False),
        reads_done=16, input_offset=os.path.getsize(fasta))
    ckpt.save_sparse(checkpoint_path(out), *want[:2])
    ckpt.save(checkpoint_path(out))
    got = _torch_sparse(fasta, 18, batch_size=8, out_path=out, resume=True)
    _assert_same(got, want)
    assert got[2].reads == 0 and got[2].total_reads == 16


def test_malloc_helpers_run():
    """The glibc helpers run here (glibc) and never raise elsewhere."""
    assert pin_malloc_for_streaming() in (True, False)
    malloc_trim()


# --------------------------------------------- the sorted hand-over


@pytest.mark.parametrize("k,canonical", [(5, False), (9, True), (10, False), (11, True)])
def test_stream_spectrum_sort_route_matches_jax(tmp_path, k, canonical):
    """``impl="sort"`` streams through the sparse driver (a dense fold
    for k <= 10) and densifies: equal to cfrk_tpu's streamed sorted
    spectrum and to the port's own scatter route."""
    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(40, 33, lo=20, hi=160))
    got, m = tstream.stream_spectrum_file(fasta, k, device="cpu", impl="sort",
                                          canonical=canonical, batch_size=16,
                                          out_path=tmp_path / "s")
    want, jm = jstream.stream_spectrum_file(fasta, k, impl="sort", canonical=canonical,
                                            batch_size=16, out_path=tmp_path / "j")
    np.testing.assert_array_equal(got, np.asarray(want))
    scatter, _ = tstream.stream_spectrum_file(fasta, k, device="cpu", impl="scatter",
                                              canonical=canonical, batch_size=16)
    np.testing.assert_array_equal(got, scatter)
    assert m.mode == jm.mode == "sparse" and m.reads == 40
    assert set(m.stages) == set(jm.stages)


def test_stream_spectrum_sort_route_resume(tmp_path):
    """Kill at the 2nd checkpoint of the sorted route at k = 9 (the dense
    fold accumulator's ``.npz``) and resume in the other package."""
    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(60, 34, lo=20, hi=160))
    want, _ = jstream.stream_spectrum_file(fasta, 9, impl="sort", batch_size=16)
    for first, (start, fl), finish in (
            ("torch", (tstream.stream_spectrum_file, faults), jstream.stream_spectrum_file),
            ("jax", (jstream.stream_spectrum_file, jfaults), tstream.stream_spectrum_file)):
        out = tmp_path / f"{first}.spectrum"
        extra_start = {"device": "cpu"} if first == "torch" else {}
        extra_finish = {} if first == "torch" else {"device": "cpu"}
        fl.arm("checkpoint", 2)
        with pytest.raises(fl.InjectedFault):
            start(fasta, 9, impl="sort", batch_size=16, out_path=out,
                  checkpoint_every=1, cleanup=False, **extra_start)
        got, m = finish(fasta, 9, impl="sort", batch_size=16, out_path=out,
                        resume=True, checkpoint_every=1, **extra_finish)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert m.reads == 28 and m.total_reads == 60
        assert not list(tmp_path.glob(f"{first}.spectrum.ckpt.json*"))


def test_dense_fold_accumulator_add_pairs_matches_jax():
    """``add_pairs`` on the drain's narrow dtypes (the int16 bit view of
    uint16 idx at k <= 8, uint8 / int16 counts) equals the JAX
    accumulator's, with no sign error on idx >= 2**15."""
    rng = np.random.default_rng(8)
    for k, idx_dt in ((8, np.int16), (10, np.int32)):
        t, j = tsparse.DenseFoldAccumulator(k), jsparse.DenseFoldAccumulator(k)
        for cnt_dt in (np.uint8, np.int16):
            idx = rng.integers(0, 4**k, size=(16, 40)).astype(np.int64)
            cnt = rng.integers(0, 4, size=(16, 40)).astype(cnt_dt)
            t.add_pairs(idx.astype(idx_dt), cnt)
            j.add_pairs(idx.astype(np.uint16 if idx_dt == np.int16 else np.int32), cnt)
        assert (idx >= 2**15).any()
        _assert_same(t.result_arrays(), j.result_arrays())
        _assert_same([np.concatenate(x) for x in zip(*t.iter_merged_chunks(chunk=7))],
                     j.result_arrays())


def test_use_sorted_spectrum_rule_without_a_card():
    """The streamed route follows the in-memory rule: ``sort`` anywhere,
    ``auto`` at k = 11-15 only on a CUDA device."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for k in range(1, 16):
        assert _use_sorted_spectrum(k, "sort", cpu)
        assert _use_sorted_spectrum(k, "auto", cuda) == (k >= 11)
        assert not _use_sorted_spectrum(k, "auto", cpu)
        assert not _use_sorted_spectrum(k, "scatter", cuda)


# ----------------------------------------------------- the accumulators


def _feed(rng, accs, n_batches=30, keyspace=600, hi_words=False):
    """Collision-heavy random triples into every accumulator of
    ``accs``; returns the dict oracle."""
    oracle: dict = {}
    for _ in range(n_batches):
        n = int(rng.integers(1, 200))
        lo = rng.integers(0, keyspace, n).astype(np.int64)
        hi = rng.integers(0, 3, n).astype(np.int64) if hi_words else np.zeros(n, np.int64)
        counts = rng.integers(0, 4, n).astype(np.int64)
        for acc in accs:
            acc.add(hi, lo, counts)
        for h, key, c in zip(hi.tolist(), lo.tolist(), counts.tolist()):
            if c > 0:
                code = (h << 30) | key
                oracle[code] = oracle.get(code, 0) + c
    return oracle


def test_sparse_accumulator_result_matches_merge():
    """``result()`` equals ``merge_sorted_spectra`` of the same triples
    and both equal the JAX package's, with interior folds."""
    from cfrk_tpu_torch.ops.perread_sparse import batch_spectrum_triples

    acc, jacc, parts = SparseAccumulator(merge_every=2), jsparse.SparseAccumulator(2), []
    for seed in range(5):
        codes = np.random.default_rng(seed).integers(0, 4, size=(6, 50)).astype(np.int8)
        trip = batch_spectrum_triples(codes, 20, device="cpu")
        parts.append(trip)
        acc.add(*trip)
        jacc.add(*trip)
    assert acc.result() == tsparse.merge_sorted_spectra(parts) == jacc.result() \
        == jsparse.merge_sorted_spectra(parts)
    keys, counts = acc.result_arrays()
    assert keys.tolist() == sorted(keys.tolist())
    assert int(counts.sum()) == sum(tsparse.merge_sorted_spectra(parts).values())


def test_sparse_accumulator_fold_fuzz():
    """The searchsorted fold is exact against a dict oracle across heavy
    overlap, all-hit and all-new folds, with nonzero hi words."""
    rng = np.random.default_rng(7)
    acc = SparseAccumulator(merge_every=3)
    oracle = _feed(rng, [acc], n_batches=20, keyspace=37, hi_words=True)
    acc.add(np.zeros(8, np.int64), np.zeros(8, np.int64), np.zeros(8, np.int64))
    keys, counts = acc.result_arrays()
    assert dict(zip(keys.tolist(), counts.tolist())) == oracle
    assert keys.tolist() == sorted(keys.tolist())


@pytest.mark.parametrize("budget,merge_every", [(3 * 4096, 2), (3 * 2048, 1), (1, 1)])
def test_spilling_accumulator_matches_unbounded_and_jax(tmp_path, budget, merge_every):
    """A budget small enough to force many runs gives the unbounded
    result; the run files are byte-identical to the JAX accumulator's
    fed the same triples, and ``cleanup_spill`` removes them."""
    acc = SpillingSparseAccumulator(str(tmp_path / "t"), budget, merge_every=merge_every)
    jacc = jsparse.SpillingSparseAccumulator(str(tmp_path / "j"), budget,
                                             merge_every=merge_every)
    ref = SparseAccumulator(merge_every=merge_every)
    oracle = _feed(np.random.default_rng(101), [acc, jacc, ref], hi_words=True)
    assert len(acc.run_files) >= 2 and acc.run_files == jacc.run_files
    for b in acc.run_files:
        for part in ("keys", "counts"):
            name = f"{b}.{part}.npy"
            assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    _assert_same(acc.result_arrays(), ref.result_arrays())
    assert acc.result() == oracle
    acc.cleanup_spill()
    assert not (tmp_path / "t").exists()


def test_spilling_chunked_merge_exact(tmp_path):
    """``iter_merged_chunks``: tiny chunks, every key in one chunk,
    strictly ascending across chunks, sums exact; the JAX accumulator
    merges the port's runs to the same chunks."""
    acc = SpillingSparseAccumulator(str(tmp_path / "spill"), 3 * 2048, merge_every=1)
    ref = SparseAccumulator(merge_every=1)
    _feed(np.random.default_rng(7), [acc, ref], n_batches=25, keyspace=2000)
    assert len(acc.run_files) >= 2
    chunks = list(acc.iter_merged_chunks(chunk=17))
    allk = np.concatenate([c[0] for c in chunks])
    allc = np.concatenate([c[1] for c in chunks])
    assert (np.diff(allk.astype(np.int64)) > 0).all()
    _assert_same((allk, allc), ref.result_arrays())
    for a, b in zip(chunks, chunks[1:]):
        assert a[0][-1] < b[0][0]
    jacc = jsparse.SpillingSparseAccumulator(str(tmp_path / "spill"), 3 * 2048, 1)
    jacc.adopt_runs(acc.checkpoint_runs())
    jchunks = list(jacc.iter_merged_chunks(chunk=17))
    assert len(jchunks) == len(list(acc.iter_merged_chunks(chunk=17)))
    _assert_same([np.concatenate(x) for x in zip(*jchunks)], ref.result_arrays())


def test_spilling_adopt_runs_drops_stale(tmp_path):
    """Resume discipline: spill files missing from the checkpointed run
    list are deleted; a listed run that is missing raises."""
    d = str(tmp_path / "spill")
    acc = SpillingSparseAccumulator(d, budget_bytes=1, merge_every=1)
    acc.add(np.zeros(3), np.array([1, 2, 3]), np.array([1, 1, 1]))
    committed = acc.checkpoint_runs()
    acc.add(np.zeros(3), np.array([4, 5, 6]), np.array([1, 1, 1]))
    acc.checkpoint_runs()  # a run the checkpoint JSON never saw
    assert len(acc.run_files) == 2
    (tmp_path / "spill" / "run00009.keys.npy.tmp.npy").write_bytes(b"torn")
    fresh = SpillingSparseAccumulator(d, budget_bytes=1, merge_every=1)
    fresh.adopt_runs(committed)
    assert fresh.result_arrays()[0].tolist() == [1, 2, 3]
    assert sorted(os.listdir(d)) == ["run00000.counts.npy", "run00000.keys.npy"]
    fresh.add(np.zeros(1), np.array([7]), np.array([2]))
    assert fresh.checkpoint_runs() == ["run00000", "run00001"]
    with pytest.raises(ValueError, match="missing"):
        SpillingSparseAccumulator(d, budget_bytes=1).adopt_runs(["run99999"])


def test_merge_chunk_stays_within_the_budget(tmp_path, monkeypatch):
    """With many runs the default merge chunk keeps a pass within the
    budget (the JAX package floors it at 1 Mi keys a run, which a small
    budget with many runs exceeds); the windows read never pass it, and
    the result is the same."""
    budget = 64 << 10
    acc = SpillingSparseAccumulator(str(tmp_path / "s"), budget, merge_every=1)
    ref = SparseAccumulator(merge_every=1)
    _feed(np.random.default_rng(3), [acc, ref], n_batches=200, keyspace=10**6)
    n_runs = len(acc.run_files) + 1
    assert n_runs >= 8
    chunk = acc.merge_chunk(n_runs)
    assert 1 <= chunk and chunk * 6 * 16 * n_runs <= budget
    assert acc.merge_chunk(1) == budget // 96 and acc.merge_chunk(10**9) == 1
    reads = []
    real_read = tsparse._RunArray.read

    def read(self, start, count):
        reads.append(count)
        return real_read(self, start, count)

    monkeypatch.setattr(tsparse._RunArray, "read", read)
    got = [np.concatenate(x) for x in zip(*acc.iter_merged_chunks())]
    assert max(reads) <= chunk + 1 and max(reads) * 16 * n_runs * 6 <= budget + 96 * n_runs
    _assert_same(got, ref.result_arrays())
