"""The port's spans and counters (``cfrk_tpu_torch/runtime/metrics.py``):
off without a profiler, recorded and on the Chrome trace's clock under
one, nested per thread, bounded, and placed at the dispatcher, the
kernel wrappers, the library build and load, and the drivers' stages."""

import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cfrk_tpu_torch.ops.cuda import build
from cfrk_tpu_torch.ops.perread_sparse import count_perread_rows
from cfrk_tpu_torch.runtime import metrics as M
from cfrk_tpu_torch.runtime.metrics import RunMetrics

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_registry():
    M.reset()
    yield
    M.reset()


def _codes(b=12, length=40, seed=3):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, length)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.03] = -1
    return torch.from_numpy(codes)


def _traced(fn, path=None):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    if path is not None:
        prof.export_chrome_trace(str(path))
    return out


def _by_name(name):
    return [r for r in M.spans() if r.name == name]


def test_without_a_profiler_no_span_is_recorded_or_annotated(monkeypatch):
    def refuse(name, *args):
        raise AssertionError(f"record function {name!r} entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._autograd, "_record_function_with_args_enter", refuse)
    assert M.span("cfrk.x") is M.span("cfrk.y")
    with M.span("cfrk.x"):
        count_perread_rows(_codes(), 8)
    assert M.traced("cfrk.x", len, "abc") == 3
    with RunMetrics().stage("parse"):
        pass
    assert M.spans() == []
    assert M.counters()["cfrk.rows.calls"] == 1


def test_a_traced_cpu_call_is_one_rows_span_with_its_plain_child():
    _traced(lambda: count_perread_rows(_codes(), 8))
    (rows,) = _by_name("cfrk.rows")
    (plain,) = _by_name("cfrk.rowsort_rle.plain")
    assert rows.parent == 0 and not rows.once
    assert plain.parent == rows.id and plain.request == rows.request
    assert rows.start_ns <= plain.start_ns <= plain.end_ns <= rows.end_ns


def test_spans_are_user_annotations_on_the_trace_clock(tmp_path):
    """Each record is a ``user_annotation`` event of the exported trace,
    and its start, placed by ``trace_us``, lies within 1 ms of the
    event's ``ts`` (the median over the calls: a single enter can be
    held up)."""
    path = tmp_path / "t.json"
    _traced(lambda: [count_perread_rows(_codes(), 31, True) for _ in range(5)], path)
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    for name in ("cfrk.rows", "cfrk.rowsort_rle_large.plain"):
        events = sorted(float(e["ts"]) for e in trace["traceEvents"]
                        if e.get("cat") == "user_annotation" and e["name"] == name)
        recs = sorted(M.trace_us(r.start_ns, base) for r in _by_name(name))
        assert len(events) == len(recs) == 5
        assert abs(statistics.median(r - e for r, e in zip(recs, events))) < 1000.0


def test_self_time_is_the_duration_less_the_children():
    def work():
        with M.span("cfrk.parent"):
            time.sleep(0.02)
            with M.span("cfrk.child"):
                time.sleep(0.03)

    _traced(work)
    (parent,) = _by_name("cfrk.parent")
    (child,) = _by_name("cfrk.child")
    assert child.parent == parent.id
    self_ns = (parent.end_ns - parent.start_ns) - (child.end_ns - child.start_ns)
    assert 0.02e9 <= self_ns < 0.03e9 <= child.end_ns - child.start_ns


def test_nesting_holds_in_each_thread():
    go = threading.Barrier(4)

    def worker(i):
        go.wait()
        for _ in range(20):
            with M.span(f"cfrk.outer{i}"):
                with M.span(f"cfrk.inner{i}"):
                    time.sleep(0)

    def work():
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)

    _traced(work)
    by_id = {r.id: r for r in M.spans()}
    for i in range(4):
        inner = _by_name(f"cfrk.inner{i}")
        outer = _by_name(f"cfrk.outer{i}")
        assert len(inner) == len(outer) == 20
        assert len({r.request for r in outer}) == 20
        for r in inner:
            up = by_id[r.parent]
            assert up.name == f"cfrk.outer{i}" and up.thread == r.thread
            assert up.request == r.request


def test_the_cap_keeps_the_first_records_and_counts_the_rest(monkeypatch):
    monkeypatch.setattr(M, "MAX_RECORDS", 3)

    def work():
        for _ in range(5):
            with M.span("cfrk.x"):
                pass

    _traced(work)
    assert len(M.spans()) == 3
    assert M.counters()[M.DROPPED] == 2


def test_counts_from_many_threads_are_all_kept():
    per, n_threads = 500, 4 * 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(per):
            M.count("cfrk.test")

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert M.counters()["cfrk.test"] == per * n_threads


@pytest.mark.parametrize("k,canonical,arrays", [(8, False, 2), (31, True, 3)])
def test_out_bytes_and_calls_are_counted_on_the_cpu_route(k, canonical, arrays):
    codes = _codes(b=10, length=50)
    for _ in range(3):
        count_perread_rows(codes, k, canonical)
    c = M.counters()
    assert c["cfrk.rows.calls"] == 3
    assert c[M.OUT_BYTES] == 3 * arrays * 4 * 10 * (50 - k + 1)
    assert c["cfrk.rowsort_rle.launches"] == 0 and c["cfrk.rowsort_rle_large.launches"] == 0


def test_the_tiled_route_is_one_call_with_a_tiled_child(monkeypatch):
    from cfrk_tpu_torch.ops import perread_sparse

    monkeypatch.setattr(perread_sparse, "rowsort_max_windows", lambda k: 16)
    _traced(lambda: count_perread_rows(_codes(b=4, length=40), 8))
    (rows,) = _by_name("cfrk.rows")
    (tiled,) = _by_name("cfrk.rows.tiled")
    assert tiled.parent == rows.id
    assert M.counters()["cfrk.rows.calls"] == 1
    assert _by_name("cfrk.narrow") and _by_name("cfrk.to_host")


def test_a_first_launch_is_a_once_span_then_launches_are_off():
    name = f"test_kernel_{time.perf_counter_ns()}"
    assert M.launch(name, max, 2, 5) == 5 and M.launch(name, max, 7, 1) == 7
    (first,) = M.spans()
    assert first.name == f"cfrk.{name}.first_launch" and first.once
    assert _traced(lambda: M.launch(name, min, 2, 5)) == 2
    assert [r.name for r in M.spans()][1:] == [f"cfrk.{name}.launch"]


def test_a_library_load_records_its_build_the_first_time_only(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    build.load_library.cache_clear()
    try:
        build.load_library("fastaio")
        build.load_library.cache_clear()
        build.load_library("fastaio")
    finally:
        build.load_library.cache_clear()
    loads = _by_name("cfrk.library.load.fastaio")
    (built,) = _by_name("cfrk.library.build.fastaio")
    assert len(loads) == 2 and all(r.once for r in loads) and built.once
    assert built.parent == loads[0].id and loads[0].parent == 0
    assert loads[0].end_ns - loads[0].start_ns >= built.end_ns - built.start_ns


def test_run_metrics_stages_are_spans_and_keep_their_totals():
    m = RunMetrics(k=3, mode="perread")

    def work():
        for _ in range(2):
            with m.stage("dispatch"):
                time.sleep(0.005)
        with m.stage("write"):
            pass

    _traced(work)
    assert [r.name for r in M.spans()] == ["cfrk.stage.dispatch"] * 2 + ["cfrk.stage.write"]
    d = m.to_dict()
    assert set(d["stages_s"]) == {"dispatch", "write"}
    assert d["stages_s"]["dispatch"] >= 0.01


def test_the_package_import_is_a_once_span_of_a_fresh_process():
    code = (
        "import cfrk_tpu_torch\n"
        "from cfrk_tpu_torch.runtime import metrics\n"
        "print([(r.name, r.parent, r.once, r.end_ns > r.start_ns) for r in metrics.spans()])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, check=True, timeout=120)
    assert out.stdout.strip() == "[('cfrk.import', 0, True, True)]"
