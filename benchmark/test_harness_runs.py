"""Whole runs of the harness, past its look for a card: a sound run is
correct; the same run with the timed path broken underneath, or with a
control in the program's place, is not."""

import json
import time

import pytest
import torch

from benchmark import control, harness, reads, spec
from benchmark.trace import WINDOW, Trace

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SMALL = 256  # reads a call on the CPU


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_cell(name):
    cell = spec.cell(name)
    cell.traffic = dict(cell.traffic, reads_per_call=SMALL)
    return cell


def run(cell, seed=2**31 + 99, trace=False, device=torch.device("cpu"), seconds=0.2):
    return harness.run_cell(cell, seed, seconds, trace, device, time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = run(small_cell(name))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in spec.cell(name).end_to_end}
    assert list(r)[-1] == "checks"
    assert r["checks"]["mismatched_cells"]["value"] == 0
    assert r["checks"]["calls_compared"]["value"] >= 2
    json.dumps(r)


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_the_per_layer_metrics_it_can_read(name):
    r = run(small_cell(name), trace=True)
    assert r["correct"]
    assert "host_us_per_call" in r["metrics"]
    assert set(r["metrics"]) <= {m["name"] for m in spec.cell(name).per_layer}
    assert r["device"]["window_s"] > 0 and set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _stale(real):
    last = []

    def route(codes, k, canonical=False):
        out = real(codes, k, canonical)
        if last:
            return last[0]
        last.append(out)
        return out
    return route


def _half(real):
    def route(codes, k, canonical=False):
        half = real(codes[: codes.shape[0] // 2], k, canonical)
        return tuple(torch.cat([h, torch.zeros_like(h)])[: codes.shape[0]] for h in half)
    return route


def _altered(real):
    def route(codes, k, canonical=False):
        out = tuple(a.clone() for a in real(codes, k, canonical))
        out[-1][0, 0] += 1
        return out
    return route


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    from cfrk_tpu_torch.ops import perread_sparse

    monkeypatch.setattr(perread_sparse, "count_perread_rows",
                        fault(perread_sparse.count_perread_rows))
    r = run(small_cell(name))
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["mismatched_cells"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = small_cell(name)
    entry = spec.load_module("entries", cell.traffic["entry"])
    out = control.readings(cell, [5, 2**31 + 6], 0.2, [None] + entry.controls(cell.config),
                           torch.device("cpu"))
    for r in out:
        assert r["correct"] == (r["variant"] == "program"), r


def test_the_same_seed_gives_the_same_reads():
    model = {"genomes": 3, "genome_len": 500, "mut_rate": 0.01, "n_rate": 0.01}
    a = reads.shards(2**32 + 1, 2, 50, 100, model, torch.device("cpu"))
    b = reads.shards(2**32 + 1, 2, 50, 100, model, torch.device("cpu"))
    c = reads.shards(2**32 + 2, 2, 50, 100, model, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    assert int(a[0].min()) == -1 and int(a[0].max()) == 3


def test_the_sample_is_drawn_from_the_seed():
    assert harness.sample(7, 1000, 6) == harness.sample(7, 1000, 6)
    assert harness.sample(7, 1000, 6) != harness.sample(8, 1000, 6)
    assert max(harness.sample(7, 1000, 6)) < 800 and harness.sample(7, 1, 6) == {0}


def _chrome(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace.from_chrome(path)


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_busy_gaps_and_breakdown(tmp_path):
    t = _chrome(tmp_path, [
        _x("user_annotation", WINDOW, 100, 100),
        _x("kernel", "void rowsort_rle_regs<false>", 90, 30),  # clipped to 100-120
        _x("kernel", "void rowsort_rle_regs<false>", 130, 40),
        _x("gpu_memset", "Memset", 160, 20),  # overlaps: union 130-180
        _x("kernel", "late", 250, 10),  # outside the window
        _x("cpu_op", "aten::empty", 119, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 118, 20),
    ])
    assert t.busy_intervals() == [(100, 120), (130, 180)]
    assert t.busy_s == pytest.approx(70e-6) and t.window_s == pytest.approx(100e-6)
    assert t.gaps() == [(120, 130), (180, 200)]
    b = t.breakdown()
    assert b["device_ops"][0] == ["void rowsort_rle_regs<false>", pytest.approx(60e-6)]
    assert dict((n, v) for n, v in b["idle_gaps"]) == {
        "aten::empty": pytest.approx(10e-6), "no host op": pytest.approx(20e-6)}


def test_per_layer_readers_on_a_trace(tmp_path):
    t = _chrome(tmp_path, [
        _x("user_annotation", WINDOW, 0, 1000),
        _x("kernel", "rowsort_rle_large_regs", 0, 400),
        _x("kernel", "rowsort_rle_large_regs", 500, 400),
    ])
    cell = spec.cell("cfg4_k31c.rows_shard")

    class W:
        reads, read_len, k, canonical = 100_000, 152, 31, True

    r = harness.Run(cell=cell, workload=W, setup_s=1.0,
                    window=harness.Window(calls=2, seconds=1e-3, call_ms=[0.4, 0.5], kept={}),
                    trace=t, host_call_us=[30.0, 50.0, 40.0])
    from benchmark import roofline

    bound_ms = roofline.rowsort_bound(100_000, 152, 31, True)[0]
    assert spec.load_module("metrics", "rowsort_roofline").read(r) == pytest.approx(
        100 * 2 * bound_ms / 0.8)
    assert spec.load_module("metrics", "device_idle_share").read(r) == pytest.approx(0.2)
    assert spec.load_module("metrics", "host_us_per_call").read(r) == 40.0
    r.trace = _chrome(tmp_path, [_x("user_annotation", WINDOW, 0, 1000)])
    assert spec.load_module("metrics", "rowsort_roofline").read(r) is None
    assert spec.load_module("metrics", "device_idle_share").read(r) is None


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_at_the_cells_size_on_the_card_the_program_is_correct_and_the_control_not(name, card):
    cell = spec.cell(name)
    entry = spec.load_module("entries", cell.traffic["entry"])
    out = control.readings(cell, [11, 2**31 + 12, 13], 1.0,
                           [None] + entry.controls(cell.config), card)
    for r in out:
        assert r["correct"] == (r["variant"] == "program"), r
