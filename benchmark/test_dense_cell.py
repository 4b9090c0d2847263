"""The dense per-read cell's own pieces: its check, its bound and its two
per-layer metrics (``entries/perread_dense.py``,
``references/perread_dense.py``, ``dense_roofline.py``,
``metrics/perread_roofline.py``,
``metrics/perread_self_us_per_call.py``).

The CPU runs take 256 reads a call (16 where a traced run enqueues
about a thousand calls); the cell's own size runs on the card
(``-m card``)."""

import time

import pytest
import torch

from benchmark import control, dense_roofline, harness, roofline, spec
from benchmark.references import perread_dense
from benchmark.test_harness_runs import _chrome, _x
from benchmark.trace import WINDOW

CELL = "cfg2_k8_dense.dense_matrix"
KERNEL = ("void (anonymous namespace)::perread_hist_kernel<1>(signed char const*, "
          "unsigned int*, int*, int, int, int, int, int, bool, int, int, int, int, long)")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def entry():
    return spec.load_module("entries", "perread_dense")


def small_cell(reads=256):
    cell = spec.cell(CELL)
    cell.traffic = dict(cell.traffic, reads_per_call=reads)
    return cell


def run(cell, trace=False, seconds=0.2):
    return harness.run_cell(cell, 2**33 + 28, seconds, trace, torch.device("cpu"),
                            time.perf_counter())


def test_a_sound_small_run_is_correct():
    # A window of many calls, even on a loaded CPU (30-100 ms a call),
    # so that more than the last call is compared.
    r = run(small_cell(), seconds=1.0)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["mismatched_cells"]["value"] == 0
    assert r["checks"]["calls_compared"]["value"] >= 2
    assert set(r["metrics"]) == {"bases_per_s", "call_ms_p95", "setup_s"}


def _n_as_base(real):
    def route(codes, k, canonical=False):
        return perread_dense.counts(codes, k, canonical, n_as_base=True)
    return route


def _stale(real):
    last = []

    def route(codes, k, canonical=False):
        out = real(codes, k, canonical=canonical)
        if last:
            return last[0]
        last.append(out)
        return out
    return route


def _off_by_one(real):
    def route(codes, k, canonical=False):
        out = real(codes, k, canonical=canonical).clone()
        out[3, 1234] += 1
        return out
    return route


def _int64(real):
    def route(codes, k, canonical=False):
        return real(codes, k, canonical=canonical).to(torch.int64)
    return route


def _one_read_short(real):
    def route(codes, k, canonical=False):
        return real(codes, k, canonical=canonical)[:-1]
    return route


@pytest.mark.parametrize("fault", [_n_as_base, _stale, _off_by_one, _int64, _one_read_short])
def test_a_broken_call_is_not_correct(fault, monkeypatch):
    from cfrk_tpu_torch.ops import perread

    monkeypatch.setattr(perread, "count_perread", fault(perread.count_perread))
    r = run(small_cell())
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["mismatched_cells"]["value"] > 0


def test_a_wrong_dtype_or_shape_counts_every_cell():
    wl = entry().Workload(spec.cell(CELL).config, dict(small_cell().traffic, reads_per_call=8),
                          1, torch.device("cpu"))
    out = wl.call(wl.inputs[0])
    ref = wl.reference(wl.inputs[0])
    assert wl.mismatches(out, ref) == 0
    bumped = out.clone()
    bumped[0, 0] += 1
    assert wl.mismatches(bumped, ref) == 1
    assert wl.mismatches(out.to(torch.int64), ref) == 8 * 4**8
    assert wl.mismatches(out[:, :-1], ref) == 8 * 4**8
    assert wl.mismatches((out,), ref) == 8 * 4**8


def test_the_bound_is_the_codes_and_the_matrix_written_once():
    assert dense_roofline.dense_bytes(8192, 150, 8) == 2_148_712_448
    ms, by = dense_roofline.dense_bound(8192, 150, 8)
    assert by == "bytes"
    assert ms == pytest.approx(2_148_712_448 / roofline.HBM_BW * 1e3)
    assert ms == pytest.approx(0.6414, abs=1e-4)


def test_the_bound_bytes_equal_the_reference_matrix():
    codes = torch.zeros((5, 40), dtype=torch.int8)
    for k in (1, 4, 8):
        out = perread_dense.counts(codes, k)
        assert dense_roofline.dense_bytes(5, 40, k) == codes.numel() + out.numel() * 4


def _run_with(trace, calls, workload=None, cell=None):
    return harness.Run(cell=cell or spec.cell(CELL), workload=workload, setup_s=1.0,
                       window=harness.Window(calls=calls, seconds=1e-3, call_ms=[], kept={}),
                       trace=trace)


def test_the_roofline_on_a_trace(tmp_path):
    class W:
        reads, read_len, k = 8192, 150, 8

    t = _chrome(tmp_path, [
        _x("user_annotation", WINDOW, 0, 2000),
        _x("kernel", KERNEL, 0, 700),
        _x("kernel", "perread_hist_kernel<2>", 800, 600),
        _x("kernel", "void (anonymous namespace)::perread_scatter_kernel<1>(int)", 1500, 100),
        _x("kernel", "void rowsort_rle_regs<false>", 1600, 100),
    ])
    read = spec.load_module("metrics", "perread_roofline").read
    bound_ms = dense_roofline.dense_bound(8192, 150, 8)[0]
    assert read(_run_with(t, 2, W)) == pytest.approx(100 * 2 * bound_ms / 1e3 / 1300e-6)


def test_both_metrics_read_nothing_without_their_kernel_or_spans(tmp_path, monkeypatch):
    from cfrk_tpu_torch.runtime import metrics

    roof = spec.load_module("metrics", "perread_roofline").read
    self_us = spec.load_module("metrics", "perread_self_us_per_call").read
    no_kernel = _chrome(tmp_path, [_x("user_annotation", WINDOW, 0, 1000),
                                   _x("kernel", "void indexFuncLargeIndex<int>", 0, 900),
                                   _x("kernel", "perread_scatter_kernel<1>", 900, 50)])
    assert roof(_run_with(no_kernel, 4)) is None
    assert roof(_run_with(None, 4)) is None
    with_kernel = _chrome(tmp_path, [_x("user_annotation", WINDOW, 0, 1000),
                                     _x("kernel", KERNEL, 0, 900)])
    assert roof(_run_with(with_kernel, 4, cell=spec.cell("cfg2_k8.rows_shard"))) is None
    monkeypatch.setattr(metrics, "spans", lambda: [])
    monkeypatch.setattr(metrics, "counters", lambda: {})
    assert self_us(_run_with(None, 4)) is None
    monkeypatch.setattr(metrics, "counters", lambda: {"cfrk.perread.calls": 3})
    assert self_us(_run_with(None, 4)) is None
    monkeypatch.setattr(metrics, "spans", lambda: [_record("cfrk.perread", 1, 0, 0, 10)])
    monkeypatch.setattr(metrics, "counters", lambda: {"cfrk.spectrum.calls": 3})
    assert self_us(_run_with(None, 4)) is None  # the parent: no cfrk.perread.calls
    monkeypatch.setattr(metrics, "counters", lambda: {"cfrk.perread.calls": 3})
    monkeypatch.delattr(metrics, "spans")
    assert self_us(_run_with(None, 4)) is None


def _record(name, id, parent, start, end):
    from cfrk_tpu_torch.runtime.metrics import SpanRecord

    return SpanRecord(name, id, parent, 1, 1, start, end, False)


def test_self_time_takes_the_last_top_level_spans_less_their_children(monkeypatch):
    from cfrk_tpu_torch.runtime import metrics

    records = [
        _record("cfrk.perread", 1, 0, 0, 1_000_000),  # before the window
        _record("cfrk.perread_hist.launch", 3, 2, 2_000_200, 2_000_500),
        _record("cfrk.perread", 2, 0, 2_000_000, 2_001_000),
        _record("cfrk.spectrum", 6, 0, 2_500_000, 2_600_000),  # another dispatcher
        _record("cfrk.perread", 5, 0, 3_000_000, 3_000_100),
    ]
    monkeypatch.setattr(metrics, "spans", lambda: list(records))
    monkeypatch.setattr(metrics, "counters", lambda: {"cfrk.perread.calls": 3})
    read = spec.load_module("metrics", "perread_self_us_per_call").read
    assert read(_run_with(None, 2)) == pytest.approx((700 + 100) / 2 / 1e3)
    # The spectrum metric, loaded beside it, still reads its own spans.
    spectrum_read = spec.load_module("metrics", "spectrum_self_us_per_call").read
    monkeypatch.setattr(metrics, "counters", lambda: {"cfrk.spectrum.calls": 1,
                                                      "cfrk.perread.calls": 3})
    assert spectrum_read(_run_with(None, 2)) == pytest.approx(100_000 / 1e3)


def test_a_traced_small_run_reads_the_self_time():
    r = run(small_cell(16), trace=True)
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert 0 < m["perread_self_us_per_call"] < r["device"]["window_s"] / r["attempted"] * 1e6
    assert "perread_roofline" not in m  # no kernel on the CPU


def test_the_control_is_not_correct():
    cell = small_cell()
    out = control.readings(cell, [5, 2**31 + 6], 0.2,
                           [None] + entry().controls(cell.config), torch.device("cpu"))
    assert [r["variant"] for r in out] == ["program"] * 2 + ["n_as_base"] * 2
    for r in out:
        assert r["correct"] == (r["variant"] == "program"), r


@pytest.mark.card
def test_at_the_cells_size_on_the_card_the_program_is_correct_and_the_control_not(card):
    cell = spec.cell(CELL)
    out = control.readings(cell, [11, 2**31 + 12], 1.0,
                           [None] + entry().controls(cell.config), card)
    for r in out:
        assert r["correct"] == (r["variant"] == "program"), r
        assert r["checks"]["calls_compared"]["value"] >= 2
