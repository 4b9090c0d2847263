"""The dense table cell's own pieces: its read model, its check, its
bound and its two per-layer metrics (``entries/spectrum_table.py``,
``table_roofline.py``, ``metrics/spectrum_roofline.py``,
``metrics/spectrum_self_us_per_call.py``).

The check is run on the CPU at k = 12 and a small read model, so that
no test here holds a 4**15 table: the check is the same code at every
k.  The cell itself, at k = 15, runs in ``test_harness_runs.py``."""

import time

import pytest
import torch

from benchmark import harness, spec, table_roofline
from benchmark.references import spectrum_table
from benchmark.trace import WINDOW
from benchmark.test_harness_runs import _chrome, _x

CELL = "cfg3_k15.spectrum_shard"
SMALL_MODEL = {"genomes": 6, "genome_len": 20_000, "abundance": "lognormal",
               "abundance_mu": 1, "abundance_sigma": 2, "mut_rate": 0.01, "n_rate": 0.01}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def entry():
    return spec.load_module("entries", "spectrum_table")


def small_cell(k=12, canonical=False):
    cell = spec.cell(CELL)
    cell.config = dict(cell.config, k=k, canonical=canonical, read_model=SMALL_MODEL)
    cell.traffic = dict(cell.traffic, reads_per_call=200)
    return cell


def run(cell, trace=False):
    return harness.run_cell(cell, 2**33 + 5, 0.2, trace, torch.device("cpu"),
                            time.perf_counter())


def test_the_same_seed_gives_the_same_community():
    shards = entry().community_shards
    a = shards(2**32 + 1, 2, 300, 150, SMALL_MODEL, torch.device("cpu"))
    b = shards(2**32 + 1, 2, 300, 150, SMALL_MODEL, torch.device("cpu"))
    c = shards(2**32 + 2, 2, 300, 150, SMALL_MODEL, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    assert a[0].dtype == torch.int8 and a[0].shape == (300, 150)
    assert int(a[0].min()) == -1 and int(a[0].max()) == 3


def test_abundances_are_skewed():
    """sigma 2 puts most reads on a few genomes.  Genomes one read long,
    with no mutation and no N, make each read its genome whole, so the
    reads' multiplicities are the genomes' draws; uniform draws would
    give the 4 most drawn of 40 genomes about a tenth of the reads."""
    model = dict(SMALL_MODEL, genomes=40, genome_len=150, mut_rate=0.0, n_rate=0.0)
    for seed in (1, 2, 2**33 + 3):
        (codes,) = entry().community_shards(seed, 1, 4000, 150, model, torch.device("cpu"))
        _, per_genome = torch.unique(codes, dim=0, return_counts=True)
        top4 = torch.sort(per_genome, descending=True).values[:4].sum()
        assert float(top4) / 4000 > 0.3


def test_sectors_equal_a_brute_count():
    g = torch.Generator().manual_seed(3)
    keys = torch.randint(0, 4**11, (5000,), generator=g)
    keys = torch.cat([keys, keys[:100], torch.arange(64)])
    assert table_roofline.sectors(keys) == len({int(x) * 4 // 32 for x in keys})


def test_the_bound_is_the_codes_and_two_passes_over_each_sector():
    from benchmark import roofline

    ms, by = table_roofline.table_bound(125_000, 150, 1000)
    assert by == "bytes"
    assert ms == pytest.approx((125_000 * 150 + 64 * 1000) / roofline.HBM_BW * 1e3)


def test_the_sectors_of_a_shard_come_from_the_reference_keys():
    (codes,) = entry().community_shards(5, 1, 200, 150, SMALL_MODEL, torch.device("cpu"))
    keys, _ = spectrum_table.spectrum(codes, 12)
    brute = set()
    for row in codes.tolist():
        for i in range(150 - 12 + 1):
            w = row[i : i + 12]
            if min(w) >= 0:
                brute.add(int("".join(map(str, w)), 4) // 8)
    assert table_roofline.sectors(keys) == len(brute)


@pytest.mark.parametrize("k,canonical", [(12, False), (11, True)])
def test_a_sound_small_run_is_correct(k, canonical):
    r = run(small_cell(k, canonical))
    assert r["correct"] and r["failed"] == 0 and r["checks"]["calls_compared"]["value"] >= 2


def _n_as_base(real):
    def route(codes, k, *, canonical=False, out=None):
        keys, counts = spectrum_table.spectrum(codes, k, canonical, n_as_base=True)
        return out.index_add_(0, keys, counts.to(torch.int32))
    return route


def _canonical(real):
    def route(codes, k, *, canonical=False, out=None):
        return real(codes, k, canonical=True, out=out)
    return route


def _dropped(real):
    calls = []

    def route(codes, k, *, canonical=False, out=None):
        calls.append(1)
        return out if len(calls) == 2 else real(codes, k, canonical=canonical, out=out)
    return route


def _off_by_one(real):
    calls = []

    def route(codes, k, *, canonical=False, out=None):
        out = real(codes, k, canonical=canonical, out=out)
        calls.append(1)
        if len(calls) == 1:
            out[12345] += 1
        return out
    return route


@pytest.mark.parametrize("fault", [_n_as_base, _canonical, _dropped, _off_by_one])
def test_a_broken_call_is_not_correct(fault, monkeypatch):
    from cfrk_tpu_torch.ops import spectrum

    monkeypatch.setattr(spectrum, "spectrum", fault(spectrum.spectrum))
    r = run(small_cell())
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["mismatched_cells"]["value"] > 0


def test_a_wrong_dtype_or_shape_counts_every_cell():
    wl = entry().Workload(small_cell(11).config, dict(small_cell().traffic, reads_per_call=8),
                          1, torch.device("cpu"))
    wl.call(wl.inputs[0])
    assert wl.mismatches(wl.table, None) == 0
    assert wl.mismatches(wl.table.to(torch.int64), None) == 4**11
    assert wl.mismatches(wl.table[:-1], None) == 4**11


def test_an_overflowing_expected_bin_raises():
    wl = entry().Workload(small_cell(11).config, dict(small_cell().traffic, reads_per_call=8),
                          1, torch.device("cpu"))
    wl.call(wl.inputs[0])
    wl.calls[0] = 2**31
    with pytest.raises(RuntimeError, match="2\\*\\*31"):
        wl.mismatches(wl.table, None)


def _run_with(trace, calls, workload=None, cell=None):
    return harness.Run(cell=cell or spec.cell(CELL), workload=workload, setup_s=1.0,
                       window=harness.Window(calls=calls, seconds=1e-3, call_ms=[], kept={}),
                       trace=trace)


def test_the_roofline_on_a_trace(tmp_path):
    wl = entry().Workload(small_cell(11).config, dict(small_cell().traffic, reads_per_call=50),
                          1, torch.device("cpu"))
    t = _chrome(tmp_path, [
        _x("user_annotation", WINDOW, 0, 1000),
        _x("kernel", "spectrum_large", 0, 300),
        _x("kernel", "(anonymous namespace)::spectrum_large(signed char const*, int*)", 400, 300),
        _x("kernel", "void spectrum_large_sliced<1>(int*)", 700, 50),
        _x("kernel", "void rowsort_rle_regs<false>", 800, 100),
    ])
    read = spec.load_module("metrics", "spectrum_roofline").read
    n = len(wl.inputs)
    calls = n + 2  # inputs 0 and 1 twice, the others once
    want = sum((2 if j < 2 else 1) * table_roofline.table_bound(
        50, 150, table_roofline.sectors(wl.spectrum_of(j)[0]))[0] for j in range(n))
    assert read(_run_with(t, calls, wl)) == pytest.approx(100 * want / 1e3 / 600e-6)


def test_both_metrics_read_nothing_without_their_kernel_or_spans(tmp_path, monkeypatch):
    from cfrk_tpu_torch.runtime import metrics

    roof = spec.load_module("metrics", "spectrum_roofline").read
    self_us = spec.load_module("metrics", "spectrum_self_us_per_call").read
    no_kernel = _chrome(tmp_path, [_x("user_annotation", WINDOW, 0, 1000),
                                   _x("kernel", "void indexFuncLargeIndex<int>", 0, 900)])
    assert roof(_run_with(no_kernel, 4)) is None
    assert roof(_run_with(None, 4)) is None
    rows_cell = spec.cell("cfg2_k8.rows_shard")
    assert roof(_run_with(no_kernel, 4, cell=rows_cell)) is None
    monkeypatch.setattr(metrics, "spans", lambda: [])
    monkeypatch.setattr(metrics, "counters", lambda: {})
    assert self_us(_run_with(None, 4)) is None
    monkeypatch.setattr(metrics, "counters", lambda: {"cfrk.spectrum.calls": 3})
    assert self_us(_run_with(None, 4)) is None
    monkeypatch.delattr(metrics, "spans")
    assert self_us(_run_with(None, 4)) is None


def _record(name, id, parent, start, end):
    from cfrk_tpu_torch.runtime.metrics import SpanRecord

    return SpanRecord(name, id, parent, 1, 1, start, end, False)


def test_self_time_takes_the_last_top_level_spans_less_their_children(monkeypatch):
    from cfrk_tpu_torch.runtime import metrics

    records = [
        _record("cfrk.spectrum", 1, 0, 0, 1_000_000),  # before the window
        _record("cfrk.spectrum_hist.launch", 3, 2, 2_000_200, 2_000_500),
        _record("cfrk.spectrum", 2, 0, 2_000_000, 2_001_000),
        _record("cfrk.rows", 6, 0, 2_500_000, 2_600_000),  # another dispatcher
        _record("cfrk.spectrum", 5, 0, 3_000_000, 3_000_100),
    ]
    monkeypatch.setattr(metrics, "spans", lambda: list(records))
    monkeypatch.setattr(metrics, "counters", lambda: {"cfrk.spectrum.calls": 3})
    read = spec.load_module("metrics", "spectrum_self_us_per_call").read
    assert read(_run_with(None, 2)) == pytest.approx((700 + 100) / 2 / 1e3)


def test_a_traced_small_run_reads_the_self_time():
    r = run(small_cell(), trace=True)
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert 0 < m["spectrum_self_us_per_call"] < r["device"]["window_s"] / r["attempted"] * 1e6
    assert "spectrum_roofline" not in m  # no kernel on the CPU
