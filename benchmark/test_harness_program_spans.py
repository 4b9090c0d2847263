"""The per-layer metrics read from the program's own spans and counters
(``metrics/rows_self_us_per_call.py``, ``out_mb_per_call.py``,
``program_setup_s.py``): read in a traced CPU run of each cell, each in
a fresh process as ``run.py`` runs one, and silent where the program
has no registry."""

import json
import subprocess
import sys

import pytest

from benchmark import harness, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SMALL = 256  # reads a call on the CPU, as in test_harness_runs.py
NEW = ("rows_self_us_per_call", "out_mb_per_call", "program_setup_s")

_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from benchmark import harness, spec
cell = spec.cell({name!r})
cell.traffic = dict(cell.traffic, reads_per_call={small})
print(json.dumps(harness.run_cell(cell, 2**31 + 99, 0.2, True, torch.device("cpu"),
                                  time.perf_counter())))
"""


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_the_programs_spans_and_counters(name):
    code = _RUN.format(root=str(spec.ROOT), name=name, small=SMALL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=spec.ROOT, check=True, timeout=300)
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(NEW) <= set(m)
    config = spec.cell(name).config
    k = config["k"]
    arrays = 2 if k <= 15 else 3
    assert m["out_mb_per_call"] == SMALL * (config["read_len"] - k + 1) * 4 * arrays / 1e6
    host_us_per_call = r["device"]["window_s"] / r["attempted"] * 1e6
    assert 0 < m["rows_self_us_per_call"] < host_us_per_call
    assert m["program_setup_s"] > 0


def _record(name, id, parent, start, end, once=False):
    from cfrk_tpu_torch.runtime.metrics import SpanRecord

    return SpanRecord(name, id, parent, 1, 1, start, end, once)


def _run(calls):
    return harness.Run(cell=spec.cell(CELLS[0]), workload=None, setup_s=1.0,
                       window=harness.Window(calls=calls, seconds=1.0, call_ms=[], kept={}))


def test_self_time_takes_the_union_of_the_children_and_the_last_calls(monkeypatch):
    from cfrk_tpu_torch.runtime import metrics

    records = [
        _record("cfrk.rows", 1, 0, 0, 1_000_000),  # before the window
        _record("cfrk.rowsort_rle.launch", 3, 2, 2_000_200, 2_000_500),
        _record("cfrk.narrow", 4, 2, 2_000_400, 2_000_600),
        _record("cfrk.rows", 2, 0, 2_000_000, 2_001_000),
        _record("cfrk.rows", 5, 0, 3_000_000, 3_000_100),
    ]
    monkeypatch.setattr(metrics, "spans", lambda: list(records))
    read = spec.load_module("metrics", "rows_self_us_per_call").read
    assert read(_run(2)) == pytest.approx((600 + 100) / 2 / 1e3)


def test_setup_counts_each_once_span_outside_another_once(monkeypatch):
    from cfrk_tpu_torch.runtime import metrics

    records = [
        _record("cfrk.import", 1, 0, 0, 50_000_000, once=True),
        _record("cfrk.library.build.rowsort", 3, 2, 0, 9_000_000_000, once=True),
        _record("cfrk.library.load.rowsort", 2, 0, 0, 9_100_000_000, once=True),
        _record("cfrk.rowsort_rle.first_launch", 5, 4, 0, 2_000_000, once=True),
        _record("cfrk.rows", 4, 0, 0, 3_000_000),
    ]
    monkeypatch.setattr(metrics, "spans", lambda: list(records))
    read = spec.load_module("metrics", "program_setup_s").read
    assert read(_run(1)) == pytest.approx(0.05 + 9.1 + 0.002)


def test_the_readers_give_nothing_without_the_registry(monkeypatch):
    from cfrk_tpu_torch.runtime import metrics

    monkeypatch.delattr(metrics, "spans")
    monkeypatch.delattr(metrics, "counters")
    for name in NEW:
        assert spec.load_module("metrics", name).read(_run(10)) is None
