"""cfrk_tpu_torch/ops/roofline.py, the H100 bounds, against the numbers
they stand for.

At the shapes ``chip_smoke.py`` times its kernels (8192 reads in 256
columns; the probe's 150), each bound equals the one PERF.md section 6
quotes, to the digits quoted there; each depends on the shape alone;
and ``chip_smoke.py``, ``bench.py`` and the suite take their bounds from
this module and keep no constant or bound function of their own.
``pad_pow2`` is the JAX module's.  Tolerance: exact, or the digits
PERF.md quotes.
"""

import re
from pathlib import Path

import pytest

from cfrk_tpu.ops import roofline as jroof
from cfrk_tpu_torch.ops import roofline as R

ROOT = Path(__file__).resolve().parent.parent
B = 8192


@pytest.mark.parametrize("name,got,digits,want", [
    ("rowsort_rle k=8", lambda: R.rowsort_bound(B, 256, 8), 4, 0.0055),
    ("rowsort_rle_large k=31 canonical", lambda: R.rowsort_bound(B, 256, 31, True), 4, 0.0073),
    ("spectrum_hist k=8", lambda: R.spectrum_bound(B, 256, 8), 4, 0.0007),
    ("perread_hist b4", lambda: R.perread_bound(B, 256, 8, "b4"), 3, 0.161),
    ("perread_hist fh", lambda: R.perread_bound(B, 256, 8, "fh"), 3, 0.321),
    ("perread_hist unpacked", lambda: R.perread_bound(B, 256, 8, None), 3, 0.642),
    ("rowsort_probe", lambda: R.probe_bound(B, 150, 8), 4, 0.0004),
])
def test_bounds_at_the_smokes_shapes_are_perfs(name, got, digits, want):
    ms, by = got()
    assert round(ms, digits) == want and by == "bytes", name


def test_bytes_bound_counts_each_input_and_output_once():
    """The main batch's row sort: 2.10 MB of codes in, two int32 words a
    window out (three above k = 15), over 3.35 TB/s."""
    w = 256 - 8 + 1
    assert R.rowsort_bound(B, 256, 8)[0] == (B * 256 + B * w * 8) / 3.35e12 * 1e3
    w = 256 - 31 + 1
    assert R.rowsort_bound(B, 256, 31)[0] == (B * 256 + B * w * 12) / 3.35e12 * 1e3
    assert R.perread_bound(B, 256, 8, "b4")[0] == (B * 256 + B * 4**8) / 3.35e12 * 1e3


def test_operations_bound_wins_where_the_work_outgrows_the_bytes():
    assert R.bound(1, 10**9) == (10**9 / 33.5e12 * 1e3, "operations")
    assert R.bound(10**9, 1) == (10**9 / 3.35e12 * 1e3, "bytes")
    # w * ceil(log2 w) comparisons a row plus one operation a key.
    assert R.sort_ops(3, 143) == 3 * 143 * (8 + 1)
    assert R.sort_ops(1, 1) == 2


def test_every_bound_depends_on_the_shape_alone():
    calls = [lambda: R.rowsort_bound(100, 70, 8), lambda: R.spectrum_bound(100, 70, 15),
             lambda: R.perread_bound(100, 70, 4, "fh"), lambda: R.probe_bound(100, 70, 31)]
    for call in calls:
        assert call() == call()
    # Twice the reads: twice the bytes and the operations (the spectrum's
    # table is its own case, below).
    for fn, args in ((R.rowsort_bound, (70, 8)), (R.perread_bound, (70, 4)),
                     (R.probe_bound, (70, 8))):
        assert fn(200, *args)[0] == pytest.approx(2 * fn(100, *args)[0], rel=1e-12)


def test_a_running_table_bound_counts_the_cells_a_batch_can_touch():
    """At k = 15 a batch of 8192 reads touches at most its 1.11 M windows'
    cells, not the whole 4**15 table; at k = 8 every cell."""
    windows = B * (150 - 15 + 1)
    assert R.spectrum_bound(B, 150, 15)[0] == (B * 150 + windows * 4) / 3.35e12 * 1e3
    assert R.spectrum_bound(B, 150, 8)[0] == (B * 150 + 4**8 * 4) / 3.35e12 * 1e3


def test_bases_per_second_names_keep_the_jax_meaning():
    """sort_sol / scatter_sol / dense_emit_sol are bases/s of their
    bounds; pad_pow2 is the JAX function."""
    assert R.sort_sol(B, 150, 8) == B * 150 / (R.rowsort_bound(B, 150, 8)[0] / 1e3)
    assert R.sort_sol(B, 152, 31, canonical=True) == B * 152 / (
        R.rowsort_bound(B, 152, 31, True)[0] / 1e3)
    assert R.scatter_sol(B, 150, 8) == B * 150 / (R.spectrum_bound(B, 150, 8)[0] / 1e3)
    assert R.dense_emit_sol(B, 150, 8) == B * 150 / (B * 4**8 / 3.35e12)
    assert R.dense_emit_sol(B, 150, 8, bytes_per_bin=2.0) == R.dense_emit_sol(B, 150, 8) / 2
    for w in (1, 5, 32, 127, 128, 129, 1000, 4096, 40_000):
        for floor in (32, 128):
            assert R.pad_pow2(w, floor) == jroof.pad_pow2(w, floor)


@pytest.mark.parametrize("source", ["chip_smoke.py", "cfrk_tpu_torch/bench.py",
                                    "cfrk_tpu_torch/tools/bench_suite.py"])
def test_callers_keep_no_bound_of_their_own(source):
    text = (ROOT / source).read_text()
    assert re.search(r"cfrk_tpu_torch\.ops\.roofline|\.ops\.roofline", text), source
    for literal in ("3.35e12", "33.5e12", "3.35e9", "HBM_BYTES_PER_S", "INT_OPS_PER_S"):
        assert literal not in text, (source, literal)
    assert not re.search(r"^def (bound|sort_ops|\w+_bound|\w+_sol)\(", text, re.M), source


def test_the_module_imports_no_jax_and_no_torch():
    """A module of arithmetic: it imports nothing."""
    lines = (ROOT / "cfrk_tpu_torch" / "ops" / "roofline.py").read_text().splitlines()
    assert [line for line in lines if re.match(r"\s*(import|from)\s", line)] == [
        "from __future__ import annotations"]
