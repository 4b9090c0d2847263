"""``count_perread`` (``cfrk_tpu_torch/ops/perread.py``) against the
benchmark's plain dense reference (``benchmark/references/
perread_dense.py``) on every route a CPU tensor takes: ``compare`` at k
<= 3, ``scatter``, ``matmul``, ``host``, and ``pallas`` through its
plain twin; and the dispatcher's span ``cfrk.perread`` and its counters
``cfrk.perread.calls`` and ``.route.<impl>``.  Seeded reads
with N bases, a poly-A read and an all-N read; reads of exactly k
bases, batches of N alone, and reads shorter than k.  Tolerance: exact
equality -- every output is an integer array."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.references import perread_dense as reference
from cfrk_tpu_torch.ops.perread import count_perread
from cfrk_tpu_torch.runtime import metrics as M

ROUTES = ("compare", "scatter", "matmul", "host", "pallas")
CASES = [(k, impl) for k in range(1, 9) for impl in ROUTES if impl != "compare" or k <= 3]
EDGE_CASES = [(k, impl) for k, impl in CASES if k in (2, 3, 5, 8)]


@pytest.fixture(autouse=True)
def _fresh_registry():
    M.reset()
    yield
    M.reset()


def _batch(b=37, length=150, seed=28):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, length)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.02] = -1
    codes[1] = -1  # all N
    codes[2] = 0  # poly-A
    return torch.from_numpy(codes)


def _assert_exact(got, want):
    assert got.dtype == want.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,impl", CASES)
def test_every_cpu_route_equals_the_plain_reference(k, impl, canonical):
    codes = _batch(seed=k)
    want = reference.counts(codes, k, canonical)
    _assert_exact(count_perread(codes, k, canonical=canonical, impl=impl), want)
    assert int(want[1].sum()) == 0 and int(want[2, 0]) == 150 - k + 1


@pytest.mark.parametrize("k,impl", EDGE_CASES)
def test_edge_reads_equal_the_plain_reference(k, impl):
    """Reads of exactly k bases (one window each) and a batch of N
    alone; reads shorter than k raise the reference's error."""
    one_window = _batch(b=9, length=k, seed=100 + k)
    all_n = torch.full((5, 40), -1, dtype=torch.int8)
    for codes in (one_window, all_n):
        _assert_exact(count_perread(codes, k, impl=impl), reference.counts(codes, k))
    short = _batch(b=4, length=k - 1, seed=200 + k)
    for fn in (lambda: count_perread(short, k, impl=impl), lambda: reference.counts(short, k)):
        with pytest.raises(ValueError, match=f"read length {k - 1} < k={k}"):
            fn()


@pytest.mark.parametrize("impl", ROUTES)
def test_int16_counts_equal_the_reference_cast(impl):
    k = 3
    codes = _batch(b=11, seed=5)
    got = count_perread(codes, k, impl=impl, out_dtype=torch.int16)
    assert got.dtype == torch.int16
    assert torch.equal(got, reference.counts(codes, k).to(torch.int16))


def _route_of(impl, k):
    if impl != "auto":
        return impl
    return "compare" if 4**k <= 64 else "host"  # the CPU's policy


@pytest.mark.parametrize("impl,k", [(impl, 3) for impl in ROUTES]
                         + [(impl, 5) for impl in ROUTES[1:]] + [("auto", 2), ("auto", 6)])
def test_a_traced_call_is_one_perread_span_and_one_count_of_each_counter(impl, k):
    codes = _batch(b=12, length=40)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            count_perread(codes, k, impl=impl)
    records = M.spans()
    tops = [r for r in records if r.name == "cfrk.perread"]
    assert len(tops) == 3 and all(r.parent == 0 and not r.once for r in tops)
    children = [r for r in records if r.parent in {t.id for t in tops}]
    route = _route_of(impl, k)
    if route == "pallas":
        assert [r.name for r in children] == ["cfrk.perread_hist.plain"] * 3
        for top, child in zip(tops, children):
            assert child.parent == top.id and child.request == top.request
            assert top.start_ns <= child.start_ns <= child.end_ns <= top.end_ns
    else:
        assert children == []
    c = M.counters()
    assert c["cfrk.perread.calls"] == 3
    assert {n: v for n, v in c.items() if n.startswith("cfrk.perread.route.")} == {
        "cfrk.perread.route." + route: 3}


@pytest.mark.parametrize("impl", ["pallas", "host"])
def test_without_a_profiler_no_span_is_kept_and_the_counters_count(impl, monkeypatch):
    def refuse(name, *args):
        raise AssertionError(f"record function {name!r} entered with no profiler")

    monkeypatch.setattr(torch._C._autograd, "_record_function_with_args_enter", refuse)
    codes = _batch(b=6, length=30)
    for _ in range(2):
        count_perread(codes, 5, impl=impl)
    assert M.spans() == []
    c = M.counters()
    assert c["cfrk.perread.calls"] == 2
    assert c["cfrk.perread.route." + impl] == 2


def test_a_refused_call_counts_nothing():
    codes = _batch(b=3, length=30)
    for kw in ({"impl": "nope"}, {"impl": "auto", "k": 9}):
        with pytest.raises(ValueError):
            count_perread(codes, **({"k": 5} | kw))
    assert not any(n.startswith("cfrk.perread") for n in M.counters())


@pytest.mark.parametrize("broken", ["n_as_base", "forward_only"])
def test_each_broken_guarantee_changes_the_counts(broken):
    codes = _batch(b=8, seed=9)
    good = reference.counts(codes, 6, True)
    assert not torch.equal(good, reference.counts(codes, 6, True, **{broken: True}))


def test_the_reference_refuses_k_outside_its_range():
    for k in (0, 9):
        with pytest.raises(ValueError, match=f"k={k} outside"):
            reference.counts(_batch(b=4), k)
