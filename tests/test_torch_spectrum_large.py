"""The dense spectrum at 11 <= k <= 15, where the table is larger than the
card's L2: the kernel's numpy model (``spectrum_hist_model``, sparse
there), the port's ``spectrum(..., impl="auto")`` on a CPU tensor and
the JAX package's ``spectrum`` against the benchmark's plain reference
(``benchmark/references/spectrum_table.py``); the ``auto`` route on a
CUDA tensor by its route counter, with the launch stubbed; and the
refusals.  Tolerance: exact equality -- every output is an integer
array.

The k = 15 table is 4**15 int32 (4.29 GB): the CPU route's k = 15 cases
are the only ones that build it, share one table, zeroed between them,
and are compared sparsely.  The JAX package runs at k = 11 and 12
alone, so that it builds no such table."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.references import spectrum_table as reference
from cfrk_tpu.ops.spectrum import spectrum as jax_spectrum
from cfrk_tpu_torch.ops import spectrum as S
from cfrk_tpu_torch.ops.cuda.spectrum import (
    HIST_MAX_K,
    LARGE_LAUNCHES,
    SPECTRUM_MAX_K,
    spectrum_hist,
    spectrum_hist_model,
)
from cfrk_tpu_torch.runtime import metrics

KS = (11, 12, 15)
LARGE_KS = range(SPECTRUM_MAX_K + 1, HIST_MAX_K + 1)


def _batch(seed=23):
    """Random reads with N bases, a read shorter than k, an all-N read,
    poly-A and poly-T reads and two dinucleotide repeats."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(14, 90)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.03] = -1
    codes[1, 9:] = -1  # 9 bases: no window at k >= 11
    codes[2] = -1
    codes[3] = 0  # poly-A
    codes[4] = 3  # poly-T
    codes[5] = np.tile([0, 1], 45)  # ACAC...
    codes[6] = np.tile([2, 3], 45)  # GTGT...
    return codes


def _want(codes, k, canonical):
    keys, counts = reference.spectrum(torch.from_numpy(codes), k, canonical)
    return keys.numpy(), counts.numpy()


def _sparse(table):
    keys = torch.nonzero(table).reshape(-1)
    return keys.numpy(), table[keys].to(torch.int64).numpy()


def _assert_sparse_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("skew", [0, 5])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_kernel_model_equals_the_reference(k, canonical, skew):
    """The model with small blocks (32 threads, 3 blocks: several steps a
    block), the batch starting ``skew`` codes off a 16-byte boundary."""
    codes = _batch()
    (keys, counts), atomics = spectrum_hist_model(codes, k, canonical, skew=skew,
                                                  threads=32, grid=3)
    _assert_sparse_equal((keys, counts), _want(codes, k, canonical))
    assert atomics < int(counts.sum())  # the repeats merge in registers


def test_repeats_cost_few_atomics():
    """A batch of poly-A and ACAC reads: the held pairs merge each run,
    so a thread adds a key once a run and not once a window."""
    codes = np.zeros((8, 150), np.int8)
    codes[4:] = np.tile([0, 1], 75)
    (keys, counts), atomics = spectrum_hist_model(codes, 15, threads=32, grid=2)
    _assert_sparse_equal((keys, counts), _want(codes, 15, False))
    assert atomics <= 3 * 32 and int(counts.sum()) == 8 * 136


@pytest.fixture(scope="module")
def k15_table():
    return torch.zeros(4**15, dtype=torch.int32)


@pytest.mark.parametrize("k", KS)
def test_cpu_auto_route_equals_the_reference(k, k15_table):
    """``spectrum(..., impl="auto")`` on a CPU tensor, forward and
    canonical, into a running table; the same reads off a 16-byte
    boundary."""
    codes = _batch()
    flat = torch.from_numpy(np.concatenate([np.zeros(3, np.int8), codes.reshape(-1)]))
    odd = flat[3:].view(codes.shape)
    assert odd.data_ptr() % 16 != 0
    for canonical in (False, True):
        table = k15_table.zero_() if k == 15 else torch.zeros(4**k, dtype=torch.int32)
        got = S.spectrum(torch.from_numpy(codes), k, canonical=canonical, out=table)
        assert got is table
        _assert_sparse_equal(_sparse(table), _want(codes, k, canonical))
        S.spectrum(odd, k, canonical=canonical, out=table)
        keys, counts = _want(codes, k, canonical)
        _assert_sparse_equal(_sparse(table), (keys, 2 * counts))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [11, 12])
def test_jax_package_equals_the_reference(k, canonical):
    codes = _batch()
    table = np.asarray(jax_spectrum(jnp.asarray(codes), k, canonical=canonical,
                                    impl="scatter"))
    keys = np.flatnonzero(table)
    _assert_sparse_equal((keys, table[keys].astype(np.int64)), _want(codes, k, canonical))


@pytest.mark.parametrize("k", range(1, 16))
def test_auto_route_per_k(k):
    """On a CUDA tensor ``auto`` takes the histogram kernel (route
    ``pallas``) at every k, at any window count; off CUDA the JAX
    package's off-TPU policy; ``pallas`` by name stops at k = 10."""
    for n in (1000, 2**24, 2**30):
        assert S._route("auto", k, True, n) == "pallas"
        off = "matmul" if k <= 6 and n < 2**24 else "scatter"
        assert S._route("auto", k, False, n) == off
    assert S._route("scatter", k, True, 10) == "scatter"
    assert S._route("matmul", k, True, 2**24) == "scatter"
    if k <= SPECTRUM_MAX_K:
        assert S._route("pallas", k, True, 10) == "pallas"
    else:
        with pytest.raises(ValueError, match="k <= 10"):
            S._route("pallas", k, True, 10)


def test_auto_on_a_cuda_tensor_counts_the_kernel_route(monkeypatch):
    """The dispatcher, told that the codes are on a CUDA device, hands
    the batch to the kernel's wrapper (stubbed: no card here) and counts
    the call, its windows and its route."""
    real = S._route
    calls = []

    def stub(codes, k, canonical, out):
        calls.append((tuple(codes.shape), k, canonical))
        return out

    monkeypatch.setattr(S, "_route", lambda impl, k, on_cuda, n: real(impl, k, True, n))
    monkeypatch.setitem(S._ROUTES, "pallas", stub)
    before = metrics.counters()
    codes = torch.from_numpy(_batch())
    table = torch.zeros(4**12, dtype=torch.int32)
    for k in (11, 12):
        S.spectrum(codes, k, out=table if k == 12 else None)
    after = metrics.counters()

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    assert calls == [((14, 90), 11, False), ((14, 90), 12, False)]
    assert delta("cfrk.spectrum.calls") == 2 and delta("cfrk.spectrum.route.pallas") == 2
    assert delta("cfrk.spectrum.windows") == 14 * 80 + 14 * 79
    assert delta(LARGE_LAUNCHES) == 0


def test_a_call_is_one_span_with_its_wrapper_inside():
    from torch.profiler import profile

    metrics.reset()
    codes = torch.from_numpy(_batch())
    with profile():
        S.spectrum(codes, 11)
        spectrum_hist(codes, 11)
    names = [r.name for r in metrics.spans()]
    assert names.count("cfrk.spectrum") == 1
    assert "cfrk.spectrum_hist.plain" in names


@pytest.mark.parametrize("k", LARGE_KS)
def test_pallas_still_refuses_k_above_10(k):
    with pytest.raises(ValueError, match="k <= 10"):
        S.spectrum(torch.from_numpy(_batch()), k, impl="pallas")


def test_refusals():
    codes = torch.from_numpy(_batch())
    before = metrics.counters().get(LARGE_LAUNCHES, 0)
    with pytest.raises(ValueError, match="k <= 15"):
        S.spectrum(codes, 16)
    for k in (0, 16):
        with pytest.raises(ValueError, match="1 <= k <= 15"):
            spectrum_hist(codes, k)
    with pytest.raises(ValueError, match="int32"):
        spectrum_hist(codes, 11, out=torch.zeros(4**11, dtype=torch.int64))
    with pytest.raises(ValueError, match="int32"):
        spectrum_hist(codes, 11, out=torch.zeros(4**12, dtype=torch.int32))
    with pytest.raises(ValueError, match="int8"):
        spectrum_hist(codes.to(torch.int32), 11)
    with pytest.raises(ValueError, match="needs CUDA"):
        spectrum_hist(torch.zeros((2, 40), dtype=torch.int8, device="meta"), 12)
    assert metrics.counters().get(LARGE_LAUNCHES, 0) == before
