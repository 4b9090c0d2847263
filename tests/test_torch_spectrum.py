"""The global dense spectrum of cfrk_tpu_torch against cfrk_tpu.

The port's ``spectrum`` routes (``scatter``, ``matmul``, and ``pallas``,
which on a CPU tensor is the CUDA kernel's plain twin) are held against
the JAX package's XLA scatter route, against its Pallas kernel run in
interpret mode (as tests/test_pallas.py runs it) and against the numpy
oracle; the spill discipline and the file driver against the JAX
package's.  Tolerance: exact equality -- every output is an integer
array.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfrk_tpu.ops.pallas.spectrum import spectrum_pallas
from cfrk_tpu.ops.spectrum import spectrum as jax_spectrum
from cfrk_tpu.pipeline import count as jcount
from cfrk_tpu_torch.ops.cuda.spectrum import spectrum_hist, spectrum_hist_plain
from cfrk_tpu_torch.ops.reference import spectrum_np
from cfrk_tpu_torch.ops.spectrum import spectrum
from cfrk_tpu_torch.pipeline import count as tcount


def _batch(seed, b, length, p_invalid=0.03):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, length)).astype(np.int8)
    codes[rng.random(codes.shape) < p_invalid] = -1
    return codes


def _edge_batch():
    """An odd batch with a poly-A read, an all-N read, a read shorter
    than k and a palindromic read (canonical ties)."""
    codes = _batch(7, 9, 77)
    codes[0] = 0
    codes[1] = -1
    codes[2, 4:] = -1
    codes[3, :8] = [0, 1, 2, 3, 0, 1, 2, 3]
    codes[3, 8:] = -1
    return codes


def _port(codes, k, canonical, impl):
    return spectrum(torch.from_numpy(codes), k, canonical=canonical, impl=impl).numpy()


@pytest.mark.parametrize("impl", ["scatter", "matmul", "pallas"])
@pytest.mark.parametrize("k", [1, 2, 4, 5, 6])
@pytest.mark.parametrize("canonical", [False, True])
def test_routes_match_jax_scatter_and_oracle(impl, k, canonical):
    codes = _batch(k, 13, 171)
    got = _port(codes, k, canonical, impl)
    assert got.dtype == np.int32 and got.shape == (4**k,)
    want = np.asarray(jax_spectrum(jnp.asarray(codes), k, canonical=canonical,
                                   impl="scatter"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, spectrum_np(list(codes), k, canonical))


@pytest.mark.parametrize("k", [1, 2, 4, 5])
@pytest.mark.parametrize("canonical", [False, True])
def test_kernel_twin_matches_pallas_interpret(k, canonical):
    codes = _batch(20 + k, 13, 171)
    got = spectrum_hist(torch.from_numpy(codes), k, canonical).numpy()
    want = np.asarray(spectrum_pallas(jnp.asarray(codes), k, canonical=canonical))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["scatter", "matmul", "pallas"])
def test_no_cross_read_windows(impl):
    """Full-length reads with no padding: no window may span two reads
    (the Pallas kernel's separator column)."""
    codes = np.random.default_rng(3).integers(0, 4, size=(16, 64)).astype(np.int8)
    want = np.asarray(spectrum_pallas(jnp.asarray(codes), 3))
    np.testing.assert_array_equal(_port(codes, 3, False, impl), want)
    np.testing.assert_array_equal(want, spectrum_np(list(codes), 3))


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("canonical", [False, True])
def test_edge_rows(k, canonical):
    codes = _edge_batch()
    want = spectrum_np(list(codes), k, canonical)
    for impl in ("scatter", "matmul", "pallas"):
        np.testing.assert_array_equal(_port(codes, k, canonical, impl), want)


def test_auto_policy_and_limits_on_cpu():
    """Off CUDA, auto is matmul for k <= 6 and scatter above, as the JAX
    package's off-TPU policy; the kernel refuses k > 10 on any device
    and the dense op k > 15; 'sort' is a driver route."""
    codes = _batch(5, 4, 40)
    for k in (6, 7, 9):
        np.testing.assert_array_equal(
            _port(codes, k, False, "auto"), spectrum_np(list(codes), k)
        )
    with pytest.raises(ValueError, match="k <= 10"):
        spectrum(torch.from_numpy(codes), 11, impl="pallas")
    with pytest.raises(ValueError, match="k <= 15"):
        spectrum(torch.from_numpy(codes), 16)
    with pytest.raises(ValueError, match="driver-level"):
        spectrum(torch.from_numpy(codes), 4, impl="sort")
    with pytest.raises(ValueError, match="unknown impl"):
        spectrum(torch.from_numpy(codes), 4, impl="host")


@pytest.mark.parametrize("impl", ["scatter", "matmul", "pallas"])
def test_out_accumulates_in_place(impl):
    """``out`` takes the batch's counts in place: two batches into one
    table equal the two tables summed."""
    a, b = _batch(1, 5, 60), _batch(2, 7, 90)
    table = spectrum(torch.from_numpy(a), 4, impl=impl)
    again = spectrum(torch.from_numpy(b), 4, impl=impl, out=table)
    assert again is table
    want = spectrum_np(list(a), 4) + spectrum_np(list(b), 4)
    np.testing.assert_array_equal(table.numpy(), want)


def test_out_is_checked():
    codes = torch.from_numpy(_batch(1, 2, 20))
    with pytest.raises(ValueError, match="int32"):
        spectrum_hist_plain(codes, 3, out=torch.zeros(64, dtype=torch.int64))
    with pytest.raises(ValueError, match="int32"):
        spectrum_hist(codes, 3, out=torch.zeros(16, dtype=torch.int32))


def test_matmul_reroutes_at_2_24_windows(monkeypatch):
    """At >= 2**24 windows matmul takes scatter (float32 is exact only
    below), as the JAX package does."""
    import cfrk_tpu_torch.ops.spectrum as S

    calls = []
    monkeypatch.setattr(S, "_spectrum_matmul", lambda *a: calls.append(a))
    codes = torch.zeros((2**24 // 128 + 1, 128), dtype=torch.int8)
    codes[:, 1:] = -1  # one valid window (an A) per read
    got = spectrum(codes, 1, impl="matmul")
    assert not calls and int(got[0]) == codes.shape[0]


@pytest.mark.parametrize(
    "b,length,limit", [(10, 50, 10**9), (10, 50, 200), (3, 400, 300), (1, 400, 50)]
)
def test_iter_spill_chunks_matches_jax(b, length, limit):
    codes = _batch(b, b, length)
    got = list(tcount.iter_spill_chunks(codes, 4, limit=limit))
    want = list(jcount.iter_spill_chunks(codes, 4, limit=limit))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.shape[0] * (g.shape[1] - 3) < limit


@pytest.mark.parametrize("limit", [10**9, 500, 120])
def test_dense_accumulator_spills_like_jax(limit):
    """With a lowered limit the port spills as often as the JAX package
    and both totals equal the oracle."""
    k = 3
    batches = [_batch(30 + i, 6, 70) for i in range(4)] + [_batch(9, 1, 400)]

    def dispatch(arr, table):
        return spectrum(arr, k, impl="scatter", out=table)

    acc = tcount.DenseSpectrumAccumulator(
        k, dispatch, np.zeros(4**k, np.int64), device="cpu", limit=limit
    )
    jacc = jcount.DenseSpectrumAccumulator(
        k, lambda arr: jax_spectrum(arr, k, impl="scatter"),
        np.zeros(4**k, np.int64), limit=limit,
    )
    for codes in batches:
        acc.add(codes)
        jacc.add(codes)
        assert acc.windows == jacc.windows < limit
    want = spectrum_np([r for c in batches for r in c], k)
    np.testing.assert_array_equal(acc.total(), want)
    np.testing.assert_array_equal(jacc.total(), want)
    assert acc.windows == 0


def _fasta(tmp_path, reads, name="r.fa"):
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    path = tmp_path / name
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">r%d\n%s\n" % (i, lut[np.where(r < 0, 4, r)].tobytes()))
    return str(path)


def _reads(seed, n, max_len=300):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = rng.integers(0, 4, size=int(rng.integers(1, max_len))).astype(np.int8)
        r[rng.random(r.size) < 0.02] = -1
        out.append(r)
    return out


@pytest.mark.parametrize(
    "impl,k", [("auto", 5), ("scatter", 7), ("matmul", 4), ("pallas", 6),
               ("sort", 4), ("sort", 9), ("sort", 11)]
)
@pytest.mark.parametrize("canonical", [False, True])
def test_spectrum_file_matches_jax(tmp_path, impl, k, canonical):
    reads = _reads(k, 60) + [np.zeros(700, np.int8)]  # one long poly-A read
    path = _fasta(tmp_path, reads)
    got = tcount.spectrum_file(path, k, device="cpu", canonical=canonical,
                               impl=impl, batch_size=16)
    want = jcount.spectrum_file(path, k, canonical=canonical, impl=impl,
                                batch_size=16)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, spectrum_np(reads, k, canonical))


def test_spectrum_file_empty_input(tmp_path):
    path = tmp_path / "e.fa"
    path.write_bytes(b"")
    got = tcount.spectrum_file(str(path), 3, device="cpu")
    np.testing.assert_array_equal(got, np.zeros(64, np.int64))


def test_sorted_route_policy():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tcount._use_sorted_spectrum(9, "auto", cuda)
    assert not tcount._use_sorted_spectrum(8, "auto", cuda)
    assert not tcount._use_sorted_spectrum(9, "auto", cpu)
    assert not tcount._use_sorted_spectrum(10, "pallas", cuda)
    assert tcount._use_sorted_spectrum(2, "sort", cpu)
