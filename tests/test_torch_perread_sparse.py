"""Per-read sparse rows of cfrk_tpu_torch against cfrk_tpu.

The plain PyTorch route (``count_perread_sparse``/``_large`` — the CPU
route of the CUDA kernels and their oracle) is held against the JAX
package's XLA sort route and against its Pallas kernels run in interpret
mode, across the kernel edge cases of tests/test_pallas.py: canonical
keys, long reads, poly-A, all-N, odd batches, short (span-packed) reads
and the 16-T hi collision.  Tolerance: exact equality — every output is
an integer array (the uint32 key words of k > 15 travel as int32 bit
views in the port and are compared as uint32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfrk_tpu.ops import perread_sparse as jps
from cfrk_tpu.ops.pallas.rowsort import rowsort_rle_pallas, rowsort_rle_pallas_large
from cfrk_tpu_torch.ops import perread_sparse as tps
from cfrk_tpu_torch.ops.cuda.rowsort import rowsort_rle, rowsort_rle_large
from cfrk_tpu_torch.ops.reference import count_perread_np
from cfrk_tpu_torch.tools.card import launches


def _batch(seed, b, length, p_invalid=0.03):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, length)).astype(np.int8)
    codes[rng.random(codes.shape) < p_invalid] = -1
    return codes


def _as_np(x):
    """Host array of a port output; int32 bit views of uint32 key words
    compare as int32 against the JAX package's uint32 by view."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _as_np(g), np.asarray(w)
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _jax_rows(codes, k, canonical):
    fn = jps.count_perread_sparse if k <= 15 else jps.count_perread_sparse_large
    return fn(jnp.asarray(codes), k, canonical)


def _torch_rows(codes, k, canonical):
    fn = tps.count_perread_sparse if k <= 15 else tps.count_perread_sparse_large
    return fn(torch.from_numpy(codes), k, canonical)


@pytest.mark.parametrize("k", [1, 2, 8, 15, 16, 24, 31])
@pytest.mark.parametrize("canonical", [False, True])
def test_plain_route_matches_xla_oracle(k, canonical):
    codes = _batch(k, 13, 171, 0.03 if k <= 15 else 0.005)
    _assert_rows_equal(_torch_rows(codes, k, canonical), _jax_rows(codes, k, canonical))


@pytest.mark.parametrize(
    "k,canonical", [(8, False), (8, True), (15, True), (31, False), (31, True)]
)
def test_plain_route_matches_pallas_interpret(k, canonical):
    codes = _batch(40 + k, 13, 171, 0.01)
    if k <= 15:
        want = rowsort_rle_pallas(jnp.asarray(codes), k, canonical=canonical,
                                  interpret=True)
    else:
        want = rowsort_rle_pallas_large(jnp.asarray(codes), k,
                                        canonical=canonical, interpret=True)
    _assert_rows_equal(_torch_rows(codes, k, canonical), want)


@pytest.mark.parametrize("length", [36, 70])
@pytest.mark.parametrize("canonical", [False, True])
def test_short_reads_match_pallas_span_packing(length, canonical):
    """Reads of <= 64 padded windows are span-packed by the TPU kernel;
    the port has no packing but must give the same rows (odd batch)."""
    codes = _batch(length, 37, length)
    want = rowsort_rle_pallas(jnp.asarray(codes), 8, canonical=canonical,
                              interpret=True)
    _assert_rows_equal(_torch_rows(codes, 8, canonical), want)
    _assert_rows_equal(_torch_rows(codes, 31, canonical),
                       _jax_rows(codes, 31, canonical))


@pytest.mark.parametrize("k", [8, 31])
def test_long_reads_poly_a_all_n(k):
    codes = _batch(5, 5, 1000)
    codes[0] = 0  # poly-A: one run over the whole read
    codes[1] = -1  # all N: no valid window
    codes[2, 7:] = -1  # a read shorter than k, padded
    got = _torch_rows(codes, k, False)
    _assert_rows_equal(got, _jax_rows(codes, k, False))
    assert int(got[-1][0, 0]) == 1000 - k + 1
    assert int(got[-1][1].sum()) == 0 and int(got[-1][2].sum()) == 0


def test_16T_hi_collision_matches_pallas():
    """At k=31 a 16-T prefix makes the hi word equal the sentinel value;
    validity is judged on lo, so these k-mers must survive."""
    codes = np.zeros((4, 60), np.int8)
    codes[:, :20] = 3
    want = rowsort_rle_pallas_large(jnp.asarray(codes), 31, interpret=True)
    got = _torch_rows(codes, 31, False)
    _assert_rows_equal(got, want)
    assert int(got[2].sum()) == 4 * 30
    assert (got[0][got[2] > 0] == -1).any()  # hi == 0xFFFFFFFF, real


def test_canonical_palindromes():
    """Windows equal to their own reverse complement (ACGT at k=4)."""
    codes = np.tile(np.array([0, 1, 2, 3], np.int8), (3, 25))
    _assert_rows_equal(_torch_rows(codes, 4, True), _jax_rows(codes, 4, True))
    _assert_rows_equal(_torch_rows(codes, 20, True), _jax_rows(codes, 20, True))


@pytest.mark.parametrize("k", [2, 8, 31])
def test_dispatcher_on_cpu_is_plain_route(k):
    codes = _batch(60 + k, 7, 150)
    got = tps.count_perread_rows(torch.from_numpy(codes), k, True)
    wrap = (rowsort_rle if k <= 15 else rowsort_rle_large)(
        torch.from_numpy(codes), k, True
    )
    _assert_rows_equal(got, _torch_rows(codes, k, True))
    _assert_rows_equal(wrap, _torch_rows(codes, k, True))
    assert launches()["rowsort_rle"] == 0 and launches()["rowsort_rle_large"] == 0


@pytest.mark.parametrize("k", [8, 31])
def test_dispatcher_tiles_rows_past_the_kernel_ceiling(k, monkeypatch):
    """The dispatcher tiles by row width alone, on any device: a row
    past the kernel ceiling (lowered here to keep the test small) goes
    through the tiled route and still equals the single-shot rows."""
    import cfrk_tpu_torch.ops.perread_sparse as mod

    tiled, steps = mod.count_perread_rows_tiled, []

    def spy(*args, step):
        steps.append(step)
        return tiled(*args, step=step)

    monkeypatch.setattr(mod, "rowsort_max_windows", lambda k: 100)
    monkeypatch.setattr(mod, "count_perread_rows_tiled", spy)
    codes = _batch(80 + k, 3, 400)
    got = mod.count_perread_rows(torch.from_numpy(codes), k, False)
    assert steps == [100]
    _assert_rows_equal(got, _torch_rows(codes, k, False))
    _assert_rows_equal(got, _jax_rows(codes, k, False))


@pytest.mark.parametrize("k,step", [(8, 64), (8, 300), (15, 1000), (31, 77)])
def test_tiled_rows_equal_single_shot(k, step):
    """Position tiling with a k-1 halo and a host merge rebuilds the
    exact single-shot layout (the route for rows past the kernel
    ceiling)."""
    codes = _batch(70 + step, 4, 1000)
    codes[0] = 0  # one run spanning every tile
    codes[1, 500:] = -1
    got = tps.count_perread_rows_tiled(torch.from_numpy(codes), k, True, step=step)
    _assert_rows_equal(got, _torch_rows(codes, k, True))
    _assert_rows_equal(got, jps.count_perread_rows_tiled(
        codes, k, True, impl="sort", step=step))


@pytest.mark.parametrize("k,length", [(2, 150), (8, 150), (8, 300), (12, 300), (31, 152), (31, 400)])
def test_narrow_and_pairs_to_host_match_jax(k, length):
    """The drain: narrowed dtypes per window count, the uint16 sentinel
    wrap at k <= 8 (masked by count), and the host widening — equal to
    the JAX package's values."""
    codes = _batch(k * length, 11, length)
    rows = _torch_rows(codes, k, False)
    narrow = tps.narrow_for_fetch(rows, k)
    w = length - k + 1
    want_cnt = torch.uint8 if w < 256 else torch.int16
    assert narrow[-1].dtype == want_cnt
    if k <= 8:
        assert narrow[0].dtype == torch.int16
        sent_cells = rows[1] == 0
        assert (narrow[0][sent_cells].numpy().view(np.uint16) == (4**k) % 65536).all()
    j_narrow = jps.narrow_for_fetch(_jax_rows(codes, k, False), k)
    for g, wnt in zip(narrow, j_narrow):
        wnt = np.asarray(wnt)
        np.testing.assert_array_equal(
            g.numpy().view(wnt.dtype) if g.dtype != torch.uint8 else g.numpy(), wnt
        )
    got_keys, got_cnt = tps.pairs_to_host(narrow, 9)
    want_keys, want_cnt = jps.pairs_to_host(j_narrow, 9)
    assert got_keys.dtype == want_keys.dtype and got_cnt.dtype == np.int32
    np.testing.assert_array_equal(got_cnt, want_cnt)
    np.testing.assert_array_equal(got_keys, want_keys)


def test_valid_pair_prefix_keeps_every_run():
    codes = _batch(3, 6, 256)
    codes[:, 150:] = -1  # 150 bp reads padded to 256: 143 real windows
    idx, cnt = _torch_rows(codes, 8, False)
    p_idx, p_cnt = tps.valid_pair_prefix((idx, cnt), 143)
    assert p_idx.shape == (6, 143)
    assert int(p_cnt.sum()) == int(cnt.sum())


@pytest.mark.parametrize("k", [2, 5, 8])
@pytest.mark.parametrize("canonical", [False, True])
def test_rows_densify_to_numpy_spec(k, canonical):
    """Densified rows equal the numpy specification (a copy of the JAX
    package's, itself pinned against it here)."""
    from cfrk_tpu.ops.reference import count_perread_np as jax_spec

    codes = _batch(k + 90, 9, 130)
    want = count_perread_np(list(codes), k, canonical)
    np.testing.assert_array_equal(want, jax_spec(list(codes), k, canonical))
    idx, cnt = _torch_rows(codes, k, canonical)
    dense = np.zeros((9, 4**k), np.int32)
    r, c = np.nonzero(cnt.numpy())
    dense[r, idx.numpy()[r, c]] = cnt.numpy()[r, c]
    np.testing.assert_array_equal(dense, want)
