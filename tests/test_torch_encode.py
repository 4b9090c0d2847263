"""Window keys of cfrk_tpu_torch against cfrk_tpu's.

The same seeded numpy code batch (with N codes) goes through the JAX
function and its PyTorch counterpart.  Tolerance: exact equality — every
output is an integer array.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfrk_tpu.ops.encode import window_indices as jax_window_indices
from cfrk_tpu.ops.sparse import kmer_keys as jax_kmer_keys
from cfrk_tpu_torch.ops.encode import split_k, window_indices
from cfrk_tpu_torch.ops.sparse import INVALID_SENTINEL, kmer_keys


def _batch(seed, b=9, length=67, p_invalid=0.03):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, length)).astype(np.int8)
    codes[rng.random(codes.shape) < p_invalid] = -1
    codes[0] = 3  # poly-T: the 16-T hi word equals the sentinel at k=31
    codes[1, :] = np.tile(np.array([0, 1, 2, 3], np.int8), length // 4 + 1)[:length]
    return codes


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 11, 15])
@pytest.mark.parametrize("canonical", [False, True])
def test_window_indices_match_jax(k, canonical):
    codes = _batch(k)
    want = np.asarray(jax_window_indices(jnp.asarray(codes), k, canonical))
    got = window_indices(torch.from_numpy(codes), k, canonical)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 2, 8, 15, 16, 17, 20, 24, 30, 31])
@pytest.mark.parametrize("canonical", [False, True])
def test_kmer_keys_match_jax(k, canonical):
    codes = _batch(100 + k, p_invalid=0.01)
    want_hi, want_lo = map(
        np.asarray, jax_kmer_keys(jnp.asarray(codes), k, canonical)
    )
    hi, lo = kmer_keys(torch.from_numpy(codes), k, canonical)
    np.testing.assert_array_equal(hi.numpy().astype(np.uint32), want_hi)
    np.testing.assert_array_equal(lo.numpy().astype(np.uint32), want_lo)
    assert int(lo.max()) <= INVALID_SENTINEL


def test_window_rules_and_errors():
    """Reads shorter than k raise; pad and N poison exactly the windows
    that cover them; canonical palindromes keep their own index."""
    with pytest.raises(ValueError):
        window_indices(torch.zeros((2, 3), dtype=torch.int8), 4)
    with pytest.raises(ValueError):
        window_indices(torch.zeros((2, 40), dtype=torch.int8), 16)
    codes = torch.tensor([[0, 1, 2, 3, -1, 0, 1]], dtype=torch.int8)
    got = window_indices(codes, 4, canonical=True)
    # ACGT is its own reverse complement: index 0b00011011 = 27.
    assert got.tolist() == [[27, -1, -1, -1]]
    assert split_k(7) == (4, 3) and split_k(1) == (1, 0)
