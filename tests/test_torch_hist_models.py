"""The arithmetic of the two CUDA histogram kernels, on the CPU.

``csrc/perread.cu`` and ``csrc/spectrum.cu`` cannot run without a card,
but what is new in them can: ``ops/cuda/perread.py`` keeps a numpy model
of where a bin lives in a packed output word (``bin_place``), of the
kernel's work units (tiles of rows, chunks of a row's words) and of the
checksum it reads off the old words its atomics return;
``ops/cuda/spectrum.py`` a model, thread by thread, of the flat 16-code
units, the funnel-shift keys, the position test that keeps a window
inside its read, and the two held (key, run) pairs that merge equal keys
before the atomic.  Here the models are held against the plain twins
and against ``cfrk_tpu`` (its Pallas kernels in interpret mode, as
tests/test_pallas.py runs them, and its XLA spectrum).  Inputs from a
numpy seed.  Tolerance: none, every value is an integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfrk_tpu.ops.pallas.perread import count_perread_pallas
from cfrk_tpu.ops.spectrum import spectrum as jax_spectrum
from cfrk_tpu_torch.ops.cuda import perread as P
from cfrk_tpu_torch.ops.cuda import spectrum as S
from cfrk_tpu_torch.ops.encode import split_k


def _batch(seed, b, length, p_invalid=0.03):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, length)).astype(np.int8)
    codes[rng.random(codes.shape) < p_invalid] = -1
    return codes


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- (a) bin -> (word, shift)


@pytest.mark.parametrize("packing", [False, "fh", "b4"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8])
def test_bin_place_is_the_layout(k, packing):
    """Every bin's count added at (word, shift) gives the layout that
    ``_pack`` (and ``unpack_counts``) defines."""
    counts = ((np.arange(4**k, dtype=np.int64) * 7 + 1) % 200).astype(np.int32)
    word, shift = P.bin_place_model(np.arange(4**k), k, packing)
    per = {False: 1, "fh": 2, "b4": 4}[packing]
    image = np.zeros(4**k // per, np.int64)
    np.add.at(image, word, counts.astype(np.int64) << shift)
    image = image.astype(np.uint32).view(np.int32)
    t = torch.from_numpy(counts[None])
    want = P._pack(t, k, packing, 1).reshape(-1) if packing else t.reshape(-1)
    _same(image, want)
    if packing:
        kh, kl = split_k(k)
        back = P.unpack_counts(image.reshape(1, 4**kh // per, 4**kl), 1, packing)
        _same(back, counts[None])


@pytest.mark.parametrize("packing", ["fh", "b4"])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [2, 4, 5, 7, 8])
def test_image_equals_twin_and_pallas(k, canonical, packing):
    """The accumulated image, pad rows included (13 reads in blocks of
    4), equals the plain twin's packed array and the Pallas kernel's."""
    codes = _batch(50 + k, 13, 171)
    kw = dict(packed=packing, read_block=4, checksum=True)
    got, chk = P.perread_image_model(codes, k, canonical, **kw)
    want, wchk = P.perread_hist_plain(torch.from_numpy(codes), k, canonical, **kw)
    _same(got, want)
    _same(chk, wchk)
    assert got.shape[0] == 16 and not got[13:].any()
    jwant, jchk = count_perread_pallas(jnp.asarray(codes), k, canonical=canonical, **kw)
    _same(got, jwant)
    _same(chk, jchk)


@pytest.mark.parametrize("packing", [False, "fh", "b4"])
@pytest.mark.parametrize("image_words,tile_words,max_tile_rows",
                         [(64, 32, 4), (256, 4096, 3), (16384, 4096, 64)])
@pytest.mark.parametrize("k", [3, 5])
def test_units_cover_the_output(k, packing, image_words, tile_words, max_tile_rows):
    """Rows cut into several chunks, several rows to an image, a ragged
    last tile: every word of the output is some unit's, once."""
    codes = _batch(k, 11, 90)
    kw = dict(packed=packing, read_block=5, checksum=True)
    got = P.perread_image_model(codes, k, True, image_words=image_words,
                                tile_words=tile_words,
                                max_tile_rows=max_tile_rows, **kw)
    want = P.perread_hist_plain(torch.from_numpy(codes), k, True, **kw)
    for g, w in zip(got, want):
        _same(g, w)


# ---------------------------------------------------------------- (b) checksum deltas


def _runs_batch(k):
    """Poly-A reads of 3, 4, 5, 8 and 255 windows (one bin reaching each
    count), a dinucleotide read, an all-N read and random reads, padded
    with -1 to 254 + k columns (255 windows: the "b4" limit)."""
    length = 254 + k
    codes = np.full((9, length), -1, np.int8)
    for r, w in enumerate((3, 4, 5, 8, 255)):
        codes[r, :w + k - 1] = 0
    codes[5] = np.resize([0, 1], length)
    codes[7:] = _batch(k, 2, length)
    return codes


@pytest.mark.parametrize("packing", [False, "fh", "b4"])
@pytest.mark.parametrize("read_block", [5, 16])
@pytest.mark.parametrize("k", [2, 5, 8])
def test_checksum_deltas_equal_twin(k, packing, read_block):
    codes = _runs_batch(k)
    kw = dict(packed=packing, read_block=read_block, checksum=True)
    got, chk = P.perread_image_model(codes, k, **kw)
    want, wchk = P.perread_hist_plain(torch.from_numpy(codes), k, **kw)
    _same(got, want)
    _same(chk, wchk)
    counts = P.perread_hist_plain(torch.from_numpy(codes), k).numpy()
    assert [int(c.max()) for c in counts[:5]] == [3, 4, 5, 8, 255]


@pytest.mark.parametrize("k", [2, 5])
def test_checksum_deltas_equal_pallas(k):
    codes = _runs_batch(k)
    kw = dict(packed="b4", read_block=4, checksum=True)
    got, chk = P.perread_image_model(codes, k, **kw)
    want, wchk = count_perread_pallas(jnp.asarray(codes), k, **kw)
    _same(got, want)
    _same(chk, wchk)


# ---------------------------------------------------------------- (c) the spectrum kernel


def _spectrum_batches(k):
    length = 100
    n_cut = _batch(3, 6, length, p_invalid=0.0)
    n_cut[:, ::17] = -1  # N every 17 bases
    short = _batch(4, 6, length)
    short[:, k - 1:] = -1  # every read one base shorter than k
    ragged = _batch(5, 7, length)
    for r, n in enumerate((0, 1, k, k + 1, 40, 99, 100)):
        ragged[r, n:] = -1
    return {
        "random": _batch(2, 12, length),
        "polyA": np.zeros((12, length), np.int8),
        "dinuc": np.tile(np.resize(np.array([0, 1], np.int8), length), (12, 1)),
        "all_N": np.full((5, length), -1, np.int8),
        "N_interrupted": n_cut,
        "shorter_than_k": short,
        "ragged": ragged,
    }


@pytest.mark.parametrize("kind", ["random", "polyA", "dinuc", "all_N",
                                  "N_interrupted", "shorter_than_k", "ragged"])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 2, 5, 7, 8, 9, 10])
def test_spectrum_model_equals_twin_and_jax(k, canonical, kind):
    codes = _spectrum_batches(k)[kind]
    got, _ = S.spectrum_hist_model(codes, k, canonical, threads=32, grid=2)
    want = S.spectrum_hist_plain(torch.from_numpy(codes), k, canonical).numpy()
    np.testing.assert_array_equal(got, want)
    jwant = np.asarray(jax_spectrum(jnp.asarray(codes), k, canonical=canonical,
                                    impl="scatter"))
    np.testing.assert_array_equal(got, jwant)


@pytest.mark.parametrize("skew", [1, 7, 15])
@pytest.mark.parametrize("length", [9, 16, 33, 171])
def test_spectrum_model_off_boundary_and_row_lengths(length, skew):
    """A batch that starts off a 16-byte boundary, rows shorter than a
    unit, rows that are a whole number of units: no window crosses
    reads and none is lost."""
    codes = _batch(length + skew, 9, length)
    for k, canonical in ((3, False), (8, True)):
        got, _ = S.spectrum_hist_model(codes, k, canonical, skew=skew,
                                       threads=64, grid=3)
        want = S.spectrum_hist_plain(torch.from_numpy(codes), k, canonical).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid", [1, 2, 5])
@pytest.mark.parametrize("kind,per_warp", [("polyA", 1), ("dinuc", 2)])
def test_spectrum_model_merges_runs(kind, per_warp, grid):
    """A homopolymer costs one atomic a warp and a dinucleotide repeat
    two, whatever the number of steps a block takes; random reads cost
    about one a window."""
    threads = 64
    codes = _spectrum_batches(8)[kind]
    table, atomics = S.spectrum_hist_model(codes, 8, threads=threads, grid=grid)
    assert int(table.sum()) == 12 * 93
    steps = -(-codes.size // (threads * 16))
    assert atomics <= per_warp * (threads // 32) * min(grid, steps)
    rnd = _spectrum_batches(8)["random"]
    table, atomics = S.spectrum_hist_model(rnd, 8, threads=threads, grid=grid)
    assert 0.9 * int(table.sum()) <= atomics <= int(table.sum())
