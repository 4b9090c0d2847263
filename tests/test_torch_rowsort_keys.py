"""The key arithmetic of the CUDA rowsort kernels, on the CPU.

The kernels of ``cfrk_tpu_torch/csrc/rowsort.cu`` cannot run without a
card, but their bit tricks can: ``ops/cuda/rowsort.py`` keeps a numpy
model of ``cfrk::pack_unit`` and ``cfrk::packed_window_key``
(``csrc/kmer_key.cuh``) -- 2-bit packing into 16-base units, the invalid
mask, funnel-shift extraction, the reverse complement by bit reversal --
written line for line as the device code, and of the sort network
(``sort_in_registers``), which must sort.  Here the key model is held
against the port's plain key functions (``window_indices``,
``kmer_keys``) and against ``cfrk_tpu``'s own, over k x canonical x row
length, on rows with N bases, -1 padding, poly-A and poly-T rows (the
16-T case, whose hi word equals the uint32 sentinel at k = 31) and
palindromic repeats (canonical ties).  At k <= 8 the kernel sorts two
16-bit keys a register (``rowsort_rle_pairs``): its model -- key build
with the padding value 0xFFFF and the count of real windows, the packed
network, the emit cut at that count -- is held against ``np.sort`` and
against the plain rows (``rowsort_rle_plain``, ``rle_rows``), poly-T
rows included, whose key TTTTTTTT is 0xFFFF at k = 8.  Rows whose W lies
just above a power of two P split into a head of P cells and a short
tail, two reads a word (``rowsort_rle_split``): the model of its key
build, its network and its merge is held against ``np.sort`` and the
plain rows, on rows whose tail keys all lie below or above the head's,
head-tail ties, poly-T, all-N and padded rows, in odd batches (the last
pair half empty).  Above k = 15,
rows of up to 256 keys sort 32-bit prefix-and-position words
(``rowsort_rle_prefix``): the model of the word build, the flip-form
sort, the gather of the full keys and the warp's repair is held
against ``np.sort`` and the plain rows (``rowsort_rle_large_plain``),
on rows in which distinct keys share a prefix in reverse position order
(the repair must fire), and its flags against the plain readout
(``rowsort_fallbacks_plain``).  Inputs from a numpy seed.  Tolerance:
none, every value is an integer.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfrk_tpu.ops.encode import window_indices as jax_window_indices
from cfrk_tpu.ops.sparse import kmer_keys as jax_kmer_keys
from cfrk_tpu_torch.ops.cuda import rowsort as R
from cfrk_tpu_torch.ops.encode import window_indices
from cfrk_tpu_torch.ops.sparse import INVALID_SENTINEL, LO_BASES, kmer_keys
from cfrk_tpu_torch.tools.onchip_validate import prefix_tie_row

KS = (1, 2, 8, 15, 16, 17, 31)
FULL = 257  # the longest row; shorter rows are its prefixes
SENTINEL64 = (1 << 64) - 1  # the kernel's uint64 sentinel, all ones


def _lengths(k):
    return sorted({n for n in (k, k + 1, 31, 32, 33, 64, 150, FULL) if n >= k})


CASES = [(k, canonical, length)
         for k in KS for canonical in (False, True) for length in _lengths(k)]


@functools.cache
def _rows() -> np.ndarray:
    """[R, FULL] int8 codes: random rows with N bases, rows padded with
    -1 from several positions on, poly-A, poly-T, all-N, and repeats of
    ACGT, AT and CG (each its own reverse complement: even-k windows of
    them are palindromes)."""
    rng = np.random.default_rng(20240)
    rows = rng.integers(0, 4, size=(24, FULL)).astype(np.int8)
    rows[:8][rng.random((8, FULL)) < 0.03] = -1
    rows[8:12][rng.random((4, FULL)) < 0.3] = -1
    for r, start in zip(range(12, 18), (1, 20, 47, 100, 140, 250)):
        rows[r, start:] = -1
    rows[18] = 0
    rows[19] = 3
    rows[20] = -1
    rows[21] = np.resize([0, 1, 2, 3], FULL)
    rows[22] = np.resize([0, 3], FULL)
    rows[23] = np.resize([1, 2], FULL)
    return rows


def _combine(hi, lo):
    """(hi, lo) uint32 key words -> the kernel's uint64 key, the all-ones
    sentinel where lo is invalid."""
    hi = np.asarray(hi).astype(np.uint64)
    lo = np.asarray(lo).astype(np.uint64)
    key = (hi << np.uint64(2 * LO_BASES)) | lo
    return np.where(lo == np.uint64(INVALID_SENTINEL), np.uint64(SENTINEL64), key)


@functools.cache
def _jax_keys(k, canonical):
    """cfrk_tpu's keys of every window of the full rows: the combined
    uint64 key, and for k <= 15 the int32 index (-1 invalid).  A
    window's key depends on its own k codes only, so a shorter row's
    windows are a prefix of these."""
    codes = jnp.asarray(_rows())
    key64 = _combine(*jax_kmer_keys(codes, k, canonical))
    idx = np.asarray(jax_window_indices(codes, k, canonical)) if k <= 15 else None
    return key64, idx


def _model(rows, k, canonical, bits, sentinel):
    w = rows.shape[1] - k + 1
    out = np.empty((rows.shape[0], w), np.uint64)
    for r, row in enumerate(rows):
        bases, invalid = R.pack_units_model(row, R.packed_units(w))
        out[r] = R.packed_window_keys_model(
            bases, invalid, np.arange(w), k, canonical, bits, sentinel)
    return out


@pytest.mark.parametrize("k,canonical,length", CASES)
def test_packed_keys_equal_plain_and_jax(k, canonical, length):
    rows = _rows()[:, :length]
    w = length - k + 1
    codes = torch.from_numpy(rows)
    jax64, jax_idx = _jax_keys(k, canonical)

    got64 = _model(rows, k, canonical, 64, SENTINEL64)
    np.testing.assert_array_equal(
        got64, _combine(*(t.numpy() for t in kmer_keys(codes, k, canonical))))
    np.testing.assert_array_equal(got64, jax64[:, :w])

    if k <= 15:
        sentinel = 4**k
        got32 = _model(rows, k, canonical, 32, sentinel).astype(np.int64)
        for want in (window_indices(codes, k, canonical).numpy(), jax_idx[:, :w]):
            want = want.astype(np.int64)
            np.testing.assert_array_equal(got32, np.where(want < 0, sentinel, want))


@pytest.mark.parametrize("length", [1, 15, 16, 17, 33, 150])
def test_pack_units_model_layout(length):
    """Unit h holds codes 16h..16h+15, the first in the two top bits;
    invalid bit b is code 16h+b < 0, and every position past the row's
    end is invalid."""
    row = _rows()[3, :length]
    n_units = R.packed_units(length)
    bases, invalid = R.pack_units_model(row, n_units)
    assert bases.shape == invalid.shape == (n_units,)
    for p in range(n_units * R.UNIT_BASES):
        h, b = divmod(p, R.UNIT_BASES)
        code = int(row[p]) if p < length else -1
        assert (int(invalid[h]) >> b) & 1 == (code < 0)
        assert (int(bases[h]) >> (2 * (R.UNIT_BASES - 1 - b))) & 3 == max(code, 0)
    assert int(bases.max()) < 1 << 32 and int(invalid.max()) < 1 << 16


def test_16t_key_is_not_the_sentinel():
    """Sixteen leading T at k = 31 make hi 0xFFFFFFFF, the uint32
    sentinel; the 64-bit key stays below the all-ones sentinel."""
    row = np.zeros(64, np.int8)
    row[:20] = 3
    bases, invalid = R.pack_units_model(row, R.packed_units(34))
    key = R.packed_window_keys_model(bases, invalid, np.arange(34), 31, False,
                                     64, SENTINEL64)
    assert int(key[0]) >> (2 * LO_BASES) == INVALID_SENTINEL
    assert (key < np.uint64(4**31)).all()
    hi, lo = kmer_keys(torch.from_numpy(row[None]), 31, False)
    np.testing.assert_array_equal(key, _combine(hi[0].numpy(), lo[0].numpy()))


@pytest.mark.parametrize("k", [2, 8, 16, 30])
def test_palindromes_tie(k):
    """An even-k window of an ACGT repeat that starts on A is its own
    reverse complement: canonical and forward keys agree there."""
    row = np.resize([0, 1, 2, 3], 96).astype(np.int8)
    w = 96 - k + 1
    bases, invalid = R.pack_units_model(row, R.packed_units(w))
    p = np.arange(0, w, 4) if k % 4 == 0 else np.arange(1, w, 4)
    bits = 32 if k <= 15 else 64
    fwd = R.packed_window_keys_model(bases, invalid, p, k, False, bits, 0)
    can = R.packed_window_keys_model(bases, invalid, p, k, True, bits, 0)
    np.testing.assert_array_equal(fwd, can)


@pytest.mark.parametrize("keys_per_thread", [8, 16])
@pytest.mark.parametrize("width", [32, 64, 128, 256, 512, 1024, 2048, 4096])
def test_register_sort_network_sorts(width, keys_per_thread):
    """The kernel's register / shuffle / shared-memory network, as a
    numpy model, sorts rows of every width it serves: distinct keys,
    many duplicates, and a row of sentinels with a few real keys."""
    rng = np.random.default_rng(width + keys_per_thread)
    rows = [rng.integers(0, 1 << 62, width).astype(np.uint64),
            rng.integers(0, 7, width).astype(np.uint64),
            np.where(rng.random(width) < 0.1, rng.integers(0, 4**8, width),
                     4**8).astype(np.uint64)]
    for row in rows:
        np.testing.assert_array_equal(
            R.sort_in_registers_model(row, keys_per_thread), np.sort(row))


def test_model_rejects_k_beyond_key_width():
    bases, invalid = R.pack_units_model(np.zeros(40, np.int8), 4)
    with pytest.raises(ValueError):
        R.packed_window_keys_model(bases, invalid, [0], 16, False, 32, 0)
    with pytest.raises(ValueError):
        R.packed_window_keys_model(bases, invalid, [0], 32, False, 64, 0)


# ------------------------------------------- two keys a register (k <= 8)

PAIR_KS = (1, 2, 7, 8)
LONG = 4096 + 7  # rows of 512 .. 4096 windows at k <= 8 are its prefixes


@functools.cache
def _long_rows() -> np.ndarray:
    """[8, LONG] int8 codes for the widest register rows: random rows
    with N bases, one N-heavy, poly-T, poly-A, all-N, and rows padded
    with -1 from several positions on."""
    rng = np.random.default_rng(20241)
    rows = rng.integers(0, 4, size=(8, LONG)).astype(np.int8)
    rows[:2][rng.random((2, LONG)) < 0.01] = -1
    rows[2][rng.random(LONG) < 0.4] = -1
    rows[3] = 3
    rows[4] = 0
    rows[5] = -1
    rows[6, 700:] = -1
    rows[7, 2500:] = -1
    rows[7, 100:600] = 3
    return rows


def _pair_rows_model(rows, k, canonical):
    """The 16-bit path's rows by its model, row by row: packed, keys
    built, sorted two a register, emitted; and the rows' real windows."""
    w = rows.shape[1] - k + 1
    width = R._sort_width(w)
    kw = R.keys_per_thread(width, False) // 2
    idx = np.empty((rows.shape[0], w), np.int32)
    counts = np.empty_like(idx)
    n_valid = []
    for r, row in enumerate(rows):
        bases, invalid = R.pack_units_model(row, R.packed_units(w))
        keys, nv = R.pair_keys_model(bases, invalid, width, k, canonical, kw)
        idx[r], counts[r] = R.finish_pairs_model(R.sort_pairs_model(keys, kw), nv, w, k)
        n_valid.append(nv)
    return idx, counts, np.array(n_valid)


PAIR_CASES = ([(k, canonical, length, False) for k in PAIR_KS for canonical in (False, True)
               for length in _lengths(k)]
              + [(k, canonical, w + k - 1, True) for k in PAIR_KS for canonical in (False, True)
                 for w in (512, 1030, 2048, 4096)])


@pytest.mark.parametrize("k,canonical,length,long", PAIR_CASES)
def test_pair_rows_equal_plain(k, canonical, length, long):
    """The model of the 16-bit path gives the plain rows, and counts the
    real windows the plain keys have."""
    rows = (_long_rows() if long else _rows())[:, :length]
    assert R.key16_path(length - k + 1, k)
    codes = torch.from_numpy(rows)
    idx, counts, n_valid = _pair_rows_model(rows, k, canonical)
    want_idx, want_counts = R.rowsort_rle_plain(codes, k, canonical)
    np.testing.assert_array_equal(idx, want_idx.numpy())
    np.testing.assert_array_equal(counts, want_counts.numpy())
    np.testing.assert_array_equal(
        n_valid, (window_indices(codes, k, canonical) >= 0).sum(1).numpy())


def test_poly_t_is_a_key_not_padding():
    """At k = 8 TTTTTTTT is 0xFFFF, the padding value: a poly-T read is
    one run of all its windows, and a read with T's before its -1 tail
    keeps their run, cut where the real windows end."""
    rows = np.full((2, 150), 3, np.int8)
    rows[1, 40:] = -1
    rows[1, :10] = 0
    idx, counts, n_valid = _pair_rows_model(rows, 8, False)
    assert n_valid.tolist() == [143, 33]
    assert (idx[0, 0], counts[0, 0]) == (4**8 - 1, 143) and counts[0, 1:].sum() == 0
    got = [(int(i), int(c)) for i, c in zip(idx[1], counts[1]) if c]
    assert got == [(0, 3), (3, 1), (15, 1), (63, 1), (255, 1), (1023, 1), (4095, 1),
                   (16383, 1), (4**8 - 1, 23)]


@pytest.mark.parametrize("words_per_thread", [4, 8, 16])
@pytest.mark.parametrize("width", [32, 64, 128, 256, 512, 1024, 2048, 4096])
def test_pair_sort_network_sorts(width, words_per_thread):
    """The packed network, as a numpy model, sorts rows of every width
    the 16-bit path serves at every count of words a thread: distinct
    keys, many duplicates, padding with real 0xFFFF keys among it, a
    row of padding with a few real keys."""
    rng = np.random.default_rng(width * words_per_thread)
    pad = np.where(rng.random(width) < 0.5, R.PAD16, rng.integers(0, 1 << 16, width))
    rows = [rng.integers(0, 1 << 16, width), rng.integers(0, 7, width), pad,
            np.where(rng.random(width) < 0.1, rng.integers(0, 4**8, width), R.PAD16)]
    for row in rows:
        row = row.astype(np.uint32)
        np.testing.assert_array_equal(R.sort_pairs_model(row, words_per_thread), np.sort(row))


SPLIT_WINDOWS = (65, 80, 81, 129, 143, 144, 160, 161, 257, 320, 321)


def test_key16_path_follows_the_launch_rule():
    """k <= 8 and rows of up to 4096 keys take the 16-bit path
    (csrc/rowsort.cu ``launch``); k 9-15, the uint64 keys and wider rows
    keep their kernels.  Its threads hold the uint32 path's keys, two a
    word, so the rows a block, and the checksum's layout, do not change
    with k, except where a row splits (``split_head``): k <= 8,
    P < W <= P + P/4 for P = 128 and 256, and at least 512 blocks of
    4096 / head reads, two reads on head / 8 threads."""
    for k in range(1, 32):
        for w in (1, 31, 32, 143, 256, 2049, 4096, 4097, 16384, 32768):
            assert R.key16_path(w, k) == (k <= 8 and w <= 4096), (w, k)
    for width in (32, 64, 128, 256, 512, 1024, 2048, 4096):
        keys = R.keys_per_thread(width, False)
        assert keys // 2 <= R.UNIT_BASES and width >= keys
        for k in (8, 12):
            assert R.checksum_rows_per_block(width, k, 7) == 256 * keys // width
    splits = {129: (128, 8),
              136: (128, 8), 137: (128, 16), 143: (128, 16), 144: (128, 16),
              145: (128, 32), 160: (128, 32), 257: (256, 8), 264: (256, 8),
              265: (256, 16), 288: (256, 32), 289: (256, 64), 320: (256, 64)}
    least = {128: 16384, 256: 8192}  # reads of 512 blocks
    for k in range(1, 32):
        for w in (1, 32, 33, 40, 64, *SPLIT_WINDOWS, *splits, 72, 73, 176, 192, 256, 384,
                  512, 513, 520, 576, 4096):
            for b in (1, 7, 8191, 8192, 16383, 16384, 100_000):
                split = splits.get(w) if k <= 8 else None
                want = split if split and b >= least[split[0]] else None
                assert R.split_path(w, k, b) == want, (w, k, b)
                if want:
                    assert R.key16_path(w, k)
                    assert R.checksum_rows_per_block(w, k, b) == 2 * 256 * 8 // want[0]
                    tail_threads = want[1] // R._tail_words_per_thread(*want)
                    assert tail_threads <= want[0] // 8 and w <= sum(want)


# ------------------------------- two reads a word (k <= 8, split rows)


def _split_rows(w: int, k: int) -> np.ndarray:
    """[11, w + k - 1] int8 rows for a split width (an odd batch: the
    last pair's high lanes hold no read): random with N, N-heavy,
    poly-T, poly-A, all-N, rows cut by -1 inside the head, rows whose
    tail windows all start with A or C and head windows with G or T
    (every tail key below every head key) and the reverse, an ACGT and
    an AAC repeat (keys shared by head and tail)."""
    length = w + k - 1
    head = 1 << (w - 1).bit_length() - 1
    rng = np.random.default_rng(w * 100 + k)
    rows = rng.integers(0, 4, size=(11, length)).astype(np.int8)
    rows[0][rng.random(length) < 0.02] = -1
    rows[1][rng.random(length) < 0.3] = -1
    rows[2] = 3
    rows[3] = 0
    rows[4] = -1
    rows[5, head // 3:] = -1
    rows[6, :head] = rng.integers(2, 4, head)
    rows[6, head:] = rng.integers(0, 2, length - head)
    rows[7, :head] = rng.integers(0, 2, head)
    rows[7, head:] = rng.integers(2, 4, length - head)
    rows[8] = np.resize([0, 1, 2, 3], length)
    rows[9] = np.resize([0, 0, 1], length)
    rows[10, head - 3:] = 3  # a T run across the head's end, -1 after it
    rows[10, head + 5:] = -1
    return rows


def _split_rows_model(rows, k, canonical, head, tail):
    """The split path's rows by its model, two reads at a time (a read
    past the batch packs as all invalid): packed, keys built, sorted and
    merged two a word, emitted; the merged rows and the real windows."""
    w = rows.shape[1] - k + 1
    padded = np.concatenate([rows, np.full((1, rows.shape[1]), -1, np.int8)])
    idx = np.empty((rows.shape[0], w), np.int32)
    counts = np.empty_like(idx)
    merged, n_valid = [], []
    for a in range(0, rows.shape[0], 2):
        packed = [R.pack_units_model(padded[r], R.packed_units(w)) for r in (a, a + 1)]
        head_words, tail_words, nv = R.split_keys_model(*packed, head, tail, k, canonical)
        for r, row, n in zip((a, a + 1), R.sort_split_model(head_words, tail_words), nv):
            if r < rows.shape[0]:
                idx[r], counts[r] = R.finish_pairs_model(row, n, w, k)
                merged.append(row)
                n_valid.append(n)
    return idx, counts, np.array(merged), np.array(n_valid)


SPLIT_CASES = [(k, canonical, w) for k in PAIR_KS for canonical in (False, True)
               for w in SPLIT_WINDOWS]


@pytest.mark.parametrize("k,canonical,w", SPLIT_CASES)
def test_split_rows_equal_plain(k, canonical, w):
    """The model of the split (two reads a word, head and tail sorted
    apart and merged) gives np.sort's cells, the plain rows and the
    plain rows' run-length encoding, and counts the real windows, at
    W = P + 1, 143, 144 and each head's threshold P + P/4.  One past it
    (161, 321), and at P = 64 (65, 80, 81), the kernel does not split:
    there the model of the 2P-cell row it takes gives the plain rows."""
    split = R.split_path(w, k, 100_000)
    head = 1 << (w - 1).bit_length() - 1
    assert (split is None) == (w - head > head // 4 or head < 128)
    rows = _split_rows(w, k)
    codes = torch.from_numpy(rows)
    want_idx, want_counts = R.rowsort_rle_plain(codes, k, canonical)
    if split is None:
        idx, counts, n_valid = _pair_rows_model(rows, k, canonical)
        np.testing.assert_array_equal(idx, want_idx.numpy())
        np.testing.assert_array_equal(counts, want_counts.numpy())
        np.testing.assert_array_equal(
            n_valid, (window_indices(codes, k, canonical) >= 0).sum(1).numpy())
        return
    idx, counts, merged, n_valid = _split_rows_model(rows, k, canonical, *split)
    keys = window_indices(codes, k, canonical).numpy()
    np.testing.assert_array_equal(n_valid, (keys >= 0).sum(1))
    cells = np.full((rows.shape[0], sum(split)), R.PAD16, np.int64)
    cells[:, :w] = np.where(keys < 0, R.PAD16, keys)
    np.testing.assert_array_equal(merged, np.sort(cells, axis=1))
    np.testing.assert_array_equal(idx, want_idx.numpy())
    np.testing.assert_array_equal(counts, want_counts.numpy())
    real = torch.arange(w).expand(rows.shape[0], w) < torch.from_numpy(n_valid)[:, None]
    rle_idx, rle_counts = R.rle_rows(torch.from_numpy(merged[:, :w]).to(torch.int32),
                                     real, 4**k)
    np.testing.assert_array_equal(idx, rle_idx.numpy())
    np.testing.assert_array_equal(counts, rle_counts.numpy())


@pytest.mark.parametrize("head,tail", [(128, 8), (128, 16), (128, 32), (256, 8), (256, 16),
                                       (256, 32), (256, 64)])
def test_split_sort_network_sorts(head, tail):
    """The split's network and merge, as a numpy model, sort both lanes
    at every head and tail the kernel splits: distinct
    keys, many duplicates (ties across head and tail), padding with real
    0xFFFF keys among it, every tail key below the head's, above it, and
    a lane of padding beside a lane of keys."""
    rng = np.random.default_rng(head * 1000 + tail)
    n = head + tail
    lanes = [rng.integers(0, 1 << 16, n), rng.integers(0, 7, n),
             np.where(rng.random(n) < 0.5, R.PAD16, rng.integers(0, 1 << 16, n)),
             np.concatenate([rng.integers(1000, 2000, head), rng.integers(0, 1000, tail)]),
             np.concatenate([rng.integers(0, 1000, head), rng.integers(1000, 2000, tail)]),
             np.full(n, R.PAD16)]
    for a, b in zip(lanes, lanes[1:] + lanes[:1]):
        a, b = a.astype(np.uint32), b.astype(np.uint32)
        words = a | (b << np.uint32(16))
        got_a, got_b = R.sort_split_model(words[:head], words[head:])
        np.testing.assert_array_equal(got_a, np.sort(a))
        np.testing.assert_array_equal(got_b, np.sort(b))


# ------------------------- prefix-and-position words (k > 15, rows <= 256)

PREFIX_KS = (16, 20, 30, 31)
PREFIX_WINDOWS = (20, 32, 50, 64, 122, 128, 200, 256)  # widths 32 .. 256


def _prefix_rows(k, length):
    """[R, length] int8 rows for the prefix path: random, N-heavy,
    poly-A, poly-T, all-N, half padded, a run of 30 T (forward keys of
    one prefix in descending order: more than the transposition rounds
    repair), and (where two windows fit apart) rows with distinct keys
    that share a prefix in reverse position order.  Returns the rows and
    the indices of the tie rows."""
    rng = np.random.default_rng(k * 1000 + length)
    rows = rng.integers(0, 4, size=(9, length)).astype(np.int8)
    rows[8, 2:32] = 3
    rows[1][rng.random(length) < 0.1] = -1
    rows[2] = 0
    rows[3] = 3
    rows[4] = -1
    rows[5, length // 2:] = -1
    ties = []
    if length >= 2 * k + 5:
        rows[6] = prefix_tie_row(rng, length, k)
        rows[7] = prefix_tie_row(rng, length, k)
        rows[7][rng.random(length) < 0.02] = -1  # an N may cut X or Y
        ties = [6]
    return rows, ties


def _emit64(s, w):
    """``finish_row`` at k > 15 over one sorted row of uint64 keys: hi,
    lo and counts at run starts, -1, -1 and 0 elsewhere (int32)."""
    s = np.asarray(s, np.uint64)
    key = s[:w]
    first = key != np.uint64(SENTINEL64)
    first[1:] &= key[1:] != key[:-1]
    counts = np.where(first, np.searchsorted(s, key, side="right") - np.arange(w), 0)
    hi = np.where(first, key >> np.uint64(2 * LO_BASES), 0xFFFFFFFF).astype(np.uint32)
    lo = np.where(first, key & np.uint64(R.LO_MASK), 0xFFFFFFFF).astype(np.uint32)
    return hi.view(np.int32), lo.view(np.int32), counts.astype(np.int32)


PREFIX_CASES = [(k, canonical, w) for k in PREFIX_KS for canonical in (False, True)
                for w in PREFIX_WINDOWS]


@pytest.mark.parametrize("k,canonical,w", PREFIX_CASES)
def test_prefix_rows_equal_plain(k, canonical, w):
    """The model of the prefix path (key build, words, flip-form sort,
    gather, repair) gives np.sort's keys and the plain rows, and repairs
    exactly the rows the plain readout names: the tie rows always, by
    transposition rounds alone."""
    length = w + k - 1
    rows, ties = _prefix_rows(k, length)
    assert R.prefix_path(w, k)
    width = R._sort_width(w)
    kpt = R.keys_per_thread(width, True)
    codes = torch.from_numpy(rows)
    want = [t.numpy() for t in R.rowsort_rle_large_plain(codes, k, canonical)]
    flags = []
    for r, row in enumerate(rows):
        bases, invalid = R.pack_units_model(row, R.packed_units(w))
        keys = np.full(width, SENTINEL64, np.uint64)
        keys[:w] = R.packed_window_keys_model(bases, invalid, np.arange(w), k, canonical,
                                              64, SENTINEL64)
        got, out_of_order, network = R.sort_prefix_model(keys, k, kpt)
        np.testing.assert_array_equal(got, np.sort(keys))
        for g, x in zip(_emit64(got, w), want):
            np.testing.assert_array_equal(g, x[r])
        flags.append(out_of_order)
        if r in ties:
            assert out_of_order and not network, f"row {r}: a tie pair is one round's repair"
    own = R.rowsort_fallbacks_plain(codes, k, canonical) == 1
    assert own.tolist() == flags


@pytest.mark.parametrize("width", [32, 64, 128, 256])
def test_prefix_sort_network_sorts(width):
    """The word network and its repair, as a numpy model, sort rows of
    every width the prefix path serves: distinct keys, many duplicates
    of 7 small keys (one prefix: repaired), the sentinel among them, the
    largest real key (all T) beside the sentinel (no two distinct keys
    share a prefix), and distinct keys of one prefix in descending
    position order, which takes the uint64 network."""
    rng = np.random.default_rng(width)
    k = 31
    top = np.uint64(4**k - 1)
    shared = np.uint64(12345) << np.uint64(40)
    rows = [rng.integers(0, 4**k, width, dtype=np.uint64),
            rng.integers(0, 7, width).astype(np.uint64),
            np.where(rng.random(width) < 0.5, np.uint64(SENTINEL64),
                     rng.integers(0, 4**k, width, dtype=np.uint64)),
            np.where(rng.random(width) < 0.5, np.uint64(SENTINEL64), top),
            shared + np.arange(width, 0, -1, dtype=np.uint64)]
    for i, row in enumerate(rows):
        got, out_of_order, network = R.sort_prefix_model(row, k, 8)
        np.testing.assert_array_equal(got, np.sort(row))
        if i >= 3:
            assert out_of_order == network == (i == 4)


def test_prefix_words_put_the_sentinel_last():
    """Bit 31 marks the sentinel: its words sort after every real key's,
    the all-T key's included, and each word keeps its position in the
    low log2(width) bits."""
    keys = np.array([4**31 - 1, SENTINEL64, 0, 4**31 - 1] + [SENTINEL64] * 28, np.uint64)
    words = R.prefix_words_model(keys, 31)
    assert (words & 31).tolist() == list(range(32))
    real = keys != np.uint64(SENTINEL64)
    assert words[real].max() < words[~real].min()
    assert words[0] >> 5 == (1 << 26) - 1  # the all-T prefix: 26 bits of ones


def test_prefix_fallbacks_mark_the_warp():
    """A row whose own words left it out of order reads 1; the other
    rows of its warp (4 of 16 threads at 122 windows: 2 rows a warp) are
    repaired with it and read 2; other rows 0."""
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 4, size=(6, 152)).astype(np.int8)
    rows[3] = prefix_tie_row(rng, 152, 31)
    got = R.rowsort_fallbacks_plain(torch.from_numpy(rows), 31, True)
    assert got.tolist() == [0, 0, 2, 1, 0, 0]
    assert R.rowsort_fallbacks(torch.from_numpy(rows), 31, True).tolist() == got.tolist()


@pytest.mark.parametrize("k,length", [(15, 150), (31, 300), (16, 272)])
def test_prefix_fallbacks_refuse_other_paths(k, length):
    """The readout exists on the prefix path only: k <= 15 and rows of
    more than 256 windows are refused."""
    with pytest.raises(ValueError, match="prefix path"):
        R.rowsort_fallbacks_plain(torch.zeros((2, length), dtype=torch.int8), k)


def test_prefix_path_follows_the_launch_rule():
    """k > 15 and rows of up to 256 keys take the prefix path
    (csrc/rowsort.cu ``launch``): every k of rowsort_rle_large in rows
    of one warp's threads, 8 keys each; wider rows and k <= 15 keep
    their kernels.  The rows a block, and the checksum's layout, are the
    uint64 path's."""
    for k in range(1, 32):
        for w in (1, 31, 32, 122, 143, 256, 257, 512, 4096, 16384):
            assert R.prefix_path(w, k) == (k >= 16 and w <= 256), (w, k)
    for width in (32, 64, 128, 256):
        keys = R.keys_per_thread(width, True)
        assert width // keys <= 32
        assert R.checksum_rows_per_block(width, 31, 7) == 256 * keys // width
