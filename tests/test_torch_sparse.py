"""The sparse spectrum of cfrk_tpu_torch against cfrk_tpu.

Host accumulators, the dense fold, the per-batch triples of the sorted
route, the file driver and the ``KMER<TAB>count`` writer of the port
are held against the JAX package's, including accumulator state carried
from a JAX accumulator into the port's.  Tolerance: exact equality --
every output is an integer array or bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfrk_tpu.io.native import fold_pairs_into as jax_fold_pairs_into
from cfrk_tpu.ops import perread_sparse as jps
from cfrk_tpu.ops import sparse as jsparse
from cfrk_tpu.pipeline import count as jcount
from cfrk_tpu_torch.format import format_kmer_tsv_bytes
from cfrk_tpu_torch.ops import perread_sparse as tps
from cfrk_tpu_torch.ops import sparse as tsparse
from cfrk_tpu_torch.pipeline import count as tcount


def _batch(seed, b, length, p_invalid=0.02):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, length)).astype(np.int8)
    codes[rng.random(codes.shape) < p_invalid] = -1
    return codes


def _repetitive_batch(seed, b, length):
    """Reads drawn from one short genome, so k-mers repeat across reads
    and batches (the accumulators' merge paths all run)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=400).astype(np.int8)
    starts = rng.integers(0, 400 - length, size=b)
    codes = genome[starts[:, None] + np.arange(length)]
    codes[rng.random(codes.shape) < 0.01] = -1
    return codes


def _triples_equal(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [3, 8, 12, 15, 21, 31])
@pytest.mark.parametrize("canonical", [False, True])
def test_batch_spectrum_triples_match_jax(k, canonical):
    """Drain dtypes included: uint16 idx at k <= 8, int32 idx to k = 15,
    uint32 (hi, lo) words above; narrow counts."""
    codes = _batch(k, 11, 128)
    got = tps.batch_spectrum_triples(codes, k, canonical, max_len=100, device="cpu")
    want = jsparse.batch_spectrum_triples(codes, k, canonical, max_len=100)
    _triples_equal(got, want)


@pytest.mark.parametrize("k", [5, 8, 20])
def test_rows_to_triples_match_jax(k):
    codes = _batch(50 + k, 7, 90)
    got = tps.rows_to_triples(tps.count_perread_rows(torch.from_numpy(codes), k), k)
    want = jsparse.rows_to_triples(jps.count_perread_rows(jnp.asarray(codes), k), k)
    _triples_equal(got, want)


def _jax_and_port_triples(k, n_batches=5):
    for i in range(n_batches):
        codes = _repetitive_batch(100 * k + i, 9, 80)
        yield (
            jsparse.batch_spectrum_triples(codes, k, True),
            tps.batch_spectrum_triples(codes, k, True, device="cpu"),
        )


@pytest.mark.parametrize("k", [7, 13, 31])
@pytest.mark.parametrize("merge_every", [1, 2, 32])
def test_sparse_accumulator_matches_jax(k, merge_every):
    jacc = jsparse.SparseAccumulator(merge_every=merge_every)
    tacc = tsparse.SparseAccumulator(merge_every=merge_every)
    for jt, tt in _jax_and_port_triples(k):
        jacc.add(*jt)
        tacc.add(*tt)
    (jk, jc), (tk, tc) = jacc.result_arrays(), tacc.result_arrays()
    assert tk.dtype == np.uint64 and tc.dtype == np.int64
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tc, jc)
    assert np.all(np.diff(tk.astype(np.float64)) > 0)


@pytest.mark.parametrize("k", [4, 8, 10])
def test_dense_fold_accumulator_matches_jax(k):
    jacc, tacc = jsparse.DenseFoldAccumulator(k), tsparse.DenseFoldAccumulator(k)
    for jt, tt in _jax_and_port_triples(k):
        jacc.add(*jt)
        tacc.add(*tt)
    for g, w in zip(tacc.result_arrays(), jacc.result_arrays()):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="k <= 10"):
        tsparse.DenseFoldAccumulator(11)


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_state_carried_from_jax_accumulator(kind):
    """A JAX accumulator's result arrays load into the port's, which then
    takes more batches: the result equals one JAX accumulator fed every
    batch."""
    k = 9
    make_j = (lambda: jsparse.SparseAccumulator()) if kind == "sparse" else (
        lambda: jsparse.DenseFoldAccumulator(k))
    make_t = (lambda: tsparse.SparseAccumulator()) if kind == "sparse" else (
        lambda: tsparse.DenseFoldAccumulator(k))
    pairs = list(_jax_and_port_triples(k, 6))
    first, whole = make_j(), make_j()
    for jt, _ in pairs[:3]:
        first.add(*jt)
    for jt, _ in pairs:
        whole.add(*jt)
    port = make_t()
    port.load_arrays(*first.result_arrays())
    for _, tt in pairs[3:]:
        port.add(*tt)
    for g, w in zip(port.result_arrays(), whole.result_arrays()):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize(
    "idx_dtype,cnt_dtype", [(np.uint16, np.uint8), (np.int32, np.int16),
                            (np.int32, np.int32), (np.uint32, np.int64)]
)
def test_fold_pairs_into_matches_jax(idx_dtype, cnt_dtype):
    rng = np.random.default_rng(5)
    size = 4**6
    idx = rng.integers(0, size, size=(40, 30)).astype(idx_dtype)
    cnt = rng.integers(0, 9, size=(40, 30)).astype(cnt_dtype)
    idx[0, :5] = 0  # wrapped uint16 sentinels: count 0, skipped
    cnt[0, :5] = 0
    if idx_dtype == np.uint32:
        idx[1, :3] = 0xFFFFFFFF  # out of the table: skipped
    got, want = np.full(size, 7, np.int64), np.full(size, 7, np.int64)
    tsparse.fold_pairs_into(got, idx, cnt)
    jax_fold_pairs_into(want, idx, cnt)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="int64"):
        tsparse.fold_pairs_into(np.zeros(size, np.int32), idx, cnt)


def test_merge_sorted_key_counts_matches_jax():
    rng = np.random.default_rng(6)
    parts = []
    for _ in range(4):
        keys = np.unique(rng.integers(0, 4**20, size=50, dtype=np.uint64))
        parts.append((keys, rng.integers(1, 9, size=keys.size)))
    parts.append((np.empty(0, np.uint64), np.empty(0, np.int64)))
    for g, w in zip(tsparse.merge_sorted_key_counts(parts),
                    jsparse.merge_sorted_key_counts(parts)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tsparse.merge_sorted_key_counts([]),
                    jsparse.merge_sorted_key_counts([])):
        assert g.dtype == w.dtype and g.size == w.size == 0


@pytest.mark.parametrize("k", [1, 7, 31])
def test_decode_key_matches_jax(k):
    for key in (0, 4**k - 1, 0x1B1B1B1B1B1B1B1B % 4**k):
        assert tsparse.decode_key(key, k) == jsparse.decode_key(key, k)
    assert tsparse.decode_key(0b00011011, 4) == "ACGT"


@pytest.mark.parametrize("k", [5, 31])
@pytest.mark.parametrize("min_count", [1, 2, 5])
def test_kmer_tsv_bytes_match_jax_python_writer(k, min_count):
    """Byte-equal to the JAX CLI's Python line loop (cli.py, the
    ``decode_key`` fallback of ``_write_sparse``)."""
    rng = np.random.default_rng(k)
    keys = np.unique(rng.integers(0, 4**k, size=300, dtype=np.uint64))
    counts = rng.integers(0, 12, size=keys.size).astype(np.int64)
    counts[-1] = 2**40
    mask = counts >= max(min_count, 1)
    want = "".join(
        f"{jsparse.decode_key(int(key), k)}\t{c}\n"
        for key, c in zip(keys[mask].tolist(), counts[mask].tolist())
    ).encode()
    assert format_kmer_tsv_bytes(keys, counts, k, min_count) == want


def _fasta(tmp_path, reads):
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    path = tmp_path / "r.fa"
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">r%d\n%s\n" % (i, lut[np.where(r < 0, 4, r)].tobytes()))
    return str(path)


@pytest.mark.parametrize("k,canonical", [(8, False), (15, True), (31, True), (24, False)])
def test_sparse_spectrum_file_matches_jax(tmp_path, k, canonical):
    reads = list(_repetitive_batch(k, 50, 120)) + [np.zeros(5, np.int8)]
    path = _fasta(tmp_path, reads)
    got = tcount.sparse_spectrum_file(path, k, device="cpu", canonical=canonical,
                                      batch_size=16)
    want = jcount.sparse_spectrum_file(path, k, canonical=canonical, batch_size=16)
    assert got == want and got
    keys, counts = tcount.sparse_spectrum_arrays(path, k, device="cpu",
                                                 canonical=canonical)
    assert sorted(want) == keys.tolist()
    assert [want[key] for key in sorted(want)] == counts.tolist()


def test_sparse_spectrum_file_empty_input(tmp_path):
    path = tmp_path / "e.fa"
    path.write_bytes(b"")
    assert tcount.sparse_spectrum_file(str(path), 31, device="cpu") == {}
