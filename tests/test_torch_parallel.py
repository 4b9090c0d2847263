"""cfrk_tpu_torch's device mesh (``parallel/mesh|sharded|bucket|seqpar``)
against cfrk_tpu's, and the drivers and CLI flags that run on it.

The JAX package runs on its 8 virtual host devices (tests/conftest.py);
the port on meshes of the CPU device repeated (8, and 2 or 4 where a
test says so), where every device-local step runs the plain twins of the
kernels.  Inputs come from ``numpy.random.default_rng`` with a fixed
seed.  Every output is an integer array or bytes: the tolerance is exact
equality, bucket overflow flags and ``slack_used`` included.  CLI tests
patch the port's ``local_devices`` to 8 CPU devices, so that
``--device cpu`` builds the meshes the JAX CLI builds over its 8.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfrk_tpu import parallel as jpar
from cfrk_tpu.cli import main as jax_main
from cfrk_tpu.parallel import bucket as jbucket
from cfrk_tpu.parallel import seqpar as jseqpar
from cfrk_tpu.parallel import sharded as jsharded
from cfrk_tpu_torch import parallel as tpar
from cfrk_tpu_torch.cli import main
from cfrk_tpu_torch.io.fasta import decode_codes
from cfrk_tpu_torch.ops.sparse import INVALID_SENTINEL
from cfrk_tpu_torch.parallel import bucket as tbucket
from cfrk_tpu_torch.parallel import mesh as tmesh
from cfrk_tpu_torch.parallel import seqpar as tseqpar
from cfrk_tpu_torch.parallel import sharded as tsharded
from cfrk_tpu_torch.runtime import faults

N_DEV = 8
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _empty_cwd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    yield
    faults.disarm()


def _jdevs(n=N_DEV):
    devs = jax.devices()
    assert len(devs) >= n
    return devs[:n]


def _meshes(n=N_DEV, tp=1):
    return jpar.make_mesh(_jdevs(n), tp=tp), tpar.make_mesh([CPU] * n, tp=tp)


def _seq_meshes(n=N_DEV):
    return jpar.make_seq_mesh(_jdevs(n)), tpar.make_seq_mesh([CPU] * n)


def _batch(seed, b, length, p_invalid=0.03):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, length)).astype(np.int8)
    codes[rng.random(codes.shape) < p_invalid] = -1
    return codes


def _equal(jax_out, torch_out):
    """A JAX array against a port tensor: the same shape and values
    (uint32 key words against the port's int64 or int32 bit views)."""
    want = np.asarray(jax_out)
    got = torch_out.cpu().numpy()
    if want.dtype == np.uint32 and got.dtype == np.int32:
        got = got.view(np.uint32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


def _write_fasta(path: Path, codes) -> str:
    path.write_bytes(b"".join(b">r%d\n" % i + decode_codes(np.asarray(r)) + b"\n"
                              for i, r in enumerate(codes)))
    return str(path)


# ---------------------------------------------------------------- mesh


def test_make_mesh_and_shardings_match_jax():
    """The (dp, tp) layout, the axis names and sizes, the refusal, and
    the blocks ``shard_batch`` deals (block i * tp + j on devices[i, j])
    and ``table_sharding`` keeps (bin block j on tp column j)."""
    jm, tm = _meshes(8, tp=2)
    assert tm.axis_names == jm.axis_names == ("dp", "tp")
    assert tm.shape == dict(jm.shape) and tm.size == jm.size == 8
    assert tpar.DP_AXIS == jpar.DP_AXIS and tpar.TP_AXIS == jpar.TP_AXIS
    assert tpar.SP_AXIS == jpar.SP_AXIS
    for make in (jpar.make_mesh, tpar.make_mesh):
        with pytest.raises(ValueError, match="^6 devices not divisible by tp=4$"):
            make((_jdevs(6) if make is jpar.make_mesh else [CPU] * 6), tp=4)
    codes = _batch(0, 16, 12)
    blocks = tpar.shard_batch(codes, tm)
    assert [b.tolist() for b in blocks] == [codes[2 * i : 2 * i + 2].tolist()
                                            for i in range(8)]
    assert tpar.table_sharding(tm).block_of() == [0, 1] * 4
    assert tpar.batch_sharding(tm).block_of() == list(range(8))
    with pytest.raises(ValueError, match="not divisible"):
        tpar.shard_batch(codes[:12], tpar.make_mesh([CPU] * 8))


def test_collectives_match_their_definitions():
    """psum / pmax over an axis, psum_scatter, all_to_all and the ring
    ppermute on a (2, 4) mesh, against numpy over the per-device values."""
    m = tpar.make_mesh([CPU] * 8, tp=4)
    vals = [torch.arange(8, dtype=torch.int32) * (i + 1) for i in range(8)]
    grid = np.stack([v.numpy() for v in vals]).reshape(2, 4, 8)
    got = tmesh.psum(vals, m, "dp")
    for i in range(2):
        for j in range(4):
            np.testing.assert_array_equal(got[i * 4 + j], grid[:, j].sum(0))
    got = tmesh.psum_scatter(vals, m, "tp")
    for i in range(2):
        for j in range(4):
            np.testing.assert_array_equal(got[i * 4 + j], grid[i].sum(0)[2 * j : 2 * j + 2])
    got = tmesh.pmax([-v for v in vals], m, ("dp", "tp"))
    assert all((g.numpy() == -grid[0, 0]).all() for g in got)
    got = tmesh.all_to_all(vals, m, "tp")
    for i in range(2):
        for j in range(4):
            want = np.concatenate([grid[i, s][2 * j : 2 * j + 2] for s in range(4)])
            np.testing.assert_array_equal(got[i * 4 + j], want)
    sm = tpar.make_seq_mesh([CPU] * 4)
    got = tmesh.ppermute(vals[:4], sm, "sp", [(j, (j - 1) % 4) for j in range(4)])
    assert [g.tolist() for g in got] == [vals[(j + 1) % 4].tolist() for j in range(4)]
    got = tmesh.ppermute(vals[:4], sm, "sp", [(0, 1)])
    assert got[1].tolist() == vals[0].tolist() and not got[0].any()


# ---------------------------------------------------------------- sharded


@pytest.mark.parametrize("k,tp", [(2, 1), (5, 2), (8, 1), (5, 1), (2, 2), (8, 2)])
def test_perread_sharded_matches_jax(k, tp):
    jm, tm = _meshes(tp=tp)
    codes = _batch(k, 2 * N_DEV, 96)
    want = jpar.count_perread_sharded(jpar.shard_batch(jnp.asarray(codes), jm), k, jm)
    _equal(want, tpar.count_perread_sharded(tpar.shard_batch(codes, tm), k, tm))
    _equal(want, tpar.count_perread_sharded(codes, k, tpar.make_mesh([CPU] * 2)))


@pytest.mark.parametrize("k,tp", [(2, 1), (5, 2), (8, 1), (5, 8), (4, 2), (8, 4)])
def test_spectrum_sharded_matches_jax(k, tp):
    """psum over dp, psum_scatter over tp, the bins put together in bin
    order; the same table on a mesh of 4."""
    jm, tm = _meshes(tp=tp)
    codes = _batch(10 + k, 2 * N_DEV, 96)
    want = jpar.spectrum_sharded(jpar.shard_batch(jnp.asarray(codes), jm), k, jm)
    _equal(want, tpar.spectrum_sharded(codes, k, tm))
    _equal(want, tpar.spectrum_sharded(codes, k, tpar.make_mesh([CPU] * 4, tp=min(tp, 4))))


def test_spectrum_sharded_refuses_tp_not_dividing_the_bins():
    jm, tm = _meshes(tp=8)
    codes = _batch(1, 16, 40)
    for fn, mesh, arr in ((jpar.spectrum_sharded, jm, jnp.asarray(codes)),
                          (tpar.spectrum_sharded, tm, codes)):
        with pytest.raises(ValueError, match=r"^4\*\*1 bins not divisible by tp=8$"):
            fn(arr, 1, mesh)


@pytest.mark.parametrize("k,canonical", [(12, False), (12, True), (31, False), (31, True)])
def test_perread_sparse_sharded_matches_jax(k, canonical):
    """Row-sharded sparse per-read rows: the same arrays as cfrk_tpu's."""
    jm, tm = _meshes()
    codes = _batch(20 + k, 2 * N_DEV, 64)
    want = jpar.count_perread_sparse_sharded(jnp.asarray(codes), k, jm, canonical=canonical)
    got = tpar.count_perread_sparse_sharded(codes, k, tm, canonical=canonical)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        _equal(w, g)


def test_sharded_impl_host_reroutes_to_scatter():
    codes = _batch(2, 16, 40, p_invalid=0)
    jm, tm = _meshes()
    want = jsharded.count_perread_sharded(codes, 4, jm, impl="host")
    _equal(want, tsharded.count_perread_sharded(codes, 4, tm, impl="host"))


def test_sharded_packed_parity_and_refusal():
    """The packed emit per device ("b4"), unpacked on the host, against
    cfrk_tpu's; a device's rows not a multiple of the read block are
    refused in its words."""
    from cfrk_tpu.ops.pallas.perread import unpack_counts as junpack
    from cfrk_tpu_torch.ops.cuda.perread import resolve_packed, unpack_counts

    codes = _batch(3, 128, 64, p_invalid=0.05)
    jm, tm = _meshes()
    pk = resolve_packed(True, 64 - 5 + 1)
    want = junpack(np.asarray(jsharded.count_perread_sharded_packed(
        codes, 5, jm, packed=pk, read_block=16)), 128, mode=pk)
    got = unpack_counts(tsharded.count_perread_sharded_packed(
        codes, 5, tm, packed=pk, read_block=16).numpy(), 128, mode=pk)
    np.testing.assert_array_equal(got, want)
    for fn, mesh in ((jsharded.count_perread_sharded_packed, jm),
                     (tsharded.count_perread_sharded_packed, tm)):
        with pytest.raises(ValueError, match="^packed sharded rows/device must be a "
                                             "multiple of read_block=16: got 72 rows"):
            fn(codes[:72], 5, mesh, packed=pk, read_block=16)


def test_count_reads_packed_mesh_branch(monkeypatch):
    """count_reads' packed branch on a mesh (on CUDA by ``packed_auto``)
    gives cfrk_tpu's counts, as does the plain mesh branch."""
    import cfrk_tpu.ops.pallas.perread as jpp
    from cfrk_tpu.pipeline.count import count_reads as jcount_reads
    from cfrk_tpu_torch.pipeline import count as tcount

    rng = np.random.default_rng(4)
    reads = [rng.integers(0, 4, size=int(rng.integers(20, 60))).astype(np.int8)
             for _ in range(128)]
    monkeypatch.setattr(jpp, "packed_auto", lambda impl, k, w: 5 <= k <= 8 and w < 2**15)
    want = jcount_reads(reads, 5, mesh=_meshes()[0])
    calls = []

    def packed(impl, k, w, device):
        calls.append(w)
        return 5 <= k <= 8 and w < 2**15

    monkeypatch.setattr(tcount, "packed_auto", packed)
    np.testing.assert_array_equal(tcount.count_reads(reads, 5, mesh=_meshes()[1]), want)
    assert calls
    monkeypatch.setattr(tcount, "packed_auto", lambda impl, k, w, device: False)
    np.testing.assert_array_equal(
        tcount.count_reads(reads, 5, mesh=tpar.make_mesh([CPU] * 4, tp=2)), want)


# ---------------------------------------------------------------- seqpar


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_seqpar_matches_jax(k):
    """Position-sharded counting with the halo: windows across a slice
    boundary are counted once; the same on a mesh of 2."""
    jm, tm = _seq_meshes()
    codes = _batch(30 + k, 4, 16 * N_DEV)
    want = jpar.count_perread_seqpar(jnp.asarray(codes), k, jm)
    _equal(want, tpar.count_perread_seqpar(codes, k, tm))
    _equal(want, tpar.count_perread_seqpar(codes, k, tpar.make_seq_mesh([CPU] * 2)))
    _equal(jpar.spectrum_seqpar(jnp.asarray(codes), k, jm),
           tpar.spectrum_seqpar(codes, k, tm))


def test_seqpar_canonical():
    jm, tm = _seq_meshes()
    codes = _batch(5, 2, 8 * N_DEV)
    _equal(jpar.count_perread_seqpar(jnp.asarray(codes), 3, jm, canonical=True),
           tpar.count_perread_seqpar(codes, 3, tm, canonical=True))
    _equal(jpar.spectrum_seqpar(jnp.asarray(codes), 5, jm, canonical=True),
           tpar.spectrum_seqpar(codes, 5, tm, canonical=True))


def test_seqpar_rejects_narrow_slices():
    """A slice narrower than k-1 would undercount, and a position axis
    not divisible by sp has no slices: both refused in the JAX words."""
    jm, tm = _seq_meshes()
    codes = _batch(6, 2, 32, p_invalid=0)
    for fn, mesh in ((jpar.count_perread_seqpar, jm), (tpar.count_perread_seqpar, tm)):
        with pytest.raises(ValueError, match=r"^per-device slice 4 < k-1=7: windows "
                                             r"would span >2 slices"):
            fn(codes, 8, mesh)
        with pytest.raises(ValueError, match="^position axis 36 not divisible by sp=8$"):
            fn(np.pad(codes, ((0, 0), (0, 4)), constant_values=-1), 3, mesh)


def test_seqpar_sorted_spectrum_triples():
    """Per-slice sort + RLE rows: the arrays of cfrk_tpu, and folded,
    the same spectrum."""
    from cfrk_tpu.ops.sparse import SparseAccumulator as JAcc
    from cfrk_tpu.ops.sparse import rows_to_triples as jrows
    from cfrk_tpu_torch.ops.perread_sparse import rows_to_triples
    from cfrk_tpu_torch.ops.sparse import SparseAccumulator

    jm, tm = _seq_meshes()
    for k in (3, 12, 17):
        codes = _batch(40 + k, 6, 128)
        want = jseqpar.spectrum_seqpar_triples(jnp.asarray(codes), k, jm)
        got = tseqpar.spectrum_seqpar_triples(codes, k, tm)
        for w, g in zip(want, got):
            _equal(w, g)
        acc, jacc = SparseAccumulator(), JAcc()
        acc.add(*rows_to_triples(got, k))
        jacc.add(*jrows(want, k))
        for a, b in zip(acc.result_arrays(), jacc.result_arrays()):
            np.testing.assert_array_equal(a, b)


def test_seqpar_sorted_spectrum_file(tmp_path):
    from cfrk_tpu.pipeline.count import spectrum_file as jspectrum_file
    from cfrk_tpu_torch.pipeline.count import spectrum_file

    fa = _write_fasta(tmp_path / "sp.fasta", _batch(7, 5, 96))
    want = jspectrum_file(fa, 12, impl="sort", mesh=_seq_meshes()[0], seqpar=True,
                          max_len=128)
    got = spectrum_file(fa, 12, impl="sort", mesh=_seq_meshes()[1], seqpar=True,
                        max_len=128)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def test_seqpar_sparse_spectrum_file(tmp_path):
    from cfrk_tpu.pipeline.count import sparse_spectrum_file as jsparse
    from cfrk_tpu_torch.pipeline.count import sparse_spectrum_file

    fa = _write_fasta(tmp_path / "sp31.fasta", _batch(8, 3, 256, p_invalid=0.01))
    want = jsparse(fa, 19, mesh=_seq_meshes()[0], seqpar=True, max_len=256)
    got = sparse_spectrum_file(fa, 19, mesh=_seq_meshes()[1], seqpar=True, max_len=256)
    assert got == want and got


# ---------------------------------------------------------------- bucket


@pytest.mark.parametrize("n_dev", [1, 2, 6, 8])
@pytest.mark.parametrize("k", [1, 8, 15, 16, 17, 31])
def test_bucket_of_matches_jax(k, n_dev):
    """Owner devices of random words, sentinel words included: the JAX
    function's uint32 shifts, int32 cast and clamp."""
    rng = np.random.default_rng(k * 10 + n_dev)
    hi = rng.integers(0, 2**32, size=4000, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, size=4000, dtype=np.uint64).astype(np.uint32)
    hi[: 4 ** 3] &= np.uint32(4 ** max(k - 15, 0) - 1) if k > 15 else np.uint32(0)
    lo[: 4 ** 3] &= np.uint32(4 ** min(k, 15) - 1)
    hi[-7:] = INVALID_SENTINEL
    lo[-3:] = INVALID_SENTINEL
    want = np.asarray(jbucket._bucket_of(jnp.asarray(hi), jnp.asarray(lo), k, n_dev))
    got = tbucket._bucket_of(torch.from_numpy(hi.astype(np.int64)),
                             torch.from_numpy(lo.astype(np.int64)), k, n_dev)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("k,canonical", [(12, False), (16, False), (21, True), (31, True)])
def test_sparse_spectrum_sharded_matches_jax(k, canonical, n_dev):
    """Every output array, overflow flags included, equals cfrk_tpu's;
    after the ``counts > 0`` mask each device's keys lie in its own
    range (bucket d on device d) and together are sorted and unique."""
    jm, tm = _seq_meshes(n_dev)
    codes = _batch(50 + k + n_dev, 16, 64)
    want = jbucket.sparse_spectrum_sharded(jnp.asarray(codes), k, jm, canonical=canonical)
    got = tbucket.sparse_spectrum_sharded(codes, k, tm, canonical=canonical)
    for w, g in zip(want, got):
        _equal(w, g)
    hi, lo, counts, over = (t.numpy() for t in got)
    assert not over.any()
    per_dev = counts.size // n_dev
    keys = []
    for d in range(n_dev):
        sl = slice(d * per_dev, (d + 1) * per_dev)
        m = counts[sl] > 0
        owner = tbucket._bucket_of(torch.from_numpy(hi[sl][m]), torch.from_numpy(lo[sl][m]),
                                   k, n_dev)
        assert (owner.numpy() == d).all()
        keys += ((hi[sl][m].astype(np.uint64) << np.uint64(30))
                 | lo[sl][m].astype(np.uint64)).tolist()
    assert keys == sorted(set(keys)) and keys


def test_sparse_spectrum_sharded_flattens_a_two_axis_mesh():
    """A (dp, tp) mesh routes over all its devices, as cfrk_tpu's."""
    jm, tm = _meshes(4, tp=2)
    assert tbucket._flat_mesh(tm).shape == {"dp": 4}
    codes = _batch(9, 8, 48)
    want = jbucket.sparse_spectrum_sharded(jnp.asarray(codes), 19, jm)
    for w, g in zip(want, tbucket.sparse_spectrum_sharded(codes, 19, tm)):
        _equal(w, g)


def test_sparse_spectrum_overflow_and_retry_slack_used():
    """A poly-A-heavy batch overflows its boxes at a small slack: the
    flags, then the retry's doubled ``slack_used`` and its arrays, equal
    cfrk_tpu's, and the retried counts hold every window."""
    codes = _batch(11, 16, 64, p_invalid=0)
    codes[:12] = 0  # 12 of 16 reads are poly-A: one key takes most windows
    jm, tm = _seq_meshes()
    want = jbucket.sparse_spectrum_sharded(jnp.asarray(codes), 21, jm, slack=0.5)
    got = tbucket.sparse_spectrum_sharded(codes, 21, tm, slack=0.5)
    for w, g in zip(want, got):
        _equal(w, g)
    assert got[3].any()
    want = jbucket.sparse_spectrum_sharded_retry(jnp.asarray(codes), 21, jm, slack=0.5)
    got = tbucket.sparse_spectrum_sharded_retry(codes, 21, tm, slack=0.5)
    assert got[3] == want[3] > 0.5
    for w, g in zip(want[:3], got[:3]):
        _equal(w, g)
    assert int(got[2].sum()) == 16 * (64 - 21 + 1)


def test_k31_key_of_sixteen_t_bases_on_a_mesh():
    """At k = 31 a k-mer whose first 16 bases are T has hi equal to the
    sentinel: it is judged valid on lo, routed to the last device and
    counted, as in cfrk_tpu."""
    codes = _batch(12, 8, 64, p_invalid=0)
    codes[:3, :40] = 3
    codes[3, 10:26] = 3
    jm, tm = _seq_meshes(4)
    want = jbucket.sparse_spectrum_sharded(jnp.asarray(codes), 31, jm)
    got = tbucket.sparse_spectrum_sharded(codes, 31, tm)
    for w, g in zip(want, got):
        _equal(w, g)
    hi, lo, counts = (t.numpy() for t in got[:3])
    hits = (hi == INVALID_SENTINEL) & (counts > 0)
    assert hits.any()
    assert (np.flatnonzero(hits) >= 3 * counts.size // 4).all()


# ---------------------------------------------------------------- drivers


def _reads_fasta(tmp_path, n, lo=20, hi=60, seed=0, name="r.fasta") -> str:
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        codes = rng.integers(0, 4, size=int(rng.integers(lo, hi))).astype(np.int8)
        codes[rng.random(codes.size) < 0.02] = -1
        recs.append(b">r%d\n" % i + decode_codes(codes) + b"\n")
    path = tmp_path / name
    path.write_bytes(b"".join(recs))
    return str(path)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_count_file_sparse_rows_on_mesh_matches_jax(tmp_path, n_dev):
    from cfrk_tpu.pipeline.count import count_file_sparse_rows as jrows
    from cfrk_tpu_torch.pipeline.count import count_file_sparse_rows

    fa = _reads_fasta(tmp_path, N_DEV + 5, 24, 48)
    jm, tm = _meshes(n_dev)
    assert jrows(fa, str(tmp_path / "j.cfrk"), 13, mesh=jm) == N_DEV + 5
    assert count_file_sparse_rows(fa, str(tmp_path / "t.cfrk"), 13, mesh=tm) == N_DEV + 5
    got = (tmp_path / "t.cfrk").read_bytes()
    assert got == (tmp_path / "j.cfrk").read_bytes() and got


def test_stream_sparse_rows_on_mesh_matches_jax(tmp_path):
    """k > 8 --nonzero streaming on a mesh, a short tail batch included."""
    from cfrk_tpu.pipeline.stream import stream_count_file as jstream
    from cfrk_tpu_torch.pipeline.stream import stream_count_file

    fa = _reads_fasta(tmp_path, 2 * N_DEV + 3, 20, 60)
    jm, tm = _meshes()
    jstream(fa, str(tmp_path / "j.cfrk"), 12, nonzero=True, batch_size=N_DEV, mesh=jm)
    stream_count_file(fa, str(tmp_path / "t.cfrk"), 12, nonzero=True,
                      batch_size=N_DEV, mesh=tm)
    got = (tmp_path / "t.cfrk").read_bytes()
    assert got == (tmp_path / "j.cfrk").read_bytes() and got


@pytest.mark.parametrize("flags", [dict(k=4), dict(k=5, packed=True, batch_size=128),
                                   dict(k=3, impl="scatter", seqpar=True)],
                         ids=["dense_pairs", "packed", "seqpar"])
def test_stream_count_file_on_mesh_matches_jax(tmp_path, flags):
    """The dense per-read streaming routes on a mesh: the pairs route,
    the packed emit per device and the position-sharded counts."""
    from cfrk_tpu.pipeline.stream import stream_count_file as jstream
    from cfrk_tpu_torch.pipeline.stream import stream_count_file

    fa = _reads_fasta(tmp_path, 150)
    kw = dict(flags)
    k = kw.pop("k")
    kw.setdefault("batch_size", 16)
    jm, tm = _seq_meshes() if kw.get("seqpar") else _meshes()
    jstream(fa, str(tmp_path / "j.cfrk"), k, mesh=jm, **kw)
    stream_count_file(fa, str(tmp_path / "t.cfrk"), k, mesh=tm, **kw)
    got = (tmp_path / "t.cfrk").read_bytes()
    assert got == (tmp_path / "j.cfrk").read_bytes() and got


@pytest.mark.parametrize("k,impl,tp", [(4, "auto", 2), (6, "sort", 1), (12, "sort", 2)])
def test_stream_spectrum_on_mesh_matches_jax(tmp_path, k, impl, tp):
    """The dense spectrum streamed on a (dp, tp) mesh, and its sorted
    route through the bucket exchange."""
    from cfrk_tpu.pipeline.stream import stream_spectrum_file as jstream
    from cfrk_tpu_torch.pipeline.stream import stream_spectrum_file

    fa = _reads_fasta(tmp_path, 100)
    jm, tm = _meshes(tp=tp)
    want, _ = jstream(fa, k, impl=impl, batch_size=16, mesh=jm)
    got, m = stream_spectrum_file(fa, k, impl=impl, batch_size=16, mesh=tm)
    np.testing.assert_array_equal(got, want)
    assert m.reads == 100 and got.sum() > 0


def test_stream_sparse_on_mesh_killed_and_resumed(tmp_path):
    """The sparse streaming driver on a mesh, slack carried from batch to
    batch, killed at its second checkpoint and resumed: the keys and
    counts of cfrk_tpu's run."""
    from cfrk_tpu.pipeline.stream import stream_sparse_spectrum_file as jstream
    from cfrk_tpu_torch.pipeline.stream import stream_sparse_spectrum_file

    fa = _reads_fasta(tmp_path, 120, 30, 90)
    jm, tm = _meshes()
    wk, wc, _ = jstream(fa, 21, canonical=True, batch_size=16, mesh=jm, slack=0.5)
    out = str(tmp_path / "t.kmers")
    faults.arm("checkpoint", 2)
    with pytest.raises(faults.InjectedFault):
        stream_sparse_spectrum_file(fa, 21, canonical=True, batch_size=16, mesh=tm,
                                    slack=0.5, out_path=out, checkpoint_every=2)
    faults.disarm()
    keys, counts, m = stream_sparse_spectrum_file(
        fa, 21, canonical=True, batch_size=16, mesh=tm, slack=0.5, out_path=out,
        checkpoint_every=2, resume=True)
    np.testing.assert_array_equal(keys, wk)
    np.testing.assert_array_equal(counts, wc)
    assert 0 < m.reads < 120 and m.total_reads == 120


def test_stream_mesh_refusals_match_jax():
    """A batch size the mesh does not divide, packed rows a device that
    are not whole read blocks, packed or sparse rows under seqpar: the
    JAX package's refusals."""
    from cfrk_tpu.pipeline.stream import stream_count_file as jstream
    from cfrk_tpu_torch.pipeline.stream import stream_count_file

    jm, tm = _meshes()
    jsm, tsm = _seq_meshes()
    cases = [
        (4, dict(batch_size=9), "m", "^batch_size 9 not divisible by mesh size 8$"),
        (4, dict(batch_size=64, packed=True), "m",
         r"^packed mesh runs need batch_size/device divisible by the read block"),
        (4, dict(packed=True, seqpar=True), "s",
         "^packed mode does not compose with --seqpar$"),
        (12, dict(seqpar=True, nonzero=True), "s",
         "^sparse per-read rows do not compose with seqpar"),
    ]
    for k, kw, which, message in cases:
        for fn, mesh in ((jstream, jm if which == "m" else jsm),
                         (stream_count_file, tm if which == "m" else tsm)):
            with pytest.raises(ValueError, match=message):
                fn("x.fasta", "y.cfrk", k, mesh=mesh, **kw)


def test_sparse_spectrum_arrays_on_mesh_matches_jax(tmp_path):
    """The in-memory sparse spectrum through the bucket exchange at a
    slack that overflows, on meshes of 2 and 8."""
    from cfrk_tpu.pipeline.count import sparse_spectrum_file as jsparse
    from cfrk_tpu_torch.pipeline.count import sparse_spectrum_file

    rng = np.random.default_rng(13)
    codes = rng.integers(0, 4, size=(40, 70)).astype(np.int8)
    codes[:20] = 1  # low complexity: one key takes half the windows
    fa = _write_fasta(tmp_path / "lc.fasta", codes)
    for n in (2, 8):
        jm, tm = _meshes(n)
        want = jsparse(fa, 31, canonical=True, mesh=jm, slack=0.5, batch_size=16)
        got = sparse_spectrum_file(fa, 31, canonical=True, mesh=tm, slack=0.5,
                                   batch_size=16)
        assert got == want and got


# ---------------------------------------------------------------- CLI


@pytest.fixture
def eight_cpus(monkeypatch):
    monkeypatch.setattr(tmesh, "local_devices", lambda device: [CPU] * 8)


def _cli_both(tmp_path, inp, flags, capsys=None):
    """Output bytes (and stderr lines starting with '#') of the port on
    ``--device cpu`` over 8 CPU devices and of cfrk_tpu's CLI."""
    res = []
    for name, cli_main, extra in (("t", main, ["--device", "cpu"]), ("j", jax_main, [])):
        out = tmp_path / f"{name}.out"
        assert cli_main([inp, "-o", str(out), *flags, *extra]) == 0
        err = capsys.readouterr().err if capsys else ""
        res.append((out.read_bytes(), [ln for ln in err.splitlines() if ln.startswith("#")]))
    return res


@pytest.mark.parametrize(
    "flags",
    [["-k", "8", "--nonzero", "--devices", "8"],
     ["-k", "5", "--devices", "4", "--tp", "2", "--impl", "scatter"],
     ["-k", "4", "--impl", "scatter", "--seqpar"],
     ["-k", "4", "--impl", "compare", "--devices", "1", "--seqpar"],
     ["-k", "31", "--canonical", "--mode", "sparse", "--devices", "8", "--slack", "0.5"],
     ["-k", "12", "--mode", "spectrum", "--tp", "2", "--impl", "sort",
      "--spectrum-format", "tsv"],
     ["-k", "6", "--mode", "spectrum", "--tp", "4", "--spectrum-format", "hist"],
     ["-k", "19", "--mode", "sparse", "--seqpar"]],
    ids=["devices8", "tp2_of_4", "seqpar", "seqpar_one_device", "sparse_slack",
         "spectrum_sort_tp2", "spectrum_tp4_hist", "sparse_seqpar"],
)
def test_cli_mesh_flags_match_jax_cli(tmp_path, eight_cpus, flags):
    fa = _reads_fasta(tmp_path, 60, 20, 200)
    (got, _), (want, _) = _cli_both(tmp_path, fa, flags)
    assert got == want and got


def test_cli_batch_size_rounding_line_matches_jax_cli(tmp_path, eight_cpus, capsys):
    fa = _reads_fasta(tmp_path, 30)
    (got, glines), (want, wlines) = _cli_both(
        tmp_path, fa, ["-k", "6", "--nonzero", "--devices", "4", "--batch-size", "10"],
        capsys)
    assert got == want and got
    assert glines == wlines == ["# batch size 10 -> 12 (multiple of the 4-device mesh)"]


def test_cli_stream_killed_and_resumed_on_mesh(tmp_path, eight_cpus):
    """``--stream`` on the default mesh killed at its third checkpoint
    (the site ``CFRK_FAULT_INJECT=checkpoint:3`` arms) and resumed with
    ``--resume``: cfrk_tpu's bytes, no checkpoint left."""
    fa = _reads_fasta(tmp_path, 90)
    out = tmp_path / "t.cfrk"
    argv = [fa, str(out), "6", "--nonzero", "--stream", "--batch-size", "16",
            "--device", "cpu"]
    faults.arm("checkpoint", 3)
    with pytest.raises(faults.InjectedFault):
        main(argv)
    assert (tmp_path / "t.cfrk.ckpt.json").exists()
    assert main([*argv, "--resume"]) == 0
    assert jax_main([fa, str(tmp_path / "j.cfrk"), "6", "--nonzero"]) == 0
    assert out.read_bytes() == (tmp_path / "j.cfrk").read_bytes()
    assert not (tmp_path / "t.cfrk.ckpt.json").exists()


def test_cli_multi_file_on_mesh_forces_one_task(tmp_path, eight_cpus, capsys):
    """Several inputs on a mesh: the JAX CLI's line, one task at a
    time, each output cfrk_tpu's bytes."""
    shards = [_reads_fasta(tmp_path, 20 + 7 * i, seed=i, name=f"s{i}.fasta")
              for i in range(3)]
    lines = []
    for name, cli_main, extra in (("t", main, ["--device", "cpu"]), ("j", jax_main, [])):
        assert cli_main([*shards, "-k", "5", "--mode", "spectrum", "--out-dir", name,
                         "--max-parallel-tasks", "3", *extra]) == 0
        lines.append([ln for ln in capsys.readouterr().err.splitlines()
                      if ln.startswith("#")])
    assert lines[0] == lines[1] == [
        "# mesh run: --max-parallel-tasks forced to 1 (concurrent collective programs "
        "on shared devices can deadlock)"]
    for i in range(3):
        got = (tmp_path / "t" / f"s{i}.spectrum").read_bytes()
        assert got == (tmp_path / "j" / f"s{i}.spectrum").read_bytes() and got


def test_cli_default_is_every_local_device(tmp_path, monkeypatch):
    """No ``--devices``: a mesh over every device ``local_devices`` gives
    (two here), none over one; ``--device cpu`` alone is one device."""
    from cfrk_tpu_torch import cli as tcli

    seen = []
    real = tcli._build_mesh

    def spy(args, device):
        mesh = real(args, device)
        seen.append(None if mesh is None else mesh.size)
        return mesh

    monkeypatch.setattr(tcli, "_build_mesh", spy)
    fa = _reads_fasta(tmp_path, 10)
    assert main([fa, "-o", "a.cfrk", "-k", "3", "--device", "cpu"]) == 0
    monkeypatch.setattr(tmesh, "local_devices", lambda device: [CPU] * 2)
    assert main([fa, "-o", "b.cfrk", "-k", "3", "--device", "cpu"]) == 0
    assert seen == [None, 2]
    assert Path("a.cfrk").read_bytes() == Path("b.cfrk").read_bytes()
