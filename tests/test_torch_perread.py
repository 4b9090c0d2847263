"""The dense per-read API of cfrk_tpu_torch against cfrk_tpu.

The kernel's plain twin (``perread_hist_plain``, which is what
``perread_hist`` runs on a CPU tensor) is held against the JAX
package's Pallas kernel ``count_perread_pallas`` in interpret mode (as
tests/test_pallas.py runs it): raw packed arrays with their pad rows,
unpacked counts and checksums.  ``count_perread`` is held against
``cfrk_tpu.count_perread`` for every impl, ``count_reads`` /
``count_file`` against the JAX drivers and the goldens, and the rowsort
probe's plain checksums against the production rows and a scalar loop.
Tolerance: exact equality -- every output is an integer array or bytes.
"""

import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfrk_tpu.ops.pallas.perread import count_perread_pallas
from cfrk_tpu.ops.pallas.perread import resolve_packed as jax_resolve_packed
from cfrk_tpu.ops.pallas.perread import unpack_counts as jax_unpack_counts
from cfrk_tpu.ops.perread import count_perread as jax_count_perread
from cfrk_tpu.ops.perread_sparse import count_perread_sparse as jax_rows
from cfrk_tpu.pipeline import count as jcount
from cfrk_tpu_torch.format import CfrkWriter
from cfrk_tpu_torch.ops import perread as tperread
from cfrk_tpu_torch.ops.cuda import perread as P
from cfrk_tpu_torch.ops.cuda import rowsort as R
from cfrk_tpu_torch.ops.perread import count_perread
from cfrk_tpu_torch.pipeline import count as tcount
from cfrk_tpu_torch.tools.card import launches

ROOT = Path(__file__).resolve().parent.parent
DATA = Path(__file__).parent / "data"
MANIFEST = json.loads((DATA / "goldens.json").read_text())


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


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- the kernel's twin


@pytest.mark.parametrize("k", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("canonical", [False, True])
def test_twin_unpacked_and_checksum_match_pallas(k, canonical):
    codes = _batch(k, 13, 171)
    got, chk = P.perread_hist(torch.from_numpy(codes), k, canonical, checksum=True)
    want, wchk = count_perread_pallas(jnp.asarray(codes), k, canonical=canonical,
                                      checksum=True)
    _assert_same(got, want)
    _assert_same(chk, wchk)
    assert got.shape == (13, 4**k)


@pytest.mark.parametrize("packed", ["fh", "b4", True])
@pytest.mark.parametrize("b,read_block", [(13, 4), (20, 16)])
@pytest.mark.parametrize("k", [2, 5, 8])
def test_twin_packed_raw_arrays_match_pallas(packed, b, read_block, k):
    """The raw packed arrays, pad rows included, and the checksums over
    the unpacked counts."""
    codes = _batch(100 + k, b, 171)
    canonical = k == 5
    kw = dict(packed=packed, read_block=read_block, checksum=True)
    got, chk = P.perread_hist_plain(torch.from_numpy(codes), k, canonical, **kw)
    want, wchk = count_perread_pallas(jnp.asarray(codes), k, canonical=canonical, **kw)
    _assert_same(got, want)
    _assert_same(chk, wchk)
    assert got.shape[0] == -(-b // min(read_block, b)) * min(read_block, b)
    if got.shape[0] > b:
        assert not got[b:].any()


def test_twin_long_row_matches_pallas():
    """A 1500-column row: no packing below "fh"'s bound but "b4"'s."""
    codes = _batch(3, 3, 1500)
    for packed in (False, "fh", True):
        got = P.perread_hist_plain(torch.from_numpy(codes), 5, packed=packed)
        _assert_same(got, count_perread_pallas(jnp.asarray(codes), 5, packed=packed))
    with pytest.raises(ValueError, match="b4-packed counts unsafe"):
        P.perread_hist_plain(torch.from_numpy(codes), 5, packed="b4")


@pytest.mark.parametrize("k", [3, 6])
@pytest.mark.parametrize("canonical", [False, True])
def test_twin_edge_rows_match_pallas(k, canonical):
    codes = _edge_batch()
    for packed in (False, "b4"):
        got = P.perread_hist(torch.from_numpy(codes), k, canonical, packed=packed)
        _assert_same(got, count_perread_pallas(jnp.asarray(codes), k,
                                               canonical=canonical, packed=packed))


def test_wrapper_errors_match_jax():
    codes = torch.from_numpy(_batch(1, 4, 20))
    jcodes = jnp.asarray(codes.numpy())
    for kw, msg in (({"k": 9}, "supports k <= 8"),
                    ({"k": 30}, r"read length 20 < k=30"),
                    ({"k": 4, "packed": "x4"}, "unknown packed mode")):
        with pytest.raises(ValueError, match=msg):
            P.perread_hist(codes, **kw)
        with pytest.raises(ValueError, match=msg):
            count_perread_pallas(jcodes, **kw)
    with pytest.raises(ValueError, match=r"codes must be \[B, L\]"):
        P.perread_hist(codes[0], 4)
    with pytest.raises(ValueError, match="b4 packing needs k >= 2"):
        P.perread_hist(codes, 0, packed="b4")


@pytest.mark.parametrize("w", [1, 255, 256, 2**15 - 1, 2**15])
@pytest.mark.parametrize("packed", [True, False, None, "fh", "b4", "x"])
def test_resolve_packed_matches_jax(w, packed):
    try:
        want = jax_resolve_packed(packed, w)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            P.resolve_packed(packed, w)
    else:
        assert P.resolve_packed(packed, w) == want


@pytest.mark.parametrize("mode,k", [("fh", 1), ("fh", 5), ("b4", 2), ("b4", 8)])
def test_unpack_counts_of_jax_arrays(mode, k):
    """The port's unpack_counts, on numpy and on torch, reads the JAX
    kernel's packed arrays; the 0x7FFF / 0xFF masks come after the
    shift, so a sign-extended high half unpacks right."""
    codes = _batch(40 + k, 11, 100)
    packed = np.asarray(count_perread_pallas(jnp.asarray(codes), k, packed=mode,
                                             read_block=4))
    want = np.asarray(jax_unpack_counts(packed, 11, mode=mode))
    _assert_same(P.unpack_counts(packed, 11, mode=mode), want)
    _assert_same(P.unpack_counts(torch.from_numpy(packed.copy()), 11, mode=mode), want)
    top = np.full((1, 2, 4), -1, np.int32)  # every bit set
    got = P.unpack_counts(top, 1, mode="fh")
    _assert_same(got, np.asarray(jax_unpack_counts(top, 1, mode="fh")))
    assert set(got.ravel().tolist()) == {0x7FFF, 0xFFFF}
    with pytest.raises(ValueError, match="unknown packed mode"):
        P.unpack_counts(packed, 11, mode="b2")


def test_packed_auto_policy():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert P.packed_auto("pallas", 8, 249, cuda) and P.packed_auto("auto", 5, 2**15 - 1, cuda)
    assert not P.packed_auto("pallas", 8, 249, cpu)
    assert not P.packed_auto("pallas", 4, 249, cuda)
    assert not P.packed_auto("scatter", 8, 249, cuda)
    assert not P.packed_auto("pallas", 8, 2**15, cuda)


# ---------------------------------------------------------------- count_perread


@pytest.mark.parametrize("impl", ["compare", "scatter", "matmul", "host", "pallas", "auto"])
@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("out_dtype", [None, "int16"])
def test_count_perread_matches_jax(impl, k, out_dtype):
    codes = _batch(10 * k, 13, 171)
    canonical = impl in ("scatter", "host")
    tdt = getattr(torch, out_dtype) if out_dtype else None
    jdt = getattr(jnp, out_dtype) if out_dtype else None
    got = count_perread(torch.from_numpy(codes), k, canonical=canonical, impl=impl,
                        out_dtype=tdt)
    want = jax_count_perread(jnp.asarray(codes), k, canonical=canonical, impl=impl,
                             out_dtype=jdt)
    _assert_same(got, want)


def test_count_perread_edge_rows_every_impl():
    codes = _edge_batch()
    want = np.asarray(jax_count_perread(jnp.asarray(codes), 3, canonical=True,
                                        impl="scatter"))
    for impl in ("compare", "scatter", "matmul", "host", "pallas", "auto"):
        _assert_same(count_perread(torch.from_numpy(codes), 3, canonical=True,
                                   impl=impl), want)


def test_count_perread_errors_match_jax():
    codes = _batch(2, 3, 40)
    for kw, msg in (({"k": 9}, "supports k <= 8"),
                    ({"k": 4, "impl": "nope"}, "unknown impl")):
        with pytest.raises(ValueError, match=msg):
            count_perread(torch.from_numpy(codes), **kw)
        with pytest.raises(ValueError, match=msg):
            jax_count_perread(jnp.asarray(codes), **kw)
    with pytest.raises(ValueError, match=r"codes must be \[B, L\]"):
        count_perread(torch.from_numpy(codes)[None], 4)
    long = torch.zeros((1, 2**15 + 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="int16 counts unsafe"):
        count_perread(long, 4, out_dtype=torch.int16)


@pytest.mark.parametrize("impl,k", [("matmul", 2), ("matmul", 5), ("auto", 4)])
def test_matmul_reroutes_to_scatter_past_f32_exact(monkeypatch, impl, k):
    """At >= 2**24 windows per read matmul (and auto off CUDA past
    compare's range) take scatter, as the JAX package does; the limit
    is lowered here so the rows stay small."""
    class Called(Exception):
        pass

    def spy(*args):
        raise Called

    monkeypatch.setattr(tperread, "_F32_EXACT_WINDOWS", 64)
    monkeypatch.setattr(tperread, "_count_matmul", spy)
    monkeypatch.setattr(tperread, "_count_host", spy)
    codes = _batch(5, 3, 80)
    got = count_perread(torch.from_numpy(codes), k, impl=impl)
    _assert_same(got, jax_count_perread(jnp.asarray(codes), k, impl="scatter"))
    with pytest.raises(Called):  # below the limit the route is kept
        count_perread(torch.from_numpy(_batch(5, 3, 40)), k, impl=impl)


# ---------------------------------------------------------------- drivers


def _reads(seed, n, max_len=300):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = rng.integers(0, 4, size=int(rng.integers(1, max_len))).astype(np.int8)
        r[rng.random(r.size) < 0.02] = -1
        out.append(r)
    return out


def _fasta(tmp_path, reads, name="r.fa"):
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    path = tmp_path / name
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">r%d\n%s\n" % (i, lut[np.where(r < 0, 4, r)].tobytes()))
    return str(path)


@pytest.mark.parametrize(
    "impl,k,batch_size",
    [("auto", 5, 16), ("scatter", 6, 7), ("matmul", 4, 13), ("host", 5, 9),
     ("pallas", 3, 16), ("compare", 2, 5)],
)
@pytest.mark.parametrize("canonical", [False, True])
def test_count_reads_matches_jax(impl, k, batch_size, canonical):
    reads = _reads(k, 41) + [np.zeros(700, np.int8)]  # one long poly-A read
    got = tcount.count_reads(reads, k, device="cpu", canonical=canonical, impl=impl,
                             batch_size=batch_size)
    want = jcount.count_reads(reads, k, canonical=canonical, impl=impl,
                              batch_size=batch_size)
    _assert_same(got, want)


def test_count_file_matches_jax_and_empty_input(tmp_path):
    reads = _reads(3, 30)
    path = _fasta(tmp_path, reads)
    got = tcount.count_file(path, 4, device="cpu", impl="scatter", batch_size=8,
                            max_len=384)
    _assert_same(got, jcount.count_file(path, 4, impl="scatter", batch_size=8,
                                        max_len=384))
    empty = tmp_path / "e.fa"
    empty.write_bytes(b"")
    _assert_same(tcount.count_file(str(empty), 3, device="cpu"),
                 jcount.count_file(str(empty), 3))
    with pytest.raises(ValueError, match="supports k <= 8"):
        tcount.count_file(path, 9, device="cpu", impl="scatter")


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_goldens_through_count_reads(tmp_path, name):
    """The reference's goldens at k=2 through the dense API (the JAX
    package's tests/test_golden.py oracle)."""
    counts = tcount.count_file(str(DATA / name), MANIFEST["k"], device="cpu")
    assert counts.shape == (MANIFEST["files"][name]["n_reads"], 16)
    out = tmp_path / "g.cfrk"
    tcount.write_cfrk(str(out), counts)
    assert hashlib.sha256(out.read_bytes()).hexdigest() == MANIFEST["files"][name]["sha256"]


@pytest.mark.parametrize("nonzero", [False, True])
def test_dense_rows_file_equals_count_file_written_once(tmp_path, nonzero):
    """Batch-by-batch writing gives the bytes of the whole matrix
    written at once."""
    reads = _reads(8, 37)
    path = _fasta(tmp_path, reads)
    a, b = tmp_path / "a.cfrk", tmp_path / "b.cfrk"
    n = tcount.count_file_dense_rows(path, str(a), 5, device="cpu", impl="pallas",
                                     batch_size=6, nonzero=nonzero)
    assert n == len(reads)
    with CfrkWriter(str(b), nonzero=nonzero) as w:
        w.write_batch(tcount.count_file(path, 5, device="cpu", impl="pallas"))
    assert a.read_bytes() == b.read_bytes()


def test_dense_counts_packed_route_unpacks_like_jax():
    """The packed branch of pipeline/count.py (taken on CUDA): the kernel's packed
    rows, unpacked on the host, equal the JAX packed branch's rows."""
    codes = _batch(9, 21, 256)
    w = 256 - 8 + 1
    packing = P.resolve_packed(True, w)
    assert packing == "b4"
    dev = P.perread_hist(torch.from_numpy(codes), 8, packed=packing)
    got = tcount.dense_counts_to_host(dev, 19, packing)
    jpacked = count_perread_pallas(jnp.asarray(codes), 8, packed=packing)
    _assert_same(got, np.asarray(jax_unpack_counts(np.asarray(jpacked), 19, mode="b4")))


# ---------------------------------------------------------------- rowsort probe


def _scalar_checksum(row, n, sentinel, variant):
    """One row's probe checksum by a scalar loop over the kernel's steps
    (list ``row`` of W keys, padded to ``n`` with the sentinel)."""
    s = list(row) + [sentinel] * (n - len(row))
    if variant in ("full", "sortonly"):
        s.sort()
    w = len(row)
    if variant in ("noop", "sortonly"):
        return sum((s[i] ^ i) & 3 for i in range(w))
    total = 0
    for i in range(w):
        key = s[i]
        if key == sentinel or (i and s[i - 1] == key):
            continue
        lo, hi = i + 1, n
        while lo < hi:
            mid = (lo + hi) >> 1
            if s[mid] > key:
                hi = mid
            else:
                lo = mid + 1
        total += ((lo - i) & 3) + (key & 3)
    return total


@pytest.mark.parametrize("variant", sorted(R.PROBE_VARIANTS))
@pytest.mark.parametrize("k", [3, 8, 16, 31])
def test_probe_twin_matches_a_scalar_loop(variant, k):
    """The plain probe checksums, the rleonly binary search over
    UNSORTED keys included, against a scalar loop of the kernel's
    steps."""
    codes = _batch(k, 6, 45, p_invalid=0.1)
    codes[0] = 0  # one long run
    canonical = k > 15
    got = R.rowsort_probe(torch.from_numpy(codes), k, variant, canonical)
    if k <= 15:
        from cfrk_tpu.ops.encode import window_indices

        idx = np.asarray(window_indices(jnp.asarray(codes), k, False))
        sentinel = 4**k
        keys = np.where(idx < 0, sentinel, idx)
    else:
        from cfrk_tpu.ops.sparse import kmer_keys

        hi, lo = (np.asarray(x).astype(np.int64) for x in kmer_keys(jnp.asarray(codes),
                                                                  k, True))
        sentinel = R.KEY64_SENTINEL
        keys = np.where(lo != 0xFFFFFFFF, (hi << 30) | lo, sentinel)
    w = codes.shape[1] - k + 1
    n = 1 << (w - 1).bit_length()
    want = [_scalar_checksum([int(x) for x in row], n, sentinel, variant) for row in keys]
    assert got.dtype == torch.int64 and got.tolist() == want


@pytest.mark.parametrize("k,canonical", [(8, False), (31, True)])
def test_probe_full_checksum_is_the_production_rows(k, canonical):
    """``full`` sums (count & 3) + (key & 3) over the production
    kernel's run starts: the same sum over the JAX package's rows."""
    codes = _batch(k + 1, 9, 150)
    got = R.rowsort_probe_plain(torch.from_numpy(codes), k, "full", canonical)
    if k <= 15:
        idx, cnt = (np.asarray(x).astype(np.int64) for x in jax_rows(jnp.asarray(codes), k,
                                                                   canonical))
        key = idx
    else:
        from cfrk_tpu.ops.perread_sparse import count_perread_sparse_large

        hi, lo, cnt = (np.asarray(x).astype(np.int64) for x in
                       count_perread_sparse_large(jnp.asarray(codes), k, canonical))
        key = lo
    want = np.where(cnt > 0, (cnt & 3) + (key & 3), 0).sum(1)
    assert got.tolist() == want.tolist()


def test_probe_errors():
    codes = torch.from_numpy(_batch(1, 2, 40))
    with pytest.raises(ValueError, match="unknown probe variant"):
        R.rowsort_probe(codes, 8, "kernelsort")
    with pytest.raises(ValueError, match="exceeds the kernel ceiling"):
        R.rowsort_probe_plain(torch.zeros((1, 40_000), dtype=torch.int8), 8, "noop")
    meta = torch.zeros((2, 40), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="needs CUDA"):
        R.rowsort_probe(meta, 8, "full")
    assert launches()["rowsort_probe"] == 0


def test_probe_tool_needs_cuda():
    """``python -m cfrk_tpu_torch.tools.rowsort_probe`` exits non-zero
    without a CUDA device and prints no result."""
    proc = subprocess.run(
        [sys.executable, "-m", "cfrk_tpu_torch.tools.rowsort_probe", "--variant", "noop"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr

