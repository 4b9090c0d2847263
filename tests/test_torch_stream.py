"""The streaming drivers of cfrk_tpu_torch (``pipeline/stream.py``,
``runtime/checkpoint.py``, ``runtime/metrics.py``): the port's
counterpart of tests/test_stream.py.

The same seeded inputs go through the port (``device="cpu"``, the plain
route), its one-shot drivers and ``cfrk_tpu``'s streaming drivers (run
as the JAX package's own tests run them on the CPU).  Tolerance: exact
equality of bytes, batches, tables and checkpoint files.
"""

import dataclasses
import gzip
import hashlib
import json
import os
from pathlib import Path

import numpy as np
import pytest

from cfrk_tpu.pipeline import stream as jstream
from cfrk_tpu.runtime import faults as jfaults
from cfrk_tpu.runtime.checkpoint import StreamCheckpoint as JaxCheckpoint
from cfrk_tpu.runtime.metrics import RunMetrics as JaxRunMetrics
from cfrk_tpu_torch.format import CfrkWriter
from cfrk_tpu_torch.io.bgzf import write_bgzf
from cfrk_tpu_torch.io.fasta import iter_encoded_with_offsets
from cfrk_tpu_torch.pipeline import stream as tstream
from cfrk_tpu_torch.pipeline.count import (
    count_file_sparse_rows,
    count_reads,
    spectrum_file,
)
from cfrk_tpu_torch.pipeline.stream import (
    stream_batches,
    stream_count_file,
    stream_spectrum_file,
)
from cfrk_tpu_torch.runtime import faults
from cfrk_tpu_torch.runtime.checkpoint import (
    StreamCheckpoint,
    checkpoint_path,
    cleanup_checkpoint,
)
from cfrk_tpu_torch.runtime.metrics import RunMetrics, StageTimer

DATA = Path(__file__).parent / "data"
MANIFEST = json.loads((DATA / "goldens.json").read_text())
_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    jfaults.disarm()


def _decode(codes) -> bytes:
    codes = np.asarray(codes)
    return _LUT[np.where(codes < 0, 4, codes)].tobytes()


def _random_reads(n, seed, lo=20, hi=300, n_frac=0.02):
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi))
        r = rng.integers(0, 4, size=ln).astype(np.int8)
        r[rng.random(ln) < n_frac] = -1
        reads.append(r)
    return reads


def _write_fasta(path, reads):
    with open(path, "wb") as f:
        for i, codes in enumerate(reads):
            f.write(b">r%d\n" % i + _decode(codes) + b"\n")
    return path


def _write_fastq(path, reads, seed=0):
    """FASTQ with a mix of high and low qualities (``--min-qual 20``
    masks the ``#`` and ``5`` bases)."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for i, codes in enumerate(reads):
            qual = np.frombuffer(b"I#5I", np.uint8)[rng.integers(0, 4, len(codes))]
            f.write(b"@q%d\n" % i + _decode(codes) + b"\n+\n" + qual.tobytes() + b"\n")
    return path


def _input(tmp_path, kind, reads):
    """The reads as a plain FASTA, a FASTQ (used with min_qual=20), a
    plain-gzip FASTA or a BGZF FASTA: (path, min_qual)."""
    if kind == "fastq":
        return _write_fastq(tmp_path / "r.fastq", reads), 20
    plain = _write_fasta(tmp_path / "r.fasta", reads)
    if kind == "gzip":
        gz = tmp_path / "r.fasta.gz"
        gz.write_bytes(gzip.compress(plain.read_bytes()))
        return gz, 0
    if kind == "bgzf":
        bg = tmp_path / "r.bgzf.fasta.gz"
        write_bgzf(bg, plain.read_bytes(), block=700)
        return bg, 0
    return plain, 0


def _batch_rows(batches):
    return [b.codes[i, : b.lengths[i]].tolist() for b in batches for i in range(b.n_reads)]


# ------------------------------------------------------------- batches


def test_stream_batches_order_and_shapes(tmp_path):
    reads = _random_reads(25, 0)
    fasta = _write_fasta(tmp_path / "r.fasta", reads)
    batches = list(stream_batches(fasta, k=4, batch_size=8))
    assert [b.n_reads for b in batches] == [8, 8, 8, 1]
    # Every batch keeps the full batch_size rows; widths are 128 * 2^j.
    assert all(b.batch_size == 8 and b.max_len in (128, 256, 512) for b in batches)
    assert _batch_rows(batches) == [r.tolist() for r in reads]
    offsets = [off for _, off in iter_encoded_with_offsets(fasta)]
    assert [b.end_offset for b in batches] == [offsets[7], offsets[15], offsets[23],
                                              os.path.getsize(fasta)]


@pytest.mark.parametrize("native", [False, True], ids=["jax_python", "jax_native"])
@pytest.mark.parametrize(
    "kind,kw",
    [
        ("fasta", {}),
        ("fasta", {"skip_reads": 11}),
        ("fasta", {"len_base": 64}),
        ("fasta", {"offsets": (13, None)}),
        ("fasta", {"offsets": (None, 30)}),
        ("fasta", {"offsets": (9, 31)}),
        ("fastq", {}),
        ("fastq", {"offsets": (20, None)}),
        ("gzip", {"skip_reads": 5}),
        ("bgzf", {"offsets": (17, 40)}),
    ],
    ids=["whole", "skip", "len_base64", "start", "limit", "start_limit", "fastq",
         "fastq_start", "gzip_skip", "bgzf_start_limit"],
)
def test_stream_batches_match_jax(tmp_path, monkeypatch, native, kind, kw):
    """Batch order, shapes, lengths and end offsets equal
    ``cfrk_tpu.pipeline.stream.stream_batches``, through its pure-Python
    branch and its native block ingest.  ``offsets=(i, j)``: start at
    the end of record i, stop before the first record at or past the end
    of record j."""
    monkeypatch.setattr("cfrk_tpu.io.native.HAVE_STREAM_NATIVE", native)
    reads = _random_reads(45, 1, lo=10, hi=200)
    reads[20] = _random_reads(1, 2, lo=700, hi=701)[0]  # one wide batch
    path, min_qual = _input(tmp_path, kind, reads)
    kw = dict(kw, min_qual=min_qual)
    if "offsets" in kw:
        ends = [off for _, off in iter_encoded_with_offsets(path)]
        i, j = kw.pop("offsets")
        kw["start_offset"] = None if i is None else ends[i]
        kw["limit_offset"] = None if j is None else ends[j]
    got = list(stream_batches(path, 5, 8, **kw))
    want = list(jstream.stream_batches(path, 5, 8, **kw))
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.lengths, w.lengths)
        assert g.codes.dtype == np.int8 and g.lengths.dtype == w.lengths.dtype
        assert (g.n_reads, g.end_offset) == (w.n_reads, w.end_offset)
    assert (got[-1].end_offset is None) == (kind == "gzip")


def test_gzip_byte_addressing_rejected(tmp_path):
    """Byte offsets on a plain-gzip input raise the JAX package's
    messages, from the batch stream and from both drivers."""
    path, _ = _input(tmp_path, "gzip", _random_reads(5, 79, lo=10, hi=40))
    for mod in (tstream, jstream):
        for kw in ({"start_offset": 10}, {"limit_offset": 100}):
            with pytest.raises(ValueError, match="byte offsets cannot address a gzip"):
                list(mod.stream_batches(path, 3, 4, **kw))
    with pytest.raises(ValueError, match="byte_range needs a plain or bgzf input"):
        jstream.stream_spectrum_file(path, 3, byte_range=(0, 100))
    with pytest.raises(ValueError, match="byte_range needs a plain or bgzf input"):
        stream_spectrum_file(path, 3, device="cpu", byte_range=(0, 100))
    with pytest.raises(ValueError, match="byte_range needs a plain or bgzf input"):
        stream_count_file(path, tmp_path / "o.cfrk", 3, device="cpu", byte_range=(0, 9))


# ------------------------------------------- per-read rows: byte parity

_CONFIGS = {
    "k2_dense": dict(k=2),
    "k8_dense": dict(k=8),
    "k2_nonzero": dict(k=2, nonzero=True),
    "k8_nonzero": dict(k=8, nonzero=True),
    "k15_canonical_nonzero": dict(k=15, nonzero=True, canonical=True),
    "k31_canonical_nonzero": dict(k=31, nonzero=True, canonical=True),
}


@pytest.mark.parametrize("kind", ["fasta", "fastq", "gzip", "bgzf"])
@pytest.mark.parametrize("config", sorted(_CONFIGS))
def test_stream_count_bytes_and_resume_at_every_boundary(tmp_path, config, kind):
    """``stream_count_file`` bytes == the port's one-shot bytes ==
    cfrk_tpu's streamed bytes; and the same bytes after a kill at every
    ``batch-written`` and ``checkpoint`` boundary and a resume."""
    cfg = dict(_CONFIGS[config])
    k = cfg.pop("k")
    reads = _random_reads(18, 21, lo=20, hi=90)
    path, min_qual = _input(tmp_path, kind, reads)
    bs, n_batches = 4, 5
    common = dict(batch_size=bs, min_qual=min_qual, **cfg)

    full, shot, jfull = (tmp_path / n for n in ("full.cfrk", "shot.cfrk", "jax.cfrk"))
    m = stream_count_file(path, full, k, device="cpu", **common)
    assert (m.reads, m.total_reads, m.batches) == (18, 18, n_batches)
    assert not os.path.exists(checkpoint_path(full))
    count_file_sparse_rows(path, shot, k, device="cpu", nonzero=cfg.get("nonzero", False),
                           canonical=cfg.get("canonical", False), batch_size=bs,
                           min_qual=min_qual)
    jstream.stream_count_file(path, jfull, k, **common)
    want = full.read_bytes()
    assert want == shot.read_bytes() and want == jfull.read_bytes()
    assert want.count(b"\n") == 17

    for site in ("batch-written", "checkpoint"):
        for nth in range(1, n_batches + 1):
            out = tmp_path / f"{site}{nth}.cfrk"
            faults.arm(site, nth)
            with pytest.raises(faults.InjectedFault):
                stream_count_file(path, out, k, device="cpu", **common)
            done = (nth - 1 if site == "batch-written" else nth) * bs
            m = stream_count_file(path, out, k, device="cpu", resume=True, **common)
            assert m.reads == 18 - min(done, 18), (site, nth)
            assert m.total_reads == 18
            assert out.read_bytes() == want, (site, nth)
            assert not os.path.exists(checkpoint_path(out))


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_stream_golden_byte_exact(tmp_path, name):
    """The stream path reproduces the reference goldens byte for byte."""
    out = tmp_path / "g.cfrk"
    m = stream_count_file(DATA / name, out, MANIFEST["k"], device="cpu", batch_size=128)
    assert m.reads == MANIFEST["files"][name]["n_reads"]
    assert hashlib.sha256(out.read_bytes()).hexdigest() == MANIFEST["files"][name]["sha256"]


def test_stream_count_matches_count_reads(tmp_path):
    from cfrk_tpu_torch.format import parse_cfrk

    reads = _random_reads(40, 1)
    fasta = _write_fasta(tmp_path / "r.fasta", reads)
    out = tmp_path / "r.cfrk"
    m = stream_count_file(fasta, out, 4, device="cpu", batch_size=16)
    assert m.reads == 40 and m.batches == 3
    np.testing.assert_array_equal(parse_cfrk(out.read_bytes()),
                                  count_reads(reads, 4, device="cpu"))


def test_stream_long_contig_buckets(tmp_path):
    """Contigs walk the geometric bucket ladder (128, 1024, 4096) and
    match the one-shot driver and cfrk_tpu."""
    rng = np.random.default_rng(20)
    reads = [rng.integers(0, 4, size=n).astype(np.int8) for n in (3000, 150, 700)]
    fasta = _write_fasta(tmp_path / "contigs.fasta", reads)
    assert [b.max_len for b in stream_batches(fasta, 6, 1)] == [4096, 256, 1024]
    outs = [tmp_path / n for n in ("s.cfrk", "o.cfrk", "j.cfrk")]
    m = stream_count_file(fasta, outs[0], 6, device="cpu", batch_size=2, nonzero=True)
    assert m.reads == 3
    count_file_sparse_rows(fasta, outs[1], 6, device="cpu", batch_size=2)
    jstream.stream_count_file(fasta, outs[2], 6, batch_size=2, nonzero=True)
    assert outs[0].read_bytes() == outs[1].read_bytes() == outs[2].read_bytes()


# ------------------------------------------------- packed, dense routes


@pytest.mark.parametrize("k,hi,packing", [(5, 120, "b4"), (8, 100, "b4"), (6, 500, "fh")],
                         ids=["k5_b4", "k8_b4", "k6_fh"])
@pytest.mark.parametrize("nonzero", [False, True], ids=["dense", "nonzero"])
def test_stream_count_packed(tmp_path, monkeypatch, k, hi, packing, nonzero):
    """``packed=True`` really runs the per-read histogram kernel's
    wrapper in the densest safe packing (spied), an unflagged run on the
    CPU does not, and the bytes equal the unpacked route's and cfrk_tpu's
    packed run."""
    import cfrk_tpu_torch.pipeline.count as count_mod

    calls = []
    real = count_mod.perread_hist

    def spy(*a, **kw):
        calls.append(kw.get("packed"))
        return real(*a, **kw)

    monkeypatch.setattr(count_mod, "perread_hist", spy)
    reads = _random_reads(24, 10, lo=hi - 60, hi=hi)
    fasta = _write_fasta(tmp_path / "r.fasta", reads)
    out_p, out_s, out_j = (tmp_path / n for n in ("p.cfrk", "s.cfrk", "j.cfrk"))
    stream_count_file(fasta, out_p, k, device="cpu", batch_size=8, packed=True,
                      nonzero=nonzero)
    assert calls == [packing] * 3
    stream_count_file(fasta, out_s, k, device="cpu", batch_size=8, nonzero=nonzero)
    assert len(calls) == 3
    jstream.stream_count_file(fasta, out_j, k, batch_size=8, packed=True, nonzero=nonzero)
    assert out_p.read_bytes() == out_s.read_bytes() == out_j.read_bytes()


def test_stream_packed_and_output_argument_errors(tmp_path):
    """The JAX package's argument checks, message for message."""
    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(3, 4))
    for fn, kw in ((stream_count_file, {"device": "cpu"}), (jstream.stream_count_file, {})):
        with pytest.raises(ValueError, match="packed mode needs k <= 8"):
            fn(fasta, tmp_path / "y.cfrk", 9, packed=True, **kw)
        with pytest.raises(ValueError, match=r"use --impl auto/pallas \(got --impl scatter\)"):
            fn(fasta, tmp_path / "y.cfrk", 4, packed=True, impl="scatter", **kw)
        with pytest.raises(ValueError, match="streaming .gz output is unsupported"):
            fn(fasta, tmp_path / "y.cfrk.gz", 4, **kw)
        with pytest.raises(ValueError, match="per-read k=11 > 8 requires nonzero=True"):
            fn(fasta, tmp_path / "y.cfrk", 11, **kw)
    assert not (tmp_path / "y.cfrk").exists() and not (tmp_path / "y.cfrk.gz").exists()


@pytest.mark.parametrize(
    "k,canonical,nonzero",
    [(8, False, True), (6, True, True), (2, False, False), (8, False, False),
     (5, True, False)],
    ids=["k8_nonzero", "k6_canonical_nonzero", "k2_dense", "k8_dense", "k5_canonical_dense"],
)
def test_stream_pair_routes_equal_dense_kernel_route(tmp_path, k, canonical, nonzero):
    """``impl='auto'`` takes the per-read sort + RLE for nonzero AND
    dense output; an explicit impl keeps the dense counts.  Same bytes,
    equal to cfrk_tpu's for each route."""
    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(30, 23, lo=20, hi=90))
    kw = dict(batch_size=8, canonical=canonical, nonzero=nonzero)
    outs = [tmp_path / n for n in ("auto.cfrk", "dense.cfrk", "jauto.cfrk", "jdense.cfrk")]
    assert stream_count_file(fasta, outs[0], k, device="cpu", **kw).reads == 30
    stream_count_file(fasta, outs[1], k, device="cpu", impl="scatter", **kw)
    jstream.stream_count_file(fasta, outs[2], k, **kw)
    jstream.stream_count_file(fasta, outs[3], k, impl="scatter", **kw)
    data = [o.read_bytes() for o in outs]
    assert data[0] == data[1] == data[2] == data[3]


def test_stream_dense_impl_route_resume(tmp_path):
    """Kill and resume on the explicit-impl dense route."""
    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(40, 24, lo=20, hi=90))
    full, out = tmp_path / "full.cfrk", tmp_path / "r.cfrk"
    stream_count_file(fasta, full, 4, device="cpu", batch_size=8)
    faults.arm("batch-written", 2)
    with pytest.raises(faults.InjectedFault):
        stream_count_file(fasta, out, 4, device="cpu", batch_size=8, impl="host",
                          resume=True)
    m = stream_count_file(fasta, out, 4, device="cpu", batch_size=8, impl="host",
                          resume=True)
    assert m.reads == 32  # really resumed, not restarted
    assert out.read_bytes() == full.read_bytes()


# --------------------------------------------- resume: checkpoint files


def _prefix_checkpoint(fasta, out, reads, k, cut, bs, **fields):
    """An interrupted run by hand: the first ``cut`` reads' rows in
    ``out`` and a checkpoint that claims them."""
    with open(out, "wb") as f:
        CfrkWriter(f).write_batch(count_reads(reads[:cut], k, device="cpu", batch_size=bs))
        f.flush()
        nbytes = f.tell()
    ckpt = StreamCheckpoint(
        fingerprint=StreamCheckpoint.fingerprint_of(fasta, k, "perread", False),
        reads_done=cut, out_bytes=nbytes, **fields)
    ckpt.save(checkpoint_path(out))
    return nbytes


def test_stream_resume_midway_drops_torn_tail(tmp_path):
    reads = _random_reads(50, 2)
    fasta = _write_fasta(tmp_path / "r.fasta", reads)
    full, out = tmp_path / "full.cfrk", tmp_path / "r.cfrk"
    stream_count_file(fasta, full, 3, device="cpu", batch_size=16)
    _prefix_checkpoint(fasta, out, reads, 3, 32, 16)
    with open(out, "ab") as f:
        f.write(b"GARBAGE")  # past the checkpointed offset: must be dropped
    m = stream_count_file(fasta, out, 3, device="cpu", batch_size=16, resume=True)
    assert m.reads == 18 and m.total_reads == 50
    assert out.read_bytes() == full.read_bytes()
    assert not os.path.exists(checkpoint_path(out))


@pytest.mark.parametrize(
    "case", ["stale_fingerprint", "missing_output", "short_output", "torn_json",
             "json_null", "json_list", "json_string", "other_min_qual"])
def test_stream_resume_restarts_from_zero(tmp_path, case):
    """A checkpoint that does not fit the run, an output that does not
    hold what it promises, and a corrupt or non-object JSON each restart
    from scratch, as in the JAX package."""
    reads = _random_reads(12, 14)
    fasta = _write_fasta(tmp_path / "r.fasta", reads)
    out = tmp_path / "r.cfrk"
    cpath = checkpoint_path(out)
    k = 3
    fp = StreamCheckpoint.fingerprint_of(fasta, k, "perread", False)
    if case == "stale_fingerprint":
        StreamCheckpoint(fingerprint=dict(fp, k=9), reads_done=5, out_bytes=123).save(cpath)
        out.write_bytes(b"x" * 200)
    elif case == "missing_output":
        StreamCheckpoint(fingerprint=fp, reads_done=8, out_bytes=500).save(cpath)
    elif case == "short_output":
        StreamCheckpoint(fingerprint=fp, reads_done=8, out_bytes=500).save(cpath)
        out.write_bytes(b"short")
    elif case == "other_min_qual":
        StreamCheckpoint(fingerprint=dict(fp, min_qual=20), reads_done=4,
                         out_bytes=3).save(cpath)
        out.write_bytes(b"x" * 200)
    else:
        Path(cpath).write_text({"torn_json": "{torn json", "json_null": "null",
                                "json_list": "[]", "json_string": '"str"'}[case])
        assert StreamCheckpoint.load_if_valid(cpath) is None
    want = tmp_path / "want.cfrk"
    stream_count_file(fasta, want, k, device="cpu", batch_size=4)
    m = stream_count_file(fasta, out, k, device="cpu", batch_size=4, resume=True)
    assert m.reads == 12  # a full restart
    assert out.read_bytes() == want.read_bytes() and b"\x00" not in out.read_bytes()


def test_checkpoint_unknown_fields_and_complete_run(tmp_path):
    """Unknown fields of a newer build are ignored; a resumed run whose
    work is done processes 0 reads and still reports the file's rows."""
    reads = _random_reads(9, 9, lo=10, hi=40)
    fasta = _write_fasta(tmp_path / "t.fasta", reads)
    out = tmp_path / "o.cfrk"
    m1 = stream_count_file(fasta, out, 4, device="cpu", batch_size=4)
    assert m1.reads == 9 and m1.total_reads == 9
    want = out.read_bytes()
    data = {
        "fingerprint": StreamCheckpoint.fingerprint_of(fasta, 4, "perread", False),
        "reads_done": 9, "out_bytes": len(want), "spectrum_path": None,
        "input_offset": os.path.getsize(fasta), "field_from_the_future": 42,
    }
    Path(checkpoint_path(out)).write_text(json.dumps(data))
    m2 = stream_count_file(fasta, out, 4, device="cpu", batch_size=4, resume=True)
    assert m2.reads == 0 and m2.total_reads == 9
    assert out.read_bytes() == want


def test_stream_resume_uses_offset_seek(tmp_path, monkeypatch):
    """A checkpointed input_offset is sought, not re-parsed."""
    reads = _random_reads(24, 31, lo=20, hi=50)
    fasta = _write_fasta(tmp_path / "r.fasta", reads)
    full, out = tmp_path / "f.cfrk", tmp_path / "r.cfrk"
    stream_count_file(fasta, full, 3, device="cpu", batch_size=8)
    offsets = [off for _, off in iter_encoded_with_offsets(fasta)]
    _prefix_checkpoint(fasta, out, reads, 3, 16, 8, input_offset=offsets[15])
    calls = {}
    real = tstream.stream_batches

    def spy(path, k2, bs2, **kw):
        calls.update(kw)
        return real(path, k2, bs2, **kw)

    monkeypatch.setattr(tstream, "stream_batches", spy)
    m = stream_count_file(fasta, out, 3, device="cpu", batch_size=8, resume=True)
    assert calls.get("start_offset") == offsets[15] and "skip_reads" not in calls
    assert m.reads == 8
    assert out.read_bytes() == full.read_bytes()


def test_gzip_resume_warns_and_completes(tmp_path, capsys):
    """A plain-gzip input cannot seek: resume re-parses with the JAX
    package's notice on stderr and still writes the same bytes."""
    reads = _random_reads(20, 44, lo=20, hi=60)
    gz, _ = _input(tmp_path, "gzip", reads)
    full, out = tmp_path / "full.cfrk", tmp_path / "r.cfrk"
    stream_count_file(gz, full, 3, device="cpu", batch_size=8)
    _prefix_checkpoint(gz, out, reads, 3, 8, 8)
    m = stream_count_file(gz, out, 3, device="cpu", batch_size=8, resume=True)
    assert m.reads == 12
    assert out.read_bytes() == full.read_bytes()
    err = capsys.readouterr().err
    assert "# resume on gzip input re-parses 8 records from the start" in err
    assert "decompress the input first for large runs" in err


def test_stream_count_byte_range_splice(tmp_path):
    """Per-range parts, the ranges from ``cfrk_tpu.parallel.distributed``,
    equal cfrk_tpu's parts and splice with a newline to the whole-file
    bytes; a ranged checkpoint never serves the whole-file run."""
    from cfrk_tpu.parallel.distributed import align_to_record

    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(31, 57, lo=15, hi=120))
    size = os.path.getsize(fasta)
    whole = tmp_path / "whole.cfrk"
    stream_count_file(fasta, whole, 4, device="cpu", batch_size=8)
    parts = []
    for pi in range(3):
        rng = (align_to_record(fasta, size * pi // 3),
               size * (pi + 1) // 3 if pi < 2 else size)
        p, j = tmp_path / f"part{pi}.cfrk", tmp_path / f"jpart{pi}.cfrk"
        stream_count_file(fasta, p, 4, device="cpu", batch_size=8, byte_range=rng)
        jstream.stream_count_file(fasta, j, 4, batch_size=8, byte_range=rng)
        assert p.read_bytes() == j.read_bytes()
        parts.append(p.read_bytes())
    assert b"\n".join(x for x in parts if x) == whole.read_bytes()

    rng = (align_to_record(fasta, size // 3), size)
    out = tmp_path / "ranged.cfrk"
    faults.arm("checkpoint", 1)
    with pytest.raises(faults.InjectedFault):
        stream_count_file(fasta, out, 4, device="cpu", batch_size=8, byte_range=rng)
    mode = json.loads(Path(checkpoint_path(out)).read_text())["fingerprint"]["mode"]
    assert mode == f"perread-range{rng[0]}-{rng[1]}"
    m = stream_count_file(fasta, out, 4, device="cpu", batch_size=8, resume=True)
    assert m.reads == 31 and out.read_bytes() == whole.read_bytes()


# ----------------------------------------------------- streamed spectrum


@pytest.mark.parametrize("kind", ["fasta", "fastq", "gzip", "bgzf"])
@pytest.mark.parametrize(
    "k,canonical,impl",
    [(5, False, "auto"), (6, True, "scatter"), (8, False, "pallas"), (3, True, "matmul")],
    ids=["k5_auto", "k6_canonical_scatter", "k8_kernel_twin", "k3_canonical_matmul"],
)
def test_stream_spectrum_tables_and_resume(tmp_path, kind, k, canonical, impl):
    """The streamed dense table == ``spectrum_file``'s == cfrk_tpu's
    streamed table, before and after a kill at every checkpoint and a
    resume; the sidecar goes with the checkpoint."""
    reads = _random_reads(30, 4, lo=20, hi=120)
    path, min_qual = _input(tmp_path, kind, reads)
    kw = dict(canonical=canonical, impl=impl, batch_size=8, min_qual=min_qual)
    table, m = stream_spectrum_file(path, k, device="cpu", **kw)
    assert (m.reads, m.total_reads, m.batches) == (30, 30, 4)
    assert table.dtype == np.int64 and table.shape == (4**k,)
    np.testing.assert_array_equal(table, spectrum_file(path, k, device="cpu", **kw))
    jtable, _ = jstream.stream_spectrum_file(path, k, **kw)
    np.testing.assert_array_equal(table, np.asarray(jtable))

    out = tmp_path / "r.spectrum"
    for nth in (1, 2):
        faults.arm("checkpoint", nth)
        with pytest.raises(faults.InjectedFault):
            stream_spectrum_file(path, k, device="cpu", out_path=out,
                                 checkpoint_every=2, **kw)
        state = json.loads(Path(checkpoint_path(out)).read_text())
        done = min(16 * nth, 30)
        assert state["reads_done"] == done
        assert state["spectrum_path"].endswith(f".spectrum.{done}.npy")
        assert len(list(tmp_path.glob("r.spectrum.ckpt.json.spectrum.*"))) == 1
        got, m = stream_spectrum_file(path, k, device="cpu", out_path=out, resume=True,
                                      checkpoint_every=2, **kw)
        assert m.reads == 30 - done and m.total_reads == 30
        np.testing.assert_array_equal(got, table)
        assert not list(tmp_path.glob("r.spectrum.ckpt.json*"))


def test_stream_spectrum_stage_names_and_cleanup(tmp_path):
    """The wait for the device and the table's copy are booked under
    "drain", never under "checkpoint"; ``cleanup=False`` leaves the
    checkpoint for the caller; a torn sidecar restarts from zero."""
    fasta = _write_fasta(tmp_path / "in.fasta", _random_reads(40, 3, lo=60, hi=61))
    out = tmp_path / "t.spec"
    want, m = stream_spectrum_file(fasta, 3, device="cpu", batch_size=8, out_path=out,
                                   checkpoint_every=2, cleanup=False)
    _, jm = jstream.stream_spectrum_file(fasta, 3, batch_size=8,
                                         out_path=tmp_path / "j.spec", checkpoint_every=2)
    assert set(m.stages) == set(jm.stages) == {"parse_wait", "dispatch", "drain",
                                               "checkpoint"}
    state = json.loads(Path(checkpoint_path(out)).read_text())
    assert state["reads_done"] == 32 and os.path.isabs(state["spectrum_path"])
    Path(state["spectrum_path"]).write_bytes(b"torn")
    got, m = stream_spectrum_file(fasta, 3, device="cpu", batch_size=8, out_path=out,
                                  resume=True)
    assert m.reads == 40
    np.testing.assert_array_equal(got, want)
    assert not list(tmp_path.glob("t.spec.ckpt.json*"))


@pytest.mark.parametrize(
    "impl,k,device",
    [("sort", 5, "cpu"), ("sort", 12, "cpu"), ("auto", 11, "cuda"), ("auto", 15, "cuda")],
)
def test_stream_spectrum_sorted_route_matches_jax(tmp_path, monkeypatch, impl, k, device):
    """Where the sorted route holds (``--impl sort``; ``auto`` at
    k = 11-15 on a CUDA device) the driver hands over to the sparse
    streaming driver, as the JAX driver does.  ``sort`` runs here for
    real, its table equal to cfrk_tpu's streamed sorted spectrum.  The
    ``auto`` cases hold the routing rule without a card: the hand-over
    receives the CUDA device, and the sparse result it would densify is
    computed on the CPU and held against cfrk_tpu's (at k = 11 the whole
    table too; the 4**15 table is never built here)."""
    import torch

    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(30, 5, lo=20, hi=120))
    kw = dict(canonical=True, batch_size=8, checkpoint_every=2)
    handed = []
    real = tstream.stream_sparse_spectrum_file

    class _Stop(Exception):
        pass

    def hand_over(path, k_, **args):
        handed.append(args["device"])
        got = real(path, k_, **{**args, "device": "cpu"})
        want = jstream.stream_sparse_spectrum_file(path, k_, canonical=True, batch_size=8)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        if k_ == 15:
            raise _Stop
        return got

    monkeypatch.setattr(tstream, "stream_sparse_spectrum_file", hand_over)
    assert tstream._use_sorted_spectrum(k, impl, torch.device(device))
    assert tstream._use_sorted_spectrum(k, impl, torch.device("cpu")) == (impl == "sort")
    if k == 15:
        with pytest.raises(_Stop):
            stream_spectrum_file(fasta, k, device=device, impl=impl,
                                 out_path=tmp_path / "s", **kw)
    else:
        got, m = stream_spectrum_file(fasta, k, device=device, impl=impl,
                                      out_path=tmp_path / "s", **kw)
        want, jm = jstream.stream_spectrum_file(fasta, k, impl="sort",
                                                out_path=tmp_path / "j", **kw)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert m.reads == 30 and m.mode == jm.mode == "sparse"
        assert not list(tmp_path.glob("*.ckpt.json*"))
    assert handed == [torch.device(device)]


def test_checkpoint_sidecar_paths_absolute_and_mtime_ns(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ckpt = StreamCheckpoint(fingerprint={}, reads_done=3)
    ckpt.save_spectrum("rel.ckpt.json", np.arange(4, dtype=np.int64))
    assert os.path.isabs(ckpt.spectrum_path)
    monkeypatch.chdir("/")
    np.testing.assert_array_equal(ckpt.load_spectrum(), np.arange(4))
    f = tmp_path / "a.fasta"
    f.write_bytes(b">r\nACGT\n")
    fp1 = StreamCheckpoint.fingerprint_of(f, 2, "perread", False)
    assert fp1 == JaxCheckpoint.fingerprint_of(f, 2, "perread", False)
    os.utime(f, ns=(os.stat(f).st_atime_ns, os.stat(f).st_mtime_ns + 1))
    assert fp1 != StreamCheckpoint.fingerprint_of(f, 2, "perread", False)
    with pytest.raises(ValueError, match="no spectrum accumulator"):
        StreamCheckpoint(fingerprint={}).load_spectrum()


# --------------------------------------------------------------- metrics


def test_metrics_json_line_and_keys_equal_jax(tmp_path):
    reads = _random_reads(5, 6)
    fasta = _write_fasta(tmp_path / "r.fasta", reads)
    m = stream_count_file(fasta, tmp_path / "r.cfrk", 2, device="cpu", batch_size=4)
    jm = jstream.stream_count_file(fasta, tmp_path / "j.cfrk", 2, batch_size=4)
    d, jd = json.loads(m.json_line()), json.loads(jm.json_line())
    assert list(d) == list(jd)
    assert set(d["stages_s"]) == set(jd["stages_s"]) == {
        "parse_wait", "dispatch", "materialize", "write", "checkpoint"}
    for key in ("reads", "bases", "batches", "k", "mode"):
        assert d[key] == jd[key]
    assert d["reads"] == 5 and d["bases"] == sum(len(r) for r in reads)
    assert d["bases_per_sec"] > 0 and d["wall_s"] > 0
    assert [f.name for f in dataclasses.fields(RunMetrics)] == [
        f.name for f in dataclasses.fields(JaxRunMetrics)]


def test_metrics_wall_starts_at_first_stage_and_stage_timer():
    import time

    m = RunMetrics(k=3, mode="perread")
    time.sleep(0.02)
    assert m.wall_s == 0.0 and m.bases_per_sec == 0.0
    with m.stage("a"):
        time.sleep(0.01)
    with m.stage("a"):
        pass
    assert 0.01 <= m.stages["a"] <= m.wall_s < 0.02
    t = StageTimer()
    for _ in range(2):
        with t():
            time.sleep(0.01)
    assert t.count == 2 and t.total >= 0.02


def test_caller_metrics_object_is_filled(tmp_path):
    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(6, 8))
    m = RunMetrics(k=2, mode="perread")
    assert stream_count_file(fasta, tmp_path / "o.cfrk", 2, device="cpu", batch_size=4,
                             metrics=m) is m
    assert m.reads == 6 and m.batches == 2


# ------------------------------------------- cross-package checkpoints


def _torch_count(path, out, k, **kw):
    return stream_count_file(path, out, k, device="cpu", **kw)


def _torch_spectrum(path, k, **kw):
    return stream_spectrum_file(path, k, device="cpu", **kw)


@pytest.mark.parametrize("first", ["jax", "torch"])
@pytest.mark.parametrize("nonzero", [False, True], ids=["perread", "perread-nonzero"])
@pytest.mark.parametrize("site,nth", [("batch-written", 3), ("checkpoint", 2)])
def test_cross_package_checkpoint_perread(tmp_path, first, nonzero, site, nth):
    """A run of one package killed at a boundary is resumed by the other
    to the bytes of an uninterrupted run."""
    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(22, 41, lo=20, hi=80))
    kw = dict(batch_size=4, nonzero=nonzero)
    full, out = tmp_path / "full.cfrk", tmp_path / "x.cfrk"
    _torch_count(fasta, full, 7, **kw)
    runs = {"jax": (jstream.stream_count_file, jfaults), "torch": (_torch_count, faults)}
    (start, start_faults), (finish, _) = runs[first], runs["torch" if first == "jax" else "jax"]
    start_faults.arm(site, nth)
    with pytest.raises(start_faults.InjectedFault):
        start(fasta, out, 7, **kw)
    state = json.loads(Path(checkpoint_path(out)).read_text())
    assert state["reads_done"] == 8 and state["input_offset"] is not None
    m = finish(fasta, out, 7, resume=True, **kw)
    assert m.reads == 14 and m.total_reads == 22
    assert out.read_bytes() == full.read_bytes()
    assert not os.path.exists(checkpoint_path(out))


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_cross_package_checkpoint_spectrum(tmp_path, first):
    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(22, 42, lo=20, hi=80))
    kw = dict(batch_size=4, checkpoint_every=2)
    want, _ = _torch_spectrum(fasta, 6, **kw)
    out = tmp_path / "x.spectrum"
    runs = {"jax": (jstream.stream_spectrum_file, jfaults),
            "torch": (_torch_spectrum, faults)}
    (start, start_faults), (finish, _) = runs[first], runs["torch" if first == "jax" else "jax"]
    start_faults.arm("checkpoint", 2)
    with pytest.raises(start_faults.InjectedFault):
        start(fasta, 6, out_path=out, **kw)
    got, m = finish(fasta, 6, out_path=out, resume=True, **kw)
    assert m.reads == 6 and m.total_reads == 22
    np.testing.assert_array_equal(np.asarray(got), want)
    assert not list(tmp_path.glob("x.spectrum.ckpt.json*"))


@pytest.mark.parametrize("mode", ["perread", "perread-nonzero", "spectrum"])
def test_checkpoint_json_equals_the_jax_packages(tmp_path, mode):
    """The same run killed at the same checkpoint leaves the same JSON,
    field for field (the sidecar path apart from its directory), and the
    dataclasses have the same fields."""
    fasta = _write_fasta(tmp_path / "r.fasta", _random_reads(22, 43, lo=20, hi=80))
    states = {}
    for name, mod, fl, extra in (("torch", tstream, faults, {"device": "cpu"}),
                                 ("jax", jstream, jfaults, {})):
        d = tmp_path / name
        d.mkdir()
        fl.arm("checkpoint", 2)
        with pytest.raises(fl.InjectedFault):
            if mode == "spectrum":
                mod.stream_spectrum_file(fasta, 5, batch_size=4, checkpoint_every=2,
                                         out_path=d / "o", **extra)
            else:
                mod.stream_count_file(fasta, d / "o", 5, batch_size=4,
                                      nonzero=mode == "perread-nonzero", **extra)
        states[name] = json.loads((d / "o.ckpt.json").read_text())
        assert list(states[name]) == [f.name for f in dataclasses.fields(JaxCheckpoint)]
        # The two runs' files lie in two directories.
        if mode == "spectrum":
            sidecar = Path(states[name].pop("spectrum_path"))
            assert sidecar.parent == d and sidecar.name == "o.ckpt.json.spectrum.16.npy"
            states[name]["table"] = np.load(sidecar).tolist()
        else:
            states[name]["out"] = (d / "o").read_bytes().hex()
    assert states["torch"] == states["jax"]
    assert states["torch"]["fingerprint"]["mode"] == mode
    assert states["torch"]["reads_done"] == (16 if mode == "spectrum" else 8)
    assert [f.name for f in dataclasses.fields(StreamCheckpoint)] == [
        f.name for f in dataclasses.fields(JaxCheckpoint)]


def test_cleanup_checkpoint_removes_every_sidecar(tmp_path):
    out = tmp_path / "o.spectrum"
    cpath = checkpoint_path(out)
    ckpt = StreamCheckpoint(fingerprint={}, reads_done=4)
    ckpt.save_spectrum(cpath, np.arange(4, dtype=np.int64))
    ckpt.save(cpath)
    Path(cpath + ".spectrum.1.npy").write_bytes(b"orphan")
    Path(cpath + ".sparse.9.npz").write_bytes(b"left by the JAX package")
    os.makedirs(cpath + ".spill")
    cleanup_checkpoint(out)
    assert not list(tmp_path.glob("o.spectrum.ckpt.json*"))
    cleanup_checkpoint(out)  # nothing left: a no-op
