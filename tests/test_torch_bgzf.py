"""BGZF input of cfrk_tpu_torch (``io/bgzf.py``): the port's counterpart
of tests/test_bgzf.py.

The copy reads and writes what the JAX package's module does (each
reads the other's files), the record stream gives the plain file's
offsets in decompressed coordinates, and a streamed run on a BGZF input
resumes by seeking.  ``device="cpu"``; tolerance: exact.
"""

import gzip

import numpy as np
import pytest

from cfrk_tpu.io import bgzf as jbgzf
from cfrk_tpu.pipeline import stream as jstream
from cfrk_tpu_torch.io.bgzf import (
    BgzfReader,
    decompressed_size,
    is_bgzf,
    open_maybe_bgzf,
    write_bgzf,
)
from cfrk_tpu_torch.io.fasta import iter_encoded_with_offsets, read_fasta_encoded
from cfrk_tpu_torch.pipeline.stream import stream_batches, stream_count_file
from cfrk_tpu_torch.runtime import faults

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()


def _blob(seed, size):
    rng = np.random.default_rng(seed)
    return bytes(rng.integers(32, 127, size=size).astype(np.uint8))


def _fasta_blob(seed, n=300, fastq=False):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        seq = _BASES[rng.integers(0, 4, size=int(rng.integers(30, 200)))].tobytes()
        if fastq:
            recs.append(b"@r%d\n" % i + seq + b"\n+\n" + b"I" * len(seq) + b"\n")
        else:
            recs.append(b">r%d\n" % i + seq + b"\n")
    return b"".join(recs)


def test_bgzf_roundtrip_and_gzip_validity(tmp_path):
    data = _blob(0, 1_500_000)
    p = tmp_path / "t.bgzf"
    write_bgzf(p, data, block=50_000)
    assert gzip.decompress(p.read_bytes()) == data  # valid multi-member gzip
    assert is_bgzf(p) and decompressed_size(p) == len(data)
    with BgzfReader(p) as r:
        got = [r.read(n) for n in (1, 777, 65536, 1 << 20, -1)]
    assert b"".join(got) == data


def test_bgzf_files_equal_the_jax_packages(tmp_path):
    """The writer's bytes equal ``cfrk_tpu.io.bgzf.write_bgzf``'s, and
    each package's reader reads the other's file."""
    data = _blob(1, 300_000)
    a, b = tmp_path / "torch.bgzf", tmp_path / "jax.bgzf"
    write_bgzf(a, data, block=20_000)
    jbgzf.write_bgzf(b, data, block=20_000)
    assert a.read_bytes() == b.read_bytes()
    with jbgzf.BgzfReader(a) as r:
        assert r.read() == data
    with BgzfReader(b) as r:
        assert r.read() == data
    assert decompressed_size(a) == jbgzf.decompressed_size(b) == len(data)


def test_bgzf_sniff_rejects_plain_gzip(tmp_path):
    p = tmp_path / "t.gz"
    with gzip.open(p, "wb") as f:
        f.write(b"hello world" * 100)
    assert not is_bgzf(p) and not is_bgzf(tmp_path / "missing")
    with open_maybe_bgzf(p) as f:
        assert f.read() == b"hello world" * 100


def test_bgzf_empty_and_eof_marker(tmp_path):
    p = tmp_path / "e.bgzf"
    write_bgzf(p, b"")
    with BgzfReader(p) as r:
        assert r.read() == b""
    assert decompressed_size(p) == 0


def test_bgzf_truncated_block_raises(tmp_path):
    p = tmp_path / "t.bgzf"
    write_bgzf(p, _blob(2, 200_000), block=50_000)
    raw = p.read_bytes()
    (tmp_path / "cut.bgzf").write_bytes(raw[: len(raw) // 2])
    with pytest.raises(OSError):
        with BgzfReader(tmp_path / "cut.bgzf") as r:
            r.read()


def test_bgzf_seek_decompressed_random_targets(tmp_path):
    data = _blob(5, 800_000)
    p = tmp_path / "t.bgzf"
    write_bgzf(p, data, block=10_000)
    for target in [0, 1, 9_999, 10_000, 10_001, 123_456, 799_999, 800_000]:
        with BgzfReader(p) as r:
            r.seek_decompressed(target)
            assert r.read() == data[target:], target
    with BgzfReader(p) as r, pytest.raises(ValueError):
        r.seek_decompressed(-1)


def test_bgzf_repeated_seeks_one_reader(tmp_path):
    """One reader seeked forwards and backwards reads correctly each
    time: a seek resets the whole inflate pipeline."""
    rng = np.random.default_rng(2)
    data = _blob(3, 300_000)
    p = tmp_path / "ms.bgzf"
    write_bgzf(p, data, block=7000)
    with BgzfReader(p) as r:
        for t in range(25):
            target = int(rng.integers(0, len(data) + 1))
            n = int(rng.integers(1, 50_000))
            r.seek_decompressed(target)
            assert r.read(n) == data[target : target + n], (t, target, n)


@pytest.mark.parametrize("fastq", [False, True], ids=["fasta", "fastq"])
def test_bgzf_ingest_parity_all_paths(tmp_path, fastq):
    """A BGZF file parses as the plain file does through the in-memory
    reader, the offset iterator and the batch stream, offsets included;
    the batches equal the JAX package's."""
    blob = _fasta_blob(3, fastq=fastq)
    plain = tmp_path / "r.txt"
    plain.write_bytes(blob)
    bg = tmp_path / "r.txt.gz"
    write_bgzf(bg, blob, block=4096)  # many blocks

    a, b = read_fasta_encoded(plain), read_fasta_encoded(bg)
    assert len(a) == len(b) == 300
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    pa, pb = list(iter_encoded_with_offsets(plain)), list(iter_encoded_with_offsets(bg))
    assert [off for _, off in pa] == [off for _, off in pb]
    assert pb[-1][1] == len(blob)
    rest = list(iter_encoded_with_offsets(bg, start_offset=pb[199][1]))
    assert len(rest) == 100
    np.testing.assert_array_equal(rest[0][0], a[200])

    ba, bb = list(stream_batches(plain, 5, 64)), list(stream_batches(bg, 5, 64))
    jb = list(jstream.stream_batches(bg, 5, 64))
    assert len(ba) == len(bb) == len(jb)
    for x, y, z in zip(ba, bb, jb):
        np.testing.assert_array_equal(x.codes, y.codes)
        np.testing.assert_array_equal(y.codes, z.codes)
        np.testing.assert_array_equal(y.lengths, z.lengths)
        assert x.n_reads == y.n_reads == z.n_reads
        assert x.end_offset == y.end_offset == z.end_offset is not None


@pytest.mark.parametrize("site,nth", [("checkpoint", 2), ("batch-written", 3)])
def test_bgzf_stream_count_resumes_by_seek(tmp_path, monkeypatch, capsys, site, nth):
    """A streamed run on a BGZF input, killed and resumed: the resume
    seeks to the checkpoint's decompressed offset (no re-parse, no gzip
    warning) and ends on the bytes of the uninterrupted run, the plain
    file's run and cfrk_tpu's run."""
    import cfrk_tpu_torch.pipeline.stream as stream_mod

    blob = _fasta_blob(6, n=96)
    plain = tmp_path / "r.fasta"
    plain.write_bytes(blob)
    bg = tmp_path / "r.fasta.gz"
    write_bgzf(bg, blob, block=1024)
    k, bs = 4, 16
    full, jfull, pfull = (tmp_path / n for n in ("full.cfrk", "jax.cfrk", "plain.cfrk"))
    stream_count_file(bg, full, k, device="cpu", batch_size=bs)
    stream_count_file(plain, pfull, k, device="cpu", batch_size=bs)
    jstream.stream_count_file(bg, jfull, k, batch_size=bs)
    want = full.read_bytes()
    assert want == jfull.read_bytes() == pfull.read_bytes()

    out = tmp_path / "resumed.cfrk"
    faults.arm(site, nth)
    with pytest.raises(faults.InjectedFault):
        stream_count_file(bg, out, k, device="cpu", batch_size=bs)
    calls = {}
    real = stream_mod.stream_batches

    def spy(path, k2, bs2, **kw):
        calls.update(kw)
        return real(path, k2, bs2, **kw)

    monkeypatch.setattr(stream_mod, "stream_batches", spy)
    m = stream_count_file(bg, out, k, device="cpu", batch_size=bs, resume=True)
    offsets = [b.end_offset for b in real(bg, k, bs)]
    assert calls.get("start_offset") == offsets[1] and "skip_reads" not in calls
    assert m.reads == 96 - 2 * bs and m.total_reads == 96
    assert out.read_bytes() == want
    assert "re-parses" not in capsys.readouterr().err


def test_bgzf_fastq_stream_count_parity(tmp_path):
    """BGZF FASTQ through the streaming driver equals the plain-file run
    and cfrk_tpu's, with and without a quality mask."""
    blob = _fasta_blob(4, n=100, fastq=True).replace(b"IIII", b"I#5I")
    plain = tmp_path / "r.fastq"
    plain.write_bytes(blob)
    bg = tmp_path / "r.fastq.gz"
    write_bgzf(bg, blob, block=2048)
    assert is_bgzf(bg)
    for min_qual in (0, 20):
        outs = [tmp_path / f"{n}{min_qual}.cfrk" for n in ("p", "b", "j")]
        stream_count_file(plain, outs[0], 4, device="cpu", batch_size=32,
                          min_qual=min_qual)
        stream_count_file(bg, outs[1], 4, device="cpu", batch_size=32,
                          min_qual=min_qual)
        jstream.stream_count_file(bg, outs[2], 4, batch_size=32, min_qual=min_qual)
        assert outs[0].read_bytes() == outs[1].read_bytes() == outs[2].read_bytes()
    assert (tmp_path / "p0.cfrk").read_bytes() != (tmp_path / "p20.cfrk").read_bytes()


def test_bgzf_ranged_stream_count_splice(tmp_path):
    """Two abutting byte-range runs over a BGZF FASTA, the ranges from
    ``cfrk_tpu.parallel.distributed`` in decompressed coordinates,
    splice to the bytes of the whole-file run."""
    from cfrk_tpu.parallel.distributed import host_byte_range

    blob = _fasta_blob(9, n=60)
    bg = tmp_path / "r.fasta.gz"
    write_bgzf(bg, blob, block=900)
    full = tmp_path / "full.cfrk"
    stream_count_file(bg, full, 4, device="cpu", batch_size=8)
    parts = []
    for pi in range(2):
        p = tmp_path / f"part{pi}.cfrk"
        stream_count_file(bg, p, 4, device="cpu", batch_size=8,
                          byte_range=host_byte_range(bg, pi, 2))
        parts.append(p.read_bytes())
    assert all(parts)
    assert b"\n".join(parts) == full.read_bytes()


@pytest.mark.parametrize("part", [0, 1])
@pytest.mark.parametrize("site,nth", [("batch-written", 2), ("checkpoint", 3)])
def test_bgzf_ranged_resume(tmp_path, part, site, nth):
    """A kill and a resume INSIDE a byte-ranged BGZF run (a worker of a
    multi-process run that crashes): the resumed part equals the
    uninterrupted one and cfrk_tpu's, its checkpoint is tagged with the
    range, and the resume seeks inside the range."""
    import json

    from cfrk_tpu.parallel.distributed import host_byte_range
    from cfrk_tpu_torch.runtime.checkpoint import checkpoint_path

    bg = tmp_path / "r.fasta.gz"
    write_bgzf(bg, _fasta_blob(12, n=80), block=800)
    rng = host_byte_range(bg, part, 2)
    kw = dict(batch_size=8, byte_range=rng)
    full, jfull, out = (tmp_path / n for n in ("full.part", "jax.part", "resumed.part"))
    total = stream_count_file(bg, full, 4, device="cpu", **kw).total_reads
    jstream.stream_count_file(bg, jfull, 4, **kw)
    assert full.read_bytes() == jfull.read_bytes() and total >= 32

    faults.arm(site, nth)
    with pytest.raises(faults.InjectedFault):
        stream_count_file(bg, out, 4, device="cpu", **kw)
    state = json.loads(open(checkpoint_path(out)).read())
    assert state["fingerprint"]["mode"] == f"perread-range{rng[0]}-{rng[1]}"
    assert rng[0] < state["input_offset"] < rng[1]
    m = stream_count_file(bg, out, 4, device="cpu", resume=True, **kw)
    assert m.reads == total - state["reads_done"] and m.total_reads == total
    assert out.read_bytes() == full.read_bytes()
