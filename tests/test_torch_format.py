"""Host modules of cfrk_tpu_torch (numpy copies) against cfrk_tpu's.

FASTA/FASTQ parsing, batching and the `.cfrk` formatter must give the
JAX package's records and bytes.  Tolerance: exact equality (bytes and
integer arrays).
"""

import gzip
import io
from pathlib import Path

import numpy as np
import pytest

from cfrk_tpu import format as jfmt
from cfrk_tpu.io import fasta as jfasta
from cfrk_tpu.io import native as jnative
from cfrk_tpu.pipeline import batch as jbatch
from cfrk_tpu_torch import format as tfmt
from cfrk_tpu_torch.io import fasta as tfasta
from cfrk_tpu_torch.pipeline import batch as tbatch

DATA = Path(__file__).parent / "data"


def _pairs(seed, n_rows, width, wide=False):
    """Ascending (idx, counts) pair rows with count-0 padding cells and
    some empty rows, as the per-read sort + RLE emits them."""
    rng = np.random.default_rng(seed)
    hi = 1 << 62 if wide else 65536
    idx = np.sort(rng.integers(0, hi, size=(n_rows, width), dtype=np.int64), axis=1)
    cnt = rng.integers(0, 400, size=(n_rows, width)).astype(np.int32)
    cnt[rng.random(cnt.shape) < 0.4] = 0
    cnt[::5] = 0  # empty rows
    return idx.astype(np.uint64 if wide else np.int32), cnt


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("first", [True, False])
def test_pair_rows_bytes_match_jax(wide, first):
    idx, cnt = _pairs(int(wide) * 2 + first, 23, 17, wide)
    want = jnative.format_pairs_bytes(idx, cnt, first=first)
    assert tfmt.format_pairs_bytes(idx, cnt, first=first) == want
    assert tfmt.format_rows_pairs(idx, cnt) == jfmt.format_rows_pairs(idx, cnt)


@pytest.mark.parametrize("fk", [4, 16, 256])
@pytest.mark.parametrize("first", [True, False])
def test_dense_rows_bytes_match_jax(fk, first):
    rng = np.random.default_rng(fk)
    counts = rng.integers(0, 1200, size=(9, fk)).astype(np.int32)
    counts[rng.random(counts.shape) < 0.5] = 0
    want = jnative.format_rows_bytes(counts, first=first)
    assert tfmt.format_rows_bytes(counts, first=first) == want
    assert tfmt.format_file_bytes(counts) == jfmt.format_file_bytes(counts)
    idx, cnt = jfmt._dense_to_pairs(counts)
    assert tfmt.format_dense_pairs_bytes(idx, cnt, fk, first=first) == (
        jnative.format_dense_pairs_bytes(idx, cnt, fk, first=first)
    )


def test_formatter_slabs_and_empty_inputs(monkeypatch):
    """Slab boundaries do not change the bytes; zero rows give none."""
    idx, cnt = _pairs(7, 31, 9)
    small = np.tile(np.arange(9, dtype=np.int32) * 7, (31, 1))
    whole = tfmt.format_pairs_bytes(idx, cnt)
    dense_whole = tfmt.format_dense_pairs_bytes(small, cnt, 64)
    monkeypatch.setattr(tfmt, "_SLAB_CELLS", 20)
    assert tfmt.format_pairs_bytes(idx, cnt) == whole
    assert tfmt.format_dense_pairs_bytes(small, cnt, 64) == dense_whole
    empty = np.zeros((0, 4), np.int32)
    assert tfmt.format_pairs_bytes(empty, empty) == b""
    assert tfmt.format_rows_bytes(empty) == b""
    none = np.zeros((3, 4), np.int32)
    assert tfmt.format_pairs_bytes(none, none) == b"\n\n" == (
        jnative.format_pairs_bytes(none, none)
    )


def test_writer_streams_batches_like_jax(tmp_path):
    idx, cnt = _pairs(11, 12, 8)
    small = (np.tile(np.arange(8, dtype=np.int32) * 31, (12, 1)), cnt)
    buf_t, buf_j = io.BytesIO(), io.BytesIO()
    tw, jw = tfmt.CfrkWriter(buf_t), jfmt.CfrkWriter(buf_j)
    for w in (tw, jw):
        w.write_pairs(idx[:0], cnt[:0])
        w.write_pairs(idx[:5], cnt[:5])
        w.write_pairs_dense(small[0][5:], small[1][5:], 256)
        w.write_batch(np.arange(12, dtype=np.int32).reshape(3, 4))
    assert buf_t.getvalue() == buf_j.getvalue()
    out = tmp_path / "x.cfrk.gz"
    with tfmt.CfrkWriter(str(out)) as w:
        w.write_pairs(idx, cnt)
    assert gzip.decompress(out.read_bytes()) == tfmt.format_pairs_bytes(idx, cnt)


@pytest.mark.parametrize("nonzero", [False, True], ids=["dense", "nonzero"])
@pytest.mark.parametrize("target", ["handle", "path"])
def test_continuing_writer_resumes_mid_file(tmp_path, target, nonzero):
    """``continuing=True``: rows already exist, so the first row written
    is preceded by a newline.  A handle opened at the end of the first
    part yields the one-shot file's bytes; a path is opened anew, so it
    holds the newline and the remaining rows.  Both as cfrk_tpu's writer."""
    counts = np.random.default_rng(5).integers(0, 3, size=(9, 16)).astype(np.int32)
    whole = io.BytesIO()
    with tfmt.CfrkWriter(whole, nonzero=nonzero) as w:
        w.write_batch(counts)
    got = {}
    for name, fmt in (("torch", tfmt), ("jax", jfmt)):
        out = tmp_path / f"{name}.cfrk"
        with fmt.CfrkWriter(str(out), nonzero=nonzero) as w:
            w.write_batch(counts[:4])
        head = out.read_bytes()
        if target == "handle":
            with open(out, "r+b") as f:
                f.seek(len(head))
                w = fmt.CfrkWriter(f, continuing=True, nonzero=nonzero)
                w.write_batch(counts[:0])
                w.write_batch(counts[4:6])
                w.write_batch(counts[6:])
            got[name] = out.read_bytes()
        else:
            with fmt.CfrkWriter(str(out), continuing=True, nonzero=nonzero) as w:
                w.write_batch(counts[4:])
            got[name] = head + out.read_bytes()
    assert got["torch"] == got["jax"] == whole.getvalue()


@pytest.mark.parametrize("first_empty", [False, True])
def test_nonzero_writer_matches_jax(first_empty):
    """CfrkWriter(nonzero=True).write_batch: the nonzero cells of dense
    rows, empty rows kept, across batches and row slabs."""
    rng = np.random.default_rng(int(first_empty))
    counts = rng.integers(0, 5, size=(17, 64)).astype(np.int32)
    counts[rng.random(counts.shape) < 0.7] = 0
    counts[::4] = 0
    if first_empty:
        counts[:3] = 0
    buf_t, buf_j = io.BytesIO(), io.BytesIO()
    with tfmt.CfrkWriter(buf_t, nonzero=True) as tw, jfmt.CfrkWriter(buf_j, nonzero=True) as jw:
        for w in (tw, jw):
            w.write_batch(counts[:0])
            w.write_batch(counts[:5])
            w.write_batch(counts[5:])
    assert buf_t.getvalue() == buf_j.getvalue()
    small = io.BytesIO()
    with tfmt.CfrkWriter(small, nonzero=True) as w:
        for row in counts:  # one-row batches: every slab boundary
            w.write_batch(row[None])
    assert small.getvalue() == buf_j.getvalue()


def test_dense_to_pairs_matches_jax():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 3, size=(9, 16)).astype(np.int32)
    counts[2] = 0
    for block in (counts, np.zeros((4, 16), np.int32)):
        for g, w in zip(tfmt._dense_to_pairs(block), jfmt._dense_to_pairs(block)):
            np.testing.assert_array_equal(g, w)


def test_parse_cfrk_matches_jax():
    counts = np.arange(3 * 16, dtype=np.int32).reshape(3, 16) % 7
    data = tfmt.format_file_bytes(counts)
    np.testing.assert_array_equal(tfmt.parse_cfrk(data), jfmt.parse_cfrk(data))
    np.testing.assert_array_equal(tfmt.parse_cfrk(data), counts)
    assert tfmt.parse_cfrk(data).dtype == np.int64
    for bad, msg in ((b"0:1 2:3 ", "non-dense"), (b"0:1 1:2 \n0:1 ", "ragged")):
        for parse in (tfmt.parse_cfrk, jfmt.parse_cfrk):
            with pytest.raises(ValueError, match=msg):
                parse(bad)


@pytest.mark.parametrize("name", ["seq1.fasta.gz", "seq2.fasta.gz"])
def test_read_fasta_encoded_matches_jax(name):
    got = tfasta.read_fasta_encoded(DATA / name)
    want = jfasta.read_fasta_encoded(DATA / name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("min_qual", [0, 20])
def test_fastq_and_multiline_fasta_match_jax(tmp_path, min_qual):
    fq = tmp_path / "r.fastq"
    fq.write_bytes(
        b"\n@a\nACGTNACGTT\n+\nIIII#II!II\n@b desc\nggccaa\n+x\n5555I5\n"
    )
    fa = tmp_path / "r.fa"
    fa.write_bytes(b">x\nACG\r\nTTN\n\n>y\n>z\nacgtRYac\n")
    for path in (fq, fa):
        got = tfasta.read_fasta_encoded(path, min_qual)
        want = jfasta.read_fasta_encoded(path, min_qual)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    bad = tmp_path / "bad.fastq"
    bad.write_bytes(b"@a\nACGT\n+\nII\n")
    with pytest.raises(ValueError, match="quality length"):
        tfasta.read_fasta_encoded(bad)


def test_batches_match_jax():
    rng = np.random.default_rng(5)
    reads = [
        rng.integers(-1, 4, size=int(n)).astype(np.int8)
        for n in rng.integers(1, 700, size=23)
    ]
    for bs, ml in ((8, None), (5, 768), (23, None)):
        got = list(tbatch.iter_batches(reads, bs, ml))
        want = list(jbatch.iter_batches(reads, bs, ml))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.codes, w.codes)
            np.testing.assert_array_equal(g.lengths, w.lengths)
            assert g.n_reads == w.n_reads
    assert tbatch.len_bucket(129) == jbatch.len_bucket(129) == 256
    assert tbatch.round_up(150, 128) == 256
    assert tbatch.auto_batch_size() == 8192
    with pytest.raises(ValueError, match="exceeds max_len"):
        tbatch.pad_reads(reads, 64, 8)
