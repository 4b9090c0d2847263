"""The port's host library (``cfrk_tpu_torch.io.native`` over
``csrc/fastaio.cpp``) against ``cfrk_tpu.io.native`` and the port's own
numpy / Python oracles: exact equality, no tolerance.

The library is built here by the host C++ compiler at its first call,
as on the GPU machine.  Each test of ``tests/test_native.py`` has its
counterpart here (that file's fallback tests become oracle tests: the
port has no fallback), and the inputs are made from a seed with numpy.
"""

import gzip
import hashlib
import io
import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from cfrk_tpu.format import format_file_bytes as jax_format_file_bytes
from cfrk_tpu.format import format_rows_pairs as jax_format_rows_pairs
from cfrk_tpu.io import fasta as jfasta
from cfrk_tpu.io import native as jnative
from cfrk_tpu.ops.sparse import decode_key as jax_decode_key
from cfrk_tpu.pipeline import batch as jbatch
from cfrk_tpu.pipeline import stream as jstream
from cfrk_tpu.runtime import faults as jfaults
from cfrk_tpu_torch import format as tfmt
from cfrk_tpu_torch.io import fasta as tfasta
from cfrk_tpu_torch.io import native as N
from cfrk_tpu_torch.io.bgzf import write_bgzf
from cfrk_tpu_torch.ops import sparse as tsparse
from cfrk_tpu_torch.ops.cuda import build
from cfrk_tpu_torch.pipeline import batch as tbatch
from cfrk_tpu_torch.pipeline import count as tcount
from cfrk_tpu_torch.pipeline import stream as tstream

DATA = Path(__file__).parent / "data"
MANIFEST = json.loads((DATA / "goldens.json").read_text())
_BASES = np.frombuffer(b"ACGTNacgt", dtype=np.uint8)

MESSY_FASTA = (
    b">r0 header with spaces\n"
    b"ACGTACGT\n"
    b"NNACGT\r\n"           # multi-line record, CRLF, ambiguity codes
    b"\n"                   # blank line inside a record
    b">r1\nacgtn\n"         # lower case
    b">empty\n"             # empty record
    b">r2\nTTTT"            # no trailing newline
)


def _as_lists(reads):
    return [np.asarray(r).tolist() for r in reads]


def _iter(data: bytes, min_qual: int):
    """The port's Python record loop over a buffer."""
    head = data.lstrip(b"\r\n")[:1]
    f = io.BytesIO(data)
    recs = tfasta.iter_fastq(f, min_qual) if head == b"@" else tfasta.iter_fasta(f)
    return [tfasta.encode_seq(s) for _, s in recs]


def _random_records(rng, n, lo, hi, alphabet=_BASES):
    return [bytes(rng.choice(alphabet, size=int(rng.integers(lo, hi)))) for _ in range(n)]


def _fasta_bytes(records, wrap=None, crlf=False):
    nl = b"\r\n" if crlf else b"\n"
    out = []
    for i, r in enumerate(records):
        out.append(b">read%d" % i + nl)
        step = wrap or max(len(r), 1)
        for j in range(0, len(r), step):
            out.append(r[j : j + step] + nl)
    return b"".join(out)


def _fastq_bytes(records, rng, crlf=False):
    nl = b"\r\n" if crlf else b"\n"
    out = []
    for i, r in enumerate(records):
        qual = bytes((33 + rng.integers(0, 42, size=len(r))).astype(np.uint8))
        out.append(b"@read%d" % i + nl + r + nl + b"+" + nl + qual + nl)
    return b"".join(out)


def _blocks_to_records(blocks):
    codes, offs = [], []
    for flat, lens, end in blocks:
        starts = np.concatenate(([0], np.cumsum(lens)))
        codes += [flat[starts[i] : starts[i + 1]].tolist() for i in range(len(lens))]
        offs += end.tolist()
    return codes, offs


# ---------------------------------------------------------------- parse


def test_parse_encode_matches_python_messy():
    got = N.parse_encode_bytes(MESSY_FASTA)
    want = _iter(MESSY_FASTA, 0)
    assert len(got) == 4
    assert _as_lists(got) == _as_lists(want) == _as_lists(jnative.parse_encode_bytes(MESSY_FASTA))
    assert all(g.dtype == np.int8 for g in got)


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_native_parser_on_golden_samples(name):
    native = N.read_fasta_encoded_native(DATA / name)
    assert _as_lists(native) == _as_lists(tfasta.iter_fasta_encoded(DATA / name))
    assert _as_lists(native) == _as_lists(jfasta.read_fasta_encoded(DATA / name))
    assert _as_lists(tfasta.read_fasta_encoded(DATA / name)) == _as_lists(native)


def test_native_golden_sha256():
    """Native parse + the port's count + native format == golden bytes."""
    name, meta = sorted(MANIFEST["files"].items())[1]  # seq2: small
    reads = N.read_fasta_encoded_native(DATA / name)
    counts = tcount.count_reads(reads, MANIFEST["k"], device="cpu")
    data = N.format_rows_bytes(counts)
    assert hashlib.sha256(data).hexdigest() == meta["sha256"]


def test_native_parser_is_the_route():
    """The whole-file reader parses through the library (its counter
    moves) and agrees with the Python loop on a large buffer."""
    rng = np.random.default_rng(1)
    data = _fasta_bytes(_random_records(rng, 2000, 200, 201, _BASES[:4]))
    path_calls = N.parse_encode_bytes.calls
    got = N.parse_encode_bytes(data)
    assert N.parse_encode_bytes.calls == path_calls + 1
    assert _as_lists(got) == _as_lists(_iter(data, 0))


@pytest.mark.parametrize(
    "data",
    [
        b"@r0\nACGTN\n+\nIIIII\n@r1\nGGCC\n+\nIIII\n",
        b"\n\r\n@r0\nACGTN\n+\nIIIII\n\n@r1\nGGCC\n+\nIIII",  # blank lead, no final LF
        b"@r0\r\nACGTN\r\n+\r\nIIIII\r\n@r1\r\nGGCC\r\n+\r\nIIII\r\n",
        b"\n>r0\nACG\n",
    ],
    ids=["fastq", "blank_lines", "crlf", "fasta_blank_lead"],
)
def test_parse_encode_sniffs_format(data):
    """FASTA vs FASTQ by the first non-blank byte, as the Python loop."""
    got = N.parse_encode_bytes(data)
    assert _as_lists(got) == _as_lists(_iter(data, 0))
    assert _as_lists(got) == _as_lists(jnative.parse_encode_bytes(data))


def test_native_fastq_empty_read_stays_in_sync():
    """Zero-length reads (quality-trimmed FASTQ) keep the 4-line cycle."""
    data = b"@r1\nACGT\n+\nIIII\n@r2\n\n+\n\n@r3\nGGTT\n+\nIIII\n"
    reads = N.parse_encode_bytes(data)
    assert _as_lists(reads) == [[0, 1, 2, 3], [], [2, 2, 3, 3]]
    blocks = list(N.iter_record_blocks_native(io.BytesIO(data), block_size=7))
    assert _blocks_to_records(blocks)[0] == [[0, 1, 2, 3], [], [2, 2, 3, 3]]


_BAD_FASTQ = {
    "missing '+' line": b"@r1\nACGT\nIIII\n@r2\nGG\n+\nII\n",
    "quality length mismatch": b"@r1\nACGT\n+\nIII\n",
    "malformed FASTQ header": b"@r1\nACGT\n+\nIIII\nr2\nGG\n+\nII\n",
    "truncated": b"@r1\nACGT\n",
}
_BAD_TEXT = {
    "missing '+' line": "malformed FASTQ record: missing '+' line",
    "quality length mismatch": "malformed FASTQ record: quality length mismatch",
    "malformed FASTQ header": "malformed FASTQ header",
    "truncated": "malformed FASTQ record: missing '+' line",
}


@pytest.mark.parametrize("case", sorted(_BAD_FASTQ))
def test_native_fastq_validation_matches_python(case, tmp_path):
    """Malformed FASTQ raises ValueError with the JAX package's native
    text from both parsers, where the Python loop raises too."""
    data = _BAD_FASTQ[case]
    with pytest.raises(ValueError):
        _iter(data, 0)
    with pytest.raises(ValueError) as e:
        N.parse_encode_bytes(data)
    assert str(e.value) == _BAD_TEXT[case]
    p = tmp_path / "bad.fastq"
    p.write_bytes(data)
    for block in (4, 1 << 20):
        with pytest.raises(ValueError) as e:
            list(N.iter_record_blocks_native(p, block_size=block))
        assert str(e.value) == _BAD_TEXT[case]


def test_native_fastq_trailing_bare_cr_matches_python(tmp_path):
    """A stray final '\\r' after the last record is an empty line the
    Python parser skips; the chunked parser takes it at EOF and keeps it
    in the carry before EOF."""
    data = b"@r1\nACGT\n+\nIIII\n\r"
    assert _as_lists(_iter(data, 0)) == [[0, 1, 2, 3]]
    p = tmp_path / "cr.fastq"
    p.write_bytes(data)
    for block in (3, 1 << 20):
        codes, offs = _blocks_to_records(N.iter_record_blocks_native(p, block_size=block))
        assert codes == [[0, 1, 2, 3]] and offs == [len(data) - 1]
    assert _as_lists(N.parse_encode_bytes(data)) == [[0, 1, 2, 3]]


@pytest.mark.parametrize("q", [0, 1, 20, 41])
def test_native_min_qual_matches_python(tmp_path, q):
    """Quality masking: both native parsers mask exactly the bases the
    Python loop masks, over qualities spanning the Phred+33 range."""
    rng = np.random.default_rng(3)
    buf = _fastq_bytes(_random_records(rng, 61, 0, 120), rng)
    p = tmp_path / "q.fastq"
    p.write_bytes(buf)
    want = _as_lists(_iter(buf, q))
    assert _as_lists(N.parse_encode_bytes(buf, q)) == want
    assert _as_lists(jnative.parse_encode_bytes(buf, q)) == want
    got, _ = _blocks_to_records(N.iter_record_blocks_native(p, block_size=64, min_qual=q))
    assert got == want
    assert _as_lists(c for c, _ in tfasta.iter_encoded_with_offsets(p, min_qual=q)) == want


# ------------------------------------------------------ chunked parser


def _messy_inputs(rng):
    recs = _random_records(rng, 97, 1, 300)
    recs[5] = b""
    recs[40] = bytes(rng.choice(_BASES, size=2000))  # larger than small blocks
    fq_recs = list(recs)
    return {
        "fasta_wrapped": _fasta_bytes(recs, wrap=61),
        "fasta_crlf_blank": _fasta_bytes(recs, wrap=70, crlf=True).replace(
            b">read9\r\n", b"\n>read9\r\n\n"),
        "fasta_no_final_lf": _fasta_bytes(recs)[:-1],
        "fastq": _fastq_bytes(fq_recs, rng),
        "fastq_crlf_cr_tail": _fastq_bytes(fq_recs, rng, crlf=True) + b"\r",
        "fastq_blank_lines": _fastq_bytes(fq_recs, rng).replace(b"@read7\n", b"\n\n@read7\n"),
    }


@pytest.mark.parametrize("fmt", ["fasta_wrapped", "fasta_crlf_blank", "fasta_no_final_lf",
                                 "fastq", "fastq_crlf_cr_tail", "fastq_blank_lines"])
@pytest.mark.parametrize("block", [16, 100, 1 << 20])
def test_chunked_stream_parser_matches_python(tmp_path, fmt, block):
    """iter_record_blocks_native reproduces iter_encoded_with_offsets
    (records AND byte offsets) across block edges: blocks smaller than
    one record (the block doubles), CRLF, blank lines, empty reads, a
    bare trailing CR."""
    data = _messy_inputs(np.random.default_rng(0))[fmt]
    p = tmp_path / ("x.fastq" if fmt.startswith("fastq") else "x.fasta")
    p.write_bytes(data)
    want = list(tfasta.iter_encoded_with_offsets(p))
    jwant = list(jfasta.iter_encoded_with_offsets(p))
    codes, offs = _blocks_to_records(N.iter_record_blocks_native(p, block_size=block))
    assert codes == _as_lists(c for c, _ in want) == _as_lists(c for c, _ in jwant)
    assert offs == [o for _, o in want] == [o for _, o in jwant]


@pytest.mark.parametrize("kind", ["plain", "bgzf", "gzip"])
def test_chunked_parser_offsets_and_ranges(tmp_path, kind):
    """start_offset / limit_offset at record starts: plain and bgzf
    offsets are resume points (bgzf ones decompressed positions), a
    plain gzip refuses them and streams whole with decompress=True."""
    rng = np.random.default_rng(4)
    data = _fasta_bytes(_random_records(rng, 40, 10, 200), wrap=50)
    plain = tmp_path / "x.fasta"
    plain.write_bytes(data)
    ends = [o for _, o in tfasta.iter_encoded_with_offsets(plain)]
    reads = _as_lists(c for c, _ in tfasta.iter_encoded_with_offsets(plain))
    path, decompress = plain, False
    if kind == "bgzf":
        path, decompress = tmp_path / "x.fasta.gz", True
        write_bgzf(path, data, block=300)
    elif kind == "gzip":
        path, decompress = tmp_path / "x.fasta.gz", True
        path.write_bytes(gzip.compress(data))
    whole = _blocks_to_records(N.iter_record_blocks_native(
        path, block_size=64, decompress=decompress))
    assert whole == (reads, ends)
    if kind == "gzip":
        for kw in ({"start_offset": ends[3]}, {"limit_offset": ends[9]}):
            with pytest.raises(ValueError, match="byte offsets cannot address a gzip"):
                list(N.iter_record_blocks_native(path, decompress=True, **kw))
        return
    for i, j in ((3, None), (None, 9), (3, 9), (0, 1), (38, None)):
        kw = dict(start_offset=None if i is None else ends[i],
                  limit_offset=None if j is None else ends[j])
        codes, offs = _blocks_to_records(N.iter_record_blocks_native(
            path, block_size=64, decompress=decompress, **kw))
        lo, hi = (0 if i is None else i + 1), (len(reads) if j is None else j + 1)
        assert codes == reads[lo:hi] and offs == ends[lo:hi], (i, j)


def test_chunked_stream_parser_start_offset(tmp_path):
    """Resume from a checkpointed offset: the records after it."""
    p = tmp_path / "x.fasta"
    p.write_bytes(b">a\nACGT\n>b\nGGTT\nAAC\n>c\nTT\n")
    reads, offs = _blocks_to_records(N.iter_record_blocks_native(p))
    resumed, roffs = _blocks_to_records(N.iter_record_blocks_native(p, start_offset=offs[0]))
    assert resumed == reads[1:] and roffs == offs[1:]


def test_chunked_parser_open_stream():
    """An open binary stream is read sequentially and closed at EOF; it
    refuses random access."""
    rng = np.random.default_rng(8)
    data = _fasta_bytes(_random_records(rng, 30, 5, 90))
    f = io.BytesIO(data)
    codes, offs = _blocks_to_records(N.iter_record_blocks_native(f, block_size=50))
    assert codes == _as_lists(_iter(data, 0)) and offs[-1] == len(data) and f.closed
    with pytest.raises(ValueError, match="no random access"):
        list(N.iter_record_blocks_native(io.BytesIO(data), start_offset=5))


# ------------------------------------------------------------- batches


def test_pad_reads_flat_matches_pad_reads():
    rng = np.random.default_rng(5)
    reads = [rng.integers(-1, 4, size=int(rng.integers(0, 40))).astype(np.int8)
             for _ in range(23)]
    flat = np.concatenate(reads)
    lens = np.array([len(r) for r in reads], dtype=np.int64)
    calls = N.pack_records.calls
    got = tbatch.pad_reads_flat(flat, lens, 32, 64)
    assert N.pack_records.calls == calls + 1
    for want in (tbatch.pad_reads(reads, 32, 64), jbatch.pad_reads_flat(flat, lens, 32, 64)):
        np.testing.assert_array_equal(got.codes, want.codes)
        np.testing.assert_array_equal(got.lengths, want.lengths)
        assert got.n_reads == want.n_reads and got.codes.dtype == np.int8
    with pytest.raises(ValueError, match="do not sum"):
        tbatch.pad_reads_flat(flat[:-1], lens, 32, 64)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tbatch.pad_reads_flat(flat, lens, 32, 8)
    with pytest.raises(ValueError, match="batch_size"):
        tbatch.pad_reads_flat(flat, lens, 8, 64)


@pytest.mark.parametrize(
    "lens,rows,row_len,text",
    [([3, 2], 1, 8, "more records than batch rows"),
     ([3, 9], 2, 8, "record longer than row_len"),
     ([3, 2], 2, 8, "lengths do not sum to the flat buffer size")],
)
def test_pack_records_errors(lens, rows, row_len, text):
    """The library's own checks raise cfrk_tpu's texts."""
    flat = np.arange(sum(lens) - (text.startswith("lengths")), dtype=np.int8)
    with pytest.raises(ValueError) as e:
        N.pack_records(flat, np.array(lens), rows, row_len)
    assert str(e.value) == text
    got = N.pack_records(np.arange(5, dtype=np.int8), [2, 3], 3, 4)
    assert got.tolist() == [[0, 1, -1, -1], [2, 3, 4, -1], [-1] * 4]


def test_stream_batches_native_vs_python_parity(tmp_path):
    """stream_batches (native flat ingest) == the per-record loop ==
    cfrk_tpu's stream_batches, batch by batch."""
    rng = np.random.default_rng(9)
    p = tmp_path / "x.fasta"
    p.write_bytes(_fasta_bytes(_random_records(rng, 37, 1, 200, _BASES[:5])))
    native = list(tstream.stream_batches(p, 5, 8))
    python = list(tstream._record_batches(p, 5, 8))
    jax = list(jstream.stream_batches(p, 5, 8))
    assert len(native) == len(python) == len(jax) == 5
    for a, b, c in zip(native, python, jax):
        for x in (b, c):
            np.testing.assert_array_equal(a.codes, x.codes)
            np.testing.assert_array_equal(a.lengths, x.lengths)
            assert (a.n_reads, a.end_offset) == (x.n_reads, x.end_offset)
        assert a.batch_size == 8  # the tail batch keeps the full shape


@pytest.mark.parametrize("kind", ["fasta", "fastq", "gzip", "bgzf"])
def test_stream_batches_skip_and_offsets(tmp_path, kind):
    """skip_reads (block-wise) and the resume offsets of every input kind
    equal the per-record loop's; plain gzip carries no offsets."""
    rng = np.random.default_rng(11)
    recs = _random_records(rng, 50, 1, 150, _BASES[:5])
    data = _fastq_bytes(recs, rng) if kind == "fastq" else _fasta_bytes(recs, wrap=40)
    p = tmp_path / ("x.fastq" if kind == "fastq" else "x.fasta")
    p.write_bytes(data)
    if kind == "gzip":
        p = tmp_path / "x.fa.gz"
        p.write_bytes(gzip.compress(data))
    elif kind == "bgzf":
        p = tmp_path / "x.fa.gz"
        write_bgzf(p, data, block=500)
    for kw in ({}, {"skip_reads": 13}, {"skip_reads": 49}, {"skip_reads": 60}):
        got = list(tstream.stream_batches(p, 4, 6, **kw))
        want = list(tstream._record_batches(p, 4, 6, **kw))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.codes, b.codes)
            assert (a.n_reads, a.end_offset) == (b.n_reads, b.end_offset)
            assert (a.end_offset is None) == (kind == "gzip")


# ----------------------------------------------------------- formatters


@pytest.mark.parametrize("first", [True, False])
def test_format_rows_bytes_matches_python(first):
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 2**31 - 1, size=(37, 16)).astype(np.int32)
    got = N.format_rows_bytes(counts, first=first)
    lead = b"" if first else b"\n"
    assert got == tfmt.format_rows_bytes(counts, first=first)
    assert got == lead + jax_format_file_bytes(counts)
    assert got == jnative.format_rows_bytes(counts, first=first)


def test_format_rows_bytes_extremes():
    counts = np.array([[0, 1, 2147483647, 0]], dtype=np.int32)
    assert N.format_rows_bytes(counts) == b"0:0 1:1 2:2147483647 3:0 "
    wide = np.array([[0, 2**40, 0], [7, 0, 2**63 - 1]], dtype=np.int64)
    assert N.format_rows_bytes(wide) == tfmt.format_rows_bytes(wide) == (
        b"0:0 1:1099511627776 2:0 \n0:7 1:0 2:9223372036854775807 ")
    assert N.format_rows_bytes(np.zeros((0, 4), np.int32)) == b""
    with pytest.raises(ValueError, match="2-D"):
        N.format_rows_bytes(np.zeros(4, np.int32))


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("what", ["rows", "pairs", "dense_pairs", "pairs64", "kmer_tsv"])
def test_format_parallel_path_parity(what, first):
    """Outputs past ~4 MB format on several threads (row-contiguous
    segments); the bytes equal the numpy formatter's, leading-newline
    framing of every segment's first row included."""
    rng = np.random.default_rng(1)
    if what == "rows":
        counts = rng.integers(0, 150, size=(60000, 16)).astype(np.int32)
        got, want = (f(counts, first=first) for f in (N.format_rows_bytes,
                                                      tfmt.format_rows_bytes))
    elif what == "kmer_tsv":
        keys = np.sort(rng.integers(0, 4**31, 300_000, dtype=np.uint64))
        counts = rng.integers(0, 9, keys.size)
        got = N.format_kmer_tsv_bytes(keys, counts, 31, 1 if first else 3)
        want = tfmt.format_kmer_tsv_bytes(keys, counts, 31, 1 if first else 3)
    else:
        top = 2**62 if what == "pairs64" else 65536
        idx = np.sort(rng.integers(0, top, size=(8192, 143), dtype=np.uint64), axis=1)
        cnt = rng.integers(0, 4, size=idx.shape).astype(np.int32)
        if what != "pairs64":
            idx = idx.astype(np.int32)
        if what == "dense_pairs":
            idx, cnt = idx[:600] % 4096, cnt[:600]
            idx.sort(axis=1)
            cnt[:, 1:][idx[:, 1:] == idx[:, :-1]] = 0  # one cell a bin
            got = N.format_dense_pairs_bytes(idx, cnt, 4096, first=first)
            want = tfmt.format_dense_pairs_bytes(idx, cnt, 4096, first=first)
        else:
            got = N.format_pairs_bytes(idx, cnt, first=first)
            want = tfmt.format_pairs_bytes(idx, cnt, first=first)
    assert len(got) > 4 << 20 and got == want


@pytest.mark.parametrize("first", [True, False])
def test_format_pairs_bytes_matches_python(first):
    rng = np.random.default_rng(0)
    idx = np.sort(rng.integers(0, 1000, size=(9, 12)), axis=1).astype(np.int32)
    counts = rng.integers(0, 4, size=(9, 12)).astype(np.int32)  # zeros mixed in
    lead = b"" if first else b"\n"
    want = lead + b"\n".join(jax_format_rows_pairs(idx, counts))
    assert N.format_pairs_bytes(idx, counts, first=first) == want
    assert tfmt.format_pairs_bytes(idx, counts, first=first) == want
    # The narrowed drain dtypes: uint16 idx with the wrapped sentinel (0,
    # count 0) and uint8 counts give the same bytes.
    idx16, cnt8 = idx.astype(np.uint16), counts.astype(np.uint8)
    idx16[counts == 0] = 0
    assert N.format_pairs_bytes(idx16, cnt8, first=first) == want


@pytest.mark.parametrize("first", [True, False])
def test_format_dense_pairs_matches_dense_formatter(first):
    """Dense-from-pairs == the dense formatter on the densified matrix,
    with count-0 cells anywhere in a row."""
    rng = np.random.default_rng(7)
    n, w, fk = 11, 9, 64
    dense = np.zeros((n, fk), np.int32)
    idx = np.full((n, w), fk, np.int32)
    cnt = np.zeros((n, w), np.int32)
    for r in range(n):
        m = int(rng.integers(0, w + 1))
        cols = np.sort(rng.choice(fk, size=m, replace=False))
        vals = rng.integers(1, 100, size=m).astype(np.int32)
        dense[r, cols] = vals
        pos = np.sort(rng.choice(w, size=m, replace=False))
        idx[r, pos] = cols
        cnt[r, pos] = vals
    got = N.format_dense_pairs_bytes(idx, cnt, fk, first=first)
    assert got == N.format_rows_bytes(dense, first=first)
    assert got == tfmt.format_rows_bytes(dense, first=first)
    assert got == jnative.format_dense_pairs_bytes(idx, cnt, fk, first=first)


def test_format_pairs64_matches_python():
    """uint64 combined codes at k = 31, among them a 16-T hi prefix
    (hi == 0xFFFFFFFF, the uint32 sentinel of the JAX kernels)."""
    rng = np.random.default_rng(1)
    idx = np.sort(rng.integers(0, 4**31, size=(7, 9), dtype=np.uint64), axis=1)
    idx[3, -1] = (np.uint64(0xFFFFFFFF) << np.uint64(30)) | np.uint64(12345)
    counts = rng.integers(0, 3, size=(7, 9)).astype(np.int32)
    counts[3, -1] = 2
    want = b"\n".join(jax_format_rows_pairs(idx, counts))
    for first, lead in ((True, b""), (False, b"\n")):
        assert N.format_pairs_bytes(idx, counts, first=first) == lead + want
        assert tfmt.format_pairs_bytes(idx, counts, first=first) == lead + want
    assert b"%d:2 " % int(idx[3, -1]) in want


@pytest.mark.parametrize("k", [1, 8, 15, 16, 31, 32])
def test_format_kmer_tsv_native_matches_python(k):
    """``KMER<TAB>count`` lines equal the decode_key line loop of
    cfrk_tpu's CLI and the numpy oracle, min_count filters and counts
    past 32 bits included."""
    rng = np.random.default_rng(21)
    keys = np.sort(rng.integers(0, 4**min(k, 31), 500, dtype=np.uint64))
    counts = rng.integers(0, 5, 500).astype(np.int64)
    counts[7] = 10**12
    for mc in (1, 2):
        want = "".join(f"{jax_decode_key(int(key), k)}\t{cnt}\n"
                       for key, cnt in zip(keys.tolist(), counts.tolist())
                       if cnt >= mc).encode()
        assert N.format_kmer_tsv_bytes(keys, counts, k, mc) == want
        assert tfmt.format_kmer_tsv_bytes(keys, counts, k, mc) == want
    with pytest.raises(ValueError, match="k out of range"):
        N.format_kmer_tsv_bytes(keys, counts, 33)
    with pytest.raises(ValueError, match="size mismatch"):
        N.format_kmer_tsv_bytes(keys, counts[:-1], k)


# ----------------------------------------------------------------- fold


@pytest.mark.parametrize("idt", [np.uint16, np.int32, np.uint32, np.int64])
@pytest.mark.parametrize("cdt", [np.uint8, np.int16, np.int32, np.int64])
def test_fold_pairs_into_native_vs_oracle(idt, cdt):
    """The threaded fold (more than 2**20 cells: private tables) over
    every drain dtype pair equals the numpy oracle and cfrk_tpu's fold,
    sentinel cells (count 0, the uint16 sentinel wrapped to 0) and
    out-of-table cells skipped."""
    rng = np.random.default_rng(9)
    k, n = 8, (1 << 20) + 4097
    base_idx = rng.integers(0, 4**k, size=n)
    base_cnt = rng.integers(0, 5, size=n)
    base_idx[:50] = 0
    base_cnt[:50] = 0
    if idt in (np.int32, np.int64):
        base_idx[50] = 4**k  # out of the table with a positive count
        base_cnt[50] = 3
    idx, cnt = base_idx.astype(idt), base_cnt.astype(cdt)
    got, want, jwant = (np.full(4**k, 5, np.int64) for _ in range(3))
    calls = N.fold_pairs_into.calls
    N.fold_pairs_into(got, idx, cnt)
    assert N.fold_pairs_into.calls == calls + 1
    tsparse.fold_pairs_into(want, idx, cnt)
    jnative.fold_pairs_into(jwant, idx, cnt)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jwant)
    small = np.zeros(4**k, np.int64)
    N.fold_pairs_into(small, idx[:999], cnt[:999])  # serial path
    ref = np.zeros(4**k, np.int64)
    tsparse.fold_pairs_into(ref, idx[:999], cnt[:999])
    np.testing.assert_array_equal(small, ref)


def test_fold_pairs_rejects_bad_tables_and_f_order():
    """Column-major inputs fold to the C-order table (the wrapper copies;
    the TPU tunnel's zero-copy transpose is not carried over), and a
    table that is not a writable contiguous int64 array raises."""
    rng = np.random.default_rng(33)
    idx = rng.integers(0, 4**9, size=(512, 142)).astype(np.int32)
    cnt = rng.integers(0, 3, size=(512, 142)).astype(np.uint8)
    t1, t2, t3 = (np.zeros(4**9, np.int64) for _ in range(3))
    N.fold_pairs_into(t1, idx, cnt)
    N.fold_pairs_into(t2, np.asfortranarray(idx), np.asfortranarray(cnt))
    N.fold_pairs_into(t3, np.asfortranarray(idx), cnt)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(t1, t3)
    for bad in (np.zeros(64, np.int32), np.zeros(128, np.int64)[::2]):
        with pytest.raises(ValueError, match="int64"):
            N.fold_pairs_into(bad, idx, cnt)
    with pytest.raises(ValueError, match="size mismatch"):
        N.fold_pairs_into(t1, idx, cnt[:-1])


def test_fetched_to_triples_f_order_views():
    rng = np.random.default_rng(34)
    idx = rng.integers(0, 100, size=(16, 9)).astype(np.int32)
    cnt = rng.integers(0, 3, size=(16, 9)).astype(np.uint8)
    _, lo0, c0 = tsparse.fetched_to_triples([idx, cnt], 9)
    _, loF, cF = tsparse.fetched_to_triples(
        [np.asfortranarray(idx), np.asfortranarray(cnt)], 9)
    assert sorted(zip(lo0.tolist(), c0.tolist())) == sorted(zip(loF.tolist(), cF.tolist()))
    a, b = tsparse.DenseFoldAccumulator(5), tsparse.DenseFoldAccumulator(5)
    a.add(None, lo0, c0)
    b.add(None, loF, cF)
    np.testing.assert_array_equal(a.table, b.table)


# ------------------------------------------------- routes and the build


def _reset_counts():
    for fn in N.COUNTED:
        fn.calls = 0


def _calls():
    return {fn.__name__: fn.calls for fn in N.COUNTED}


def test_drivers_take_the_native_route(tmp_path, monkeypatch):
    """CfrkWriter, read_fasta_encoded, the dense fold, pad_reads_flat,
    the streamed ingest and the sparse tsv writer each call the library
    (its counters move), with bytes equal to cfrk_tpu's."""
    from cfrk_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)  # no cfrk.json around the checkout applies

    rng = np.random.default_rng(12)
    fa = tmp_path / "r.fa"
    fa.write_bytes(_fasta_bytes(_random_records(rng, 40, 20, 120, _BASES[:5])))
    _reset_counts()
    assert main([str(fa), str(tmp_path / "a.cfrk"), "4", "--device", "cpu"]) == 0
    after = _calls()
    assert after["parse_encode_bytes"] == 1 and after["format_dense_pairs_bytes"] >= 1
    assert main([str(fa), str(tmp_path / "b.cfrk"), "9", "--nonzero", "--stream",
                 "--device", "cpu", "--batch-size", "16"]) == 0
    after = _calls()
    assert after["iter_record_blocks_native"] >= 1 and after["pack_records"] == 3
    assert after["format_pairs_bytes"] == 3
    assert main([str(fa), "-o", str(tmp_path / "c.tsv"), "-k", "9", "--mode", "sparse",
                 "--device", "cpu"]) == 0
    assert _calls()["format_kmer_tsv_bytes"] == 1
    assert main([str(fa), "-o", str(tmp_path / "d.sp"), "-k", "5", "--mode", "spectrum",
                 "--impl", "sort", "--device", "cpu"]) == 0
    assert _calls()["fold_pairs_into"] >= 1
    assert main([str(fa), str(tmp_path / "e.cfrk"), "3", "--impl", "scatter",
                 "--device", "cpu"]) == 0
    assert _calls()["format_rows_bytes"] >= 1
    for name, args in (("b.cfrk", ["9", "--nonzero"]), ("e.cfrk", ["3"])):
        jout = tmp_path / f"jax_{name}"
        jstream.stream_count_file(fa, jout, int(args[0]), nonzero="--nonzero" in args)
        assert (tmp_path / name).read_bytes() == jout.read_bytes()


@pytest.mark.parametrize("kind", ["fasta", "fastq", "gzip", "bgzf"])
def test_file_bytes_native_vs_python_record_loop(tmp_path, monkeypatch, kind):
    """stream_count_file and count_file_sparse_rows write the same bytes
    through the native ingest as through the Python record loops."""
    rng = np.random.default_rng(13)
    recs = _random_records(rng, 33, 10, 160, _BASES[:5])
    data = _fastq_bytes(recs, rng) if kind == "fastq" else _fasta_bytes(recs, wrap=77)
    p = tmp_path / ("r.fastq" if kind == "fastq" else "r.fa")
    p.write_bytes(data)
    if kind == "gzip":
        p = tmp_path / "r.fa.gz"
        p.write_bytes(gzip.compress(data))
    elif kind == "bgzf":
        p = tmp_path / "r.fa.gz"
        write_bgzf(p, data, block=400)
    mq = 20 if kind == "fastq" else 0

    def run(tag):
        a, b = tmp_path / f"s_{tag}.cfrk", tmp_path / f"c_{tag}.cfrk"
        tstream.stream_count_file(p, a, 8, device="cpu", nonzero=True, batch_size=8,
                                  min_qual=mq)
        tcount.count_file_sparse_rows(p, b, 8, device="cpu", batch_size=8, min_qual=mq)
        return a.read_bytes(), b.read_bytes()

    native = run("native")
    monkeypatch.setattr(tstream, "stream_batches", tstream._record_batches)
    monkeypatch.setattr(tcount, "read_fasta_encoded",
                        lambda path, q=0: list(tfasta.iter_fasta_encoded(path, q)))
    _reset_counts()
    python = run("python")
    assert _calls()["parse_encode_bytes"] == 0
    assert _calls()["iter_record_blocks_native"] == 0
    assert native == python and native[0] == native[1]


def test_jax_checkpoint_resumed_by_native_ingest(tmp_path):
    """A run of cfrk_tpu killed after its 3rd batch resumes in the port,
    whose native ingest seeks to the checkpoint's offset."""
    rng = np.random.default_rng(14)
    fa = tmp_path / "r.fa"
    fa.write_bytes(_fasta_bytes(_random_records(rng, 40, 10, 90, _BASES[:5])))
    full, out = tmp_path / "full.cfrk", tmp_path / "out.cfrk"
    tstream.stream_count_file(fa, full, 8, device="cpu", nonzero=True, batch_size=6)
    jfaults.arm("batch-written", 4)
    try:
        with pytest.raises(jfaults.InjectedFault):
            jstream.stream_count_file(fa, out, 8, nonzero=True, batch_size=6)
    finally:
        jfaults.disarm()
    _reset_counts()
    m = tstream.stream_count_file(fa, out, 8, device="cpu", nonzero=True, batch_size=6,
                                  resume=True)
    assert (m.reads, m.total_reads) == (40 - 18, 40)
    assert _calls()["iter_record_blocks_native"] >= 1
    assert out.read_bytes() == full.read_bytes()


def test_failing_compiler_raises_and_does_not_format(monkeypatch, tmp_path):
    """A compiler that fails on an empty build directory raises with its
    exit status; the writer does not fall back to numpy."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "/bin/false")
    build.load_library.cache_clear()
    N._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="/bin/false failed to build"):
            build.build_library("fastaio")
        out = io.BytesIO()
        with pytest.raises(RuntimeError, match="failed to build"):
            tfmt.CfrkWriter(out).write_pairs(np.zeros((2, 3), np.int32),
                                             np.ones((2, 3), np.int32))
        assert out.getvalue() == b""
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        with pytest.raises(RuntimeError, match="cannot run"):
            build.build_library("fastaio")
        monkeypatch.delenv("CXX")
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
            build.host_compiler()
        assert not list((tmp_path / "build").glob("*.so"))
    finally:
        build.load_library.cache_clear()
        N._library.cache_clear()


def test_unwritable_build_dir_names_it(monkeypatch, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setattr(build, "BUILD_DIR", blocker / "build")
    with pytest.raises(RuntimeError, match=f"cannot write the build directory {blocker}"):
        build.build_library("fastaio")


def test_host_source_is_plain_c_and_not_nvcc(monkeypatch, tmp_path):
    """csrc/fastaio.cpp includes no Python header; a .cpp source builds
    with the host compiler and the host flags, never nvcc."""
    src = (Path(build.CSRC) / "fastaio.cpp").read_text()
    includes = [line for line in src.splitlines() if line.startswith("#include")]
    assert includes and not any("Python" in line for line in includes)
    assert 'extern "C"' in src
    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        import subprocess
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "my-c++")
    monkeypatch.setattr(build, "_nvcc", lambda: pytest.fail("nvcc called"))
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    so = build.build_library("fastaio")
    assert seen[0][0] == "my-c++" and tuple(seen[0][1:6]) == build.CXX_FLAGS
    assert so.parent == tmp_path and so.name.startswith("libfastaio-")
    assert "my-c++" in so.with_suffix(".log").read_text()


def test_concurrent_calls_count_every_call():
    """Threads formatting at once (the library runs without the
    interpreter lock) get correct bytes, and no call goes uncounted."""
    rng = np.random.default_rng(15)
    idx = np.sort(rng.integers(0, 4096, size=(64, 40)), axis=1).astype(np.int32)
    cnt = rng.integers(0, 4, size=idx.shape).astype(np.int32)
    want = tfmt.format_pairs_bytes(idx, cnt)
    before = N.format_pairs_bytes.calls
    bad, per, n_threads = [], 25, 4 * (os.cpu_count() or 1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(per):
            if N.format_pairs_bytes(idx, cnt) != want:
                bad.append(1)

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not bad
    assert N.format_pairs_bytes.calls == before + per * n_threads


def test_first_use_from_two_threads_builds_once(monkeypatch, tmp_path):
    """Two threads that reach the host library first at the same moment
    (two workflow tasks) run the compiler once and share one library
    whose signatures were declared once."""
    import shutil
    import subprocess
    import time

    built = build.build_library("fastaio")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    runs = []

    def slow_compiler(cmd, **kw):
        runs.append(cmd)
        time.sleep(0.5)  # both threads are inside the first use meanwhile
        shutil.copyfile(built, cmd[cmd.index("-o") + 1])
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build.subprocess, "run", slow_compiler)
    build.load_library.cache_clear()
    N._library.cache_clear()
    got, start = [], threading.Barrier(2)

    def first_use():
        start.wait()
        got.append(N._library())

    try:
        threads = [threading.Thread(target=first_use) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(runs) == 1 and len(got) == 2 and got[0] is got[1]
        assert N._library.cache_info().currsize == 1
        idx, cnt = np.arange(4, dtype=np.int32)[None], np.ones((1, 4), np.int32)
        assert N.format_pairs_bytes(idx, cnt) == tfmt.format_pairs_bytes(idx, cnt)
    finally:
        build.load_library.cache_clear()
        N._library.cache_clear()
