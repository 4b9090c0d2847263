"""The plain reference against counts made by slicing strings."""

import pytest
import torch

from benchmark.references import perread_rows

_CODE = {"A": 0, "C": 1, "G": 2, "T": 3, "N": -1}
_COMP = str.maketrans("ACGT", "TGCA")
_DIGITS = str.maketrans("ACGT", "0123")

READS = [s[:76] for s in [
    "ACGTACGTTTGACCANGGTACCATTGACGATCGATCGGGAAATTTCCCAGGGTTTAAACCCGGGTTTACGTACGTTA",
    "TTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTT",
    "GATTACAGATTACANNGATTACAGATTACAGATTACACCCCGGGGAAAATTTTGATTACAGATTACAGATTACAGAN",
    "NNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNN",
    "ACACACACACACACACACACACACACACACACACACACACACACACACACACACACACACACACACACACACACACAC",
]]


def string_counts(seq: str, k: int, canonical: bool) -> dict:
    """{key: count} of one read by slicing: windows with an N skipped;
    canonical: the smaller of a window and its reverse complement."""
    out = {}
    for i in range(len(seq) - k + 1):
        w = seq[i : i + k]
        if "N" in w:
            continue
        if canonical:
            w = min(w, w.translate(_COMP)[::-1])
        code = int(w.translate(_DIGITS), 4)
        out[code] = out.get(code, 0) + 1
    return out


def expected_rows(reads, k, canonical):
    w = len(reads[0]) - k + 1
    keys = [[None] * w for _ in reads]
    counts = [[0] * w for _ in reads]
    for r, seq in enumerate(reads):
        pos = 0
        for key, n in sorted(string_counts(seq, k, canonical).items()):
            keys[r][pos], counts[r][pos] = key, n
            pos += n
    return keys, counts


def codes_of(reads):
    return torch.tensor([[_CODE[c] for c in s] for s in reads], dtype=torch.int8)


@pytest.mark.parametrize("k,canonical", [(8, False), (31, True), (4, False), (15, True),
                                         (16, False), (31, False)])
def test_rows_equal_string_slicing(k, canonical):
    keys, counts = expected_rows(READS, k, canonical)
    out = perread_rows.rows(codes_of(READS), k, canonical)
    assert out[-1].tolist() == counts
    if k <= 15:
        want = [[4**k if x is None else x for x in row] for row in keys]
        assert out[0].tolist() == want
        return
    hi, lo = out[0].tolist(), out[1].tolist()
    for r, row in enumerate(keys):
        for j, key in enumerate(row):
            want_hi = -1 if key is None else key >> 30
            want_lo = -1 if key is None else key & (2**30 - 1)
            assert (hi[r][j] & 0xFFFFFFFF, lo[r][j]) == (want_hi & 0xFFFFFFFF, want_lo)


def test_a_read_of_ns_has_an_empty_row():
    out = perread_rows.rows(codes_of(READS), 8)
    assert int(out[1][3].sum()) == 0 and bool((out[0][3] == 4**8).all())


@pytest.mark.parametrize("broken", ["n_as_base", "forward_only"])
def test_each_broken_guarantee_changes_the_rows(broken):
    good = perread_rows.rows(codes_of(READS), 31, True)
    bad = perread_rows.rows(codes_of(READS), 31, True, **{broken: True})
    assert any(bool((g != b).any()) for g, b in zip(good, bad))


@pytest.mark.parametrize("k,canonical", [(8, False), (31, True)])
def test_rows_equal_the_programs_cpu_route(k, canonical):
    from benchmark import reads as read_model

    from cfrk_tpu_torch.ops.perread_sparse import count_perread_rows

    model = {"genomes": 2, "genome_len": 2000, "mut_rate": 0.01, "n_rate": 0.01}
    (codes,) = read_model.shards(2**33 + 7, 1, 300, 150, model, torch.device("cpu"))
    for a, b in zip(count_perread_rows(codes, k, canonical), perread_rows.rows(codes, k, canonical)):
        assert torch.equal(a, b)
