"""The plain spectrum reference (``references/spectrum_table.py``)
against counts made by slicing strings, its dense table against its
sparse spectrum, its two broken guarantees, and its imports."""

import pytest
import torch

from benchmark.references import spectrum_table
from benchmark.test_harness_contract import _top_level_after
from benchmark.test_harness_reference import READS, codes_of, string_counts


def _joint_counts(reads, k, canonical=False):
    out = {}
    for seq in reads:
        for key, n in string_counts(seq, k, canonical).items():
            out[key] = out.get(key, 0) + n
    return out


@pytest.mark.parametrize("k,canonical", [(11, False), (15, False), (11, True), (15, True)])
def test_spectrum_equals_string_slicing(k, canonical):
    want = _joint_counts(READS, k, canonical)
    keys, counts = spectrum_table.spectrum(codes_of(READS), k, canonical)
    assert keys.dtype == counts.dtype == torch.int64
    assert keys.tolist() == sorted(want) and counts.tolist() == [want[x] for x in sorted(want)]


def test_dense_table_equals_the_sparse_spectrum():
    keys, counts = spectrum_table.spectrum(codes_of(READS), 11)
    dense = spectrum_table.table(codes_of(READS), 11)
    assert dense.shape == (4**11,) and dense.dtype == torch.int64
    assert torch.equal(torch.nonzero(dense).reshape(-1), keys)
    assert torch.equal(dense[keys], counts) and int(dense.sum()) == int(counts.sum())


@pytest.mark.parametrize("broken", ["n_as_base", "forward_only"])
def test_each_broken_guarantee_changes_the_spectrum(broken):
    good = spectrum_table.spectrum(codes_of(READS), 15, True)
    bad = spectrum_table.spectrum(codes_of(READS), 15, True, **{broken: True})
    assert len(good[0]) != len(bad[0]) or not torch.equal(good[0], bad[0])


def test_reads_shorter_than_k_have_no_windows():
    keys, counts = spectrum_table.spectrum(codes_of(READS)[:, :10], 11)
    assert keys.numel() == counts.numel() == 0


def test_the_reference_imports_neither_jax_nor_either_package():
    assert _top_level_after("import benchmark.references.spectrum_table") == "[]"
