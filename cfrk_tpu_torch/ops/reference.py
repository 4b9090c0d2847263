"""Executable NumPy specification of per-read k-mer counting.

A copy of ``cfrk_tpu/ops/reference.py`` (per-read rows and the global
spectrum), the semantics every implementation must match; deliberately
simple and slow.

* a read of length ``L`` has windows at positions ``p`` in ``[0, L-k]``;
* a window is valid iff all ``k`` of its codes are in ``0..3``;
* the window index is ``sum_i code[p+i] * 4**(k-1-i)`` — first base most
  significant;
* canonical mode counts ``min(idx, revcomp_idx)``, where the reverse
  complement of code ``c`` is ``3-c`` with base order reversed.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "window_indices_np",
    "canonical_indices_np",
    "count_perread_np",
    "spectrum_np",
]


def window_indices_np(codes: np.ndarray, k: int) -> np.ndarray:
    """All window indices of one read; invalid windows are -1.

    codes: 1-D int8 array (0..3 valid, -1 invalid).  Returns int64 array of
    length max(0, len(codes)-k+1).
    """
    codes = np.asarray(codes, dtype=np.int64)
    n = codes.shape[0]
    w = n - k + 1
    if w <= 0:
        return np.empty((0,), dtype=np.int64)
    idx = np.zeros(w, dtype=np.int64)
    valid = np.ones(w, dtype=bool)
    for i in range(k):
        c = codes[i : i + w]
        valid &= c >= 0
        idx = idx * 4 + np.maximum(c, 0)
    return np.where(valid, idx, -1)


def revcomp_index_np(idx: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement of base-4 window indices (vectorised)."""
    idx = np.asarray(idx, dtype=np.int64)
    out = np.zeros_like(idx)
    rem = idx.copy()
    for _ in range(k):
        out = out * 4 + (3 - (rem & 3))
        rem >>= 2
    return out


def canonical_indices_np(codes: np.ndarray, k: int) -> np.ndarray:
    """Canonical (strand-neutral) window indices; invalid windows are -1."""
    idx = window_indices_np(codes, k)
    rc = revcomp_index_np(np.maximum(idx, 0), k)
    return np.where(idx >= 0, np.minimum(idx, rc), -1)


def count_perread_np(
    reads: Sequence[np.ndarray], k: int, canonical: bool = False
) -> np.ndarray:
    """Per-read dense histograms: ``[n_reads, 4**k]`` int32."""
    four_k = 4**k
    out = np.zeros((len(reads), four_k), dtype=np.int32)
    fn = canonical_indices_np if canonical else window_indices_np
    for r, codes in enumerate(reads):
        idx = fn(codes, k)
        idx = idx[idx >= 0]
        if idx.size:
            out[r] = np.bincount(idx, minlength=four_k).astype(np.int32)
    return out


def spectrum_np(
    reads: Iterable[np.ndarray], k: int, canonical: bool = False
) -> np.ndarray:
    """Global k-mer spectrum: ``[4**k]`` int64 summed over all reads."""
    four_k = 4**k
    out = np.zeros(four_k, dtype=np.int64)
    fn = canonical_indices_np if canonical else window_indices_np
    for codes in reads:
        idx = fn(codes, k)
        idx = idx[idx >= 0]
        if idx.size:
            out += np.bincount(idx, minlength=four_k)
    return out
