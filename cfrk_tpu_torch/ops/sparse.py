"""Large-k window keys: the (hi, lo) split of ``cfrk_tpu/ops/sparse.py``.

Only :func:`kmer_keys` and its constants are ported so far.  A k-mer
(k <= 31) is the pair of uint32 words

    hi = first k-15 bases (<= 16 bases = 32 bits),
    lo = last 15 bases   (30 bits),

and invalid windows carry ``INVALID_SENTINEL`` in both words.  torch has
few uint32 operations, so the words come back in int64 tensors holding
the uint32 values.
"""

from __future__ import annotations

import torch

from .encode import horner, shifted_views

__all__ = ["MAX_SPARSE_K", "LO_BASES", "INVALID_SENTINEL", "kmer_keys"]

MAX_SPARSE_K = 31
LO_BASES = 15
INVALID_SENTINEL = 0xFFFFFFFF


def kmer_keys(codes: torch.Tensor, k: int, canonical: bool = False):
    """All window keys of a padded batch.

    codes: [..., L] int8 → (hi, lo) int64 tensors of uint32 values,
    shape [..., L-k+1]; invalid windows have hi == lo == INVALID_SENTINEL.
    Canonical keys are the lexicographic (hi, lo) minimum with the
    reverse complement (a tie keeps the forward key, which is equal).
    """
    if not 1 <= k <= MAX_SPARSE_K:
        raise ValueError(f"k must be in [1, {MAX_SPARSE_K}]")
    views, valid = shifted_views(codes, k, torch.int64)
    kh = max(k - LO_BASES, 0)  # leading bases in hi (0 for k <= 15)
    hi, lo = horner(views[:kh], views[0]), horner(views[kh:], views[0])
    if canonical:
        rviews = [3 - v for v in reversed(views)]
        rc_hi = horner(rviews[:kh], views[0])
        rc_lo = horner(rviews[kh:], views[0])
        fwd_smaller = (hi < rc_hi) | ((hi == rc_hi) & (lo <= rc_lo))
        hi = torch.where(fwd_smaller, hi, rc_hi)
        lo = torch.where(fwd_smaller, lo, rc_lo)
    hi = torch.where(valid, hi, INVALID_SENTINEL)
    lo = torch.where(valid, lo, INVALID_SENTINEL)
    return hi, lo
