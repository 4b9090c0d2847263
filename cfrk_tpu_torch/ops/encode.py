"""Window extraction: padded code batches → k-mer window indices (PyTorch).

The plain-torch counterpart of ``cfrk_tpu/ops/encode.py``.  On the GPU
the kernels build their keys themselves (``ops/cuda/``); this is the CPU
route and the kernels' oracle.  :func:`window_components` and
:func:`canonical_components` give the library the JAX package's
``(hi, lo)`` split of each window index (``hi`` = the first
``ceil(k/2)`` bases), which its matmul routes contract.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "split_k",
    "shifted_views",
    "horner",
    "WindowComponents",
    "window_components",
    "window_indices",
    "canonical_components",
]


def split_k(k: int) -> tuple[int, int]:
    """Split k into (kh, kl) with kh = ceil(k/2): index = hi * 4**kl + lo."""
    kh = (k + 1) // 2
    return kh, k - kh


def shifted_views(codes: torch.Tensor, k: int, dtype: torch.dtype):
    """(views, valid): the k shifted ``[..., W]`` code views of a padded
    batch (W = L-k+1), clamped to 0..3, and the mask of windows whose k
    codes are all valid.  Pad (-1) poisons every window it overlaps."""
    length = codes.shape[-1]
    w = length - k + 1
    if w <= 0:
        raise ValueError(f"read length {length} < k={k}")
    c = codes.to(dtype)
    views = [c[..., i : i + w] for i in range(k)]
    valid = views[0] >= 0
    for v in views[1:]:
        valid = valid & (v >= 0)
    return [v.clamp(min=0) for v in views], valid


def horner(views, like: torch.Tensor) -> torch.Tensor:
    """Base-4 positional value of the views, first view most significant
    (zeros shaped like ``like`` when there are none)."""
    acc = torch.zeros_like(like)
    for v in views:
        acc = (acc << 2) | v
    return acc


@dataclasses.dataclass(frozen=True)
class WindowComponents:
    """Per-window k-mer index components for a padded batch.

    hi:    [..., W] int32 in [0, 4**kh)  — first ceil(k/2) bases.
    lo:    [..., W] int32 in [0, 4**kl)  — remaining bases (0 when kl == 0).
    rc_hi: [..., W] int32 — same split of the reverse-complement index.
    rc_lo: [..., W] int32
    valid: [..., W] bool  — all k codes in 0..3 (excludes N/pad windows).
    """

    hi: torch.Tensor
    lo: torch.Tensor
    rc_hi: torch.Tensor
    rc_lo: torch.Tensor
    valid: torch.Tensor


def window_components(codes: torch.Tensor, k: int) -> WindowComponents:
    """All window index components of a padded code batch.

    codes: [..., L] int8 (0..3 valid, -1 invalid/pad).  Windows start at
    every position p in [0, L-k]; pad (-1) poisons the windows it
    overlaps, as a reference separator does.  Invalid windows keep the
    components of their codes clamped to 0.
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    if k > 15:
        # kh = ceil(k/2) > 15 would overflow int32; ops/sparse.kmer_keys
        # splits k up to 31 at 15 bases instead.
        raise ValueError("window_components supports k <= 15; use "
                         "ops.sparse.kmer_keys for k up to 31")
    kh, kl = split_k(k)
    views, valid = shifted_views(codes, k, torch.int32)
    rviews = [3 - v for v in reversed(views)]  # base i of rc: 3 - base[k-1-i]
    return WindowComponents(
        hi=horner(views[:kh], views[0]), lo=horner(views[kh:], views[0]),
        rc_hi=horner(rviews[:kh], views[0]), rc_lo=horner(rviews[kh:], views[0]),
        valid=valid,
    )


def canonical_components(codes: torch.Tensor, k: int):
    """(hi, lo, valid) of CANONICAL window indices: min(fwd, revcomp)
    breaks the independent hi/lo split, so the canonical full index is
    computed and split again.  Invalid windows hold (0, 0)."""
    kl = split_k(k)[1]
    idx = window_indices(codes, k, canonical=True)
    valid = idx >= 0
    idx = idx.clamp(min=0)
    return idx >> (2 * kl), idx & (4**kl - 1), valid


def window_indices(codes: torch.Tensor, k: int, canonical: bool = False) -> torch.Tensor:
    """Full int32 window indices (k <= 15), -1 for invalid windows.

    canonical=True returns min(index, revcomp(index)) — strand-neutral.
    """
    if not 1 <= k <= 15:
        raise ValueError("full int32 indices need 1 <= k <= 15; use "
                         "ops.sparse.kmer_keys for k up to 31")
    views, valid = shifted_views(codes, k, torch.int32)
    idx = horner(views, views[0])
    if canonical:
        rc = horner([3 - v for v in reversed(views)], views[0])
        idx = torch.minimum(idx, rc)
    return torch.where(valid, idx, -1)
