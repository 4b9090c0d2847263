"""Window extraction: padded code batches → k-mer window indices (PyTorch).

The plain-torch counterpart of ``cfrk_tpu/ops/encode.py``, cut to what
the per-read path needs.  On the GPU the per-read kernels build their
keys themselves (``ops/cuda/rowsort.py``); this is the CPU route and
the kernels' oracle.
"""

from __future__ import annotations

import torch

__all__ = ["split_k", "shifted_views", "horner", "window_indices"]


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
