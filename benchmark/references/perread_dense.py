"""Plain reference of dense per-read k-mer histograms, in PyTorch alone.

It imports nothing of the program, and nothing but ``window_keys`` of
``references/perread_rows.py`` beside torch.  From int8 codes ``[B, L]``
(0-3 for A, C, G, T, -1 for N) it takes every window's key (a window
holding an N has none; windows never cross reads) and counts them into
a zeroed ``[B, 4**k]`` int32 matrix: cell ``(b, key)`` holds the number
of read ``b``'s windows with that key, and every one of the ``4**k``
cells of a row is present, zeros included.  The counts are made by one
``index_add_`` of ``b * 4**k + key`` over the valid windows.

The key of a window is ``window_keys``'s: ``sum s_j 4**(k-1-j)``, or at a
canonical k the smaller of that and its reverse complement's.
``n_as_base`` and ``forward_only`` break one guarantee each, as in
``perread_rows``: an N read as the base A, and the forward key where the
canonical one is due.  They serve the control only.
"""

from __future__ import annotations

import torch

from benchmark.references.perread_rows import window_keys

MAX_K = 8  # 4**8 int32 cells a read: 256 KB


def counts(codes: torch.Tensor, k: int, canonical: bool = False, **broken) -> torch.Tensor:
    """``[B, 4**k]`` int32 on the codes' device: each read's count of
    every k-mer over its windows that hold no N."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    key, ok = window_keys(codes, k, canonical, **broken)
    b = codes.shape[0]
    rows = torch.arange(b, dtype=torch.int64, device=codes.device)[:, None]
    flat = (rows * 4**k + key)[ok]
    out = torch.zeros(b * 4**k, dtype=torch.int32, device=codes.device)
    out.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.int32, device=codes.device))
    return out.reshape(b, 4**k)
