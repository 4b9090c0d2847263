"""Plain reference of per-read k-mer rows, in PyTorch alone.

It imports nothing of the program.  From int8 codes ``[B, L]`` (0-3 for
A, C, G, T, -1 for N) it works out each read's window keys (a window
holding an N has none), sorts them and run-length encodes them into the
layout that ``count_perread_rows`` documents:

* k <= 15: ``(idx, counts)``, both ``[B, W]`` int32 with W = L - k + 1;
  a run's first cell holds the key and the run's length, every other
  cell ``4**k`` and 0;
* 16 <= k <= 31: ``(hi, lo, counts)``, int32 bit views of the key's
  two 30-bit halves (``key >> 30``, ``key & (2**30 - 1)``), -1 and -1 at
  cells that start no run.

The key of a window ``s_0 .. s_{k-1}`` is ``sum s_j 4**(k-1-j)``; its
canonical key is the smaller of that and its reverse complement's,
``sum (3 - s_j) 4**j``.  The run lengths are counted with a cumulative
run id and ``bincount``.

``n_as_base`` and ``forward_only`` break one guarantee each: an N read
as the base A (its windows counted), and the forward key where the
configuration asks for the canonical one.  They serve the control only.
"""

from __future__ import annotations

import torch

LO_BITS = 30
_SENTINEL = 1 << 62  # above every real key: 4**31 - 1 < 2**62


def window_keys(codes: torch.Tensor, k: int, canonical: bool, *,
                n_as_base: bool = False, forward_only: bool = False):
    """``(keys, valid)``: int64 ``[B, W]`` window keys and whether each
    window holds no N."""
    c = codes.to(torch.int64)
    valid = c >= 0 if not n_as_base else torch.ones_like(c, dtype=torch.bool)
    c = c.clamp(min=0)
    b, length = c.shape
    w = length - k + 1
    if w <= 0:
        raise ValueError(f"read length {length} < k={k}")
    fwd = torch.zeros((b, w), dtype=torch.int64, device=c.device)
    rc = torch.zeros_like(fwd)
    ok = torch.ones((b, w), dtype=torch.bool, device=c.device)
    for j in range(k):
        col = c[:, j : j + w]
        fwd = fwd * 4 + col
        rc += (3 - col) << (2 * j)
        ok &= valid[:, j : j + w]
    key = torch.minimum(fwd, rc) if canonical and not forward_only else fwd
    return key, ok


def rows(codes: torch.Tensor, k: int, canonical: bool = False, **broken):
    """The rows of ``count_perread_rows(codes, k, canonical)``."""
    if not 1 <= k <= 31:
        raise ValueError(f"k={k} outside [1, 31]")
    key, ok = window_keys(codes, k, canonical, **broken)
    s = torch.sort(torch.where(ok, key, _SENTINEL), dim=1).values
    real = s != _SENTINEL
    start = real.clone()
    start[:, 1:] &= s[:, 1:] != s[:, :-1]
    # A row's first real cell starts a run, so every real cell follows a
    # start of its own row in the flattened order.
    run = torch.cumsum(start.flatten(), 0) - 1
    per_run = torch.bincount(run[real.flatten()], minlength=int(start.sum()))
    counts = torch.zeros(s.shape, dtype=torch.int32, device=s.device)
    counts[start] = per_run.to(torch.int32)
    if k <= 15:
        return torch.where(start, s, 4**k).to(torch.int32), counts
    hi = torch.where(start, s >> LO_BITS, -1)
    lo = torch.where(start, s & ((1 << LO_BITS) - 1), -1)
    return _int32_bits(hi), _int32_bits(lo), counts


def _int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [-1, 2**32) as the int32 with the same low 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
