"""Plain reference of a batch's global k-mer spectrum, in PyTorch alone.

It imports nothing of the program, and nothing but ``window_keys`` of
``references/perread_rows.py`` beside torch.  From int8 codes ``[B, L]``
(0-3 for A, C, G, T, -1 for N) it takes every window's key (a window
holding an N has none; windows never cross reads) and counts each
distinct key:

* :func:`spectrum`: the sorted distinct keys, int64, and their counts,
  int64: the batch's exact spectrum with no ``4**k`` table;
* :func:`table`: the same as a dense ``[4**k]`` int64 table.

The key of a window is ``window_keys``'s: ``sum s_j 4**(k-1-j)``, or at a
canonical k the smaller of that and its reverse complement's.
``n_as_base`` and ``forward_only`` break one guarantee each, as in
``perread_rows``: an N read as the base A, and the forward key where the
canonical one is due.
"""

from __future__ import annotations

import torch

from benchmark.references.perread_rows import window_keys


def spectrum(codes: torch.Tensor, k: int, canonical: bool = False, **broken):
    """``(keys, counts)``: the batch's distinct window keys, ascending, and
    how many windows hold each, both int64 on the codes' device."""
    if not 1 <= k <= 31:
        raise ValueError(f"k={k} outside [1, 31]")
    if codes.shape[-1] < k:
        empty = torch.zeros(0, dtype=torch.int64, device=codes.device)
        return empty, empty.clone()
    key, ok = window_keys(codes.reshape(-1, codes.shape[-1]), k, canonical, **broken)
    keys, counts = torch.unique(key[ok], sorted=True, return_counts=True)
    return keys, counts.to(torch.int64)


def table(codes: torch.Tensor, k: int, canonical: bool = False, **broken) -> torch.Tensor:
    """The batch's spectrum as a dense ``[4**k]`` int64 table (k <= 15)."""
    if not 1 <= k <= 15:
        raise ValueError(f"a dense table takes k <= 15, got k={k}")
    keys, counts = spectrum(codes, k, canonical, **broken)
    out = torch.zeros(4**k, dtype=torch.int64, device=codes.device)
    return out.index_put_((keys,), counts)
