"""Dense per-read k-mer histograms (PyTorch): codes [B, L] → [B, 4**k].

The counterpart of ``cfrk_tpu/ops/perread.py``.  Routes, chosen by
``impl``:

* ``compare`` (4**k <= 64): ``counts[b, v] = sum_w (idx[b, w] == v)``;
* ``scatter``: each valid window adds one at ``row * 4**k + index`` of a
  flat int32 table (``perread_hist_plain``), exact for any row length;
* ``matmul``: the batched one-hot contraction
  ``counts[b, hi, lo] = sum_w onehot(hi) * onehot(lo)`` in float32
  (exact below 2**24 windows per read; longer rows take ``scatter``).
  The JAX package's ``acc_dtype`` (bf16 one-hots for the TPU's MXU) has
  no counterpart: the product is always float32;
* ``host``: numpy sort of the composite (read, bin) keys and run-length
  counts, O(B·W log B·W), never O(B·4**k) work;
* ``pallas``: the name is kept so that command lines carry over; it
  names the hand-written CUDA kernel that replaces
  ``count_perread_pallas`` (``ops/cuda/perread.perread_hist``).  On a CPU
  tensor its plain twin, the scatter route, runs.

The first four are XLA or host routes in the JAX package, so plain
torch is their port.  ``auto`` follows the JAX package: on a CUDA tensor
its TPU policy (``compare`` for 4**k <= 64, the kernel for k >= 5,
``matmul`` at k = 4), elsewhere its off-TPU policy (``compare``, else
``host``).  The JAX package's tracer branches have no counterpart.

A call is the span ``cfrk.perread`` around the route and its cast, one
count of ``cfrk.perread.calls`` and one count of
``cfrk.perread.route.<impl>`` for the route it takes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.metrics import count, traced
from .cuda.perread import MAX_PERREAD_K, perread_hist, perread_hist_plain
from .encode import as_codes, split_k, window_indices

__all__ = ["count_perread", "MAX_PERREAD_K"]

# float32 sums of 0/1 products are exact below this many windows per read.
_F32_EXACT_WINDOWS = 2**24
_IMPLS = ("compare", "scatter", "matmul", "host", "pallas")


def _count_compare(codes: torch.Tensor, k: int, canonical: bool) -> torch.Tensor:
    idx = window_indices(codes, k, canonical)  # [B, W], -1 invalid
    bins = torch.arange(4**k, dtype=torch.int32, device=codes.device)
    return (idx[..., None] == bins).sum(-2, dtype=torch.int32)


def _count_matmul(codes: torch.Tensor, k: int, canonical: bool) -> torch.Tensor:
    kh, kl = split_k(k)
    fh, fl = 4**kh, 4**kl
    idx = window_indices(codes, k, canonical)  # [B, W], -1 invalid
    dev = codes.device
    hi, lo = idx >> (2 * kl), idx & (fl - 1)
    oh_hi = ((hi[..., None] == torch.arange(fh, device=dev))
             & (idx >= 0)[..., None]).float()
    oh_lo = (lo[..., None] == torch.arange(fl, device=dev)).float()
    counts = torch.bmm(oh_hi.transpose(1, 2), oh_lo)  # [B, fh, fl]
    return counts.reshape(codes.shape[0], fh * fl).to(torch.int32)


def _count_host(codes: torch.Tensor, k: int, canonical: bool,
                out_dtype: torch.dtype) -> torch.Tensor:
    # Sort composite (read, bin) keys and length-encode the runs; a
    # scatter into the B·4**k table would be random writes over it.
    idx = window_indices(codes, k, canonical).cpu().numpy()
    b, w = idx.shape
    rows = np.broadcast_to(np.arange(b, dtype=np.int64)[:, None], (b, w))
    valid = idx >= 0
    comp = rows[valid] * (4**k) + idx[valid]
    comp.sort(kind="stable")
    starts = np.r_[0, np.flatnonzero(comp[1:] != comp[:-1]) + 1]
    runs = np.diff(np.r_[starts, len(comp)])
    counts = torch.zeros((b, 4**k), dtype=out_dtype)
    if len(comp):
        counts.view(-1)[torch.from_numpy(comp[starts])] = (
            torch.from_numpy(runs).to(out_dtype)
        )
    return counts.to(codes.device)


def count_perread(
    codes: torch.Tensor,
    k: int,
    *,
    canonical: bool = False,
    impl: str = "auto",
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Dense per-read histograms: codes [B, L] int8 → counts [B, 4**k].

    impl: 'auto' | 'compare' | 'scatter' | 'matmul' | 'host' | 'pallas'.
    out_dtype: torch.int32 (default) or torch.int16, which halves the
        device→host copy and is exact below 2**15 windows per read
        (counts are bounded by the window count).
    A tensor runs on its device; a numpy array runs on the card.
    """
    codes = as_codes(codes)
    out_dtype = torch.int32 if out_dtype is None else out_dtype
    w = codes.shape[-1] - k + 1
    if out_dtype == torch.int16 and w >= 2**15:
        raise ValueError("int16 counts unsafe for >= 2**15 windows/read")
    on_cuda = codes.device.type == "cuda"
    if w >= _F32_EXACT_WINDOWS and (
        impl == "matmul"
        or (impl == "auto" and 4**k > 64 and not (on_cuda and k >= 5))
    ):
        # A repeat-dominated contig could push one float32 cell past
        # 2**24; scatter counts in int32.  The kernel (auto for k >= 5 on
        # CUDA) counts in int32 too; auto at k = 4 would land on matmul.
        impl = "scatter"
    if k > MAX_PERREAD_K:
        raise ValueError(
            f"per-read dense counting supports k <= {MAX_PERREAD_K} "
            f"(4**{k} bins/read); use spectrum or bucketed modes"
        )
    if codes.ndim != 2:
        raise ValueError(f"codes must be [B, L], got {tuple(codes.shape)}")
    if impl == "auto":
        if 4**k <= 64:
            impl = "compare"
        elif not on_cuda:
            impl = "host"
        elif k >= 5:
            impl = "pallas"
        else:
            impl = "matmul"
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    count("cfrk.perread.calls")
    count("cfrk.perread.route." + impl)
    return traced("cfrk.perread", _run_route, impl, codes, k, canonical, out_dtype)


def _run_route(impl: str, codes: torch.Tensor, k: int, canonical: bool,
               out_dtype: torch.dtype) -> torch.Tensor:
    """The route ``impl`` and its cast to ``out_dtype``.  The route
    functions are looked up at each call, so that a caller can put
    another in a route's place."""
    if impl == "compare":
        return _count_compare(codes, k, canonical).to(out_dtype)
    if impl == "scatter":
        return perread_hist_plain(codes, k, canonical).to(out_dtype)
    if impl == "host":
        return _count_host(codes, k, canonical, out_dtype)
    if impl == "matmul":
        return _count_matmul(codes, k, canonical).to(out_dtype)
    # The int16 cast follows the kernel, as in the JAX package.
    return perread_hist(codes, k, canonical).to(out_dtype)
