"""Global k-mer spectrum (one table over all reads), PyTorch.

The counterpart of ``cfrk_tpu/ops/spectrum.py``.  Three dense routes,
chosen by ``impl``:

* ``scatter`` (k <= 15): ``index_add_`` of the valid window indices into
  a flat ``4**k`` int32 table (``spectrum_hist_plain``).  It is the
  counterpart of an XLA route, so plain torch is its port.
* ``matmul`` (any k <= 15, meant for k <= 6): the one-hot
  ``[4**kh, N] @ [N, 4**kl]`` contraction over every window, in float32,
  which is exact below 2**24 windows; larger batches take ``scatter``.
  The JAX package's ``acc_dtype`` (bf16 one-hots for the TPU's MXU) has
  no counterpart: the product is always float32.
* ``pallas``: the name is kept so that command lines carry over; it
  names the hand-written CUDA histogram kernel that replaces
  ``spectrum_pallas`` (``ops/cuda/spectrum.spectrum_hist``, k <= 10).  On
  a CPU tensor its plain twin, the scatter route, runs.

``auto`` follows the JAX package: on a CUDA tensor its TPU policy (the
kernel for k <= 10; the file driver's sorted route takes k >= 9 before
this is reached), elsewhere its off-TPU policy (``matmul`` for k <= 6,
``scatter`` above).  The JAX package's slicing of large batches into
8192-read kernel calls is a TPU-measured optimum and is not carried
over: the table is the same without it.
"""

from __future__ import annotations

import math

import torch

from .cuda.spectrum import SPECTRUM_MAX_K, spectrum_hist, spectrum_hist_plain
from .encode import split_k, window_indices

__all__ = ["spectrum", "MAX_DENSE_SPECTRUM_K"]

MAX_DENSE_SPECTRUM_K = 15


def _spectrum_matmul(codes: torch.Tensor, k: int, canonical: bool) -> torch.Tensor:
    """One-hot contraction: every window's hi one-hot times its lo
    one-hot, summed over all windows."""
    kh, kl = split_k(k)
    fh, fl = 4**kh, 4**kl
    idx = window_indices(codes, k, canonical).reshape(-1)
    valid = (idx >= 0).unsqueeze(1)
    hi, lo = idx >> (2 * kl), idx & (fl - 1)
    dev = codes.device
    oh_hi = ((hi.unsqueeze(1) == torch.arange(fh, device=dev)) & valid).float()
    oh_lo = (lo.unsqueeze(1) == torch.arange(fl, device=dev)).float()
    table = oh_hi.T @ oh_lo
    return table.reshape(fh * fl).to(torch.int32)


def spectrum(
    codes: torch.Tensor,
    k: int,
    *,
    canonical: bool = False,
    impl: str = "auto",
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Global dense spectrum: codes [..., L] int8 → counts [4**k] int32.

    ``out``: a running ``[4**k]`` int32 table on the codes' device; the
    batch's counts are added into it in place and it is returned.
    """
    if impl == "sort":
        raise ValueError(
            "impl='sort' is a driver-level route (spectrum_file "
            "accumulates sparsely and densifies once); spectrum() itself "
            "is dense per batch"
        )
    on_cuda = codes.device.type == "cuda"
    n_windows = math.prod(codes.shape[:-1]) * max(codes.shape[-1] - k + 1, 0)
    if n_windows >= 2**24 and (
        impl == "matmul"
        or (impl == "auto" and not (k <= SPECTRUM_MAX_K and on_cuda))
    ):
        # float32 accumulation is exact only below 2**24 per cell; a
        # degenerate batch (all one k-mer) could exceed it.
        impl = "scatter"
    if k > MAX_DENSE_SPECTRUM_K:
        raise ValueError(
            f"dense spectrum supports k <= {MAX_DENSE_SPECTRUM_K}; "
            "use the sparse mode for larger k"
        )
    if impl == "auto":
        if k <= SPECTRUM_MAX_K and on_cuda:
            impl = "pallas"
        else:
            impl = "matmul" if k <= 6 else "scatter"
    flat = codes.reshape(-1, codes.shape[-1])
    if impl == "scatter":
        return spectrum_hist_plain(flat, k, canonical, out)
    if impl == "pallas":
        return spectrum_hist(flat, k, canonical, out)
    if impl == "matmul":
        table = _spectrum_matmul(flat, k, canonical)
        return table if out is None else out.add_(table)
    raise ValueError(f"unknown impl {impl!r}")
