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
  ``spectrum_pallas`` (``ops/cuda/spectrum.spectrum_hist``).  Asked for
  by name it takes k <= 10, the JAX package's limit.  On a CPU tensor
  its plain twin, the scatter route, runs.

``auto`` on a CUDA tensor takes the histogram kernel (route ``pallas``)
at every k <= 15, whatever the window count: up to k = 10 its table
stays in the L2, and for 11 <= k <= 15, where the table (up to 4**15
int32, 4.29 GB) is far larger than the L2, it runs ``spectrum_large``,
which adds each window's count into the table in HBM, 4-5 times as
fast as ``index_add_`` there (PERF.md).  Elsewhere ``auto`` is the JAX
package's off-TPU policy (``matmul`` for k <= 6, ``scatter`` above).  The
JAX package's slicing of large batches into 8192-read kernel calls is a
TPU-measured optimum and is not carried over: the table is the same
without it.

A call is the span ``cfrk.spectrum``, one count of ``cfrk.spectrum.calls``,
its B * W windows under ``cfrk.spectrum.windows`` and one count of
``cfrk.spectrum.route.<route>`` for the route it takes.
"""

from __future__ import annotations

import math

import torch

from ..runtime.metrics import count, traced
from .cuda.spectrum import SPECTRUM_MAX_K, spectrum_hist, spectrum_hist_plain
from .encode import as_codes, split_k, window_indices

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
    A tensor runs on its device; a numpy array runs on the card.
    """
    codes = as_codes(codes)
    if impl == "sort":
        raise ValueError(
            "impl='sort' is a driver-level route (spectrum_file "
            "accumulates sparsely and densifies once); spectrum() itself "
            "is dense per batch"
        )
    if k > MAX_DENSE_SPECTRUM_K:
        raise ValueError(
            f"dense spectrum supports k <= {MAX_DENSE_SPECTRUM_K}; "
            "use the sparse mode for larger k"
        )
    n_windows = math.prod(codes.shape[:-1]) * max(codes.shape[-1] - k + 1, 0)
    route = _route(impl, k, codes.device.type == "cuda", n_windows)
    count("cfrk.spectrum.calls")
    count("cfrk.spectrum.windows", n_windows)
    count("cfrk.spectrum.route." + route)
    return traced("cfrk.spectrum", _ROUTES[route], codes.reshape(-1, codes.shape[-1]),
                  k, canonical, out)


def _route(impl: str, k: int, on_cuda: bool, n_windows: int) -> str:
    """The route ``impl`` resolves to (``auto`` as the module says)."""
    if impl == "auto":
        if on_cuda:
            return "pallas"
        impl = "matmul" if k <= 6 else "scatter"
    if impl == "pallas" and k > SPECTRUM_MAX_K:
        raise ValueError(f"impl='pallas' supports k <= {SPECTRUM_MAX_K}, the JAX "
                         f"package's limit, got k={k}; impl='auto' takes the "
                         "kernel on a CUDA tensor up to k = 15")
    if impl == "matmul" and n_windows >= 2**24:
        # float32 accumulation is exact only below 2**24 per cell; a
        # degenerate batch (all one k-mer) could exceed it.
        return "scatter"
    if impl not in ("scatter", "pallas", "matmul"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl


def _matmul_into(codes: torch.Tensor, k: int, canonical: bool, out):
    table = _spectrum_matmul(codes, k, canonical)
    return table if out is None else out.add_(table)


_ROUTES = {
    "scatter": spectrum_hist_plain,
    "pallas": spectrum_hist,
    "matmul": _matmul_into,
}
