"""Global dense spectrum: a hand-written CUDA histogram kernel and its
plain PyTorch twin.

:func:`spectrum_hist` (1 <= k <= 10) replaces ``spectrum_pallas``
(cfrk_tpu/ops/pallas/spectrum.py:62): codes ``[B, L]`` int8 → the
``[4**k]`` int32 counts of every valid window, forward or canonical.
The kernel builds the window keys itself and histograms them
(``csrc/spectrum.cu`` explains the design and its bounds on the H100).
Its plain twin :func:`spectrum_hist_plain` is the ``scatter`` route of
``ops/spectrum.py``: ``index_add_`` of the valid window indices, on any
device, for k <= 15.

Both ADD into ``out`` when it is given (the running table of
``DenseSpectrumAccumulator``) and return it, so a batch never allocates
a fresh ``4**k`` table; without ``out`` they start from a zeroed table.

As in ``ops/cuda/rowsort.py``, the wrapper takes its plain twin only for
a tensor on the CPU.  For a CUDA tensor it launches the kernel or
raises; a build or launch failure is never replaced by the plain route.
``spectrum_hist.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..encode import window_indices
from .build import load_library

__all__ = ["SPECTRUM_MAX_K", "spectrum_hist", "spectrum_hist_plain"]

# The TPU kernel's limit (its VMEM accumulator), kept so that the two
# packages accept and refuse the same k.
SPECTRUM_MAX_K = 10

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _table(out: torch.Tensor | None, k: int, device: torch.device) -> torch.Tensor:
    """``out`` checked as a running ``[4**k]`` int32 table, or a new
    zeroed one."""
    if out is None:
        return torch.zeros(4**k, dtype=torch.int32, device=device)
    if out.shape != (4**k,) or out.dtype != torch.int32 or out.device != device:
        raise ValueError(
            f"out must be a [4**{k}] int32 tensor on {device}, got "
            f"{tuple(out.shape)} {out.dtype} on {out.device}"
        )
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    return out


def spectrum_hist_plain(codes: torch.Tensor, k: int, canonical: bool = False,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Global spectrum, plain route on any device (1 <= k <= 15).

    codes: [..., L] int8 → [4**k] int32; invalid windows (-1 indices)
    are dropped before the ``index_add_``.
    """
    idx = window_indices(codes, k, canonical).reshape(-1)
    idx = idx[idx >= 0]
    table = _table(out, k, codes.device)
    return table.index_add_(0, idx, torch.ones_like(idx))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("spectrum")
    lib.cfrk_spectrum_hist.argtypes = [_PTR, _PTR] + [_INT] * 5 + [_PTR]
    lib.cfrk_spectrum_hist.restype = _INT
    return lib


def spectrum_hist(codes: torch.Tensor, k: int, canonical: bool = False,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Global spectrum of a code batch, CUDA histogram kernel.

    codes [B, L] int8 → [4**k] int32 (1 <= k <= 10), added into ``out``
    when given.  Each window of each read counts once iff none of its
    codes is < 0.
    """
    if not 1 <= k <= SPECTRUM_MAX_K:
        raise ValueError(f"the dense spectrum kernel supports 1 <= k <= "
                         f"{SPECTRUM_MAX_K}, got k={k}")
    if codes.ndim != 2 or codes.dtype != torch.int8:
        raise ValueError(
            f"codes must be a [B, L] int8 tensor, got {tuple(codes.shape)} "
            f"{codes.dtype}"
        )
    if codes.device.type == "cpu":
        return spectrum_hist_plain(codes, k, canonical, out)
    b, length = codes.shape
    w = length - k + 1
    if w <= 0:
        raise ValueError(f"read length {length} < k={k}")
    if codes.device.type != "cuda":
        raise ValueError(f"codes on {codes.device}: the kernel needs CUDA")
    codes = codes.contiguous()
    table = _table(out, k, codes.device)
    if b:
        with torch.cuda.device(codes.device):
            stream = torch.cuda.current_stream(codes.device).cuda_stream
            err = _library().cfrk_spectrum_hist(
                codes.data_ptr(), table.data_ptr(), b, length, w, k,
                int(canonical), stream,
            )
        if err != 0:
            raise RuntimeError(f"cfrk_spectrum_hist launch failed: CUDA error {err}")
        spectrum_hist.launches += 1
    return table


spectrum_hist.launches = 0
