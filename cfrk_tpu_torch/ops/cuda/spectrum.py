"""Global dense spectrum: a hand-written CUDA histogram kernel and its
plain PyTorch twin.

:func:`spectrum_hist` replaces ``spectrum_pallas``
(cfrk_tpu/ops/pallas/spectrum.py:62) for 1 <= k <= 10 and goes on to
k = 15, which the TPU kernel does not take: codes ``[B, L]`` int8 → the
``[4**k]`` int32 counts of every valid window, forward or canonical.
The kernel builds the window keys itself, out of the batch packed as one
flat run of 16-code units, merges runs of equal keys in registers and
histograms the rest with atomics (``csrc/spectrum.cu`` explains the
design and its bounds on the H100).  Above k = 10, where the table (67 MB
to 4.29 GB from k = 12) is larger than the L2, the same walk runs under
the kernel name ``spectrum_large``, and each such launch also counts
under ``LARGE_LAUNCHES``.  :func:`spectrum_hist_model` is a numpy model
of that arithmetic, thread by thread, which the CPU tests hold against
the plain twin.  Its plain twin :func:`spectrum_hist_plain` is the
``scatter`` route of ``ops/spectrum.py``: ``index_add_`` of the valid
window indices, on any device, for k <= 15.

Both ADD into ``out`` when it is given (the running table of
``DenseSpectrumAccumulator``) and return it, so a batch never allocates
a fresh ``4**k`` table; without ``out`` they start from a zeroed table.

As in ``ops/cuda/rowsort.py``, the wrapper takes its plain twin only for
a tensor on the CPU.  For a CUDA tensor it launches the kernel or
raises; a build or launch failure is never replaced by the plain route.
Its validation, launch counter, spans and ``cfrk.out_bytes`` count are
those of ``ops/cuda/rowsort.py``'s wrappers.
"""

from __future__ import annotations

import ctypes
from collections import defaultdict

import numpy as np
import torch

from ...runtime.metrics import count, count_out, span
from ..encode import window_indices
from .build import check_codes, launch_kernel, load_library, once
from .rowsort import UNIT_BASES, pack_units_model, packed_window_keys_model

__all__ = ["HIST_MAX_K", "LARGE_LAUNCHES", "SPECTRUM_MAX_K", "spectrum_hist",
           "spectrum_hist_model", "spectrum_hist_plain"]

# The TPU kernel's limit (its VMEM accumulator), kept so that the two
# packages accept and refuse the same k under impl="pallas".
SPECTRUM_MAX_K = 10
# The CUDA kernel's limit: above SPECTRUM_MAX_K it is spectrum_large.
HIST_MAX_K = 15
# Launches of spectrum_hist that ran spectrum_large (k > SPECTRUM_MAX_K).
LARGE_LAUNCHES = "cfrk.spectrum_hist.large_launches"

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


# ------------------------------------------- the kernel's arithmetic

_SENTINEL = 0xFFFFFFFF


def spectrum_hist_model(codes: np.ndarray, k: int, canonical: bool = False,
                        *, skew: int = 0, threads: int = 256, grid: int = 4):
    """numpy model of the kernels of ``csrc/spectrum.cu``, thread by
    thread.  Returns ``(table, atomics)``: the counts, and how many
    atomic adds reached the table.  Up to k = 10 the counts are the
    ``[4**k]`` int64 table; above, where that table would take 8 * 4**k
    bytes, they are the pair ``(keys, counts)``: the distinct keys the
    batch adds to, ascending, and their int64 counts.

    The batch is one flat run of codes cut into 16-code units, ``skew``
    codes of the first unit lying before the batch (invalid, as are the
    codes past its end).  Thread t of block b walks, at each step s = b,
    b + grid, ..., the 16 windows that start in unit ``s * threads + t``:
    a window counts iff none of its codes is invalid and its position in
    its read is below W.  The thread holds the last two distinct keys
    with their run counts and adds a pair to the table only when a third
    key evicts it; at the end the lanes of a warp that hold the same key
    add their runs as one.
    """
    b, length = codes.shape
    w = length - k + 1
    total = b * length
    steps = -(-(total + skew) // (threads * UNIT_BASES))
    n_units = steps * threads + 4
    flat = np.concatenate([np.full(skew, -1, np.int8), codes.reshape(-1)])
    bases, invalid = pack_units_model(flat, n_units)
    keys = packed_window_keys_model(
        bases, invalid, np.arange(steps * threads * UNIT_BASES), k, canonical,
        32, _SENTINEL).tolist()
    sparse = k > SPECTRUM_MAX_K
    table = defaultdict(int) if sparse else np.zeros(4**k, np.int64)
    atomics = 0

    def add(key, run):
        nonlocal atomics
        table[key] += run
        atomics += 1

    for block in range(min(grid, steps)):
        held = [[_SENTINEL, 0, _SENTINEL, 0] for _ in range(threads)]
        for s in range(block, steps, grid):
            for t in range(threads):
                unit = s * threads + t
                if int(invalid[unit]) == 0xFFFF:
                    continue  # no window starts here
                h = held[t]
                p = (unit * UNIT_BASES - skew) % length
                for e in range(UNIT_BASES):
                    key = keys[unit * UNIT_BASES + e]
                    if p < w and key != _SENTINEL:
                        if key == h[0]:
                            h[1] += 1
                        elif key == h[2]:
                            h[3] += 1
                        else:
                            if h[3]:
                                add(h[2], h[3])
                            h[2], h[3] = h[0], h[1]
                            h[0], h[1] = key, 1
                    p = 0 if p + 1 == length else p + 1
        for warp in range(0, threads, 32):  # flush_warp, pair 0 then pair 1
            for pair in (0, 2):
                groups: dict = {}
                for h in held[warp:warp + 32]:
                    groups[h[pair]] = groups.get(h[pair], 0) + h[pair + 1]
                for key, run in groups.items():
                    if run:
                        add(key, run)
    if sparse:
        distinct = sorted(table)
        counts = [table[key] for key in distinct]
        return (np.array(distinct, np.int64), np.array(counts, np.int64)), atomics
    return table, atomics


@once
def _library() -> ctypes.CDLL:
    lib = load_library("spectrum")
    lib.cfrk_spectrum_hist.argtypes = [_PTR, _PTR] + [_INT] * 5 + [_PTR]
    lib.cfrk_spectrum_hist.restype = _INT
    return lib


def spectrum_hist(codes: torch.Tensor, k: int, canonical: bool = False,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Global spectrum of a code batch, CUDA histogram kernel.

    codes [B, L] int8 → [4**k] int32 (1 <= k <= 15), added into ``out``
    when given.  Each window of each read counts once iff none of its
    codes is < 0.  Above k = 10 the launch runs ``spectrum_large``, for
    tables larger than the L2, and counts under ``LARGE_LAUNCHES``.
    """
    w = check_codes(codes, k, 1, HIST_MAX_K)
    if codes.device.type == "cpu":
        with span("cfrk.spectrum_hist.plain"):
            return count_out(spectrum_hist_plain(codes, k, canonical, out))
    codes = codes.contiguous()
    b, length = codes.shape
    table = _table(out, k, codes.device)
    if b:
        launch_kernel("spectrum_hist", _library().cfrk_spectrum_hist, codes.device,
                      codes.data_ptr(), table.data_ptr(), b, length, w, k,
                      int(canonical))
        if k > SPECTRUM_MAX_K:
            count(LARGE_LAUNCHES)
    return count_out(table)
