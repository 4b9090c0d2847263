"""Per-read sort + run-length encode: hand-written CUDA kernels and their
plain PyTorch twins.

* :func:`rowsort_rle` (1 <= k <= 15) replaces ``rowsort_rle_pallas``
  (cfrk_tpu/ops/pallas/rowsort.py:569);
* :func:`rowsort_rle_large` (16 <= k <= 31) replaces
  ``rowsort_rle_pallas_large`` (rowsort.py:655).

:func:`rowsort_probe` is the port of the step-time probe kernels of
``tools/rowsort_probe.py`` (``call_kernel`` :173): variants of the same
CUDA kernel that leave out stages and write one checksum per row
(``PROBE_VARIANTS``; ``cfrk_tpu_torch/tools/rowsort_probe.py`` times
them), with the plain twin :func:`rowsort_probe_plain`.

All take the int8 code batch ``[B, L]`` and build the window keys in the
kernel (``csrc/rowsort.cu`` explains the design and its bounds on the
H100): a row is packed once into 16-base units and every key is a funnel
shift out of them.  :func:`pack_units_model` and
:func:`packed_window_keys_model` are a numpy model of that arithmetic
(``cfrk::pack_unit`` and ``cfrk::packed_window_key`` of
``csrc/kmer_key.cuh``, line for line), so that the CPU tests can hold it
against the plain key functions.  The kernels' output is array-equal to
the plain twins
:func:`rowsort_rle_plain` / :func:`rowsort_rle_large_plain`, which sort
with ``torch.sort`` on any device; ``ops/perread_sparse.py`` exports them
as ``count_perread_sparse`` / ``count_perread_sparse_large``.

``checksum=True`` (the JAX kernels' option) also returns ``chk``, one
int64 a thread block of the kernel: the sum over the block's reads of
``count & 3`` plus ``key & 3`` at each run start (the ``lo`` word above
k = 15), reads past B counting zero.  A benchmark consumes it so that
the row writes are not dead without reading them back.  The blocks are
the kernel's (:func:`checksum_rows_per_block`), not the TPU kernel's, so
only the sum ``chk.sum()`` is the same in both packages.

This module owns the device decision: a wrapper takes its plain twin
only for a tensor on the CPU.  For a CUDA tensor it launches its kernel
or raises; a build or launch failure is never replaced by the plain
route.  Each wrapper counts its launches in its ``launches`` attribute,
so a run can show it went through the kernel, and the bytes it returns
under the counter ``cfrk.out_bytes``; its launch is the span
``cfrk.<wrapper>.launch`` (``.first_launch`` the first time), its plain
twin ``cfrk.<wrapper>.plain`` (``runtime/metrics.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...runtime.metrics import count_out, launch, register_launches, span
from ..encode import window_indices
from ..sparse import INVALID_SENTINEL, LO_BASES, kmer_keys
from .build import load_library, once

__all__ = [
    "PROBE_VARIANTS",
    "MAX_SPARSE_PERREAD_K",
    "KEY64_SENTINEL",
    "LO_MASK",
    "ROWSORT_MAX_WINDOWS",
    "ROWSORT_MAX_WINDOWS_LARGE",
    "rowsort_max_windows",
    "rle_rows",
    "rowsort_rle",
    "rowsort_rle_large",
    "rowsort_rle_plain",
    "rowsort_rle_large_plain",
    "checksum_rows_per_block",
    "rowsort_probe",
    "rowsort_probe_plain",
    "UNIT_BASES",
    "packed_units",
    "pack_units_model",
    "packed_window_keys_model",
    "sort_in_registers_model",
]

MAX_SPARSE_PERREAD_K = 15
LO_MASK = (1 << (2 * LO_BASES)) - 1
# The k > 15 sort key is one int64 ``hi << 30 | lo`` (< 4**31 = 2**62 for
# a real window); invalid windows take the largest int64 so they sort
# last.  The uint32 pair sentinel cannot serve: its combined value
# equals the all-T 31-mer's.
KEY64_SENTINEL = (1 << 63) - 1

# Window ceilings of one row in one thread block: the padded row of keys
# lives in shared memory (227 KB per block on the H100), 128 KB of uint32
# or uint64 keys beside 12 KB of packed codes.
ROWSORT_MAX_WINDOWS = 32768
ROWSORT_MAX_WINDOWS_LARGE = 16384

# The probe's variants, numbered as the C entry point takes them:
#   full      build + sort + run-end search; checksum: the sum over run
#             starts of (count & 3) + (key & 3);
#   sortonly  build + sort; checksum: the sum of ((key ^ i) & 3) over
#             the row's W cells;
#   rleonly   build + the run-end search on the UNSORTED keys; full's
#             checksum;
#   noop      build; sortonly's checksum.
PROBE_VARIANTS = {"full": 1, "sortonly": 2, "rleonly": 3, "noop": 4}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def rowsort_max_windows(k: int) -> int:
    """The kernel's windows-per-row ceiling at this k."""
    return ROWSORT_MAX_WINDOWS if k <= MAX_SPARSE_PERREAD_K else ROWSORT_MAX_WINDOWS_LARGE


# ---------------------------------------------------------------- plain twins


def rle_rows(keys: torch.Tensor, is_real: torch.Tensor, sentinel: int):
    """Run-length-encode SORTED key rows.

    keys: [B, W]; is_real: [B, W] bool, False for sentinel positions
    (sorted to the row tails).  Returns ``(masked_keys, counts)``:
    position j holds a distinct key and its int32 count iff it is the
    first of its run, else ``sentinel`` and 0.  The run length is the
    distance to the next boundary, found by a suffix minimum (the JAX
    package's reversed ``associative_scan`` is ``flip``/``cummin``/``flip``).
    """
    b, w = keys.shape
    first = torch.ones((b, w), dtype=torch.bool, device=keys.device)
    first[:, 1:] = keys[:, 1:] != keys[:, :-1]
    first &= is_real
    pos = torch.arange(w, dtype=torch.int32, device=keys.device).expand(b, w)
    boundary = torch.where(first | ~is_real, pos, w)
    suffix_min = torch.flip(
        torch.cummin(torch.flip(boundary, [-1]), dim=-1).values, [-1]
    )
    nxt_after = torch.cat(
        [suffix_min[:, 1:],
         torch.full((b, 1), w, dtype=torch.int32, device=keys.device)],
        dim=-1,
    )
    counts = torch.where(first, nxt_after - pos, 0).to(torch.int32)
    return torch.where(first, keys, sentinel), counts


# The kernel's launch layout (``launch`` in csrc/rowsort.cu): threads of
# a register-path block, log2 of the keys a thread holds (and of the
# wider choice), the uint32 width from which a thread holds the wider
# count, the narrowest row.
_REG_THREADS, _LOG_KEYS, _LOG_KEYS_WIDE, _WIDE_FROM_32, _MIN_WIDTH = 256, 3, 4, 256, 32


def checksum_rows_per_block(w: int, large: bool) -> int:
    """Reads in one thread block of the row-sort kernel for rows of
    ``w`` windows (``large``: the uint64 keys above k = 15), so reads
    per entry of its checksum: several rows a block up to 4096 keys a
    row, one above."""
    n = 1 << max(w - 1, 0).bit_length()
    if n > _REG_THREADS << _LOG_KEYS_WIDE:
        return 1
    width = max(n, _MIN_WIDTH)
    wide = width > _REG_THREADS << _LOG_KEYS or (not large and width >= _WIDE_FROM_32)
    return (_REG_THREADS << (_LOG_KEYS_WIDE if wide else _LOG_KEYS)) // width


def _block_checksum(low_key: torch.Tensor, counts: torch.Tensor, large: bool) -> torch.Tensor:
    """The kernel's ``chk`` from finished rows: a run start's count is
    at least 1 and every other cell's 0."""
    b, w = counts.shape
    start = counts > 0
    row = ((counts & 3) + torch.where(start, low_key & 3, 0)).sum(1, dtype=torch.int64)
    rows = checksum_rows_per_block(w, large)
    padded = torch.zeros(-(-b // rows) * rows, dtype=torch.int64, device=counts.device)
    padded[:b] = row
    return padded.view(-1, rows).sum(1)


def rowsort_rle_plain(codes: torch.Tensor, k: int, canonical: bool = False, *,
                      checksum: bool = False):
    """Per-read sparse rows for k <= 15, plain route on any device.

    codes: [B, L] int8 → (idx, counts), both [B, W] int32 with
    W = L-k+1; the sentinel is ``4**k``.  ``checksum=True`` also returns
    the kernel's ``chk``.
    """
    if not 1 <= k <= MAX_SPARSE_PERREAD_K:
        raise ValueError(f"k must be in [1, {MAX_SPARSE_PERREAD_K}]")
    sent = 4**k
    idx = window_indices(codes, k, canonical)  # [B, W], -1 invalid
    x = torch.where(idx < 0, sent, idx)
    x = torch.sort(x, dim=-1).values
    idx, counts = rle_rows(x, x != sent, sent)
    if checksum:
        return idx, counts, _block_checksum(idx, counts, False)
    return idx, counts


def rowsort_rle_large_plain(codes: torch.Tensor, k: int,
                            canonical: bool = False, *, checksum: bool = False):
    """Per-read sparse rows for 16 <= k <= 31, plain route on any device.

    codes: [B, L] int8 → (hi, lo, counts), each [B, W] int32; hi and lo
    are bit views of the uint32 (hi, lo) split of ``ops/sparse.py``,
    sorted lexicographically, with sentinel 0xFFFFFFFF at non-run-start
    cells.  Validity is judged on lo: a 16-T prefix makes a real hi equal
    the sentinel.  ``checksum=True`` also returns the kernel's ``chk``.
    """
    if not 16 <= k <= 31:
        raise ValueError("count_perread_sparse_large needs 16 <= k <= 31")
    hi, lo = kmer_keys(codes, k, canonical)
    key = torch.where(
        lo != INVALID_SENTINEL, (hi << (2 * LO_BASES)) | lo, KEY64_SENTINEL
    )
    key = torch.sort(key, dim=-1).values
    key, counts = rle_rows(key, key != KEY64_SENTINEL, KEY64_SENTINEL)
    real = key != KEY64_SENTINEL
    hi = torch.where(real, key >> (2 * LO_BASES), INVALID_SENTINEL).to(torch.int32)
    lo = torch.where(real, key & LO_MASK, INVALID_SENTINEL).to(torch.int32)
    if checksum:
        return hi, lo, counts, _block_checksum(lo, counts, True)
    return hi, lo, counts


def _upper_bound(s: torch.Tensor, key: torch.Tensor, lo: torch.Tensor,
                 hi: int) -> torch.Tensor:
    """The kernel's run-end search, vectorised: for each (row, cell), the
    binary search for the first index in [lo, hi) of row ``s`` whose
    key is greater than ``key``, step for step as ``upper_bound`` in
    ``csrc/rowsort.cu`` (on unsorted rows too)."""
    hi = torch.full_like(lo, hi)
    while True:
        active = lo < hi
        if not bool(active.any()):
            return lo
        mid = (lo + hi) >> 1
        greater = torch.gather(s, 1, mid.clamp(max=s.shape[1] - 1)) > key
        hi = torch.where(active & greater, mid, hi)
        lo = torch.where(active & ~greater, mid + 1, lo)


def rowsort_probe_plain(codes: torch.Tensor, k: int, variant: str,
                        canonical: bool = False) -> torch.Tensor:
    """The probe's per-row checksums ([B] int64), plain route on any
    device: keys built, padded with the sentinel to the kernel's power
    of two, then the stages of ``variant`` (see ``PROBE_VARIANTS``)."""
    w = _probe_check(codes, k, variant)
    b = codes.shape[0]
    if k <= MAX_SPARSE_PERREAD_K:
        sent = 4**k
        keys = window_indices(codes, k, canonical).to(torch.int64)
        keys = torch.where(keys < 0, sent, keys)
    else:
        sent = KEY64_SENTINEL
        hi, lo = kmer_keys(codes, k, canonical)
        keys = torch.where(lo != INVALID_SENTINEL, (hi << (2 * LO_BASES)) | lo, sent)
    n = 1 << max(w - 1, 0).bit_length()
    s = torch.full((b, n), sent, dtype=torch.int64, device=codes.device)
    s[:, :w] = keys
    if variant in ("full", "sortonly"):
        s = torch.sort(s, dim=-1).values
    key = s[:, :w]
    pos = torch.arange(w, device=codes.device).expand(b, w)
    if variant in ("sortonly", "noop"):
        return ((key ^ pos) & 3).sum(1)
    first = key != sent
    first[:, 1:] &= key[:, 1:] != key[:, :-1]
    count = _upper_bound(s, key, pos + 1, n) - pos
    return torch.where(first, (count & 3) + (key & 3), 0).sum(1)


# ------------------------------------------- the kernel's key arithmetic

UNIT_BASES = 16  # cfrk::kUnitBases: bases in one packed 32-bit unit

_U32 = np.uint64(0xFFFFFFFF)  # the model computes 32-bit words in uint64


def packed_units(w: int) -> int:
    """Units the kernel packs for a row of ``w`` windows (``units_of`` of
    ``csrc/rowsort.cu`` at the row's sort width, the power of two >= w
    and >= 32): its windows' units and two more, which a window of 31
    bases can reach into."""
    width = max(32, 1 << max(w - 1, 0).bit_length())
    return width // UNIT_BASES + 2


def pack_units_model(row: np.ndarray, n_units: int):
    """numpy model of ``cfrk::pack_unit`` over one row of int8 codes.

    Returns ``(bases, invalid)``, uint64 arrays of ``n_units`` 32-bit
    values: unit h packs the codes ``row[16h : 16h+16]`` at 2 bits a
    base, base 0 in the two most significant bits (an invalid base packs
    as 0); bit b of ``invalid[h]`` is set iff code ``16h+b`` is < 0 or
    lies past the row's end.
    """
    codes = np.full(n_units * UNIT_BASES, -1, np.int64)
    n = min(len(row), codes.size)
    codes[:n] = row[:n]
    codes = codes.reshape(n_units, UNIT_BASES)
    bases = np.zeros(n_units, np.uint64)
    invalid = np.zeros(n_units, np.uint64)
    for b in range(UNIT_BASES):
        code = codes[:, b]
        bases = (bases << np.uint64(2)) | np.where(code < 0, 0, code & 3).astype(np.uint64)
        invalid |= (code < 0).astype(np.uint64) << np.uint64(b)
    return bases, invalid


def _funnelshift_l(lo, hi, shift):
    """``__funnelshift_l``: the most significant 32 bits of hi:lo shifted
    left by ``shift & 31``."""
    return ((((hi << np.uint64(32)) | lo) << (shift & np.uint64(31)))
            >> np.uint64(32)) & _U32


def _funnelshift_r(lo, hi, shift):
    """``__funnelshift_r``: the least significant 32 bits of hi:lo shifted
    right by ``shift & 31``."""
    return (((hi << np.uint64(32)) | lo) >> (shift & np.uint64(31))) & _U32


def _brev(x, bits: int):
    """``__brev`` / ``__brevll``: the low ``bits`` bits of x reversed."""
    out = np.zeros_like(x)
    for i in range(bits):
        out |= ((x >> np.uint64(i)) & np.uint64(1)) << np.uint64(bits - 1 - i)
    return out


def _swap_pairs(x):
    """``cfrk::swap_pairs``: the two bits of every 2-bit group swapped."""
    odd = np.uint64(0x5555555555555555)
    return ((x & odd) << np.uint64(1)) | ((x >> np.uint64(1)) & odd)


def packed_window_keys_model(bases, invalid, p, k: int, canonical: bool,
                             bits: int, sentinel: int):
    """numpy model of ``cfrk::packed_window_key`` (and of ``key_at`` of
    ``csrc/rowsort.cu``, which feeds it) for the windows that start at
    positions ``p`` of a row packed by :func:`pack_units_model`.

    ``bits`` is the key width: 32 (k <= 15, the ``rowsort_rle`` kernel)
    or 64 (k <= 31, ``rowsort_rle_large``).  Returns uint64 keys, with
    ``sentinel`` where a window holds an invalid code.  The row must
    have two units past the one the last window starts in.
    """
    if bits not in (32, 64) or not 1 <= k <= (15 if bits == 32 else 31):
        raise ValueError(f"k={k} does not fit {bits}-bit keys")
    p = np.asarray(p, np.int64)
    word = np.uint64((1 << bits) - 1)
    # key_at: the three units from the window's, the invalid bits from p on.
    u0, u1, u2 = (bases[(p >> 4) + i] for i in range(3))
    bad = invalid[0::2] | (invalid[1::2] << np.uint64(16))  # read as 32-bit
    m0, m1 = bad[p >> 5], bad[(p >> 5) + 1]
    invalid_from_p = _funnelshift_r(m0, m1, (p & 31).astype(np.uint64))
    o = (p & 15).astype(np.uint64)
    # packed_window_key
    is_invalid = (invalid_from_p & np.uint64((1 << k) - 1)) != 0
    if bits == 32:
        x = _funnelshift_l(u1, u0, np.uint64(2) * o)
    else:
        x = (_funnelshift_l(u1, u0, np.uint64(2) * o) << np.uint64(32)) | (
            _funnelshift_l(u2, u1, np.uint64(2) * o))
    reversed_ = _brev(~x & word, bits)
    fwd = x >> np.uint64(bits - 2 * k)
    key = fwd
    if canonical:
        rc = _swap_pairs(reversed_) & np.uint64((1 << (2 * k)) - 1)
        key = np.where(rc < fwd, rc, fwd)
    return np.where(is_invalid, np.uint64(sentinel), key)


def sort_in_registers_model(keys: np.ndarray, keys_per_thread: int) -> np.ndarray:
    """numpy model of ``sort_in_registers`` of ``csrc/rowsort.cu``: one
    row of ``width`` keys (a power of two) held by ``width / K`` threads,
    thread t the keys ``[t*K, (t+1)*K)``.  Strides below K exchange a
    thread's own keys, strides up to 16 K a thread's keys with those of
    lane ``t ^ (stride / K)`` (the shuffle), wider strides pairs of the
    row in shared memory (``shared_stage``); pair (i, i + stride) of a
    merge of ``size`` ascends iff ``(i & size) == 0``.  Returns the row
    as the threads hold it at the end: sorted ascending."""
    kk = keys_per_thread
    width = keys.size
    v = np.array(keys).reshape(width // kk, kk)
    t = np.arange(width // kk)

    def compare_exchange(e, f, ascending):
        a, b = v[:, e].copy(), v[:, f].copy()
        exchange = (b < a) == ascending
        v[:, e] = np.where(exchange, b, a)
        v[:, f] = np.where(exchange, a, b)

    def register_strides(first, ascending):
        stride = first
        while stride:
            for e in range(kk):
                if e & stride == 0:
                    compare_exchange(e, e | stride, ascending(e))
            stride >>= 1

    size = 2
    while size <= kk:  # merges of up to K keys lie inside one thread
        if size < kk:
            register_strides(size >> 1, lambda e: (e & size) == 0)
        else:
            register_strides(size >> 1, lambda e: (t & 1) == 0)
        size <<= 1
    while size <= width:
        ascending = (t & (size // kk)) == 0
        stride = size >> 1
        if stride >= 32 * kk:  # pairs of two warps: shared memory
            s = v.reshape(-1)
            while stride >= 32 * kk:
                q = np.arange(width >> 1)
                i = 2 * q - (q & (stride - 1))
                a, b = s[i].copy(), s[i + stride].copy()
                swap = (a > b) == ((i & size) == 0)
                s[i] = np.where(swap, b, a)
                s[i + stride] = np.where(swap, a, b)
                stride >>= 1
            v = s.reshape(width // kk, kk)
        while stride >= kk:  # warp shuffles
            lane_mask = stride // kk
            keep_low = ((t & lane_mask) == 0) == ascending
            other = v[t ^ lane_mask]
            v = np.where((other < v) == keep_low[:, None], other, v)
            stride >>= 1
        register_strides(kk >> 1, lambda e: ascending)
        size <<= 1
    return v.reshape(-1)


# ---------------------------------------------------------------- kernels


@once
def _library() -> ctypes.CDLL:
    lib = load_library("rowsort")
    lib.cfrk_rowsort_rle.argtypes = [_PTR] * 4 + [_INT] * 5 + [_PTR]
    lib.cfrk_rowsort_rle.restype = _INT
    lib.cfrk_rowsort_rle_large.argtypes = [_PTR] * 5 + [_INT] * 5 + [_PTR]
    lib.cfrk_rowsort_rle_large.restype = _INT
    lib.cfrk_rowsort_probe.argtypes = [_PTR, _PTR] + [_INT] * 7 + [_PTR]
    lib.cfrk_rowsort_probe.restype = _INT
    return lib


def _check(codes: torch.Tensor, k: int, lo: int, hi: int) -> int:
    """Validate a code batch; returns W = L-k+1."""
    if codes.ndim != 2 or codes.dtype != torch.int8:
        raise ValueError(
            f"codes must be a [B, L] int8 tensor, got {tuple(codes.shape)} "
            f"{codes.dtype}"
        )
    if not lo <= k <= hi:
        raise ValueError(f"k={k} outside [{lo}, {hi}]")
    w = codes.shape[1] - k + 1
    if w <= 0:
        raise ValueError(f"read length {codes.shape[1]} < k={k}")
    if codes.device.type != "cuda":
        raise ValueError(f"codes on {codes.device}: the kernel needs CUDA")
    if w > rowsort_max_windows(k):
        raise ValueError(
            f"{w} windows/read exceeds the kernel ceiling "
            f"{rowsort_max_windows(k)}; use count_perread_rows_tiled"
        )
    return w


def _launch(kernel: str, fn, codes: torch.Tensor, outs, chk, k: int, w: int,
            canonical: bool) -> None:
    b, length = codes.shape
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = launch(
            kernel, fn, codes.data_ptr(), *(o.data_ptr() for o in outs),
            None if chk is None else chk.data_ptr(),
            b, length, w, k, int(canonical), stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def _checksum_out(codes: torch.Tensor, w: int, large: bool, checksum: bool):
    if not checksum:
        return None
    blocks = -(-codes.shape[0] // checksum_rows_per_block(w, large))
    return torch.empty(blocks, dtype=torch.int64, device=codes.device)


def rowsort_rle(codes: torch.Tensor, k: int, canonical: bool = False, *,
                checksum: bool = False):
    """Per-read sparse rows for 1 <= k <= 15, fused CUDA kernel.

    codes [B, L] int8 → (idx, counts) [B, W] int32, W = L-k+1: rows
    ascending, a run start holds the index and its count, every other
    cell the sentinel ``4**k`` and 0.  ``checksum=True`` also returns
    ``chk`` (see the module's docstring).
    """
    if codes.device.type == "cpu":
        with span("cfrk.rowsort_rle.plain"):
            return count_out(rowsort_rle_plain(codes, k, canonical, checksum=checksum))
    w = _check(codes, k, 1, MAX_SPARSE_PERREAD_K)
    codes = codes.contiguous()
    idx = torch.empty((codes.shape[0], w), dtype=torch.int32, device=codes.device)
    cnt = torch.empty_like(idx)
    chk = _checksum_out(codes, w, False, checksum)
    if codes.shape[0]:
        _launch("rowsort_rle", _library().cfrk_rowsort_rle, codes, (idx, cnt), chk, k, w,
                canonical)
        rowsort_rle.launches += 1
    return count_out((idx, cnt) if chk is None else (idx, cnt, chk))


def rowsort_rle_large(codes: torch.Tensor, k: int, canonical: bool = False, *,
                      checksum: bool = False):
    """Per-read sparse rows for 16 <= k <= 31, fused CUDA kernel.

    codes [B, L] int8 → (hi, lo, counts) [B, W] int32: hi and lo are bit
    views of the uint32 (hi, lo) key words, sorted lexicographically,
    sentinel 0xFFFFFFFF (-1 as int32) at non-run-start cells.
    ``checksum=True`` also returns ``chk`` (see the module's docstring).
    """
    if codes.device.type == "cpu":
        with span("cfrk.rowsort_rle_large.plain"):
            return count_out(rowsort_rle_large_plain(codes, k, canonical,
                                                     checksum=checksum))
    w = _check(codes, k, 16, 31)
    codes = codes.contiguous()
    hi = torch.empty((codes.shape[0], w), dtype=torch.int32, device=codes.device)
    lo = torch.empty_like(hi)
    cnt = torch.empty_like(hi)
    chk = _checksum_out(codes, w, True, checksum)
    if codes.shape[0]:
        _launch("rowsort_rle_large", _library().cfrk_rowsort_rle_large, codes,
                (hi, lo, cnt), chk, k, w, canonical)
        rowsort_rle_large.launches += 1
    return count_out((hi, lo, cnt) if chk is None else (hi, lo, cnt, chk))


rowsort_rle.launches = 0
rowsort_rle_large.launches = 0


def _probe_check(codes: torch.Tensor, k: int, variant: str) -> int:
    """Validate a probe call; returns W = L-k+1."""
    if variant not in PROBE_VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}; "
                         f"choose from {sorted(PROBE_VARIANTS)}")
    if codes.ndim != 2 or codes.dtype != torch.int8:
        raise ValueError(
            f"codes must be a [B, L] int8 tensor, got {tuple(codes.shape)} "
            f"{codes.dtype}"
        )
    if not 1 <= k <= 31:
        raise ValueError(f"k={k} outside [1, 31]")
    w = codes.shape[1] - k + 1
    if w <= 0:
        raise ValueError(f"read length {codes.shape[1]} < k={k}")
    if w > rowsort_max_windows(k):
        raise ValueError(f"{w} windows/read exceeds the kernel ceiling "
                         f"{rowsort_max_windows(k)}")
    return w


def rowsort_probe(codes: torch.Tensor, k: int, variant: str,
                  canonical: bool = False) -> torch.Tensor:
    """One probe variant of the rowsort kernel (uint32 keys for k <= 15,
    uint64 above): codes [B, L] int8 → [B] int64 checksums, equal to
    :func:`rowsort_probe_plain`'s."""
    if codes.device.type == "cpu":
        with span("cfrk.rowsort_probe.plain"):
            return count_out(rowsort_probe_plain(codes, k, variant, canonical))
    w = _probe_check(codes, k, variant)
    if codes.device.type != "cuda":
        raise ValueError(f"codes on {codes.device}: the kernel needs CUDA")
    codes = codes.contiguous()
    b, length = codes.shape
    chk = torch.empty(b, dtype=torch.int64, device=codes.device)
    if b:
        with torch.cuda.device(codes.device):
            stream = torch.cuda.current_stream(codes.device).cuda_stream
            err = launch(
                "rowsort_probe", _library().cfrk_rowsort_probe,
                codes.data_ptr(), chk.data_ptr(), b, length, w, k,
                int(canonical), int(k > MAX_SPARSE_PERREAD_K),
                PROBE_VARIANTS[variant], stream,
            )
        if err != 0:
            raise RuntimeError(f"cfrk_rowsort_probe launch failed: CUDA error {err}")
        rowsort_probe.launches += 1
    return count_out(chk)


rowsort_probe.launches = 0
register_launches(rowsort_rle, rowsort_rle_large, rowsort_probe)
