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
against the plain key functions; :func:`sort_in_registers_model` models
the uint32 and uint64 sort network.  At k <= 8, rows of up to 4096 keys
sort two 16-bit keys a register (``rowsort_rle_pairs``;
:func:`key16_path` mirrors the launch rule): :func:`pair_keys_model`,
:func:`sort_pairs_model` and :func:`finish_pairs_model` model its key
build, its network and its emit.  Where W lies just above a power of two
P and the batch fills the card, two reads share the words instead, a head of P cells and a short tail
sorted apart and merged (``rowsort_rle_split``; :func:`split_path`
mirrors the launch rule, :func:`split_keys_model` and
:func:`sort_split_model` model it).  Above k = 15, rows of up to 256 keys
sort 32-bit prefix-and-position words, gather the full keys and repair
a warp's rows where two distinct keys shared a prefix
(``rowsort_rle_prefix``; :func:`prefix_path` mirrors the launch rule,
:func:`sort_prefix_model` models it, and :func:`rowsort_fallbacks` / :func:`rowsort_fallbacks_plain`
read which rows were repaired).  The kernels' output is array-equal to
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
route.  Each wrapper validates with ``build.check_codes`` and launches
with ``build.launch_kernel``, which counts its launches under
``cfrk.<wrapper>.launches``, so a run can show it went through the
kernel; it counts the bytes it returns under ``cfrk.out_bytes``.  Its
launch is the span ``cfrk.<wrapper>.launch`` (``.first_launch`` the
first time), its plain twin ``cfrk.<wrapper>.plain``
(``runtime/metrics.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...runtime.metrics import count_out, span
from ..encode import window_indices
from ..sparse import INVALID_SENTINEL, LO_BASES, kmer_keys
from .build import check_codes, launch_kernel, load_library, once

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
    "key16_path",
    "split_path",
    "keys_per_thread",
    "PAD16",
    "pair_keys_model",
    "sort_pairs_model",
    "split_keys_model",
    "sort_split_model",
    "finish_pairs_model",
    "prefix_path",
    "prefix_words_model",
    "sort_prefix_model",
    "rowsort_fallbacks",
    "rowsort_fallbacks_plain",
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
# The probe kernel's readout of the prefix path (rowsort_fallbacks), not a
# timed variant.
_FALLBACK_VARIANT = 5

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
# count, the narrowest row, the largest k of the 16-bit path (whose
# threads hold as many keys, two a word, in the same rows a block).
_REG_THREADS, _LOG_KEYS, _LOG_KEYS_WIDE, _WIDE_FROM_32, _MIN_WIDTH = 256, 3, 4, 256, 32
_MAX_PAIR_K = 8

# The widest row of the prefix path: one warp's threads.
_MAX_PREFIX_WIDTH = 32 << _LOG_KEYS

# The split at k <= 8 (``rowsort_rle_split``): kSplitShift, kMinSplitHead,
# kMaxSplitHead, kSplitWords (head words a thread), kMinTail and
# kMinSplitBlocks (the least grid).
_SPLIT_SHIFT, _MIN_SPLIT_HEAD, _MAX_SPLIT_HEAD, _SPLIT_WORDS, _MIN_TAIL = 2, 128, 256, 8, 8
_MIN_SPLIT_BLOCKS = 512


def _sort_width(w: int) -> int:
    """The register path's row width for ``w`` windows: the power of
    two >= w and >= 32; above 4096 the row takes the shared-memory
    network."""
    return max(_MIN_WIDTH, 1 << max(w - 1, 0).bit_length())


def key16_path(w: int, k: int) -> bool:
    """Whether the kernel sorts rows of ``w`` windows at this k two keys
    a register (16-bit keys): k <= 8 and rows of up to 4096 keys."""
    return k <= _MAX_PAIR_K and _sort_width(w) <= _REG_THREADS << _LOG_KEYS_WIDE


def split_path(w: int, k: int, b: int):
    """``(head, tail)`` where the kernel sorts ``b`` rows of ``w``
    windows at this k as a head and a tail, two reads a word
    (``rowsort_rle_split``), else None: k <= 8, P < w <= P + P/4 for
    the power of two P in [128, 256], and a grid of at least 512 blocks
    of 4096 / P reads (b >= 16384 at P = 128, 8192 at P = 256); the tail
    is the power of two >= max(w - P, 8)."""
    head = _sort_width(w) >> 1
    if not (k <= _MAX_PAIR_K and _MIN_SPLIT_HEAD <= head <= _MAX_SPLIT_HEAD
            and w - head <= head >> _SPLIT_SHIFT
            and b >= _MIN_SPLIT_BLOCKS * (2 * _REG_THREADS * _SPLIT_WORDS // head)):
        return None
    return head, max(_MIN_TAIL, 1 << (w - head - 1).bit_length())


def prefix_path(w: int, k: int) -> bool:
    """Whether the kernel sorts rows of ``w`` windows at this k as 32-bit
    prefix-and-position words: the uint64 keys (k > 15, which take
    ``rowsort_rle_large`` and the probe's uint64 kernel) in rows of up
    to 256 keys, one warp's threads."""
    return k > MAX_SPARSE_PERREAD_K and _sort_width(w) <= _MAX_PREFIX_WIDTH


def keys_per_thread(width: int, large: bool) -> int:
    """Keys a thread of the register path holds in rows of ``width``
    keys (``large``: the uint64 keys above k = 15); the 16-bit path's
    threads hold as many, two a word."""
    wide = width > _REG_THREADS << _LOG_KEYS or (not large and width >= _WIDE_FROM_32)
    return 1 << (_LOG_KEYS_WIDE if wide else _LOG_KEYS)


def checksum_rows_per_block(w: int, k: int, b: int) -> int:
    """Reads in one thread block of the row-sort kernel for ``b`` rows
    of ``w`` windows at this k, so reads per entry of its checksum:
    several rows a block up to 4096 keys a row, one above; a split row's
    pair of reads shares head / 8 threads."""
    split = split_path(w, k, b)
    if split:
        return 2 * _REG_THREADS * _SPLIT_WORDS // split[0]
    width = _sort_width(w)
    if width > _REG_THREADS << _LOG_KEYS_WIDE:
        return 1
    return _REG_THREADS * keys_per_thread(width, k > MAX_SPARSE_PERREAD_K) // width


def _block_checksum(low_key: torch.Tensor, counts: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's ``chk`` from finished rows: a run start's count is
    at least 1 and every other cell's 0."""
    b, w = counts.shape
    start = counts > 0
    row = ((counts & 3) + torch.where(start, low_key & 3, 0)).sum(1, dtype=torch.int64)
    rows = checksum_rows_per_block(w, k, b)
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
        return idx, counts, _block_checksum(idx, counts, k)
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
        return hi, lo, counts, _block_checksum(lo, counts, k)
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
    """The probe's per-row checksums ([B] int64), plain route on the
    CPU or CUDA: keys built, padded with the sentinel to the kernel's power
    of two, then the stages of ``variant`` (see ``PROBE_VARIANTS``)."""
    _probe_variant(variant)
    w = check_codes(codes, k, 1, 31, rowsort_max_windows(k))
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
    return _sort_width(w) // UNIT_BASES + 2


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


_LOW16 = np.uint32(0xFFFF)
_HIGH16 = np.uint32(0xFFFF0000)
PAD16 = 0xFFFF  # a 16-bit cell that holds no real key (kPad16)


def _min_u16x2(a, b):
    """``min.u16x2``: the smaller of each 16-bit lane."""
    return (np.minimum(a & _LOW16, b & _LOW16)
            | (np.minimum(a >> np.uint32(16), b >> np.uint32(16)) << np.uint32(16)))


def _max_u16x2(a, b):
    """``max.u16x2``: the larger of each 16-bit lane."""
    return (np.maximum(a & _LOW16, b & _LOW16)
            | (np.maximum(a >> np.uint32(16), b >> np.uint32(16)) << np.uint32(16)))


def pair_keys_model(bases, invalid, width: int, k: int, canonical: bool,
                    words_per_thread: int, start: int = 0):
    """numpy model of the key build of ``rowsort_rle_pairs`` in
    ``csrc/rowsort.cu`` (``real_windows``, ``build_pairs``) over one row
    packed by :func:`pack_units_model` into ``packed_units(width)``
    units: thread t builds the windows from ``t*K`` and from
    ``width/2 + t*K`` (K = ``words_per_thread``).  Returns ``(keys,
    n_valid)``: the row's ``width`` keys by window, uint32, ``PAD16``
    where a window is not real, and the number of real windows.  With
    ``start``, the ``width`` windows from there (a multiple of K), as
    ``rowsort_rle_split`` builds its tails."""
    kw = words_per_thread
    bad = invalid[0::2] | (invalid[1::2] << np.uint64(16))  # read as 32-bit
    p = start + np.arange(0, width, kw)  # the first window of each run of K
    # real_windows: the invalid bits from p on, each OR-ed with the k - 1
    # that follow it.
    any_ = _funnelshift_r(bad[p >> 5], bad[(p >> 5) + 1], (p & 31).astype(np.uint64))
    span = 1
    while 2 * span <= k:
        any_ |= any_ >> np.uint64(span)
        span <<= 1
    if span < k:
        any_ |= any_ >> np.uint64(k - span)
    real = ~any_ & _U32
    e = np.arange(kw, dtype=np.uint64)
    is_real = ((real[:, None] >> e) & np.uint64(1)).astype(bool).reshape(-1)
    key = packed_window_keys_model(bases, np.zeros_like(invalid),
                                   np.arange(start, start + width), k, canonical, 32, 0)
    keys = np.where(is_real, key, PAD16).astype(np.uint32)
    return keys, int(is_real.sum())


def _exchange_words(v, e, f, lower, upper):
    """``exchange_words``: words e and f of every thread's ``v`` in
    ascending order, by the ``lower`` / ``upper`` of the word type."""
    a, b = v[:, e].copy(), v[:, f].copy()
    v[:, e] = lower(a, b)
    v[:, f] = upper(a, b)


def _register_words(v, lower, upper):
    """``register_words``: the cleaner strides below K, inside each
    thread."""
    kw = v.shape[1]
    stride = kw >> 1
    while stride:
        for e in range(kw):
            if e & stride == 0:
                _exchange_words(v, e, e | stride, lower, upper)
        stride >>= 1


def _merge_words(v, n, stride, mirror, lower, upper):
    """numpy model of ``merge_words`` of ``csrc/rowsort.cu`` over the
    ``[n / K, K]`` words ``v`` of one row (thread t the row ``v[t]``):
    from word stride ``stride`` down to 1, the first the mirror stage
    when ``mirror``.  Strides of 32 K and more pair words in shared
    memory (``shared_words``), strides from K a thread's words with those
    of lane ``t ^ mask`` (the shuffle), the rest a thread's own.
    Returns the words."""
    threads, kw = v.shape
    t = np.arange(threads)
    if stride >= 32 * kw:  # pairs of two warps: shared memory
        s = v.reshape(-1)
        while stride >= 32 * kw:
            q = np.arange(n >> 1)
            i = 2 * q - (q & (stride - 1))
            j = i ^ (2 * stride - 1) if mirror else i + stride
            a, b = s[i].copy(), s[j].copy()
            s[i] = lower(a, b)
            s[j] = upper(a, b)
            stride >>= 1
            mirror = False
        v = s.reshape(threads, kw)
    elif mirror:  # word e against word K-1-e of lane t ^ mask
        keep_low = (t & (stride // kw)) == 0
        other = v[t ^ (2 * stride // kw - 1)][:, ::-1]
        v = np.where(keep_low[:, None], lower(v, other), upper(v, other))
        stride >>= 1
    while stride >= kw:  # warp shuffles
        lane_mask = stride // kw
        keep_low = (t & lane_mask) == 0
        other = v[t ^ lane_mask]
        v = np.where(keep_low[:, None], lower(v, other), upper(v, other))
        stride >>= 1
    _register_words(v, lower, upper)
    return v


def _flip_sort(v, lower, upper):
    """numpy model of ``flip_sort``: the ``[n / K, K]`` words ``v`` of one
    row sorted ascending by the flip form of the bitonic network, every
    pair ascending (a merge of ``size`` pairs word i first with
    ``i ^ (size - 1)``, then cleans at size/4, ..., 1).  Returns the
    words."""
    threads, kw = v.shape
    n = threads * kw
    size = 2
    while size <= kw:  # merges of up to K words lie inside one thread
        for e in range(kw):
            if e & (size >> 1) == 0:
                _exchange_words(v, e, e ^ (size - 1), lower, upper)
        stride = size >> 2
        while stride:
            for e in range(kw):
                if e & stride == 0:
                    _exchange_words(v, e, e | stride, lower, upper)
            stride >>= 1
        size <<= 1
    while size <= n:
        v = _merge_words(v, n, size >> 1, True, lower, upper)
        size <<= 1
    return v


def sort_pairs_model(keys: np.ndarray, words_per_thread: int) -> np.ndarray:
    """numpy model of ``sort_pairs`` of ``csrc/rowsort.cu``: one row of
    ``width`` 16-bit keys (a power of two) as ``width/2`` words, word j
    keys j (low lane) and j + width/2 (high lane), thread t the words
    ``[t*K, (t+1)*K)`` (K = ``words_per_thread``).  Each lane's half
    sorts with the flip form of the bitonic network, every pair
    ascending, the high lane complemented; then one stage inside each
    word and the cleaners from width/4 down.  Strides below K exchange a
    thread's own words, strides up to 16 K a thread's words with those
    of lane ``t ^ mask`` (the shuffle), wider strides pairs of words in
    shared memory (``shared_words``).  Returns the row's cells as the
    kernel stores them: sorted ascending."""
    kw = words_per_thread
    half = keys.size // 2
    keys = np.asarray(keys, np.uint32)
    v = (keys[:half] | (keys[half:] << np.uint32(16))).reshape(half // kw, kw)
    v = _flip_sort(v ^ _HIGH16, _min_u16x2, _max_u16x2)
    w = v ^ _HIGH16
    swapped = ((w & _LOW16) << np.uint32(16)) | (w >> np.uint32(16))
    v = (_min_u16x2(w, swapped) & _LOW16) | (_max_u16x2(w, swapped) & _HIGH16)
    words = _merge_words(v, half, half >> 1, False, _min_u16x2, _max_u16x2).reshape(-1)
    return np.concatenate([words & _LOW16, words >> np.uint32(16)])


def _tail_words_per_thread(head: int, tail: int) -> int:
    """kTailWords of the split's launch: 1 or 2 tail words for each of
    the head / 8 threads of a pair of reads."""
    threads = head // _SPLIT_WORDS
    assert tail <= 2 * threads, "a tail takes at most two words a thread"
    return 1 if tail <= threads else 2


def split_keys_model(packed_a, packed_b, head: int, tail: int, k: int, canonical: bool):
    """numpy model of the key build of ``rowsort_rle_split`` in
    ``csrc/rowsort.cu`` (``build_words`` over two reads) for two reads
    packed by :func:`pack_units_model` (``packed_*`` = ``(bases,
    invalid)``; a read past the batch packs as all invalid): thread t
    builds head windows ``[8t, 8t + 8)`` and tail windows ``head +
    [t*K, (t+1)*K)`` (K of :func:`_tail_words_per_thread`), read a's key
    in the low lane, read b's in the high lane.  Returns ``(head_words,
    tail_words, n_valid)``: uint32 words by window, ``PAD16`` in a lane
    whose window is not real, and the two reads' real windows."""
    words, n_valid = [], [0, 0]
    for start, width, kw in ((0, head, _SPLIT_WORDS),
                             (head, tail, _tail_words_per_thread(head, tail))):
        lanes = []
        for lane, (bases, invalid) in enumerate((packed_a, packed_b)):
            keys, nv = pair_keys_model(bases, invalid, width, k, canonical, kw, start)
            lanes.append(keys)
            n_valid[lane] += nv
        words.append(lanes[0] | (lanes[1] << np.uint32(16)))
    return words[0], words[1], tuple(n_valid)


def _count_below(s: np.ndarray, x):
    """``count_below``: the keys of the sorted ``s`` (a power of two of
    them) below each x, by the kernel's branchless search."""
    pos = np.zeros(np.shape(x), np.int64)
    step = s.size >> 1
    while step:
        pos += np.where(s[pos + step - 1] < x, step, 0)
        step >>= 1
    return pos + (s[pos] < x)


def _merge_row(s: np.ndarray, head: int, tail: int, out: np.ndarray) -> None:
    """``merge_row`` for every thread of one read, the threads side by
    side: thread t's head keys j in ``[8t, 8t + 8)`` to ``out[j + c]``, c
    the tail's keys below key j (one search for the first, thread 0
    from the tail's start, then a walk); a tail key the walk passes
    before head key j, or after the thread's last and below the next
    thread's first (above every key on the last thread), to its index
    plus j."""
    keys = s[:head].reshape(-1, _SPLIT_WORDS)
    tail_keys = s[head:]
    p0 = np.arange(0, head, _SPLIT_WORDS)

    def at(c):  # past the tail, a value above every key
        return np.where(c < tail, tail_keys[np.minimum(c, tail - 1)], 0x10000)

    def walk(c, nxt, x, j):  # place the tail keys below x at index + j
        while (nxt < x).any():
            step = nxt < x
            out[(c + j)[step]] = nxt[step]
            c = c + step
            nxt = at(c)
        return c, nxt

    c = np.where(p0 == 0, 0, _count_below(tail_keys, keys[:, 0]))
    nxt = at(c)
    for e in range(_SPLIT_WORDS):
        x = keys[:, e]
        c, nxt = walk(c, nxt, x, p0 + e)
        out[p0 + e + c] = x
    bound = np.append(keys[1:, 0], 0x10000)
    walk(c, nxt, bound, p0 + _SPLIT_WORDS)


def sort_split_model(head_words: np.ndarray, tail_words: np.ndarray):
    """numpy model of the sort and merge of ``rowsort_rle_split`` in
    ``csrc/rowsort.cu`` over the words of :func:`split_keys_model`: the
    head's ``head`` words sorted by one flip-form network, both 16-bit
    lanes ascending, 8 words a thread; the tail's words the same way,
    K a thread; then for each read (lane) its sorted head and tail,
    merged (:func:`_merge_row`): a head key to its index plus the tail's
    keys below it, a tail key to its index plus the head's keys at most
    it.  Returns the two reads' merged rows of ``head + tail`` cells
    (uint32): sorted ascending."""
    head, tail = head_words.size, tail_words.size
    kt = _tail_words_per_thread(head, tail)
    v = _flip_sort(np.array(head_words, np.uint32).reshape(-1, _SPLIT_WORDS),
                   _min_u16x2, _max_u16x2).reshape(-1)
    w = _flip_sort(np.array(tail_words, np.uint32).reshape(-1, kt),
                   _min_u16x2, _max_u16x2).reshape(-1)
    rows = []
    for shift in (np.uint32(0), np.uint32(16)):
        s = np.concatenate([(v >> shift) & _LOW16, (w >> shift) & _LOW16])
        out = np.full(head + tail, -1, np.int64)
        _merge_row(s, head, tail, out)
        rows.append(out.astype(np.uint32))
    return rows


_SENTINEL_WORD = 1 << 31  # kSentinelWord: the bit of an invalid window's word
_REPAIR_ROUNDS = 2  # kRepairRounds: odd-even transposition rounds before the network
_KEY64_ALL_ONES = np.uint64((1 << 64) - 1)  # the kernel's uint64 sentinel


def prefix_words_model(keys: np.ndarray, k: int) -> np.ndarray:
    """numpy model of the word build of ``sort_prefix_words`` in
    ``csrc/rowsort.cu`` over one row of ``width`` uint64 keys (a power
    of two, the kernel's all-ones sentinel at invalid windows and
    padding): the word of the key at position p is bit 31 for the
    sentinel, else the key's top ``31 - log2(width)`` bits, above the
    ``log2(width)`` bits of p.  Returns uint32 words."""
    keys = np.asarray(keys, np.uint64)
    width = keys.size
    log_width = width.bit_length() - 1
    shift = np.uint64(max(0, 2 * k - (31 - log_width)))
    p = np.arange(width, dtype=np.uint64)
    prefix = (keys >> shift) << np.uint64(log_width)
    words = np.where(keys == _KEY64_ALL_ONES, np.uint64(_SENTINEL_WORD), prefix) | p
    return words.astype(np.uint32)


def _transposition_round(keys: np.ndarray) -> np.ndarray:
    """``transposition_round``: one round of odd-even transposition over
    a row, the pairs (2i, 2i + 1), then (2i + 1, 2i + 2)."""
    keys = keys.copy()
    for start in (0, 1):
        i = np.arange(start, keys.size - 1, 2)
        lo, hi = np.minimum(keys[i], keys[i + 1]), np.maximum(keys[i], keys[i + 1])
        keys[i], keys[i + 1] = lo, hi
    return keys


def _descends(keys: np.ndarray) -> bool:
    """``out_of_order`` over a whole row."""
    return bool((keys[1:] < keys[:-1]).any())


def sort_prefix_model(keys: np.ndarray, k: int, keys_per_thread: int):
    """numpy model of ``sort_prefix_words`` of ``csrc/rowsort.cu`` over
    one row of ``width`` uint64 keys (up to 32 K, one warp's threads, K =
    ``keys_per_thread``; the all-ones sentinel at invalid windows and
    padding): the words of :func:`prefix_words_model` sorted by the flip
    form with whole-word min / max, the full keys gathered by the
    words' positions; where two distinct keys that share a prefix came
    out of order, up to ``kRepairRounds`` rounds of odd-even
    transposition, and if the keys are still out of order the uint64
    network (:func:`sort_in_registers_model`).  Returns ``(sorted keys,
    out_of_order, network)``: whether the row's own words left its keys
    out of order, and whether the network sorted them again.  (The
    kernel repairs a warp's rows together; a row in order is left as it
    is by either step.)"""
    keys = np.asarray(keys, np.uint64)
    width = keys.size
    if width > _MAX_PREFIX_WIDTH or width % keys_per_thread:
        raise ValueError(f"a row of {width} keys does not lie within a warp")
    words = prefix_words_model(keys, k).reshape(width // keys_per_thread, keys_per_thread)
    words = _flip_sort(words, np.minimum, np.maximum).reshape(-1)
    got = keys[words & np.uint32(width - 1)]
    out_of_order = left = _descends(got)
    for _ in range(_REPAIR_ROUNDS):
        if not left:
            break
        got = _transposition_round(got)
        left = _descends(got)
    if left:
        got = sort_in_registers_model(got, keys_per_thread)
    return got, out_of_order, left


def finish_pairs_model(s: np.ndarray, n_valid: int, w: int, k: int):
    """numpy model of ``finish_pairs_row`` (the production kernel's
    emit) over one sorted row of 16-bit cells: a run start is a cell
    below ``n_valid`` that differs from the one before; its run ends at
    the first larger key, cut at ``n_valid``.  Returns ``(idx, counts)``,
    int32 ``[w]``, with the sentinel ``4**k`` and 0 off the run
    starts."""
    s = np.asarray(s, np.int64)
    i = np.arange(w)
    key = s[:w]
    first = i < n_valid
    first[1:] &= key[1:] != key[:-1]
    end = np.minimum(np.searchsorted(s[:n_valid], key, side="right"), n_valid)
    counts = np.where(first, end - i, 0).astype(np.int32)
    return np.where(first, key, 4**k).astype(np.int32), counts


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


def _checksum_out(codes: torch.Tensor, w: int, k: int, checksum: bool):
    if not checksum:
        return None
    blocks = -(-codes.shape[0] // checksum_rows_per_block(w, k, codes.shape[0]))
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
    w = check_codes(codes, k, 1, MAX_SPARSE_PERREAD_K, ROWSORT_MAX_WINDOWS)
    codes = codes.contiguous()
    b, length = codes.shape
    idx = torch.empty((b, w), dtype=torch.int32, device=codes.device)
    cnt = torch.empty_like(idx)
    chk = _checksum_out(codes, w, k, checksum)
    if b:
        launch_kernel("rowsort_rle", _library().cfrk_rowsort_rle, codes.device,
                      codes.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
                      None if chk is None else chk.data_ptr(),
                      b, length, w, k, int(canonical))
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
    w = check_codes(codes, k, 16, 31, ROWSORT_MAX_WINDOWS_LARGE)
    codes = codes.contiguous()
    b, length = codes.shape
    hi = torch.empty((b, w), dtype=torch.int32, device=codes.device)
    lo = torch.empty_like(hi)
    cnt = torch.empty_like(hi)
    chk = _checksum_out(codes, w, k, checksum)
    if b:
        launch_kernel("rowsort_rle_large", _library().cfrk_rowsort_rle_large, codes.device,
                      codes.data_ptr(), hi.data_ptr(), lo.data_ptr(), cnt.data_ptr(),
                      None if chk is None else chk.data_ptr(),
                      b, length, w, k, int(canonical))
    return count_out((hi, lo, cnt) if chk is None else (hi, lo, cnt, chk))


def _probe_variant(variant: str) -> int:
    """The probe variant's number (``PROBE_VARIANTS``)."""
    if variant not in PROBE_VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}; "
                         f"choose from {sorted(PROBE_VARIANTS)}")
    return PROBE_VARIANTS[variant]


def rowsort_probe(codes: torch.Tensor, k: int, variant: str,
                  canonical: bool = False) -> torch.Tensor:
    """One probe variant of the rowsort kernel (16-bit keys two a
    register for k <= 8 and rows of up to 4096 keys, uint32 keys for
    k <= 15, uint64 above, as prefix-and-position words in rows of up to
    256 keys): codes [B, L] int8 → [B] int64 checksums, equal to
    :func:`rowsort_probe_plain`'s."""
    if codes.device.type == "cpu":
        with span("cfrk.rowsort_probe.plain"):
            return count_out(rowsort_probe_plain(codes, k, variant, canonical))
    number = _probe_variant(variant)
    w = check_codes(codes, k, 1, 31, rowsort_max_windows(k))
    return count_out(_probe_kernel(codes, k, w, canonical, number))


def _probe_kernel(codes: torch.Tensor, k: int, w: int, canonical: bool,
                  variant: int) -> torch.Tensor:
    """One launch of the probe kernel's ``variant`` (its number) on a
    validated CUDA batch; returns its [B] int64 output."""
    codes = codes.contiguous()
    b, length = codes.shape
    chk = torch.empty(b, dtype=torch.int64, device=codes.device)
    if b:
        launch_kernel("rowsort_probe", _library().cfrk_rowsort_probe, codes.device,
                      codes.data_ptr(), chk.data_ptr(), b, length, w, k,
                      int(canonical), int(k > MAX_SPARSE_PERREAD_K), variant)
    return chk


def _prefix_windows(codes: torch.Tensor, k: int) -> int:
    """W = L-k+1 of a batch whose rows take the prefix path, else a
    ValueError."""
    w = check_codes(codes, k, 1, 31)
    if not prefix_path(w, k):
        raise ValueError(f"k={k} and {w} windows a row do not take the prefix path "
                         f"(16 <= k <= 31, up to {_MAX_PREFIX_WIDTH} windows)")
    return w


def rowsort_fallbacks_plain(codes: torch.Tensor, k: int,
                            canonical: bool = False) -> torch.Tensor:
    """Which rows the prefix path repairs, plain route on the CPU or
    CUDA: [B] int64, 1 where the row's own prefix-and-position words
    leave its keys out of order (two distinct keys share a prefix, the
    larger at the lower position), 2 where only another row of its
    warp's did, 0 elsewhere.  The words, their order and the warps are
    those of :func:`sort_prefix_model` and the kernel's launch."""
    w = _prefix_windows(codes, k)
    b = codes.shape[0]
    width = _sort_width(w)
    hi, lo = kmer_keys(codes, k, canonical)
    real = lo != INVALID_SENTINEL
    keys = torch.full((b, width), -1, dtype=torch.int64, device=codes.device)
    keys[:, :w] = torch.where(real, (hi << (2 * LO_BASES)) | lo, -1)
    log_width = width.bit_length() - 1
    pos = torch.arange(width, device=codes.device)
    prefix = (keys >> max(0, 2 * k - (31 - log_width))) << log_width
    words = torch.where(keys < 0, _SENTINEL_WORD, prefix) | pos
    got = torch.gather(keys, 1, torch.sort(words, dim=-1).values & (width - 1))
    # The sentinel, -1 here, is the largest key (all ones in the kernel).
    got = torch.where(got < 0, KEY64_SENTINEL, got)
    own = (got[:, 1:] < got[:, :-1]).any(1)
    per_warp = 32 * keys_per_thread(width, True) // width
    warps = torch.zeros(-(-b // per_warp) * per_warp, dtype=torch.bool,
                        device=codes.device)
    warps[:b] = own
    warp = warps.view(-1, per_warp).any(1).repeat_interleave(per_warp)[:b]
    return torch.where(own, 1, torch.where(warp, 2, 0)).to(torch.int64)


def rowsort_fallbacks(codes: torch.Tensor, k: int,
                      canonical: bool = False) -> torch.Tensor:
    """The probe kernel's readout of the prefix path (16 <= k <= 31, rows
    of up to 256 windows): [B] int64, equal to
    :func:`rowsort_fallbacks_plain`'s.  The sum of ``> 0`` over a batch
    is the rows that ``rowsort_rle_large`` repairs after the word sort."""
    if codes.device.type == "cpu":
        with span("cfrk.rowsort_probe.plain"):
            return count_out(rowsort_fallbacks_plain(codes, k, canonical))
    w = _prefix_windows(codes, k)
    return count_out(_probe_kernel(codes, k, w, canonical, _FALLBACK_VARIANT))
