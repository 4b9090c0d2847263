"""Dense per-read histograms: a hand-written CUDA kernel and its plain
PyTorch twin.

:func:`perread_hist` (1 <= k <= 8) replaces ``count_perread_pallas``
(cfrk_tpu/ops/pallas/perread.py:166): codes ``[B, L]`` int8 → each
read's ``[4**k]`` int32 counts, forward or canonical, optionally in the
packed ``"fh"`` (two bins per int32) or ``"b4"`` (four, one byte each)
layouts, with an optional per-read-block checksum.  The kernel builds
the window keys itself and counts them straight into a shared-memory
image of the output words, which a bulk copy writes out
(``csrc/perread.cu`` explains the design and its bounds on the H100).
:func:`bin_place_model` and :func:`perread_image_model` are a numpy
model of that arithmetic -- where a bin lives in a packed word, the
work units of rows and chunks, the checksum from the old values the
atomics return -- so that the CPU tests can hold it against the plain
twin.  Its plain twin :func:`perread_hist_plain` is the
``scatter`` route of ``ops/perread.py`` followed by the same packing and
checksum in torch ops; the two return equal arrays, pad rows included,
so one :func:`unpack_counts` serves both.

The module also carries the JAX module's helpers: ``DEFAULT_READ_BLOCK``,
:func:`resolve_packed`, :func:`unpack_counts` (numpy and torch) and
:func:`packed_auto` (with "the device is CUDA" for "the backend is a
TPU").  The TPU tiling knobs ``window_block``, ``interpret`` and
``mxu_dtype`` have no counterpart; ``read_block`` stays, because it
defines the packed and checksum shapes.

As in ``ops/cuda/rowsort.py``, the wrapper takes its plain twin only for
a tensor on the CPU.  For a CUDA tensor it launches the kernel or
raises; a build or launch failure is never replaced by the plain route.
Its validation, launch counter, spans and ``cfrk.out_bytes`` count are
those of ``ops/cuda/rowsort.py``'s wrappers.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...runtime.metrics import count_out, span
from ..encode import split_k, window_indices
from .build import check_codes, launch_kernel, load_library, once

__all__ = [
    "DEFAULT_READ_BLOCK",
    "MAX_PERREAD_K",
    "bin_place_model",
    "packed_auto",
    "perread_image_model",
    "perread_hist",
    "perread_hist_plain",
    "resolve_packed",
    "unpack_counts",
]

# Reads per checksum block and the packed layouts' row multiple (the
# JAX kernel's grid step).
DEFAULT_READ_BLOCK = 16
MAX_PERREAD_K = 8

_PACKINGS = {False: 0, "fh": 1, "b4": 2}
_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def packed_auto(impl: str, k: int, w: int, device) -> bool:
    """Packed-emit eligibility of a batch: the packed kernel applies on
    CUDA in its k range when the windows per read fit the "fh" bound."""
    return (
        impl in ("auto", "pallas")
        and 5 <= k <= 8
        and w < 2**15
        and torch.device(device).type == "cuda"
    )


def resolve_packed(packed, w: int):
    """Resolve a packed-mode request against the windows/read bound.

    ``True`` picks the densest safe packing: "b4" (1 byte/bin) when every
    count is provably < 256, else "fh" (2 bytes/bin) below 2**15.
    """
    if packed is True:
        if w < 256:
            return "b4"
        if w < 2**15:
            return "fh"
        raise ValueError(
            "packed counts unsafe for >= 2**15 windows/read"
        )
    if packed in (False, None):
        return False
    if packed == "b4" and w >= 256:
        raise ValueError("b4-packed counts unsafe for >= 256 windows/read")
    if packed == "fh" and w >= 2**15:
        raise ValueError("fh-packed counts unsafe for >= 2**15 windows/read")
    if packed not in ("b4", "fh"):
        raise ValueError(f"unknown packed mode {packed!r}")
    return packed


def unpack_counts(packed, n_reads: int, mode: str = "fh"):
    """Unpack a packed output back to ``[n_reads, 4**k]`` int32.

    Works on numpy arrays (host side, after the halved or quartered
    device→host copy) and on torch tensors.  mode="fh": ``[B_pad, fh/2,
    fl]``, hi bin h in the high 16 bits paired with bin h + fh/2 in the
    low.  mode="b4": ``[B_pad, fh/4, fl]``, four hi bins one byte each, h
    in the highest byte.  The byte/halfword extraction masks after the
    shift, so the arithmetic sign extension of the int32 container is
    harmless.
    """
    if isinstance(packed, np.ndarray):
        cat, as_int32 = np.concatenate, lambda a: a.astype(np.int32)
    else:
        cat, as_int32 = torch.cat, lambda a: a.to(torch.int32)
    if mode == "fh":
        bpad, hhalf, fl = packed.shape
        hi = (packed >> 16) & 0x7FFF
        lo = packed & 0xFFFF
        counts = cat([hi, lo], 1)  # [bpad, fh, fl]
        return as_int32(counts.reshape(bpad, 2 * hhalf * fl)[:n_reads])
    if mode == "b4":
        bpad, q, fl = packed.shape
        parts = [(packed >> s) & 0xFF for s in (24, 16, 8, 0)]
        counts = cat(parts, 1)  # [bpad, fh, fl]
        return as_int32(counts.reshape(bpad, 4 * q * fl)[:n_reads])
    raise ValueError(f"unknown packed mode {mode!r}")


def _plan(codes: torch.Tensor, k: int, packed, read_block: int):
    """Validate a call; returns (w, kl, packing, rb, b_pad).  k is
    refused in ``count_perread_pallas``'s words and order: above 8 after
    the window count, below 1 after the packing."""
    w = check_codes(codes, k, None, None)
    b = codes.shape[0]
    if k > MAX_PERREAD_K:
        raise ValueError("per-read dense counting supports k <= 8")
    packing = resolve_packed(packed, w)
    kh, kl = split_k(k)
    if packing == "b4" and 4**kh < 4:
        raise ValueError("b4 packing needs k >= 2")
    if k < 1 or read_block < 1:
        raise ValueError(f"k and read_block must be >= 1, got {k}, {read_block}")
    rb = max(min(read_block, b), 1)
    return w, kl, packing, rb, -(-b // rb) * rb


def _pack(counts: torch.Tensor, k: int, packing, b_pad: int) -> torch.Tensor:
    """``[B, 4**k]`` int32 → the packed ``[b_pad, fh/n, fl]`` layout."""
    kh, kl = split_k(k)
    fh, fl = 4**kh, 4**kl
    b = counts.shape[0]
    a = torch.zeros((b_pad, fh, fl), dtype=torch.int32, device=counts.device)
    a[:b] = counts.reshape(b, fh, fl)
    if packing == "fh":
        hh = fh // 2
        return (a[:, :hh] << 16) | a[:, hh:]
    q = fh // 4
    return (
        (a[:, :q] << 24)
        | (a[:, q : 2 * q] << 16)
        | (a[:, 2 * q : 3 * q] << 8)
        | a[:, 3 * q :]
    )


def perread_hist_plain(codes: torch.Tensor, k: int, canonical: bool = False, *,
                       packed=False, read_block: int = DEFAULT_READ_BLOCK,
                       checksum: bool = False):
    """Dense per-read histograms, plain route on the CPU or CUDA.

    The ``scatter`` route: each valid window adds one at ``row * 4**k +
    index`` of a flat zeroed int32 ``[B * 4**k]`` table; then the packing
    and checksum of :func:`perread_hist`.
    """
    w, _, packing, rb, b_pad = _plan(codes, k, packed, read_block)
    b = codes.shape[0]
    idx = window_indices(codes, k, canonical).to(torch.int64)  # [B, W]
    rows = torch.arange(b, dtype=torch.int64, device=codes.device)[:, None]
    flat = (rows * 4**k + idx)[idx >= 0]
    counts = torch.zeros(b * 4**k, dtype=torch.int32, device=codes.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    counts = counts.reshape(b, 4**k)
    out = _pack(counts, k, packing, b_pad) if packing else counts
    if not checksum:
        return out
    chk = torch.zeros(b_pad, dtype=torch.int32, device=codes.device)
    chk[:b] = (counts & 3).sum(1, dtype=torch.int32)
    return out, chk.reshape(b_pad // rb, rb).sum(1, dtype=torch.int32)


# ------------------------------------------- the kernel's bin arithmetic

# csrc/perread.cu: the largest image of a block, the words that short
# rows share, and the most rows of one image.
IMAGE_WORDS = 16384
TILE_WORDS = 4096
MAX_TILE_ROWS = 64


def bin_place_model(keys: np.ndarray, k: int, packing):
    """numpy model of ``bin_place`` of ``csrc/perread.cu``: where the bins
    ``keys`` live in an output row of ``4**k / n`` words with n = 1
    (unpacked), 2 ("fh") or 4 ("b4") bins a word.  Returns ``(word,
    shift)``: the word of the row, and the bit its field starts at."""
    per = {False: 1, "fh": 2, "b4": 4}[packing]
    log_row_words = 2 * k - (per.bit_length() - 1)
    keys = np.asarray(keys, np.int64)
    word = keys & ((1 << log_row_words) - 1)
    shift = (32 // per) * (per - 1 - (keys >> log_row_words))
    return word, shift


def perread_image_model(codes: np.ndarray, k: int, canonical: bool = False, *,
                        packed=False, read_block: int = DEFAULT_READ_BLOCK,
                        checksum: bool = False, image_words: int = IMAGE_WORDS,
                        tile_words: int = TILE_WORDS,
                        max_tile_rows: int = MAX_TILE_ROWS):
    """numpy model of ``perread_hist_kernel`` of ``csrc/perread.cu``, unit
    by unit: a unit is a tile of consecutive output rows times a chunk of
    each row's words; it adds ``1 << shift`` at the word of every window
    whose word falls in its chunk, into an image that starts at 0, and
    the image is the unit's part of the output.  The checksum is the sum
    of the deltas read off the old words: -3 where the bin's old count
    has ``count & 3 == 3``, else +1.  Keys come from the plain
    ``window_indices``.  Returns what :func:`perread_hist` returns, as
    numpy arrays."""
    t = torch.from_numpy(np.ascontiguousarray(codes))
    w, kl, packing, rb, b_pad = _plan(t, k, packed, read_block)
    b = codes.shape[0]
    idx = window_indices(t, k, canonical).numpy()
    per = {False: 1, "fh": 2, "b4": 4}[packing]
    row_words = 4**k // per
    rows = b_pad if packing else b
    chunk_words = min(row_words, image_words)
    tile_rows = min(max(tile_words // row_words, 1), max_tile_rows)
    chunks = row_words // chunk_words
    out = np.zeros((rows, row_words), np.uint32)
    chk = np.zeros(b_pad // rb, np.int64)
    units = -(-rows // tile_rows) * chunks
    for unit in range(units):
        tile, chunk = divmod(unit, chunks)
        word_lo = chunk * chunk_words
        row0 = tile * tile_rows
        n_rows = min(tile_rows, rows - row0)
        image = np.zeros(tile_rows * chunk_words, np.uint32)
        for r in range(n_rows):
            if row0 + r >= b:
                break
            keys = idx[row0 + r]
            word, shift = bin_place_model(keys[keys >= 0], k, packing)
            word = word - word_lo
            mine = (word >= 0) & (word < chunk_words)
            for wd, sh in zip(word[mine].tolist(), shift[mine].tolist()):
                old = int(image[r * chunk_words + wd])
                image[r * chunk_words + wd] = old + (1 << sh)
                chk[(row0 + r) // rb] += -3 if (old >> sh) & 3 == 3 else 1
        out[row0:row0 + n_rows, word_lo:word_lo + chunk_words] = (
            image[:n_rows * chunk_words].reshape(n_rows, chunk_words))
    out = out.view(np.int32)
    if packing:
        kh = k - kl
        out = out.reshape(b_pad, 4**kh // per, 4**kl)
    return (out, chk.astype(np.int32)) if checksum else out


@once
def _library() -> ctypes.CDLL:
    lib = load_library("perread")
    lib.cfrk_perread_hist.argtypes = [_PTR, _PTR, _PTR] + [_INT] * 9 + [_PTR]
    lib.cfrk_perread_hist.restype = _INT
    return lib


def perread_hist(codes: torch.Tensor, k: int, canonical: bool = False, *,
                 packed=False, read_block: int = DEFAULT_READ_BLOCK,
                 checksum: bool = False):
    """Dense per-read histograms of a code batch, CUDA kernel.

    codes [B, L] int8 → ``[B, 4**k]`` int32, or with ``packed``
    ("fh", "b4", or True for the densest safe one) the ``[B_pad, fh/2,
    fl]`` / ``[B_pad, fh/4, fl]`` int32 layout of
    :func:`count_perread_pallas`, ``B_pad = ceil(B / rb) * rb``, ``rb =
    min(read_block, B)``, pad rows 0.  ``checksum=True`` also returns
    ``chk[B_pad / rb]`` int32, the sum of ``count & 3`` over each block of
    ``rb`` reads.  Length is unbounded.
    """
    if codes.device.type == "cpu":
        with span("cfrk.perread_hist.plain"):
            return count_out(perread_hist_plain(codes, k, canonical, packed=packed,
                                                read_block=read_block, checksum=checksum))
    w, kl, packing, rb, b_pad = _plan(codes, k, packed, read_block)
    codes = codes.contiguous()
    b, length = codes.shape
    kh = k - kl
    if packing:
        rows = b_pad
        shape = (b_pad, 4**kh // (2 if packing == "fh" else 4), 4**kl)
    else:
        rows, shape = b, (b, 4**k)
    out = torch.empty(shape, dtype=torch.int32, device=codes.device)
    chk = (torch.zeros(b_pad // rb, dtype=torch.int32, device=codes.device)
           if checksum else None)
    if rows:
        launch_kernel("perread_hist", _library().cfrk_perread_hist, codes.device,
                      codes.data_ptr(), out.data_ptr(),
                      chk.data_ptr() if checksum else None,
                      rows, b, length, w, k, kl, int(canonical), _PACKINGS[packing], rb)
    return count_out((out, chk) if checksum else out)
