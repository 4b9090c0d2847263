"""Sharded sparse spectra: all_to_all bucket routing for large k.

The counterpart of ``cfrk_tpu/parallel/bucket.py`` (BASELINE.json
config 4, "k=31 canonical k-mers with sharded hash table + all-to-all
bucket routing").  Each device:

1. builds its rows' (hi, lo) keys (``ops/sparse.kmer_keys``);
2. gives every key a bucket, its owner device (the top bits of the key,
   so that the devices' outputs concatenated are globally sorted);
3. sorts its keys by (bucket, hi, lo) and counts each bucket;
4. writes them into fixed-capacity bucket boxes, one a device, which
   ``all_to_all`` exchanges (``parallel/mesh.py``);
5. sorts what it received and run-length encodes it: each device then
   holds the exact global counts of its own key range.

The boxes have capacity ``max(ceil8(int(slack * n_local / n_dev)), 8)``
(the JAX package's rule, so overflow and ``slack_used`` match); an
overflow is reported (a flag a device), never silently dropped, and
:func:`sparse_spectrum_sharded_retry` doubles the slack until none is
left.  The sort, ``searchsorted`` and the box scatter are ``torch.sort``,
``torch.searchsorted`` and ``index_put_`` on each device, as the JAX
package's are XLA ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda.rowsort import KEY64_SENTINEL, LO_MASK, rle_rows
from ..ops.sparse import INVALID_SENTINEL, LO_BASES, kmer_keys
from .mesh import Mesh, Sharding, all_to_all, pmax
from .sharded import _blocks

__all__ = ["sparse_spectrum_sharded", "sparse_spectrum_sharded_retry"]


def _bucket_of(hi: torch.Tensor, lo: torch.Tensor, k: int, n_dev: int) -> torch.Tensor:
    """Owner device of a key: the top ``log2(n_dev)`` bits of the 2k-bit
    code (int32, clamped to ``n_dev - 1`` for device counts that are not
    powers of two).  ``hi`` and ``lo`` hold uint32 values; the shifts and
    the int32 cast are the JAX package's uint32 ones, on any key."""
    bits = (n_dev - 1).bit_length() if n_dev > 1 else 0
    if bits == 0:
        return torch.zeros(lo.shape, dtype=torch.int32, device=lo.device)
    if k > LO_BASES:
        hi_bits = 2 * (k - LO_BASES)
        if hi_bits >= bits:
            b = hi >> (hi_bits - bits)
        else:
            # hi has fewer bits than the bucket needs (k = 16-17 on 8 or
            # more devices): borrow the rest from the top of lo, still
            # the top ``bits`` bits of the combined code.
            take = bits - hi_bits
            b = ((hi << take) & 0xFFFFFFFF) | (lo >> (2 * LO_BASES - take))
    else:
        b = lo >> max(2 * k - bits, 0)
    b = ((b + 2**31) & 0xFFFFFFFF) - 2**31  # uint32 → int32, wrapping
    return torch.clamp(b, max=n_dev - 1).to(torch.int32)


def _sorted_keys(hi: torch.Tensor, lo: torch.Tensor, small: bool):
    """Keys sorted by (hi, lo), invalid windows last.  For k <= LO_BASES
    hi is 0 for every valid key, so lo alone orders them; above, one
    int64 key ``hi << 30 | lo`` does (lo < 4**15), judged valid on lo (at
    k = 31 a hi of 16 T bases equals the sentinel)."""
    if small:
        return None, torch.sort(lo).values
    key = torch.where(lo != INVALID_SENTINEL, (hi << (2 * LO_BASES)) | lo,
                      KEY64_SENTINEL)
    key = torch.sort(key).values
    real = key != KEY64_SENTINEL
    return (torch.where(real, key >> (2 * LO_BASES), INVALID_SENTINEL),
            torch.where(real, key & LO_MASK, INVALID_SENTINEL))


def _rle(hi, lo, small: bool):
    """Run-length encode sorted keys: (uhi, ulo, counts), a distinct key
    and its count at each run start, the sentinel and 0 elsewhere."""
    if small:
        ulo, counts = rle_rows(lo[None, :], (lo != INVALID_SENTINEL)[None, :],
                               INVALID_SENTINEL)
        ulo, counts = ulo[0], counts[0]
        return torch.where(counts > 0, 0, INVALID_SENTINEL), ulo, counts
    key = torch.where(lo != INVALID_SENTINEL, (hi << (2 * LO_BASES)) | lo,
                      KEY64_SENTINEL)
    ukey, counts = rle_rows(key[None, :], (key != KEY64_SENTINEL)[None, :],
                            KEY64_SENTINEL)
    ukey, counts = ukey[0], counts[0]
    run = counts > 0
    return (torch.where(run, ukey >> (2 * LO_BASES), INVALID_SENTINEL),
            torch.where(run, ukey & LO_MASK, INVALID_SENTINEL), counts)


def _boxes(bucket, words, n_dev: int, cap: int):
    """Each sorted key's words into its bucket's box at its offset in
    the bucket: ``[n_dev, cap]`` per word, the sentinel in empty slots.
    Keys past a box's capacity (and invalid ones) land in a spare slot
    that is cut off, as the JAX scatter's ``mode='drop'`` drops them.
    Returns (boxes, overflowed)."""
    dev = bucket.device
    ar = torch.arange(n_dev, dtype=torch.int32, device=dev)
    start = torch.searchsorted(bucket, ar)
    count = torch.searchsorted(bucket, ar, right=True) - start
    pos = torch.arange(bucket.numel(), device=dev)
    offset = pos - start[torch.clamp(bucket, max=n_dev - 1).long()]
    in_box = (bucket < n_dev) & (offset < cap)
    tgt_b = torch.where(in_box, bucket.long(), n_dev)
    tgt_o = torch.where(in_box, offset, cap)
    boxes = []
    for w in words:
        box = torch.full((n_dev + 1, cap + 1), INVALID_SENTINEL, dtype=torch.int64,
                         device=dev)
        box[tgt_b, tgt_o] = w
        boxes.append(box[:n_dev, :cap].contiguous())
    return boxes, (count > cap).any().to(torch.int32)


def _flat_mesh(mesh: Mesh) -> Mesh:
    """Bucket routing runs over ONE mesh axis.  On a multi-axis mesh
    (the CLI's (dp, tp) spectrum mesh rerouted here) rows would shard
    over the first axis only and the exchange would repeat over the
    others, so every device goes onto one axis instead."""
    if len(mesh.axis_names) == 1:
        return mesh
    return Mesh(mesh.devices.reshape(-1), (mesh.axis_names[0],))


def sparse_spectrum_sharded(codes, k: int, mesh: Mesh, *, canonical: bool = False,
                            slack: float = 2.0):
    """Global sparse spectrum of a batch by all_to_all bucket routing.

    codes: ``[B, L]`` int8, B divisible by the mesh size (numpy, a
    tensor, or the per-device blocks of ``shard_batch``); a multi-axis
    mesh is flattened so that every device routes buckets.  Returns
    (hi, lo, counts, overflowed) on the mesh's first device: the first
    three are the devices' outputs concatenated (int64 tensors of uint32
    key words and int32 counts; the cells with count > 0 are the
    globally sorted distinct k-mers), ``overflowed`` one bool a device
    (True: a bucket box overflowed and counts are missing; retry with a
    larger slack, or call :func:`sparse_spectrum_sharded_retry`).
    """
    mesh = _flat_mesh(mesh)
    n_dev = mesh.size
    small = k <= LO_BASES
    sorted_parts, boxed, flags = [], [], []
    for blk in _blocks(codes, mesh):
        hi, lo = kmer_keys(blk, k, canonical)
        hi, lo = hi.reshape(-1), lo.reshape(-1)
        n_local = lo.numel()
        cap = int(slack * n_local / n_dev) if n_dev > 1 else n_local
        cap = max(((cap + 7) // 8) * 8, 8)
        hi, lo = _sorted_keys(hi, lo, small)
        if n_dev == 1:
            sorted_parts.append((hi, lo))
            continue
        bucket = torch.where(lo == INVALID_SENTINEL, n_dev,
                             _bucket_of(hi, lo, k, n_dev)).to(torch.int32)
        boxes, over = _boxes(bucket, [lo] if small else [lo, hi], n_dev, cap)
        boxed.append(boxes)
        flags.append(over)
    if n_dev > 1:
        axis = mesh.axis_names[0]
        # Device d receives every device's box for bucket d.
        lo_r = all_to_all([b[0] for b in boxed], mesh, axis)
        hi_r = (all_to_all([b[1] for b in boxed], mesh, axis) if not small
                else [None] * n_dev)
        for h, lo in zip(hi_r, lo_r):
            sorted_parts.append(_sorted_keys(
                None if small else h.reshape(-1), lo.reshape(-1), small))
        flags = [f > 0 for f in pmax(flags, mesh, axis)]
    else:
        flags = [torch.zeros((), dtype=torch.bool, device=mesh.home)]
    outs = [_rle(hi, lo, small) for hi, lo in sorted_parts]
    rows = Sharding(mesh, (mesh.axis_names[0],))
    return (*(rows.unsplit([o[i] for o in outs]) for i in range(3)),
            rows.unsplit([f.reshape(1) for f in flags]))


def sparse_spectrum_sharded_retry(codes, k: int, mesh: Mesh, *,
                                  canonical: bool = False, slack: float = 2.0):
    """:func:`sparse_spectrum_sharded` with overflow recovery: doubles
    the slack and runs again while any device overflows.  It ends: at
    slack >= n_devices every box holds a device's whole key stream.
    Returns (hi, lo, counts, slack_used); callers carry ``slack_used``
    to later batches of the same stream."""
    mesh = _flat_mesh(mesh)
    n_dev = mesh.size
    blocks = _blocks(codes, mesh)
    s = slack
    while True:
        hi, lo, counts, overflowed = sparse_spectrum_sharded(
            blocks, k, mesh, canonical=canonical, slack=s)
        if s >= n_dev or not bool(np.any(overflowed.cpu().numpy())):
            return hi, lo, counts, s
        s = min(s * 2.0, float(n_dev))
