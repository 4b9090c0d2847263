"""On-card correctness artifact: goldens and kernel parity on the GPU.

The port's counterpart of ``tools/onchip_validate.py`` (which wrote the
TPU's ``TPU_VALID.json``): it runs the golden byte-exact suite and the
parity of every CUDA kernel of ``cfrk_tpu_torch`` against its plain
PyTorch twin on the card, and writes ``GPU_VALID.json``: the platform,
the card's name and power limit (``nvidia-smi``), the torch and CUDA
versions, a timestamp, each check with its evidence and seconds, the
kernels' launches and ``ok``.  It exits 1 when any check fails; a
failing check records its error and the others still run.

Run:  python -m cfrk_tpu_torch.tools.onchip_validate [--out GPU_VALID.json]
      [--device cuda|cpu]

The checks, each named for what it holds on the card:

* ``golden_byte_exact``: ``count_reads`` + ``format_file_bytes`` of both
  ``tests/data/seqN.fasta.gz`` at k=2 against ``goldens.json``;
* ``perread_impl_parity``: every ``count_perread`` impl equals ``host``
  at k = 5 and 8;
* ``perread_kernel_parity``: ``perread_hist`` unpacked, ``b4`` with its
  checksum, and canonical, each against ``perread_hist_plain``;
* ``perread_dense_chunk``: ``count_perread(x, 8)`` (the ``auto`` route:
  ``perread_hist`` unpacked on the card) on unpadded ``[8192, 150]``
  codes (W = 143; 64 reads on the CPU) against ``perread_hist_plain``,
  compared on the device; the route and launch counters;
* ``spectrum_kernel_parity``: ``spectrum_hist`` against the scatter route
  at k=8;
* ``spectrum_k15_parity``: ``spectrum(..., impl="auto")`` at k = 11, 12
  and 15, forward and canonical (``spectrum_hist``, which runs
  ``spectrum_large`` there), against ``spectrum_hist_plain``, on random
  reads with N, reads shorter than k, a batch off a 16-byte boundary and
  homopolymer and dinucleotide repeats, all into one running table a k;
  the route and launch counters;
* ``sorted_spectrum_parity``: the k=12 sorted route (per-read rows into
  the sparse accumulator) against scatter;
* ``rowsort_key16_parity``: ``rowsort_rle``'s two-keys-a-register path
  (k <= 8, rows of up to 4096 keys) against its twin at k = 1, 4, 7 and
  8, canonical or not, on rows of 32, 128, 256 and 4096 windows, and of
  the widths that split into a head and a tail, two reads a word (W =
  129, 143, 144, 160, 257 and 320, in odd batches that fill 512 blocks
  of the split, and in small batches and one read short of it, which
  keep the 2P-cell row; 161, one past the split at P = 128, and 65 and
  80, which P = 64 leaves unsplit), with poly-T (the 16-bit padding
  value's key at k = 8), poly-A, all-N, N-heavy and half-padded rows
  and rows whose tail keys all lie below or all above their head's;
  with its checksum (also on split batches); the probe's four variants
  at k = 8 against ``rowsort_probe_plain``, on split batches too;
* ``rowsort_prefix_parity``: ``rowsort_rle_large``'s prefix path (k > 15,
  rows of up to 256 keys sorted as 32-bit prefix-and-position words)
  against its twin at k = 16, 20, 30 and 31, canonical or not, on rows
  of 20 to 256 windows: random, poly-A, poly-T, all-N, N-heavy,
  half-padded rows and rows with a run of 30 T, and rows in which two
  distinct k-mers share every
  prefix bit, the larger first, which the kernel must repair; with its
  checksum; the probe's readout of the rows repaired
  (``rowsort_fallbacks``) against its twin, 1 on every such row;
* ``rowsort_kernel_parity``: ``rowsort_rle`` / ``rowsort_rle_large``
  against their twins at k = 8, 15 and 31 canonical on 150, 200, 500 and
  70 bp rows and on a row at the kernel ceiling; 64 kb and 128 kb contigs
  (past the ceiling) through the tiled route against the twin; the
  rowsort checksum from the probe kernel's ``full`` variant against
  ``rowsort_probe_plain``;
* ``mesh_kernel_probes``: the mesh paths on a one-device mesh of this
  run's device (JAX's ``mesh_compiled_probes``): the ``b4`` packed
  per-read emit over the mesh unpacked against ``host``, the sharded
  row sort on 150 and 70 bp rows against the plain rows, and the seqpar
  sorted spectrum at k=12 through ``SparseAccumulator`` against
  ``spectrum_np``;
* ``auto_batch_capacity``: ``perread_hist`` ``b4`` with its checksum and
  ``rowsort_rle`` at the production batch, ``auto_batch_size()``, k=8,
  against their twins, checksums nonzero.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ..format import format_file_bytes
from ..io.fasta import read_fasta_encoded
from ..ops.cuda.perread import perread_hist, perread_hist_plain, unpack_counts
from ..ops.cuda.rowsort import (
    rowsort_fallbacks,
    rowsort_fallbacks_plain,
    rowsort_max_windows,
    rowsort_probe,
    rowsort_probe_plain,
    rowsort_rle,
    rowsort_rle_large,
    rowsort_rle_large_plain,
    rowsort_rle_plain,
)
from ..ops.cuda.spectrum import LARGE_LAUNCHES, spectrum_hist, spectrum_hist_plain
from ..ops.perread import count_perread
from ..ops.perread_sparse import count_perread_rows, count_perread_sparse, rows_to_triples
from ..ops.reference import spectrum_np
from ..ops.sparse import SparseAccumulator
from ..ops.spectrum import spectrum
from ..parallel.mesh import local_devices, make_mesh
from ..parallel.seqpar import make_seq_mesh, spectrum_seqpar_triples
from ..parallel.sharded import count_perread_sharded_packed, count_perread_sparse_sharded
from ..pipeline.batch import auto_batch_size
from ..pipeline.count import count_reads
from ..runtime.metrics import counters
from . import card

ROOT = Path(__file__).resolve().parents[2]
DATA = ROOT / "tests" / "data"
PERREAD_IMPLS = ("compare", "matmul", "scatter", "pallas", "host")


def _codes(rng, shape, low: int = 0, p_n: float = 0.0) -> np.ndarray:
    codes = rng.integers(low, 4, size=shape).astype(np.int8)
    if p_n:
        codes[rng.random(codes.shape) < p_n] = -1
    return codes


def assert_equal(got, want, what: str) -> None:
    """Exact equality of two tensors (or tuples of them), compared on the
    host; raises with the first differing cell."""
    if isinstance(got, (tuple, list)):
        if len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} outputs, {len(want)} expected")
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal(g, w, f"{what}[{i}]")
        return
    g, w = (t.cpu() if isinstance(t, torch.Tensor) else torch.as_tensor(t)
            for t in (got, want))
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not torch.equal(g.to(w.dtype), w):
        bad = torch.nonzero(g.to(w.dtype) != w)[0].tolist()
        raise AssertionError(f"{what}: differs at {bad}: {g[tuple(bad)]} != {w[tuple(bad)]}")


def golden_byte_exact(device: torch.device) -> dict:
    """Byte-exact .cfrk for both golden samples through ``count_reads``
    on this device."""
    manifest = json.loads((DATA / "goldens.json").read_text())
    hashes = {}
    for name, meta in sorted(manifest["files"].items()):
        reads = read_fasta_encoded(DATA / name)
        out = format_file_bytes(count_reads(reads, manifest["k"], device=device))
        h = hashlib.sha256(out).hexdigest()
        if h != meta["sha256"]:
            raise AssertionError(f"{name}: {h} != {meta['sha256']}")
        hashes[name] = h
    return {"k": manifest["k"], "sha256": hashes}


def perread_impl_parity(device: torch.device) -> dict:
    """Every count_perread impl agrees with host on this device (k=5, 8)."""
    x = torch.from_numpy(_codes(np.random.default_rng(0), (64, 150), p_n=0.02)).to(device)
    out = {}
    for k in (5, 8):
        want = count_perread(x, k, impl="host")
        for impl in PERREAD_IMPLS:
            assert_equal(count_perread(x, k, impl=impl), want, f"k={k} {impl}")
        out[f"k{k}_checksum"] = int(want.sum())
    out["impls"] = list(PERREAD_IMPLS)
    return out


def perread_kernel_parity(device: torch.device) -> dict:
    """perread_hist unpacked, "b4" with its checksum, and canonical, each
    against its plain twin (the checksum against the twin's: the sum of
    count & 3 over each block of reads)."""
    codes = _codes(np.random.default_rng(1), (48, 150), p_n=0.02)
    x = torch.from_numpy(codes).to(device)
    k = 8
    want = perread_hist_plain(x, k)
    assert_equal(perread_hist(x, k), want, "unpacked")
    packed, chk = perread_hist(x, k, packed="b4", checksum=True)
    assert_equal((packed, chk), perread_hist_plain(x, k, packed="b4", checksum=True),
                 "b4 + checksum")
    assert_equal(unpack_counts(packed.cpu().numpy(), 48, mode="b4"), want, "b4 unpacked")
    assert_equal(perread_hist(x, k, canonical=True),
                 perread_hist_plain(x, k, canonical=True), "canonical")
    return {"k": k, "modes": ["dense", "b4+checksum", "canonical"],
            "checksum": int(chk.sum())}


DENSE_CHUNK = (8192, 150)  # the reference CFRK's chunk of 150 bp reads
LAUNCHES = "cfrk.perread_hist.launches"


def perread_dense_chunk(device: torch.device) -> dict:
    """``count_perread(x, 8)`` on one unpadded chunk of the reference
    CFRK's size (8192 reads of 150 bp, W = 143; 64 reads on the CPU,
    where the output is 2.15 GB of plain-route table otherwise) against
    ``perread_hist_plain``, compared on the device; on the card it takes
    the route ``pallas`` and launches ``perread_hist`` once."""
    reads, length = DENSE_CHUNK if device.type == "cuda" else (64, DENSE_CHUNK[1])
    x = torch.from_numpy(_codes(np.random.default_rng(10), (reads, length), p_n=0.002)).to(device)
    route = "cfrk.perread.route." + ("pallas" if device.type == "cuda" else "host")
    before = counters()
    got = count_perread(x, 8)
    after = counters()
    want = perread_hist_plain(x, 8)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    if not torch.equal(got, want):
        bad = torch.nonzero(got != want)[0].tolist()
        raise AssertionError(f"differs at {bad}: {int(got[tuple(bad)])} != {int(want[tuple(bad)])}")
    launched = after.get(LAUNCHES, 0) - before.get(LAUNCHES, 0)
    routed = after.get(route, 0) - before.get(route, 0)
    if routed != 1 or launched != (1 if device.type == "cuda" else 0):
        raise AssertionError(f"{route} {routed}, perread_hist launches {launched}")
    return {"shape": [reads, length], "k": 8, "windows": length - 8 + 1,
            "counted": int(want.sum(dtype=torch.int64)), route: routed, LAUNCHES: launched}


def spectrum_kernel_parity(device: torch.device) -> dict:
    x = torch.from_numpy(_codes(np.random.default_rng(2), (64, 150))).to(device)
    assert_equal(spectrum_hist(x, 8), spectrum(x, 8, impl="scatter"), "k=8")
    return {"k": 8}


def spectrum_k15_parity(device: torch.device) -> dict:
    """The ``auto`` route at 11 <= k <= 15 (``spectrum_hist``, its kernel
    ``spectrum_large``) against ``spectrum_hist_plain``, every batch added into one running
    table a (k, canonical), compared on the device."""
    rng = np.random.default_rng(9)
    random = _codes(rng, (3000, 150), p_n=0.01)
    short = random[:64].copy()
    short[:, 9:] = -1  # reads of 9 bases: no window at k >= 11
    repeats = np.zeros((512, 150), np.int8)  # poly-A
    repeats[1::4] = 3  # poly-T
    repeats[2::4, 1::2] = 1  # ACAC...
    repeats[3::4, 0::2] = 2  # GTGT...
    repeats[3::4, 1::2] = 3
    # The same random reads off a 16-byte boundary (the card's
    # allocations start on 512-byte ones).
    flat = torch.from_numpy(np.concatenate([np.zeros(3, np.int8), random.reshape(-1)]))
    odd = flat.to(device)[3:].view(random.shape)
    batches = {"random": torch.from_numpy(random).to(device), "off_boundary": odd,
               "short_reads": torch.from_numpy(short).to(device),
               "repeats": torch.from_numpy(repeats).to(device)}
    before = counters()
    cases = []
    for k in (11, 12, 15):
        table = torch.zeros(4**k, dtype=torch.int32, device=device)
        want = torch.zeros_like(table)
        for canonical in (False, True):
            table.zero_()
            want.zero_()
            for name, x in batches.items():
                spectrum(x, k, canonical=canonical, out=table)
                spectrum_hist_plain(x, k, canonical, want)
                if not torch.equal(table, want):
                    bad = torch.nonzero(table != want)[0].item()
                    raise AssertionError(
                        f"k={k} canonical={canonical} after {name}: bin {bad} "
                        f"{int(table[bad])} != {int(want[bad])}")
            cases.append(f"k{k}_{'canonical' if canonical else 'forward'}")
        del table, want
    # On a CPU tensor ``auto`` takes the scatter route and launches nothing.
    route = "cfrk.spectrum.route." + ("pallas" if device.type == "cuda" else "scatter")
    after = counters()
    routed = after.get(route, 0) - before.get(route, 0)
    launched = after.get(LARGE_LAUNCHES, 0) - before.get(LARGE_LAUNCHES, 0)
    calls = len(cases) * len(batches)
    if routed != calls or launched != (calls if device.type == "cuda" else 0):
        raise AssertionError(f"{calls} calls: {route} {routed}, launches {launched}")
    return {"cases": cases, "batches": sorted(batches), route: routed,
            LARGE_LAUNCHES: launched}


def sorted_spectrum_parity(device: torch.device) -> dict:
    """k=12 sorted-spectrum route (per-read row sorts merged in the
    sparse accumulator) against scatter on this device."""
    x = torch.from_numpy(_codes(np.random.default_rng(3), (32, 100))).to(device)
    k = 12
    want = spectrum(x, k, impl="scatter").cpu().numpy().astype(np.int64)
    acc = SparseAccumulator()
    acc.add(*rows_to_triples(count_perread_rows(x, k), k))
    keys, counts = acc.result_arrays()
    table = np.zeros(4**k, dtype=np.int64)
    table[keys.astype(np.int64)] = counts
    assert_equal(table, want, "k=12 table")
    return {"k": k, "distinct": int(keys.size)}


def _rows_vs_plain(x: torch.Tensor, k: int, canonical: bool, what: str) -> None:
    if k <= 15:
        assert_equal(rowsort_rle(x, k, canonical), rowsort_rle_plain(x, k, canonical), what)
    else:
        assert_equal(rowsort_rle_large(x, k, canonical),
                     rowsort_rle_large_plain(x, k, canonical), what)


def rowsort_key16_parity(device: torch.device) -> dict:
    """``rowsort_rle`` at k <= 8, where it sorts two 16-bit keys a
    register, against its plain twin, and the probe's variants at k = 8
    against theirs."""
    rng = np.random.default_rng(7)

    def rows(b, length, head=None):
        codes = _codes(rng, (b, length), p_n=0.01)
        codes[0] = 3  # poly-T: the key 0xFFFF at k = 8
        codes[1] = 0  # poly-A: one long run
        codes[2] = -1  # all N: no real window
        codes[3][rng.random(length) < 0.4] = -1
        codes[4, length // 2:] = -1
        if head:  # windows from `head` on start with A or C, the others G or T
            codes[5, :head] = rng.integers(2, 4, head)
            codes[5, head:] = rng.integers(0, 2, length - head)
            codes[6, :head] = rng.integers(0, 2, head)
            codes[6, head:] = rng.integers(2, 4, length - head)
        return torch.from_numpy(codes).to(device)

    # Batches of at least 512 blocks of the split take it (16384 reads
    # at P = 128, 8192 at P = 256; odd ones leave the last pair half
    # empty), smaller ones the 2P-cell row (16383 reads: one fewer).
    cases = 0
    for k in (1, 4, 7, 8):
        for w, b in ((32, 150), (128, 70), (256, 40), (4096, 6), (65, 71), (80, 33),
                     (129, 45), (143, 37), (144, 41), (160, 43), (161, 39), (257, 19),
                     (320, 23), (129, 16385), (143, 16385), (144, 16384), (143, 16383),
                     (160, 16385), (161, 16385), (257, 8193), (320, 8193)):
            head = 1 << (w - 1).bit_length() - 1 if w & (w - 1) else None
            x = rows(b, w + k - 1, head)
            for canonical in (False, True):
                _rows_vs_plain(x, k, canonical, f"k={k} canonical={canonical} {w} windows")
                cases += 1
    for length, b in ((150, 37), (150, 16385), (167, 16385)):
        x = rows(b, length, 128)
        assert_equal(rowsort_rle(x, 8, checksum=True), rowsort_rle_plain(x, 8, checksum=True),
                     f"k=8 {b} reads of {length} bp with checksum")
    variants = {}
    for length, b in ((150, 41), (4103, 6), (150, 16385), (167, 16385)):
        x = rows(b, length, 128 if b > 41 else None)
        for variant in ("full", "sortonly", "rleonly", "noop"):
            chk = rowsort_probe(x, 8, variant)
            assert_equal(chk, rowsort_probe_plain(x, 8, variant), f"k=8 probe {variant}")
            variants[f"{variant}_{length}" + (f"_B{b}" if b > 41 else "")] = int(chk.sum())
    return {"cases": cases, "probe_checksums": variants}


def prefix_tie_row(rng, length: int, k: int) -> np.ndarray:
    """A random row of int8 codes with two distinct k-mers that share
    their first 13 bases (every prefix bit of a row of up to 256 keys),
    the larger at the lower position: X = P T R C at 3, Y = P A R C near
    the end, P and R random.  P starts with AA and both end in C, so
    each is its own canonical key.  Needs length >= 2k + 5 (the two
    apart)."""
    row = rng.integers(0, 4, length).astype(np.int8)
    p = np.concatenate([[0, 0], rng.integers(0, 4, 11)]).astype(np.int8)
    rest = np.concatenate([rng.integers(0, 4, k - 15), [1]]).astype(np.int8)
    a, b = 3, length - k - 2
    if b < a + k:
        raise ValueError(f"a row of {length} codes cannot hold two {k}-mers apart")
    row[a:a + k] = np.concatenate([p, [3], rest])
    row[b:b + k] = np.concatenate([p, [0], rest])
    return row


def rowsort_prefix_parity(device: torch.device) -> dict:
    """``rowsort_rle_large`` on its prefix path against its twin, on
    rows built so that distinct keys share a prefix, and which rows it
    repairs against the plain readout."""
    rng = np.random.default_rng(8)
    cases, tie_rows, repaired = 0, 0, 0
    for k in (16, 20, 30, 31):
        for w, b in ((20, 40), (32, 64), (64, 64), (122, 200), (200, 64), (256, 64)):
            length = w + k - 1
            codes = _codes(rng, (b, length), p_n=0.01)
            codes[0] = 3  # poly-T
            codes[1] = 0  # poly-A: one long run
            codes[2] = -1  # all N: no real window
            codes[3][rng.random(length) < 0.3] = -1
            codes[4, length // 2:] = -1
            codes[6, 2:32] = 3  # a T run: forward keys of one prefix, descending
            ties = list(range(5, b, 3)) if length >= 2 * k + 5 else []
            for r in ties:
                codes[r] = prefix_tie_row(rng, length, k)
            x = torch.from_numpy(codes).to(device)
            for canonical in (False, True):
                what = f"k={k} canonical={canonical} {w} windows"
                _rows_vs_plain(x, k, canonical, what)
                got = rowsort_fallbacks(x, k, canonical)
                assert_equal(got, rowsort_fallbacks_plain(x, k, canonical),
                             f"{what}: rows repaired")
                if ties and not bool((got[ties] == 1).all()):
                    raise AssertionError(f"{what}: a tie row was not repaired")
                tie_rows += len(ties)
                repaired += int((got > 0).sum())
                cases += 1
            if w == 122:
                assert_equal(rowsort_rle_large(x, k, True, checksum=True),
                             rowsort_rle_large_plain(x, k, True, checksum=True),
                             f"k={k} {w} windows with checksum")
    if not tie_rows:
        raise AssertionError("no row shared a prefix out of order")
    return {"cases": cases, "tie_rows": tie_rows, "rows_repaired": repaired}


def rowsort_kernel_parity(device: torch.device) -> dict:
    """The row-sort kernels against their plain twins: k=8, 15, 31
    canonical, rows of 150, 200, 500 and 70 bp and at the kernel
    ceiling; contigs past the ceiling through the tiled route; and the
    probe kernel's checksum."""
    rng = np.random.default_rng(4)

    def on(shape):
        return torch.from_numpy(_codes(rng, shape, low=-1)).to(device)

    codes = on((64, 150))
    out = {}
    for k in (8, 15):
        _rows_vs_plain(codes, k, False, f"k={k} 150 bp")
        chk = rowsort_probe(codes, k, "full")
        assert_equal(chk, rowsort_probe_plain(codes, k, "full"), f"k={k} probe checksum")
        out[f"k{k}_checksum"] = int(chk.sum())
    _rows_vs_plain(codes, 31, True, "k=31 canonical 150 bp")
    _rows_vs_plain(on((32, 200)), 31, True, "k=31 canonical 200 bp")
    _rows_vs_plain(on((16, 500)), 8, False, "k=8 500 bp")
    _rows_vs_plain(on((64, 70)), 8, False, "k=8 70 bp")
    for k, canonical in ((8, False), (31, True)):
        w = rowsort_max_windows(k)
        _rows_vs_plain(on((2, w + k - 1)), k, canonical, f"k={k} row at the ceiling")
        out[f"ceiling_k{k}_windows"] = w
    # Contigs past the ceiling: the tiled route (the kernel per tile, the
    # tiles' pairs merged on the host) against the twin on the whole row.
    for name, shape in (("contig_64kb", (4, 65521)), ("contig_128kb", (2, 131041))):
        x = on(shape)
        assert_equal(count_perread_rows(x, 8), rowsort_rle_plain(x, 8), f"{name} tiled")
        out[f"{name}_tiles"] = -(-(shape[1] - 7) // rowsort_max_windows(8))
    return out


def mesh_kernel_probes(device: torch.device) -> dict:
    """The mesh functions on a one-device mesh of this device: the
    packed per-read emit (``perread_hist`` ``b4``), the sharded row sort
    (``rowsort_rle``) on 150 bp and on short 70 bp rows, and the seqpar
    sorted spectrum (``rowsort_rle`` on each position slice), each
    against a route with no mesh."""
    rng = np.random.default_rng(5)
    codes = rng.integers(-1, 4, size=(64, 150)).astype(np.int8)
    x = torch.from_numpy(codes).to(device)
    devs = local_devices(device)[:1]
    mesh = make_mesh(devs)

    want = count_perread(x, 8, impl="host")
    packed = count_perread_sharded_packed(x, 8, mesh, packed="b4")
    assert_equal(unpack_counts(packed.cpu().numpy(), 64, mode="b4"), want, "packed_mesh")

    assert_equal(count_perread_sparse_sharded(x, 8, mesh), count_perread_sparse(x, 8),
                 "rowsort_mesh")
    short = torch.from_numpy(rng.integers(-1, 4, size=(64, 70)).astype(np.int8)).to(device)
    assert_equal(count_perread_sparse_sharded(short, 8, mesh),
                 count_perread_sparse(short, 8), "rowsort_mesh_span")

    rows = spectrum_seqpar_triples(x[:, :128], 12, make_seq_mesh(devs))
    acc = SparseAccumulator()
    acc.add(*rows_to_triples(rows, 12))
    keys, counts = acc.result_arrays()
    table = np.zeros(4**12, dtype=np.int64)
    table[keys.astype(np.int64)] = counts
    assert_equal(table, spectrum_np(list(codes[:, :128]), 12), "seqpar_sorted")
    return {"probes": ["packed_mesh", "rowsort_mesh", "rowsort_mesh_span", "seqpar_sorted"]}


def auto_batch_capacity(device: torch.device) -> dict:
    """The kernels at the production batch size, checksums consumed:
    a capacity or launch-shape fault that only a full batch shows."""
    b = auto_batch_size()
    x = torch.from_numpy(_codes(np.random.default_rng(6), (b, 150), low=-1)).to(device)
    packed, chk = perread_hist(x, 8, packed="b4", checksum=True)
    assert_equal((packed, chk), perread_hist_plain(x, 8, packed="b4", checksum=True),
                 "perread b4 + checksum")
    idx, cnt = rowsort_rle(x, 8)
    assert_equal((idx, cnt), rowsort_rle_plain(x, 8), "rowsort")
    # The probe's "full" checksum from the kernel's rows: over run
    # starts, (count & 3) + (key & 3).
    starts = cnt > 0
    rowsort_chk = int((((cnt & 3) + (idx & 3)) * starts).sum())
    dense_chk = int(chk.sum())
    if not (dense_chk > 0 and rowsort_chk > 0):
        raise AssertionError(f"zero checksum: dense {dense_chk}, rowsort {rowsort_chk}")
    return {"batch": b, "dense_checksum": dense_chk, "rowsort_checksum": rowsort_chk}


CHECKS = {fn.__name__: fn for fn in (
    golden_byte_exact,
    perread_impl_parity,
    perread_kernel_parity,
    perread_dense_chunk,
    spectrum_kernel_parity,
    spectrum_k15_parity,
    sorted_spectrum_parity,
    rowsort_key16_parity,
    rowsort_prefix_parity,
    rowsort_kernel_parity,
    mesh_kernel_probes,
    auto_batch_capacity,
)}


def run_checks(device: torch.device) -> dict:
    """Every check in turn on ``device``; returns {name: record}.  A
    check that raises is recorded as failed with its error, and the
    others still run."""
    checks = {}
    for name, fn in CHECKS.items():
        t0 = time.perf_counter()
        try:
            rec = {"ok": True, **fn(device)}
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        except Exception as e:  # record and go on: the artifact lists every check
            rec = {"ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc(limit=4)}
        rec["wall_s"] = time.perf_counter() - t0
        checks[name] = rec
        print(f"# {name}: {'ok' if rec['ok'] else 'FAIL'} ({rec['wall_s']:.3f} s)",
              file=sys.stderr, flush=True)
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "GPU_VALID.json"),
                    help="artifact path (default: GPU_VALID.json at the repo root)")
    card.add_device_argument(ap)
    args = ap.parse_args(argv)
    device = card.resolve_device(args.device)

    record = {**card.device_record(device),
              "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    before = card.launches()
    t0 = time.perf_counter()
    record["checks"] = run_checks(device)
    record["wall_s"] = time.perf_counter() - t0
    record["launches"] = card.launches_since(before)
    record["ok"] = all(c["ok"] for c in record["checks"].values())
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps({"ok": record["ok"], "artifact": args.out,
                      "device_kind": record["device_kind"], "card": record["card"],
                      "launches": record["launches"]}))
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
