#!/usr/bin/env python3
"""Chip smoke test of cfrk_tpu_torch, the PyTorch + CUDA port.

Run from the root of a checkout on a machine with one NVIDIA GPU
(Hopper, sm_90a):

    python3 chip_smoke.py [--seed 0]

Phases, each of which exits non-zero on failure:

1. card: the GPU's name and power limit, torch and CUDA versions, the
   host's ``free -g``;
2. build: compiles the CUDA kernels from csrc/ (one nvcc per source,
   all started together);
3. kernel vs plain: each kernel against its plain PyTorch twin on the
   card's inputs, array-equal, across k, canonical keys, read shapes
   (150 bp, short, 4 kb, past the kernel ceiling, a 20 000-read batch)
   and edge rows; the rowsort kernels and the probe also at every sort
   width from 16 keys to the ceiling (each width of the register path,
   the first width of the shared-memory network), batches of 1, 7 and
   8193 reads (a ragged last block), poly-A, all-N and shorter-than-k
   batches and a batch that starts off a 16-byte boundary; the
   per-read histogram kernel in every emit (unpacked,
   "fh", "b4") with and without its checksum, and each variant of the
   rowsort probe kernel; both histogram kernels also on skewed
   [8192, 256] batches (poly-A, reads of one 500 bp sequence, a
   dinucleotide repeat) and on a batch off a 16-byte boundary, and the
   per-read kernel's "b4" main batch three times over, every word
   compared (a missing fence before its bulk copy shows as rare wrong
   bytes);
4. goldens: ``python -m cfrk_tpu_torch <seqN.fasta.gz> <out> 2`` must
   reproduce tests/data/goldens.json;
5. main path at real size: seeded synthetic reads (100k x 150 bp and
   100k x 152 bp, the synthetic-read configuration of BASELINE.json)
   through the CLI on the GPU — k=8 ``--nonzero``, k=31 ``--canonical
   --nonzero``, dense k=8 rows of the first 256 reads; then the dense
   per-read API on the 150 bp reads, ``8 --nonzero --impl pallas`` (the
   "b4" packed kernel; the first 50k reads) and ``4 --impl pallas``
   (dense rows, the unpacked kernel; all 100k), each also byte-equal to
   the auto route (per-read sort + RLE) on the same reads.  Each must
   launch its kernel, write the same bytes as ``--device cpu`` and agree
   on sampled rows with string-slicing ground truth;
6. spectrum legs at real size (BASELINE.json configs 3 and 4): 1M
   seeded 150 bp reads through ``--mode spectrum`` at k=8 (the
   histogram kernel; its row must equal the numpy oracle) and at k=15
   ``--spectrum-format hist`` (the sorted route on the rowsort kernel;
   sum of count x kmers must equal the valid windows), and the 100k x
   152 bp reads through ``-k 31 --canonical --mode sparse`` (tsv equal
   to an independent numpy spectrum on sampled lines).  Each leg's
   counts are set to 0 just before it, must show its kernel launched,
   and its bytes must equal ``--device cpu``;
7. times: each kernel's ms per 8192-read batch beside the plain route's
   on the card (CUDA events, after warm-up; the rowsort kernels as a
   CUDA-graph replay, also at 70 bp and 4 kb, with ``torch.sort`` on
   prebuilt keys as the sort stage's yardstick; the spectrum kernel as
   a graph replay at k = 7, 8, 9, 10 on the random and the skewed
   batches; the per-read histogram kernel "b4", "fh" and unpacked, with
   its written GB/s, beside a ``zero_()`` of the same output and the
   zero-then-scatter alternative: ``tools/hist_times.py``), each
   kernel's bound (bytes over the memory rate, operations over the
   integer rate, whichever is larger, from the shape it was timed at),
   the spectrum kernel against the sorted route per batch at k = 9 and
   10 on the random and the poly-A batch, the end-to-end
   bases/s of phases 5 and 6, and the rowsort probe tool
   (``python -m cfrk_tpu_torch.tools.rowsort_probe``) for each variant
   at k = 8 and k = 31, its checksums held to the plain twin's.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the JSON record of the kernels, and the one before that the card's
``nvidia-smi`` name and power limit.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
BATCH = 8192
# NVIDIA H100 SXM (data sheet): device memory rate, and the integer rate
# of the plain cores, one operation a lane where the 67 TFLOP/s float32
# rate counts a fused multiply-add as two.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 33.5e12
READS = 100_000  # BASELINE.json config 2: 100k reads per leg
# The k=8 dense-API leg takes the first half of them: its host side
# unpacks 2.1 GB a batch, on both routes, and 100k reads held a third of
# the whole run.
DENSE_API_READS = 50_000
SPECTRUM_READS = 1_000_000  # BASELINE.json config 3: a 1M-read metagenome
_COMP = str.maketrans("ACGT", "TGCA")
_DIGITS = str.maketrans("ACGT", "0123")


class PhaseClock:
    """Logs the seconds each phase took, so that a run near its time
    limit shows which phase to cut."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        log(f"phase {phase}: {now - self.t:.1f} s")
        self.t = now


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- data


def synthetic_reads(seed: int, n: int, length: int, genomes: int = 8,
                    genome_len: int = 100_000, mut_rate: float = 0.01,
                    n_rate: float = 0.002):
    """Reads sampled from random genomes with point mutations and N
    bases (tools/make_synthetic.py's model, vectorised): int8 codes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gen = rng.integers(0, 4, size=(genomes, genome_len), dtype=np.int8)
    gi = rng.integers(0, genomes, size=n)
    starts = rng.integers(0, genome_len - length + 1, size=n)
    reads = gen[gi[:, None], starts[:, None] + np.arange(length)]
    mut = rng.random(reads.shape) < mut_rate
    reads[mut] = rng.integers(0, 4, size=int(mut.sum()), dtype=np.int8)
    reads[rng.random(reads.shape) < n_rate] = -1
    return reads


def write_fasta(path: Path, reads) -> None:
    import numpy as np

    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    seqs = lut[np.where(reads < 0, 4, reads)]
    with open(path, "wb") as f:
        f.write(b"".join(b">r%d\n%s\n" % (i, s.tobytes()) for i, s in enumerate(seqs)))


def string_counts(seq: str, k: int, canonical: bool) -> dict:
    """{code: count} of one read by string slicing alone (the ground
    truth of tests/test_groundtruth.py)."""
    out: dict = {}
    for i in range(len(seq) - k + 1):
        w = seq[i : i + k]
        if "N" in w:
            continue
        if canonical:
            rc = w.translate(_COMP)[::-1]
            w = min(w, rc)
        code = int(w.translate(_DIGITS), 4)
        out[code] = out.get(code, 0) + 1
    return out


def row_cells(row: bytes) -> dict:
    """Nonzero ``idx:count`` cells of one `.cfrk` row."""
    out = {}
    for cell in row.split():
        i, c = cell.split(b":")
        if int(c):
            out[int(i)] = int(c)
    return out


# ---------------------------------------------------------------- phases


def check_kernels(seed: int) -> dict:
    """Phase 3: every kernel against its plain twin on CPU copies of the
    same inputs; returns {kernel name: max |kernel - plain|}."""
    import numpy as np
    import torch

    from cfrk_tpu_torch.ops.cuda import rowsort as R
    from cfrk_tpu_torch.ops.perread_sparse import count_perread_rows

    rng = np.random.default_rng(seed)

    def batch(b, length, p=0.01):
        c = rng.integers(0, 4, size=(b, length)).astype(np.int8)
        c[rng.random(c.shape) < p] = -1
        return c

    edge = batch(13, 171)  # odd batch
    edge[0] = 0  # poly-A
    edge[1] = -1  # all N
    edge[2, 5:] = -1  # shorter than k
    t16 = np.zeros((4, 60), np.int8)
    t16[:, :20] = 3  # the 16-T hi word equals the uint32 sentinel at k=31
    r150 = batch(64, 256)
    r150[:, 150:] = -1  # 150 bp reads in the main path's padded width
    cases = {
        "150bp": r150,
        "short_70bp": batch(37, 70),
        "contig_4kb": batch(3, 4096),
        "edge_rows_odd_batch": edge,
        "16T": t16,
    }
    past = {"rowsort_rle": batch(2, 40_000), "rowsort_rle_large": batch(2, 20_000)}
    kernels = {
        "rowsort_rle": (R.rowsort_rle, R.rowsort_rle_plain, (1, 2, 8, 15)),
        "rowsort_rle_large": (R.rowsort_rle_large, R.rowsort_rle_large_plain,
                              (16, 24, 31)),
    }
    errs = {}
    for name, (kern, plain, ks) in kernels.items():
        err = 0
        for k in ks:
            widths = width_cases(batch, k) if k in WIDTH_CASE_KS else {}
            for canonical in (False, True):
                runs = [(c, kern, n) for n, c in {**cases, **widths}.items()]
                past_ceiling = past[name].shape[1] - k + 1 > R.rowsort_max_windows(k)
                if past_ceiling:
                    runs.append((past[name], count_perread_rows, "past_ceiling"))
                for codes, fn, case in runs:
                    got = fn(on_card(codes, case), k, canonical)
                    torch.cuda.synchronize()
                    want = plain(torch.from_numpy(codes), k, canonical)
                    for g, w in zip(got, want):
                        g = g.cpu()
                        if g.shape != w.shape or g.dtype != w.dtype:
                            fail(f"{name} k={k} {case}: {g.shape}/{g.dtype} "
                                 f"vs plain {w.shape}/{w.dtype}")
                        d = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                        if d:
                            fail(f"{name} k={k} canonical={canonical} {case}: "
                                 f"differs from plain by {d}")
                        err = max(err, d)
        errs[name] = err
        log(f"kernel vs plain: {name} k={ks} x canonical x "
            f"{sorted(cases) + ['past_ceiling']}, and k in {WIDTH_CASE_KS} x "
            f"{sorted(widths)}: array-equal")
    from cfrk_tpu_torch.tools.hist_times import skew_batches

    skewed = {n: c for n, c in skew_batches(seed).items() if n != "random"}
    hist_cases = dict(cases, edge_off_boundary=edge)  # 171 columns: see on_card
    errs["spectrum_hist"] = check_spectrum_kernel(hist_cases, batch(20_000, 256),
                                                  skewed)
    main_batch = np.full((BATCH, 256), -1, np.int8)
    main_batch[:, :150] = batch(BATCH, 150)
    errs["perread_hist"] = check_perread_kernel(hist_cases, batch(2, 40_000),
                                                main_batch, skewed)
    errs["rowsort_probe"] = check_probe_kernel(cases, batch)
    return errs


WIDTH_CASE_KS = (1, 8, 15, 16, 31)


def width_cases(batch, k: int) -> dict:
    """Code batches that reach every path of the rowsort kernels at this
    k: each has ``n + k - 1`` columns, so a row is exactly n windows.
    n = 16 sorts at the least width, 32..4096 are the widths of the
    register path (512 and more take several warps a row, 4096 holds 16
    keys a thread), 8192 is the first width of the shared-memory network
    and the last n the ceiling; 7 reads leave every block ragged, 1 and
    8193 reads are the least batch and one read past a multiple of every
    block's rows."""
    import numpy as np

    from cfrk_tpu_torch.ops.cuda.rowsort import rowsort_max_windows

    def cols(n):
        return n + k - 1

    out = {f"n{n}_B7": batch(7, cols(n))
           for n in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
                     rowsort_max_windows(k))}
    for n in (32, 256, 512):
        out[f"n{n}_B1"] = batch(1, cols(n))
    for n in (32, 256):
        out[f"n{n}_B8193"] = batch(8193, cols(n))
    out["n250_off_boundary"] = batch(10, cols(250))  # see on_card
    for n in (256, 4096, 8192):
        out[f"polyA_n{n}"] = np.zeros((3, cols(n)), np.int8)  # one run of n
    out["all_N"] = np.full((9, 200), -1, np.int8)
    short = batch(9, 64)
    short[:, k - 1:] = -1  # every read one base shorter than k
    out["shorter_than_k"] = short
    return out


def on_card(codes, case: str):
    """The batch as a CUDA tensor; the ``off_boundary`` case as rows 1..
    of a larger tensor, so that its first byte lies off a 16-byte
    boundary (the row length is odd there) and the wrapper still takes
    it as contiguous."""
    import numpy as np
    import torch

    if "off_boundary" not in case:
        return torch.from_numpy(codes).cuda()
    padded = np.concatenate([codes[:1], codes])
    return torch.from_numpy(padded).cuda()[1:]


def compare_arrays(name: str, got, want, what: str) -> int:
    """Array equality of a kernel's outputs (a tensor or a tuple of
    them) with its plain twin's; returns max |difference| (0) or fails."""
    import torch

    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        g, w = g.cpu(), w.cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{name} {what}: {tuple(g.shape)}/{g.dtype} vs plain "
                 f"{tuple(w.shape)}/{w.dtype}")
        d = int((g.long() - w.long()).abs().max()) if g.numel() else 0
        if d:
            fail(f"{name} {what}: differs from plain by {d}")
    return 0


def check_perread_kernel(cases: dict, contig, main_batch, skewed: dict) -> int:
    """The per-read histogram kernel against its plain twin: unpacked,
    "fh", "b4" and the densest safe packing (where the row length allows
    it), read blocks of 16 and 5 (pad rows), with and without the
    checksum, k in {1, 2, 4, 5, 7, 8} x canonical, every case (one of
    them off a 16-byte boundary), a 2 x 40 000 bp row, the main path's
    [8192, 256] batch at k = 8 in every emit (the twin on the card), its
    "b4" emit three times over, and the skewed [8192, 256] batches at
    k = 8 "b4" and k = 5 "fh" with the checksum."""
    import torch

    from cfrk_tpu_torch.ops.cuda import perread as P

    ks = (1, 2, 4, 5, 7, 8)
    cases = dict(cases, contig_40kb=contig)
    err = 0
    for k in ks:
        for canonical in (False, True):
            for case, codes in cases.items():
                if codes.shape[1] < k:
                    continue
                for packed in (False, "fh", "b4", True):
                    try:
                        P.resolve_packed(packed, codes.shape[1] - k + 1)
                    except ValueError:
                        continue
                    for rb, checksum in ((16, False), (5, True)):
                        kw = dict(packed=packed, read_block=rb, checksum=checksum)
                        err = max(err, compare_arrays(
                            "perread_hist",
                            P.perread_hist(on_card(codes, case), k, canonical, **kw),
                            P.perread_hist_plain(torch.from_numpy(codes), k, canonical, **kw),
                            f"k={k} canonical={canonical} {case} {kw}"))
    codes = torch.from_numpy(main_batch).cuda()
    for packed in (False, "fh", "b4"):
        for checksum in (False, True):
            kw = dict(packed=packed, checksum=checksum)
            want = P.perread_hist_plain(codes, 8, False, **kw)
            for repeat in range(3 if packed == "b4" else 1):
                err = max(err, compare_arrays(
                    "perread_hist", P.perread_hist(codes, 8, False, **kw), want,
                    f"k=8 [{BATCH}, 256] {kw} repeat {repeat}"))
            del want
    for case, batch in skewed.items():
        codes = torch.from_numpy(batch).cuda()
        for k, packed in ((8, "b4"), (5, "fh")):
            for canonical in (False, True):
                kw = dict(packed=packed, checksum=True)
                err = max(err, compare_arrays(
                    "perread_hist", P.perread_hist(codes, k, canonical, **kw),
                    P.perread_hist_plain(codes, k, canonical, **kw),
                    f"k={k} canonical={canonical} {case} [{BATCH}, 256] {kw}"))
    log(f"kernel vs plain: perread_hist k={ks} x canonical x "
        f"{sorted(cases)} x packed/read_block/checksum, [{BATCH}, 256] "
        f"k=8 unpacked/fh/b4 (b4 three times), and {sorted(skewed)} at "
        f"k=8 b4 / k=5 fh: array-equal")
    return err


def check_probe_kernel(cases: dict, batch) -> int:
    """Each variant of the rowsort probe kernel against its plain twin:
    uint32 keys at k = 1, 8, 15 and uint64 canonical keys at k = 16,
    31, on every case within the kernel's ceiling and on the width
    cases of each k."""
    import torch

    from cfrk_tpu_torch.ops.cuda import rowsort as R

    err = 0
    for k, canonical in ((1, False), (8, False), (15, False), (16, True), (31, True)):
        widths = width_cases(batch, k)
        for variant in R.PROBE_VARIANTS:
            for case, codes in {**cases, **widths}.items():
                w = codes.shape[1] - k + 1
                if w <= 0 or w > R.rowsort_max_windows(k):
                    continue
                err = max(err, compare_arrays(
                    "rowsort_probe",
                    R.rowsort_probe(on_card(codes, case), k, variant, canonical),
                    R.rowsort_probe_plain(torch.from_numpy(codes), k, variant, canonical),
                    f"{variant} k={k} canonical={canonical} {case}"))
    log(f"kernel vs plain: rowsort_probe {sorted(R.PROBE_VARIANTS)} x k=1/8/15 "
        f"(uint32) and k=16/31 canonical (uint64) x {sorted(cases)} and "
        f"{sorted(widths)}: equal checksums")
    return err


def check_spectrum_kernel(cases: dict, big, skewed: dict) -> int:
    """The histogram kernel against its plain twin: every case (one of
    them off a 16-byte boundary), one batch of 20 000 reads (more than
    one 8192-read slice), a running table that takes two batches in
    place, and the skewed [8192, 256] batches at k = 7, 8, 9, 10 (the
    twin on the card)."""
    import torch

    from cfrk_tpu_torch.ops.cuda import spectrum as S

    ks = (1, 2, 5, 7, 8, 9, 10)
    cases = dict(cases, reads_20000=big)
    err = 0

    def compare(got, want, what):
        nonlocal err
        err = max(err, compare_arrays("spectrum_hist", got, want, what))

    for k in ks:
        for canonical in (False, True):
            for case, codes in cases.items():
                if codes.shape[1] < k:
                    continue
                compare(S.spectrum_hist(on_card(codes, case), k, canonical),
                        S.spectrum_hist_plain(torch.from_numpy(codes), k, canonical),
                        f"k={k} canonical={canonical} {case}")
            a, b = cases["150bp"], cases["edge_rows_odd_batch"]
            table = S.spectrum_hist(torch.from_numpy(a).cuda(), k, canonical)
            S.spectrum_hist(torch.from_numpy(b).cuda(), k, canonical, out=table)
            want = S.spectrum_hist_plain(torch.from_numpy(a), k, canonical)
            S.spectrum_hist_plain(torch.from_numpy(b), k, canonical, out=want)
            compare(table, want, f"k={k} canonical={canonical} running table")
    for case, batch in skewed.items():
        codes = torch.from_numpy(batch).cuda()
        for k in (7, 8, 9, 10):
            for canonical in (False, True):
                compare(S.spectrum_hist(codes, k, canonical),
                        S.spectrum_hist_plain(codes, k, canonical),
                        f"k={k} canonical={canonical} {case} [{BATCH}, 256]")
    log(f"kernel vs plain: spectrum_hist k={ks} x canonical x "
        f"{sorted(cases) + ['running_table']}, and k=7..10 x canonical x "
        f"{sorted(skewed)}: array-equal")
    return err


def check_goldens() -> None:
    """Phase 4: the reference positional form through the module entry."""
    data = ROOT / "tests" / "data"
    manifest = json.loads((data / "goldens.json").read_text())
    for name, meta in sorted(manifest["files"].items()):
        out = WORK / f"golden_{name}.cfrk"
        subprocess.run(
            [sys.executable, "-m", "cfrk_tpu_torch", str(data / name),
             str(out), str(manifest["k"])],
            cwd=ROOT, check=True, timeout=600,
        )
        digest = hashlib.sha256(out.read_bytes()).hexdigest()
        if digest != meta["sha256"]:
            fail(f"golden {name}: sha256 {digest} != {meta['sha256']}")
        log(f"golden {name} k={manifest['k']}: sha256 matches")


def run_main_path(label: str, fasta: Path, reads, flags: list, kernel,
                  k: int, canonical: bool, same_as: str | None = None) -> dict:
    """Phase 5, one leg: the CLI on the GPU (counting its kernel's
    launches), the same CLI on the CPU route, byte comparison (and with
    ``same_as``, the sha256 of another route's bytes on the same reads)
    and a sampled ground-truth check.  Returns the leg's numbers."""
    import numpy as np

    from cfrk_tpu_torch.cli import main

    out_gpu = WORK / f"{label}.cuda.cfrk"
    out_cpu = WORK / f"{label}.cpu.cfrk"
    before = kernel.launches
    t0 = time.perf_counter()
    if main([str(fasta), str(out_gpu), *flags]) != 0:
        fail(f"{label}: CLI exit")
    wall = time.perf_counter() - t0
    launches = kernel.launches - before
    if launches <= 0:
        fail(f"{label}: {kernel.__name__} was not launched")
    t0 = time.perf_counter()
    if main([str(fasta), str(out_cpu), *flags, "--device", "cpu"]) != 0:
        fail(f"{label}: CPU CLI exit")
    cpu_wall = time.perf_counter() - t0
    gpu_bytes = out_gpu.read_bytes()
    if gpu_bytes != out_cpu.read_bytes():
        fail(f"{label}: GPU bytes differ from --device cpu bytes")
    digest = hashlib.sha256(gpu_bytes).hexdigest()
    if same_as is not None and digest != same_as:
        fail(f"{label}: bytes differ from the auto route's on the same reads")
    rows = gpu_bytes.split(b"\n")
    if len(rows) != len(reads):
        fail(f"{label}: {len(rows)} rows for {len(reads)} reads")
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    sample = sorted({0, 1, len(reads) // 2, len(reads) - 1,
                     *np.random.default_rng(k).integers(0, len(reads), 12).tolist()})
    for i in sample:
        seq = lut[np.where(reads[i] < 0, 4, reads[i])].tobytes().decode()
        if row_cells(rows[i]) != string_counts(seq, k, canonical):
            fail(f"{label}: row {i} disagrees with the string ground truth")
    out_gpu.unlink()
    out_cpu.unlink()
    bases = int(reads.size)
    res = {
        "leg": label, "reads": len(reads), "bases": bases,
        "cuda_wall_s": wall, "cpu_route_wall_s": cpu_wall,
        "bases_per_s": bases / wall, "launches": launches,
        "bytes": len(gpu_bytes), "rows_checked": len(sample), "sha256": digest,
        "equal_to_auto_route": same_as is not None,
    }
    log(f"main path {label}: " + json.dumps(res))
    return res


def valid_windows(reads, k: int) -> int:
    """Windows of k codes that are all valid, by a cumulative count of
    invalid codes (numpy, independent of the package)."""
    import numpy as np

    bad = np.zeros((reads.shape[0], reads.shape[1] + 1), np.int32)
    np.cumsum(reads < 0, axis=1, out=bad[:, 1:])
    return int((bad[:, k:] == bad[:, :-k]).sum())


def numpy_kmer_keys(reads, k: int, canonical: bool):
    """Every valid window's k-mer code (uint64) by a k-step numpy loop."""
    import numpy as np

    w = reads.shape[1] - k + 1
    fwd = np.zeros((reads.shape[0], w), np.uint64)
    rc = np.zeros_like(fwd)
    for j in range(k):
        c = np.maximum(reads[:, j : j + w], 0).astype(np.uint64)
        fwd = (fwd << np.uint64(2)) | c
        rc |= (np.uint64(3) - c) << np.uint64(2 * j)
    bad = np.zeros((reads.shape[0], reads.shape[1] + 1), np.int32)
    np.cumsum(reads < 0, axis=1, out=bad[:, 1:])
    keys = np.minimum(fwd, rc) if canonical else fwd
    return keys[bad[:, k:] == bad[:, :-k]]


def run_spectrum_leg(label: str, fasta: Path, reads, flags: list,
                     kernels: dict, check) -> dict:
    """Phase 6, one leg: every kernel count set to 0 just before the CLI
    runs on the GPU and read just after (the leg's own kernel must have
    launched), the same CLI on ``--device cpu``, byte comparison, then
    ``check(output bytes)``.  Returns the leg's numbers."""
    from cfrk_tpu_torch.cli import main

    out_gpu = WORK / f"{label}.cuda.out"
    out_cpu = WORK / f"{label}.cpu.out"
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    if main([str(fasta), "-o", str(out_gpu), *flags]) != 0:
        fail(f"{label}: CLI exit")
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    t0 = time.perf_counter()
    if main([str(fasta), "-o", str(out_cpu), *flags, "--device", "cpu"]) != 0:
        fail(f"{label}: CPU CLI exit")
    cpu_wall = time.perf_counter() - t0
    gpu_bytes = out_gpu.read_bytes()
    if gpu_bytes != out_cpu.read_bytes():
        fail(f"{label}: GPU bytes differ from --device cpu bytes")
    checked = check(gpu_bytes)
    out_gpu.unlink()
    out_cpu.unlink()
    res = {
        "leg": label, "reads": len(reads), "bases": int(reads.size),
        "cuda_wall_s": wall, "cpu_route_wall_s": cpu_wall,
        "bases_per_s": int(reads.size) / wall, "launches": launches,
        "bytes": len(gpu_bytes), "checked": checked,
    }
    log(f"spectrum leg {label}: " + json.dumps(res))
    return res


def spectrum_legs(seed: int, r152, fa152: Path) -> list:
    """Phase 6: the spectrum modes at BASELINE.json config 3's read count
    and config 4's k = 31 canonical sparse spectrum."""
    import numpy as np

    from cfrk_tpu_torch.ops.cuda import rowsort as R
    from cfrk_tpu_torch.ops.cuda import spectrum as S
    from cfrk_tpu_torch.ops.reference import spectrum_np

    kernels = {"rowsort_rle": R.rowsort_rle,
               "rowsort_rle_large": R.rowsort_rle_large,
               "spectrum_hist": S.spectrum_hist}
    r1m = synthetic_reads(seed + 3, SPECTRUM_READS, 150)
    fa1m = WORK / "r1m.fa"
    write_fasta(fa1m, r1m)

    def check_k8(out: bytes) -> str:
        row = np.array([int(c.split(b":")[1]) for c in out.split()], np.int64)
        # The oracle over reads joined by -1 separators: windows cannot
        # cross them, so the spectrum is the same, in 100 long calls.
        joined = np.pad(r1m, ((0, 0), (0, 1)), constant_values=-1).reshape(100, -1)
        want = spectrum_np(list(joined), 8)
        if row.shape != want.shape or not np.array_equal(row, want):
            fail("spectrum_k8: the row differs from spectrum_np")
        return f"row of {row.size} cells equals spectrum_np; sum {int(row.sum())}"

    def check_k15(out: bytes) -> str:
        pairs = np.array([[int(x) for x in line.split(b"\t")]
                          for line in out.splitlines()], np.int64)
        total = int((pairs[:, 0] * pairs[:, 1]).sum())
        want = valid_windows(r1m, 15)
        if total != want:
            fail(f"spectrum_k15_hist: sum count x kmers {total} != {want} windows")
        return f"sum count x kmers = {total} valid windows; {int(pairs[:, 1].sum())} distinct"

    def check_k31(out: bytes) -> str:
        lines = out.splitlines()
        keys, counts = np.unique(numpy_kmer_keys(r152, 31, True), return_counts=True)
        if len(lines) != keys.size:
            fail(f"sparse_k31_canonical: {len(lines)} lines for {keys.size} k-mers")
        total = sum(int(line.rsplit(b"\t", 1)[1]) for line in lines)
        if total != int(counts.sum()) or total != valid_windows(r152, 31):
            fail(f"sparse_k31_canonical: sum of counts {total} != valid windows")
        sample = np.random.default_rng(seed).integers(0, keys.size, 20).tolist()
        for i in sorted({0, keys.size - 1, *sample}):
            kmer, count = lines[i].split(b"\t")
            if int(kmer.decode().translate(_DIGITS), 4) != int(keys[i]) or int(count) != counts[i]:
                fail(f"sparse_k31_canonical: line {i} {lines[i]!r} disagrees with numpy")
        return f"{keys.size} k-mers, sum {total} = valid windows, sampled lines decode"

    legs = [
        run_spectrum_leg("spectrum_k8", fa1m, r1m, ["-k", "8", "--mode", "spectrum"],
                         kernels, check_k8),
        run_spectrum_leg("spectrum_k15_hist", fa1m, r1m,
                         ["-k", "15", "--mode", "spectrum", "--spectrum-format", "hist"],
                         kernels, check_k15),
        run_spectrum_leg("sparse_k31_canonical", fa152, r152,
                         ["-k", "31", "--canonical", "--mode", "sparse"],
                         kernels, check_k31),
    ]
    for leg, name in zip(legs, ("spectrum_hist", "rowsort_rle", "rowsort_rle_large")):
        if leg["launches"][name] <= 0:
            fail(f"{leg['leg']}: {name} was not launched")
    fa1m.unlink()
    return legs


def time_spectrum_routes(seed: int, card: str) -> dict:
    """Phase 7, spectrum: ms per 8192-read batch (150 bp padded to 256)
    of the histogram kernel at k = 7, 8, 9, 10 on the random and the
    skewed batches (graph replays, ``tools/hist_times.py``) and of its
    plain twin at k = 8 (CUDA events); then of the kernel route (H2D +
    kernel into the running table) against the sorted route (H2D +
    rowsort kernel + narrowed D2H + host fold) at k = 9 and 10 on the
    random and the poly-A batch (host clock, synchronised)."""
    import torch

    from cfrk_tpu_torch.ops.cuda import spectrum as S
    from cfrk_tpu_torch.ops.perread_sparse import batch_spectrum_triples
    from cfrk_tpu_torch.ops.sparse import DenseFoldAccumulator
    from cfrk_tpu_torch.tools.hist_times import skew_batches, time_spectrum

    batches = skew_batches(seed + 4)
    codes = torch.from_numpy(batches["random"]).cuda()
    p1 = time_kernel(S.spectrum_hist_plain, codes, 8, False)
    k1 = time_spectrum(batches)
    k2 = time_spectrum(batches)
    p2 = time_kernel(S.spectrum_hist_plain, codes, 8, False)
    by_case = {f"k{a['k']}_{a['batch']}": (a["ms"] + b["ms"]) / 2
               for a, b in zip(k1, k2, strict=True)}
    log("spectrum_hist_times: " + json.dumps({"card": card, "ms": by_case}))
    log(f"time spectrum_hist k=8 [{BATCH}, 256]: kernel {by_case['k8_random']:.4f} ms "
        f"as a graph replay, plain {p1:.4f}/{p2:.4f} ms per batch ({card})")
    out = {"spectrum_hist": (by_case["k8_random"], (p1 + p2) / 2)}
    def kernel_route(codes_np, k, iters=20):
        table = torch.zeros(4**k, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            S.spectrum_hist(torch.from_numpy(codes_np).cuda(), k, out=table)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    def sorted_route(codes_np, k, iters=20):
        acc = DenseFoldAccumulator(k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            acc.add(*batch_spectrum_triples(codes_np, k, max_len=150, device="cuda"))
        return (time.perf_counter() - t0) * 1e3 / iters

    for name in ("random", "polyA"):
        batch = batches[name]
        for k in (9, 10):
            kernel_route(batch, k, 3)
            sorted_route(batch, k, 3)
            s1, q1, q2, s2 = (sorted_route(batch, k), kernel_route(batch, k),
                              kernel_route(batch, k), sorted_route(batch, k))
            kern = by_case[f"k{k}_{name}"]
            out[f"k{k}_{name}"] = {"kernel_route_ms": (q1 + q2) / 2,
                                   "sorted_route_ms": (s1 + s2) / 2,
                                   "kernel_only_ms": kern}
            log(f"time spectrum k={k} {name} [{BATCH}, 256]: kernel route "
                f"{q1:.4f}/{q2:.4f} ms (kernel alone {kern:.4f} ms), sorted route "
                f"{s1:.4f}/{s2:.4f} ms per batch ({card})")
    return out


def dense_api_legs(r150, fa150: Path) -> list:
    """Phase 5, the dense per-read API (``--impl pallas``) on the 150 bp
    reads: k=8 ``--nonzero`` (the "b4" packed kernel, unpacked on the
    host) on the first 50k reads, and dense k=4 rows (the unpacked
    kernel) on all 100k.  Each is also held to the bytes of the auto
    route (per-read sort + RLE), run here first on the same reads."""
    from cfrk_tpu_torch.cli import main
    from cfrk_tpu_torch.ops.cuda import perread as P

    def auto_sha(fasta: Path, flags: list) -> str:
        out = WORK / "auto.cuda.cfrk"
        if main([str(fasta), str(out), *flags]) != 0:
            fail(f"auto route {flags}: CLI exit")
        digest = hashlib.sha256(out.read_bytes()).hexdigest()
        out.unlink()
        return digest

    r_half = r150[:DENSE_API_READS]
    fa_half = WORK / "r150_half.fa"
    write_fasta(fa_half, r_half)
    k8_auto_sha = auto_sha(fa_half, ["8", "--nonzero"])
    k4_auto_sha = auto_sha(fa150, ["4"])
    P.perread_hist.launches = 0
    legs = [
        run_main_path("k8_dense_api_nonzero", fa_half, r_half,
                      ["8", "--nonzero", "--impl", "pallas"], P.perread_hist, 8, False,
                      same_as=k8_auto_sha),
        run_main_path("k4_dense_api", fa150, r150, ["4", "--impl", "pallas"],
                      P.perread_hist, 4, False, same_as=k4_auto_sha),
    ]
    return legs


def time_perread(seed: int, card: str) -> dict:
    """Phase 7, per-read histograms: ms per 8192-read batch (150 bp
    padded to 256) at k = 8 of the kernel in each emit ("b4", "fh",
    unpacked) beside ``zero_()`` of the same output and the
    zero-then-scatter alternative (``tools/hist_times.py``), and of its
    plain twin, all on the card; written GB/s = output bytes / ms."""
    import torch

    from cfrk_tpu_torch.ops.cuda import perread as P
    from cfrk_tpu_torch.tools import hist_times

    codes_np = hist_times.skew_batches(seed + 5)["random"]
    codes = torch.from_numpy(codes_np).cuda()
    out = {}
    for rec in hist_times.time_perread(codes_np):
        name = rec["emit"]
        plain = functools.partial(P.perread_hist_plain,
                                  packed=False if name == "unpacked" else name)
        plain_ms = time_kernel(plain, codes, 8, False, iters=5)
        ms = (rec["ms"] + rec["ms_again"]) / 2
        out[name] = {"ms": ms, "plain_ms": plain_ms,
                     "written_bytes": rec["written_bytes"],
                     "written_GB_per_s": rec["written_bytes"] / ms / 1e6,
                     "zero_ms": rec["zero_ms"],
                     "zero_and_scatter_ms": rec["zero_and_scatter_ms"]}
        log(f"time perread_hist k=8 {name} [{BATCH}, 256]: kernel "
            f"{rec['ms']:.4f}/{rec['ms_again']:.4f} ms "
            f"({out[name]['written_GB_per_s']:.1f} GB/s written), zero_() "
            f"{rec['zero_ms']:.4f} ms, zero_() + scatter "
            f"{rec['zero_and_scatter_ms']:.4f} ms, plain {plain_ms:.4f} ms "
            f"per batch ({card})")
    return out


def run_probe(card: str) -> dict:
    """Phase 7, the rowsort probe tool: every variant at k = 8 (uint32
    keys) and k = 31 (uint64 canonical keys), through its command-line
    entry, with the probe kernel's count set to 0 just before and read
    just after.  Each run's checksum must equal the plain twin's over
    the same cycled batches."""
    import torch

    from cfrk_tpu_torch.ops.cuda import rowsort as R
    from cfrk_tpu_torch.tools.rowsort_probe import main as probe_main
    from cfrk_tpu_torch.tools.rowsort_probe import probe_batches

    steps, batch, length = 64, BATCH, 150
    xs = [torch.from_numpy(x).cuda() for x in probe_batches(batch, length)]
    R.rowsort_probe.launches = 0
    records, err = {}, 0
    for keys, k in ((1, 8), (2, 31)):
        for variant in R.PROBE_VARIANTS:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = probe_main(["--variant", variant, "--keys", str(keys),
                                 "--batch", str(batch), "--len", str(length),
                                 "--steps", str(steps)])
            if rc != 0:
                fail(f"rowsort_probe {variant} --keys {keys}: exit {rc}")
            rec = json.loads(buf.getvalue().strip().splitlines()[-1])
            per_batch = [int(R.rowsort_probe_plain(x, k, variant, keys == 2).sum())
                         for x in xs]
            want = sum(per_batch[i % 4] for i in range(steps))
            err = max(err, abs(rec["chk"] - want))
            if rec["chk"] != want:
                fail(f"rowsort_probe {variant} k={k}: chk {rec['chk']} != plain {want}")
            records[f"{variant}_k{k}"] = rec
            log(f"probe {variant} k={k}: " + json.dumps(rec))
    launches = R.rowsort_probe.launches
    if launches <= 0:
        fail("the probe tool never launched rowsort_probe")
    plain = functools.partial(R.rowsort_probe_plain, variant="full")
    plain_ms = time_kernel(lambda c, k, can: plain(c, k, canonical=can), xs[0], 8, False)
    log(f"time rowsort_probe full k=8 [{batch}, {length}]: kernel "
        f"{records['full_k8']['step_ms']:.4f} ms, plain {plain_ms:.4f} ms ({card})")
    return {"records": records, "launches": launches, "err": err,
            "ms": records["full_k8"]["step_ms"], "plain_ms": plain_ms}


def bound(nbytes: int, ops: int) -> tuple:
    """(ms, "bytes" | "operations"): the least time the card could take
    to move ``nbytes`` through device memory (each input read once, each
    output written once) or to do ``ops`` integer operations, whichever
    is longer."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sort_ops(rows: int, w: int) -> int:
    """Comparisons a sort of ``rows`` rows of ``w`` keys cannot avoid,
    w * ceil(log2 w) a row, plus one operation a key to build it."""
    return rows * w * (max(w - 1, 1).bit_length() + 1)


def time_torch_sort(seed: int) -> dict:
    """The sort stage's yardstick: ms of one ``torch.sort`` of prebuilt
    [8192, 256] keys along the rows, int32 (k <= 15) and int64 (k > 15).
    The port never sorts with it on the card's path."""
    import torch

    from cfrk_tpu_torch.tools.rowsort_times import time_eager

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for dtype, top in ((torch.int32, 4**8), (torch.int64, 4**31)):
        keys = torch.randint(0, top, (BATCH, 256), dtype=dtype, device="cuda",
                             generator=gen)
        name = str(dtype).removeprefix("torch.")
        out[f"torch_sort_{name}_ms"] = time_eager(lambda: torch.sort(keys, dim=-1))
    return out


def time_kernel(fn, codes, k: int, canonical: bool, iters: int = 20) -> float:
    """ms per call on the card: CUDA events around ``iters`` calls after
    a warm-up."""
    from cfrk_tpu_torch.tools.rowsort_times import time_eager

    return time_eager(lambda: fn(codes, k, canonical), iters)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from cfrk_tpu_torch.ops.cuda import perread as P
        from cfrk_tpu_torch.ops.cuda import rowsort as R
        from cfrk_tpu_torch.ops.cuda import spectrum as S
        from cfrk_tpu_torch.ops.cuda.build import build_libraries
    except ImportError as e:
        print(f"chip_smoke: cfrk_tpu_torch not found beside this script "
              f"({e}); run it from the root of a checkout", file=sys.stderr)
        return 1
    if "jax" in sys.modules:
        fail("jax was imported")
    WORK.mkdir(parents=True, exist_ok=True)

    # 1. card
    started = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    free = subprocess.run(["free", "-g"], capture_output=True, text=True, timeout=60)
    log("host memory (free -g):\n" + free.stdout.strip())

    # 2. build
    t0 = time.perf_counter()
    built = build_libraries(["rowsort", "spectrum", "perread"])
    R._library()
    S._library()
    P._library()
    log(f"build: {', '.join(so.name for so in built.values())} in "
        f"{time.perf_counter() - t0:.3f} s")
    for so in built.values():
        log(so.with_suffix(".log").read_text().strip())

    # 3. kernel vs plain
    clock = PhaseClock()
    errs = check_kernels(args.seed)
    clock.lap("3 kernel vs plain")

    # 4. goldens
    check_goldens()
    clock.lap("4 goldens")

    # 5. main path at real size
    import numpy as np

    r150 = synthetic_reads(args.seed, READS, 150)
    r152 = synthetic_reads(args.seed + 1, READS, 152)
    fa150, fa152, fa256 = (WORK / n for n in ("r150.fa", "r152.fa", "r256.fa"))
    write_fasta(fa150, r150)
    write_fasta(fa152, r152)
    write_fasta(fa256, r150[:256])
    R.rowsort_rle.launches = 0
    R.rowsort_rle_large.launches = 0
    legs = [
        run_main_path("k8_nonzero", fa150, r150, ["8", "--nonzero"],
                      R.rowsort_rle, 8, False),
        run_main_path("k31_canonical_nonzero", fa152, r152,
                      ["31", "--canonical", "--nonzero"],
                      R.rowsort_rle_large, 31, True),
        run_main_path("k8_dense_256", fa256, r150[:256], ["8"],
                      R.rowsort_rle, 8, False),
    ]
    launches = {"rowsort_rle": R.rowsort_rle.launches,
                "rowsort_rle_large": R.rowsort_rle_large.launches}
    for name, n in launches.items():
        if n <= 0:
            fail(f"main path never launched {name}")
    dense_legs = dense_api_legs(r150, fa150)
    launches["perread_hist"] = P.perread_hist.launches
    if launches["perread_hist"] <= 0:
        fail("the dense per-read legs never launched perread_hist")
    legs += dense_legs

    clock.lap("5 main path")

    # 6. spectrum legs at real size
    spec_legs = spectrum_legs(args.seed, r152, fa152)
    launches["spectrum_hist"] = spec_legs[0]["launches"]["spectrum_hist"]

    clock.lap("6 spectrum legs")

    # 7. times: plain, kernel, kernel, plain at the main path's batch shape
    from cfrk_tpu_torch.tools.rowsort_times import time_graph, time_shape

    times, bounds = {}, {}
    for name, kern, plain, k, canonical, length in (
        ("rowsort_rle", R.rowsort_rle, R.rowsort_rle_plain, 8, False, 150),
        ("rowsort_rle_large", R.rowsort_rle_large, R.rowsort_rle_large_plain,
         31, True, 152),
    ):
        codes = np.full((BATCH, 256), -1, np.int8)
        codes[:, :length] = synthetic_reads(args.seed + 2, BATCH, length)
        codes = torch.from_numpy(codes).cuda()
        p1 = time_kernel(plain, codes, k, canonical)
        k1 = time_graph(lambda: kern(codes, k, canonical))
        eager = time_kernel(kern, codes, k, canonical)
        k2 = time_graph(lambda: kern(codes, k, canonical))
        p2 = time_kernel(plain, codes, k, canonical)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        w = 256 - k + 1
        bounds[name] = bound(codes.numel() + BATCH * w * 4 * (2 if k <= 15 else 3),
                             sort_ops(BATCH, w))
        log(f"time {name} k={k} canonical={canonical} [{BATCH}, 256]: kernel "
            f"{k1:.4f}/{k2:.4f} ms as a graph replay ({eager:.4f} ms in an eager "
            f"loop, which also times the host's launches), plain "
            f"{p1:.4f}/{p2:.4f} ms per batch ({card})")
    other_shapes = [time_shape(shape, k, canonical, args.seed, 50, plain=True)
                    for shape in ("short70", "contig4k")
                    for k, canonical in ((8, False), (31, True))]
    log("rowsort_other_shapes: " + json.dumps({"card": card, "times": other_shapes}))
    log("sort_yardstick: " + json.dumps({"card": card, **time_torch_sort(args.seed)}))
    spec_times = time_spectrum_routes(args.seed, card)
    times["spectrum_hist"] = spec_times.pop("spectrum_hist")
    log("spectrum_routes: " + json.dumps({"card": card, **spec_times}))
    perread_times = time_perread(args.seed, card)
    log("perread_hist_times: " + json.dumps({"card": card, **perread_times}))
    # The main path's emit ("b4", the k8_dense_api_nonzero leg's).
    times["perread_hist"] = (perread_times["b4"]["ms"], perread_times["b4"]["plain_ms"])
    # Bounds of the other kernels, from the shapes timed above: a k=8
    # table of int32 out of [8192, 256] codes; the "b4" block, one byte a
    # cell; the probe's [8192, 150] codes to one int64 a row.
    in_bytes = BATCH * 256
    bounds["spectrum_hist"] = bound(in_bytes + 4**8 * 4, BATCH * 249)
    bounds["perread_hist"] = bound(in_bytes + perread_times["b4"]["written_bytes"],
                                   BATCH * 249)
    bounds["rowsort_probe"] = bound(BATCH * 150 + BATCH * 8, sort_ops(BATCH, 143))
    probe = run_probe(card)
    launches["rowsort_probe"] = probe["launches"]
    errs["rowsort_probe"] = max(errs["rowsort_probe"], probe["err"])
    times["rowsort_probe"] = (probe["ms"], probe["plain_ms"])
    log("rowsort_probe_step_ms: " + json.dumps({
        "card": card, **{name: r["step_ms"] for name, r in probe["records"].items()}}))
    clock.lap("7 times")
    log("end_to_end: " + json.dumps({
        "card": card,
        "legs": {leg["leg"]: leg["bases_per_s"] for leg in legs + spec_legs},
    }))

    kernels = []
    for name, source, replaces in (
        ("rowsort_rle", "rowsort.cu", "cfrk_tpu/ops/pallas/rowsort.py:569"),
        ("rowsort_rle_large", "rowsort.cu", "cfrk_tpu/ops/pallas/rowsort.py:655"),
        ("spectrum_hist", "spectrum.cu", "cfrk_tpu/ops/pallas/spectrum.py:62"),
        ("perread_hist", "perread.cu", "cfrk_tpu/ops/pallas/perread.py:166"),
        ("rowsort_probe", "rowsort.cu", "tools/rowsort_probe.py:173"),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"cfrk_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            # No single PyTorch call takes int8 codes to sorted run-length
            # rows, a k-mer table or per-read histograms: the twins are
            # key building plus torch.sort / index_add_ plus more calls.
            "library_ms": None,
        })
    log(f"total: {time.perf_counter() - started:.1f} s from the card line on")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
