#!/usr/bin/env python3
"""Chip smoke test of cfrk_tpu_torch, the PyTorch + CUDA port.

Run from the root of a checkout on a machine with one NVIDIA GPU
(Hopper, sm_90a):

    python3 chip_smoke.py [--seed 0]

Phases, each of which exits non-zero on failure:

1. card: the GPU's name and power limit, torch and CUDA versions, the
   host's ``free -g``;
2. build: compiles the CUDA kernels and the host library from csrc/
   (one nvcc per kernel source and the host C++ compiler for
   ``fastaio.cpp``, all started together), logging the host compiler
   and its seconds;
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
   bytes); then the host library (``io/native``) against its numpy and
   Python twins at the main path's sizes, byte- or array-equal: the
   whole-file and the chunked parser on the 100k x 150 bp file,
   ``pack_records`` on one batch, the pair formatters on one k=8 and one
   k=31 canonical batch of the kernels' pairs, the dense formatters, the
   sparse tsv formatter and the dense fold on one batch; their seconds
   go on the ``host`` line;
4. goldens: ``python -m cfrk_tpu_torch <seqN.fasta.gz> <out> 2`` must
   reproduce tests/data/goldens.json;
5. main path at real size: seeded synthetic reads (100k x 150 bp and
   100k x 152 bp, the synthetic-read configuration of BASELINE.json)
   through the CLI on the GPU — k=8 ``--nonzero``, k=31 ``--canonical
   --nonzero``, dense k=8 rows of the first 256 reads; then the dense
   per-read API on the 150 bp reads, ``8 --nonzero --impl pallas`` (the
   "b4" packed kernel; the first batch of reads) and ``4 --impl
   pallas`` (dense rows, the unpacked kernel; all 100k), each also
   byte-equal to the auto route (per-read sort + RLE) on the same
   reads.  Each must launch its kernel, call the host library (its
   counters are set to 0 just before the leg and read just after, in
   every leg of phases 5-7),
   write the same bytes as ``--device cpu`` and agree on sampled rows
   with string-slicing ground truth;
6. spectrum legs at real size (BASELINE.json configs 3 and 4): 1M
   seeded 150 bp reads through ``--mode spectrum`` at k=8 (the
   histogram kernel; its row must equal the numpy oracle) and, on the
   first 125k of them, at k=15 ``--spectrum-format hist`` (the sorted
   route on the rowsort kernel; sum of count x kmers must equal the
   valid windows), and the 100k x
   152 bp reads through ``-k 31 --canonical --mode sparse`` (tsv equal
   to an independent numpy spectrum on sampled lines).  Each leg's
   counts are set to 0 just before it, must show its kernel launched,
   and its bytes must equal ``--device cpu``;
7. streamed legs (``--stream`` / ``--resume`` / ``--packed``), each
   with every kernel count set to 0 just before it and read just after:
   the 100k x 150 bp file through ``8 --nonzero --stream --stats``
   (sha256 of the k=8 leg of phase 5, no checkpoint left, its
   ``stages_s`` logged); the same command as a subprocess killed by
   ``CFRK_FAULT_INJECT=batch-written:7`` (non-zero exit, a torn tail and
   a checkpoint left) and resumed in this process (fewer launches than
   the fresh run, the same sha256); ``31 --canonical --nonzero --stream``
   on a BGZF copy of the 152 bp file, killed at ``checkpoint:5`` and
   resumed by a seek to the checkpoint's decompressed offset (no
   re-parse warning); ``8 --nonzero --stream --packed`` on the first
   batch of reads (the per-read histogram kernel, sha256 of phase 5's
   dense-API leg); and ``--mode spectrum --stream`` at k=8 on the 1M
   reads as a subprocess beside a non-streamed subprocess (each reports its
   launches; bytes equal to phase 6's leg; both peak RSS logged); then
   the sparse streaming driver: ``31 --canonical --mode sparse --stream
   --stats`` on the 100k x 152 bp file (13 launches of the k=31 kernel,
   the sha256 of phase 6's sparse leg, no checkpoint or spill directory
   left); 600k x 152 bp seeded reads through the same command with
   ``--mem-budget-mb 256 --checkpoint-every 16`` as a child killed at
   ``CFRK_FAULT_INJECT=checkpoint:3`` (its checkpoint lists at least 2
   spilled runs), resumed in this process (fewer launches than a fresh
   run) and held to the sha256 of an unbudgeted ``--stream`` child, both
   children's peak RSS logged; and ``-k 15 --mode spectrum --stream
   --spectrum-format hist`` on the 125k x 150 bp reads (the sorted route:
   the k <= 15 rowsort kernel, the sha256 of phase 6's k=15 leg);
8. times: each kernel's ms per 8192-read batch beside the plain route's
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
   bases/s of phases 5 to 7; the two rowsort kernels with
   ``checksum=True`` at the main batch and at widths of every launch
   layout, their ``chk`` array-equal to the plain twins' and their rows
   to the ``checksum=False`` call's, and both timed as graph replays
   with and without it; and the rowsort probe tool
   (``python -m cfrk_tpu_torch.tools.rowsort_probe``) for each variant
   at k = 8 and k = 31, its checksums held to the plain twin's;
9. entry layer, each leg the CLI in a child process reporting its
   launches: ``workflow_k8_8shards`` (eight 100k x 150 bp shards, seeds
   0-7, shard 0 the phase 5 file, through ``8 --nonzero --out-dir D
   --stats --config`` with a JSON config of 2 parallel tasks, 1 retry
   and a provenance log; shard 0's sha256 that of ``k8_nonzero``, the
   eight parts merged by ``tools/merge_outputs`` equal to one run over
   the joined shards in this process, sampled merged rows against string
   slicing, 8 ok
   provenance records; the same at 1 parallel task, the overlap, the sum
   of task durations over the wall, logged for both);
   ``workflow_retry_resume`` (two shards, ``--stream --retries 1`` under
   ``CFRK_FAULT_INJECT=checkpoint:5``: one task retried, counting fewer
   reads than its shard, both outputs equal the uninterrupted ones);
   ``workflow_spectrum_k8_4shards`` (the 1M-read file in 4 shards,
   ``--mode spectrum -k 8``, merged equal to ``spectrum_k8``);
   ``stdin_k8_nonzero`` (the phase 5 file piped through ``cat``, ``gzip
   -1 -c`` and into ``--stream``, each equal to ``k8_nonzero``);
   ``profile_k8`` (``--profile``: a Chrome trace whose kernel events
   name ``rowsort_rle`` with device time); ``list_devices`` (one line,
   an H100 with its memory);
10. the user and validation tools of ``cfrk_tpu_torch/tools``, each in
   this process with every kernel count set to 0 before it and read
   after it: ``onchip_validate`` (its ``GPU_VALID.json`` under
   ``build/chip_smoke``, every check ok, all five kernels launched; its
   ``mesh_kernel_probes`` check run once more alone, launching
   ``perread_hist`` and ``rowsort_rle`` on one-device meshes);
   ``onchip_fuzz`` (40 trials, at least one past the kernel ceiling
   through the tiled route); ``fuzz_cli --devices 8`` (24 trials of the
   CLI on the card against the numpy spec, with ``cuda:0`` repeated 8
   times, so that the seed draws mesh and seqpar trials, at least one of
   each; the two row-sort kernels and the spectrum kernel launched; its
   launches join the main path's counts);
   the golden round trip (phase 4's k=2 ``.cfrk`` of seq2 rebuilt by
   ``reconstruct_fasta`` and counted again to the golden sha256);
   ``make_synthetic`` (50k reads, BGZF) and ``query_spectrum --stats``
   on phase 6's ``spectrum_k8`` row (its total equal to the valid
   windows); ``scale_demo --reads 50000 --skip sparse
   --scale-check-reads 0`` on that file (two CLI children, each leg with
   its sha256, ``--stats`` line and bases/s);
11. byte-ranged runs (``--distributed``, one input): 2 ranks of the CLI
   as child processes sharing the card, started with the JAX package's
   coordinator variables on 127.0.0.1 (gloo), each reporting its
   launches: ``8 --nonzero`` over a BGZF copy of the 100k x 150 bp file
   with rank 1 killed at ``CFRK_FAULT_INJECT=checkpoint:2`` (both ranks
   exit non-zero, rank 0 at the barrier, and no output is written),
   then both resumed with ``--resume`` to the sha256 of ``k8_nonzero``;
   ``-k 8 --mode spectrum`` over the plain 1M-read file to the sha256
   of ``spectrum_k8``; ``-k 31 --canonical --mode sparse`` over the
   plain 100k x 152 bp file to the sha256 of ``sparse_k31_canonical``;
   ``8 --nonzero`` over the plain 100k x 150 bp file with the ranks
   started from SLURM's variables alone (``SLURM_JOB_ID``,
   ``SLURM_STEP_NODELIST=localhost``, ``SLURM_NTASKS=2``,
   ``SLURM_PROCID``, ``SLURM_LOCALID=0`` and ``JAX_COORDINATOR_PORT``)
   to the sha256 of ``k8_nonzero``.
   Each rank of each finished run must launch the leg's kernel
   (``rowsort_rle``, ``spectrum_hist``, ``rowsort_rle_large``), and no
   part file may remain; each rank's wall and reads are logged.  Then
   ``--distributed`` with several inputs: three of phase 9's shards dealt
   to the 2 ranks (rank 0 runs two as a workflow, rank 1 one), each
   output equal to its shard's single-process sha256;
12. the mesh on one card, in this process: the library drivers over
   meshes of ``cuda:0`` repeated, with every kernel count set to 0 just
   before each leg and read just after (the exact launches a leg's
   devices make are required): the 100k x 150 bp file's k=8 rows over
   4 devices (``count_file_sparse_rows``; sha256 of ``k8_nonzero``); the
   packed "b4" emit over 2 devices on the dense-API leg's 8192 reads
   (sha256 of ``k8_dense_api_nonzero``); the 1M-read k=8 spectrum over a
   (2, 2) mesh, psum and the tp scatter (sha256 of ``spectrum_k8``); the
   k=31 canonical sparse spectrum through the bucket exchange at slack 2
   (sha256 of ``sparse_k31_canonical``) and a low-complexity batch that
   overflows at slack 0.5 (its ``slack_used`` logged; bytes equal to the
   one-device run); 64 contigs of 64 kb over an sp mesh of 4, dense
   per-read k=5 and the sorted spectrum at k=12 (equal to one device);
   and the k=8 rows streamed over 2 devices, killed at its third
   checkpoint and resumed (sha256 of ``k8_nonzero``).  Each leg logs its
   launches, wall and the card's name and power limit;
13. the scaling ladder and the library defaults, in this process:
   ``cfrk_tpu_torch.tools.scaling_bench``'s ``main`` with ``cuda:0``
   repeated 4 times, in each mode (``perread``, ``rows``, ``spectrum``)
   at the tool's default sizes and ``--steps 4``, each launching its
   kernel (``perread_hist``, ``rowsort_rle``, ``spectrum_hist``), each
   rung's checksum equal to the same ladder's through the CPU route and
   logged with the card's name and power limit; then ``count_file``,
   ``spectrum_file`` and ``count_perread`` (on a numpy array) with no
   device, each launching its kernel on the card and equal to its
   ``device="cpu"`` result;
14. the benchmarks, each a child process: ``python -m
   cfrk_tpu_torch.bench`` (its line has the JAX bench's keys, a value
   above 0 and ``vs_sort_sol`` <= 1 in both cases); ``python -m
   cfrk_tpu_torch.tools.bench_suite --steps 512 --ingest-reads 200000
   --stream-reads 100000 --json-out`` (every case; ``golden_k2_exact``
   byte-exact, every device case's ``vs_sol`` <= 1); ``python -m
   cfrk_tpu_torch.tools.bench_format`` (its four shapes).  The first two
   report their launches (a captured graph counts each of its launches
   once), which join the main path's counts.

The bounds of the ``kernels`` line come from ``cfrk_tpu_torch/ops/
roofline.py``, the one place they are computed.

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
READS = 100_000  # BASELINE.json config 2: 100k reads per leg
# The k=8 dense-API leg takes the first batch of them: its host side
# unpacks 2.1 GB a batch, on both routes (and again in the packed stream
# of phase 7 and the packed mesh leg of phase 12), so at three batches
# those legs held about 55 s of a 567.1 s run of this script (NVIDIA H100
# 80GB HBM3, 700.00 W), and at 50k reads a fifth of a 634 s run.
DENSE_API_READS = BATCH
SPECTRUM_READS = 1_000_000  # BASELINE.json config 3: a 1M-read metagenome
# The two k = 15 sorted-route legs (phase 6's in-memory run, phase 7's
# streamed run pinned to its sha256) take the first eighth of those
# reads: at 1M each took 40-47 s of the host's fold and checkpoints; at
# 500k the run with phases 11-12 took 490.4 s, and at 250k the run with
# phases 13-14 621.4 s on a slow host (NVIDIA H100 80GB HBM3, 700 W),
# 37.4 s of it these two legs.
K15_READS = 125_000
K15_FASTA = WORK / "r_k15.fa"
# The budgeted sparse leg: config 4's k = 31 canonical reads of 152 bp,
# cut from config 3's 1M reads to 600k so that the smoke stays well under
# 600 s (at 1M the leg took 112 s of a 579 s run); about 17 M distinct
# k-mers, 270 MB of keys and counts, against a 256 MB budget: it spills.
BUDGET_READS = 600_000
BUDGET_MB = 256
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
    """Phase 3: every kernel against its plain twin (plain PyTorch, which
    runs on any device) on the same tensors on the card; returns
    {kernel name: max |kernel - plain|}."""
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
                    x = on_card(codes, case)
                    got = fn(x, k, canonical)
                    torch.cuda.synchronize()
                    want = plain(x, k, canonical)
                    for g, w in zip(got, want):
                        g, w = g.cpu(), w.cpu()
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
                        x = on_card(codes, case)
                        err = max(err, compare_arrays(
                            "perread_hist", P.perread_hist(x, k, canonical, **kw),
                            P.perread_hist_plain(x, k, canonical, **kw),
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
                x = on_card(codes, case)
                err = max(err, compare_arrays(
                    "rowsort_probe", R.rowsort_probe(x, k, variant, canonical),
                    R.rowsort_probe_plain(x, k, variant, canonical),
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
                x = on_card(codes, case)
                compare(S.spectrum_hist(x, k, canonical),
                        S.spectrum_hist_plain(x, k, canonical),
                        f"k={k} canonical={canonical} {case}")
            a, b = (torch.from_numpy(cases[n]).cuda()
                    for n in ("150bp", "edge_rows_odd_batch"))
            table = S.spectrum_hist(a, k, canonical)
            S.spectrum_hist(b, k, canonical, out=table)
            want = S.spectrum_hist_plain(a, k, canonical)
            S.spectrum_hist_plain(b, k, canonical, out=want)
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


def cpu_model() -> str:
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        if line.startswith("model name"):
            return line.split(":", 1)[1].strip()
    return "unknown"


def check_host_library(r150, r152, fa150: Path, card: str) -> dict:
    """Phase 3, the host library: each native function against its numpy
    or Python twin on the same inputs at the main path's sizes, byte- or
    array-equal; logs and returns the seconds of both, as the ``host``
    line ({function: {"native_s", "numpy_s"}})."""
    import numpy as np
    import torch

    from cfrk_tpu_torch import format as F
    from cfrk_tpu_torch.io import fasta
    from cfrk_tpu_torch.io import native as N
    from cfrk_tpu_torch.ops import sparse
    from cfrk_tpu_torch.ops.perread import count_perread
    from cfrk_tpu_torch.ops.perread_sparse import (batch_spectrum_triples,
                                                   count_perread_rows,
                                                   narrow_for_fetch, pairs_to_host)
    from cfrk_tpu_torch.pipeline.batch import pad_reads

    out = {}

    def compare(name, native_fn, numpy_fn, same=lambda a, b: a == b):
        t0 = time.perf_counter()
        got = native_fn()
        t1 = time.perf_counter()
        want = numpy_fn()
        t2 = time.perf_counter()
        if not same(got, want):
            fail(f"host library {name}: differs from its numpy twin")
        out[name] = {"native_s": t1 - t0, "numpy_s": t2 - t1}
        return got

    def same_reads(a, b):
        return len(a) == len(b) and [len(r) for r in a] == [len(r) for r in b] and (
            np.array_equal(np.concatenate(a), np.concatenate(b)))

    def same_blocks(blocks, records):
        flat = np.concatenate([b[0] for b in blocks])
        lens = np.concatenate([b[1] for b in blocks])
        offs = np.concatenate([b[2] for b in blocks])
        return (lens.tolist() == [len(c) for c, _ in records]
                and offs.tolist() == [o for _, o in records]
                and np.array_equal(flat, np.concatenate([c for c, _ in records])))

    N.parse_encode_bytes(b">warm\nACGT\n")  # the library's load, not a parse
    reads = compare("parse_encode_bytes", lambda: N.read_fasta_encoded_native(fa150),
                    lambda: list(fasta.iter_fasta_encoded(fa150)), same_reads)
    compare("iter_record_blocks_native", lambda: list(N.iter_record_blocks_native(fa150)),
            lambda: list(fasta.iter_encoded_with_offsets(fa150)), same_blocks)
    batch = reads[:BATCH]
    flat = np.concatenate(batch)
    lens = np.array([len(r) for r in batch], np.int64)
    compare("pack_records", lambda: N.pack_records(flat, lens, BATCH, 256),
            lambda: pad_reads(batch, BATCH, 256).codes, np.array_equal)

    def drained(reads_np, k, canonical):
        codes = np.full((BATCH, 256), -1, np.int8)
        codes[:, : reads_np.shape[1]] = reads_np[:BATCH]
        rows = narrow_for_fetch(count_perread_rows(torch.from_numpy(codes).cuda(), k,
                                                   canonical), k)
        narrow = [t[:BATCH].cpu().numpy() for t in rows]
        t0 = time.perf_counter()
        narrow[-1].astype(np.int32)
        widen_s = time.perf_counter() - t0
        return pairs_to_host(rows, BATCH), widen_s, codes

    (idx8, cnt8), widen8, codes8 = drained(r150, 8, False)
    (idx31, cnt31), widen31, _ = drained(r152, 31, True)
    out["widen_counts_to_int32"] = {"k8_s": widen8, "k31_s": widen31}
    compare("format_pairs_bytes k=8", lambda: N.format_pairs_bytes(idx8, cnt8),
            lambda: F.format_pairs_bytes(idx8, cnt8))
    compare("format_pairs_bytes k=31", lambda: N.format_pairs_bytes(idx31, cnt31),
            lambda: F.format_pairs_bytes(idx31, cnt31))
    compare("format_dense_pairs_bytes k=8, 256 rows",
            lambda: N.format_dense_pairs_bytes(idx8[:256], cnt8[:256], 4**8),
            lambda: F.format_dense_pairs_bytes(idx8[:256], cnt8[:256], 4**8))
    dense4 = count_perread(torch.from_numpy(codes8).cuda(), 4, impl="pallas").cpu().numpy()
    compare("format_rows_bytes k=4", lambda: N.format_rows_bytes(dense4),
            lambda: F.format_rows_bytes(dense4))
    keys, counts = np.unique(numpy_kmer_keys(r152[:BATCH], 31, True), return_counts=True)
    compare("format_kmer_tsv_bytes k=31", lambda: N.format_kmer_tsv_bytes(keys, counts, 31),
            lambda: F.format_kmer_tsv_bytes(keys, counts, 31))
    _, lo, cnt = batch_spectrum_triples(codes8, 10, max_len=150, device="cuda")

    def fold(fn):
        table = np.zeros(4**10, np.int64)
        fn(table, lo, cnt)
        return table

    compare("fold_pairs_into k=10", lambda: fold(N.fold_pairs_into),
            lambda: fold(sparse.fold_pairs_into), np.array_equal)
    log("host library vs numpy: " + ", ".join(n for n in out if "widen" not in n)
        + ": byte- or array-equal")
    log("host: " + json.dumps({"card": card, "nproc": os.cpu_count(), "cpu": cpu_model(),
                               "functions": out}))
    return out


# Host library functions each leg must call (its counters set to 0 just
# before the leg and read just after).
NATIVE_BY_LEG = {
    "k8_nonzero": ("parse_encode_bytes", "format_pairs_bytes"),
    "k31_canonical_nonzero": ("parse_encode_bytes", "format_pairs_bytes"),
    "k8_dense_256": ("parse_encode_bytes", "format_dense_pairs_bytes"),
    "k8_dense_api_nonzero": ("parse_encode_bytes", "format_pairs_bytes"),
    "k4_dense_api": ("parse_encode_bytes", "format_rows_bytes"),
    "spectrum_k8": ("parse_encode_bytes", "format_rows_bytes"),
    "spectrum_k15_hist": ("parse_encode_bytes",),
    "sparse_k31_canonical": ("parse_encode_bytes", "format_kmer_tsv_bytes"),
    "k8_nonzero_stream": ("iter_record_blocks_native", "pack_records",
                          "format_pairs_bytes"),
    "k8_nonzero_kill_resume": ("iter_record_blocks_native", "pack_records",
                               "format_pairs_bytes"),
    "k31_canonical_nonzero_stream": ("iter_record_blocks_native", "pack_records",
                                     "format_pairs_bytes"),
    "k8_packed_stream": ("iter_record_blocks_native", "pack_records",
                         "format_pairs_bytes"),
    "spectrum_k8_stream": ("iter_record_blocks_native", "pack_records",
                           "format_rows_bytes"),
    "spectrum_k8_in_memory": ("parse_encode_bytes", "format_rows_bytes"),
    "sparse_k31_canonical_stream": ("iter_record_blocks_native", "pack_records",
                                    "format_kmer_tsv_bytes"),
    "sparse_k31_budget_kill_resume": ("iter_record_blocks_native", "pack_records",
                                      "format_kmer_tsv_bytes"),
    "sparse_k31_unbudgeted_child": ("iter_record_blocks_native", "pack_records",
                                    "format_kmer_tsv_bytes"),
    "spectrum_k15_stream": ("iter_record_blocks_native", "pack_records"),
    "workflow_k8_joined": ("parse_encode_bytes", "format_pairs_bytes"),
}


def reset_native() -> None:
    from cfrk_tpu_torch.io import native as N

    for fn in N.COUNTED:
        fn.calls = 0


def native_calls(label: str, calls: dict | None = None) -> dict:
    """The host library's calls since :func:`reset_native` (or a child's
    ``calls``); fails if a function ``label`` must call was not called."""
    from cfrk_tpu_torch.io import native as N

    if calls is None:
        calls = {fn.__name__: fn.calls for fn in N.COUNTED}
    missing = [name for name in NATIVE_BY_LEG[label] if calls.get(name, 0) <= 0]
    if missing:
        fail(f"{label}: the host library's {missing} were not called: {calls}")
    return {name: n for name, n in calls.items() if n}


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
    reset_native()
    t0 = time.perf_counter()
    if main([str(fasta), str(out_gpu), *flags]) != 0:
        fail(f"{label}: CLI exit")
    wall = time.perf_counter() - t0
    launches = kernel.launches - before
    native = native_calls(label)
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
        "bases_per_s": bases / wall, "launches": launches, "native_calls": native,
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
                     kernels: dict, check, keep: bool = False) -> dict:
    """Phase 6, one leg: every kernel count set to 0 just before the CLI
    runs on the GPU and read just after (the leg's own kernel must have
    launched), the same CLI on ``--device cpu``, byte comparison, then
    ``check(output bytes)``.  Returns the leg's numbers; with ``keep``,
    the GPU's output stays at ``WORK/<label>.cfrk`` (its ``output``)."""
    from cfrk_tpu_torch.cli import main

    out_gpu = WORK / f"{label}.cuda.out"
    out_cpu = WORK / f"{label}.cpu.out"
    for fn in kernels.values():
        fn.launches = 0
    reset_native()
    t0 = time.perf_counter()
    if main([str(fasta), "-o", str(out_gpu), *flags]) != 0:
        fail(f"{label}: CLI exit")
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    native = native_calls(label)
    t0 = time.perf_counter()
    if main([str(fasta), "-o", str(out_cpu), *flags, "--device", "cpu"]) != 0:
        fail(f"{label}: CPU CLI exit")
    cpu_wall = time.perf_counter() - t0
    gpu_bytes = out_gpu.read_bytes()
    if gpu_bytes != out_cpu.read_bytes():
        fail(f"{label}: GPU bytes differ from --device cpu bytes")
    checked = check(gpu_bytes)
    kept = None
    if keep:
        kept = out_gpu.rename(WORK / f"{label}.cfrk")
    else:
        out_gpu.unlink()
    out_cpu.unlink()
    res = {
        "leg": label, "reads": len(reads), "bases": int(reads.size),
        "cuda_wall_s": wall, "cpu_route_wall_s": cpu_wall,
        "bases_per_s": int(reads.size) / wall, "launches": launches,
        "native_calls": native, "bytes": len(gpu_bytes), "checked": checked,
        "sha256": hashlib.sha256(gpu_bytes).hexdigest(),
    }
    log(f"spectrum leg {label}: " + json.dumps(res))
    res["output"] = kept
    return res


def spectrum_legs(seed: int, r152, fa152: Path, fa1m: Path) -> list:
    """Phase 6: the spectrum modes at BASELINE.json config 3's read count
    (written to ``fa1m``) and config 4's k = 31 canonical sparse
    spectrum."""
    import numpy as np

    from cfrk_tpu_torch.ops.cuda import rowsort as R
    from cfrk_tpu_torch.ops.cuda import spectrum as S
    from cfrk_tpu_torch.ops.reference import spectrum_np

    kernels = {"rowsort_rle": R.rowsort_rle,
               "rowsort_rle_large": R.rowsort_rle_large,
               "spectrum_hist": S.spectrum_hist}
    r1m = synthetic_reads(seed + 3, SPECTRUM_READS, 150)
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

    r_k15 = r1m[:K15_READS]
    write_fasta(K15_FASTA, r_k15)

    def check_k15(out: bytes) -> str:
        pairs = np.array([[int(x) for x in line.split(b"\t")]
                          for line in out.splitlines()], np.int64)
        total = int((pairs[:, 0] * pairs[:, 1]).sum())
        want = valid_windows(r_k15, 15)
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
                         kernels, check_k8, keep=True),
        run_spectrum_leg("spectrum_k15_hist", K15_FASTA, r_k15,
                         ["-k", "15", "--mode", "spectrum", "--spectrum-format", "hist"],
                         kernels, check_k15),
        run_spectrum_leg("sparse_k31_canonical", fa152, r152,
                         ["-k", "31", "--canonical", "--mode", "sparse"],
                         kernels, check_k31),
    ]
    for leg, name in zip(legs, ("spectrum_hist", "rowsort_rle", "rowsort_rle_large")):
        if leg["launches"][name] <= 0:
            fail(f"{leg['leg']}: {name} was not launched")
    legs[0]["valid_windows"] = valid_windows(r1m, 8)
    return legs


# A child that runs the CLI and then reports its kernels' launches and
# the host library's calls, which this process cannot count across the
# process boundary.
_CLI_CHILD = (
    "import json, sys\n"
    "from cfrk_tpu_torch.cli import main\n"
    "from cfrk_tpu_torch.io import native\n"
    "from cfrk_tpu_torch.ops.cuda import perread, rowsort, spectrum\n"
    "rc = main(sys.argv[1:])\n"
    "print(json.dumps({'launches': {f.__name__: f.launches for f in ("
    "rowsort.rowsort_rle, rowsort.rowsort_rle_large, spectrum.spectrum_hist, "
    "perread.perread_hist)}, "
    "'native_calls': {f.__name__: f.calls for f in native.COUNTED}}))\n"
    "sys.exit(rc)\n"
)


def run_child(label: str, argv: list, env_extra: dict | None = None,
              stdin=None) -> dict:
    """One child process to its end: its exit code, what it wrote, and
    the peak of its resident set in MB, sampled from ``/proc/<pid>/statm``
    every 20 ms.  (``ru_maxrss`` of a child starts at its parent's
    resident set at the fork, here many times the child's own, and
    ``VmHWM`` is not on every kernel's ``/proc``.)  ``stdin``: a pipe
    or file the child reads as its standard input."""
    paths = [WORK / f"{label}.child.{name}" for name in ("out", "err")]
    page_mb = os.sysconf("SC_PAGE_SIZE") / 2**20
    peak, deadline = 0, time.perf_counter() + 600
    with open(paths[0], "wb") as out, open(paths[1], "wb") as err:
        proc = subprocess.Popen(argv, cwd=ROOT, stdin=stdin, stdout=out, stderr=err,
                                env={**os.environ, **(env_extra or {})})
        while proc.poll() is None:
            try:
                pages = int(Path(f"/proc/{proc.pid}/statm").read_text().split()[1])
                peak = max(peak, pages)
            except (OSError, ValueError, IndexError):
                pass  # the child has just gone
            if time.perf_counter() > deadline:
                proc.kill()
                proc.wait()
                fail(f"{label}: the child ran past 600 s")
            time.sleep(0.02)
    res = {"rc": proc.returncode, "out": paths[0].read_text(),
           "err": paths[1].read_text(), "peak_rss_mb": peak * page_mb}
    for path in paths:
        path.unlink()
    return res


def stats_metrics(stderr: str) -> dict:
    """The streamed run's metrics line (the one with ``stages_s``) among
    what ``--stats`` wrote to stderr."""
    for line in reversed(stderr.strip().splitlines()):
        if line.startswith("{") and '"stages_s"' in line:
            return json.loads(line)
    fail(f"no metrics line on stderr: {stderr[-400:]}")


def run_cli_here(label: str, argv: list, kernels: dict) -> dict:
    """The CLI in this process with every kernel count and host library
    counter set to 0 just before and read just after; returns the
    launches, the library calls, the wall seconds, what it wrote to
    stderr and, with ``--stats``, its metrics line."""
    from cfrk_tpu_torch.cli import main

    for fn in kernels.values():
        fn.launches = 0
    reset_native()
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"{label}: CLI exit {rc}: {err.getvalue()[-400:]}")
    res = {"launches": {name: fn.launches for name, fn in kernels.items()},
           "native_calls": native_calls(label), "wall_s": wall,
           "stderr": err.getvalue()}
    if "--stats" in argv:
        res["metrics"] = stats_metrics(err.getvalue())
    return res


def sha256_of(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def killed_then_resumed(label: str, fasta: Path, flags: list, fault: str,
                        kernels: dict, kernel: str, fresh_launches: int,
                        want_sha: str) -> dict:
    """One streamed run as a child killed at ``fault`` (it must exit
    non-zero and leave an output and a checkpoint), then ``--resume`` in
    this process: it must launch ``kernel``, fewer times than a fresh
    run, and end on ``want_sha`` with no checkpoint left."""
    out = WORK / f"{label}.cfrk"
    ckpt = Path(str(out) + ".ckpt.json")
    child = run_child(label, [sys.executable, "-m", "cfrk_tpu_torch", str(fasta),
                              str(out), *flags, "--stream"],
                      {"CFRK_FAULT_INJECT": fault})
    if child["rc"] == 0 or "InjectedFault" not in child["err"]:
        fail(f"{label}: the child armed with {fault} exited {child['rc']}: "
             f"{child['err'][-400:]}")
    if not out.exists() or not ckpt.exists():
        fail(f"{label}: the killed run left no output or no checkpoint")
    state = json.loads(ckpt.read_text())
    torn = out.stat().st_size - state["out_bytes"]
    if torn < 0 or (fault.startswith("batch-written") and torn == 0):
        fail(f"{label}: output of {out.stat().st_size} bytes against a "
             f"checkpoint of {state['out_bytes']}: no torn tail")
    run = run_cli_here(label, [str(fasta), str(out), *flags, "--resume", "--stats"],
                       kernels)
    launches = run["launches"][kernel]
    if not 0 < launches < fresh_launches:
        fail(f"{label}: the resumed run launched {kernel} {launches} times, a "
             f"fresh run {fresh_launches}")
    if sha256_of(out) != want_sha:
        fail(f"{label}: the resumed bytes differ from the non-streamed leg's")
    if ckpt.exists():
        fail(f"{label}: the checkpoint outlived the resumed run")
    out.unlink()
    res = {"leg": label, "fault": fault, "child_rc": child["rc"],
           "reads_done_at_kill": state["reads_done"],
           "input_offset_at_kill": state["input_offset"], "torn_tail_bytes": torn,
           "resume_launches": run["launches"], "fresh_launches": fresh_launches,
           "resume_native_calls": run["native_calls"],
           "resume_wall_s": run["wall_s"], "resume_stages_s": run["metrics"]["stages_s"],
           "resume_stderr": [line for line in run["stderr"].strip().splitlines()
                             if not line.startswith("{")]}
    log(f"streamed leg {label}: " + json.dumps(res))
    return res


def streamed_legs(fa150: Path, fa152: Path, fa_half: Path, fa1m: Path,
                  sha: dict, seed: int) -> tuple:
    """Phase 7: the streaming drivers at the sizes of phases 5 and 6.
    ``sha`` holds the sha256 of the non-streamed legs' bytes by leg name.
    Returns (legs, launches by kernel over the runs made in this process
    and the children that report theirs)."""
    from cfrk_tpu_torch.io.bgzf import is_bgzf, write_bgzf
    from cfrk_tpu_torch.ops.cuda import perread as P
    from cfrk_tpu_torch.ops.cuda import rowsort as R
    from cfrk_tpu_torch.ops.cuda import spectrum as S

    kernels = {"rowsort_rle": R.rowsort_rle, "rowsort_rle_large": R.rowsort_rle_large,
               "spectrum_hist": S.spectrum_hist, "perread_hist": P.perread_hist}
    legs, total = [], dict.fromkeys(kernels, 0)

    def whole_run(label, fasta, flags, kernel, want_sha, bases):
        out = WORK / f"{label}.cfrk"
        run = run_cli_here(label, [str(fasta), str(out), *flags, "--stream", "--stats"],
                           kernels)
        if run["launches"][kernel] <= 0:
            fail(f"{label}: {kernel} was not launched")
        if sha256_of(out) != want_sha:
            fail(f"{label}: the streamed bytes differ from the non-streamed leg's")
        if Path(str(out) + ".ckpt.json").exists():
            fail(f"{label}: the checkpoint outlived the run")
        out.unlink()
        for name, n in run["launches"].items():
            total[name] += n
        res = {"leg": label, "launches": run["launches"],
               "native_calls": run["native_calls"], "cuda_wall_s": run["wall_s"],
               "bases": bases, "bases_per_s": bases / run["wall_s"],
               "metrics": run["metrics"]}
        log(f"streamed leg {label}: " + json.dumps(res))
        legs.append(res)
        return res

    fresh = whole_run("k8_nonzero_stream", fa150, ["8", "--nonzero"], "rowsort_rle",
                      sha["k8_nonzero"], READS * 150)
    k8 = killed_then_resumed(
        "k8_nonzero_kill_resume", fa150, ["8", "--nonzero"], "batch-written:7",
        kernels, "rowsort_rle", fresh["launches"]["rowsort_rle"], sha["k8_nonzero"])

    bgzf152 = WORK / "r152.fa.gz"
    write_bgzf(bgzf152, fa152.read_bytes())
    if not is_bgzf(bgzf152):
        fail("write_bgzf wrote a file that is_bgzf does not take")
    k31 = killed_then_resumed(
        "k31_canonical_nonzero_stream", bgzf152, ["31", "--canonical", "--nonzero"],
        "checkpoint:5", kernels, "rowsort_rle_large", -(-READS // BATCH),
        sha["k31_canonical_nonzero"])
    if k31["input_offset_at_kill"] is None or any(
            "re-parses" in line for line in k31["resume_stderr"]):
        fail("k31_canonical_nonzero_stream: the resume on BGZF input re-parsed "
             "instead of seeking to the checkpoint's decompressed offset")
    bgzf152.unlink()
    for leg in (k8, k31):
        legs.append(leg)
        for name, n in leg["resume_launches"].items():
            total[name] += n

    whole_run("k8_packed_stream", fa_half, ["8", "--nonzero", "--packed"],
              "perread_hist", sha["k8_dense_api_nonzero"], DENSE_API_READS * 150)

    # The 1M reads, streamed and not, each in a process of its own so
    # that its peak resident set is its own.
    spec = {}
    for name, extra in (("spectrum_k8_stream", ["--stream", "--stats"]),
                        ("spectrum_k8_in_memory", [])):
        out = WORK / f"{name}.spectrum"
        t0 = time.perf_counter()
        child = run_child(name, [sys.executable, "-c", _CLI_CHILD, str(fa1m), "-k", "8",
                                 "--mode", "spectrum", "-o", str(out), *extra])
        wall = time.perf_counter() - t0
        if child["rc"] != 0:
            fail(f"{name}: exit {child['rc']}: {child['err'][-400:]}")
        report = json.loads(child["out"].strip().splitlines()[-1])
        launches = report["launches"]
        if launches["spectrum_hist"] <= 0:
            fail(f"{name}: spectrum_hist was not launched")
        if sha256_of(out) != sha["spectrum_k8"]:
            fail(f"{name}: bytes differ from the spectrum_k8 leg's")
        if Path(str(out) + ".ckpt.json").exists():
            fail(f"{name}: the checkpoint outlived the run")
        out.unlink()
        spec[name] = {"launches": launches,
                      "native_calls": native_calls(name, report["native_calls"]),
                      "process_wall_s": wall, "peak_rss_mb": child["peak_rss_mb"]}
        if extra:
            spec[name]["metrics"] = stats_metrics(child["err"])
    total["spectrum_hist"] += spec["spectrum_k8_stream"]["launches"]["spectrum_hist"]
    streamed = spec["spectrum_k8_stream"]
    res = {"leg": "spectrum_k8_stream", "bases": SPECTRUM_READS * 150,
           "bases_per_s": streamed["metrics"]["bases_per_sec"], **spec}
    log("streamed leg spectrum_k8_stream: " + json.dumps(res))
    log("peak_rss_mb at 1M reads, --mode spectrum k=8: streamed "
        f"{streamed['peak_rss_mb']:.1f}, in memory "
        f"{spec['spectrum_k8_in_memory']['peak_rss_mb']:.1f}")
    legs.append(res)

    for leg in sparse_streamed_legs(fa152, fa1m, sha, kernels, seed):
        legs.append(leg)
        for launches in (leg["launches"], leg.get("unbudgeted_launches", {})):
            for name, n in launches.items():
                total[name] += n
    return legs, total


def spill_state(out: Path) -> tuple:
    """(checkpoint path, spill directory) of a streamed run's output."""
    ckpt = Path(str(out) + ".ckpt.json")
    return ckpt, Path(str(ckpt) + ".spill")


def sparse_streamed_legs(fa152: Path, fa1m: Path, sha: dict, kernels: dict,
                         seed: int) -> list:
    """Phase 7, the sparse streaming driver and the sorted hand-over:
    the 100k x 152 bp k=31 canonical sparse spectrum streamed; the same
    at 600k reads under a memory budget, killed at its third checkpoint,
    resumed and held to an unbudgeted child; the k=15 dense spectrum
    streamed through the sorted route.  Each leg's counts are set to 0
    just before it and read just after (``run_cli_here``; a child
    reports its own)."""
    legs = []
    sparse = ["-k", "31", "--canonical", "--mode", "sparse", "--stream"]

    label = "sparse_k31_canonical_stream"
    out = WORK / f"{label}.kmers.tsv"
    run = run_cli_here(label, [str(fa152), "-o", str(out), *sparse, "--stats"], kernels)
    if run["launches"]["rowsort_rle_large"] != -(-READS // BATCH):
        fail(f"{label}: rowsort_rle_large launched {run['launches']['rowsort_rle_large']} "
             f"times, not {-(-READS // BATCH)}")
    if sha256_of(out) != sha["sparse_k31_canonical"]:
        fail(f"{label}: the streamed bytes differ from the sparse_k31_canonical leg's")
    if any(p.exists() for p in spill_state(out)):
        fail(f"{label}: a checkpoint or spill directory outlived the run")
    out.unlink()
    legs.append({"leg": label, "launches": run["launches"],
                 "native_calls": run["native_calls"], "cuda_wall_s": run["wall_s"],
                 "bases": READS * 152, "bases_per_s": READS * 152 / run["wall_s"],
                 "metrics": run["metrics"]})
    log(f"streamed leg {label}: " + json.dumps(legs[-1]))

    # BUDGET_READS x 152 bp under a budget: a child killed at its third
    # checkpoint, resumed here, against an unbudgeted child of the file.
    label = "sparse_k31_budget_kill_resume"
    fa = WORK / "r1m152.fa"
    t0 = time.perf_counter()
    write_fasta(fa, synthetic_reads(seed + 4, BUDGET_READS, 152))
    made_s = time.perf_counter() - t0
    out = WORK / f"{label}.kmers.tsv"
    ckpt, spill = spill_state(out)
    budget = ["--mem-budget-mb", str(BUDGET_MB), "--checkpoint-every", "16"]
    t0 = time.perf_counter()
    killed = run_child(f"{label}_killed", [sys.executable, "-m", "cfrk_tpu_torch", str(fa),
                                           "-o", str(out), *sparse, *budget],
                       {"CFRK_FAULT_INJECT": "checkpoint:3"})
    killed_wall = time.perf_counter() - t0
    if killed["rc"] == 0 or "InjectedFault" not in killed["err"]:
        fail(f"{label}: the child armed with checkpoint:3 exited {killed['rc']}: "
             f"{killed['err'][-400:]}")
    if out.exists() or not ckpt.exists():
        fail(f"{label}: the killed run left an output or no checkpoint")
    state = json.loads(ckpt.read_text())
    runs = state["sparse_runs"] or []
    if len(runs) < 2 or sorted(p.name for p in spill.iterdir()) != sorted(
            f"{b}.{part}.npy" for b in runs for part in ("counts", "keys")):
        fail(f"{label}: the checkpoint lists {runs}, the spill directory holds "
             f"{sorted(p.name for p in spill.iterdir()) if spill.exists() else None}")
    spilled_mb = sum(p.stat().st_size for p in spill.iterdir()) / 2**20
    fresh_launches = -(-BUDGET_READS // BATCH)
    run = run_cli_here(label, [str(fa), "-o", str(out), *sparse, *budget, "--resume",
                               "--stats"], kernels)
    if not 0 < run["launches"]["rowsort_rle_large"] < fresh_launches:
        fail(f"{label}: the resumed run launched rowsort_rle_large "
             f"{run['launches']['rowsort_rle_large']} times, a fresh run {fresh_launches}")
    if any(p.exists() for p in (ckpt, spill)):
        fail(f"{label}: a checkpoint or spill directory outlived the resumed run")
    resumed_sha = sha256_of(out)
    out.unlink()
    full = WORK / f"{label}.unbudgeted.kmers.tsv"
    t0 = time.perf_counter()
    child = run_child("sparse_k31_unbudgeted_child", [sys.executable, "-c", _CLI_CHILD,
                                                      str(fa), "-o", str(full), *sparse,
                                                      "--stats"])
    child_wall = time.perf_counter() - t0
    if child["rc"] != 0:
        fail(f"{label}: the unbudgeted child exited {child['rc']}: {child['err'][-400:]}")
    report = json.loads(child["out"].strip().splitlines()[-1])
    if report["launches"]["rowsort_rle_large"] != fresh_launches:
        fail(f"{label}: the unbudgeted child launched rowsort_rle_large "
             f"{report['launches']['rowsort_rle_large']} times, not {fresh_launches}")
    if sha256_of(full) != resumed_sha:
        fail(f"{label}: the budgeted, killed and resumed bytes differ from the "
             "unbudgeted run's")
    tsv_bytes = full.stat().st_size
    full.unlink()
    fa.unlink()
    legs.append({
        "leg": label, "reads": BUDGET_READS, "budget_mb": BUDGET_MB,
        "fasta_made_s": made_s, "killed_process_wall_s": killed_wall,
        "killed_peak_rss_mb": killed["peak_rss_mb"],
        "reads_done_at_kill": state["reads_done"], "runs_at_kill": runs,
        "spilled_mb_at_kill": spilled_mb, "fresh_launches": fresh_launches,
        "launches": run["launches"], "native_calls": run["native_calls"],
        "resume_wall_s": run["wall_s"], "resume_metrics": run["metrics"],
        "unbudgeted_process_wall_s": child_wall,
        "unbudgeted_peak_rss_mb": child["peak_rss_mb"],
        "unbudgeted_launches": report["launches"],
        "unbudgeted_native_calls": native_calls("sparse_k31_unbudgeted_child",
                                                report["native_calls"]),
        "unbudgeted_metrics": stats_metrics(child["err"]), "tsv_bytes": tsv_bytes,
        "sha256": resumed_sha,
    })
    log(f"streamed leg {label}: " + json.dumps(legs[-1]))
    log(f"peak_rss_mb at {BUDGET_READS} x 152 bp, k=31 canonical sparse --stream: "
        f"budgeted {BUDGET_MB} MB child (killed at checkpoint 3 of "
        f"{fresh_launches // 16}) {killed['peak_rss_mb']:.1f}, unbudgeted child "
        f"{child['peak_rss_mb']:.1f}")

    label = "spectrum_k15_stream"
    out = WORK / f"{label}.hist"
    run = run_cli_here(label, [str(K15_FASTA), "-o", str(out), "-k", "15", "--mode",
                               "spectrum", "--stream", "--spectrum-format", "hist", "--stats"],
                       kernels)
    if run["launches"]["rowsort_rle"] <= 0:
        fail(f"{label}: rowsort_rle was not launched")
    if sha256_of(out) != sha["spectrum_k15_hist"]:
        fail(f"{label}: the streamed bytes differ from the spectrum_k15_hist leg's")
    if any(p.exists() for p in spill_state(out)):
        fail(f"{label}: a checkpoint outlived the run")
    out.unlink()
    legs.append({"leg": label, "launches": run["launches"],
                 "native_calls": run["native_calls"], "cuda_wall_s": run["wall_s"],
                 "bases": K15_READS * 150,
                 "bases_per_s": K15_READS * 150 / run["wall_s"],
                 "metrics": run["metrics"]})
    log(f"streamed leg {label}: " + json.dumps(legs[-1]))
    return legs


# ---------------------------------------------------------------- entry layer

ENTRY_SHARDS = 8  # the 8-shard per-read workflow: shard i of seed + i
SPECTRUM_SHARDS = 4  # the 1M-read file cut into 4 shards of 250k


def cli_child(label: str, argv: list, env_extra: dict | None = None, stdin=None,
              rc: int = 0) -> dict:
    """The CLI (``_CLI_CHILD``) in a child process that must exit ``rc``:
    ``run_child``'s record with the child's wall, its kernels' launches
    and host library calls, and the ``--stats`` summary line if any."""
    t0 = time.perf_counter()
    res = run_child(label, [sys.executable, "-c", _CLI_CHILD, *argv], env_extra, stdin)
    res["process_wall_s"] = time.perf_counter() - t0
    if res["rc"] != rc:
        fail(f"{label}: the child exited {res['rc']}, not {rc}: {res['err'][-600:]}")
    report = json.loads(res["out"].strip().splitlines()[-1])
    res["launches"] = {name: n for name, n in report["launches"].items() if n}
    res["native_calls"] = {name: n for name, n in report["native_calls"].items() if n}
    summary = [line for line in res["err"].splitlines() if line.startswith('{"files"')]
    res["stats"] = json.loads(summary[-1]) if summary else None
    return res


def provenance(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def overlap(records: list, wall_s: float) -> float:
    """Sum of the tasks' successful attempt durations over the workflow
    wall: 1 is no overlap, the task count the most there could be."""
    return sum(r["duration_s"] for r in records if r["ok"]) / wall_s


def workflow_legs(seed: int, fa150: Path, sha: dict, work: Path, total: dict) -> list:
    """Phase 9, the per-read workflow: ``workflow_k8_8shards`` (at 2 and
    at 1 parallel tasks, merged and held to one run over the joined
    shards) and ``workflow_retry_resume``."""
    import numpy as np

    from cfrk_tpu_torch.ops.cuda import rowsort as R
    from cfrk_tpu_torch.tools import merge_outputs

    kernels = {"rowsort_rle": R.rowsort_rle}
    shards, reads = [fa150], [synthetic_reads(seed, READS, 150)]
    t0 = time.perf_counter()
    for i in range(1, ENTRY_SHARDS):
        reads.append(synthetic_reads(seed + i, READS, 150))
        shards.append(work / f"s{i}.fa")
        write_fasta(shards[-1], reads[-1])
    made_s = time.perf_counter() - t0
    cfg = work / "entry.json"
    prov2, prov1 = work / "prov2.jsonl", work / "prov1.jsonl"
    cfg.write_text(json.dumps({"max-parallel-tasks": 2, "retries": 1,
                               "provenance": str(prov2)}))
    label = "workflow_k8_8shards"
    argv = [*map(str, shards), "8", "--nonzero", "--stats"]
    runs = {}
    for tasks, prov in ((2, prov2), (1, prov1)):
        out_dir = work / f"wf{tasks}"
        extra = [] if tasks == 2 else ["--max-parallel-tasks", "1", "--provenance", str(prov)]
        run = cli_child(f"{label}_p{tasks}", [*argv, "--out-dir", str(out_dir), "--config",
                                              str(cfg), *extra])
        stats, records = run["stats"], provenance(prov)
        if (stats["files"], stats["failed"], stats["reads"]) != (ENTRY_SHARDS, 0,
                                                                ENTRY_SHARDS * READS):
            fail(f"{label} at {tasks} tasks: stats line {stats}")
        if len(records) != ENTRY_SHARDS or not all(r["ok"] and r["attempt"] == 0
                                                  for r in records):
            fail(f"{label} at {tasks} tasks: provenance {records}")
        if run["launches"].get("rowsort_rle", 0) <= 0:
            fail(f"{label} at {tasks} tasks: rowsort_rle was not launched")
        total["rowsort_rle"] += run["launches"].get("rowsort_rle", 0)
        parts = [out_dir / (p.stem + ".cfrk") for p in shards]
        run["sha"] = [sha256_of(p) for p in parts]
        run["parts"] = parts
        run["overlap"] = overlap(records, stats["wall_s"])
        run["task_s"] = [r["duration_s"] for r in records]  # in order of completion
        runs[tasks] = run
    if runs[2]["sha"][0] != sha["k8_nonzero"]:
        fail(f"{label}: shard 0's bytes differ from the k8_nonzero leg's")
    if runs[1]["sha"] != runs[2]["sha"]:
        fail(f"{label}: the shards' bytes differ between 1 and 2 parallel tasks")
    for p in runs[1]["parts"]:
        p.unlink()
    merged = work / "merged.cfrk"
    t0 = time.perf_counter()
    if merge_outputs.main(["--mode", "perread", "-o", str(merged),
                           *map(str, runs[2]["parts"])]) != 0:
        fail(f"{label}: merge_outputs exit")
    merge_s = time.perf_counter() - t0
    # The reference: one run over the joined shards, in this process (a
    # child's start would add its seconds to the smoke for no check).
    joined = work / "joined.fa"
    with open(joined, "wb") as f:
        for p in shards:
            f.write(p.read_bytes())
    single = run_cli_here("workflow_k8_joined", [str(joined), str(work / "joined.cfrk"),
                                                 "8", "--nonzero"], kernels)
    total["rowsort_rle"] += single["launches"]["rowsort_rle"]
    joined.unlink()
    merged_sha = sha256_of(merged)
    if merged_sha != sha256_of(work / "joined.cfrk"):
        fail(f"{label}: the merged shards differ from one run over the joined shards")
    (work / "joined.cfrk").unlink()
    rows = merged.read_bytes().split(b"\n")
    merged.unlink()
    every = np.concatenate(reads)
    if len(rows) != len(every):
        fail(f"{label}: {len(rows)} merged rows for {len(every)} reads")
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    sample = sorted({0, READS - 1, READS, len(every) - 1,
                     *np.random.default_rng(seed).integers(0, len(every), 16).tolist()})
    for i in sample:
        seq = lut[np.where(every[i] < 0, 4, every[i])].tobytes().decode()
        if row_cells(rows[i]) != string_counts(seq, 8, False):
            fail(f"{label}: merged row {i} disagrees with the string ground truth")
    del rows, every
    bases = ENTRY_SHARDS * READS * 150
    leg = {
        "leg": label, "shards": ENTRY_SHARDS, "reads": ENTRY_SHARDS * READS,
        "bases": bases, "fasta_made_s": made_s,
        **{f"p{t}_{key}": value for t, run in runs.items() for key, value in (
            ("wall_s", run["stats"]["wall_s"]), ("process_wall_s", run["process_wall_s"]),
            ("bases_per_s", bases / run["stats"]["wall_s"]), ("overlap", run["overlap"]),
            ("launches", run["launches"]), ("native_calls", run["native_calls"]),
            ("peak_rss_mb", run["peak_rss_mb"]), ("task_s", run["task_s"]))},
        "merge_s": merge_s, "joined_wall_s": single["wall_s"],
        "rows_checked": len(sample), "sha256_merged": merged_sha,
    }
    log(f"entry leg {label}: " + json.dumps(leg))
    legs = [leg]

    label = "workflow_retry_resume"
    prov = work / "prov_retry.jsonl"
    pair = [shards[0], shards[1]]
    run = cli_child(label, [*map(str, pair), "8", "--nonzero", "--stream", "--retries", "1",
                            "--out-dir", str(work / "retry"), "--provenance", str(prov),
                            "--stats"], {"CFRK_FAULT_INJECT": "checkpoint:5"})
    records = provenance(prov)
    failed = [r for r in records if not r["ok"]]
    if len(failed) != 1 or failed[0]["attempt"] != 0 or "InjectedFault" not in failed[0]["error"]:
        fail(f"{label}: provenance {records}")
    retried = failed[0]["input"]
    attempts = {str(p): [(r["attempt"], r["ok"]) for r in records if r["input"] == str(p)]
                for p in pair}
    if sorted(attempts[retried]) != [(0, False), (1, True)] or sorted(
            a for p, a in attempts.items() if p != retried) != [[(0, True)]]:
        fail(f"{label}: attempts {attempts}")
    stats = run["stats"]
    # The task that ran once counted its READS; the retried one resumed
    # from its checkpoint and counted fewer.
    if not (stats["failed"] == 0 and READS < stats["reads"] < 2 * READS):
        fail(f"{label}: stats line {stats}: the retry did not resume")
    for i, p in enumerate(pair):
        out = work / "retry" / (p.stem + ".cfrk")
        if sha256_of(out) != runs[2]["sha"][i]:
            fail(f"{label}: {out.name} differs from the uninterrupted run's")
        if Path(str(out) + ".ckpt.json").exists():
            fail(f"{label}: a checkpoint outlived the run")
        out.unlink()
    total["rowsort_rle"] += run["launches"].get("rowsort_rle", 0)
    leg = {"leg": label, "retried": Path(retried).name,
           "retried_reads": stats["reads"] - READS, "shard_reads": READS,
           "wall_s": stats["wall_s"], "process_wall_s": run["process_wall_s"],
           "launches": run["launches"], "attempts": attempts}
    log(f"entry leg {label}: " + json.dumps(leg))
    legs.append(leg)
    for p in runs[2]["parts"]:
        p.unlink()
    # Shards 1 and 2 and their single-process bytes serve phase 11.
    for i, p in enumerate(shards[:3]):
        sha[f"workflow_shard{i}"] = runs[2]["sha"][i]
        if i:
            p.rename(WORK / p.name)
    for p in shards[3:]:
        p.unlink()
    return legs


def split_fasta(path: Path, n: int, work: Path) -> list:
    """``write_fasta``'s file cut into ``n`` shards of whole records."""
    data = path.read_bytes()
    per = data.count(b"\n>") // n + 1
    cuts = [0] + [data.index(b"\n>r%d\n" % (per * i)) + 1 for i in range(1, n)] + [len(data)]
    out = []
    for i in range(n):
        out.append(work / f"q{i}.fa")
        out[-1].write_bytes(data[cuts[i]:cuts[i + 1]])
    return out


def entry_layer_legs(seed: int, fa150: Path, fa1m: Path, sha: dict) -> tuple:
    """Phase 9: the CLI's entry layer, each leg the real CLI in a child
    process on the card: multi-file workflow runs (with a config file,
    retries and provenance) merged by ``tools/merge_outputs``, a crashed
    shard resumed on retry, the spectrum shards, stdin three ways,
    ``--profile`` and ``--list-devices``.  Returns (legs, launches by
    kernel over every child)."""
    import shutil

    from cfrk_tpu_torch.tools import merge_outputs

    work = WORK / "entry"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    total = {"rowsort_rle": 0, "spectrum_hist": 0}
    legs = workflow_legs(seed, fa150, sha, work, total)

    label = "workflow_spectrum_k8_4shards"
    parts = split_fasta(fa1m, SPECTRUM_SHARDS, work)
    run = cli_child(label, [*map(str, parts), "-k", "8", "--mode", "spectrum", "--out-dir",
                            str(work / "spec"), "--stats"])
    if run["launches"].get("spectrum_hist", 0) <= 0:
        fail(f"{label}: spectrum_hist was not launched")
    total["spectrum_hist"] += run["launches"].get("spectrum_hist", 0)
    merged = work / "merged.spectrum"
    if merge_outputs.main(["--mode", "spectrum", "-o", str(merged),
                           *(str(work / "spec" / (p.stem + ".spectrum")) for p in parts)]) != 0:
        fail(f"{label}: merge_outputs exit")
    if sha256_of(merged) != sha["spectrum_k8"]:
        fail(f"{label}: the merged spectrum differs from the spectrum_k8 leg's")
    bases = SPECTRUM_READS * 150
    leg = {"leg": label, "shards": SPECTRUM_SHARDS, "bases": bases,
           "wall_s": run["stats"]["wall_s"], "process_wall_s": run["process_wall_s"],
           "bases_per_s": bases / run["stats"]["wall_s"], "launches": run["launches"],
           "native_calls": run["native_calls"], "peak_rss_mb": run["peak_rss_mb"]}
    log(f"entry leg {label}: " + json.dumps(leg))
    legs.append(leg)
    for p in parts:
        p.unlink()

    label = "stdin_k8_nonzero"
    leg = {"leg": label, "bases": READS * 150}
    for way, feeder, extra in (("plain", ["cat", str(fa150)], []),
                               # level 1: the pipe, not the compressor, is timed
                               ("gzip", ["gzip", "-1", "-c", str(fa150)], []),
                               ("stream", ["cat", str(fa150)], ["--stream"])):
        out = work / f"stdin_{way}.cfrk"
        pipe = subprocess.Popen(feeder, stdout=subprocess.PIPE)
        try:
            run = cli_child(f"{label}_{way}", ["-", "-k", "8", "--nonzero", "-o", str(out),
                                               "--stats", *extra], stdin=pipe.stdout)
        finally:
            pipe.stdout.close()
            pipe.wait()
        if pipe.returncode != 0:
            fail(f"{label}: {feeder[0]} exited {pipe.returncode}")
        if sha256_of(out) != sha["k8_nonzero"]:
            fail(f"{label} ({way}): bytes differ from the k8_nonzero leg's")
        if run["launches"].get("rowsort_rle", 0) <= 0:
            fail(f"{label} ({way}): rowsort_rle was not launched")
        total["rowsort_rle"] += run["launches"].get("rowsort_rle", 0)
        out.unlink()
        leg[way] = {"wall_s": run["stats"]["wall_s"], "process_wall_s": run["process_wall_s"],
                    "bases_per_s": READS * 150 / run["stats"]["wall_s"],
                    "launches": run["launches"], "native_calls": run["native_calls"]}
    log(f"entry leg {label}: " + json.dumps(leg))
    legs.append(leg)

    label = "profile_k8"
    trace_dir, out = work / "trace", work / "profiled.cfrk"
    run = cli_child(label, [str(fa150), str(out), "8", "--nonzero", "--profile",
                            str(trace_dir)])
    if sha256_of(out) != sha["k8_nonzero"]:
        fail(f"{label}: bytes differ from the k8_nonzero leg's")
    total["rowsort_rle"] += run["launches"].get("rowsort_rle", 0)
    traces = sorted(trace_dir.glob("*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"{label}: {len(traces)} trace files in {trace_dir}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            k = kernels.setdefault(e["name"][:80], [0, 0.0])
            k[0] += 1
            k[1] += float(e.get("dur", 0))
    rowsort_us = sum(us for name, (n, us) in kernels.items() if "rowsort_rle" in name)
    leg = {"leg": label, "trace_mb": traces[0].stat().st_size / 2**20,
           "events": len(events), "launches": run["launches"],
           "kernel_events": {name: {"n": n, "device_us": us} for name, (n, us) in kernels.items()},
           "process_wall_s": run["process_wall_s"]}
    log(f"entry leg {label}: " + json.dumps(leg))
    if rowsort_us <= 0:
        fail(f"{label}: the trace holds no rowsort_rle kernel with device time")
    legs.append(leg)
    shutil.rmtree(trace_dir)
    out.unlink()

    label = "list_devices"
    run = cli_child(label, ["--list-devices"])
    lines = [json.loads(line) for line in run["out"].strip().splitlines()[:-1]]
    import torch

    if (len(lines) != torch.cuda.device_count() or "H100" not in lines[0]["kind"]
            or lines[0]["platform"] != "gpu" or not lines[0]["bytes_limit"] > 0):
        fail(f"{label}: {lines}")
    legs.append({"leg": label, "lines": lines, "process_wall_s": run["process_wall_s"]})
    log(f"entry leg {label}: " + json.dumps(legs[-1]))
    shutil.rmtree(work)
    return legs, total


# Phase 10: make_synthetic's and scale_demo's reads, cut from 200k (and
# from 100k once the tools' mesh legs were added) so that a slow host's
# run stays under 540 s.
TOOL_READS = 50_000


def _tool_main(label: str, fn, argv: list) -> list:
    """A tool's ``main(argv)`` in this process: it must return 0; returns
    what it printed, line by line (its last line is its JSON record)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    lines = out.getvalue().strip().splitlines()
    if rc != 0:
        fail(f"{label}: exit {rc}: {lines[-3:]}")
    log(f"tool {label}: {time.perf_counter() - t0:.3f} s")
    return lines


def tool_legs(seed: int, spectrum_k8: dict) -> tuple:
    """Phase 10: the port's user and validation tools on the card, every
    kernel count set to 0 before a tool and read after it.  Returns (the
    tools' records, the launches of the one tool that drives the main
    path, ``fuzz_cli``: the others compare kernels with their twins)."""
    import shutil

    import torch

    from cfrk_tpu_torch.cli import main as cli_main
    from cfrk_tpu_torch.io.bgzf import is_bgzf
    from cfrk_tpu_torch.parallel.mesh import repeat_devices
    from cfrk_tpu_torch.tools import (
        card,
        fuzz_cli,
        make_synthetic,
        onchip_fuzz,
        onchip_validate,
        query_spectrum,
        reconstruct_fasta,
        scale_demo,
    )

    def zero():
        for fn in card.KERNELS.values():
            fn.launches = 0

    gpu = torch.device("cuda", 0)
    records = {}
    zero()
    artifact = WORK / "GPU_VALID.json"
    _tool_main("onchip_validate", onchip_validate.main, ["--out", str(artifact)])
    valid = json.loads(artifact.read_text())
    if not valid["ok"] or set(valid["checks"]) != set(onchip_validate.CHECKS):
        fail(f"onchip_validate: {valid['checks']}")
    for name, n in card.launches().items():
        if n <= 0:
            fail(f"onchip_validate never launched {name}")
    probes = valid["checks"]["mesh_kernel_probes"]
    if probes.get("probes") != ["packed_mesh", "rowsort_mesh", "rowsort_mesh_span",
                                "seqpar_sorted"]:
        fail(f"onchip_validate mesh_kernel_probes: {probes}")
    records["onchip_validate"] = {
        "launches": card.launches(), "wall_s": valid["wall_s"],
        "checks_wall_s": {name: c["wall_s"] for name, c in valid["checks"].items()}}
    # The mesh check alone, for the launches its one-device meshes make.
    zero()
    onchip_validate.mesh_kernel_probes(gpu)
    torch.cuda.synchronize()
    mesh_probe = {name: n for name, n in card.launches().items() if n}
    if mesh_probe.get("perread_hist", 0) <= 0 or mesh_probe.get("rowsort_rle", 0) <= 0:
        fail(f"mesh_kernel_probes never launched perread_hist and rowsort_rle: {mesh_probe}")
    records["onchip_validate"]["mesh_kernel_probes_launches"] = mesh_probe

    zero()
    fuzz = json.loads(_tool_main("onchip_fuzz", onchip_fuzz.main,
                                 ["--trials", "40", "--seed", str(seed)])[-1])
    if not fuzz["ok"] or fuzz["routes"]["tiled"] < 1:
        fail(f"onchip_fuzz: {fuzz}")
    records["onchip_fuzz"] = fuzz

    # fuzz_cli --devices 8: the card repeated 8 times, so that the seed
    # also draws mesh and seqpar trials.
    zero()
    prev = repeat_devices(8)
    try:
        campaign = fuzz_cli.run_campaign(24, seed, "cuda", use_mesh=True)
    finally:
        repeat_devices(prev)
    for name in ("rowsort_rle", "rowsort_rle_large", "spectrum_hist"):
        if campaign["launches"][name] <= 0:
            fail(f"fuzz_cli never launched {name}: {campaign}")
    log(f"fuzz_cli --devices 8: {sum(campaign['mesh_trials'].values())} mesh trials "
        f"{campaign['mesh_trials']}, {campaign['seqpar_trials']} seqpar trials of 24")
    if not campaign["mesh_trials"] or campaign["seqpar_trials"] < 1:
        fail(f"fuzz_cli --devices 8 drew no mesh or no seqpar trial: {campaign}")
    records["fuzz_cli"] = campaign
    # Every kernel a trial launched, perread_hist too (the seqpar
    # trials' dense per-read route).
    main_path = {name: n for name, n in campaign["launches"].items() if n}

    # The golden round trip: phase 4's k=2 .cfrk of seq2 rebuilt into a
    # FASTA, counted again on the card.
    zero()
    data = ROOT / "tests" / "data"
    golden = json.loads((data / "goldens.json").read_text())["files"]["seq2.fasta.gz"]
    rebuilt, recount = WORK / "seq2_rebuilt.fa", WORK / "seq2_rebuilt.cfrk"
    _tool_main("reconstruct_fasta", reconstruct_fasta.main,
               [str(WORK / "golden_seq2.fasta.gz.cfrk"), str(rebuilt)])
    if cli_main([str(rebuilt), str(recount), "2"]) != 0 or sha256_of(recount) != golden["sha256"]:
        fail("round trip: the rebuilt seq2 does not count to the golden sha256")
    records["round_trip"] = {"sha256": golden["sha256"], "reads": golden["n_reads"]}
    rebuilt.unlink()
    recount.unlink()

    # make_synthetic writes the input scale_demo then finds in its work
    # directory; query_spectrum reads phase 6's spectrum_k8 row.
    work = WORK / "scale"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    fasta = work / f"reads_{TOOL_READS}.fasta.bgz"
    t0 = time.perf_counter()
    _tool_main("make_synthetic", make_synthetic.main,
               [str(fasta), "--reads", str(TOOL_READS), "--genome-len", "2500000", "--bgzf"])
    records["make_synthetic"] = {"reads": TOOL_READS, "bytes": fasta.stat().st_size,
                                 "wall_s": time.perf_counter() - t0}
    if not is_bgzf(fasta):
        fail("make_synthetic --bgzf did not write BGZF")
    stats = dict(line.split("\t", 1) for line in _tool_main(
        "query_spectrum", query_spectrum.main, [str(spectrum_k8["output"]), "--stats"]))
    if int(stats["total"]) != spectrum_k8["valid_windows"]:
        fail(f"query_spectrum: total {stats['total']} != {spectrum_k8['valid_windows']} "
             "valid windows of spectrum_k8")
    records["query_spectrum"] = stats
    spectrum_k8["output"].unlink()

    zero()
    doc_path = work / "GPU_SCALE.json"
    _tool_main("scale_demo", scale_demo.main, [
        "--reads", str(TOOL_READS), "--skip", "sparse", "--scale-check-reads", "0",
        "--workdir", str(work), "--json-out", str(doc_path)])
    doc = json.loads(doc_path.read_text())
    if doc["synth_s"] is not None:
        fail("scale_demo synthesised its input again instead of make_synthetic's")
    for leg in ("perread_k8_nonzero", "spectrum_k8"):
        rec = doc["legs"].get(leg)
        if (not rec or len(rec["sha256"]) != 64 or not rec["stats"]
                or rec["stats"]["reads"] != TOOL_READS or not rec["bases_per_s"] > 0):
            fail(f"scale_demo leg {leg}: {rec}")
    records["scale_demo"] = doc
    shutil.rmtree(work)
    for name, rec in records.items():
        log(f"tool record {name}: " + json.dumps(rec, default=str))
    return records, main_path


# ---------------------------------------------------------------- byte ranges

RANKS = 2  # processes of a --distributed run, sharing the one card


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def triplet_env(rank: int, port: int) -> dict:
    """The JAX package's coordinator variables for rank ``rank``."""
    return {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": str(RANKS), "JAX_PROCESS_ID": str(rank)}


def slurm_env(rank: int, port: int) -> dict:
    """A SLURM job step's variables for task ``rank``, as though each
    task had a node of its own with one card (``SLURM_LOCALID=0``), and
    ``JAX_COORDINATOR_PORT`` in place of the port the job id gives."""
    return {"SLURM_JOB_ID": "4242", "SLURM_STEP_NODELIST": "localhost",
            "SLURM_NTASKS": str(RANKS), "SLURM_PROCID": str(rank), "SLURM_LOCALID": "0",
            "JAX_COORDINATOR_PORT": str(port)}


# Every variable a launcher sets: a child gets only those of its env_of_rank.
_LAUNCH_VARS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID", "JAX_COORDINATOR_PORT")
_LAUNCH_PREFIXES = ("SLURM_", "OMPI_")


def run_ranks(label: str, argv: list, fault_of_rank=lambda rank: None,
              env_of_rank=triplet_env) -> list:
    """One ``--distributed`` CLI run: ``RANKS`` children of ``_CLI_CHILD``
    started together with the launcher's variables of ``env_of_rank(i,
    port)`` (default: the JAX package's coordinator variables on
    127.0.0.1), each on ``--device cuda`` (the one card), rank i armed
    with ``CFRK_FAULT_INJECT=fault_of_rank(i)`` where that is not None.
    Returns each rank's exit code, stderr, launches and the seconds from
    the launch to its exit.  Made again once, on another port, only when
    a rank says that the address was in use."""
    base = {name: value for name, value in os.environ.items()
            if name not in _LAUNCH_VARS and not name.startswith(_LAUNCH_PREFIXES)}
    for attempt in (0, 1):
        port = free_port()
        procs, files = [], []
        t0 = time.perf_counter()
        for rank in range(RANKS):
            out, err = (WORK / f"{label}.rank{rank}.{n}" for n in ("out", "err"))
            files.append((out, err))
            env = {**base, **env_of_rank(rank, port)}
            if fault_of_rank(rank):
                env["CFRK_FAULT_INJECT"] = fault_of_rank(rank)
            with open(out, "wb") as o, open(err, "wb") as e:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _CLI_CHILD, *argv, "--distributed"],
                    cwd=ROOT, stdout=o, stderr=e, env=env))
        walls = [None] * RANKS
        while any(w is None for w in walls):
            for rank, proc in enumerate(procs):
                if walls[rank] is None and proc.poll() is not None:
                    walls[rank] = time.perf_counter() - t0
            if time.perf_counter() - t0 > 600:
                for proc in procs:
                    proc.kill()
                    proc.wait()
                fail(f"{label}: a rank ran past 600 s")
            time.sleep(0.02)
        ranks = []
        for proc, wall, (out, err) in zip(procs, walls, files):
            text, report = err.read_text(), out.read_text().strip().splitlines()
            out.unlink()
            err.unlink()
            ranks.append({"rc": proc.returncode, "err": text, "process_wall_s": wall,
                          "launches": ({n: c for n, c in json.loads(report[-1])["launches"].items()
                                        if c} if proc.returncode == 0 and report else {})})
        if attempt == 0 and any("address already in use" in r["err"].lower() for r in ranks):
            continue
        return ranks


def byte_ranged_legs(fa150: Path, fa152: Path, fa1m: Path, sha: dict) -> tuple:
    """Phase 11: ``--distributed`` with one input on 2 ranks sharing the
    card, each leg's output held to the sha256 of its single-process leg:
    per-read k=8 ``--nonzero`` over a BGZF copy of the 100k x 150 bp file
    (rank 1 killed at its second checkpoint, rank 0 then failing at the
    barrier with no output written, both resumed with ``--resume``),
    the dense spectrum at k=8 over the plain 1M-read file and the sparse
    k=31 canonical spectrum over the plain 100k x 152 bp file.  Each rank
    of each finished run must launch the leg's kernel; no part file may
    remain.  Returns (legs, launches by kernel over every finished rank)."""
    from cfrk_tpu_torch.io.bgzf import is_bgzf, write_bgzf

    bgzf150 = WORK / "r150.fa.gz"
    write_bgzf(bgzf150, fa150.read_bytes())
    if not is_bgzf(bgzf150):
        fail("write_bgzf wrote a file that is_bgzf does not take")
    total = {"rowsort_rle": 0, "spectrum_hist": 0, "rowsort_rle_large": 0}
    legs = []

    def finished(label, ranks, kernel, out, want_sha, bases, extra=None):
        for rank, r in enumerate(ranks):
            if r["rc"] != 0:
                fail(f"{label}: rank {rank} exited {r['rc']}: {r['err'][-600:]}")
            if r["launches"].get(kernel, 0) <= 0:
                fail(f"{label}: rank {rank} never launched {kernel}: {r['launches']}")
            for name, n in r["launches"].items():
                total[name] = total.get(name, 0) + n
        if sha256_of(out) != want_sha:
            fail(f"{label}: the merged output differs from the single-process leg's")
        left = sorted(p.name for p in WORK.iterdir() if ".part" in p.name)
        if left:
            fail(f"{label}: parts left behind: {left}")
        out.unlink()
        stats = [json.loads(line) for r in ranks for line in r["err"].splitlines()
                 if line.startswith("{") and '"stages_s"' in line]
        wall = max(r["process_wall_s"] for r in ranks)
        leg = {"leg": label, "ranks": RANKS, "bases": bases, "process_wall_s": wall,
               "bases_per_s": bases / wall,
               "rank_process_wall_s": [r["process_wall_s"] for r in ranks],
               "rank_launches": [r["launches"] for r in ranks],
               "rank_reads": [m["reads"] for m in stats],
               "rank_wall_s": [m["wall_s"] for m in stats], **(extra or {})}
        log(f"byte-ranged leg {label}: " + json.dumps(leg))
        legs.append(leg)

    label = "distributed_k8_nonzero_bgzf"
    out = WORK / f"{label}.cfrk"
    out.unlink(missing_ok=True)
    argv = [str(bgzf150), str(out), "8", "--nonzero", "--stats"]
    killed = run_ranks(label + "_killed", argv,
                       lambda rank: "checkpoint:2" if rank == 1 else None)
    if killed[1]["rc"] == 0 or "InjectedFault" not in killed[1]["err"]:
        fail(f"{label}: rank 1 armed at checkpoint:2 exited {killed[1]['rc']}: "
             f"{killed[1]['err'][-600:]}")
    if killed[0]["rc"] == 0 or out.exists():
        fail(f"{label}: rank 0 went on without rank 1 (exit {killed[0]['rc']})")
    ckpt = WORK / f"{label}.cfrk.part1.ckpt.json"
    if not ckpt.exists():
        fail(f"{label}: the killed rank 1 left no checkpoint")
    at_kill = json.loads(ckpt.read_text())["reads_done"]
    resumed = run_ranks(label, [*argv, "--resume"])
    finished(label, resumed, "rowsort_rle", out, sha["k8_nonzero"], READS * 150,
             {"killed_rank_rcs": [r["rc"] for r in killed],
              "killed_process_wall_s": [r["process_wall_s"] for r in killed],
              "rank1_reads_done_at_kill": at_kill})
    bgzf150.unlink()

    label = "distributed_spectrum_k8"
    out = WORK / f"{label}.spectrum"
    finished(label, run_ranks(label, [str(fa1m), "-o", str(out), "-k", "8", "--mode",
                                      "spectrum", "--stats"]),
             "spectrum_hist", out, sha["spectrum_k8"], SPECTRUM_READS * 150)

    label = "distributed_sparse_k31_canonical"
    out = WORK / f"{label}.kmers.tsv"
    finished(label, run_ranks(label, [str(fa152), "-o", str(out), "-k", "31",
                                      "--canonical", "--mode", "sparse", "--stats"]),
             "rowsort_rle_large", out, sha["sparse_k31_canonical"], READS * 152)

    # The same per-read run started from SLURM's variables alone: the
    # group's address, size and ranks come from the detected job.
    label = "distributed_slurm_k8_nonzero"
    out = WORK / f"{label}.cfrk"
    finished(label, run_ranks(label, [str(fa150), str(out), "8", "--nonzero", "--stats"],
                              env_of_rank=slurm_env),
             "rowsort_rle", out, sha["k8_nonzero"], READS * 150,
             {"launcher": "slurm"})

    # Several inputs: dealt round-robin, rank 0 runs two as a workflow,
    # rank 1 one; no barrier.  Each output is its shard's phase 9 bytes.
    label = "distributed_3_inputs_k8_nonzero"
    shards = [fa150, WORK / "s1.fa", WORK / "s2.fa"]
    out_dir = WORK / label
    ranks = run_ranks(label, [*map(str, shards), "8", "--nonzero", "--out-dir",
                              str(out_dir), "--stats"])
    for rank, r in enumerate(ranks):
        if r["rc"] != 0:
            fail(f"{label}: rank {rank} exited {r['rc']}: {r['err'][-600:]}")
        if r["launches"].get("rowsort_rle", 0) <= 0:
            fail(f"{label}: rank {rank} never launched rowsort_rle: {r['launches']}")
        for name, n in r["launches"].items():
            total[name] = total.get(name, 0) + n
    summaries = [json.loads([line for line in r["err"].splitlines()
                             if line.startswith('{"files"')][-1]) for r in ranks]
    if [(m["files"], m["reads"]) for m in summaries] != [(2, 2 * READS), (1, READS)]:
        fail(f"{label}: the ranks' summary lines {summaries}")
    for i, shard in enumerate(shards):
        part = out_dir / (shard.stem + ".cfrk")
        if sha256_of(part) != sha[f"workflow_shard{i}"]:
            fail(f"{label}: {part.name} differs from its single-process bytes")
        part.unlink()
    out_dir.rmdir()
    for shard in shards[1:]:
        shard.unlink()
    leg = {"leg": label, "ranks": RANKS, "inputs": len(shards),
           "rank_files": [m["files"] for m in summaries],
           "rank_process_wall_s": [r["process_wall_s"] for r in ranks],
           "rank_wall_s": [m["wall_s"] for m in summaries],
           "rank_launches": [r["launches"] for r in ranks],
           "bases_per_s": 3 * READS * 150 / max(r["process_wall_s"] for r in ranks)}
    log(f"byte-ranged leg {label}: " + json.dumps(leg))
    legs.append(leg)
    return legs, total


# ---------------------------------------------------------------- mesh

MESH_CONTIGS = 64  # the seqpar leg: 64 contigs of 64 kb
MESH_CONTIG_LEN = 64_000


def mesh_legs(seed: int, r150, fa150: Path, fa152: Path, fa1m: Path, sha: dict,
              card: str, gpu=None) -> tuple:
    """Phase 12, the mesh on one card: the library drivers over meshes of
    ``cuda:0`` repeated (the CLI's ``--devices 2`` on one card exits, as
    the JAX CLI does), each leg held to its one-device leg's bytes or
    arrays and to the launches its devices make: rows over 4 devices
    (``count_file_sparse_rows``), the packed emit over 2, the dense
    spectrum over a (2, 2) mesh (psum and the tp scatter), the k=31
    canonical sparse spectrum through the bucket exchange (and a
    low-complexity batch that overflows at slack 0.5), 64 contigs of
    64 kb over an sp mesh of 4 (dense per-read k=5, the sorted spectrum
    at k=12), and the streamed per-read rows over 2 devices killed at
    a checkpoint and resumed.  Returns (legs, launches by kernel)."""
    import numpy as np
    import torch

    from cfrk_tpu_torch.cli import _write_sparse, _write_spectrum
    from cfrk_tpu_torch.ops.cuda import perread as P
    from cfrk_tpu_torch.ops.cuda import rowsort as R
    from cfrk_tpu_torch.ops.cuda import spectrum as S
    from cfrk_tpu_torch.parallel import make_mesh, make_seq_mesh
    from cfrk_tpu_torch.parallel.bucket import sparse_spectrum_sharded_retry
    from cfrk_tpu_torch.pipeline import count as C
    from cfrk_tpu_torch.pipeline import stream as ST
    from cfrk_tpu_torch.runtime import faults

    gpu = torch.device("cuda", 0) if gpu is None else gpu
    kernels = {"rowsort_rle": R.rowsort_rle, "rowsort_rle_large": R.rowsort_rle_large,
               "spectrum_hist": S.spectrum_hist, "perread_hist": P.perread_hist}
    total = dict.fromkeys(kernels, 0)
    legs = []

    def batches(n: int) -> int:
        return -(-n // BATCH)

    def leg(label, mesh, run, check, want_launches, **extra):
        """``run()`` on the mesh with every count at 0 just before it and
        read just after; ``check(result)`` holds its output to the one
        device's; each kernel of ``want_launches`` must have launched
        exactly that often."""
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items() if fn.launches}
        if launches != want_launches:
            fail(f"{label}: launches {launches}, expected {want_launches}")
        check(result)
        for name, n in launches.items():
            total[name] += n
        rec = {"leg": label, "mesh": mesh.shape, "wall_s": wall, "launches": launches,
               "card": card, **extra}
        log(f"mesh leg {label}: " + json.dumps(rec))
        legs.append(rec)

    def same_sha(path: Path, want: str, label: str):
        def check(_):
            if sha256_of(path) != want:
                fail(f"{label}: the mesh's bytes differ from the one-device leg's")
            path.unlink()
        return check

    label = "mesh_k8_nonzero_dp4"
    out = WORK / f"{label}.cfrk"
    mesh = make_mesh([gpu] * 4)
    leg(label, mesh, lambda: C.count_file_sparse_rows(fa150, out, 8, mesh=mesh),
        same_sha(out, sha["k8_nonzero"], label), {"rowsort_rle": 4 * batches(READS)})

    label = "mesh_dense_api_k8_packed_dp2"
    fa_half = WORK / "r150_half.fa"
    write_fasta(fa_half, r150[:DENSE_API_READS])
    out = WORK / f"{label}.cfrk"
    mesh = make_mesh([gpu] * 2)
    leg(label, mesh, lambda: C.count_file_dense_rows(fa_half, out, 8, impl="pallas",
                                                     nonzero=True, mesh=mesh),
        same_sha(out, sha["k8_dense_api_nonzero"], label),
        {"perread_hist": 2 * batches(DENSE_API_READS)})
    fa_half.unlink()

    label = "mesh_spectrum_k8_tp2"
    out = WORK / f"{label}.spectrum"
    mesh = make_mesh([gpu] * 4, tp=2)
    leg(label, mesh, lambda: _write_spectrum(str(out), C.spectrum_file(fa1m, 8, mesh=mesh),
                                             "cfrk", 1),
        same_sha(out, sha["spectrum_k8"], label),
        {"spectrum_hist": 4 * batches(SPECTRUM_READS)})

    label = "mesh_sparse_k31_canonical_dp4"
    out = WORK / f"{label}.kmers.tsv"
    mesh = make_mesh([gpu] * 4)

    def sparse_to(path, **kw):
        keys, counts = C.sparse_spectrum_arrays(kw.pop("fasta"), 31, canonical=True, **kw)
        _write_sparse(str(path), keys, counts, 31, "tsv", 1)

    # The bucket exchange is torch.sort, searchsorted and index_put_ on
    # each device, as the JAX package's is XLA ops: no kernel launches.
    leg(label, mesh, lambda: sparse_to(out, fasta=fa152, mesh=mesh, slack=2.0),
        same_sha(out, sha["sparse_k31_canonical"], label), {})
    label = "mesh_sparse_k31_low_complexity_dp4"
    rng = np.random.default_rng(seed + 12)
    low = rng.integers(0, 4, size=(BATCH, 152)).astype(np.int8)
    low[: BATCH // 2] = 0  # half the reads poly-A
    low[BATCH // 2 : 3 * BATCH // 4] = np.tile([1, 3], 76)  # a quarter CT repeats
    fa_low = WORK / "low_complexity.fa"
    write_fasta(fa_low, low)
    ref = WORK / f"{label}.one_device.tsv"
    sparse_to(ref, fasta=fa_low, device=gpu)
    out = WORK / f"{label}.kmers.tsv"
    slack_used = sparse_spectrum_sharded_retry(
        torch.from_numpy(low).to(gpu), 31, mesh, canonical=True, slack=0.5)[3]
    if not slack_used > 0.5:
        fail(f"{label}: slack 0.5 did not overflow (slack_used {slack_used})")
    leg(label, mesh, lambda: sparse_to(out, fasta=fa_low, mesh=mesh, slack=0.5),
        same_sha(out, sha256_of(ref), label), {}, slack=0.5, slack_used=slack_used)
    ref.unlink()
    fa_low.unlink()

    contigs = synthetic_reads(seed + 13, MESH_CONTIGS, MESH_CONTIG_LEN)
    fa_contigs = WORK / "contigs.fa"
    write_fasta(fa_contigs, contigs)
    seq = make_seq_mesh([gpu] * 4)
    label = "mesh_seqpar_contigs_sp4_perread_k5"
    ref = WORK / f"{label}.one_device.cfrk"
    C.count_file_dense_rows(fa_contigs, ref, 5, device=gpu)
    out = WORK / f"{label}.cfrk"
    leg(label, seq, lambda: C.count_file_dense_rows(fa_contigs, out, 5, mesh=seq,
                                                    seqpar=True),
        same_sha(out, sha256_of(ref), label), {"perread_hist": 4},
        bases=MESH_CONTIGS * MESH_CONTIG_LEN)
    ref.unlink()
    label = "mesh_seqpar_contigs_sp4_spectrum_k12_sort"
    want = C.spectrum_file(fa_contigs, 12, impl="sort", device=gpu)

    def same_table(table):
        if not np.array_equal(table, want) or not want.sum():
            fail(f"{label}: the mesh's table differs from the one-device table")

    leg(label, seq, lambda: C.spectrum_file(fa_contigs, 12, impl="sort", mesh=seq,
                                            seqpar=True),
        same_table, {"rowsort_rle": 4}, bases=MESH_CONTIGS * MESH_CONTIG_LEN)
    fa_contigs.unlink()

    label = "mesh_k8_nonzero_stream_dp2"
    out = WORK / f"{label}.cfrk"
    mesh = make_mesh([gpu] * 2)
    faults.arm("checkpoint", 3)  # the site CFRK_FAULT_INJECT=checkpoint:3 arms
    try:
        ST.stream_count_file(fa150, out, 8, nonzero=True, mesh=mesh)
        fail(f"{label}: the run armed at checkpoint:3 finished")
    except faults.InjectedFault:
        pass
    finally:
        faults.disarm()
    if not Path(str(out) + ".ckpt.json").exists():
        fail(f"{label}: the killed run left no checkpoint")
    leg(label, mesh, lambda: ST.stream_count_file(fa150, out, 8, nonzero=True, mesh=mesh,
                                                  resume=True),
        same_sha(out, sha["k8_nonzero"], label),
        {"rowsort_rle": 2 * (batches(READS) - 3)})
    return legs, total


# ---------------------------------------------------------------- phase 13

LADDER_DEVICES = 4  # the scaling ladder's cuda:0 repeated: rungs 1, 2, 4


def scaling_and_defaults(r150, fa150: Path, fa256: Path, card: str, gpu=None,
                         cpu=None) -> tuple:
    """Phase 13, in this process: ``scaling_bench``'s ``main`` over
    ``cuda:0`` repeated 4 times in each mode at the tool's default sizes
    (``--steps 4``), every rung's checksum equal to the same ladder's
    through the CPU route; then the library's entry points with no
    device (``count_file``, ``spectrum_file``, ``count_perread`` on a
    numpy array), each launching its kernel on the card and equal to its
    ``device="cpu"`` result.  Every kernel count is set to 0 just before
    each run and read just after.  Returns (records, launches)."""
    import numpy as np
    import torch

    import cfrk_tpu_torch as lib
    from cfrk_tpu_torch.parallel.mesh import repeat_devices
    from cfrk_tpu_torch.tools import card as tcard
    from cfrk_tpu_torch.tools import scaling_bench

    gpu = torch.device("cuda", 0) if gpu is None else gpu
    cpu = torch.device("cpu") if cpu is None else cpu
    total = dict.fromkeys(tcard.KERNELS, 0)
    records = {}

    def counted(label, kernel, run):
        for fn in tcard.KERNELS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        result = run()
        wall = time.perf_counter() - t0
        launches = {name: n for name, n in tcard.launches().items() if n}
        if launches.get(kernel, 0) <= 0:
            fail(f"{label}: never launched {kernel}: {launches}")
        for name, n in launches.items():
            total[name] += n
        return result, launches, wall

    kernel_of = {"perread": "perread_hist", "rows": "rowsort_rle",
                 "spectrum": "spectrum_hist"}
    prev = repeat_devices(LADDER_DEVICES)
    try:
        for mode, kernel in kernel_of.items():
            lines, launches, wall = counted(
                f"scaling_bench {mode}", kernel,
                lambda: _tool_main(f"scaling_bench_{mode}", scaling_bench.main,
                                   ["--mode", mode, "--steps", "4"]))
            rungs = [json.loads(line) for line in lines if line.startswith("{")]
            if [r["devices"] for r in rungs] != [1, 2, 4]:
                fail(f"scaling_bench {mode}: rungs {rungs}")
            t0 = time.perf_counter()
            want = scaling_bench.sharded_checksums(
                [cpu] * LADDER_DEVICES, mode, 8,
                scaling_bench.default_reads_per_device(mode), 150)
            cpu_s = time.perf_counter() - t0
            got = [(r["devices"], r["checksum"]) for r in rungs]
            if got != want:
                fail(f"scaling_bench {mode}: checksums {got} != the CPU route's {want}")
            for rung in rungs:
                log("scaling rung: " + json.dumps({**rung, "card": card}))
            records[f"scaling_{mode}"] = {"rungs": rungs, "launches": launches,
                                          "wall_s": wall, "cpu_checksums_s": cpu_s}
            log(f"scaling_bench {mode}: " + json.dumps(
                {"launches": launches, "wall_s": wall, "cpu_checksums_s": cpu_s}))
    finally:
        repeat_devices(prev)

    # The library with no device: on the card, equal to device="cpu".
    codes = np.stack(r150[:512])
    cases = (
        ("count_file", "perread_hist", lambda: lib.count_file(fa256, 8),
         lambda: lib.count_file(fa256, 8, device=cpu)),
        ("spectrum_file", "spectrum_hist", lambda: lib.spectrum_file(fa150, 8),
         lambda: lib.spectrum_file(fa150, 8, device=cpu)),
        ("count_perread", "perread_hist", lambda: lib.count_perread(codes, 8),
         lambda: lib.count_perread(torch.from_numpy(codes), 8)),
    )
    for name, kernel, on_card, on_cpu in cases:
        got, launches, wall = counted(f"library default {name}", kernel, on_card)
        if isinstance(got, torch.Tensor):
            if got.device.type != gpu.type:
                fail(f"library default {name}: the result is on {got.device}")
            got = got.cpu().numpy()
        want = on_cpu()
        want = want.numpy() if isinstance(want, torch.Tensor) else want
        if got.shape != want.shape or not np.array_equal(got, want) or not want.any():
            fail(f"library default {name}: the card's result differs from device='cpu'")
        rec = {"launches": launches, "wall_s": wall, "shape": list(got.shape),
               "card": card}
        log(f"library default {name}: " + json.dumps(rec))
        records[f"default_{name}"] = rec
    return records, total


def time_spectrum_routes(seed: int, card: str) -> dict:
    """Phase 8, spectrum: ms per 8192-read batch (150 bp padded to 256)
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
    host) on the first batch of reads, and dense k=4 rows (the unpacked
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
    """Phase 8, per-read histograms: ms per 8192-read batch (150 bp
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
    """Phase 8, the rowsort probe tool: every variant at k = 8 (uint32
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


# Widths of every launch layout of the rowsort kernels (``width_cases``):
# a row of 16 keys, rows of 256 keys (8 or 16 a block), 4096 keys (16 keys
# a thread), 8192 keys (one block a row, the shared-memory network), a
# ragged last block of 8193 reads, one run of 4096, all N, and reads
# shorter than k.
CHECKSUM_WIDTHS = ("n16_B7", "n256_B7", "n4096_B7", "n8192_B7", "n256_B8193",
                   "polyA_n4096", "all_N", "shorter_than_k")


def check_checksums(seed: int, card: str) -> dict:
    """Phase 8, ``checksum=True`` of the two rowsort kernels: at the main
    batch and at ``CHECKSUM_WIDTHS``, ``chk`` array-equal to the plain
    twin's and the rows to the ``checksum=False`` call's; then the main
    batch as graph replays with the checksum and without it.  Returns
    {kernel: {"err", "ms", "checksum_ms"}}."""
    import numpy as np
    import torch

    from cfrk_tpu_torch.ops.cuda import rowsort as R
    from cfrk_tpu_torch.tools.rowsort_times import time_graph

    rng = np.random.default_rng(seed + 7)

    def batch(b, length, p=0.01):
        c = rng.integers(0, 4, size=(b, length)).astype(np.int8)
        c[rng.random(c.shape) < p] = -1
        return c

    out = {}
    for name, kern, plain, k, canonical, length in (
        ("rowsort_rle", R.rowsort_rle, R.rowsort_rle_plain, 8, False, 150),
        ("rowsort_rle_large", R.rowsort_rle_large, R.rowsort_rle_large_plain,
         31, True, 152),
    ):
        main_batch = np.full((BATCH, 256), -1, np.int8)
        main_batch[:, :length] = batch(BATCH, length)
        cases = {"main": main_batch, **{n: c for n, c in width_cases(batch, k).items()
                                        if n in CHECKSUM_WIDTHS}}
        err = 0
        for case, codes in cases.items():
            x = on_card(codes, case)
            *rows, chk = kern(x, k, canonical, checksum=True)
            err = max(err, compare_arrays(name, tuple(rows), kern(x, k, canonical),
                                          f"k={k} {case}: rows with checksum=True"))
            want = plain(x, k, canonical, checksum=True)[-1]
            err = max(err, compare_arrays(name, chk, want, f"k={k} {case}: chk"))
        x = torch.from_numpy(main_batch).cuda()
        bare = time_graph(lambda: kern(x, k, canonical))
        summed = time_graph(lambda: kern(x, k, canonical, checksum=True))
        out[name] = {"err": err, "ms": bare, "checksum_ms": summed}
        log(f"checksum {name} k={k} canonical={canonical}: chk and rows array-equal "
            f"on {sorted(cases)}; [{BATCH}, 256] {bare:.4f} ms without, "
            f"{summed:.4f} ms with checksum=True, graph replays ({card})")
    return out


def bench_legs(card: str) -> dict:
    """Phase 14: ``cfrk_tpu_torch.bench``, ``tools.bench_suite`` and
    ``tools.bench_format``, each a child process; fails on a record out
    of its bounds.  Returns the launches the first two report."""
    from collections import Counter

    launches = Counter()
    res = run_child("bench", [sys.executable, "-m", "cfrk_tpu_torch.bench"])
    if res["rc"]:
        fail(f"bench exited {res['rc']}: {res['err'][-3000:]}")
    line = json.loads(res["out"].strip().splitlines()[-1])
    keys = {"metric", "value", "unit", "vs_baseline", "beats_dense_write_sol", "k8", "k31"}
    if not keys <= set(line) or not line["value"] > 0:
        fail(f"bench line: {sorted(line)}, value {line.get('value')}")
    for case in ("k8", "k31"):
        if not 0 < line[case]["vs_sort_sol"] <= 1:
            fail(f"bench {case}: vs_sort_sol {line[case]['vs_sort_sol']}")
    launches.update(line["launches"])
    log("bench: " + json.dumps({"card": card, **line}))

    path = WORK / "GPU_BENCHSUITE.json"
    res = run_child("bench_suite", [
        sys.executable, "-m", "cfrk_tpu_torch.tools.bench_suite", "--steps", "512",
        "--ingest-reads", "200000", "--stream-reads", "100000", "--json-out", str(path)])
    if res["rc"]:
        fail(f"bench_suite exited {res['rc']}: {res['err'][-3000:]}")
    doc = json.loads(path.read_text())
    cases = {rec["bench"]: rec for rec in doc["cases"]}
    if not cases.get("golden_k2_exact", {}).get("byte_exact"):
        fail("bench_suite: golden_k2_exact is not byte-exact")
    device_cases = [rec for rec in doc["cases"] if "sol_model" in rec]
    if len(device_cases) != 11:
        fail(f"bench_suite: {len(device_cases)} device cases, not 11")
    for rec in device_cases:
        if not 0 < rec["vs_sol"] <= 1:
            fail(f"bench_suite {rec['bench']}: vs_sol {rec['vs_sol']}")
    launches.update(doc["launches"])
    log("bench_suite: " + json.dumps({"card": card, "cases": doc["cases"],
                                      "launches": doc["launches"]}))

    res = run_child("bench_format", [sys.executable, "-m",
                                     "cfrk_tpu_torch.tools.bench_format"])
    if res["rc"]:
        fail(f"bench_format exited {res['rc']}: {res['err'][-3000:]}")
    shapes = json.loads(res["out"].strip().splitlines()[-1])
    if set(shapes) != {"pairs_k8", "pairs64_k31", "dense_k2", "dense_pairs_k8"} or not all(
            r["mb_s"] > 0 for r in shapes.values()):
        fail(f"bench_format: {shapes}")
    log("bench_format: " + json.dumps({"card": card, "cpu": cpu_model(), **shapes}))
    return dict(launches)


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
    built = build_libraries(["rowsort", "spectrum", "perread", "fastaio"])
    R._library()
    S._library()
    P._library()
    from cfrk_tpu_torch.io import native as N
    from cfrk_tpu_torch.ops.cuda.build import host_compiler

    N._library()
    log(f"build: {', '.join(so.name for so in built.values())} in "
        f"{time.perf_counter() - t0:.3f} s")
    for so in built.values():
        log(so.with_suffix(".log").read_text().strip())
    version = subprocess.run([host_compiler(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
    host_log = built["fastaio"].with_suffix(".log").read_text().splitlines()
    log(f"host library: {host_compiler()} ({version[0] if version else '?'}), "
        f"{host_log[1]}")

    # 3. kernel vs plain, and the host library vs numpy
    clock = PhaseClock()
    errs = check_kernels(args.seed)
    clock.lap("3 kernel vs plain")
    import numpy as np

    r150 = synthetic_reads(args.seed, READS, 150)
    r152 = synthetic_reads(args.seed + 1, READS, 152)
    fa150, fa152, fa256 = (WORK / n for n in ("r150.fa", "r152.fa", "r256.fa"))
    write_fasta(fa150, r150)
    write_fasta(fa152, r152)
    write_fasta(fa256, r150[:256])
    check_host_library(r150, r152, fa150, card)
    clock.lap("3 host library vs numpy")

    # 4. goldens
    check_goldens()
    clock.lap("4 goldens")

    # 5. main path at real size
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
    fa1m = WORK / "r1m.fa"
    spec_legs = spectrum_legs(args.seed, r152, fa152, fa1m)
    launches["spectrum_hist"] = spec_legs[0]["launches"]["spectrum_hist"]

    clock.lap("6 spectrum legs")

    # 7. streamed legs: their launches join the main path's counts
    sha = {leg["leg"]: leg["sha256"] for leg in legs + spec_legs}
    stream_legs, stream_launches = streamed_legs(
        fa150, fa152, WORK / "r150_half.fa", fa1m, sha, args.seed)
    for name, n in stream_launches.items():
        if n <= 0:
            fail(f"the streamed legs never launched {name}")
        launches[name] += n
    log("streamed_launches: " + json.dumps(stream_launches))

    clock.lap("7 streamed legs")

    # 8. times: plain, kernel, kernel, plain at the main path's batch shape
    from cfrk_tpu_torch.ops.roofline import (
        perread_bound,
        probe_bound,
        rowsort_bound,
        spectrum_bound,
    )
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
        bounds[name] = rowsort_bound(BATCH, 256, k, canonical)
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
    # table out of [8192, 256] codes; the "b4" block; the probe's
    # [8192, 150] codes.
    bounds["spectrum_hist"] = spectrum_bound(BATCH, 256, 8)
    bounds["perread_hist"] = perread_bound(BATCH, 256, 8, "b4")
    bounds["rowsort_probe"] = probe_bound(BATCH, 150, 8)
    checksums = check_checksums(args.seed, card)
    for name, rec in checksums.items():
        errs[name] = max(errs[name], rec["err"])
    probe = run_probe(card)
    launches["rowsort_probe"] = probe["launches"]
    errs["rowsort_probe"] = max(errs["rowsort_probe"], probe["err"])
    times["rowsort_probe"] = (probe["ms"], probe["plain_ms"])
    log("rowsort_probe_step_ms: " + json.dumps({
        "card": card, **{name: r["step_ms"] for name, r in probe["records"].items()}}))
    clock.lap("8 times")

    # 9. entry layer: children of the CLI; their launches join the counts
    entry_legs, entry_launches = entry_layer_legs(args.seed, fa150, fa1m, sha)
    for name, n in entry_launches.items():
        if n <= 0:
            fail(f"the entry-layer legs never launched {name}")
        launches[name] += n
    log("entry_launches: " + json.dumps(entry_launches))
    clock.lap("9 entry layer")

    # 10. the user and validation tools; fuzz_cli's CLI runs join the counts
    tool_records, tool_launches = tool_legs(args.seed, spec_legs[0])
    for name, n in tool_launches.items():
        launches[name] += n
    log("tool_launches: " + json.dumps({
        "fuzz_cli": tool_launches,
        "onchip_validate": tool_records["onchip_validate"]["launches"],
        "onchip_fuzz": tool_records["onchip_fuzz"]["launches"]}))
    clock.lap("10 tools")

    # 11. --distributed with one input: 2 ranks on the card, byte-ranged
    dist_legs, dist_launches = byte_ranged_legs(fa150, fa152, fa1m, sha)
    for name, n in dist_launches.items():
        launches[name] += n
    log("byte_ranged_launches: " + json.dumps(dist_launches))
    clock.lap("11 byte-ranged runs")

    # 12. meshes of the one card repeated, through the library drivers
    mesh_recs, mesh_launches = mesh_legs(args.seed, r150, fa150, fa152, fa1m, sha, card)
    for name, n in mesh_launches.items():
        launches[name] += n
    log("mesh_launches: " + json.dumps(mesh_launches))
    clock.lap("12 mesh on one card")

    # 13. the scaling ladder on the card repeated, and the library defaults
    _, phase13_launches = scaling_and_defaults(r150, fa150, fa256, card)
    for name, n in phase13_launches.items():
        launches[name] += n
    log("scaling_and_defaults_launches: " + json.dumps(phase13_launches))
    clock.lap("13 scaling ladder and library defaults")

    # 14. the benchmarks, as children; their launches join the counts
    bench_launches = bench_legs(card)
    for name, n in bench_launches.items():
        launches[name] += n
    log("bench_launches: " + json.dumps(bench_launches))
    clock.lap("14 benchmarks")
    log("end_to_end: " + json.dumps({
        "card": card,
        "legs": {leg["leg"]: leg["bases_per_s"]
                 for leg in legs + spec_legs + stream_legs + entry_legs + dist_legs
                 if "bases_per_s" in leg},
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
