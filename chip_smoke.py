#!/usr/bin/env python3
"""Chip smoke test of cfrk_tpu_torch, the PyTorch + CUDA port.

Run from the root of a checkout on a machine with one NVIDIA GPU
(Hopper, sm_90a):

    python3 chip_smoke.py [--seed 0]

Phases, each of which exits non-zero on failure:

1. card: the GPU's name and power limit, torch and CUDA versions;
2. build: compiles the CUDA kernels from csrc/ (nvcc, at first use);
3. kernel vs plain: each kernel against its plain PyTorch twin on the
   card's inputs, array-equal, across k, canonical keys, read shapes
   (150 bp, short, 4 kb, past the kernel ceiling) and edge rows;
4. goldens: ``python -m cfrk_tpu_torch <seqN.fasta.gz> <out> 2`` must
   reproduce tests/data/goldens.json;
5. main path at real size: seeded synthetic reads (100k x 150 bp and
   100k x 152 bp, the synthetic-read configuration of BASELINE.json)
   through the CLI on the GPU — k=8 ``--nonzero``, k=31 ``--canonical
   --nonzero``, dense k=8 rows of the first 256 reads.  Each must launch
   its kernel, write the same bytes as ``--device cpu`` and agree on
   sampled rows with string-slicing ground truth;
6. times: each kernel's ms per 8192-read batch beside the plain route's
   on the card (CUDA events, after warm-up), and the end-to-end bases/s
   of phase 5.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the JSON record of the kernels, and the one before that the card's
``nvidia-smi`` name and power limit.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
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
_COMP = str.maketrans("ACGT", "TGCA")
_DIGITS = str.maketrans("ACGT", "0123")


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
            for canonical in (False, True):
                runs = [(c, kern, n) for n, c in cases.items()]
                past_ceiling = past[name].shape[1] - k + 1 > R.rowsort_max_windows(k)
                if past_ceiling:
                    runs.append((past[name], count_perread_rows, "past_ceiling"))
                for codes, fn, case in runs:
                    got = fn(torch.from_numpy(codes).cuda(), k, canonical)
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
            f"{sorted(cases) + ['past_ceiling']}: array-equal")
    return errs


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
                  k: int, canonical: bool) -> dict:
    """Phase 5, one leg: the CLI on the GPU (counting its kernel's
    launches), the same CLI on the CPU route, byte comparison and a
    sampled ground-truth check.  Returns the leg's numbers."""
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
        "bytes": len(gpu_bytes), "rows_checked": len(sample),
    }
    log(f"main path {label}: " + json.dumps(res))
    return res


def time_kernel(fn, codes, k: int, canonical: bool, iters: int = 20) -> float:
    """ms per call on the card: CUDA events around ``iters`` calls after
    a warm-up."""
    import torch

    for _ in range(3):
        fn(codes, k, canonical)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn(codes, k, canonical)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


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
        from cfrk_tpu_torch.ops.cuda import rowsort as R
        from cfrk_tpu_torch.ops.cuda.build import build_library
    except ImportError as e:
        print(f"chip_smoke: cfrk_tpu_torch not found beside this script "
              f"({e}); run it from the root of a checkout", file=sys.stderr)
        return 1
    if "jax" in sys.modules:
        fail("jax was imported")
    WORK.mkdir(parents=True, exist_ok=True)

    # 1. card
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    so = build_library("rowsort")
    R._library()
    log(f"build: {so.name} in {time.perf_counter() - t0:.3f} s")
    log(so.with_suffix(".log").read_text().strip())

    # 3. kernel vs plain
    errs = check_kernels(args.seed)

    # 4. goldens
    check_goldens()

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

    # 6. times: plain, kernel, kernel, plain at the main path's batch shape
    times = {}
    for name, kern, plain, k, canonical, length in (
        ("rowsort_rle", R.rowsort_rle, R.rowsort_rle_plain, 8, False, 150),
        ("rowsort_rle_large", R.rowsort_rle_large, R.rowsort_rle_large_plain,
         31, True, 152),
    ):
        codes = np.full((BATCH, 256), -1, np.int8)
        codes[:, :length] = synthetic_reads(args.seed + 2, BATCH, length)
        codes = torch.from_numpy(codes).cuda()
        p1 = time_kernel(plain, codes, k, canonical)
        k1 = time_kernel(kern, codes, k, canonical)
        k2 = time_kernel(kern, codes, k, canonical)
        p2 = time_kernel(plain, codes, k, canonical)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"time {name} k={k} canonical={canonical} [{BATCH}, 256]: kernel "
            f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms per batch "
            f"({card})")
    log("end_to_end: " + json.dumps({
        "card": card,
        "legs": {leg["leg"]: leg["bases_per_s"] for leg in legs},
    }))

    kernels = []
    for name, line in (("rowsort_rle", 569), ("rowsort_rle_large", 655)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "cfrk_tpu_torch/csrc/rowsort.cu",
            "replaces": f"cfrk_tpu/ops/pallas/rowsort.py:{line}",
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
        })
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
