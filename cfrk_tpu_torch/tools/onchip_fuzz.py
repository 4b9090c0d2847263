"""Random-shape parity fuzz of the row-sort kernels on the card.

The port's counterpart of ``tools/onchip_fuzz.py``: it draws random
``(k, read length, batch, canonical, N rate)`` configurations with that
tool's draw sequence, so one seed gives the same trials, and holds the
kernel against its plain PyTorch twin on the same device, every output
array equal.  Lengths reach 66 kb.  A row within the kernel's window
ceiling (``rowsort_max_windows(k)``) goes to ``rowsort_rle`` (k <= 15)
or ``rowsort_rle_large`` (k >= 16) whole; a longer row goes through
``count_perread_rows``, the tiled route (the kernel per tile, the
tiles' pairs merged on the host), held to the twin on the whole row.

    python -m cfrk_tpu_torch.tools.onchip_fuzz --trials 20 [--seed 0] [--device cuda|cpu]

It stops at the first mismatch with the failing config; the last line
is one JSON object naming the device and the trials of each route.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops.cuda.rowsort import (
    MAX_SPARSE_PERREAD_K,
    rowsort_max_windows,
    rowsort_rle,
    rowsort_rle_large,
    rowsort_rle_large_plain,
    rowsort_rle_plain,
)
from ..ops.perread_sparse import count_perread_rows
from . import card


def draw_trial(rng: np.random.Generator) -> tuple[dict, np.ndarray]:
    """One configuration and its int8 code batch, drawn in the JAX
    tool's order (``tools/onchip_fuzz.py``)."""
    # Bias lengths toward the layout boundaries: short rows, one warp's
    # keys, a block's keys, the shared-memory network, and contigs past
    # the kernel ceiling.
    length = int(rng.choice([
        rng.integers(33, 72), rng.integers(72, 200),
        rng.integers(200, 600), rng.integers(600, 2500),
        rng.integers(2500, 16500), rng.integers(16500, 66000),
    ], p=[0.22, 0.26, 0.18, 0.18, 0.08, 0.08]))
    big = bool(rng.integers(0, 3) == 0)
    if big:
        k = int(rng.integers(16, 32))
        length = max(length, k + 3)
    else:
        k = int(rng.integers(1, 16))
    b = int(rng.choice([5, 37, 64, 256, 511]))
    if length > 2500:
        b = int(rng.choice([3, 9, 16]))  # contig batches are small
    canonical = bool(rng.integers(0, 2))
    p_n = float(rng.choice([0.0, 0.02, 0.3]))
    codes = rng.integers(0, 4, size=(b, length)).astype(np.int8)
    if p_n:
        codes[rng.random(codes.shape) < p_n] = -1
    return dict(k=k, length=length, b=b, canonical=canonical, p_n=p_n), codes


def route(cfg: dict) -> str:
    """``kernel`` for a row within the kernel's ceiling, else ``tiled``."""
    w = cfg["length"] - cfg["k"] + 1
    return "kernel" if w <= rowsort_max_windows(cfg["k"]) else "tiled"


def rows(x: torch.Tensor, cfg: dict):
    """The trial's rows through its route (CPU tensors from the tiled
    route, ``x``'s device from the kernel)."""
    k, canonical = cfg["k"], cfg["canonical"]
    if route(cfg) == "tiled":
        return count_perread_rows(x, k, canonical)
    if k <= MAX_SPARSE_PERREAD_K:
        return rowsort_rle(x, k, canonical)
    return rowsort_rle_large(x, k, canonical)


def plain_rows(x: torch.Tensor, cfg: dict):
    """The plain twin on the whole row, on ``x``'s device."""
    plain = rowsort_rle_plain if cfg["k"] <= MAX_SPARSE_PERREAD_K else rowsort_rle_large_plain
    return plain(x, cfg["k"], cfg["canonical"])


def check_trial(cfg: dict, codes: np.ndarray, device: torch.device) -> None:
    """Every output array of the route equal to the twin's; raises
    AssertionError naming the config."""
    x = torch.from_numpy(codes).to(device)
    got, want = rows(x, cfg), plain_rows(x, cfg)
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} outputs, {len(want)} expected: {json.dumps(cfg)}")
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"output {i} differs ({route(cfg)} route): {json.dumps(cfg)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    card.add_device_argument(ap)
    args = ap.parse_args(argv)
    device = card.resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    routes = {"kernel": 0, "tiled": 0}
    before = card.launches()
    t0 = time.perf_counter()
    for t in range(args.trials):
        cfg, codes = draw_trial(rng)
        check_trial(cfg, codes, device)
        routes[route(cfg)] += 1
        print(f"# {t + 1}/{args.trials} ok {route(cfg)} {json.dumps(cfg)}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    rec = card.device_record(device)
    print(json.dumps({
        "platform": rec["platform"], "device_kind": rec["device_kind"], "card": rec["card"],
        "trials": args.trials, "seed": args.seed, "routes": routes,
        "launches": card.launches_since(before), "wall_s": wall,
        "trials_per_s": args.trials / wall if wall > 0 else None, "ok": True,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
