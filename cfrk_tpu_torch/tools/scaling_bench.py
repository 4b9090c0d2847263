"""Scaling ladder of the sharded per-read, row and spectrum paths.

The port's counterpart of ``tools/scaling_bench.py``.  A weak-scaling
sweep: for each device count n of the doubling ladder 1, 2, 4, ... 32
(up to the devices of this process), a fixed per-device workload runs
over an n-device (dp) mesh, and each rung reports reads/s and two
efficiencies:

* ``efficiency_vs_1dev``: reads/s over n times the one-device rung's;
* ``efficiency_vs_unsharded``: the same total batch run on device 0 with
  no mesh, over the sharded time (the cost of the mesh itself).

The devices are ``parallel.mesh.local_devices`` of the card: every
distinct card, or the card repeated N times where the caller set
``parallel.mesh.repeat_devices(N)``.  ``--cpu`` runs the plain PyTorch
route on the CPU repeated 8 times, the counterpart of the JAX tool's
virtual 8-device host mesh.  Where the devices are not distinct cards,
the shards of a step run one after another on one device, so neither
efficiency is performance: the record says so (``spmd_validation_only``).

The inputs are the JAX tool's: ``default_rng(0)``, one ``[n x reads per
device, read_len]`` batch of random bases drawn for each rung in turn.
Each step ends in a dependent sync, the fetch of the scalar
``int((out & 3).sum())``, which is also the rung's checksum: the sharded
and the unsharded run must agree on it.

    python -m cfrk_tpu_torch.tools.scaling_bench [--k 8] [--reads-per-device N]
        [--read-len 150] [--mode perread|spectrum|rows] [--steps 8] [--cpu]
        [--json-out FILE]

Prints one JSON line per rung.  On the card, ``perread`` launches
``perread_hist`` (the CUDA route of ``auto`` at k = 8), ``rows``
``rowsort_rle`` and ``spectrum`` ``spectrum_hist``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time

import numpy as np
import torch

from ..ops.perread import count_perread
from ..ops.perread_sparse import count_perread_rows
from ..ops.spectrum import spectrum
from ..parallel import (
    count_perread_sharded,
    count_perread_sparse_sharded,
    make_mesh,
    shard_batch,
    spectrum_sharded,
)
from ..parallel.mesh import local_devices, repeat_devices
from . import card

LADDER = (1, 2, 4, 8, 16, 32)


def default_reads_per_device(mode: str) -> int:
    """32768 for rows and spectrum; 2048 for dense per-read rows, whose
    ``[reads, 4**8]`` int32 block is 8 GB a device at 32768 reads."""
    return 2048 if mode == "perread" else 32768


def ladder_inputs(n_devices: int, reads_per_device: int, read_len: int):
    """(n, codes) for each rung up to ``n_devices``: the JAX tool's
    batches, drawn from ``default_rng(0)`` rung by rung."""
    rng = np.random.default_rng(0)
    for n in (n for n in LADDER if n <= n_devices):
        codes = rng.integers(0, 4, size=(reads_per_device * n, read_len)).astype(np.int8)
        yield n, codes


def checksum(out: torch.Tensor) -> int:
    """The dependent sync: ``sum(out & 3)`` fetched to the host."""
    return int((out & 3).sum())


def sharded_step(batch: list, mesh, mode: str, k: int) -> int:
    """One step over the mesh on the batch's row blocks."""
    if mode == "perread":
        out = count_perread_sharded(batch, k, mesh)
    elif mode == "rows":
        out = count_perread_sparse_sharded(batch, k, mesh)[-1]
    else:
        out = spectrum_sharded(batch, k, mesh)
    return checksum(out)


def unsharded_step(codes: torch.Tensor, mode: str, k: int) -> int:
    """The same total work on one device with no mesh."""
    if mode == "perread":
        out = count_perread(codes, k)
    elif mode == "rows":
        out = count_perread_rows(codes, k)[-1]
    else:
        out = spectrum(codes, k)
    return checksum(out)


def sharded_checksums(devices: list, mode: str, k: int, reads_per_device: int,
                      read_len: int) -> list:
    """Each rung's (n, checksum) over meshes of ``devices[:n]``, one step
    each and untimed: the ladder's checksums on another route."""
    out = []
    for n, codes in ladder_inputs(len(devices), reads_per_device, read_len):
        mesh = make_mesh(devices[:n])
        out.append((n, sharded_step(shard_batch(torch.from_numpy(codes), mesh), mesh,
                                    mode, k)))
    return out


def _seconds_per_step(step, steps: int) -> tuple:
    """(seconds a step over ``steps`` steps after one warm-up step, the
    last step's checksum)."""
    step()
    t0 = time.perf_counter()
    for _ in range(steps):
        chk = step()
    return (time.perf_counter() - t0) / steps, chk


def run_ladder(devices: list, mode: str, k: int, reads_per_device: int, read_len: int,
               steps: int, log=None) -> list:
    """The timed ladder over ``devices``: one record a rung, each checked
    against the unsharded run on ``devices[0]``."""
    records, base = [], None
    for n, codes in ladder_inputs(len(devices), reads_per_device, read_len):
        mesh = make_mesh(devices[:n])
        batch = shard_batch(torch.from_numpy(codes), mesh)
        dt, chk = _seconds_per_step(lambda: sharded_step(batch, mesh, mode, k), steps)
        plain = torch.from_numpy(codes).to(devices[0])
        dt_u, chk_u = _seconds_per_step(lambda: unsharded_step(plain, mode, k), steps)
        if chk_u != chk:
            raise AssertionError(f"{n} devices: sharded checksum {chk} != unsharded {chk_u}")
        b = reads_per_device * n
        reads_per_s = b / dt
        base = reads_per_s if base is None else base
        rec = {
            "devices": n,
            "mode": mode,
            "k": k,
            "reads": b,
            "reads_per_s": reads_per_s,
            "efficiency_vs_1dev": reads_per_s / (base * n),
            "efficiency_vs_unsharded": dt_u / dt,
            "checksum": chk,
        }
        records.append(rec)
        if log is not None:
            log(json.dumps(rec))
    return records


def write_doc(path: str, devices: list, reads_per_device: int, records: list) -> int:
    """Merge this ladder into the ``{"runs": [...]}`` document at
    ``path`` (a run of the same mode is replaced); returns the number of
    runs it holds."""
    distinct_cards = devices[0].type == "cuda" and len(set(devices)) == len(devices)
    dev = card.device_record(devices[0])
    doc = {
        "platform": dev["platform"],
        "device_kind": dev["device_kind"],
        "card": dev["card"],
        "torch": dev["torch"],
        "cuda": dev["cuda"],
        "devices": [str(d) for d in devices],
        "host_cores": os.cpu_count(),
        "reads_per_device": reads_per_device,
        "timestamp": datetime.datetime.now(datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%SZ"),
        # One device standing for several runs the shards of a step one
        # after another: the ladder then checks the mesh paths at every
        # size, and its efficiencies are not performance.
        "spmd_validation_only": not distinct_cards,
        "ladder": records,
    }
    out = {"runs": []}
    if os.path.exists(path):
        try:
            with open(path) as f:
                out = json.load(f)
        except (OSError, ValueError):
            out = {"runs": []}
        if "runs" not in out:
            out = {"runs": []}
    mode = records[0]["mode"] if records else None
    out["runs"] = [r for r in out["runs"]
                   if r.get("ladder", [{}])[0].get("mode") != mode] + [doc]
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return len(out["runs"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument(
        "--reads-per-device", type=int, default=None,
        help="default: 32768 for rows and spectrum, 2048 for the dense "
             "perread mode (a 32768 x 4**8 int32 block is 8 GB a device)",
    )
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--mode", choices=["perread", "spectrum", "rows"], default="perread",
                    help="rows = sparse per-read pairs (the row-sort kernel on the card)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="the plain route on the CPU repeated 8 times")
    ap.add_argument("--json-out", default=None,
                    help="merge the ladder into FILE as one JSON document of runs "
                         "(one a mode)")
    args = ap.parse_args(argv)
    if args.cpu:
        repeat_devices(8)
        devices = local_devices(torch.device("cpu"))
    else:
        devices = local_devices(card.resolve_device("cuda"))
    rpd = args.reads_per_device or default_reads_per_device(args.mode)
    records = run_ladder(devices, args.mode, args.k, rpd, args.read_len, args.steps,
                         log=lambda line: print(line, flush=True))
    if args.json_out:
        n = write_doc(args.json_out, devices, rpd, records)
        print(f"# wrote {args.json_out} ({n} mode runs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
