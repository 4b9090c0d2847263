"""Headline benchmark: per-read k-mer counting throughput on one card.

The port of the root ``bench.py``.  Two cases, as there:

* k = 8 at 150 bp (BASELINE config 2): the per-read rows of
  ``rowsort_rle``, the route of every driver's ``.cfrk`` output;
* k = 31 canonical at 152 bp (config 4's per-batch core):
  ``rowsort_rle_large``.

Each case runs ``N_BATCHES`` steps of ``auto_batch_size()`` reads
(8192, what the drivers dispatch), cycling ``DISTINCT`` seeded input
batches, through the kernel with ``checksum=True``; a step adds the sum
of its ``chk`` to a running total on the card, so the total depends on
every step's row writes and nothing is read back.  :func:`time_steps`
(shared with ``tools/bench_suite.py``) captures ``GRAPH_STEPS`` steps
in a CUDA graph and times its replays between CUDA events (an eager
loop of 20 us kernels would time the host's launches); best of 3 runs,
whose totals must be equal.

Prints ONE JSON line with the JAX bench's keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``beats_dense_write_sol``, ``k8``, ``k31``),
plus ``device`` (the card's name and power limit) and ``launches`` (the
kernels' launch counts: a captured graph counts each launch once).
Each case has ``step_ms``, ``bases_per_s`` and ``vs_sort_sol``, its
rate over the H100 bound of ``ops/roofline.sort_sol``; k = 8 also
``vs_dense_sol``, against one write of the dense ``b4`` per-read matrix
(``dense_emit_sol``), which the pairs route never writes, so it may
exceed 1; ``vs_baseline`` is that share capped at 1, and
``beats_dense_write_sol`` says whether the cap fired.  A ``vs_sort_sol``
above 1 is a measurement bug and fails the run.

    python -m cfrk_tpu_torch.bench          # on the card; exits without one
    python -m cfrk_tpu_torch.bench --cpu    # the plain route at a tiny size

``--cpu`` runs the plain twins in an eager loop of a few 64-read steps
for the tests; its record says ``cpu`` and leaves the shares of the
card's bounds null.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .ops.cuda.rowsort import rowsort_rle, rowsort_rle_large
from .ops.roofline import dense_emit_sol, sort_sol
from .pipeline.batch import auto_batch_size
from .tools import card

__all__ = ["K8", "LEN8", "K31", "LEN31", "N_BATCHES", "DISTINCT", "GRAPH_STEPS",
           "time_steps", "run_case", "main"]

K8, LEN8 = 8, 150
K31, LEN31 = 31, 152
# 512 steps: ~10 ms of kernels, long enough that a replay's own start
# does not show.
N_BATCHES = 512
DISTINCT = 4  # distinct input batches cycled through the steps
GRAPH_STEPS = 16  # steps in one captured graph, replayed to the step count
CPU_BATCH, CPU_STEPS = 64, 4


def _inputs(batch: int, k: int, read_len: int, device: torch.device) -> torch.Tensor:
    """The ``DISTINCT`` input batches of a case, seeded by k."""
    rng = np.random.default_rng(k)
    xs = rng.integers(0, 4, size=(DISTINCT, batch, read_len)).astype(np.int8)
    return torch.from_numpy(xs).to(device)


def time_steps(step, xs: torch.Tensor, steps: int, *, graph: bool = True,
               finish=None, reset=None) -> tuple:
    """(seconds, total, steps run) of ``steps`` calls of ``step`` on the
    cycled batches of ``xs``; each call returns a scalar tensor, added to
    a total on the batches' device, or None.  ``finish()`` adds a last
    scalar after the steps (a running table's), ``reset()`` clears what
    the steps keep before the timed run.  On the card the steps run as
    replays of a ``GRAPH_STEPS``-step CUDA graph (``graph=False``:
    eagerly) between CUDA events, the total fetched after the last; on
    the CPU eagerly, by the host's clock.  Two steps first build the
    libraries and warm every kernel."""
    on_card = xs.device.type == "cuda"
    total = torch.zeros((), dtype=torch.int64, device=xs.device)

    def run(n: int) -> None:
        for i in range(n):
            value = step(xs[i % len(xs)])
            if value is not None:  # the tiled route's rows come back on the host
                total.add_(value.to(total.device))

    def timed(body) -> float:
        total.zero_()
        if reset:
            reset()
        if not on_card:
            t0 = time.perf_counter()
            body()
            if finish:
                total.add_(finish())
            int(total)
            return time.perf_counter() - t0
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        body()
        if finish:
            total.add_(finish())
        e1.record()
        int(total)  # waits for the last step
        return e0.elapsed_time(e1) / 1e3

    run(min(2, steps))
    if on_card:
        torch.cuda.synchronize()
    if not (graph and on_card):
        return timed(lambda: run(steps)), int(total), steps
    per = min(GRAPH_STEPS, steps)
    replays = -(-steps // per)
    captured = torch.cuda.CUDAGraph()
    with torch.cuda.graph(captured):
        run(per)
    seconds = timed(lambda: [captured.replay() for _ in range(replays)])
    return seconds, int(total), replays * per


def run_case(k: int, read_len: int, device: torch.device) -> dict:
    """One case's record: ``step_ms``, ``bases_per_s``, ``checksum`` and,
    on the card, ``vs_sort_sol`` (and ``vs_dense_sol`` at k <= 8)."""
    on_card = device.type == "cuda"
    batch = auto_batch_size(read_len) if on_card else CPU_BATCH
    steps = N_BATCHES if on_card else CPU_STEPS
    xs = _inputs(batch, k, read_len, device)
    kernel = rowsort_rle if k <= 15 else rowsort_rle_large
    runs = [time_steps(lambda x: kernel(x, k, k > 15, checksum=True)[-1].sum(), xs, steps)
            for _ in range(3)]
    dt, totals = min(r[0] for r in runs), [r[1] for r in runs]
    # The total depends on every step; equal inputs must give equal
    # totals, or the measurement ran nothing real.
    assert len(set(totals)) == 1, f"k={k}: the checksums differ across repeats: {totals}"
    bps = steps * batch * read_len / dt
    rec = {"k": k, "read_len": read_len, "batch": batch, "steps": steps,
           "step_ms": dt / steps * 1e3, "bases_per_s": bps, "checksum": totals[0],
           "vs_sort_sol": None}
    if on_card:
        rec["vs_sort_sol"] = bps / sort_sol(batch, read_len, k, canonical=k > 15)
        assert rec["vs_sort_sol"] <= 1.0, (
            f"k={k}: measured {bps:.6e} bases/s exceeds its own bound "
            f"{sort_sol(batch, read_len, k, canonical=k > 15):.6e}: a measurement bug")
    if k <= 8:
        rec["vs_dense_sol"] = bps / dense_emit_sol(batch, read_len, k) if on_card else None
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="the plain route on the CPU at a tiny size (tests)")
    args = ap.parse_args(argv)
    device = card.resolve_device("cpu" if args.cpu else "cuda")
    before = card.launches()
    k8 = run_case(K8, LEN8, device)
    k31 = run_case(K31, LEN31, device)
    dense = k8["vs_dense_sol"]
    record = card.device_record(device)
    print(json.dumps({
        "metric": (f"perread count throughput, 1 card ({record['device_kind']}, cuda "
                   "rowsort pairs)" if device.type == "cuda" else
                   "perread count throughput, CPU (plain route)")
                  + ": k=8 dense-row route; k31 = canonical sparse",
        "value": k8["bases_per_s"],
        "unit": "bases/s",
        "vs_baseline": None if dense is None else min(1.0, dense),
        "beats_dense_write_sol": None if dense is None else dense > 1.0,
        "k8": k8,
        "k31": k31,
        "device": record,
        "launches": card.launches_since(before),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
