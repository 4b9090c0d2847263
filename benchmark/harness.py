"""One run of one cell: set-up, the timed window, the check, the metrics.

The window is one closed-loop caller: it enqueues the entry's call on
the next input as soon as the last call is enqueued, drops each call's
outputs once the next call is enqueued (bar the sampled ones the check
keeps), records one CUDA event between every two calls, and
synchronises once, at its end.  A call's device time runs from the
event before it to the event after it.

With ``trace`` the run first times the host's enqueue of the calls in
blocks with the queue empty (``host_call_us``), then runs the window
for at most ``TRACE_SECONDS`` under ``torch.profiler`` and reads the
device's activity from its trace; the metrics reported are then the
per-layer ones.
"""

from __future__ import annotations

import contextlib
import gc
import os
import random
import sys
import tempfile
import time
from dataclasses import dataclass

import torch

from benchmark import spec
from benchmark.trace import WINDOW, Trace

TRACE_SECONDS = 2.0
HOST_BLOCKS, HOST_BLOCK_CALLS = 32, 32


class CudaClock:
    """Device timestamps: CUDA events on the current stream."""

    def __init__(self, device: torch.device):
        self.device = device

    def mark(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    @staticmethod
    def between(a, b) -> float:
        return a.elapsed_time(b)

    def sync(self) -> None:
        torch.cuda.synchronize(self.device)


class HostClock:
    """The host clock, for a run on the CPU (tests only: the CPU route
    runs each call before it returns)."""

    @staticmethod
    def mark() -> float:
        return time.perf_counter()

    @staticmethod
    def between(a, b) -> float:
        return (b - a) * 1e3

    def sync(self) -> None:
        pass


def clock_for(device: torch.device):
    return CudaClock(device) if device.type == "cuda" else HostClock()


@dataclass
class Window:
    calls: int
    seconds: float
    call_ms: list
    kept: dict  # call index -> outputs


@dataclass
class Run:
    """What the metrics read (``metrics/<name>.py``'s ``read(run)``)."""

    cell: spec.Cell
    workload: object
    setup_s: float
    window: Window
    trace: Trace | None = None
    host_call_us: list | None = None


def closed_loop(workload, seconds: float, clock, keep: set,
                span=contextlib.nullcontext) -> Window:
    """The timed window; ``span`` wraps the calls and the final
    synchronise (the traced run's annotation)."""
    call, inputs = workload.call, workload.inputs
    n = len(inputs)
    kept = {}
    i = 0
    # The window's own bookkeeping (an event a call) would otherwise
    # grow the collector's full passes into host stalls that empty the
    # launch queue; as in timeit, the collector is off while it runs.
    gc.collect()
    gc.disable()
    try:
        with span():
            marks = [clock.mark()]
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while True:
                out = call(inputs[i % n])
                marks.append(clock.mark())
                if i in keep:
                    kept[i] = out
                i += 1
                if time.perf_counter() >= deadline:
                    break
            kept[i - 1] = out
            del out
            clock.sync()
            t1 = time.perf_counter()
    finally:
        gc.enable()
    call_ms = [clock.between(a, b) for a, b in zip(marks, marks[1:])]
    return Window(calls=i, seconds=t1 - t0, call_ms=call_ms, kept=kept)


def host_blocks(workload, clock) -> list:
    """Host microseconds a call, from blocks of calls enqueued back to
    back after a synchronise, so that no call waits for room in the
    launch queue: what the host spends, not the device's pace."""
    call, inputs = workload.call, workload.inputs
    per_call = []
    for b in range(HOST_BLOCKS):
        clock.sync()
        t = time.perf_counter()
        for j in range(HOST_BLOCK_CALLS):
            out = call(inputs[(b * HOST_BLOCK_CALLS + j) % len(inputs)])
        per_call.append((time.perf_counter() - t) / HOST_BLOCK_CALLS * 1e6)
        del out
    clock.sync()
    return per_call


def warm_up(workload, clock, hold: int) -> float:
    """Runs every input, then ``hold`` calls whose outputs live at once,
    so that the window finds every kernel loaded and as many output
    blocks cached as it keeps alive; returns device ms a call."""
    inputs = workload.inputs
    n = len(inputs)
    outs = [workload.call(x) for x in inputs]
    clock.sync()
    outs += [workload.call(inputs[i % n]) for i in range(hold)]
    clock.sync()
    del outs
    a = clock.mark()
    for i in range(2 * n):
        out = workload.call(inputs[i % n])
    b = clock.mark()
    clock.sync()
    del out
    return max(clock.between(a, b) / (2 * n), 1e-6)


def sample(seed: int, expected_calls: int, count: int) -> set:
    """Call indices the check keeps, drawn from the seed among the calls
    the window is sure to make (the last call is kept besides)."""
    rng = random.Random(seed)
    pool = max(1, int(0.8 * expected_calls))
    return set(rng.sample(range(pool), min(count, pool)))


def check(workload, window: Window) -> dict:
    """Every kept call's outputs against the reference over the same
    input; a reference is worked out once an input."""
    refs, bad, failed, compared = {}, 0, 0, 0
    n = len(workload.inputs)
    for i in sorted(window.kept):
        j = i % n
        if j not in refs:
            refs[j] = workload.reference(workload.inputs[j])
        m = workload.mismatches(window.kept.pop(i), refs[j])
        bad += m
        failed += m > 0
        compared += 1
    return {"mismatched_cells": bad, "failed_calls": failed, "calls_compared": compared}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> dict:
    """Runs the cell once; returns the result's fields (see ``run.py``)."""
    on_gpu = device.type == "cuda"
    clock = clock_for(device)
    phases = [("start", t_start)]

    def phase(name):
        clock.sync()
        phases.append((name, time.perf_counter()))

    entry = spec.load_module("entries", cell.traffic["entry"])
    if on_gpu:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    phase("context")
    workload = entry.Workload(cell.config, cell.traffic, seed, device)
    phase("inputs")
    n_samples = cell.traffic["check_samples"]
    call_ms = warm_up(workload, clock, hold=n_samples + 3)
    phase("warm_up")
    host_call_us = host_blocks(workload, clock) if trace else None
    length = min(seconds, TRACE_SECONDS) if trace else seconds
    keep = sample(seed, int(length * 1e3 / call_ms), n_samples)
    setup_s = time.perf_counter() - t_start
    print("setup s: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(phases, phases[1:])),
          file=sys.stderr)
    trace_obj = None
    if trace:
        window, trace_obj = traced_window(workload, length, clock, keep, device)
    else:
        window = closed_loop(workload, length, clock, keep)
    peak = torch.cuda.max_memory_allocated(device) if on_gpu else 0
    run = Run(cell=cell, workload=workload, setup_s=setup_s, window=window,
              trace=trace_obj, host_call_us=host_call_us)
    verdict = check(workload, window)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if on_gpu else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_gpu else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    out = {
        "correct": verdict["mismatched_cells"] == 0 and verdict["calls_compared"] > 0,
        "attempted": window.calls,
        "failed": verdict["failed_calls"],
        "metrics": metrics,
        "device": dev,
    }
    if trace_obj is not None:
        dev["busy_s"] = trace_obj.busy_s
        dev["window_s"] = trace_obj.window_s
        out["breakdown"] = trace_obj.breakdown()
    out["checks"] = {
        "mismatched_cells": {"value": verdict["mismatched_cells"], "limit": 0, "rule": "<="},
        "calls_compared": {"value": verdict["calls_compared"], "limit": 1, "rule": ">="},
    }
    return out


def traced_window(workload, seconds: float, clock, keep: set, device: torch.device):
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=activities) as prof:
            clock.sync()
            window = closed_loop(workload, seconds, clock, keep,
                                 span=lambda: record_function(WINDOW))
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return window, Trace.from_chrome(path)
