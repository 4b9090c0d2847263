"""``rows_self_us_per_call``: the host's microseconds a call spends in the
program's dispatcher and kernel wrapper, outside the launch itself: the
self time of each top-level ``cfrk.rows`` span the program recorded in
the traced window (its duration less the part its child spans, the
wrapper's ``cfrk.<kernel>.launch``, cover), averaged over the window's
calls.  The program keeps its spans only while a profiler records, so
the window's calls are the last top-level ``cfrk.rows`` records it
holds.  A program without the registry
``cfrk_tpu_torch.runtime.metrics.spans``, or a window with no such span,
gives nothing."""

import importlib


def _spans():
    try:
        registry = importlib.import_module("cfrk_tpu_torch.runtime.metrics")
    except ImportError:
        return None
    spans = getattr(registry, "spans", None)
    return spans() if spans is not None else None


def _covered(start: int, end: int, intervals) -> int:
    covered, t = 0, start
    for s, e in sorted(intervals):
        s, e = max(s, t), min(e, end)
        if e > s:
            covered += e - s
            t = e
    return covered


def read(run):
    spans = _spans()
    if not spans or run.window.calls <= 0:
        return None
    rows = [r for r in spans if r.name == "cfrk.rows" and r.parent == 0][-run.window.calls:]
    if not rows:
        return None
    children = {r.id: [] for r in rows}
    for r in spans:
        if r.parent in children:
            children[r.parent].append((r.start_ns, r.end_ns))
    self_ns = sum(r.end_ns - r.start_ns - _covered(r.start_ns, r.end_ns, children[r.id])
                  for r in rows)
    return self_ns / len(rows) / 1e3
