"""``spectrum_self_us_per_call``: the host's microseconds a call spends in
the program's dense spectrum dispatcher and kernel wrapper, outside the
launch itself: the self time of each top-level ``cfrk.spectrum`` span
the program recorded in the traced window (its duration less the part
its child spans, the wrapper's ``cfrk.<kernel>.launch``, cover),
averaged over the window's calls, read as ``rows_self_us_per_call``
reads ``cfrk.rows`` and with its helpers.  A program without the
registry ``cfrk_tpu_torch.runtime.metrics``, one whose counter
``cfrk.spectrum.calls`` counted no call, or a window with no such span,
gives nothing."""

import importlib

from benchmark import spec

NAME = "cfrk.spectrum"
_rows = spec.load_module("metrics", "rows_self_us_per_call")


def _calls() -> int:
    try:
        registry = importlib.import_module("cfrk_tpu_torch.runtime.metrics")
    except ImportError:
        return 0
    counters = getattr(registry, "counters", None)
    return counters().get(NAME + ".calls", 0) if counters is not None else 0


def read(run):
    if run.window.calls <= 0 or _calls() <= 0:
        return None
    spans = _rows._spans()
    if not spans:
        return None
    tops = [r for r in spans if r.name == NAME and r.parent == 0][-run.window.calls:]
    if not tops:
        return None
    children = {r.id: [] for r in tops}
    for r in spans:
        if r.parent in children:
            children[r.parent].append((r.start_ns, r.end_ns))
    self_ns = sum(r.end_ns - r.start_ns - _rows._covered(r.start_ns, r.end_ns, children[r.id])
                  for r in tops)
    return self_ns / len(tops) / 1e3
