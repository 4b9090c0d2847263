"""``program_setup_s``: the seconds of the program's own once-per-process
set-up: the sum of the once spans the program recorded (its import,
each kernel library's build and load, each kernel's first launch) that
lie in no other once span, so that a build inside its load counts once.
A share of ``setup_s``: the rest is Python, ``import torch``, the CUDA
context, the inputs and the warm-up.  A program without the registry
``cfrk_tpu_torch.runtime.metrics.spans``, or with no once span, gives
nothing."""

import importlib


def read(run):
    try:
        registry = importlib.import_module("cfrk_tpu_torch.runtime.metrics")
    except ImportError:
        return None
    spans = getattr(registry, "spans", None)
    if spans is None:
        return None
    records = spans()
    by_id = {r.id: r for r in records}

    def inside_once(r):
        up = by_id.get(r.parent)
        while up is not None:
            if up.once:
                return True
            up = by_id.get(up.parent)
        return False

    tops = [r for r in records if r.once and not inside_once(r)]
    if not tops:
        return None
    return sum(r.end_ns - r.start_ns for r in tops) / 1e9
