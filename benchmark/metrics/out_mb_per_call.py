"""``out_mb_per_call``: the megabytes (1e6 bytes) of output the kernel
wrappers return a call: the program's counter ``cfrk.out_bytes`` (the
bytes of every tensor a wrapper returns) over ``cfrk.rows.calls`` (the
dispatcher's calls), both counted from the process's start.  Every call
of a cell has one shape, so the ratio is exact.  A program without the
registry ``cfrk_tpu_torch.runtime.metrics.counters``, or with no call
counted, gives nothing."""

import importlib


def read(run):
    try:
        registry = importlib.import_module("cfrk_tpu_torch.runtime.metrics")
    except ImportError:
        return None
    counters = getattr(registry, "counters", None)
    if counters is None:
        return None
    c = counters()
    calls, out = c.get("cfrk.rows.calls", 0), c.get("cfrk.out_bytes", 0)
    if calls <= 0 or out <= 0:
        return None
    return out / calls / 1e6
