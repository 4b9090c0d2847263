"""``call_ms_p95``: the 95th percentile, over every call of the window,
of a call's device time: from the CUDA event recorded before its first
launch to the one recorded after its last, read once the window has
closed.  A host stall inside a call, or a launch queue that ran dry,
shows here; a call's time when the queue is full is its kernels'."""

import numpy as np


def read(run):
    if not run.window.call_ms:
        return None
    return float(np.percentile(run.window.call_ms, 95))
