"""``device_idle_share``: the share of the traced window (first enqueue
to the final synchronise) in which no kernel, copy or memset ran on the
card: 1 - (union of the device's activity) / (window)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 1.0 - t.busy_s / t.window_s
