"""``rowsort_roofline``: the row-sort kernels' share of their bound, in
percent, over the traced window.

The bound of one call is ``roofline.rowsort_bound`` of the cell's shapes
(``[reads_per_call, read_len]`` codes at its k), by the frozen arithmetic
of ``benchmark/roofline.py``; the time is the device time of every
kernel named ``rowsort_rle*`` in the trace.  Read in cells whose entry
is ``perread_rows`` (one row-sort call a window call); elsewhere, or
where the trace has no such kernel, nothing is read.
"""

from benchmark import roofline


def read(run):
    if run.trace is None or run.cell.traffic["entry"] != "perread_rows":
        return None
    kernel_s = run.trace.device_seconds(lambda name: "rowsort_rle" in name)
    if kernel_s <= 0:
        return None
    wl = run.workload
    bound_ms, _ = roofline.rowsort_bound(wl.reads, wl.read_len, wl.k, wl.canonical)
    return 100.0 * run.window.calls * bound_ms / 1e3 / kernel_s
