"""``spectrum_roofline``: the dense table kernel's share of its bound, in
percent, over the traced window.

The time is the device time of every kernel whose own name, after its
return type and namespaces, is ``spectrum_large`` (``csrc/spectrum.cu``:
the table above k = 10, held in HBM; the trace names it
``(anonymous namespace)::spectrum_large(signed char const*, ...)``).
The bound of a call of input ``j`` is ``table_roofline.table_bound`` of
the cell's shapes and of the distinct table sectors of input ``j``'s
keys (the plain reference's); the window's bound is the sum over its
calls, input by input, as the window cycles them from the first.  Read in cells whose entry is ``spectrum_table``; elsewhere, or
where the trace has no such kernel, nothing is read.
"""

import re

from benchmark import table_roofline

KERNEL = re.compile(r"(?:^|[\s:])spectrum_large(?:$|[(<])")


def _is_kernel(name: str) -> bool:
    return KERNEL.search(name) is not None


def read(run):
    if run.trace is None or run.cell.traffic["entry"] != "spectrum_table":
        return None
    kernel_s = run.trace.device_seconds(_is_kernel)
    if kernel_s <= 0:
        return None
    wl = run.workload
    n, calls = len(wl.inputs), run.window.calls
    bound_ms = 0.0
    for j in range(n):
        calls_j = len(range(j, calls, n))
        if calls_j:
            keys, _ = wl.spectrum_of(j)
            ms, _ = table_roofline.table_bound(wl.reads, wl.read_len,
                                               table_roofline.sectors(keys))
            bound_ms += calls_j * ms
    return 100.0 * bound_ms / 1e3 / kernel_s
