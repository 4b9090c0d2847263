"""``perread_roofline``: the dense per-read histogram kernel's share of its
bound, in percent, over the traced window.

The time is the device time of every kernel whose own name, after its
return type and namespaces, is ``perread_hist_kernel``
(``csrc/perread.cu``; the trace names it ``void (anonymous
namespace)::perread_hist_kernel<1>(signed char const*, ...)``).  The
bound of one call is ``dense_roofline.dense_bound`` of the cell's shapes
(the codes read once, the ``[reads, 4**k]`` int32 matrix written once);
the window's is its calls times that.  Read in cells whose entry is
``perread_dense``; elsewhere, or where the trace has no such kernel,
nothing is read.
"""

import re

from benchmark import dense_roofline

KERNEL = re.compile(r"(?:^|[\s:])perread_hist_kernel(?:$|[(<])")


def _is_kernel(name: str) -> bool:
    return KERNEL.search(name) is not None


def read(run):
    if run.trace is None or run.cell.traffic["entry"] != "perread_dense":
        return None
    kernel_s = run.trace.device_seconds(_is_kernel)
    if kernel_s <= 0:
        return None
    wl = run.workload
    bound_ms, _ = dense_roofline.dense_bound(wl.reads, wl.read_len, wl.k)
    return 100.0 * run.window.calls * bound_ms / 1e3 / kernel_s
