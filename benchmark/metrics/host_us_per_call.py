"""``host_us_per_call``: the host's microseconds to enqueue one call
(the dispatcher, the kernel wrappers' checks, allocations and launch),
the median over blocks of calls enqueued back to back with the queue
empty, before the profiler starts.  It would set the pace if it grew
past a call's device time."""

import statistics


def read(run):
    if not run.host_call_us:
        return None
    return statistics.median(run.host_call_us)
