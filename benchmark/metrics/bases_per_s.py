"""``bases_per_s``: the input bases of every call the window made (all
complete at its final synchronise), over the whole window on the host
clock, from the first enqueue to the return of that synchronise."""


def read(run):
    w = run.window
    return w.calls * run.workload.bases_per_call / w.seconds
