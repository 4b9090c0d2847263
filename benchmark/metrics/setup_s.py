"""``setup_s``: seconds from the start of the run's process to the
first enqueue of the window: imports, the CUDA context, the program's
kernels loaded (built, in a checkout's first run), the inputs made on
the device and the warm-up."""


def read(run):
    return run.setup_s
