"""``perread_self_us_per_call``: the host's microseconds a call spends in
the program's dense per-read dispatcher and kernel wrapper, outside the
launch itself: the self time of each top-level ``cfrk.perread`` span the
program recorded in the traced window (its duration less the part its
child spans, the wrapper's ``cfrk.perread_hist.launch``, cover),
averaged over the window's calls.  It is read by the code of
``spectrum_self_us_per_call``, loaded as a copy of its own with the span's
name ``cfrk.perread`` in place of ``cfrk.spectrum``: a program without the
registry ``cfrk_tpu_torch.runtime.metrics``, one whose counter
``cfrk.perread.calls`` counted no call, or a window with no such span,
gives nothing."""

from benchmark import spec

_reader = spec.load_module("metrics", "spectrum_self_us_per_call")  # a copy of its own
_reader.NAME = "cfrk.perread"
read = _reader.read
