"""Per-stage timing and throughput metrics of one counting run, and the
program's spans and counters.

``RunMetrics`` is a copy of ``cfrk_tpu/runtime/metrics.py``'s: every
stage of a streaming driver records into a :class:`RunMetrics`, which
prints as one JSON line with the JAX package's keys.

Stages time the host.  Launches on a CUDA device return before the
device finishes, so a stage holds the time the host was held there: the
"materialize" stage of a streamed run is the wait for a batch's copy to
the host, which is the exposed device time.

Spans and counters
------------------
:func:`span` marks one layer's work on the host.  It records only while
a ``torch.profiler`` records in the process (the CLI's ``--profile``, a
benchmark's traced window); otherwise it returns a shared no-op context
and costs one attribute read.  :func:`traced` and :func:`launch` do the
same for a call, without a ``with`` block when off: the dispatcher's
call and each kernel launch, once a call.  A recorded span opens, on
the thread that started the profiler, the ``USER_SCOPE`` record function
that ``torch.profiler.record_function`` opens (through its C binding,
``torch._C._autograd._record_function_with_args_enter``, at a third of
the cost), so it lands in the Chrome trace as a ``user_annotation``
event on the timeline of the card's kernels and copies; and it keeps
one :class:`SpanRecord` in memory (every thread): name, id, parent,
request, thread, start and end on ``time.perf_counter_ns``.  A span
opened with no open span in its thread starts a new request id; spans
inside it take its id.  :func:`once_span` marks once-per-process set-up
(the package's import, a kernel library's build and load, a kernel's
first launch) and records whether or not a profiler runs.  At most
``MAX_RECORDS`` records are kept (threads racing at the cap may add a
few more); the rest are counted under ``cfrk.spans.dropped``.

:func:`count` adds to a named counter, always: each thread adds to its
own table, so no add is lost and none takes a lock.  :func:`counters`
sums them, with the kernel wrappers' ``launches`` attributes; :func:`spans`, :func:`counters` and :func:`reset` are for
tests and the benchmark's readers, and :func:`trace_us` places a record
on an exported Chrome trace's clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

__all__ = ["RunMetrics", "SpanRecord", "count", "count_out", "counters", "launch",
           "malloc_trim", "once_span", "pin_malloc_for_streaming", "record_once",
           "register_launches", "reset", "span", "spans", "trace_us", "traced"]


@dataclasses.dataclass
class RunMetrics:
    """Counters + per-stage wall times for one counting run."""

    reads: int = 0
    # Reads in the OUTPUT including checkpoint-resumed ones (== reads on
    # a fresh run).
    total_reads: int = 0
    bases: int = 0
    batches: int = 0
    k: int = 0
    mode: str = ""
    stages: dict = dataclasses.field(default_factory=dict)
    # The wall clock starts at the FIRST stage entry, not at construction:
    # a metrics object built early (CLI set-up, CUDA start-up) must not
    # bill that time to the run's bases/sec.
    _t0: float | None = None
    _t_end: float | None = None

    @contextmanager
    def stage(self, name: str):
        """Accumulate wall time under ``stages[name]``; the stage is the
        span ``cfrk.stage.<name>``."""
        t = time.perf_counter()
        if self._t0 is None:
            self._t0 = t
        try:
            with span("cfrk.stage." + name):
                yield
        finally:
            self._t_end = time.perf_counter()
            self.stages[name] = self.stages.get(name, 0.0) + (
                self._t_end - t
            )

    @property
    def wall_s(self) -> float:
        if self._t0 is None:
            return 0.0
        return (self._t_end or time.perf_counter()) - self._t0

    @property
    def bases_per_sec(self) -> float:
        w = self.wall_s
        return self.bases / w if w > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "reads": self.reads,
            "bases": self.bases,
            "batches": self.batches,
            "k": self.k,
            "mode": self.mode,
            "wall_s": round(self.wall_s, 4),
            "bases_per_sec": round(self.bases_per_sec, 1),
            "stages_s": {n: round(t, 4) for n, t in sorted(self.stages.items())},
        }

    def json_line(self) -> str:
        return json.dumps(self.to_dict())


def pin_malloc_for_streaming() -> bool:
    """Keep glibc from retaining the sparse streaming drain's buffers.

    The per-batch host arrays of the sparse fold (tens of MB of masked
    keys and fold transients) sit under glibc's DYNAMIC mmap threshold,
    so freed blocks stay cached in its arenas: the JAX package measured
    a 20M-read k=31 run creeping to 11.1 GB of resident set against a
    4 GB accumulator budget.  Pinning ``M_MMAP_THRESHOLD`` to 1 MB routes
    the big blocks through mmap/munmap, and the resident set tracks the
    live set.  The setting holds for the whole PROCESS, so only a
    program that owns its process calls it (the CLI, once, before a
    streamed sparse or sorted-spectrum run); a library function never
    does.  No-op off glibc.  Returns True when applied."""
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        m_mmap_threshold = -3
        return bool(libc.mallopt(m_mmap_threshold, 1 << 20))
    except (OSError, AttributeError):
        return False


def malloc_trim() -> None:
    """Return freed arena pages to the OS (the streaming drivers call it
    at checkpoints, their quiet point).  No-op off glibc."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


# ---------------------------------------------------------------- spans

MAX_RECORDS = 1 << 18
DROPPED = "cfrk.spans.dropped"
OUT_BYTES = "cfrk.out_bytes"
# One (wall clock, perf counter) pair a process: a record's perf-counter
# nanoseconds convert to the wall clock, from which an exported Chrome
# trace counts its ``baseTimeNanoseconds``.
_ANCHOR = (time.time_ns(), time.perf_counter_ns())
_autograd = torch._C._autograd


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: int  # the enclosing span's id; 0 for none
    request: int
    thread: int
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    once: bool  # once-per-process set-up, kept with or without a profiler


_lock = threading.Lock()
_records: list = []  # SpanRecord fields as plain tuples, cheaper to make
_thread_counts: list = []  # every thread's counter table
_wrappers: list = []  # kernel wrappers whose ``launches`` counters() lists
_launched: set = set()
_local = threading.local()
_ids = itertools.count(1)
_requests = itertools.count(1)
_OFF = contextlib.nullcontext()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _new_counts() -> dict:
    _local.counts = {}
    with _lock:
        _thread_counts.append(_local.counts)
    return _local.counts


class _Span:
    __slots__ = ("name", "once", "id", "parent", "request", "start_ns", "_handle")

    def __init__(self, name: str, once: bool):
        self.name, self.once = name, once

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up else 0
        self.request = up.request if up else next(_requests)
        stack.append(self)
        # The profiler takes annotations from the thread that started it
        # only (this flag is per thread); other threads keep the record.
        self._handle = (_autograd._record_function_with_args_enter(self.name)
                        if _autograd._profiler_enabled() else None)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        if self._handle is not None:
            _autograd._record_function_with_args_exit(self._handle)
        _stack().pop()  # spans are ``with`` blocks: strictly nested in a thread
        _keep((self.name, self.id, self.parent, self.request, threading.get_ident(),
               self.start_ns, end_ns, self.once))
        return False


def _keep(record: tuple) -> None:
    if len(_records) < MAX_RECORDS:
        _records.append(record)
    else:
        count(DROPPED)


def span(name: str):
    """A context that records ``name`` while a profiler records in the
    process, else a shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, False)


def traced(name: str, fn, *args):
    """``fn(*args)`` inside the span ``name``; with no profiler, the call
    alone."""
    if not _profiler._is_profiler_enabled:
        return fn(*args)
    with _Span(name, False):
        return fn(*args)


def launch(kernel: str, fn, *args):
    """``fn(*args)``, one launch of ``kernel``, inside its span:
    ``cfrk.<kernel>.first_launch`` (a once span, where the card loads the
    kernel's module) the first time in the process, else
    ``cfrk.<kernel>.launch``, which holds any wait for room in a full
    launch queue."""
    if kernel not in _launched:
        with _lock:
            first = kernel not in _launched
            _launched.add(kernel)
        if first:
            with _Span(f"cfrk.{kernel}.first_launch", True):
                return fn(*args)
    if not _profiler._is_profiler_enabled:
        return fn(*args)
    with _Span(f"cfrk.{kernel}.launch", False):
        return fn(*args)


def once_span(name: str):
    """A context that records ``name`` always: once-per-process set-up."""
    return _Span(name, True)


def record_once(name: str, start_ns: int) -> None:
    """Record the once-per-process span ``name`` from ``start_ns``
    (``time.perf_counter_ns``) to now, outside any other span: for work
    that ends before this module exists (the package's import)."""
    _keep((name, next(_ids), 0, next(_requests), threading.get_ident(), start_ns,
           time.perf_counter_ns(), True))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    try:
        counts = _local.counts
    except AttributeError:
        counts = _new_counts()
    counts[name] = counts.get(name, 0) + n


def count_out(out):
    """Count the bytes of a kernel wrapper's result (a tensor or a tuple
    of tensors) under ``cfrk.out_bytes``; returns ``out``."""
    if type(out) is tuple:  # no isinstance: Tensor's own check is slow
        n = 0
        for t in out:
            n += t.nbytes
    else:
        n = out.nbytes
    count(OUT_BYTES, n)
    return out


def register_launches(*wrappers) -> None:
    """List each wrapper's ``launches`` attribute in :func:`counters` as
    ``cfrk.<wrapper name>.launches``."""
    _wrappers.extend(wrappers)


def counters() -> dict:
    """Every counter by name, summed over the threads, the wrappers'
    launches included."""
    with _lock:
        tables = list(_thread_counts)
    out: dict = {}
    for table in tables:
        for name, n in list(table.items()):
            out[name] = out.get(name, 0) + n
    out.update({f"cfrk.{f.__name__}.launches": f.launches for f in _wrappers})
    return out


def spans() -> list:
    """The kept :class:`SpanRecord` s, each added when its span closed."""
    return [SpanRecord(*r) for r in list(_records)]


def reset() -> None:
    """Forget the kept records and the counters (not the wrappers'
    ``launches``, nor which kernels have launched)."""
    with _lock:
        _records.clear()
        for table in _thread_counts:
            table.clear()


def trace_us(ns: int, base_time_ns: int) -> float:
    """``time.perf_counter_ns`` nanoseconds as microseconds on the clock of
    an exported Chrome trace whose ``baseTimeNanoseconds`` is given."""
    return (_ANCHOR[0] + ns - _ANCHOR[1] - base_time_ns) / 1e3
