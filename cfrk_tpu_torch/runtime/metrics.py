"""Per-stage timing and throughput metrics of one counting run.

A copy of ``RunMetrics`` and ``StageTimer`` of
``cfrk_tpu/runtime/metrics.py``: every stage of a streaming driver
records into a :class:`RunMetrics`, which prints as one JSON line with
the JAX package's keys.

Stages time the host.  Launches on a CUDA device return before the
device finishes, so a stage holds the time the host was held there: the
"materialize" stage of a streamed run is the wait for a batch's copy to
the host, which is the exposed device time.
"""

from __future__ import annotations

import dataclasses
import json
import time
from contextlib import contextmanager

__all__ = ["RunMetrics", "StageTimer", "malloc_trim", "pin_malloc_for_streaming"]


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
        """Accumulate wall time under ``stages[name]``."""
        t = time.perf_counter()
        if self._t0 is None:
            self._t0 = t
        try:
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


class StageTimer:
    """Standalone accumulating timer (for call sites without a RunMetrics)."""

    def __init__(self) -> None:
        self.total = 0.0
        self.count = 0

    @contextmanager
    def __call__(self):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.total += time.perf_counter() - t
            self.count += 1
