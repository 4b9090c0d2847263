"""Multi-file workflow orchestration: the Swift/K layer on one GPU.

The counterpart of ``cfrk_tpu/runtime/workflow.py``.  The reference
scaled out by fanning independent `cfrk` processes over FASTA shards
with a Swift/K script (``swift/cfrk.swf:14-20``) configured for
``maxParallelTasks=2``, ``executionRetries=0``, ``lazyErrors=true``
(``swift/swift.conf:27,137,41``), and measured runs only through Swift's
provenance sqlite (``swift/provenance.sh``, ``swift/query.sh:3``).

Here one process owns the card, so file-level parallelism is a thread
pool: the host parse, format and write of one file overlap another's
device work.  A worker thread's current CUDA stream is the legacy
default stream, so in-memory tasks queue their kernels in one order on
the card; each streamed task's ``_BatchPipeline`` has a copy stream and
pinned buffers of its own.  Each task gets Swift-style retries and
lazy-error semantics, and every attempt is appended to a JSONL
provenance log with its duration (the sqlite analog, read back by
:func:`query_provenance`).
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

__all__ = [
    "WorkflowTask",
    "WorkflowResult",
    "count_one_factory",
    "run_workflow",
    "query_provenance",
]


@dataclasses.dataclass
class WorkflowTask:
    """One input→output unit (a Swift/K ``app CFRK`` invocation analog)."""

    input: str
    output: str
    ok: bool = False
    attempts: int = 0
    duration_s: float = 0.0
    reads: int = 0
    error: str | None = None


@dataclasses.dataclass
class WorkflowResult:
    tasks: list
    wall_s: float

    @property
    def ok(self) -> bool:
        return all(t.ok for t in self.tasks)

    @property
    def failed(self) -> list:
        return [t for t in self.tasks if not t.ok]


class _Provenance:
    """Append-only JSONL provenance log (thread-safe)."""

    def __init__(self, path: str | None):
        self._path = path
        self._lock = threading.Lock()

    def record(self, task: WorkflowTask, attempt: int, ok: bool,
               duration_s: float, error: str | None) -> None:
        if not self._path:
            return
        line = json.dumps({
            "ts": time.time(),
            "input": task.input,
            "output": task.output,
            "attempt": attempt,
            "ok": ok,
            "duration_s": round(duration_s, 4),
            "error": error,
        })
        with self._lock:
            with open(self._path, "a") as f:
                f.write(line + "\n")


def query_provenance(path: str) -> list[dict]:
    """All recorded attempts with durations (``swift/query.sh:3`` analog)."""
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(json.loads(line))
    return out


def run_workflow(
    pairs: list[tuple[str, str]],
    count_one,
    *,
    max_parallel_tasks: int = 2,
    retries: int = 0,
    lazy_errors: bool = True,
    provenance_path: str | None = None,
) -> WorkflowResult:
    """Run ``count_one(input, output) -> n_reads`` over many file pairs.

    max_parallel_tasks: concurrent tasks (Swift/K ``maxParallelTasks``).
    retries:            re-attempts per failed task (``executionRetries``).
    lazy_errors:        keep going after failures, report at the end
                        (``lazyErrors``); False raises on first failure.
    provenance_path:    JSONL log of every attempt with duration.
    """
    prov = _Provenance(provenance_path)
    tasks = [WorkflowTask(input=str(i), output=str(o)) for i, o in pairs]
    t_start = time.perf_counter()
    abort = threading.Event()

    # A count_one that accepts ``retrying`` (like count_one_factory's) is
    # told when an attempt is a re-run, so a crashed streaming task
    # resumes from its surviving checkpoint instead of redoing the whole
    # file.  Plain 2-arg callables keep Swift/K's restart-from-scratch.
    try:
        accepts_retrying = "retrying" in inspect.signature(count_one).parameters
    except (TypeError, ValueError):  # builtins / C callables
        accepts_retrying = False

    def run_task(task: WorkflowTask) -> None:
        for attempt in range(retries + 1):
            if abort.is_set():
                # Never clobber a real traceback from an earlier attempt.
                if task.error is None:
                    task.error = "aborted"
                return
            task.attempts = attempt + 1
            t0 = time.perf_counter()
            try:
                kw = {"retrying": attempt > 0} if accepts_retrying else {}
                task.reads = int(count_one(task.input, task.output, **kw) or 0)
                task.duration_s = time.perf_counter() - t0
                task.ok = True
                prov.record(task, attempt, True, task.duration_s, None)
                return
            except Exception:
                dt = time.perf_counter() - t0
                task.duration_s = dt
                task.error = traceback.format_exc(limit=8)
                prov.record(task, attempt, False, dt, task.error)
        if not lazy_errors:
            abort.set()

    with ThreadPoolExecutor(max_workers=max(1, max_parallel_tasks)) as ex:
        list(ex.map(run_task, tasks))

    result = WorkflowResult(tasks=tasks, wall_s=time.perf_counter() - t_start)
    if not lazy_errors and not result.ok:
        # Report a task with a real traceback, not an aborted placeholder.
        first = next(
            (t for t in result.failed if t.error and t.error != "aborted"),
            result.failed[0],
        )
        raise RuntimeError(
            f"workflow task failed ({first.input}):\n{first.error}"
        )
    return result


def count_one_factory(
    k: int,
    *,
    device=None,
    mode: str = "perread",
    canonical: bool = False,
    impl: str = "auto",
    batch_size: int = 8192,
    stream: bool = False,
    spectrum_format: str = "cfrk",
    max_len: int | None = None,
    nonzero: bool = False,
    packed: bool = False,
    resume: bool = False,
    checkpoint_every: int | None = None,
    min_count: int = 1,
    mem_budget_mb: int | None = None,
    mesh=None,
    seqpar: bool = False,
    slack: float = 2.0,
    min_qual: int = 0,
):
    """Build a ``count_one(input, output, retrying=False)`` callable for
    :func:`run_workflow` from CLI-level options, its batches run on
    ``device``.  Each call is the CLI's per-file function
    (``cli.count_one_file``), so a multi-file run writes, file by file,
    the bytes of a single-input run.  A retry resumes a streamed run from
    its surviving checkpoint (a stale or mismatched one starts afresh).
    ``mesh`` runs every file on a mesh of devices (``parallel/``; its
    devices replace ``device``), ``seqpar`` over the positions of an
    ``sp`` mesh, and ``slack`` is the bucket exchange's first box
    capacity factor."""
    opts = argparse.Namespace(
        k=k, mode=mode, canonical=canonical, impl=impl, batch_size=batch_size,
        stream=stream, spectrum_format=spectrum_format, max_len=max_len,
        nonzero=nonzero, packed=packed, checkpoint_every=checkpoint_every,
        min_count=min_count, mem_budget_mb=mem_budget_mb, min_qual=min_qual,
        mesh=mesh, seqpar=seqpar, slack=slack,
    )

    def count_one(inp: str, out: str, retrying: bool = False) -> int:
        from ..cli import count_one_file

        reads, _ = count_one_file(inp, out, opts, device, resume=resume or retrying)
        return reads

    return count_one
