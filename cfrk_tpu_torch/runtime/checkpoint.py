"""Checkpoint / resume for streaming counting runs.

A copy of ``cfrk_tpu/runtime/checkpoint.py`` with the same JSON layout
and field names, so that a run of either package resumes from the
other's checkpoint:

* the checkpoint is a small JSON sidecar written atomically
  (tmp + ``os.replace``), holding the run's fingerprint, the number of
  reads fully written, the exact output byte offset and, where the input
  has them, the input byte offset past the last checkpointed record;
* resume validates the fingerprint, truncates the output file to the
  recorded offset (dropping any torn tail from a mid-batch crash), and
  seeks the input (plain and bgzf files) or re-parses and skips the
  processed reads (plain gzip);
* spectrum-mode runs also persist the partial table as ``.npy`` next to
  the checkpoint, and sparse runs their merged (keys, counts) arrays as
  ``.npz`` -- or, under a memory budget, the list of sorted runs spilled
  to ``<ckpt>.spill/`` (:func:`spill_dir_path`).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from . import faults

__all__ = [
    "StreamCheckpoint",
    "checkpoint_path",
    "cleanup_checkpoint",
    "spill_dir_path",
]


def cleanup_checkpoint(out_path: str | os.PathLike) -> None:
    """Remove the checkpoint (and its sidecars) for ``out_path`` if any.

    For callers that stream with ``cleanup=False`` (keeping the
    checkpoint alive until the real output file is written) and then
    finalize."""
    import shutil

    cpath = checkpoint_path(out_path)
    if not os.path.exists(cpath):
        # Spill runs can exist without a checkpoint JSON (a budgeted
        # run short enough to never checkpoint) — still remove them.
        shutil.rmtree(spill_dir_path(cpath), ignore_errors=True)
        return
    ckpt = StreamCheckpoint.load_if_valid(cpath) or StreamCheckpoint(
        fingerprint={}
    )
    ckpt.cleanup(cpath)


def checkpoint_path(out_path: str | os.PathLike) -> str:
    return str(out_path) + ".ckpt.json"


def spill_dir_path(ckpt_path: str) -> str:
    """Directory holding a memory-bounded sparse run's spilled runs —
    derived from the checkpoint path so resume finds it and
    :meth:`StreamCheckpoint.cleanup` removes it with the checkpoint."""
    return os.path.abspath(ckpt_path + ".spill")


@dataclasses.dataclass
class StreamCheckpoint:
    """State of a partially-completed streaming run."""

    fingerprint: dict
    reads_done: int = 0
    out_bytes: int = 0
    spectrum_path: str | None = None
    # Input byte offset just past the last checkpointed record (plain
    # files; the decompressed offset for bgzf): resume seeks here instead
    # of re-parsing reads_done records.  None = no offsets (plain gzip).
    input_offset: int | None = None
    # Memory-bounded sparse runs (ops/sparse.SpillingSparseAccumulator):
    # the authoritative list of spilled run basenames under
    # ``<ckpt>.spill/`` as of this checkpoint.  Runs spilled after the
    # JSON flip are stale (their batches get replayed) and are deleted
    # by adopt_runs on resume.  None = unbounded npz checkpointing.
    sparse_runs: list | None = None

    @staticmethod
    def fingerprint_of(input_path, k: int, mode: str, canonical: bool) -> dict:
        st = os.stat(input_path)
        return {
            "input": os.path.abspath(str(input_path)),
            "input_size": st.st_size,
            # nanosecond mtime: a same-size input regenerated within the
            # same SECOND (fast CI reruns) must not match and splice two
            # different files' counts together.
            "input_mtime": int(st.st_mtime_ns),
            "k": k,
            "mode": mode,
            "canonical": bool(canonical),
        }

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(self), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # The JSON now references the new sidecar (if any); the
        # superseded one can go.
        stale = getattr(self, "_pending_cleanup", None)
        if stale and stale != self.spectrum_path and os.path.exists(stale):
            os.remove(stale)
        self._pending_cleanup = None
        # Crash-consistency fault site: dies right after the checkpoint
        # became durable (runtime/faults.py; a no-op unless a test armed it).
        faults.trip("checkpoint")

    @staticmethod
    def load(path: str) -> "StreamCheckpoint":
        with open(path) as f:
            data = json.load(f)
        # Tolerate unknown fields (forward compatibility: a checkpoint
        # written by a newer build must not crash an older one).
        fields = {f.name for f in dataclasses.fields(StreamCheckpoint)}
        return StreamCheckpoint(**{k: v for k, v in data.items() if k in fields})

    @staticmethod
    def load_if_valid(path: str) -> "StreamCheckpoint | None":
        """Load a checkpoint, or None if it is missing/torn/invalid —
        resume paths fall back to a fresh start instead of crashing."""
        try:
            return StreamCheckpoint.load(path)
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            # AttributeError: a JSON whose top level is not an object
            # ('null', '[]') — fall back to a fresh start like any
            # other torn/foreign sidecar.
            return None

    def matches(self, fingerprint: dict) -> bool:
        return self.fingerprint == fingerprint

    # -- accumulator sidecars --------------------------------------------
    # Sidecars get a UNIQUE name per checkpoint state (reads_done) and
    # only become live when the atomically-replaced JSON references
    # them: a crash between the sidecar write and the JSON write leaves
    # the old JSON pointing at the old sidecar — never a new accumulator
    # paired with a stale reads_done (which would double-count on
    # resume).  The superseded sidecar is deleted after the JSON flip.

    def _sidecar_swap(self, new_path: str) -> str:
        old = self.spectrum_path
        self.spectrum_path = new_path
        return old

    def save_spectrum(self, ckpt_path: str, table: np.ndarray) -> None:
        # abspath: a run launched with a relative out_path must resume
        # from ANY working directory (the fingerprint already stores the
        # input's abspath) — a dangling relative sidecar path silently
        # discards all checkpointed accumulation.
        spath = os.path.abspath(f"{ckpt_path}.spectrum.{self.reads_done}.npy")
        tmp = spath + ".tmp.npy"
        with open(tmp, "wb") as f:
            np.save(f, table)
            f.flush()
            os.fsync(f.fileno())  # data durable BEFORE the JSON claims it
        os.replace(tmp, spath)
        self._pending_cleanup = self._sidecar_swap(spath)

    def load_spectrum(self) -> np.ndarray:
        if not self.spectrum_path:
            raise ValueError("checkpoint has no spectrum accumulator")
        return np.load(self.spectrum_path)

    def save_sparse(self, ckpt_path: str, keys: np.ndarray,
                    counts: np.ndarray) -> None:
        spath = os.path.abspath(f"{ckpt_path}.sparse.{self.reads_done}.npz")
        tmp = spath + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, keys=keys, counts=counts)
            f.flush()
            os.fsync(f.fileno())  # data durable BEFORE the JSON claims it
        os.replace(tmp, spath)
        self._pending_cleanup = self._sidecar_swap(spath)

    def load_sparse(self) -> tuple[np.ndarray, np.ndarray]:
        if not self.spectrum_path:
            raise ValueError("checkpoint has no sparse accumulator")
        with np.load(self.spectrum_path) as z:
            return z["keys"], z["counts"]

    def cleanup(self, ckpt_path: str) -> None:
        """Remove checkpoint files after a successful run (including any
        orphaned sidecar generations from interrupted checkpoints and
        the memory-bound spill-run directory)."""
        import glob
        import shutil

        esc = glob.escape(ckpt_path)  # metachars in out paths must not glob
        stale = glob.glob(esc + ".spectrum.*") + glob.glob(esc + ".sparse.*")
        for p in {ckpt_path, self.spectrum_path, *stale}:
            if p and os.path.exists(p):
                os.remove(p)
        shutil.rmtree(spill_dir_path(ckpt_path), ignore_errors=True)
