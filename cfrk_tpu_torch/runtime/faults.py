"""Deterministic fault injection for crash-consistency testing.

A copy of ``cfrk_tpu/runtime/faults.py`` (same names, same environment
variable).  The streaming drivers promise byte-identical output across a
crash at any checkpoint boundary, which is only testable by crashing
there: production code calls :func:`trip` at named sites, and tests arm
a site to raise after N passes.

Sites wired:

* ``"checkpoint"`` — just after a streaming checkpoint sidecar is
  durably saved (``StreamCheckpoint.save``): the checkpoint claims
  progress the process never gets to act on;
* ``"batch-written"`` — a batch's rows are written but not yet
  checkpointed (``pipeline/stream.stream_count_file``): resume must drop
  the torn tail and redo the batch.

Arming is explicit (:func:`arm`, for in-process tests) or through the
environment for subprocess tests::

    CFRK_FAULT_INJECT="checkpoint:2"   # raise at the 2nd checkpoint

A disarmed site costs one dict lookup.
"""

from __future__ import annotations

import os

__all__ = ["InjectedFault", "arm", "disarm", "trip"]


class InjectedFault(RuntimeError):
    """Raised at an armed fault site; never raised in normal operation."""


_armed: dict[str, int] = {}


def _load_env() -> None:
    spec = os.environ.get("CFRK_FAULT_INJECT", "")
    for part in spec.split(","):
        if ":" in part:
            site, n = part.rsplit(":", 1)
            try:
                _armed[site.strip()] = int(n)
            except ValueError:
                raise ValueError(f"bad CFRK_FAULT_INJECT spec: {part!r}")


_load_env()


def arm(site: str, after: int) -> None:
    """Make the ``after``-th :func:`trip` of ``site`` raise
    :class:`InjectedFault` (1 = the very next one)."""
    if after < 1:
        raise ValueError("after must be >= 1")
    _armed[site] = after


def disarm(site: str | None = None) -> None:
    """Disarm one site, or every site when ``site`` is None."""
    if site is None:
        _armed.clear()
    else:
        _armed.pop(site, None)


def trip(site: str) -> None:
    """Fault point: raises iff ``site`` is armed and its counter expires.

    The site disarms itself when it fires, so cleanup or retry code
    running after the injected crash does not trip again."""
    n = _armed.get(site)
    if n is None:
        return
    if n <= 1:
        del _armed[site]
        raise InjectedFault(site)
    _armed[site] = n - 1
