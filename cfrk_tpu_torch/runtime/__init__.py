"""Runtime subsystems of the streaming drivers: metrics, checkpoint and
resume, fault injection."""

from .checkpoint import StreamCheckpoint, checkpoint_path
from .faults import InjectedFault
from .metrics import RunMetrics, StageTimer

__all__ = [
    "InjectedFault",
    "RunMetrics",
    "StageTimer",
    "StreamCheckpoint",
    "checkpoint_path",
]
