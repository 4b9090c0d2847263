"""Runtime subsystems: metrics, checkpoint and resume, fault injection,
config files and the multi-file workflow."""

from .checkpoint import StreamCheckpoint, checkpoint_path
from .faults import InjectedFault
from .metrics import RunMetrics
from .workflow import (
    WorkflowResult,
    WorkflowTask,
    count_one_factory,
    query_provenance,
    run_workflow,
)

__all__ = [
    "InjectedFault",
    "RunMetrics",
    "StreamCheckpoint",
    "WorkflowResult",
    "WorkflowTask",
    "checkpoint_path",
    "count_one_factory",
    "query_provenance",
    "run_workflow",
]
