"""The prototype-lineage runtime (counterpart of ``byzpy_tpu/engine/legacy``):
polled mailbox transports and a process-per-node runner with command and
result queues, kept for minimal step-loop demos. The modern runtime is
``byzpy_tpu_torch.engine.node`` (``DecentralizedNode`` and its contexts).
"""

from .runner import NodeCluster, NodeRunner, StepParameterServer
from .transport import LocalMailbox, TcpMailbox, Transport

__all__ = [
    "Transport",
    "LocalMailbox",
    "TcpMailbox",
    "NodeRunner",
    "NodeCluster",
    "StepParameterServer",
]
