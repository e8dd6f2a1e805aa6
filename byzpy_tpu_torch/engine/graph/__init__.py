"""The graph engine (counterpart of ``byzpy_tpu/engine/graph``): the
operator protocol, graphs, the sequential and parallel schedulers,
sessions, the lazy builder and the actor pools that run operators'
subtasks."""

from .chunking import select_adaptive_chunk_size
from .executor import OperatorExecutor, run_operator
from .graph import ComputationGraph, GraphInput, GraphNode, graph_input
from .lazy import GraphBuilder, LazyNode
from .operator import MessageTriggerOp, OpContext, Operator
from .ops import CallableOp, RemoteCallableOp, make_single_operator_graph
from .parallel_scheduler import ParallelScheduler
from .pool import ActorPool, ActorPoolChannel, ActorPoolConfig
from .scheduler import MessageAwareNodeScheduler, MessageSource, NodeScheduler
from .session import ExecutionFuture, ExecutionSession
from .subtask import SubTask

__all__ = [
    "select_adaptive_chunk_size",
    "OperatorExecutor",
    "run_operator",
    "ComputationGraph",
    "GraphInput",
    "GraphNode",
    "graph_input",
    "GraphBuilder",
    "LazyNode",
    "MessageTriggerOp",
    "OpContext",
    "Operator",
    "CallableOp",
    "RemoteCallableOp",
    "make_single_operator_graph",
    "ParallelScheduler",
    "ActorPool",
    "ActorPoolChannel",
    "ActorPoolConfig",
    "MessageAwareNodeScheduler",
    "MessageSource",
    "NodeScheduler",
    "ExecutionFuture",
    "ExecutionSession",
    "SubTask",
]
