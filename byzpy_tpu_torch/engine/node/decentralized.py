"""DecentralizedNode: the message-driven node runtime.

Counterpart of ``byzpy_tpu/engine/node/decentralized.py`` (behavior
parity: ``byzpy/engine/node/decentralized.py:12-281``): one
:class:`~byzpy_tpu_torch.engine.graph.scheduler.MessageAwareNodeScheduler`
whose graph is swapped per pipeline, a handler registry, inbound messages
fed by the node's :class:`~.context.NodeContext`, topology-routed
``send`` / ``broadcast`` / ``multicast``, background tasks and a graceful
shutdown. A message's payload is passed by reference (see
:mod:`.context`).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Awaitable, Callable, Dict, List, Mapping, Optional

from ..graph.graph import ComputationGraph, GraphNode
from ..graph.ops import CallableOp
from ..graph.pool import ActorPool
from ..graph.scheduler import MessageAwareNodeScheduler
from ..peer_to_peer.topology import Topology
from .context import Message, NodeContext
from .router import MessageRouter

logger = logging.getLogger(__name__)

Handler = Callable[[Message], Awaitable[None]]


def _empty_graph() -> ComputationGraph:
    """Placeholder graph, so the scheduler exists before any pipeline runs."""
    return ComputationGraph(nodes=[GraphNode(name="noop", op=CallableOp(lambda: None), inputs={})])


class DecentralizedNode:
    """A message-driven training node bound to a :class:`NodeContext`."""

    def __init__(
        self,
        node_id: str,
        context: NodeContext,
        *,
        pool: Optional[ActorPool] = None,
        topology: Optional[Topology] = None,
        node_ids: Optional[Dict[int, str]] = None,
    ) -> None:
        self.node_id = node_id
        self.context = context
        self.pool = pool
        self.scheduler = MessageAwareNodeScheduler(
            _empty_graph(), pool=pool, metadata={"node_id": node_id})
        self._pipelines: Dict[str, ComputationGraph] = {}
        self._handlers: Dict[str, List[Handler]] = {}
        self._router: Optional[MessageRouter] = None
        if topology is not None and node_ids is not None:
            self.bind_topology(topology, node_ids)
        self._tasks: List[asyncio.Task] = []
        self._started = False
        self._pipeline_lock = asyncio.Lock()

    # -- wiring -------------------------------------------------------------

    def bind_topology(self, topology: Topology, node_ids: Dict[int, str]) -> None:
        self._router = MessageRouter(self.node_id, topology, node_ids, self.context.send_message)

    @property
    def router(self) -> MessageRouter:
        if self._router is None:
            raise RuntimeError(f"node {self.node_id!r} has no topology bound; call bind_topology")
        return self._router

    def register_pipeline(self, name: str, graph: ComputationGraph) -> None:
        self._pipelines[name] = graph

    def pipeline_names(self) -> List[str]:
        return sorted(self._pipelines)

    def register_handler(self, message_type: str, handler: Handler) -> None:
        self._handlers.setdefault(message_type, []).append(handler)

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        if self._started:
            return
        await self.context.start(self)
        self._started = True

    async def shutdown(self) -> None:
        for task in self._tasks:
            task.cancel()
        for task in self._tasks:
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001 - teardown
                pass
        self._tasks.clear()
        if self._started:
            await self.context.shutdown()
            self._started = False

    async def __aenter__(self) -> "DecentralizedNode":
        await self.start()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.shutdown()

    # -- messaging ----------------------------------------------------------

    async def handle_incoming_message(self, message: Message) -> None:
        """The context's delivery entry: the scheduler's inbox first (so a
        pipeline waiting in ``wait_for_message`` wakes), then the handlers
        of the message's type."""
        await self.scheduler.deliver_message(message.type, message)
        for handler in self._handlers.get(message.type, []):
            try:
                await handler(message)
            except Exception:  # noqa: BLE001 - one bad handler must not stop delivery
                logger.exception("node %s: handler for %r failed", self.node_id, message.type)

    async def send_message(self, target_id: str, message_type: str, payload: Any = None,
                           **metadata: Any) -> None:
        await self.router.route_direct(target_id, Message(message_type, self.node_id, payload, metadata))

    async def reply_message(self, target_id: str, message_type: str, payload: Any = None,
                            **metadata: Any) -> None:
        await self.router.route_reply(target_id, Message(message_type, self.node_id, payload, metadata))

    async def broadcast_message(self, message_type: str, payload: Any = None,
                                **metadata: Any) -> List[str]:
        return await self.router.route_broadcast(Message(message_type, self.node_id, payload, metadata))

    async def multicast_message(self, target_ids: List[str], message_type: str, payload: Any = None,
                                **metadata: Any) -> None:
        await self.router.route_multicast(
            target_ids, Message(message_type, self.node_id, payload, metadata))

    async def wait_for_message(self, message_type: str, *, timeout: Optional[float] = None) -> Message:
        return await self.scheduler.wait_for_message(message_type, timeout=timeout)

    # -- pipelines ----------------------------------------------------------

    async def execute_pipeline(self, name: str, inputs: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
        """Run a registered pipeline on the node's scheduler; the graph is
        swapped in under a lock (one pipeline at a time a node, ref:
        ``decentralized.py:185-208``). A context that hosts the node
        elsewhere (``remote_execute_pipeline``) runs it there."""
        remote = getattr(self.context, "remote_execute_pipeline", None)
        if remote is not None:
            return await remote(name, dict(inputs or {}))
        graph = self._pipelines.get(name)
        if graph is None:
            raise KeyError(f"node {self.node_id!r} has no pipeline {name!r}; "
                           f"registered: {self.pipeline_names()}")
        async with self._pipeline_lock:
            self.scheduler.swap_graph(graph)
            return await self.scheduler.run(inputs)

    def start_autonomous_task(self, coro_fn: Callable[["DecentralizedNode"], Awaitable[None]]) -> asyncio.Task:
        """Run ``coro_fn(self)`` in the background until it ends or the node
        shuts down (ref: ``decentralized.py:223-253``)."""
        task = asyncio.ensure_future(coro_fn(self))
        self._tasks.append(task)
        return task


__all__ = ["DecentralizedNode", "Message"]
