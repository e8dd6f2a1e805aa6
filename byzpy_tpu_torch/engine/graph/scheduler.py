"""Sequential and message-aware graph schedulers.

Counterpart of ``byzpy_tpu/engine/graph/scheduler.py`` (ref:
``byzpy/engine/graph/scheduler.py:12-269``). ``NodeScheduler`` executes a
``ComputationGraph`` in topological order, resolving node inputs from
application inputs, upstream results, or messages.
``MessageAwareNodeScheduler`` adds an inbox: ``deliver_message`` wakes
``wait_for_message`` waiters (or caches until asked).
"""

from __future__ import annotations

import asyncio
import logging
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Mapping, Optional

from .graph import ComputationGraph, GraphInput
from .operator import OpContext
from .pool import ActorPool


@dataclass(frozen=True)
class MessageSource:
    """Graph-input placeholder resolved by waiting for a message."""

    message_type: str
    field: Optional[str] = None
    timeout: Optional[float] = None


class NodeScheduler:
    """Runs graph nodes sequentially in topological order."""

    def __init__(
        self,
        graph: ComputationGraph,
        *,
        pool: Optional[ActorPool] = None,
        metadata: Optional[Mapping[str, Any]] = None,
    ) -> None:
        self.graph = graph
        self.pool = pool
        self._metadata = dict(metadata or {})

    def _context_metadata(self) -> Dict[str, Any]:
        md = dict(self._metadata)
        if self.pool is not None:
            md.setdefault("pool_size", self.pool.size)
            md.setdefault("worker_affinities", [])
        return md

    async def _resolve_input(self, src: Any, inputs: Mapping[str, Any], results: Dict[str, Any], node_name: str, key: str) -> Any:
        if isinstance(src, GraphInput):
            if src.name not in inputs:
                raise KeyError(
                    f"node {node_name!r} requires application input {src.name!r}"
                )
            return inputs[src.name]
        if isinstance(src, MessageSource):
            return await self._resolve_message(src)
        if isinstance(src, str):
            if src in results:
                return results[src]
            if src in inputs:
                return inputs[src]
            raise KeyError(
                f"node {node_name!r} input {key!r} references unknown source {src!r}"
            )
        raise TypeError(f"invalid input source {src!r} for node {node_name!r}")

    async def _resolve_message(self, src: MessageSource) -> Any:
        raise RuntimeError(
            "graph uses message inputs; run it on a MessageAwareNodeScheduler"
        )

    async def run(self, inputs: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
        inputs = dict(inputs or {})
        results: Dict[str, Any] = {}
        metadata = self._context_metadata()
        for node in self.graph.nodes_in_order():
            node_inputs = {
                key: await self._resolve_input(src, inputs, results, node.name, key)
                for key, src in node.inputs.items()
            }
            context = OpContext(node_name=node.name, metadata=metadata)
            results[node.name] = await node.op.run(
                node_inputs, context=context, pool=self.pool
            )
        return {name: results[name] for name in self.graph.outputs}


class MessageAwareNodeScheduler(NodeScheduler):
    """NodeScheduler + inbox with waiter futures and a type-keyed cache.

    The cache is bounded per message type (``max_cached_per_type``): a node
    that consumes some traffic only through handlers would otherwise
    accumulate every delivered message forever. On overflow the oldest
    message of that type is dropped (and logged at debug level).
    """

    def __init__(
        self,
        graph: ComputationGraph,
        *,
        pool: Optional[ActorPool] = None,
        metadata: Optional[Mapping[str, Any]] = None,
        max_cached_per_type: int = 1024,
    ) -> None:
        super().__init__(graph, pool=pool, metadata=metadata)
        self._cached: Dict[str, Deque[Any]] = {}
        self._waiters: Dict[str, List[asyncio.Future]] = {}
        self._max_cached = max(1, int(max_cached_per_type))

    def swap_graph(self, graph: ComputationGraph) -> None:
        """Replace the scheduled graph (decentralized nodes swap per-pipeline
        graphs into one scheduler; ref: ``decentralized.py:44-67``)."""
        self.graph = graph

    # -- messaging ----------------------------------------------------------

    async def deliver_message(self, message_type: str, message: Any) -> None:
        waiters = self._waiters.get(message_type)
        while waiters:
            fut = waiters.pop(0)
            if not fut.done():
                fut.set_result(message)
                return
        cache = self._cached.setdefault(
            message_type, deque(maxlen=self._max_cached)
        )
        if len(cache) == self._max_cached:
            logging.getLogger(__name__).debug(
                "message cache for %r full (%d); dropping oldest",
                message_type, self._max_cached,
            )
        cache.append(message)

    async def wait_for_message(
        self, message_type: str, *, timeout: Optional[float] = None
    ) -> Any:
        cached = self._cached.get(message_type)
        if cached:
            return cached.popleft()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiters.setdefault(message_type, []).append(fut)
        if timeout is None:
            return await fut
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            raise TimeoutError(
                f"timed out after {timeout}s waiting for message {message_type!r}"
            ) from None

    def pending_message_count(self, message_type: str) -> int:
        return len(self._cached.get(message_type, []))

    # -- overrides ----------------------------------------------------------

    async def _resolve_message(self, src: MessageSource) -> Any:
        message = await self.wait_for_message(src.message_type, timeout=src.timeout)
        if src.field is not None:
            return message[src.field]
        return message

    def _context_metadata(self) -> Dict[str, Any]:
        md = super()._context_metadata()
        md.setdefault("wait_for_message", self.wait_for_message)
        return md


__all__ = ["MessageSource", "NodeScheduler", "MessageAwareNodeScheduler"]
