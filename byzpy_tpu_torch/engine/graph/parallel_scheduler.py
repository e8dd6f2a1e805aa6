"""Concurrent DAG scheduler.

Counterpart of ``byzpy_tpu/engine/graph/parallel_scheduler.py`` (ref:
``byzpy/engine/graph/parallel_scheduler.py:19-275``). Tracks in-degrees
and launches every ready node as its own task, bounded by
``max_concurrent_nodes``; a shared semaphore bounds total in-flight
subtasks across concurrently-running operators (``max_pending_subtasks``,
default ``pool.size * 8``).
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Mapping, Optional

from .graph import ComputationGraph, GraphInput
from .operator import OpContext
from .pool import ActorPool
from .scheduler import MessageSource


class ParallelScheduler:
    """Topological wave scheduler: runs every ready node of a ComputationGraph concurrently on the pool, equivalent to NodeScheduler on any DAG (fuzz-pinned)."""
    def __init__(
        self,
        graph: ComputationGraph,
        *,
        pool: Optional[ActorPool] = None,
        metadata: Optional[Mapping[str, Any]] = None,
        max_concurrent_nodes: int = 0,
        max_pending_subtasks: Optional[int] = None,
    ) -> None:
        self.graph = graph
        self.pool = pool
        self._metadata = dict(metadata or {})
        self.max_concurrent_nodes = max_concurrent_nodes
        if max_pending_subtasks is None and pool is not None:
            max_pending_subtasks = pool.size * 8
        self.max_pending_subtasks = max_pending_subtasks

    async def run(self, inputs: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
        inputs = dict(inputs or {})
        results: Dict[str, Any] = {}
        metadata = dict(self._metadata)
        if self.pool is not None:
            metadata.setdefault("pool_size", self.pool.size)
        if self.max_pending_subtasks:
            metadata.setdefault(
                "subtask_semaphore", asyncio.Semaphore(self.max_pending_subtasks)
            )

        indegree: Dict[str, int] = {}
        consumers: Dict[str, list[str]] = {name: [] for name in self.graph.nodes}
        for name in self.graph.nodes:
            deps = self.graph.dependencies(name)
            indegree[name] = len(deps)
            for dep in deps:
                consumers[dep].append(name)

        node_gate = (
            asyncio.Semaphore(self.max_concurrent_nodes)
            if self.max_concurrent_nodes > 0
            else None
        )
        done_events: Dict[str, asyncio.Event] = {
            name: asyncio.Event() for name in self.graph.nodes
        }

        async def resolve(src: Any, node_name: str, key: str) -> Any:
            if isinstance(src, GraphInput):
                if src.name not in inputs:
                    raise KeyError(
                        f"node {node_name!r} requires application input {src.name!r}"
                    )
                return inputs[src.name]
            if isinstance(src, MessageSource):
                raise RuntimeError(
                    "message inputs require MessageAwareNodeScheduler, not ParallelScheduler"
                )
            if isinstance(src, str):
                if src in self.graph.nodes:
                    await done_events[src].wait()
                    return results[src]
                if src in inputs:
                    return inputs[src]
                raise KeyError(
                    f"node {node_name!r} input {key!r} references unknown source {src!r}"
                )
            raise TypeError(f"invalid input source {src!r}")

        async def run_node(name: str) -> None:
            node = self.graph.node(name)
            node_inputs = {
                key: await resolve(src, name, key) for key, src in node.inputs.items()
            }
            context = OpContext(node_name=name, metadata=metadata)
            if node_gate is not None:
                async with node_gate:
                    results[name] = await node.op.run(
                        node_inputs, context=context, pool=self.pool
                    )
            else:
                results[name] = await node.op.run(
                    node_inputs, context=context, pool=self.pool
                )
            done_events[name].set()

        tasks = [asyncio.ensure_future(run_node(name)) for name in self.graph.nodes]
        try:
            await asyncio.gather(*tasks)
        finally:
            for t in tasks:
                t.cancel()
        return {name: results[name] for name in self.graph.outputs}


__all__ = ["ParallelScheduler"]
