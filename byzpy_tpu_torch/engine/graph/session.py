"""Execution sessions with intermediate-result caching.

Counterpart of ``byzpy_tpu/engine/graph/session.py`` (ref:
``byzpy/engine/graph/session.py:27-416``). ``ExecutionSession.execute``
skips nodes whose results are already cached (their cached values feed
downstream nodes as plain inputs), runs the rest on a
``ParallelScheduler``, and caches every intermediate. ``execute_async``
returns an ``ExecutionFuture``.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Mapping, Optional, Sequence

from .graph import ComputationGraph, GraphNode
from .parallel_scheduler import ParallelScheduler
from .pool import ActorPool


class ExecutionFuture:
    """Handle to an in-flight graph execution (done/cancel/wait/result)."""

    def __init__(self, task: "asyncio.Task[Dict[str, Any]]") -> None:
        self._task = task

    def done(self) -> bool:
        return self._task.done()

    def cancel(self) -> bool:
        return self._task.cancel()

    async def wait(self, timeout: Optional[float] = None) -> bool:
        try:
            await asyncio.wait_for(asyncio.shield(self._task), timeout)
        except asyncio.TimeoutError:
            return False
        except asyncio.CancelledError:
            # only swallow when it's the graph task that was cancelled;
            # cancellation of the *waiting* coroutine must propagate
            if not self._task.cancelled():
                raise
        except Exception:
            pass  # task failure is surfaced by result(), not wait()
        return self._task.done()

    async def result(self) -> Dict[str, Any]:
        return await self._task


class ExecutionSession:
    """Caches node results across executions of (sub)graphs."""

    def __init__(
        self,
        *,
        pool: Optional[ActorPool] = None,
        metadata: Optional[Mapping[str, Any]] = None,
        max_concurrent_nodes: int = 0,
    ) -> None:
        self.pool = pool
        self._metadata = dict(metadata or {})
        self._max_concurrent_nodes = max_concurrent_nodes
        self._cache: Dict[str, Any] = {}

    # -- cache management ---------------------------------------------------

    @property
    def cached_nodes(self) -> Sequence[str]:
        return list(self._cache.keys())

    def invalidate(self, names: Optional[Sequence[str]] = None) -> None:
        if names is None:
            self._cache.clear()
        else:
            for name in names:
                self._cache.pop(name, None)

    def seed(self, name: str, value: Any) -> None:
        """Pre-populate the cache (e.g. re-using a value across graphs)."""
        self._cache[name] = value

    # -- execution ----------------------------------------------------------

    async def execute(
        self,
        graph: ComputationGraph,
        inputs: Optional[Mapping[str, Any]] = None,
        *,
        use_cache: bool = True,
    ) -> Dict[str, Any]:
        inputs = dict(inputs or {})
        cached = {
            name: self._cache[name]
            for name in graph.nodes
            if use_cache and name in self._cache
        }
        remaining: list[GraphNode] = [
            node for name, node in graph.nodes.items() if name not in cached
        ]

        if remaining:
            # Cached upstream values are injected as plain inputs; the
            # scheduler resolves string sources from `inputs` when the name
            # is not a live graph node.
            sub = ComputationGraph(remaining, outputs=[n.name for n in remaining])
            scheduler = ParallelScheduler(
                sub,
                pool=self.pool,
                metadata=self._metadata,
                max_concurrent_nodes=self._max_concurrent_nodes,
            )
            fresh = await scheduler.run({**inputs, **cached})
            self._cache.update(fresh)
        return {
            name: self._cache[name] for name in graph.outputs if name in self._cache
        } | {name: cached[name] for name in graph.outputs if name in cached}

    def execute_async(
        self,
        graph: ComputationGraph,
        inputs: Optional[Mapping[str, Any]] = None,
        *,
        use_cache: bool = True,
    ) -> ExecutionFuture:
        task = asyncio.ensure_future(self.execute(graph, inputs, use_cache=use_cache))
        return ExecutionFuture(task)


__all__ = ["ExecutionSession", "ExecutionFuture"]
