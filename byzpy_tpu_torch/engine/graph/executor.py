"""Operator executor, the package front door.

Counterpart of ``byzpy_tpu/engine/graph/executor.py`` (ref:
``byzpy/engine/graph/executor.py:71-291``; re-exported at the top level as
``byzpy_tpu_torch.run_operator``). ``run_operator(op, inputs)`` wraps the
operator in a one-node graph, runs it on a scheduler (optionally over an
``ActorPool``, e.g. ``pool_config=ActorPoolConfig(backend="cuda",
count=4)``), and returns the single result. Aggregators consume
``gradients``, pre-aggregators ``vectors``; attacks declare several needs
and take an explicit mapping.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

from .graph import ComputationGraph, GraphInput, GraphNode
from .operator import Operator
from .pool import ActorPool, ActorPoolConfig
from .scheduler import NodeScheduler


def _is_mapping(value: Any) -> bool:
    return isinstance(value, Mapping)


class OperatorExecutor:
    """Reusable executor: owns (or borrows) a pool, caches the graph."""

    def __init__(
        self,
        op: Operator,
        *,
        pool: Optional[ActorPool] = None,
        pool_config: Optional[ActorPoolConfig | Sequence[ActorPoolConfig]] = None,
        input_key: Optional[str] = None,
    ) -> None:
        self.op = op
        self._external_pool = pool
        self._pool_config = pool_config
        self._pool: Optional[ActorPool] = pool
        self._owns_pool = pool is None and pool_config is not None
        self.input_key = input_key or getattr(op, "input_key", None)
        self._graph_cache: dict[tuple[str, ...], ComputationGraph] = {}

    async def _ensure_pool(self) -> Optional[ActorPool]:
        if self._pool is None and self._pool_config is not None:
            self._pool = ActorPool(self._pool_config)
        if self._pool is not None:
            await self._pool.start()
        return self._pool

    def _build_graph(self, input_names: Sequence[str]) -> ComputationGraph:
        inputs = {name: GraphInput(name) for name in input_names}
        return ComputationGraph(
            [GraphNode(name=self.op.name or "op", op=self.op, inputs=inputs)]
        )

    async def run(self, inputs: Any) -> Any:
        """Run the operator. ``inputs`` may be the bare value for the
        operator's input key, or a full mapping of input names."""
        if not _is_mapping(inputs):
            if self.input_key is None:
                raise ValueError(
                    f"operator {self.op.name!r} has no input_key; pass a mapping of inputs"
                )
            inputs = {self.input_key: inputs}
        cache_key = tuple(sorted(inputs.keys()))
        graph = self._graph_cache.get(cache_key)
        if graph is None:
            graph = self._build_graph(list(inputs.keys()))
            self._graph_cache[cache_key] = graph
        pool = await self._ensure_pool()
        scheduler = NodeScheduler(graph, pool=pool)
        results = await scheduler.run(inputs)
        return results[graph.outputs[0]]

    async def close(self) -> None:
        if self._owns_pool and self._pool is not None:
            await self._pool.close()
            self._pool = None


async def run_operator(
    op: Operator,
    inputs: Any,
    *,
    pool: Optional[ActorPool] = None,
    pool_config: Optional[ActorPoolConfig | Sequence[ActorPoolConfig]] = None,
    input_key: Optional[str] = None,
) -> Any:
    """One-shot convenience around :class:`OperatorExecutor`
    (ref: ``executor.py:266-291``)."""
    executor = OperatorExecutor(
        op, pool=pool, pool_config=pool_config, input_key=input_key
    )
    try:
        return await executor.run(inputs)
    finally:
        await executor.close()


__all__ = ["OperatorExecutor", "run_operator"]
