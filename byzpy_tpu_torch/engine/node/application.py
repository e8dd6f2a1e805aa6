"""NodeApplication: a named-pipeline registry over one ActorPool.

Counterpart of ``byzpy_tpu/engine/node/application.py`` (behavior parity:
``byzpy/engine/node/application.py:1-269``). An application owns (or
borrows) an :class:`~byzpy_tpu_torch.engine.graph.pool.ActorPool`,
registers named pipelines and runs them on a
:class:`~byzpy_tpu_torch.engine.graph.scheduler.NodeScheduler`.
``HonestNodeApplication`` reserves ``aggregate`` and ``honest_gradient``,
``ByzantineNodeApplication`` reserves ``attack``; those are installed
through their own helpers.
"""

from __future__ import annotations

import asyncio
from typing import Any, ClassVar, Dict, FrozenSet, List, Mapping, Optional, Sequence

from ...aggregators.base import Aggregator
from ...attacks.base import Attack
from ..graph.graph import ComputationGraph
from ..graph.ops import make_single_operator_graph
from ..graph.pool import ActorPool, ActorPoolConfig
from ..graph.scheduler import NodeScheduler


class NodeApplication:
    """Named pipelines, one pool and per-pipeline metadata."""

    reserved_pipelines: ClassVar[FrozenSet[str]] = frozenset()

    def __init__(
        self,
        *,
        pool: Optional[ActorPool] = None,
        pool_config: Optional[ActorPoolConfig | Sequence[ActorPoolConfig]] = None,
        metadata: Optional[Mapping[str, Any]] = None,
    ) -> None:
        self._external_pool = pool is not None
        self._pool = pool
        if self._pool is None and pool_config is not None:
            self._pool = ActorPool(pool_config)
        self._metadata = dict(metadata or {})
        self._pipelines: Dict[str, ComputationGraph] = {}
        self._pipeline_meta: Dict[str, Dict[str, Any]] = {}
        self._started = False

    # -- lifecycle -----------------------------------------------------------

    @property
    def pool(self) -> Optional[ActorPool]:
        return self._pool

    async def start(self) -> None:
        if self._pool is not None and not self._started:
            await self._pool.start()
        self._started = True

    async def close(self) -> None:
        if self._pool is not None and not self._external_pool:
            await self._pool.close()
        self._started = False

    async def __aenter__(self) -> "NodeApplication":
        await self.start()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.close()

    # -- registry ------------------------------------------------------------

    def register_pipeline(
        self,
        name: str,
        graph: ComputationGraph,
        *,
        metadata: Optional[Mapping[str, Any]] = None,
        _internal: bool = False,
    ) -> None:
        if not _internal and name in self.reserved_pipelines:
            raise ValueError(
                f"pipeline name {name!r} is reserved by {type(self).__name__}; "
                f"use the dedicated register helper")
        if name in self._pipelines:
            raise ValueError(f"pipeline {name!r} already registered")
        self._pipelines[name] = graph
        self._pipeline_meta[name] = dict(metadata or {})

    def pipeline_names(self) -> List[str]:
        return sorted(self._pipelines)

    def pipeline_metadata(self, name: str) -> Dict[str, Any]:
        return dict(self._pipeline_meta[name])

    # -- execution -----------------------------------------------------------

    async def run_pipeline(self, name: str, inputs: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
        graph = self._pipelines.get(name)
        if graph is None:
            raise KeyError(f"no pipeline {name!r}; registered: {self.pipeline_names()}")
        await self.start()
        metadata = {**self._metadata, **self._pipeline_meta[name]}
        scheduler = NodeScheduler(graph, pool=self._pool, metadata=metadata)
        return await scheduler.run(inputs)

    def run_pipeline_sync(self, name: str, inputs: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
        """For callers outside an event loop: runs one of its own."""
        return asyncio.run(self.run_pipeline(name, inputs))


class HonestNodeApplication(NodeApplication):
    """The honest-node pipeline contract (ref: ``application.py:144-216``)."""

    reserved_pipelines = frozenset({"aggregate", "honest_gradient"})

    def register_aggregation(self, aggregator: Aggregator, *,
                             metadata: Optional[Mapping[str, Any]] = None) -> None:
        self.register_pipeline(
            "aggregate", make_single_operator_graph(aggregator, node_name="aggregate"),
            metadata=metadata, _internal=True)

    def register_gradient(self, graph: ComputationGraph, *,
                          metadata: Optional[Mapping[str, Any]] = None) -> None:
        self.register_pipeline("honest_gradient", graph, metadata=metadata, _internal=True)

    async def aggregate(self, gradients: Sequence[Any]) -> Any:
        out = await self.run_pipeline("aggregate", {"gradients": gradients})
        return out["aggregate"]


class ByzantineNodeApplication(NodeApplication):
    """The byzantine-node pipeline contract (ref: ``application.py:219-261``)."""

    reserved_pipelines = frozenset({"attack"})

    def register_attack(
        self,
        attack: Attack,
        *,
        input_keys: Optional[Mapping[str, str]] = None,
        metadata: Optional[Mapping[str, Any]] = None,
    ) -> None:
        if input_keys is None:
            # each need the attack declares becomes an input of that name
            keys = []
            if attack.uses_model_batch:
                keys += ["model", "x", "y"]
            if attack.uses_honest_grads:
                keys.append("honest_grads")
            if attack.uses_base_grad:
                keys.append("base_grad")
            input_keys = {k: k for k in keys}
        self.register_pipeline(
            "attack",
            make_single_operator_graph(attack, input_keys=input_keys, node_name="attack"),
            metadata=metadata, _internal=True)

    async def attack(self, **inputs: Any) -> Any:
        out = await self.run_pipeline("attack", inputs)
        return out["attack"]


__all__ = ["NodeApplication", "HonestNodeApplication", "ByzantineNodeApplication"]
