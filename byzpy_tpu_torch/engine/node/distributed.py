"""Distributed node wrappers: user nodes whose heavy calls run as
pool-scheduled pipelines.

Counterpart of ``byzpy_tpu/engine/node/distributed.py`` (behavior parity:
``byzpy/engine/node/distributed.py:52-314``). ``DistributedHonestNode``
registers an ``aggregate`` pipeline (the robust aggregator on its own
pool) and an ``honest_gradient`` pipeline around the user's gradient
method, as a :class:`~byzpy_tpu_torch.engine.graph.ops.RemoteCallableOp`
(one worker hop with a pool, inline without).
``DistributedByzantineNode.__init_subclass__`` lifts a user's
``byzantine_gradient`` override into an ``attack`` pipeline whose inputs
are the override's parameter names. Both pools are in process, so
tensors pass by reference (no pickling).
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Sequence

from ...aggregators.base import Aggregator
from ..graph.graph import ComputationGraph, GraphInput, GraphNode
from ..graph.ops import RemoteCallableOp
from ..graph.pool import ActorPool, ActorPoolConfig
from .application import ByzantineNodeApplication, HonestNodeApplication
from .base import ByzantineNode, HonestNode


class DistributedHonestNode(HonestNode):
    """Honest node whose gradient and aggregation calls run on a pool.

    Subclasses implement ``next_batch`` and ``honest_gradient``;
    ``honest_gradient_for_next_batch`` becomes a pipeline run and
    ``aggregate`` runs the configured aggregator with its subtask fan-out.
    """

    def __init__(
        self,
        *,
        aggregator: Optional[Aggregator] = None,
        pool: Optional[ActorPool] = None,
        pool_config: Optional[ActorPoolConfig | Sequence[ActorPoolConfig]] = None,
    ) -> None:
        self.app = HonestNodeApplication(pool=pool, pool_config=pool_config)
        if aggregator is not None:
            self.app.register_aggregation(aggregator)
        self.app.register_gradient(ComputationGraph([
            GraphNode(
                name="honest_gradient",
                # cache_fn=False: the bound method reads state that changes
                # every round
                op=RemoteCallableOp(self._gradient_entry, name="honest_gradient", cache_fn=False),
                inputs={"x": GraphInput("x"), "y": GraphInput("y")},
            )
        ]))

    def _gradient_entry(self, x: Any, y: Any) -> Any:
        return self.honest_gradient(x, y)

    async def honest_gradient_for_next_batch(self) -> Any:
        x, y = self.next_batch()
        out = await self.app.run_pipeline("honest_gradient", {"x": x, "y": y})
        return out["honest_gradient"]

    async def aggregate(self, gradients: Sequence[Any]) -> Any:
        """Robust aggregate on this node's pool (ref: distributed.py:108-134)."""
        return await self.app.aggregate(gradients)

    async def close(self) -> None:
        await self.app.close()


class DistributedByzantineNode(ByzantineNode):
    """Byzantine node whose ``byzantine_gradient`` body runs as a pool
    pipeline::

        class MyAttacker(DistributedByzantineNode):
            def byzantine_gradient(self, honest_gradients):
                return -2.0 * sum(honest_gradients) / len(honest_gradients)

    Calls return awaitables, which the orchestrators await.
    """

    _user_byzantine_gradient = None
    _byz_input_keys: List[str] = []

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        user_fn = cls.__dict__.get("byzantine_gradient")
        if user_fn is None:
            return
        cls._user_byzantine_gradient = user_fn
        keys = [p for p in inspect.signature(user_fn).parameters if p != "self"]
        if not keys:
            raise TypeError("byzantine_gradient must take at least one argument "
                            "(the honest gradients)")
        cls._byz_input_keys = keys

        def wrapped(self: "DistributedByzantineNode", *args: Any, **kw: Any):
            inputs: Dict[str, Any] = dict(zip(cls._byz_input_keys, args, strict=False))
            inputs.update(kw)
            return self._run_attack_pipeline(inputs)

        wrapped.__name__ = "byzantine_gradient"
        wrapped.__doc__ = user_fn.__doc__
        cls.byzantine_gradient = wrapped  # type: ignore[method-assign]

    def __init__(
        self,
        *,
        pool: Optional[ActorPool] = None,
        pool_config: Optional[ActorPoolConfig | Sequence[ActorPoolConfig]] = None,
    ) -> None:
        if type(self)._user_byzantine_gradient is None:
            raise TypeError("DistributedByzantineNode subclasses must override byzantine_gradient")
        self.app = ByzantineNodeApplication(pool=pool, pool_config=pool_config)
        keys = type(self)._byz_input_keys
        self.app.register_pipeline(
            "attack",
            ComputationGraph([
                GraphNode(
                    name="attack",
                    op=RemoteCallableOp(self._attack_entry, name="attack", cache_fn=False),
                    inputs={k: GraphInput(k) for k in keys},
                )
            ]),
            _internal=True,
        )

    def _attack_entry(self, **inputs: Any) -> Any:
        return type(self)._user_byzantine_gradient(self, **inputs)

    async def _run_attack_pipeline(self, inputs: Dict[str, Any]) -> Any:
        out = await self.app.run_pipeline("attack", inputs)
        return out["attack"]

    async def close(self) -> None:
        await self.app.close()


__all__ = ["DistributedHonestNode", "DistributedByzantineNode"]
