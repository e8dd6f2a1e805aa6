"""Operator protocol: the schedulable unit of a computation graph.

Counterpart of ``byzpy_tpu/engine/graph/operator.py:29-80`` (ref:
``byzpy/engine/graph/operator.py:13-220``): ``compute`` and the subtask
hooks' signatures. Aggregators, pre-aggregators and attacks are all
operators. The actor pools that run subtasks are not ported yet, so
:meth:`Operator.run` runs ``compute`` and raises ``NotImplementedError``
when it is handed a pool; no class sets ``supports_subtasks``. The
pools' scheduling members (the in-flight window, barriered subtasks)
come with them.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Iterable, Mapping, Optional, Sequence

from .subtask import SubTask


@dataclass(frozen=True)
class OpContext:
    """Runtime metadata passed to each operator invocation."""

    node_name: str
    metadata: Mapping[str, Any] | None = None


class Operator:
    """Schedulable unit of work: a named compute with optional subtask
    fan-out (aggregators, attacks and pre-aggregators subclass it)."""

    name: str = "operator"
    supports_subtasks: bool = False

    def compute(self, inputs: Mapping[str, Any], *, context: OpContext) -> Any:
        raise NotImplementedError

    def create_subtasks(
        self, inputs: Mapping[str, Any], *, context: OpContext
    ) -> Iterable[SubTask]:
        return []

    def reduce_subtasks(
        self,
        partials: Sequence[Any],
        inputs: Mapping[str, Any],
        *,
        context: OpContext,
    ) -> Any:
        raise RuntimeError(f"Operator {self.name} does not implement reduce_subtasks().")

    async def run(
        self,
        inputs: Mapping[str, Any],
        *,
        context: OpContext,
        pool: Optional[Any],
    ) -> Any:
        if pool is not None:
            raise NotImplementedError(
                f"Operator {self.name}: actor pools are not ported yet; run with pool=None"
            )
        value = self.compute(inputs, context=context)
        if inspect.isawaitable(value):
            return await value
        return value


__all__ = ["OpContext", "Operator"]
