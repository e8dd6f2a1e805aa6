"""Convenience operators.

Counterpart of ``byzpy_tpu/engine/graph/ops.py`` (ref:
``byzpy/engine/graph/ops.py:10-92``)."""

from __future__ import annotations

import inspect
from typing import Any, Callable, Mapping, Optional

from .graph import ComputationGraph, GraphInput, GraphNode
from .operator import OpContext, Operator
from .subtask import SubTask


class CallableOp(Operator):
    """Wraps a plain (sync or async) callable as an inline operator.

    The callable receives the node's resolved inputs as keyword arguments.
    """

    def __init__(self, fn: Callable[..., Any], *, name: Optional[str] = None) -> None:
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "callable-op")

    async def compute(self, inputs: Mapping[str, Any], *, context: OpContext) -> Any:
        result = self.fn(**inputs)
        if inspect.isawaitable(result):
            result = await result
        return result


class RemoteCallableOp(Operator):
    """Runs a callable as a single subtask on the pool (one worker hop)."""

    supports_subtasks = True

    def __init__(
        self,
        fn: Callable[..., Any],
        *,
        name: Optional[str] = None,
        affinity: Optional[str] = None,
        max_retries: int = 0,
        cache_fn: bool = True,
    ) -> None:
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "remote-callable-op")
        self.affinity = affinity
        self.max_retries = max_retries
        self.cache_fn = cache_fn

    def create_subtasks(self, inputs: Mapping[str, Any], *, context: OpContext):
        yield SubTask(
            fn=self.fn,
            kwargs=dict(inputs),
            name=self.name,
            affinity=self.affinity,
            max_retries=self.max_retries,
            cache_fn=self.cache_fn,
        )

    def reduce_subtasks(self, partials, inputs, *, context: OpContext) -> Any:
        return partials[0]

    async def compute(self, inputs: Mapping[str, Any], *, context: OpContext) -> Any:
        # no pool (or single worker): run inline
        result = self.fn(**inputs)
        if inspect.isawaitable(result):
            result = await result
        return result


def make_single_operator_graph(
    op: Operator,
    *,
    input_keys: Optional[Mapping[str, str]] = None,
    node_name: str = "op",
) -> ComputationGraph:
    """Wrap one operator into a one-node graph. ``input_keys`` maps the
    operator's input keys to application input names (defaults to identity
    on ``op.input_key`` when present)."""
    if input_keys is None:
        key = getattr(op, "input_key", None)
        input_keys = {key: key} if key else {}
    inputs = {k: GraphInput(v) for k, v in input_keys.items()}
    return ComputationGraph([GraphNode(name=node_name, op=op, inputs=inputs)])


__all__ = ["CallableOp", "RemoteCallableOp", "make_single_operator_graph"]
