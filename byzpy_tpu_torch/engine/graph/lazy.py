"""Fluent graph builder.

Counterpart of ``byzpy_tpu/engine/graph/lazy.py`` (ref:
``byzpy/engine/graph/lazy.py:24-226``).

>>> b = GraphBuilder()
>>> out = (b.input("gradients")
...         .apply(Clipping(threshold=1.0, device="cpu"))
...         .apply(CoordinateWiseMedian(device="cpu")))
>>> graph = b.build(out)
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

from .graph import ComputationGraph, GraphInput, GraphNode
from .operator import Operator


class LazyNode:
    """Handle to a graph input or an applied operator's output."""

    def __init__(self, builder: "GraphBuilder", source: Union[str, GraphInput]) -> None:
        self._builder = builder
        self._source = source

    @property
    def source(self) -> Union[str, GraphInput]:
        return self._source

    def apply(
        self,
        op: Operator,
        *,
        input_key: Optional[str] = None,
        extra_inputs: Optional[Mapping[str, Any]] = None,
        name: Optional[str] = None,
    ) -> "LazyNode":
        return self._builder._apply(
            self, op, input_key=input_key, extra_inputs=extra_inputs, name=name
        )


class GraphBuilder:
    """Lazy graph construction: record operator calls as :class:`LazyNode` handles and materialize a ComputationGraph on build()."""
    def __init__(self) -> None:
        self._nodes: List[GraphNode] = []
        self._name_counter = itertools.count()
        self._names: set[str] = set()

    def input(self, name: str) -> LazyNode:
        return LazyNode(self, GraphInput(name))

    def _unique_name(self, base: str) -> str:
        name = base
        while name in self._names:
            name = f"{base}_{next(self._name_counter)}"
        self._names.add(name)
        return name

    def _apply(
        self,
        upstream: LazyNode,
        op: Operator,
        *,
        input_key: Optional[str],
        extra_inputs: Optional[Mapping[str, Any]],
        name: Optional[str],
    ) -> LazyNode:
        key = input_key or getattr(op, "input_key", None)
        if key is None:
            raise ValueError(
                f"operator {op.name!r} has no input_key; pass input_key= explicitly"
            )
        inputs: Dict[str, Any] = {key: upstream.source}
        for extra_key, src in (extra_inputs or {}).items():
            if isinstance(src, LazyNode):
                src = src.source
            inputs[extra_key] = src
        node_name = self._unique_name(name or op.name or f"node_{next(self._name_counter)}")
        self._nodes.append(GraphNode(name=node_name, op=op, inputs=inputs))
        return LazyNode(self, node_name)

    def build(
        self, outputs: Union[LazyNode, Sequence[LazyNode], None] = None
    ) -> ComputationGraph:
        if not self._nodes:
            raise ValueError("no operators applied; nothing to build")
        out_names: Optional[List[str]] = None
        if outputs is not None:
            if isinstance(outputs, LazyNode):
                outputs = [outputs]
            out_names = []
            for out in outputs:
                if not isinstance(out.source, str):
                    raise ValueError("graph outputs must be applied operators, not raw inputs")
                out_names.append(out.source)
        return ComputationGraph(list(self._nodes), outputs=out_names)


__all__ = ["GraphBuilder", "LazyNode"]
