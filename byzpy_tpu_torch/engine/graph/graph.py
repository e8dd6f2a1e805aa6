"""Computation DAG.

Counterpart of ``byzpy_tpu/engine/graph/graph.py`` (ref:
``byzpy/engine/graph/graph.py:23-128``). Nodes wrap operators; edges are
declared per node as an ``inputs`` mapping from the operator's input key
to a ``GraphInput`` (application-supplied value), another node's name
(string), or a ``MessageSource`` (resolved by a message-aware scheduler).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, Iterable, List, Mapping, Optional, Sequence, Set, Union

from .operator import Operator

if TYPE_CHECKING:
    from .scheduler import MessageSource


@dataclass(frozen=True)
class GraphInput:
    """Opaque reference to data supplied by the application layer."""

    name: str

    @classmethod
    def from_message(
        cls,
        message_type: str,
        field: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> "MessageSource":
        from .scheduler import MessageSource

        return MessageSource(message_type=message_type, field=field, timeout=timeout)


def graph_input(name: str) -> GraphInput:
    """Shorthand constructor for a named :class:`GraphInput` placeholder."""
    return GraphInput(name)


@dataclass(frozen=True)
class GraphNode:
    name: str
    op: Operator
    inputs: Mapping[str, Union[str, GraphInput, "MessageSource"]] = field(default_factory=dict)


class ComputationGraph:
    """A DAG of named operator nodes with deterministic topological order."""

    def __init__(
        self,
        nodes: Sequence[GraphNode],
        *,
        outputs: Optional[Sequence[str]] = None,
    ) -> None:
        if not nodes:
            raise ValueError("graph requires at least one node")
        names = [n.name for n in nodes]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate node names: {dupes}")
        self._nodes: Dict[str, GraphNode] = {n.name: n for n in nodes}
        self._order: List[str] = self._topo_sort(nodes)
        if outputs is None:
            outputs = [self._order[-1]]
        unknown = [o for o in outputs if o not in self._nodes]
        if unknown:
            raise ValueError(f"unknown output nodes: {unknown}")
        self.outputs: List[str] = list(outputs)

    # -- structure ----------------------------------------------------------

    @property
    def nodes(self) -> Mapping[str, GraphNode]:
        return self._nodes

    def node(self, name: str) -> GraphNode:
        return self._nodes[name]

    def nodes_in_order(self) -> Iterable[GraphNode]:
        return (self._nodes[name] for name in self._order)

    def dependencies(self, name: str) -> Set[str]:
        """Names of graph nodes this node consumes."""
        return {
            src
            for src in self._nodes[name].inputs.values()
            if isinstance(src, str) and src in self._nodes
        }

    def required_inputs(self) -> Set[str]:
        """Names of ``GraphInput``s the application must supply."""
        required: Set[str] = set()
        for node in self._nodes.values():
            for src in node.inputs.values():
                if isinstance(src, GraphInput):
                    required.add(src.name)
                elif isinstance(src, str) and src not in self._nodes:
                    raise ValueError(
                        f"node {node.name!r} references unknown node {src!r}"
                    )
        return required

    # -- topo ---------------------------------------------------------------

    def _topo_sort(self, nodes: Sequence[GraphNode]) -> List[str]:
        known = {n.name for n in nodes}
        indegree: Dict[str, int] = {n.name: 0 for n in nodes}
        consumers: Dict[str, List[str]] = {n.name: [] for n in nodes}
        for node in nodes:
            for src in node.inputs.values():
                if isinstance(src, str) and src in known:
                    indegree[node.name] += 1
                    consumers[src].append(node.name)
        # Kahn's algorithm; insertion order keeps it deterministic.
        ready = [name for name, deg in indegree.items() if deg == 0]
        order: List[str] = []
        while ready:
            name = ready.pop(0)
            order.append(name)
            for consumer in consumers[name]:
                indegree[consumer] -= 1
                if indegree[consumer] == 0:
                    ready.append(consumer)
        if len(order) != len(nodes):
            cyclic = sorted(name for name, deg in indegree.items() if deg > 0)
            raise ValueError(f"graph contains a cycle involving: {cyclic}")
        return order


__all__ = ["GraphInput", "graph_input", "GraphNode", "ComputationGraph"]
