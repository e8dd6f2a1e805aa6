"""DecentralizedCluster: build and run a set of nodes sharing a topology.

Counterpart of ``byzpy_tpu/engine/node/cluster.py`` (parity:
``byzpy/engine/node/cluster.py:12-108``)."""

from __future__ import annotations

from typing import Dict, List

from ..peer_to_peer.topology import Topology
from .decentralized import DecentralizedNode


class DecentralizedCluster:
    """Registers nodes against one topology and shares the index -> id map,
    so every router agrees on addressing (ref: ``cluster.py:72-87``)."""

    def __init__(self, topology: Topology) -> None:
        self.topology = topology
        self._nodes: Dict[str, DecentralizedNode] = {}
        self._order: List[str] = []

    def add_node(self, node: DecentralizedNode) -> None:
        if node.node_id in self._nodes:
            raise ValueError(f"duplicate node id {node.node_id!r}")
        if len(self._nodes) >= self.topology.n_nodes:
            raise ValueError(f"topology only has {self.topology.n_nodes} slots")
        self._nodes[node.node_id] = node
        self._order.append(node.node_id)

    @property
    def nodes(self) -> Dict[str, DecentralizedNode]:
        return dict(self._nodes)

    def node_ids_map(self) -> Dict[int, str]:
        return dict(enumerate(self._order))

    def node(self, node_id: str) -> DecentralizedNode:
        return self._nodes[node_id]

    async def start_all(self) -> None:
        if len(self._nodes) != self.topology.n_nodes:
            raise RuntimeError(f"cluster has {len(self._nodes)} nodes but topology wants "
                               f"{self.topology.n_nodes}")
        ids = self.node_ids_map()
        for node in self._nodes.values():
            node.bind_topology(self.topology, ids)
        started: List[DecentralizedNode] = []
        try:
            for node in self._nodes.values():
                await node.start()
                started.append(node)
        except BaseException:
            # a partial start must not leave registry entries behind
            for node in reversed(started):
                try:
                    await node.shutdown()
                except Exception:  # noqa: BLE001 - best-effort rollback
                    pass
            raise

    async def shutdown_all(self) -> None:
        for node_id in reversed(self._order):
            await self._nodes[node_id].shutdown()

    async def __aenter__(self) -> "DecentralizedCluster":
        await self.start_all()
        return self

    async def __aexit__(self, *exc: object) -> None:
        await self.shutdown_all()


__all__ = ["DecentralizedCluster"]
