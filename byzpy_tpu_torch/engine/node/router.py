"""Topology-constrained message routing between decentralized nodes.

Counterpart of ``byzpy_tpu/engine/node/router.py`` (behavior parity:
``byzpy/engine/node/router.py:1-260``): direct sends are checked against
the topology's edges, a broadcast goes to the node's out-neighbours and
tolerates per-neighbour failures, and a reply skips the check (a node may
always answer who spoke to it).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterable, List

from ..peer_to_peer.topology import Topology

logger = logging.getLogger(__name__)


class MessageRouter:
    """Routes one node's messages over a shared :class:`Topology`;
    ``node_ids`` maps topology indices ``0..n-1`` to string ids."""

    def __init__(self, node_id: str, topology: Topology, node_ids: Dict[int, str], send_fn) -> None:
        self.node_id = node_id
        self.topology = topology
        self._idx_to_id = dict(node_ids)
        self._id_to_idx = {v: k for k, v in self._idx_to_id.items()}
        if node_id not in self._id_to_idx:
            raise ValueError(f"node id {node_id!r} not in node_ids map")
        self._send_fn = send_fn  # async (target_id, message) -> None

    @property
    def index(self) -> int:
        return self._id_to_idx[self.node_id]

    @property
    def node_ids(self) -> Dict[int, str]:
        """The shared index -> id map (a copy)."""
        return dict(self._idx_to_id)

    def out_neighbor_ids(self) -> List[str]:
        return [self._idx_to_id[i] for i in self.topology.out_neighbors(self.index)]

    def in_neighbor_ids(self) -> List[str]:
        return [self._idx_to_id[i] for i in self.topology.in_neighbors(self.index)]

    def _check_edge(self, target_id: str) -> None:
        tgt = self._id_to_idx.get(target_id)
        if tgt is None:
            raise ValueError(f"unknown node id {target_id!r}")
        if (self.index, tgt) not in self.topology.edges:
            raise ValueError(f"topology forbids {self.node_id!r} -> {target_id!r}")

    async def route_direct(self, target_id: str, message: Any) -> None:
        self._check_edge(target_id)
        await self._send_fn(target_id, message)

    async def route_reply(self, target_id: str, message: Any) -> None:
        """Replies skip the topology check."""
        if target_id not in self._id_to_idx:
            raise ValueError(f"unknown node id {target_id!r}")
        await self._send_fn(target_id, message)

    async def route_broadcast(self, message: Any) -> List[str]:
        """Send to every out-neighbour; a failed send is logged and
        skipped. Returns the ids reached."""
        reached = []
        for target_id in self.out_neighbor_ids():
            try:
                await self._send_fn(target_id, message)
                reached.append(target_id)
            except Exception as exc:  # noqa: BLE001 - a broadcast goes on
                logger.warning("broadcast %s -> %s failed: %s", self.node_id, target_id, exc)
        return reached

    async def route_multicast(self, target_ids: Iterable[str], message: Any) -> None:
        for target_id in target_ids:
            await self.route_direct(target_id, message)


__all__ = ["MessageRouter"]
