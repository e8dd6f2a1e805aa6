"""PeerToPeer: the user-facing gossip-training facade.

Counterpart of ``byzpy_tpu/engine/peer_to_peer/train.py`` (API parity:
``byzpy/engine/peer_to_peer/train.py:17-86``): honest and byzantine
workers, a robust aggregator and a topology; ``run(rounds)`` owns an
event loop, ``round()`` / ``run_async`` run inside one. Everything else
is :class:`~.runner.DecentralizedPeerToPeer`.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Dict, Optional, Sequence

from ...aggregators.base import Aggregator
from ..node.context import NodeContext
from .elastic import HeartbeatPolicy
from .nodes import ByzantineP2PWorker, HonestP2PWorker
from .runner import DecentralizedPeerToPeer
from .topology import Topology


class PeerToPeer:
    """Synchronous facade over :class:`DecentralizedPeerToPeer`::

        p2p = PeerToPeer(honest, byz, aggregator=Krum(f=1), topology=Topology.complete(5))
        p2p.run(rounds=10)        # owns its event loop
        await p2p.round()         # one round, inside a running loop
    """

    def __init__(
        self,
        honest_workers: Sequence[HonestP2PWorker],
        byzantine_workers: Sequence[ByzantineP2PWorker] = (),
        *,
        aggregator: Aggregator,
        topology: Topology,
        learning_rate: float = 0.1,
        context_factory: Optional[Callable[[str], NodeContext]] = None,
        byzantine_indices: Optional[Sequence[int]] = None,
        gossip_timeout: Optional[float] = 30.0,
        elastic: Optional[HeartbeatPolicy] = None,
    ) -> None:
        self.runner = DecentralizedPeerToPeer(
            honest_workers, byzantine_workers, aggregator=aggregator, topology=topology,
            learning_rate=learning_rate, context_factory=context_factory,
            byzantine_indices=byzantine_indices, gossip_timeout=gossip_timeout,
            elastic=elastic)

    @property
    def rounds_completed(self) -> int:
        return self.runner.rounds_completed

    # -- async API -----------------------------------------------------------

    async def round_async(self) -> Dict[int, Any]:
        return await self.runner.run_round_async()

    # the reference's name (ref: train.py:82-83), async like the original
    round = round_async

    async def run_async(self, rounds: int) -> None:
        await self.runner.run_async(rounds)

    async def remove_node(self, i: int) -> None:
        """Remove node ``i`` from the gossip mid-training
        (:meth:`DecentralizedPeerToPeer.remove_node`)."""
        await self.runner.remove_node(i)

    async def shutdown_async(self) -> None:
        await self.runner.shutdown()

    # -- sync wrapper --------------------------------------------------------

    def run(self, rounds: int) -> None:
        """Set up, run ``rounds`` rounds and shut down in one event loop
        (the in-process contexts bind their queues to the running loop)."""

        async def _go() -> None:
            async with self.runner:
                await self.runner.run_async(rounds)

        asyncio.run(_go())


__all__ = ["PeerToPeer"]
