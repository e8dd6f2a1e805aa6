"""Heartbeat failure detection for the decentralized node fabric.

Counterpart of ``byzpy_tpu/engine/node/liveness.py``. Each monitor pings
its node's topology neighbours over the message plane (``ping`` / ``pong``
envelopes through :class:`~.decentralized.DecentralizedNode` messaging);
a peer that misses ``max_missed`` consecutive heartbeats is suspect, and
the callbacks carry out whatever policy the application wants
(``peer_to_peer.elastic.HeartbeatPolicy`` removes it from the gossip).
Only consecutive misses count; one pong resets the count.

The suspicion state machine, :class:`LivenessTracker`, is transport-free.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

_log = logging.getLogger(__name__)

PING = "__liveness_ping__"
PONG = "__liveness_pong__"


@dataclass
class PeerLiveness:
    """Mutable liveness record of one neighbour."""

    missed: int = 0
    suspect: bool = False
    pongs: int = 0


class LivenessTracker:
    """Transport-free suspicion bookkeeping.

    A tick: :meth:`account_pending` charges the previous tick's unanswered
    probes (a reply has the whole interval to arrive), then each peer
    probed this tick is :meth:`mark_pending`; a reply calls
    :meth:`record_reply`. ``on_suspect`` / ``on_recover`` fire once per
    transition, and an exception from one is logged, not raised."""

    def __init__(
        self,
        *,
        max_missed: int = 3,
        startup_grace: float = 0.0,
        on_suspect: Optional[Callable[[str], None]] = None,
        on_recover: Optional[Callable[[str], None]] = None,
    ) -> None:
        if max_missed < 1:
            raise ValueError(f"max_missed must be >= 1 (got {max_missed})")
        if startup_grace < 0:
            raise ValueError(f"startup_grace must be >= 0 (got {startup_grace})")
        self.max_missed = max_missed
        # a peer that has never replied is not suspected until this many
        # seconds after the start: a slow starter is not dead
        self.startup_grace = startup_grace
        self.on_suspect = on_suspect
        self.on_recover = on_recover
        self.peers: Dict[str, PeerLiveness] = {}
        self._pending: Dict[str, bool] = {}
        self._started_at: Optional[float] = None

    def start_clock(self, now: float) -> None:
        """Anchor the startup grace at ``now``."""
        self._started_at = now

    def ensure(self, peer: str) -> PeerLiveness:
        """Begin (or continue) tracking ``peer``."""
        return self.peers.setdefault(peer, PeerLiveness())

    def mark_pending(self, peer: str) -> None:
        """A probe went out to ``peer`` this tick."""
        self.ensure(peer)
        self._pending[peer] = True

    def record_reply(self, peer: str) -> None:
        """``peer`` answered: reset its misses; recovery fires on the
        suspect -> alive transition."""
        self._pending.pop(peer, None)
        rec = self.ensure(peer)
        rec.pongs += 1
        rec.missed = 0
        if rec.suspect:
            rec.suspect = False
            self._fire(self.on_recover, peer)

    def account_pending(self, now: float) -> None:
        """Charge every unanswered probe as one consecutive miss; a peer
        reaching ``max_missed`` becomes suspect."""
        in_grace = (self._started_at is not None
                    and now - self._started_at < self.startup_grace)
        for peer, rec in self.peers.items():
            if self._pending.get(peer):
                if rec.pongs == 0 and in_grace:
                    continue
                rec.missed += 1
                if rec.missed >= self.max_missed and not rec.suspect:
                    rec.suspect = True
                    self._fire(self.on_suspect, peer)

    def _fire(self, callback, peer: str) -> None:
        if callback is None:
            return
        try:
            callback(peer)
        except Exception:  # noqa: BLE001 - log, keep monitoring
            _log.exception("liveness callback failed for peer %r", peer)

    def suspects(self) -> List[str]:
        """Peers currently considered failed."""
        return sorted(p for p, r in self.peers.items() if r.suspect)

    def alive(self) -> List[str]:
        """Peers that answered at least once and are not suspect."""
        return sorted(p for p, r in self.peers.items() if r.pongs > 0 and not r.suspect)


class HeartbeatMonitor:
    """Heartbeats from one started, topology-bound node to its
    out-neighbours: ``monitor = HeartbeatMonitor(node, interval=0.05);
    await monitor.start()``."""

    def __init__(
        self,
        node,
        *,
        interval: float = 0.5,
        max_missed: int = 3,
        on_suspect: Optional[Callable[[str], None]] = None,
        on_recover: Optional[Callable[[str], None]] = None,
        startup_grace: float = 0.0,
    ) -> None:
        self.node = node
        self.interval = interval
        self.tracker = LivenessTracker(max_missed=max_missed, startup_grace=startup_grace,
                                       on_suspect=on_suspect, on_recover=on_recover)
        self._task: Optional[asyncio.Task] = None
        self._handlers_installed = False

    @property
    def peers(self) -> Dict[str, PeerLiveness]:
        return self.tracker.peers

    @property
    def max_missed(self) -> int:
        return self.tracker.max_missed

    @property
    def startup_grace(self) -> float:
        return self.tracker.startup_grace

    # -- message plumbing ---------------------------------------------------

    @staticmethod
    def install_responder(node) -> None:
        """Install the ping -> pong responder only: a node that monitors
        no one still needs it to be seen alive."""

        async def on_ping(message) -> None:
            await node.reply_message(message.sender, PONG, {})

        node.register_handler(PING, on_ping)

    def _install_handlers(self) -> None:
        self.install_responder(self.node)

        async def on_pong(message) -> None:
            self.tracker.record_reply(message.sender)

        self.node.register_handler(PONG, on_pong)

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        """Install the handlers (once) and begin the heartbeat loop."""
        if self._task is not None:
            raise RuntimeError("monitor already running; stop() first")
        if not self._handlers_installed:
            self._install_handlers()
            self._handlers_installed = True
        for peer in self._neighbor_ids():
            self.tracker.ensure(peer)
        self.tracker.start_clock(asyncio.get_running_loop().time())
        self._task = asyncio.ensure_future(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def _neighbor_ids(self) -> List[str]:
        return [peer for peer in self.node.router.out_neighbor_ids() if peer != self.node.node_id]

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            # the previous tick's unanswered pings first
            self.tracker.account_pending(loop.time())
            for peer in self._neighbor_ids():
                self.tracker.mark_pending(peer)
                try:
                    await self.node.send_message(peer, PING, {})
                except Exception:  # noqa: BLE001 - an unreachable peer stays pending
                    pass
            await asyncio.sleep(self.interval)

    # -- queries ------------------------------------------------------------

    def suspects(self) -> List[str]:
        return self.tracker.suspects()

    def alive(self) -> List[str]:
        return self.tracker.alive()


__all__ = ["HeartbeatMonitor", "LivenessTracker", "PeerLiveness", "PING", "PONG"]
