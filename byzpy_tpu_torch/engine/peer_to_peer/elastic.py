"""The default liveness -> membership policy of the gossip fabric.

Counterpart of ``byzpy_tpu/engine/peer_to_peer/elastic.py``.
``PeerToPeer(..., elastic=HeartbeatPolicy(interval=0.5, max_missed=3))``:
on ``setup()`` the runner installs ping responders on every node, starts
one :class:`~byzpy_tpu_torch.engine.node.liveness.HeartbeatMonitor` on
the observer node (default: the first honest index) and removes any peer
the monitor declares suspect. What the policy did lands in
``runner.elastic_events`` as ``(peer_id, outcome)`` pairs. The observer
watches its own gossip neighbourhood only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class HeartbeatPolicy:
    """Knobs of the suspect -> remove loop: ``interval`` seconds between
    heartbeat ticks, ``max_missed`` consecutive unanswered pings before a
    peer is removed, the ``observer`` node index (``None``: the first
    honest one), and ``startup_grace`` seconds during which a peer that
    never answered is not suspected."""

    interval: float = 0.5
    max_missed: int = 3
    observer: Optional[int] = None
    startup_grace: float = 30.0

    def __post_init__(self) -> None:
        if self.interval <= 0:
            raise ValueError(f"interval must be > 0 (got {self.interval})")
        if self.max_missed < 1:
            raise ValueError(f"max_missed must be >= 1 (got {self.max_missed})")
        if self.startup_grace < 0:
            raise ValueError(f"startup_grace must be >= 0 (got {self.startup_grace})")


__all__ = ["HeartbeatPolicy"]
