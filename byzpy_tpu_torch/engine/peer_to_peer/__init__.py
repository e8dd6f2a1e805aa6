"""Peer-to-peer layer: so far the communication topology the gossip round
(:mod:`byzpy_tpu_torch.parallel.gossip`) runs on; the actor runners are
not ported yet."""

from .topology import Topology

__all__ = ["Topology"]
