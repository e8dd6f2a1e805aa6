"""The peer-to-peer layer (counterpart of ``byzpy_tpu/engine/peer_to_peer``):
the topology, the gossip runner and its ``PeerToPeer`` facade, the P2P
workers and the heartbeat membership policy. The fused gossip step is
``byzpy_tpu_torch.parallel.gossip``."""

from .elastic import HeartbeatPolicy
from .nodes import (
    AttackP2PWorker,
    ByzantineP2PWorker,
    FunctionP2PWorker,
    HonestP2PWorker,
    SGDModelWorker,
)
from .runner import DecentralizedPeerToPeer
from .topology import Topology
from .train import PeerToPeer

__all__ = [
    "Topology",
    "PeerToPeer",
    "DecentralizedPeerToPeer",
    "HeartbeatPolicy",
    "HonestP2PWorker",
    "ByzantineP2PWorker",
    "SGDModelWorker",
    "AttackP2PWorker",
    "FunctionP2PWorker",
]
