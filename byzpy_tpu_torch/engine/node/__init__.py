"""The node tier (counterpart of ``byzpy_tpu/engine/node``): node ABCs and
their actors, applications, the in-process message fabric (contexts,
routers, decentralized nodes, clusters), heartbeat liveness and the
distributed node wrappers. The process, remote and mesh contexts come
with the process and remote backends (ROADMAP A.4)."""

from .actors import ByzantineNodeActor, HonestNodeActor, NodeActor
from .application import ByzantineNodeApplication, HonestNodeApplication, NodeApplication
from .base import ByzantineNode, HonestNode, Node
from .cluster import DecentralizedCluster
from .context import InProcessContext, Message, NodeContext
from .decentralized import DecentralizedNode
from .distributed import DistributedByzantineNode, DistributedHonestNode
from .liveness import HeartbeatMonitor, LivenessTracker, PeerLiveness
from .router import MessageRouter

__all__ = [
    "Node",
    "HonestNode",
    "ByzantineNode",
    "NodeActor",
    "HonestNodeActor",
    "ByzantineNodeActor",
    "NodeApplication",
    "HonestNodeApplication",
    "ByzantineNodeApplication",
    "DistributedHonestNode",
    "DistributedByzantineNode",
    "Message",
    "NodeContext",
    "InProcessContext",
    "DecentralizedNode",
    "DecentralizedCluster",
    "HeartbeatMonitor",
    "LivenessTracker",
    "PeerLiveness",
    "MessageRouter",
]
