"""The node tier (counterpart of ``byzpy_tpu/engine/node``): node ABCs and
their actors, applications, the in-process message fabric (contexts,
routers, decentralized nodes, clusters), the process and remote contexts
(``ProcessContext``; the hub fabric ``RemoteNodeServer`` /
``RemoteClientContext``), heartbeat liveness and the distributed node
wrappers, and the serverless full-mesh TCP fabric ``MeshRemoteContext``."""

from .actors import ByzantineNodeActor, HonestNodeActor, NodeActor
from .application import ByzantineNodeApplication, HonestNodeApplication, NodeApplication
from .base import ByzantineNode, HonestNode, Node
from .cluster import DecentralizedCluster
from .context import InProcessContext, Message, NodeContext
from .decentralized import DecentralizedNode
from .distributed import DistributedByzantineNode, DistributedHonestNode
from .liveness import HeartbeatMonitor, LivenessTracker, PeerLiveness
from .mesh_context import MeshRemoteContext
from .process_context import ProcessContext
from .remote import RemoteClientContext, RemoteNodeClient, RemoteNodeServer, ServerNodeContext
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
    "MeshRemoteContext",
    "DecentralizedNode",
    "DecentralizedCluster",
    "HeartbeatMonitor",
    "LivenessTracker",
    "PeerLiveness",
    "MessageRouter",
    "ProcessContext",
    "RemoteClientContext",
    "RemoteNodeClient",
    "RemoteNodeServer",
    "ServerNodeContext",
]
