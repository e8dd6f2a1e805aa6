"""Node execution contexts: where a :class:`DecentralizedNode` runs and how
its messages travel.

Counterpart of ``byzpy_tpu/engine/node/context.py`` (parity:
``byzpy/engine/node/context.py:11-123``). A context owns ``start`` /
``send_message`` / ``shutdown`` and delivers inbound messages to its node.
:class:`InProcessContext` simulates a whole cluster in one event loop
through a class-level registry.

Payloads travel by reference: a message's tensor, on the CPU or a card,
is the very object the sender passed, and :meth:`DecentralizedNode.
broadcast_message` hands one message to every neighbour. A sender must
therefore never update a tensor in place after sending it
(``peer_to_peer.nodes.SGDModelWorker`` replaces its vector every step).

Mixed clusters route through :func:`register_delivery_route`: a context
whose own registry does not know the target tries each registered
``async (target_id, message) -> delivered?`` hook. The delivery routes
and ``InProcessContext``'s registry are module state: tests clear both
between cases (:meth:`InProcessContext.clear_registry`). The process
context (``process_context.py``) and the hub fabric (``remote.py``) plug
in through the same routes; the mesh context belongs to ROADMAP A.7.
"""

from __future__ import annotations

import abc
import asyncio
import logging
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Awaitable, Callable, ClassVar, Dict, List, Optional

if TYPE_CHECKING:  # pragma: no cover
    from .decentralized import DecentralizedNode


@dataclass(frozen=True)
class Message:
    """Envelope of inter-node traffic."""

    type: str
    sender: str
    payload: Any = None
    metadata: Dict[str, Any] = field(default_factory=dict)


# -- cross-scheme routing ----------------------------------------------------

DeliveryRoute = Callable[[str, Message], Awaitable[bool]]
_delivery_routes: List[DeliveryRoute] = []


def register_delivery_route(route: DeliveryRoute) -> None:
    """Register a hook ``async (target_id, message) -> delivered?``, tried
    by any context whose own registry does not know the target."""
    if route not in _delivery_routes:
        _delivery_routes.append(route)


def unregister_delivery_route(route: DeliveryRoute) -> None:
    """Remove a registered hook (no-op when absent)."""
    try:
        _delivery_routes.remove(route)
    except ValueError:
        pass


async def route_message(target_id: str, message: Message) -> bool:
    """Deliver ``message`` to ``target_id`` through the registered routes;
    False when none knows it."""
    for route in _delivery_routes:
        if await route(target_id, message):
            return True
    return False


class NodeContext(abc.ABC):
    """Transport binding of one node."""

    node_id: str

    @abc.abstractmethod
    async def start(self, node: "DecentralizedNode") -> None:
        """Attach the node and begin delivering inbound messages to it."""

    @abc.abstractmethod
    async def send_message(self, target_id: str, message: Message) -> None: ...

    @abc.abstractmethod
    async def shutdown(self) -> None: ...


class InProcessContext(NodeContext):
    """Every node in one event loop; the class-level registry is the
    network (ref: ``context.py:56-123``)."""

    _registry: ClassVar[Dict[str, "InProcessContext"]] = {}

    def __init__(self, node_id: str, *, queue_size: int = 1024) -> None:
        self.node_id = node_id
        self._queue: asyncio.Queue[Optional[Message]] = asyncio.Queue(queue_size)
        self._task: Optional[asyncio.Task] = None
        self._node: Optional["DecentralizedNode"] = None

    @classmethod
    def clear_registry(cls) -> None:
        cls._registry.clear()

    async def start(self, node: "DecentralizedNode") -> None:
        if self.node_id in self._registry:
            raise RuntimeError(f"node id {self.node_id!r} already registered")
        self._node = node
        self._registry[self.node_id] = self
        self._task = asyncio.ensure_future(self._pump())

    async def _pump(self) -> None:
        while True:
            msg = await self._queue.get()
            if msg is None:
                break
            try:
                await self._node.handle_incoming_message(msg)
            except Exception:  # noqa: BLE001 - a bad handler must not kill the pump
                logging.getLogger(__name__).exception(
                    "node %s: message handler failed", self.node_id)

    async def send_message(self, target_id: str, message: Message) -> None:
        target = self._registry.get(target_id)
        if target is not None:
            await target._queue.put(message)
            return
        if not await route_message(target_id, message):
            raise ConnectionError(f"node {target_id!r} is not running")

    async def shutdown(self) -> None:
        self._registry.pop(self.node_id, None)
        if self._task is not None:
            await self._queue.put(None)
            await self._task
            self._task = None


async def _in_process_route(target_id: str, message: Message) -> bool:
    target = InProcessContext._registry.get(target_id)
    if target is None:
        return False
    await target._queue.put(message)
    return True


register_delivery_route(_in_process_route)


__all__ = [
    "Message",
    "NodeContext",
    "InProcessContext",
    "register_delivery_route",
    "route_message",
    "unregister_delivery_route",
]
