"""Node actors: training nodes hosted inside actor backends.

Counterpart of ``byzpy_tpu/engine/node/actors.py`` (API parity:
``byzpy/engine/node/actors.py:1-91``). ``HonestNodeActor.spawn`` /
``ByzantineNodeActor.spawn`` construct a node class inside a backend and
return a :class:`NodeActor` whose method calls are awaitable RPCs.
Backends: ``"thread"`` (the default); ``"cuda"`` / ``"cuda:N"``, where
the node is built and called on the actor's own stream of card N
(``engine/actor/backends/cuda.py``: the caller's stream waits on the
call's work, so a returned tensor is ready on the caller's stream);
``"process"``, a spawned child (on the card unless
``BYZPY_TPU_TORCH_CHILD_DEVICE=cpu``); and ``"tcp://host:port"``, a node
hosted by a ``RemoteActorServer``. Across a process or a socket the node
class pickles by reference and tensors cross as host tensors: a returned
gradient is a CPU tensor.
"""

from __future__ import annotations

from typing import Any, Type

from ..actor.base import ActorRef, spawn_actor
from ..actor.factory import resolve_backend
from .base import ByzantineNode, HonestNode, Node


class NodeActor:
    """Handle to a node living inside an actor backend; every public node
    method becomes an awaitable RPC::

        actor = await HonestNodeActor.spawn(MyNode, shard, backend="cuda")
        grad = await actor.honest_gradient_for_next_batch()
        await actor.apply_server_gradient(agg)
        await actor.close()
    """

    def __init__(self, ref: ActorRef, node_cls: Type[Node]) -> None:
        self._ref = ref
        self.node_cls = node_cls

    @property
    def ref(self) -> ActorRef:
        return self._ref

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._ref, name)

    async def close(self) -> None:
        await self._ref.backend.close()

    async def __aenter__(self) -> "NodeActor":
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.close()


async def _spawn(node_cls: Type[Node], *args: Any, backend: str = "thread", **kwargs: Any) -> NodeActor:
    be = resolve_backend(backend)
    ref = await spawn_actor(be, node_cls, *args, **kwargs)
    return NodeActor(ref, node_cls)


class HonestNodeActor:
    """Spawner of honest nodes (ref: ``actors.py:50-69``)."""

    @staticmethod
    async def spawn(node_cls: Type[HonestNode], *args: Any, backend: str = "thread",
                    **kwargs: Any) -> NodeActor:
        if not (isinstance(node_cls, type) and issubclass(node_cls, HonestNode)):
            raise TypeError(f"{node_cls!r} is not an HonestNode subclass")
        return await _spawn(node_cls, *args, backend=backend, **kwargs)


class ByzantineNodeActor:
    """Spawner of byzantine nodes (ref: ``actors.py:71-91``)."""

    @staticmethod
    async def spawn(node_cls: Type[ByzantineNode], *args: Any, backend: str = "thread",
                    **kwargs: Any) -> NodeActor:
        if not (isinstance(node_cls, type) and issubclass(node_cls, ByzantineNode)):
            raise TypeError(f"{node_cls!r} is not a ByzantineNode subclass")
        return await _spawn(node_cls, *args, backend=backend, **kwargs)


__all__ = ["NodeActor", "HonestNodeActor", "ByzantineNodeActor"]
