"""Named mailbox channels and endpoints.

Counterpart of ``byzpy_tpu/engine/actor/channels.py`` (ref:
``byzpy/engine/actor/channels.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from .base import ActorBackend


@dataclass(frozen=True)
class Endpoint:
    """Addressable location of an actor: transport scheme + address + id.

    Examples: ``Endpoint("thread", "local", "a1")``,
    ``Endpoint("cuda", "cuda:0", "worker-3")``.
    """

    scheme: str
    address: str
    actor_id: str


class ChannelRef:
    """A named channel bound to one actor's mailbox.

    ``send(payload, to=endpoint)`` delivers into the *target* actor's mailbox
    of the same name (local or remote); ``recv()`` pops from this actor's own
    mailbox.
    """

    __slots__ = ("_backend", "name")

    def __init__(self, backend: "ActorBackend", name: str) -> None:
        self._backend = backend
        self.name = name

    async def send(self, payload: Any, *, to: Endpoint | None = None) -> None:
        await self._backend.chan_put(self.name, payload, endpoint=to)

    async def recv(self) -> Any:
        return await self._backend.chan_get(self.name)


async def open_channel(backend: "ActorBackend", name: str) -> ChannelRef:
    """Open (or attach to) the named channel on ``backend`` and wrap it as a :class:`ChannelRef`."""
    await backend.chan_open(name)
    return ChannelRef(backend, name)


__all__ = ["Endpoint", "ChannelRef", "open_channel"]
