"""Process-local channel router.

Counterpart of ``byzpy_tpu/engine/actor/router.py`` (ref:
``byzpy/engine/actor/router.py``): a registry mapping ``(scheme,
actor_id) -> backend`` so a backend can deliver a channel payload to a
peer actor of another scheme without importing its module.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

if TYPE_CHECKING:
    from .base import ActorBackend
    from .channels import Endpoint


class ChannelRouter:
    """Fan-in router: forwards items from many source channels into per-destination queues by a key function."""
    def __init__(self) -> None:
        self._backends: Dict[Tuple[str, str], "ActorBackend"] = {}

    def register(self, endpoint: "Endpoint", backend: "ActorBackend") -> None:
        self._backends[(endpoint.scheme, endpoint.actor_id)] = backend

    def unregister(self, endpoint: "Endpoint") -> None:
        self._backends.pop((endpoint.scheme, endpoint.actor_id), None)

    def lookup(self, endpoint: "Endpoint") -> Optional["ActorBackend"]:
        return self._backends.get((endpoint.scheme, endpoint.actor_id))

    async def deliver(self, endpoint: "Endpoint", name: str, payload: Any) -> bool:
        """Deliver into a locally-registered peer's mailbox; False if unknown."""
        backend = self.lookup(endpoint)
        if backend is None:
            return False
        await backend.deliver_local(name, payload)  # type: ignore[attr-defined]
        return True

    def clear(self) -> None:
        self._backends.clear()


channel_router = ChannelRouter()

__all__ = ["ChannelRouter", "channel_router"]
