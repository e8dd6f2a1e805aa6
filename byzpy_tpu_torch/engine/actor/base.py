"""Actor protocol and proxy.

Counterpart of ``byzpy_tpu/engine/actor/base.py`` (ref:
``byzpy/engine/actor/base.py:8-60``): an ``ActorBackend`` hosts one actor
(a thread, or a thread driving one CUDA card on a stream of its own),
``ActorRef`` turns attribute access into async RPC. Both backends are in
process, so tensors travel by reference: a CUDA tensor stays on its card.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

from .channels import ChannelRef, Endpoint


@runtime_checkable
class ActorBackend(Protocol):
    """Uniform async lifecycle + RPC + named-mailbox-channel interface."""

    scheme: str

    async def start(self) -> None: ...

    async def construct(self, target: Any, /, *args: Any, **kwargs: Any) -> None: ...

    async def call(self, method: str, /, *args: Any, **kwargs: Any) -> Any: ...

    async def close(self) -> None: ...

    def get_endpoint(self) -> Endpoint: ...

    async def chan_open(self, name: str) -> None: ...

    async def chan_put(self, name: str, payload: Any, *, endpoint: Endpoint | None = None) -> None: ...

    async def chan_get(self, name: str) -> Any: ...


class ActorRef:
    """Proxy whose attribute access becomes an async RPC on the backend.

    >>> ref = ActorRef(backend)
    >>> await ref.train_step(batch)     # -> backend.call("train_step", batch)

    Also an async context manager: entering starts the backend, exiting
    closes it.
    """

    __slots__ = ("_backend",)

    def __init__(self, backend: ActorBackend) -> None:
        object.__setattr__(self, "_backend", backend)

    @property
    def backend(self) -> ActorBackend:
        return self._backend

    @property
    def endpoint(self) -> Endpoint:
        return self._backend.get_endpoint()

    def channel(self, name: str) -> ChannelRef:
        return ChannelRef(self._backend, name)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        backend = self._backend

        async def _rpc(*args: Any, **kwargs: Any) -> Any:
            return await backend.call(name, *args, **kwargs)

        _rpc.__name__ = name
        return _rpc

    async def __aenter__(self) -> "ActorRef":
        await self._backend.start()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self._backend.close()


async def spawn_actor(backend: ActorBackend, target: Any, /, *args: Any, **kwargs: Any) -> ActorRef:
    """Start a backend and construct ``target(*args, **kwargs)`` in it."""
    await backend.start()
    await backend.construct(target, *args, **kwargs)
    return ActorRef(backend)


__all__ = ["ActorBackend", "ActorRef", "spawn_actor"]
