"""Thread actor backend: one dedicated OS thread per actor.

Counterpart of ``byzpy_tpu/engine/actor/backends/thread.py`` (ref:
``byzpy/engine/actor/backends/thread.py:14-125``): every method of the
hosted object executes on the actor's single thread, so actor state needs
no locks. Mailboxes are asyncio queues owned by the event loop. Channel
sends to peers of any local scheme route through the process-local
``channel_router``; a ``tcp`` endpoint goes over ``transports.tcp``.

:class:`ThreadActorBackend` is also the base of the ``cuda`` backend
(``backends/cuda.py``), which runs the same thread under a card and a
stream of its own.
"""

from __future__ import annotations

import asyncio
import inspect
import itertools
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

from ..channels import Endpoint
from ..router import channel_router

_counter = itertools.count()


def _invoke(fn: Callable, args: tuple, kwargs: dict) -> Any:
    """``fn(*args, **kwargs)`` on the calling thread; a coroutine function
    runs to completion there, on an event loop of its own, so the
    single-thread actor invariant holds for async methods too."""
    if inspect.iscoroutinefunction(fn):
        return asyncio.run(fn(*args, **kwargs))
    return fn(*args, **kwargs)


class ThreadActorBackend:
    """In-process backend: each actor is one thread draining its calls in
    order."""

    scheme = "thread"

    def __init__(self, *, actor_id: str | None = None) -> None:
        self.actor_id = actor_id or f"{self.scheme}-{next(_counter)}-{uuid.uuid4().hex[:6]}"
        self._executor: ThreadPoolExecutor | None = None
        self._obj: Any = None
        self._mailboxes: Dict[str, asyncio.Queue] = {}
        self._started = False

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        if self._started:
            return
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"actor-{self.actor_id}"
        )
        channel_router.register(self.get_endpoint(), self)
        self._started = True

    async def construct(self, target: Any, /, *args: Any, **kwargs: Any) -> None:
        self._ensure_started()
        loop = asyncio.get_running_loop()
        self._obj = await loop.run_in_executor(
            self._executor, self._on_actor(lambda: target(*args, **kwargs))
        )

    async def call(self, method: str, /, *args: Any, **kwargs: Any) -> Any:
        self._ensure_started()
        if self._obj is None:
            raise RuntimeError("actor not constructed")
        fn = getattr(self._obj, method)
        loop = asyncio.get_running_loop()
        result = await loop.run_in_executor(
            self._executor, self._on_actor(lambda: _invoke(fn, args, kwargs))
        )
        if inspect.isawaitable(result):
            result = await result
        return result

    def _on_actor(self, work: Callable[[], Any]) -> Callable[[], Any]:
        """What the actor's thread runs for ``work``: ``work`` itself."""
        return work

    async def close(self) -> None:
        if not self._started:
            return
        channel_router.unregister(self.get_endpoint())
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        self._obj = None
        self._started = False

    # -- endpoint & channels ------------------------------------------------

    def get_endpoint(self) -> Endpoint:
        return Endpoint(self.scheme, "local", self.actor_id)

    async def chan_open(self, name: str) -> None:
        self._mailboxes.setdefault(name, asyncio.Queue())

    async def deliver_local(self, name: str, payload: Any) -> None:
        await self._mailboxes.setdefault(name, asyncio.Queue()).put(payload)

    async def chan_put(
        self, name: str, payload: Any, *, endpoint: Optional[Endpoint] = None
    ) -> None:
        if endpoint is None or endpoint == self.get_endpoint():
            await self.deliver_local(name, payload)
            return
        if await channel_router.deliver(endpoint, name, payload):
            return
        if endpoint.scheme == "tcp":
            from ..transports import tcp

            await tcp.chan_put(endpoint, name, payload)
            return
        raise LookupError(f"no route to endpoint {endpoint}")

    async def chan_get(self, name: str) -> Any:
        queue = self._mailboxes.setdefault(name, asyncio.Queue())
        return await queue.get()

    # -- helpers ------------------------------------------------------------

    def _ensure_started(self) -> None:
        if not self._started:
            raise RuntimeError("backend not started; call start() first")


__all__ = ["ThreadActorBackend"]
