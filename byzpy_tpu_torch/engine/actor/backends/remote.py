"""Remote TCP actor backend and the multi-actor server.

Counterpart of ``byzpy_tpu/engine/actor/backends/remote.py``: the server
hosts many actors keyed by actor id; clients construct, call and use
channels over length-prefixed ``pickle`` frames (:mod:`..wire`), tensors
as host tensors. Request ids let one connection carry overlapping
requests (a blocking ``chan_get`` never stalls a call). The wire is for
orchestration: tensors between cards move through collectives.

Security: a pickle frame is code execution for anyone who can reach the
socket. Loopback or trusted, firewalled networks only
(``wire.warn_untrusted_bind``); with ``BYZPY_TPU_TORCH_WIRE_KEY`` set,
every frame is HMAC-signed and a frame under another key drops the peer.
"""

from __future__ import annotations

import asyncio
import inspect
import itertools
import logging
import traceback
import uuid
from typing import Any, Dict, Optional

from .. import wire
from ..channels import Endpoint
from ..router import channel_router

logger = logging.getLogger(__name__)


class RemoteActorServer:
    """Hosts actors for remote clients, one instance a host process. A
    call runs on the server's event loop, on whatever device the actor
    object chose."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._actors: Dict[str, Any] = {}
        self._mailboxes: Dict[str, Dict[str, asyncio.Queue]] = {}
        self._connections: set = set()
        self._handler_tasks: set = set()

    async def start(self) -> None:
        wire.warn_untrusted_bind(self.host, "RemoteActorServer")
        self._server = await asyncio.start_server(self._on_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            # drop live connections first: Server.wait_closed() waits for
            # the connection handlers, which would sit in recv forever
            for writer in list(self._connections):
                writer.close()
            await self._server.wait_closed()
            self._server = None
        # cancel handlers parked on empty mailboxes (an abandoned chan_get)
        for task in list(self._handler_tasks):
            task.cancel()
        if self._handler_tasks:
            await asyncio.gather(*self._handler_tasks, return_exceptions=True)
        self._handler_tasks.clear()
        self._actors.clear()
        self._mailboxes.clear()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def _on_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        send_lock = asyncio.Lock()

        async def reply(req_id: Any, ok: bool, payload: Any) -> None:
            async with send_lock:
                try:
                    await wire.send_obj(writer, {"req_id": req_id, "ok": ok, "result": payload})
                except (ConnectionError, OSError):
                    pass

        async def handle(msg: Dict[str, Any]) -> None:
            req_id = msg.get("req_id")
            try:
                result = await self._dispatch(msg)
                await reply(req_id, True, wire.host_view(result))
            except BaseException as exc:  # noqa: BLE001 - reported to client
                await reply(req_id, False, (type(exc).__name__, str(exc), traceback.format_exc()))

        self._connections.add(writer)
        try:
            while True:
                msg = await wire.recv_obj(reader)
                task = asyncio.ensure_future(handle(msg))
                self._handler_tasks.add(task)
                task.add_done_callback(self._handler_tasks.discard)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except ValueError as exc:
            # an unauthenticated or tampered frame (wire HMAC): drop the peer
            logger.warning("dropping connection: %s", exc)
        finally:
            self._connections.discard(writer)
            writer.close()

    async def _dispatch(self, msg: Dict[str, Any]) -> Any:
        op = msg["op"]
        actor_id = msg.get("actor_id")
        if op == "construct":
            target, args, kwargs = msg["payload"]
            obj = target(*args, **kwargs)
            self._actors[actor_id] = obj
            self._mailboxes.setdefault(actor_id, {})
            return None
        if op == "call":
            obj = self._actors.get(actor_id)
            if obj is None:
                raise KeyError(f"unknown actor {actor_id!r}")
            method, args, kwargs = msg["payload"]
            fn = getattr(obj, method)
            result = fn(*args, **kwargs)
            if inspect.isawaitable(result):
                result = await result
            return result
        if op == "chan_open":
            self._mailboxes.setdefault(actor_id, {}).setdefault(msg["name"], asyncio.Queue())
            return None
        if op == "chan_put":
            boxes = self._mailboxes.setdefault(actor_id, {})
            await boxes.setdefault(msg["name"], asyncio.Queue()).put(msg["payload"])
            return None
        if op == "chan_get":
            boxes = self._mailboxes.setdefault(actor_id, {})
            return await boxes.setdefault(msg["name"], asyncio.Queue()).get()
        if op == "close":
            self._actors.pop(actor_id, None)
            self._mailboxes.pop(actor_id, None)
            return None
        raise ValueError(f"unknown op {op!r}")


class RemoteActorBackend:
    """Client backend: hosts its actor on a remote ``RemoteActorServer``."""

    scheme = "tcp"
    _counter = itertools.count()

    def __init__(self, host: str, port: int, *, actor_id: Optional[str] = None) -> None:
        self.host = host
        self.port = int(port)
        self.actor_id = actor_id or f"remote-{next(self._counter)}-{uuid.uuid4().hex[:6]}"
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._req_ids = itertools.count()
        self._send_lock: Optional[asyncio.Lock] = None
        self._started = False

    async def start(self) -> None:
        if self._started:
            return
        # the dial retries under the shared policy (a host still booting or
        # restarting is ridden out); a request in flight is never replayed
        from ...actor.transports.tcp import dial_policy
        from ....resilience.retry import connect_with_retry

        self._reader, self._writer = await connect_with_retry(
            self.host, self.port, policy=dial_policy(),
            component="remote_actor",
        )
        self._send_lock = asyncio.Lock()
        self._reader_task = asyncio.ensure_future(self._read_replies())
        channel_router.register(self.get_endpoint(), self)
        self._started = True

    async def _read_replies(self) -> None:
        try:
            while True:
                msg = await wire.recv_obj(self._reader)
                fut = self._pending.pop(msg.get("req_id"), None)
                if fut is None or fut.done():
                    continue
                if msg["ok"]:
                    fut.set_result(msg["result"])
                else:
                    name, text, tb = msg["result"]
                    fut.set_exception(RuntimeError(f"{name} on remote server: {text}\n{tb}"))
        except asyncio.CancelledError:
            raise
        except BaseException as exc:  # noqa: BLE001 - a reader's death fails the pending calls
            io_error = isinstance(exc, (asyncio.IncompleteReadError, ConnectionError, OSError))
            detail = "" if io_error else f": {exc!r}"
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError(f"remote actor connection lost{detail}"))
            self._pending.clear()

    async def _request(self, msg: Dict[str, Any]) -> Any:
        self._ensure_started()
        if self._reader_task is not None and self._reader_task.done():
            raise ConnectionError(
                "remote actor connection lost (reader exited); reconnect with start()"
            )
        req_id = next(self._req_ids)
        msg = {**msg, "req_id": req_id, "actor_id": self.actor_id}
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        async with self._send_lock:
            await wire.send_obj(self._writer, msg)
        return await fut

    async def construct(self, target: Any, /, *args: Any, **kwargs: Any) -> None:
        await self._request(
            {"op": "construct", "payload": (target, wire.host_view(args), wire.host_view(kwargs))}
        )

    async def call(self, method: str, /, *args: Any, **kwargs: Any) -> Any:
        return await self._request(
            {"op": "call", "payload": (method, wire.host_view(args), wire.host_view(kwargs))}
        )

    async def close(self) -> None:
        if not self._started:
            return
        channel_router.unregister(self.get_endpoint())
        try:
            await asyncio.wait_for(self._request({"op": "close"}), timeout=5)
        except Exception:
            pass
        if self._reader_task is not None:
            self._reader_task.cancel()
        if self._writer is not None:
            self._writer.close()
        self._reader = self._writer = None
        self._started = False

    def get_endpoint(self) -> Endpoint:
        return Endpoint(self.scheme, f"{self.host}:{self.port}", self.actor_id)

    async def chan_open(self, name: str) -> None:
        await self._request({"op": "chan_open", "name": name})

    async def deliver_local(self, name: str, payload: Any) -> None:
        await self._request({"op": "chan_put", "name": name, "payload": wire.host_view(payload)})

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
        return await self._request({"op": "chan_get", "name": name})

    def _ensure_started(self) -> None:
        if not self._started:
            raise RuntimeError("backend not started; call start() first")


__all__ = ["RemoteActorServer", "RemoteActorBackend"]
