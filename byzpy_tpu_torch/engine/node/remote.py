"""Hub-based remote node fabric: one server hosts and routes, clients attach.

Counterpart of ``byzpy_tpu/engine/node/remote.py`` (parity:
``byzpy/engine/node/remote_server.py:15-274`` and ``remote_client.py:11-278``):
a :class:`RemoteNodeServer` hosts nodes in process (through
:class:`ServerNodeContext`) and routes frames to the nodes that connected
:class:`RemoteNodeClient`s registered; a client keeps a background receive
loop over the wire's length-prefixed ``pickle`` frames (tensors as host
tensors) and checks its connection state.

This is the control plane: frames carry pipeline triggers and small host
tensors. Security: a pickle frame is code execution for anyone who can
reach the socket; loopback or trusted, firewalled networks only
(``engine.actor.wire.warn_untrusted_bind``), and ``BYZPY_TPU_TORCH_WIRE_KEY``
signs every frame.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Dict, Optional, Tuple

from ..actor.wire import host_view, recv_obj, send_obj, warn_untrusted_bind
from .context import (
    Message,
    NodeContext,
    register_delivery_route,
    route_message,
    unregister_delivery_route,
)

logger = logging.getLogger(__name__)


class ServerNodeContext(NodeContext):
    """Context for a node hosted inside the server process
    (ref: ``remote_server.py:15-67``)."""

    def __init__(self, node_id: str, server: "RemoteNodeServer") -> None:
        self.node_id = node_id
        self._server = server
        self._node = None

    async def start(self, node) -> None:
        self._node = node
        self._server._hosted[self.node_id] = self

    async def send_message(self, target_id: str, message: Message) -> None:
        await self._server.route(target_id, message)

    async def deliver(self, message: Message) -> None:
        if self._node is not None:
            await self._node.handle_incoming_message(message)

    async def shutdown(self) -> None:
        self._server._hosted.pop(self.node_id, None)
        self._node = None


class RemoteNodeServer:
    """Asyncio TCP hub: hosts nodes and routes frames between clients.

    Frame protocol (pickle dicts over 4-byte length-prefixed frames):

    * ``{"op": "register", "node_id"}``: client announces the node living
      on its side; subsequent frames for that id go down this connection.
    * ``{"op": "send", "target_id", "message"}``: route a message.
    * ``{"op": "ping"}`` -> ``{"op": "pong"}``: liveness probe.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._hosted: Dict[str, ServerNodeContext] = {}
        # node_id -> (writer, lock) for client-registered nodes
        self._clients: Dict[str, Tuple[asyncio.StreamWriter, asyncio.Lock]] = {}
        # every live connection's writer: closed before wait_closed(), which
        # waits for every connection handler to finish
        self._conn_writers: set = set()

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        warn_untrusted_bind(self.host, "RemoteNodeServer")
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        register_delivery_route(self._delivery_route)

    async def close(self) -> None:
        unregister_delivery_route(self._delivery_route)
        self._hosted.clear()
        for writer in list(self._conn_writers):
            writer.close()
        self._conn_writers.clear()
        self._clients.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def __aenter__(self) -> "RemoteNodeServer":
        await self.start()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.close()

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def context(self, node_id: str) -> ServerNodeContext:
        """A context for hosting a node inside this server process."""
        return ServerNodeContext(node_id, self)

    # -- routing -------------------------------------------------------------

    async def route(self, target_id: str, message: Message) -> None:
        hosted = self._hosted.get(target_id)
        if hosted is not None:
            await hosted.deliver(message)
            return
        client = self._clients.get(target_id)
        if client is not None:
            writer, lock = client
            async with lock:
                await send_obj(
                    writer, {"op": "deliver", "message": host_view(message)}
                )
            return
        if not await route_message(target_id, message):
            raise ConnectionError(f"no route to node {target_id!r}")

    async def _delivery_route(self, target_id: str, message: Message) -> bool:
        """Hook into the cross-scheme delivery table for local contexts."""
        if target_id in self._hosted or target_id in self._clients:
            try:
                await self.route(target_id, message)
                return True
            except ConnectionError:
                return False
        return False

    # -- connection handling -------------------------------------------------

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        registered: Optional[str] = None
        lock = asyncio.Lock()
        self._conn_writers.add(writer)
        try:
            while True:
                try:
                    frame = await recv_obj(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                except ValueError as exc:
                    # unauthenticated/tampered frame (wire HMAC): drop peer
                    logger.warning("dropping connection: %s", exc)
                    break
                op = frame.get("op")
                rid = frame.get("rid")
                if op == "register":
                    registered = frame["node_id"]
                    self._clients[registered] = (writer, lock)
                    reply = {"op": "registered", "rid": rid}
                elif op == "send":
                    try:
                        await self.route(frame["target_id"], frame["message"])
                        reply = {"op": "ok", "rid": rid}
                    except Exception as exc:  # noqa: BLE001: report to sender
                        reply = {"op": "error", "error": repr(exc), "rid": rid}
                elif op == "ping":
                    reply = {"op": "pong", "rid": rid}
                else:
                    reply = {"op": "error", "error": f"bad op {op!r}", "rid": rid}
                async with lock:
                    await send_obj(writer, reply)
        finally:
            self._conn_writers.discard(writer)
            if registered is not None and self._clients.get(registered, (None,))[0] is writer:
                self._clients.pop(registered, None)
            writer.close()


class RemoteNodeClient:
    """Client side of the hub protocol (ref: ``remote_client.py:11-278``).

    Owns one connection: a background receive loop dispatches ``deliver``
    frames to the attached handler and resolves request/response futures
    for ``send``/``ping``.
    """

    def __init__(self, host: str, port: int, node_id: str) -> None:
        self.host = host
        self.port = port
        self.node_id = node_id
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._recv_task: Optional[asyncio.Task] = None
        # rid -> future; replies correlate by request id so a reply that
        # arrives after its request timed out is dropped, not mistaken for
        # the next request's answer
        self._pending: Dict[int, asyncio.Future] = {}
        self._next_rid = 0
        self._handler = None  # async (Message) -> None
        self._lock = asyncio.Lock()

    @property
    def is_connected(self) -> bool:
        return (
            self._writer is not None
            and not self._writer.is_closing()
            and self._recv_task is not None
            and not self._recv_task.done()
        )

    def set_handler(self, handler) -> None:
        self._handler = handler

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port
        )
        self._recv_task = asyncio.ensure_future(self._receive_loop())
        await self._request({"op": "register", "node_id": self.node_id})

    async def _dispatch(self, message: Message) -> None:
        try:
            await self._handler(message)
        except Exception:  # noqa: BLE001
            logger.exception("client %s: handler failed", self.node_id)

    async def _receive_loop(self) -> None:
        try:
            while True:
                try:
                    frame = await recv_obj(self._reader)
                except ValueError as exc:
                    # unauthenticated/tampered frame (wire HMAC) only;
                    # handler errors are logged by _dispatch, not caught here
                    logger.warning(
                        "client %s: dropping connection: %s", self.node_id, exc
                    )
                    break
                if frame.get("op") == "deliver":
                    if self._handler is not None:
                        # background task: a handler that itself sends (and
                        # thus needs the request lock) must not block this
                        # loop, or the pending request's reply never drains
                        asyncio.ensure_future(self._dispatch(frame["message"]))
                else:
                    fut = self._pending.pop(frame.get("rid"), None)
                    if fut is not None and not fut.done():
                        fut.set_result(frame)
                    # no future: the request already timed out: drop it
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("connection lost"))
            self._pending.clear()

    async def _request(self, frame: Dict[str, Any], timeout: float = 30.0) -> Dict[str, Any]:
        if self._writer is None:
            raise ConnectionError("client not connected")
        self._next_rid += 1
        rid = self._next_rid
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            async with self._lock:
                await send_obj(self._writer, {**frame, "rid": rid})
            reply = await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(rid, None)
        if reply.get("op") == "error":
            raise ConnectionError(reply["error"])
        return reply

    async def send(self, target_id: str, message: Message) -> None:
        await self._request(
            {"op": "send", "target_id": target_id, "message": host_view(message)}
        )

    async def ping(self) -> bool:
        try:
            reply = await self._request({"op": "ping"}, timeout=5.0)
            return reply.get("op") == "pong"
        except Exception:  # noqa: BLE001
            return False

    async def close(self) -> None:
        if self._recv_task is not None:
            self._recv_task.cancel()
            try:
                await self._recv_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._recv_task = None
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass
            self._writer = None


class RemoteClientContext(NodeContext):
    """Bind a local :class:`DecentralizedNode` to a hub via a client
    connection (ref: ``context.py:565-705``): inbound ``deliver`` frames ->
    the node; outbound sends -> the hub, which routes anywhere."""

    def __init__(self, node_id: str, host: str, port: int) -> None:
        self.node_id = node_id
        self._client = RemoteNodeClient(host, port, node_id)
        self._node = None

    @property
    def is_connected(self) -> bool:
        return self._client.is_connected

    async def start(self, node) -> None:
        self._node = node

        async def deliver(message: Message) -> None:
            await node.handle_incoming_message(message)

        self._client.set_handler(deliver)
        await self._client.connect()

    async def send_message(self, target_id: str, message: Message) -> None:
        await self._client.send(target_id, message)

    async def shutdown(self) -> None:
        await self._client.close()
        self._node = None


__all__ = [
    "RemoteNodeServer",
    "RemoteNodeClient",
    "RemoteClientContext",
    "ServerNodeContext",
]
