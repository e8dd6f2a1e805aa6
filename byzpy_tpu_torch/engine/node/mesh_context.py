"""MeshRemoteContext: a serverless full-mesh TCP fabric between nodes.

Counterpart of ``byzpy_tpu/engine/node/mesh_context.py`` (behaviour parity:
``byzpy/engine/node/context.py:708-1055``): every node runs its own
asyncio TCP server, dials its peers from an address book, introduces
itself with a registration handshake, sends over its outbound connection
with fallback to the peer's inbound one, and a reconnect monitor re-dials
dead peers every ``reconnect_interval``.

This is the host-level control and gossip plane between nodes (each
typically a host with its own cards), not a device mesh: bulk tensors
between cards go through ``torch.distributed`` (``parallel.collectives``).
Payloads cross as host tensors (``host_view``) in the wire's frames.

Security: a frame is a ``pickle``, which is code execution for anyone who
can reach the socket. Trusted, firewalled networks or loopback only (see
``engine.actor.wire.warn_untrusted_bind``); ``BYZPY_TPU_TORCH_WIRE_KEY``
signs every frame.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Dict, Mapping, Optional, Tuple

from ..actor.wire import host_view, recv_obj, send_obj, warn_untrusted_bind
from .context import Message, NodeContext

logger = logging.getLogger(__name__)

Address = Tuple[str, int]


class MeshRemoteContext(NodeContext):
    """Peer-to-peer TCP context: no hub, every node dials every peer.

    ``peers`` maps node ids to ``(host, port)``. A node only needs entries
    for ids it will actually send to; inbound connections from unknown
    peers are accepted and usable as reply paths.
    """

    def __init__(
        self,
        node_id: str,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        peers: Optional[Mapping[str, Address]] = None,
        reconnect_interval: float = 2.0,
    ) -> None:
        self.node_id = node_id
        self.host = host
        self.port = port
        self.peers: Dict[str, Address] = dict(peers or {})
        self.reconnect_interval = reconnect_interval
        self._node = None
        self._server: Optional[asyncio.AbstractServer] = None
        # outbound: peer_id -> (reader, writer, lock)
        self._out: Dict[str, Tuple[asyncio.StreamReader, asyncio.StreamWriter, asyncio.Lock]] = {}
        # inbound: peer_id -> (writer, lock) — reply path fallback
        self._in: Dict[str, Tuple[asyncio.StreamWriter, asyncio.Lock]] = {}
        # every inbound writer (incl. pre-handshake): must be closed on
        # shutdown or Server.wait_closed() blocks on live handlers (3.12+)
        self._inbound_writers: set = set()
        self._receive_tasks: set = set()
        self._dialing: set = set()
        self._monitor_task: Optional[asyncio.Task] = None
        self._closing = False

    # -- lifecycle -----------------------------------------------------------

    async def start(self, node) -> None:
        self._node = node
        self._closing = False
        warn_untrusted_bind(self.host, "MeshRemoteContext")
        self._server = await asyncio.start_server(
            self._handle_inbound, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        # dial whoever is already up; the monitor keeps retrying the rest
        # (peers usually start in arbitrary order)
        for peer_id in list(self.peers):
            try:
                await self._dial(peer_id)
            except OSError:
                pass
        self._monitor_task = asyncio.ensure_future(self._connection_monitor())

    async def shutdown(self) -> None:
        self._closing = True
        if self._monitor_task is not None:
            self._monitor_task.cancel()
            try:
                await self._monitor_task
            except asyncio.CancelledError:
                pass
            self._monitor_task = None
        # close every connection first: wait_closed() (3.12+) waits for all
        # connection handlers, which otherwise sit in recv until the *peer*
        # shuts down — a deadlock when peers shut down sequentially
        for _, writer, _lock in self._out.values():
            writer.close()
        self._out.clear()
        for writer in list(self._inbound_writers):
            writer.close()
        self._inbound_writers.clear()
        self._in.clear()
        for task in list(self._receive_tasks):
            task.cancel()
        for task in list(self._receive_tasks):
            try:
                await task
            except asyncio.CancelledError:
                pass
            except Exception:  # noqa: BLE001 - a handler's failure must not stop the shutdown
                logger.exception("mesh %s: receive task failed", self.node_id)
        self._receive_tasks.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self._node = None

    def add_peer(self, peer_id: str, address: Address) -> None:
        self.peers[peer_id] = address

    def connected_peers(self) -> Dict[str, str]:
        """peer_id -> "out"/"in" for currently-live connections."""
        live = {pid: "out" for pid in self._out}
        for pid in self._in:
            live.setdefault(pid, "in")
        return live

    # -- outbound ------------------------------------------------------------

    async def _dial(self, peer_id: str) -> None:
        # the dialing guard serializes monitor-vs-send races: without it two
        # concurrent dials both pass the _out check and the loser's socket
        # leaks
        if peer_id in self._out or peer_id in self._dialing or self._closing:
            return
        self._dialing.add(peer_id)
        try:
            host, port = self.peers[peer_id]
            reader, writer = await asyncio.open_connection(host, port)
            if peer_id in self._out or self._closing:
                writer.close()
                return
            # registration handshake (ref: _register_node, context.py:858-896):
            # tell the peer who we are so our inbound connection doubles as
            # their reply path
            await send_obj(writer, {"op": "hello", "node_id": self.node_id})
            self._out[peer_id] = (reader, writer, asyncio.Lock())
            task = asyncio.ensure_future(
                self._outbound_receive(peer_id, reader, writer)
            )
            self._receive_tasks.add(task)
            task.add_done_callback(self._receive_tasks.discard)
        finally:
            self._dialing.discard(peer_id)

    async def _outbound_receive(self, peer_id, reader, writer) -> None:
        """Peers may send frames back down our outbound connection."""
        try:
            while True:
                try:
                    frame = await recv_obj(reader)
                except ValueError as exc:
                    # unauthenticated/tampered frame (wire HMAC); handler
                    # errors are NOT caught here — only the decode
                    logger.warning(
                        "mesh %s: dropping outbound-recv from %s: %s",
                        self.node_id, peer_id, exc,
                    )
                    break
                await self._handle_frame(frame)
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                asyncio.CancelledError):
            pass
        finally:
            if self._out.get(peer_id, (None, None, None))[1] is writer:
                self._out.pop(peer_id, None)
            writer.close()

    async def _connection_monitor(self) -> None:
        """Re-dial dead peers (ref: context.py:898-926)."""
        while not self._closing:
            await asyncio.sleep(self.reconnect_interval)
            for peer_id in list(self.peers):
                if peer_id not in self._out:
                    try:
                        await self._dial(peer_id)
                        logger.info(
                            "mesh %s: reconnected to %s", self.node_id, peer_id
                        )
                    except OSError:
                        pass

    # -- inbound -------------------------------------------------------------

    async def _handle_inbound(self, reader, writer) -> None:
        peer_id: Optional[str] = None
        self._inbound_writers.add(writer)
        try:
            while True:
                try:
                    frame = await recv_obj(reader)
                except ValueError as exc:
                    # unauthenticated/tampered frame (wire HMAC) only
                    logger.warning(
                        "mesh %s: dropping inbound: %s", self.node_id, exc
                    )
                    break
                if frame.get("op") == "hello":
                    peer_id = frame["node_id"]
                    self._in[peer_id] = (writer, asyncio.Lock())
                else:
                    await self._handle_frame(frame)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self._inbound_writers.discard(writer)
            if peer_id is not None and self._in.get(peer_id, (None,))[0] is writer:
                self._in.pop(peer_id, None)
            writer.close()

    async def _handle_frame(self, frame: Dict[str, Any]) -> None:
        if frame.get("op") == "message" and self._node is not None:
            await self._node.handle_incoming_message(frame["message"])

    # -- sending -------------------------------------------------------------

    async def send_message(self, target_id: str, message: Message) -> None:
        """Prefer our outbound connection; fall back to the target's
        inbound one (ref: context.py:928-978). One re-dial on a dead
        outbound connection."""
        frame = {"op": "message", "message": host_view(message)}
        for attempt in (0, 1):
            conn = self._out.get(target_id)
            if conn is not None:
                _, writer, lock = conn
                try:
                    async with lock:
                        await send_obj(writer, frame)
                    return
                except (ConnectionError, OSError):
                    self._out.pop(target_id, None)
                    writer.close()
            inbound = self._in.get(target_id)
            if inbound is not None:
                writer, lock = inbound
                try:
                    async with lock:
                        await send_obj(writer, frame)
                    return
                except (ConnectionError, OSError):
                    self._in.pop(target_id, None)
                    writer.close()
            if attempt == 0 and target_id in self.peers:
                try:
                    await self._dial(target_id)
                except OSError:
                    pass
        raise ConnectionError(
            f"mesh {self.node_id!r}: no live connection to {target_id!r}"
        )


__all__ = ["MeshRemoteContext"]
