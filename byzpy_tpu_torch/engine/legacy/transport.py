"""Polled mailbox transports.

Counterpart of ``byzpy_tpu/engine/legacy/transport.py``: an ABC, in-process
mailboxes over a class registry, and thread-polled TCP mailboxes. A
mailbox is the simplest endpoint: ``send(target, payload)`` delivers a
message into the target's queue; ``recv(timeout)`` polls it. No topology,
no handlers: the step-loop demos poll explicitly.

TCP frames are a 4-byte big-endian length and a standard-library
``pickle`` body (``engine.actor.wire.dumps``), so a callable crosses only
by reference. Tensors cross as host tensors (``wire.host_view``). A pickle
frame is code execution for anyone who can reach the socket: loopback or
trusted, firewalled networks only.
"""

from __future__ import annotations

import abc
import pickle
import queue
import socket
import struct
import threading
from typing import Any, ClassVar, Dict, Optional, Tuple

from ..actor.wire import dumps, host_view, warn_untrusted_bind

_HEADER = struct.Struct(">I")


class Transport(abc.ABC):
    """A mailbox endpoint."""

    name: str

    @abc.abstractmethod
    def send(self, target: str, payload: Any) -> None: ...

    @abc.abstractmethod
    def recv(self, timeout: Optional[float] = None) -> Any:
        """Next message, or raise ``queue.Empty`` on timeout."""

    @abc.abstractmethod
    def close(self) -> None: ...


class LocalMailbox(Transport):
    """In-process mailboxes over a class-level registry. A message is
    ``(sender, payload)``, the payload as it was sent."""

    _registry: ClassVar[Dict[str, "LocalMailbox"]] = {}

    def __init__(self, name: str) -> None:
        if name in self._registry:
            raise ValueError(f"mailbox {name!r} already exists")
        self.name = name
        self._q: queue.Queue = queue.Queue()
        self._registry[name] = self

    @classmethod
    def clear_registry(cls) -> None:
        cls._registry.clear()

    def send(self, target: str, payload: Any) -> None:
        box = self._registry.get(target)
        if box is None:
            raise ConnectionError(f"no mailbox {target!r}")
        box._q.put((self.name, payload))

    def recv(self, timeout: Optional[float] = None) -> Any:
        return self._q.get(timeout=timeout)

    def close(self) -> None:
        self._registry.pop(self.name, None)


class TcpMailbox(Transport):
    """Thread-polled TCP mailbox: an accept-loop thread drains
    length-prefixed pickle frames into a local queue; ``send`` opens a
    connection per message. ``peers`` maps mailbox names to ``(host,
    port)``."""

    def __init__(
        self,
        name: str,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        peers: Optional[Dict[str, Tuple[str, int]]] = None,
    ) -> None:
        warn_untrusted_bind(host, "TcpMailbox")
        self.name = name
        self.peers: Dict[str, Tuple[str, int]] = dict(peers or {})
        self._q: queue.Queue = queue.Queue()
        self._server = socket.create_server((host, port))
        self._server.settimeout(0.2)
        self.host, self.port = self._server.getsockname()[:2]
        self._closing = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def add_peer(self, name: str, address: Tuple[str, int]) -> None:
        self.peers[name] = address

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                conn, _ = self._server.accept()
            except (socket.timeout, OSError):
                continue
            # a stalled or half-open peer must not wedge the serial accept
            # loop: bound every read on this connection
            conn.settimeout(5.0)
            try:
                with conn:
                    header = _recv_exact(conn, _HEADER.size)
                    if header is None:
                        continue
                    (length,) = _HEADER.unpack(header)
                    body = _recv_exact(conn, length)
                    if body is None:
                        continue
                    self._q.put(pickle.loads(body))
            except (socket.timeout, OSError):
                continue

    def send(self, target: str, payload: Any) -> None:
        address = self.peers.get(target)
        if address is None:
            raise ConnectionError(f"no address for mailbox {target!r}")
        body = dumps((self.name, host_view(payload)))
        with socket.create_connection(address, timeout=10) as conn:
            conn.sendall(_HEADER.pack(len(body)) + body)

    def recv(self, timeout: Optional[float] = None) -> Any:
        return self._q.get(timeout=timeout)

    def close(self) -> None:
        self._closing.set()
        self._thread.join(timeout=2)
        self._server.close()


def _recv_exact(conn: socket.socket, nbytes: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < nbytes:
        chunk = conn.recv(nbytes - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


__all__ = ["Transport", "LocalMailbox", "TcpMailbox"]
