"""Process actor backend: an actor hosted in a spawned child process.

Counterpart of ``byzpy_tpu/engine/actor/backends/process.py``. Every frame
carries a request id and the child runs an asyncio loop, so several
requests (a blocking ``chan_get`` and a ``call``) can be in flight at once.
Frames are ``pickle`` (:mod:`..wire`: a callable crosses by reference);
tensors cross as host tensors (``wire.host_view``), and the large ones
through the shm store (:mod:`..ipc`) unless ``BYZPY_TPU_TORCH_SHM=0``
forces them inline through the pipe.

``child_device`` is ``"cuda"`` / ``"cuda:N"`` by default: the child makes
that card its current device, as an H100 admits several processes (the
reference's child runs on the CPU only because a TPU admits one). With
``"cpu"`` the child sees no card (``CUDA_VISIBLE_DEVICES`` is empty in its
environment). ``BYZPY_TPU_TORCH_CHILD_DEVICE`` overrides the argument. The
start method is always ``spawn``: a child never forks a parent that has
already initialized CUDA. Before it spawns a child for the card, the
parent builds the CUDA kernels (``ops._build.build_all``, atomic files),
so the child loads them instead of compiling them again.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import inspect
import itertools
import multiprocessing as mp
import os
import pickle
import traceback
import uuid
from typing import Any, Dict, Optional

import torch

from .. import ipc, wire
from ..channels import Endpoint
from ..router import channel_router

_counter = itertools.count()
# the device spec of this process when it is an actor's child, else None
_CHILD_DEVICE: Optional[str] = None


def current_child_device() -> Optional[str]:
    """``"cpu"`` / ``"cuda:N"`` inside a process actor's child, else ``None``."""
    return _CHILD_DEVICE


def _shm_enabled() -> bool:
    """``BYZPY_TPU_TORCH_SHM=0`` forces every payload inline through the pipe."""
    return os.environ.get("BYZPY_TPU_TORCH_SHM", "1") != "0"


def child_device_of(device: Optional[str]) -> str:
    """The child's device spec: the environment's override, else
    ``device``, else ``"cuda"``; validated."""
    spec = os.environ.get("BYZPY_TPU_TORCH_CHILD_DEVICE") or device or "cuda"
    if spec != "cpu" and spec != "cuda" and not (
            spec.startswith("cuda:") and spec.split(":", 1)[1].isdigit()):
        raise ValueError(f"child_device must be 'cpu', 'cuda' or 'cuda:N' (got {spec!r})")
    return spec


def prepare_child_device(spec: str) -> None:
    """The parent's part before it spawns a child for ``spec``: a card
    must be there, and the kernels are built once here, not in each child."""
    if spec == "cpu":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(f"child_device={spec!r} needs a CUDA card; pass child_device='cpu' "
                           "to run the child on the CPU")
    from ....ops import _build

    _build.build_all()


def spawn_env(spec: str) -> Dict[str, str]:
    """Environment entries a child for ``spec`` starts with."""
    return {"CUDA_VISIBLE_DEVICES": ""} if spec == "cpu" else {}


def start_spawned(proc, env: Dict[str, str]) -> None:
    """``proc.start()`` with ``env`` set in the environment the child
    inherits, restored afterwards."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        proc.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def enter_child_device(spec: str) -> None:  # pragma: no cover - runs in a child
    global _CHILD_DEVICE
    if spec != "cpu":
        index = int(spec.split(":", 1)[1]) if ":" in spec else 0
        torch.cuda.set_device(index)
        spec = f"cuda:{index}"
    _CHILD_DEVICE = spec


# ---------------------------------------------------------------------------
# Child-process side
# ---------------------------------------------------------------------------


def _worker_main(conn, device: str) -> None:  # pragma: no cover - runs in a child
    enter_child_device(device)
    asyncio.run(_worker_loop(conn))


async def _worker_loop(conn) -> None:  # pragma: no cover - runs in a child
    loop = asyncio.get_running_loop()
    obj_holder: Dict[str, Any] = {}
    mailboxes: Dict[str, asyncio.Queue] = {}
    send_lock = asyncio.Lock()
    stopping = asyncio.Event()

    async def reply(req_id: int, ok: bool, payload: Any) -> None:
        try:
            blob = wire.dumps((req_id, ok, payload))
        except TypeError as exc:
            blob = wire.dumps((req_id, False, (type(exc).__name__, str(exc), "")))
        async with send_lock:
            try:
                await loop.run_in_executor(None, conn.send_bytes, blob)
            except OSError:  # the parent closed the pipe: nobody to answer
                stopping.set()

    async def handle(req_id: int, op: str, data: Any) -> None:
        try:
            if op == "construct":
                target, args, kwargs = data
                args, kwargs = ipc.unwrap_payload((args, kwargs), copy=True, close=True)
                obj_holder["obj"] = target(*args, **kwargs)
                result = None
            elif op == "call":
                method, args, kwargs = data
                args, kwargs = ipc.unwrap_payload((args, kwargs), copy=True, close=True)
                obj = obj_holder.get("obj")
                if obj is None:
                    raise RuntimeError("actor not constructed")
                result = getattr(obj, method)(*args, **kwargs)
                if inspect.isawaitable(result):
                    result = await result
                result = wire.host_view(result)
            elif op == "chan_open":
                mailboxes.setdefault(data, asyncio.Queue())
                result = None
            elif op == "chan_put":
                name, payload = data
                # copy shm payloads out now: the sender unlinks its segments
                # once this request is acknowledged
                payload = ipc.unwrap_payload(payload, copy=True, close=True)
                await mailboxes.setdefault(name, asyncio.Queue()).put(payload)
                result = None
            elif op == "chan_get":
                result = await mailboxes.setdefault(data, asyncio.Queue()).get()
            elif op == "stop":
                stopping.set()
                result = None
            else:
                raise ValueError(f"unknown op {op!r}")
            await reply(req_id, True, result)
        except BaseException as exc:  # noqa: BLE001 - report to the parent
            await reply(req_id, False, (type(exc).__name__, str(exc), traceback.format_exc()))

    async def read_frames() -> None:
        while not stopping.is_set():
            try:
                blob = await loop.run_in_executor(None, conn.recv_bytes)
            except (EOFError, OSError):
                break
            req_id, op, data = pickle.loads(blob)
            asyncio.ensure_future(handle(req_id, op, data))
        stopping.set()

    reader = asyncio.ensure_future(read_frames())
    await stopping.wait()
    reader.cancel()


# ---------------------------------------------------------------------------
# Parent side
# ---------------------------------------------------------------------------


class ProcessActorBackend:
    """One spawned process an actor: pickle frames over a pipe with
    request-id correlation."""

    scheme = "process"

    def __init__(self, *, actor_id: Optional[str] = None, child_device: Optional[str] = None) -> None:
        self.actor_id = actor_id or f"proc-{next(_counter)}-{uuid.uuid4().hex[:6]}"
        self.child_device = child_device_of(child_device)
        self._proc: Optional[mp.process.BaseProcess] = None
        self._conn = None
        self._reader_task: Optional[asyncio.Task] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._req_ids = itertools.count()
        self._send_lock: Optional[asyncio.Lock] = None
        # the pipe's blocking reads and writes run on threads of the
        # backend's own: a reader blocks for the actor's lifetime, and a
        # dozen actors on the loop's default executor would take every
        # thread it has
        self._io: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._started = False

    async def start(self) -> None:
        if self._started:
            return
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, prepare_child_device, self.child_device)
        ctx = mp.get_context("spawn")
        parent_conn, child_conn = ctx.Pipe(duplex=True)
        self._proc = ctx.Process(target=_worker_main, args=(child_conn, self.child_device),
                                 daemon=True)
        start_spawned(self._proc, spawn_env(self.child_device))
        child_conn.close()
        self._conn = parent_conn
        self._send_lock = asyncio.Lock()
        self._io = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix=f"byzpy-{self.actor_id}")
        self._reader_task = asyncio.ensure_future(self._read_replies())
        channel_router.register(self.get_endpoint(), self)
        self._started = True

    async def _read_replies(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                blob = await loop.run_in_executor(self._io, self._conn.recv_bytes)
                req_id, ok, payload = pickle.loads(blob)
                fut = self._pending.pop(req_id, None)
                if fut is None or fut.done():
                    continue
                if ok:
                    fut.set_result(payload)
                else:
                    name, msg, tb = payload
                    fut.set_exception(RuntimeError(f"{name} in actor process: {msg}\n{tb}"))
        except asyncio.CancelledError:
            raise
        except BaseException as exc:  # noqa: BLE001 - fail the pending calls, never hang them
            err = exc if not isinstance(exc, (EOFError, OSError)) else None
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError(
                        f"actor process pipe closed{f': {err!r}' if err else ''}"))
            self._pending.clear()

    async def _request(self, op: str, data: Any) -> Any:
        self._ensure_started()
        if self._reader_task is not None and self._reader_task.done():
            raise ConnectionError("actor process pipe closed (reader exited)")
        req_id = next(self._req_ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        try:
            blob = wire.dumps((req_id, op, data))
        except TypeError:
            self._pending.pop(req_id, None)
            raise
        loop = asyncio.get_running_loop()
        async with self._send_lock:
            await loop.run_in_executor(self._io, self._conn.send_bytes, blob)
        return await fut

    async def construct(self, target: Any, /, *args: Any, **kwargs: Any) -> None:
        await self._shm_request("construct", target, args, kwargs)

    async def call(self, method: str, /, *args: Any, **kwargs: Any) -> Any:
        return await self._shm_request("call", method, args, kwargs)

    async def _shm_request(self, op: str, head: Any, args: Any, kwargs: Any) -> Any:
        """Large host tensors go through the shm store instead of the pipe;
        the child copies them out and unmaps, the parent unlinks after the
        reply."""
        payload = wire.host_view((args, kwargs))
        handles = []
        if _shm_enabled():
            payload, handles = ipc.wrap_payload(payload)
        try:
            return await self._request(op, (head, payload[0], payload[1]))
        finally:
            ipc.cleanup_handles(handles)

    async def close(self) -> None:
        if not self._started:
            return
        channel_router.unregister(self.get_endpoint())
        try:
            await asyncio.wait_for(self._request("stop", None), timeout=5)
        except Exception:  # noqa: BLE001 - the child may be gone already
            pass
        if self._reader_task is not None:
            self._reader_task.cancel()
        if self._conn is not None:
            self._conn.close()  # EOF ends the child's blocked recv
        proc, self._proc = self._proc, None
        io, self._io = self._io, None
        self._conn = None
        self._started = False
        if proc is not None:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, proc.join, 5)
            if proc.is_alive():
                proc.kill()
                await loop.run_in_executor(None, proc.join, 5)
        if io is not None:
            io.shutdown(wait=False)  # its reader ends with the pipe

    def get_endpoint(self) -> Endpoint:
        return Endpoint(self.scheme, "local", self.actor_id)

    async def chan_open(self, name: str) -> None:
        await self._request("chan_open", name)

    async def deliver_local(self, name: str, payload: Any) -> None:
        hosted = wire.host_view(payload)
        wrapped, handles = ipc.wrap_payload(hosted) if _shm_enabled() else (hosted, [])
        try:
            await self._request("chan_put", (name, wrapped))
        finally:
            ipc.cleanup_handles(handles)

    async def chan_put(self, name: str, payload: Any, *, endpoint: Optional[Endpoint] = None) -> None:
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
        return await self._request("chan_get", name)

    def _ensure_started(self) -> None:
        if not self._started:
            raise RuntimeError("backend not started; call start() first")


__all__ = ["ProcessActorBackend", "child_device_of", "current_child_device"]
