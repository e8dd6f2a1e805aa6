"""ProcessContext: run a DecentralizedNode inside a spawned child process.

Counterpart of ``byzpy_tpu/engine/node/process_context.py`` (parity:
``byzpy/engine/node/context.py:126-490``): the node is rebuilt in the child
from a pickled ``configure`` callable, commands (``stop`` /
``execute_pipeline``) travel a command queue, messages travel inbox and
outbox ``mp.Queue``s, and the parent routes child-to-child frames between
sibling contexts (and to in-process nodes through the shared delivery
table, :func:`_process_route`).

The hook is ``pickle``d, so it must pickle by reference: a module-level
function, or a ``functools.partial`` of one over picklable state (the P2P
runner's hooks are). Tensors cross as host tensors. ``child_device`` is
the process actors' (``engine.actor.backends.process``): ``"cuda"`` by
default, the child's current card, or ``"cpu"``; the start method is
``spawn`` and the parent builds the kernels before a child for the card
starts.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import multiprocessing as mp
import pickle
import queue as _queue
import uuid
from typing import Any, Callable, ClassVar, Dict, Mapping, Optional

from ..actor import wire
from ..actor.backends.process import (
    child_device_of,
    enter_child_device,
    prepare_child_device,
    spawn_env,
    start_spawned,
)
from ..actor.wire import host_view
from .context import Message, NodeContext, register_delivery_route, route_message

Configure = Callable[[Any], None]  # (DecentralizedNode) -> None, picklable

logger = logging.getLogger(__name__)


def _child_main(node_id: str, blob: bytes, inbox_q, outbox_q, cmd_q, result_q,
                device: str) -> None:  # pragma: no cover - runs in a child
    enter_child_device(device)
    asyncio.run(_child_async(node_id, blob, inbox_q, outbox_q, cmd_q, result_q))


async def _child_async(node_id, blob, inbox_q, outbox_q, cmd_q, result_q) -> None:  # pragma: no cover
    from .decentralized import DecentralizedNode

    configure, topology, node_ids = pickle.loads(blob)

    class _Bridge(NodeContext):
        """Child-side context: sends hop through the parent's router."""

        def __init__(self) -> None:
            self.node_id = node_id
            self._node = None

        async def start(self, node) -> None:
            self._node = node

        async def send_message(self, target_id: str, message: Message) -> None:
            outbox_q.put(("send", target_id, host_view(message)))

        async def shutdown(self) -> None:
            pass

    node = DecentralizedNode(node_id, _Bridge())
    if topology is not None and node_ids is not None:
        node.bind_topology(topology, node_ids)
    if configure is not None:
        configure(node)
    await node.start()

    async def _run_pipeline(req_id: str, name: str, inputs) -> None:
        try:
            result = await node.execute_pipeline(name, inputs)
            result_q.put((req_id, "ok", host_view(result)))
        except Exception as exc:  # noqa: BLE001 - report to the parent
            result_q.put((req_id, "error", repr(exc)))

    pipeline_tasks: list = []
    running = True
    while running:
        progressed = False
        try:
            msg = inbox_q.get_nowait()
        except _queue.Empty:
            msg = None
        except Exception:  # noqa: BLE001 - a frame that fails to unpickle
            logger.exception("node %s: dropping undecodable inbox frame", node_id)
            msg = None
            progressed = True
        if msg is not None:
            progressed = True
            await node.handle_incoming_message(msg)
        try:
            cmd = cmd_q.get_nowait()
            progressed = True
        except _queue.Empty:
            cmd = None
        if cmd is not None:
            if cmd[0] == "stop":
                running = False
            elif cmd[0] == "execute_pipeline":
                _, req_id, name, inputs = cmd
                # a background task, so the inbox keeps draining: a pipeline
                # may wait for traffic that still has to flow through here
                pipeline_tasks.append(asyncio.ensure_future(_run_pipeline(req_id, name, inputs)))
        pipeline_tasks = [t for t in pipeline_tasks if not t.done()]
        if not progressed:
            # the reference's 1 ms poll, without blocking the loop
            await asyncio.sleep(0.001)
    for task in pipeline_tasks:
        task.cancel()
    for task in pipeline_tasks:
        try:
            await task
        except (asyncio.CancelledError, Exception):  # noqa: BLE001
            pass
    await node.shutdown()
    result_q.put((None, "stopped", None))


class ProcessContext(NodeContext):
    """Parent-side handle of a node hosted in a child process."""

    _registry: ClassVar[Dict[str, "ProcessContext"]] = {}
    _route_registered: ClassVar[bool] = False

    def __init__(self, node_id: str, configure: Optional[Configure] = None, *,
                 child_device: Optional[str] = None) -> None:
        self.node_id = node_id
        self._configure = configure
        self.child_device = child_device_of(child_device)
        ctx = mp.get_context("spawn")
        self._inbox = ctx.Queue()
        self._outbox = ctx.Queue()
        self._cmd = ctx.Queue()
        self._result = ctx.Queue()
        self._ctx = ctx
        self._proc: Optional[mp.process.BaseProcess] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._drain_task: Optional[asyncio.Task] = None
        self._pending: Dict[str, asyncio.Future] = {}
        self._closing = False
        # the two polling readers run on threads of the context's own, not
        # on the loop's default executor (several contexts would take it)
        self._io: Optional[concurrent.futures.ThreadPoolExecutor] = None

    @classmethod
    def clear_registry(cls) -> None:
        cls._registry.clear()

    def set_configure(self, configure: Configure) -> None:
        """Install (or replace) the child-side configure hook, before
        :meth:`start`: orchestrators register their pipelines where the node
        state lives (the child), as the P2P runner does."""
        if self._proc is not None:
            raise RuntimeError("cannot set configure hook after start()")
        self._configure = configure

    async def start(self, node) -> None:
        if self.node_id in self._registry:
            raise RuntimeError(f"node id {self.node_id!r} already registered")
        if not ProcessContext._route_registered:
            register_delivery_route(_process_route)
            ProcessContext._route_registered = True
        router = node._router  # None when no topology is bound
        topology = router.topology if router is not None else None
        node_ids = router.node_ids if router is not None else None
        blob = wire.dumps((self._configure, topology, node_ids))
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, prepare_child_device, self.child_device)
        self._proc = self._ctx.Process(
            target=_child_main,
            args=(self.node_id, blob, self._inbox, self._outbox, self._cmd, self._result,
                  self.child_device),
            daemon=True,
        )
        start_spawned(self._proc, spawn_env(self.child_device))
        self._io = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix=f"byzpy-node-{self.node_id}")
        self._registry[self.node_id] = self
        self._pump_task = asyncio.ensure_future(self._pump())
        self._drain_task = asyncio.ensure_future(self._drain_results())

    async def _pump(self) -> None:
        """Route the child's outgoing frames."""
        loop = asyncio.get_running_loop()
        while True:
            frame = await loop.run_in_executor(self._io, self._queue_get, self._outbox)
            if frame is None:
                break
            if frame[0] == "send":
                _, target_id, message = frame
                target = self._registry.get(target_id)
                if target is not None:
                    target._inbox.put(message)
                elif not await route_message(target_id, message):
                    logger.warning("process node %s -> unknown target %s", self.node_id, target_id)

    def _queue_get(self, q):
        """A blocking queue read that returns None once the child is gone
        or shutdown began, so the executor thread ends."""
        while True:
            if self._closing or (self._proc is not None and not self._proc.is_alive()):
                return None
            try:
                return q.get(timeout=0.2)
            except Exception:  # noqa: BLE001 - empty: poll again
                continue

    async def _drain_results(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            frame = await loop.run_in_executor(self._io, self._queue_get, self._result)
            if frame is None:
                break
            req_id, status, payload = frame
            fut = self._pending.pop(req_id, None)
            if fut is None or fut.done():
                continue
            if status == "ok":
                fut.set_result(payload)
            else:
                fut.set_exception(RuntimeError(f"pipeline failed: {payload}"))
        # the child is gone (or shutdown began): nothing resolves the rest
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError(f"node {self.node_id!r} is no longer running"))
        self._pending.clear()

    async def remote_execute_pipeline(self, name: str, inputs: Mapping[str, Any]) -> Any:
        """Run ``execute_pipeline`` in the child (``DecentralizedNode``
        delegates to this method when its context has it)."""
        if self._proc is None or not self._proc.is_alive():
            raise ConnectionError(f"node {self.node_id!r} is not running")
        req_id = uuid.uuid4().hex
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        self._cmd.put(("execute_pipeline", req_id, name, host_view(dict(inputs))))
        return await fut

    async def send_message(self, target_id: str, message: Message) -> None:
        target = self._registry.get(target_id)
        if target is not None:
            target._inbox.put(host_view(message))
            return
        if not await route_message(target_id, host_view(message)):
            raise ConnectionError(f"node {target_id!r} is not running")

    async def shutdown(self) -> None:
        self._registry.pop(self.node_id, None)
        self._closing = True
        loop = asyncio.get_running_loop()
        if self._proc is not None:
            self._cmd.put(("stop",))
            await loop.run_in_executor(None, self._proc.join, 5)
            if self._proc.is_alive():
                self._proc.terminate()
                await loop.run_in_executor(None, self._proc.join, 5)
        # the pump and drain threads see _closing within 0.2 s
        for attr in ("_pump_task", "_drain_task"):
            task = getattr(self, attr)
            if task is not None:
                try:
                    await task
                except Exception:  # noqa: BLE001
                    pass
                setattr(self, attr, None)
        self._proc = None
        if self._io is not None:
            self._io.shutdown(wait=False)
            self._io = None
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError("node shut down"))
        self._pending.clear()


async def _process_route(target_id: str, message: Message) -> bool:
    target = ProcessContext._registry.get(target_id)
    if target is None:
        return False
    target._inbox.put(host_view(message))
    return True


__all__ = ["ProcessContext"]
