"""Heterogeneous worker-actor pool.

Counterpart of ``byzpy_tpu/engine/graph/pool.py`` (ref:
``byzpy/engine/graph/pool.py:37-374``). An ``ActorPool`` owns worker
actors built from one or more ``ActorPoolConfig``s (e.g. 4 ``cuda``
actors on one card plus 2 ``thread`` actors) and schedules ``SubTask``s
onto them with capability-aware affinity, rotation, waiter futures, and
per-subtask retry.

Worker capabilities are inferred from the backend spec (``cuda`` backends
get ``{"gpu"}``; ``thread`` and ``process`` get ``{"cpu"}``, ``tcp://``
``{"cpu", "remote"}``, as in the reference) and an affinity on a subtask
(``"gpu"``/``"cpu"``) steers it to a matching worker. For the in-process
backends the subtask callable and its arguments pass by reference: a chunk
is a view of a tensor that stays on its card. For process and remote
workers the callable ships as ``pickle`` bytes (so it must pickle by
reference: the port's chunk functions are module-level) with a cache of
64 on the worker, so a hot function is unpickled once; its arguments
cross as host tensors.
"""

from __future__ import annotations

import asyncio
import itertools
import pickle
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..actor import wire
from ..actor.base import ActorRef
from ..actor.factory import resolve_backend
from .subtask import SubTask

_IN_PROCESS_SCHEMES = {"thread", "cuda"}


def _infer_capabilities(backend_spec: str) -> frozenset[str]:
    if backend_spec.startswith("cuda"):
        return frozenset({"gpu"})
    if backend_spec.startswith("tcp://"):
        return frozenset({"cpu", "remote"})
    return frozenset({"cpu"})


@dataclass(frozen=True)
class ActorPoolConfig:
    # None means "the configured default" (configs.actor.set_actor/get_actor)
    backend: Optional[str] = None
    count: int = 1
    capabilities: Optional[Sequence[str]] = None
    name: Optional[str] = None

    def resolved_backend(self) -> str:
        if self.backend is not None:
            return self.backend
        from ...configs.actor import get_actor

        return get_actor()

    def resolved_capabilities(
        self, backend: Optional[str] = None
    ) -> frozenset[str]:
        """Capabilities for ``backend`` (pass the value from one
        ``resolved_backend()`` call — resolving twice races the mutable
        config default)."""
        if self.capabilities is not None:
            return frozenset(self.capabilities)
        return _infer_capabilities(backend or self.resolved_backend())


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


class _SubTaskWorker:
    """Generic executor object constructed inside every worker backend."""

    def __init__(self) -> None:
        self._fn_cache: "OrderedDict[bytes, Any]" = OrderedDict()

    def execute(self, fn, args, kwargs):
        return fn(*args, **kwargs)

    def execute_blob(self, blob: bytes, args, kwargs):
        """Run a pickled subtask in a process or remote worker; a worker
        in a child on the card moves its host-tensor arguments there."""
        from ..actor.backends.process import current_child_device

        device = current_child_device()
        if device is not None and device != "cpu":
            args, kwargs = _to_device((args, kwargs), torch.device(device))
        fn = self._fn_cache.get(blob)
        if fn is None:
            fn = pickle.loads(blob)
            self._fn_cache[blob] = fn
            while len(self._fn_cache) > 64:
                self._fn_cache.popitem(last=False)
        else:
            self._fn_cache.move_to_end(blob)
        return fn(*args, **kwargs)


class _PoolWorker:
    def __init__(self, name: str, backend_spec: str, capabilities: frozenset[str]) -> None:
        self.name = name
        self.backend_spec = backend_spec
        self.capabilities = capabilities
        self.backend = resolve_backend(backend_spec, actor_id=name)
        self.ref = ActorRef(self.backend)
        self._in_process = self.backend.scheme in _IN_PROCESS_SCHEMES
        # id(fn) -> (fn, blob): holding fn pins the id, so a collected and
        # reallocated callable can never be served a stale blob
        self._blob_cache: "OrderedDict[int, tuple]" = OrderedDict()

    async def start(self) -> None:
        await self.backend.start()
        await self.backend.construct(_SubTaskWorker)

    async def run(self, st: SubTask) -> Any:
        if self._in_process:
            return await self.backend.call("execute", st.fn, tuple(st.args), dict(st.kwargs))
        if not st.cache_fn:
            # a stateful fn: a fresh pickle every run, so the worker sees its
            # current state (the worker's cache keys on the bytes)
            blob = wire.dumps(st.fn)
        else:
            entry = self._blob_cache.get(id(st.fn))
            if entry is not None and entry[0] is st.fn:
                blob = entry[1]
                self._blob_cache.move_to_end(id(st.fn))
            else:
                blob = wire.dumps(st.fn)
                self._blob_cache[id(st.fn)] = (st.fn, blob)
                while len(self._blob_cache) > 256:
                    self._blob_cache.popitem(last=False)
        return await self.backend.call("execute_blob", blob, tuple(st.args), dict(st.kwargs))

    async def close(self) -> None:
        await self.backend.close()


class ActorPool:
    """Pool of worker actors with affinity-aware acquisition."""

    _pool_ids = itertools.count()

    def __init__(
        self, configs: Sequence[ActorPoolConfig] | ActorPoolConfig | None = None
    ) -> None:
        if configs is None:
            configs = [ActorPoolConfig()]
        if isinstance(configs, ActorPoolConfig):
            configs = [configs]
        pool_id = next(self._pool_ids)
        self._workers: List[_PoolWorker] = []
        for ci, cfg in enumerate(configs):
            backend = cfg.resolved_backend()
            caps = cfg.resolved_capabilities(backend)
            for wi in range(cfg.count):
                base = cfg.name or f"pool{pool_id}-{backend.split('://')[0].replace(':', '_')}"
                name = f"{base}-{ci}-{wi}"
                self._workers.append(_PoolWorker(name, backend, caps))
        self._free: List[_PoolWorker] = []
        self._waiters: List[tuple[Optional[str], asyncio.Future]] = []
        self._started = False

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        if self._started:
            return
        await asyncio.gather(*(w.start() for w in self._workers))
        self._free = list(self._workers)
        self._started = True

    async def close(self) -> None:
        if not self._started:
            return
        await asyncio.gather(*(w.close() for w in self._workers), return_exceptions=True)
        self._free.clear()
        for _, fut in self._waiters:
            if not fut.done():
                fut.cancel()
        self._waiters.clear()
        self._started = False

    async def __aenter__(self) -> "ActorPool":
        await self.start()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.close()

    # -- introspection ------------------------------------------------------

    @property
    def size(self) -> int:
        return len(self._workers)

    @property
    def worker_names(self) -> List[str]:
        return [w.name for w in self._workers]

    @property
    def worker_capabilities(self) -> Dict[str, frozenset[str]]:
        return {w.name: w.capabilities for w in self._workers}

    def worker(self, name: str) -> _PoolWorker:
        for w in self._workers:
            if w.name == name:
                return w
        raise KeyError(f"no worker named {name!r}")

    def has_capability(self, capability: str) -> bool:
        return any(capability in w.capabilities for w in self._workers)

    # -- scheduling ---------------------------------------------------------

    async def run_subtask(self, st: SubTask) -> Any:
        """Run one subtask with affinity-aware placement and retry
        (ref: retry loop at ``pool.py:202-219``)."""
        if not self._started:
            raise RuntimeError("pool not started")
        attempts = max(0, int(st.max_retries)) + 1
        last_exc: BaseException | None = None
        for _ in range(attempts):
            worker = await self._acquire(st.affinity)
            try:
                return await worker.run(st)
            except asyncio.CancelledError:
                raise  # cancellation is not a retryable failure
            except BaseException as exc:  # noqa: BLE001 - retried/reported
                last_exc = exc
            finally:
                self._release(worker)
        raise last_exc  # type: ignore[misc]

    async def run_many(self, subtasks: Sequence[SubTask]) -> List[Any]:
        return list(await asyncio.gather(*(self.run_subtask(st) for st in subtasks)))

    async def _acquire(self, affinity: Optional[str]) -> _PoolWorker:
        # Only honor an affinity some worker can actually satisfy; otherwise
        # any worker may take the subtask (ref: pool.py:224-273).
        effective = affinity if affinity and self.has_capability(affinity) else None
        while True:
            for i, w in enumerate(self._free):
                if effective is None or effective in w.capabilities:
                    # rotation: take from the front, re-append on release
                    return self._free.pop(i)
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._waiters.append((effective, fut))
            worker = await fut
            if effective is None or effective in worker.capabilities:
                return worker
            # woken with a non-matching worker (race) — put it back, retry
            self._release(worker)

    def _release(self, worker: _PoolWorker) -> None:
        # drop dead waiters (e.g. cancelled by wait_for) as we scan
        self._waiters = [(aff, fut) for aff, fut in self._waiters if not fut.done()]
        for i, (aff, fut) in enumerate(self._waiters):
            if aff is None or aff in worker.capabilities:
                self._waiters.pop(i)
                fut.set_result(worker)
                return
        self._free.append(worker)

    # -- channels -----------------------------------------------------------

    async def open_channel(self, name: str) -> "ActorPoolChannel":
        """Bind a named mailbox on every worker
        (ref: ``pool.py:164-189, 334-374``)."""
        for w in self._workers:
            await w.backend.chan_open(name)
        return ActorPoolChannel(self, name)


class ActorPoolChannel:
    """Named channel spanning all pool workers: any worker (or the
    coordinator) can send to any worker's mailbox by name."""

    def __init__(self, pool: ActorPool, name: str) -> None:
        self._pool = pool
        self.name = name

    async def send(self, sender: Optional[str], recipient: str, payload: Any) -> None:
        worker = self._pool.worker(recipient)
        await worker.backend.chan_put(
            self.name, {"sender": sender, "payload": payload}
        )

    async def broadcast(self, sender: Optional[str], payload: Any) -> None:
        await asyncio.gather(
            *(
                self.send(sender, w.name, payload)
                for w in self._pool._workers
                if w.name != sender
            )
        )

    async def recv(self, worker_name: str) -> Any:
        worker = self._pool.worker(worker_name)
        return await worker.backend.chan_get(self.name)


__all__ = ["ActorPoolConfig", "ActorPool", "ActorPoolChannel"]
