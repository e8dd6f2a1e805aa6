"""Operator protocol: the schedulable unit of a computation graph.

Counterpart of ``byzpy_tpu/engine/graph/operator.py`` (ref:
``byzpy/engine/graph/operator.py:13-220``), with the same three execution
modes:

* plain ``compute``: on the card this is usually one call over the whole
  stacked gradient matrix, a few kernel launches (the fast path);
* fan-out ``create_subtasks`` / ``reduce_subtasks``: used when a pool of
  worker actors is attached and the op opts in (feature chunks or row
  ranges of a matrix that stays on its device, host-side subset search);
* iterative ``run_barriered_subtasks``: per-iteration fan-out + barrier
  (the geometric median's and centred clipping's pool mode).
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, AsyncIterator, Iterable, Mapping, Optional, Sequence

from .subtask import SubTask

if TYPE_CHECKING:
    from .pool import ActorPool


@dataclass(frozen=True)
class OpContext:
    """Runtime metadata passed to each operator invocation."""

    node_name: str
    metadata: Mapping[str, Any] | None = None


class Operator:
    """Schedulable unit of work: a named compute with optional windowed or
    barriered subtask fan-out and pool affinity (the graph engine's common
    currency; aggregators/attacks/pre-aggregators all subclass this)."""

    name: str = "operator"
    supports_subtasks: bool = False
    supports_barriered_subtasks: bool = False
    #: max in-flight subtasks; None -> pool.size * 8; 0 -> unlimited window
    max_subtasks_inflight: int | None = None

    def compute(self, inputs: Mapping[str, Any], *, context: OpContext) -> Any:
        raise NotImplementedError

    def create_subtasks(
        self, inputs: Mapping[str, Any], *, context: OpContext
    ) -> Iterable[SubTask]:
        return []

    def reduce_subtasks(
        self,
        partials: Sequence[Any],
        inputs: Mapping[str, Any],
        *,
        context: OpContext,
    ) -> Any:
        raise RuntimeError(f"Operator {self.name} does not implement reduce_subtasks().")

    async def run_barriered_subtasks(
        self, inputs: Mapping[str, Any], *, context: OpContext, pool: "ActorPool"
    ) -> Any:
        raise RuntimeError(f"Operator {self.name} does not implement barriered subtasks.")

    async def run(
        self,
        inputs: Mapping[str, Any],
        *,
        context: OpContext,
        pool: Optional["ActorPool"],
    ) -> Any:
        if self.supports_barriered_subtasks and pool is not None:
            return await _maybe_await(
                self.run_barriered_subtasks(inputs, context=context, pool=pool)
            )

        if self.supports_subtasks and pool is not None and pool.size > 1:
            subtasks = self.create_subtasks(inputs, context=context)
            partials = await self._run_subtasks(pool, subtasks, context)
            if partials:
                return await _maybe_await(
                    self.reduce_subtasks(partials, inputs, context=context)
                )

        return await _maybe_await(self.compute(inputs, context=context))

    async def _run_subtasks(
        self,
        pool: "ActorPool",
        subtasks: Iterable[SubTask],
        context: OpContext,
    ) -> list[Any]:
        metadata = context.metadata or {}
        affinities = metadata.get("worker_affinities")
        if affinities:
            subtasks = _with_affinities(subtasks, affinities)
        limit = self.max_subtasks_inflight
        if limit is None:
            limit = pool.size * 8
        semaphore = metadata.get("subtask_semaphore")
        return await run_subtasks_windowed(pool, subtasks, limit=limit, semaphore=semaphore)


async def run_subtasks_windowed(
    pool: "ActorPool",
    subtasks: Iterable[SubTask],
    *,
    limit: int = 0,
    semaphore: asyncio.Semaphore | None = None,
) -> list[Any]:
    """Run subtasks keeping at most ``limit`` in flight (0 = unbounded).

    Results are returned in submission order. The optional shared semaphore
    bounds in-flight subtasks *across* concurrently-running operators
    (ref: sliding-window refill loop at ``operator.py:96-179``; the
    release-on-failure discipline avoids the deadlock the reference guards
    against at ``operator.py:150-163``).
    """
    results: dict[int, Any] = {}
    in_flight: set[asyncio.Task] = set()
    idx = 0

    async def launch(i: int, st: SubTask) -> None:
        if semaphore is not None:
            await semaphore.acquire()
        try:
            results[i] = await pool.run_subtask(st)
        finally:
            if semaphore is not None:
                semaphore.release()

    iterator = iter(subtasks)
    try:
        while True:
            while iterator is not None and (limit <= 0 or len(in_flight) < limit):
                try:
                    st = next(iterator)
                except StopIteration:
                    iterator = None
                    break
                task = asyncio.ensure_future(launch(idx, st))
                in_flight.add(task)
                idx += 1
            if not in_flight:
                break
            done, in_flight = await asyncio.wait(
                in_flight, return_when=asyncio.FIRST_COMPLETED
            )
            # retrieve every exception in the batch, then raise the first, so
            # siblings don't emit "exception was never retrieved" warnings
            failures = [t.exception() for t in done if t.exception() is not None]
            if failures:
                raise failures[0]
    finally:
        if in_flight:
            for t in in_flight:
                t.cancel()
            # await cancellations so a shared semaphore is fully released
            # before control returns to concurrently-running operators
            await asyncio.gather(*in_flight, return_exceptions=True)
    return [results[i] for i in range(idx)]


def _with_affinities(
    subtasks: Iterable[SubTask], affinities: Sequence[str]
) -> AsyncIterator[SubTask] | Iterable[SubTask]:
    """Round-robin worker affinity assignment for subtasks lacking one
    (ref: ``operator.py:182-196``)."""

    def gen():
        i = 0
        for st in subtasks:
            if st.affinity is None and affinities:
                st = dataclasses.replace(st, affinity=affinities[i % len(affinities)])
                i += 1
            yield st

    return gen()


class MessageTriggerOp(Operator):
    """Blocks until the scheduler delivers a message of ``message_type``,
    then returns it (optionally a single field)
    (ref: ``operator.py:199-217``). Requires a message-aware scheduler to
    inject a ``wait_for_message`` callable into metadata.
    """

    name = "message-trigger"

    def __init__(
        self, message_type: str, *, field: str | None = None, timeout: float | None = None
    ) -> None:
        self.message_type = message_type
        self.field = field
        self.timeout = timeout

    async def compute(self, inputs: Mapping[str, Any], *, context: OpContext) -> Any:
        metadata = context.metadata or {}
        wait = metadata.get("wait_for_message")
        if wait is None:
            raise RuntimeError(
                "MessageTriggerOp requires a message-aware scheduler "
                "(metadata['wait_for_message'] missing)"
            )
        message = await wait(self.message_type, timeout=self.timeout)
        if self.field is not None:
            return message[self.field]
        return message


async def _maybe_await(value: Any) -> Any:
    if inspect.isawaitable(value):
        return await value
    return value


__all__ = ["OpContext", "Operator", "MessageTriggerOp", "run_subtasks_windowed"]
