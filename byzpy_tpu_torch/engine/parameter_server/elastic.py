"""Elastic membership for parameter-server rounds.

Counterpart of ``byzpy_tpu/engine/parameter_server/elastic.py``. What it
adds to the reference's PS round (``byzpy/engine/parameter_server/ps.py:
103-144``, which fails when any node raises):

* **Per-node fault isolation**: a node that raises, or exceeds
  ``call_timeout``, loses its slot for the round; its gradient is absent
  from the aggregate.
* **Suspicion and re-admission**: a failed node is suspected and skipped;
  every ``readmit_every`` rounds it is probed again (after a ``resync``
  of the authoritative state, when the policy has one) and re-admitted on
  the first success.
* **Quorum**: the round raises :class:`QuorumLostError` when fewer than
  ``min_quorum`` honest gradients arrive.
* **External suspicion**: ``external_suspects`` names nodes the fabric
  already knows are dead; they are skipped without burning a timeout.

Abandoned calls on ``cuda`` actors. A timeout abandons the awaiting
coroutine, not the actor's thread: the call runs on. Three things make
that safe. (1) The abandoned call's result is never returned to the
round: ``asyncio.wait_for`` cancels the awaiting coroutine, so nothing of
it reaches a fold or the aggregate. (2) The actor backend gave every CUDA
argument of the call ``record_stream(actor stream)`` before the call
started (``engine/actor/backends/cuda.py``), so the caching allocator
keeps that memory from any other stream until the call's work is done,
even though the round drops its references; the call's own results live
on the actor's stream and are freed there. (3) An actor runs one call at
a time, in order, on one thread and one stream, so a later probe of the
same node queues behind the leftover call and reads its node's state
after it; a probe that cannot start before its own timeout fails like
any other and the node stays suspected. A plain (sync) node object runs a
timed-out call in a daemon thread instead, and :class:`NodeBusyError`
refuses a second call into it while the first still runs.
"""

from __future__ import annotations

import asyncio
import inspect
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

MAX_EVENTS = 4096  # elastic_state.events ring size


class QuorumLostError(RuntimeError):
    """Fewer honest gradients arrived than ``ElasticPolicy.min_quorum``."""


@dataclass(frozen=True)
class ElasticPolicy:
    """Round-level elasticity knobs (state lives in :class:`ElasticState`).

    ``min_quorum``: the least count of honest gradients a round.
    ``call_timeout``: seconds a node call may take (``None``: forever).
    ``readmit_every``: probe suspects every this many rounds (0: never).
    ``external_suspects``: a callable returning ``node_id`` strings
    (``"honest:3"``) to skip outright, in the gather and the fan-out.
    ``resync``: a callable returning the current authoritative state; a
    suspect due for a probe is sent it through ``resync_method`` first and
    rejoins only when that call succeeds.
    """

    min_quorum: int = 1
    call_timeout: Optional[float] = None
    readmit_every: int = 1
    external_suspects: Optional[Callable[[], Sequence[str]]] = None
    resync: Optional[Callable[[], Any]] = None
    resync_method: str = "resync_params"

    def __post_init__(self) -> None:
        if self.min_quorum < 1:
            raise ValueError(f"min_quorum must be >= 1 (got {self.min_quorum})")
        if self.readmit_every < 0:
            raise ValueError(f"readmit_every must be >= 0 (got {self.readmit_every})")


@dataclass
class SuspectRecord:
    """Why and since when a node is out of the rotation."""

    since_round: int
    failures: int = 1
    last_error: str = ""
    probes: int = 0


@dataclass
class ElasticState:
    """Mutable suspicion bookkeeping (``ps.elastic_state``)."""

    suspects: Dict[str, SuspectRecord] = field(default_factory=dict)
    # (round, node_id, "failed" | "suspected" | "readmitted" | "resync" |
    # "skipped_external"); a bounded ring
    events: Deque[Tuple[int, str, str]] = field(default_factory=lambda: deque(maxlen=MAX_EVENTS))

    def note(self, round_no: int, node_id: str, kind: str) -> None:
        self.events.append((round_no, node_id, kind))

    def fail(self, round_no: int, node_id: str, err: BaseException) -> None:
        rec = self.suspects.get(node_id)
        msg = f"{type(err).__name__}: {err}"
        if rec is None:
            self.suspects[node_id] = SuspectRecord(since_round=round_no, last_error=msg)
            self.note(round_no, node_id, "suspected")
        else:
            rec.failures += 1
            rec.last_error = msg
        self.note(round_no, node_id, "failed")

    def readmit(self, round_no: int, node_id: str) -> None:
        if node_id in self.suspects:
            del self.suspects[node_id]
            self.note(round_no, node_id, "readmitted")

    def due_for_probe(self, node_id: str, policy: ElasticPolicy) -> bool:
        rec = self.suspects.get(node_id)
        if rec is None:
            return True
        if policy.readmit_every == 0:
            return False
        rec.probes += 1
        return rec.probes % policy.readmit_every == 0


def node_id(role: str, index: int) -> str:
    """Stable id of a PS node: its list position in its role
    (``"honest:3"`` / ``"byzantine:0"``)."""
    return f"{role}:{index}"


async def call_node(obj: Any, method: str, args: tuple = (), *,
                    timeout: Optional[float] = None) -> Any:
    """``obj.method(*args)``, awaited when it returns an awaitable: nodes
    are plain objects (sync) or actor handles (async). The one
    implementation of the PS calling convention."""
    fn = getattr(obj, method)
    if timeout is not None:
        deadline = asyncio.get_running_loop().time() + timeout
        if inspect.iscoroutinefunction(fn):
            # an actor handle's RPC: abandoning it is safe (module docstring)
            return await asyncio.wait_for(fn(*args), timeout=timeout)
        # a sync node runs off the loop, in a daemon thread, so a hung call
        # can neither block the loop nor stall the interpreter's exit
        out = await asyncio.wait_for(_call_in_daemon_thread(obj, fn, args), timeout=timeout)
        if inspect.isawaitable(out):
            # the rest of the one budget, not a fresh timeout
            remaining = deadline - asyncio.get_running_loop().time()
            out = await asyncio.wait_for(out, timeout=max(remaining, 0.0))
    else:
        out = fn(*args)
        if inspect.isawaitable(out):
            out = await out
    return out


class NodeBusyError(RuntimeError):
    """A previous, timed-out call to this node is still running: a second
    thread must not enter the node's state. The probe fails like any node
    failure and the node stays suspected."""


# node objects with a sync call still running in a daemon thread, by id()
# (the thread's bound method keeps the object alive while it is here)
_inflight_lock = threading.Lock()
_inflight_ids: set = set()


async def _call_in_daemon_thread(obj: Any, fn: Any, args: tuple) -> Any:
    loop = asyncio.get_running_loop()
    fut: asyncio.Future = loop.create_future()
    key = id(obj)
    with _inflight_lock:
        if key in _inflight_ids:
            raise NodeBusyError(f"a previous timed-out call to {fn!r} is still running; "
                                "refusing concurrent entry into the node")
        _inflight_ids.add(key)

    def _finish(setter: Any, value: Any) -> None:
        if not fut.done():
            setter(value)

    def _runner() -> None:
        try:
            res = fn(*args)
        except BaseException as exc:  # noqa: BLE001 - forwarded to the caller
            setter, payload = fut.set_exception, exc
        else:
            setter, payload = fut.set_result, res
        finally:
            with _inflight_lock:
                _inflight_ids.discard(key)
        try:
            loop.call_soon_threadsafe(_finish, setter, payload)
        except RuntimeError:
            pass  # the loop closed: nobody waits for this result any more

    try:
        threading.Thread(target=_runner, daemon=True, name="byzpy-elastic-call").start()
    except BaseException:
        with _inflight_lock:
            _inflight_ids.discard(key)
        raise
    return await fut


def _record_results(nodes: Sequence[Tuple[str, Any]], results: Sequence[Any],
                    state: ElasticState, round_no: int) -> List[Tuple[str, Any]]:
    """Fold gathered per-node outcomes into the suspicion state."""
    alive: List[Tuple[str, Any]] = []
    for (nid, _), res in zip(nodes, results, strict=True):
        if isinstance(res, BaseException):
            if isinstance(res, (KeyboardInterrupt, SystemExit)):
                raise res
            state.fail(round_no, nid, res)
        else:
            state.readmit(round_no, nid)
            alive.append((nid, res))
    return alive


async def elastic_gather(
    nodes: Sequence[Tuple[str, Any]],
    method: str,
    args: tuple,
    *,
    policy: ElasticPolicy,
    state: ElasticState,
    round_no: int,
) -> List[Tuple[str, Any]]:
    """Fan ``method`` out to ``(node_id, node)`` pairs with per-node
    isolation; returns the survivors' ``(node_id, result)`` in input
    order, suspecting failures and re-admitting suspects that succeed."""
    results = await asyncio.gather(
        *(call_node(node, method, args, timeout=policy.call_timeout) for _, node in nodes),
        return_exceptions=True)
    return _record_results(nodes, results, state, round_no)


async def elastic_settle(
    pairs: Sequence[Tuple[str, Any]],
    *,
    state: ElasticState,
    round_no: int,
) -> List[Tuple[str, Any]]:
    """Settle already dispatched per-node awaitables (the prefetch chains)
    with :func:`elastic_gather`'s isolation. No timeout here: each chained
    :func:`call_node` leg carries its own."""
    results = await asyncio.gather(*(aw for _, aw in pairs), return_exceptions=True)
    return _record_results(pairs, results, state, round_no)


__all__ = [
    "ElasticPolicy",
    "ElasticState",
    "NodeBusyError",
    "QuorumLostError",
    "SuspectRecord",
    "call_node",
    "elastic_gather",
    "elastic_settle",
    "node_id",
]
