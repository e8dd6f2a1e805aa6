"""The bounded admission queue between client ingress and the cohort
scheduler, and the submission record it carries.

Counterpart of ``byzpy_tpu/serving/queue.py``. Backpressure contract:
capacity is enforced at the door — ``offer`` either enqueues or rejects
with ``queue_full``, synchronously, so a burst beyond the tier's capacity
surfaces as explicit rejections (the client retries with backoff) instead
of unbounded memory growth or an ingress stall that starves other
tenants. ``depth_high_water`` proves the bound held.

The consumer side is the cohort scheduler's window/size trigger:
``collect`` returns as soon as ``max_items`` submissions are in hand or
``window_s`` has elapsed since the round's first arrival.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Submission:
    """One admitted gradient submission.

    ``gradient`` is the flattened ``(d,)`` row, a numpy array or a tensor
    (on the card it stays there); ``round_submitted`` the model round the
    client computed against; ``arrived_s`` the admission time (monotonic
    seconds); ``seq`` the client's idempotency key; ``wal_id`` the
    write-ahead-log identity when durability is on; ``wire_inflation`` the
    compressed frame's pre-decode per-block inflation (``None`` for
    lossless submissions)."""

    client: str
    round_submitted: int
    gradient: Any
    arrived_s: float
    seq: Optional[int] = None
    wal_id: Optional[int] = None
    wire_inflation: Optional[float] = None


class AdmissionQueue:
    """Bounded asyncio FIFO of :class:`Submission` with explicit-reject
    overflow and a high-water depth gauge."""

    def __init__(self, capacity: int) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=capacity)
        self.depth_high_water = 0
        self.rejected_full = 0

    def depth(self) -> int:
        """Submissions currently queued."""
        return self._queue.qsize()

    def offer(self, sub: Submission) -> bool:
        """Enqueue or reject-at-the-door (False = queue full)."""
        try:
            self._queue.put_nowait(sub)
        except asyncio.QueueFull:
            self.rejected_full += 1
            return False
        depth = self._queue.qsize()
        if depth > self.depth_high_water:
            self.depth_high_water = depth
        return True

    def snapshot_items(self) -> Tuple[Submission, ...]:
        """Non-consuming view of everything queued right now — the
        durable-snapshot capture path, which must record pending
        submissions WITHOUT dequeuing them. (Reads the asyncio.Queue's
        internal deque; safe here because all producers/consumers run on
        the owning event loop or synchronously between its steps.)"""
        return tuple(self._queue._queue)  # noqa: SLF001 — see docstring

    def restore(self, items: Sequence[Submission]) -> None:
        """Recovery-time refill: re-enqueue previously-admitted
        submissions BYPASSING the capacity bound (they were admitted
        under the bound in a prior life, plus up to one held cohort the
        scheduler had already popped — rejecting them now would lose
        acked submissions; the next rounds drain the excess first)."""
        for sub in items:
            self._queue._queue.append(sub)  # noqa: SLF001 — see docstring
        depth = self._queue.qsize()
        if depth > self.depth_high_water:
            self.depth_high_water = depth

    def drain_nowait(self, max_items: int) -> List[Submission]:
        """Synchronously pop up to ``max_items`` queued submissions
        (possibly none) without touching the event loop — the chaos
        harness's virtual-time round closer, which replays the admission
        path deterministically and cannot block on a real clock."""
        batch: List[Submission] = []
        while len(batch) < max_items:
            try:
                batch.append(self._queue.get_nowait())
            except asyncio.QueueEmpty:
                break
        return batch

    async def collect(
        self, max_items: int, window_s: float
    ) -> List[Submission]:
        """One round's cohort: block for the first submission, then
        drain until ``max_items`` are in hand or ``window_s`` has
        elapsed since that first arrival (the window/size trigger)."""
        first = await self._queue.get()
        batch = [first]
        loop = asyncio.get_running_loop()
        deadline = loop.time() + window_s
        while len(batch) < max_items:
            # drain whatever is already queued without touching the event
            # loop — a backlogged queue fills the cohort in one pass
            # instead of paying a scheduler round-trip per submission
            try:
                while len(batch) < max_items:
                    batch.append(self._queue.get_nowait())
                break
            except asyncio.QueueEmpty:
                pass
            remaining = deadline - loop.time()
            if remaining <= 0:
                break
            try:
                batch.append(
                    await asyncio.wait_for(self._queue.get(), remaining)
                )
            except asyncio.TimeoutError:
                break
        return batch


__all__ = ["AdmissionQueue", "Submission"]
