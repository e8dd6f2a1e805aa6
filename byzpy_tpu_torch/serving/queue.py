"""Admitted submissions of the serving tier.

Counterpart of ``byzpy_tpu/serving/queue.py``: the :class:`Submission`
record only. The asyncio admission queue (``AdmissionQueue``) is serving
code that comes with the front end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


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


__all__ = ["Submission"]
