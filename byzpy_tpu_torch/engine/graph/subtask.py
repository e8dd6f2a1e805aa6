"""Schedulable unit of work.

Counterpart of ``byzpy_tpu/engine/graph/subtask.py`` (ref:
``byzpy/engine/graph/subtask.py:7-18``), kept as its own copy: the port
imports nothing of the JAX package. ``affinity`` names a capability
(``"gpu"``/``"cpu"``) so that a pool can place device work on device
actors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence


@dataclass(frozen=True)
class SubTask:
    fn: Callable[..., Any]
    args: Sequence[Any] = field(default_factory=tuple)
    kwargs: Mapping[str, Any] = field(default_factory=dict)
    name: Optional[str] = None
    affinity: Optional[str] = None
    max_retries: int = 0
    # False for fns closing over mutable state (e.g. bound methods of a
    # training node): the pool must re-serialize on every run instead of
    # caching the first pickle, or workers see frozen state forever
    cache_fn: bool = True


__all__ = ["SubTask"]
