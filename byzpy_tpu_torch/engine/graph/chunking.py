"""Adaptive chunk sizing for subtask fan-out.

Counterpart of ``byzpy_tpu/engine/graph/chunking.py``, the reference
heuristic (ref: ``byzpy/aggregators/_chunking.py:41-72``): keep at least
``min_per_worker`` chunks per pool worker so the window pipeline stays
full, but never shrink the configured chunk below ``configured /
max_shrink``. Environment overrides, under the port's own names:
``BYZPY_TPU_TORCH_CHUNK_MIN_PER_WORKER``,
``BYZPY_TPU_TORCH_CHUNK_MAX_SHRINK``,
``BYZPY_TPU_TORCH_CHUNK_TARGET_FACTOR``.
"""

from __future__ import annotations

import math
import os


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def select_adaptive_chunk_size(
    total: int,
    configured: int,
    *,
    pool_size: int = 0,
    min_per_worker: int | None = None,
    max_shrink: int | None = None,
    target_factor: int | None = None,
) -> int:
    """Pick a chunk size for splitting ``total`` items across a pool."""
    if total <= 0 or configured <= 0:
        return max(1, configured)
    if pool_size <= 1:
        return configured

    if min_per_worker is None:
        min_per_worker = _env_int("BYZPY_TPU_TORCH_CHUNK_MIN_PER_WORKER", 4)
    if max_shrink is None:
        max_shrink = _env_int("BYZPY_TPU_TORCH_CHUNK_MAX_SHRINK", 8)
    if target_factor is None:
        target_factor = _env_int("BYZPY_TPU_TORCH_CHUNK_TARGET_FACTOR", 1)
    min_per_worker = max(1, min_per_worker)

    target_chunks = pool_size * min_per_worker * max(1, target_factor)
    ideal = max(1, math.ceil(total / target_chunks))
    floor = max(1, configured // max(1, max_shrink))
    return max(floor, min(configured, ideal))


def pool_size_from_context(context) -> int:
    """Worker count the scheduler injected into operator metadata (0 when
    running without a pool); the one source of every chunked operator's
    adaptive sizing."""
    metadata = getattr(context, "metadata", None) or {}
    return int(metadata.get("pool_size") or 0)


__all__ = ["select_adaptive_chunk_size", "pool_size_from_context"]
