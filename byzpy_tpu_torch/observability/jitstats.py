"""Program-build observability: count the programs each dispatch site
built.

Counterpart of ``byzpy_tpu/observability/jitstats.py``. The reference
counts XLA compiles (jit-cache growth) per site; PyTorch runs eagerly and
has no jit cache, so the port counts what it does build: a
:class:`~byzpy_tpu_torch.serving.ragged.RaggedExecutor`'s programs
(``expected_compiles()``: the dense one plus one per wire spec) and the
CUDA graphs a :class:`~byzpy_tpu_torch.utils.cuda_graph.CapturedStep`
captured (one per signature), read by :func:`programs_built`. The round
loops that own them call :func:`note_cache_size` with that count after
each dispatch; growth since the last observation increments
``byzpy_jit_compiles_total{site}`` (the reference's metric name), so an
unexpected rebuild (a shape or dtype outside what the site was built
for) shows the moment it happens.

Published unconditionally (cold path: one count and a dict lookup per
round, far off any per-submission path).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from . import metrics as _metrics

_LOCK = threading.Lock()
_LAST: Dict[str, int] = {}


def programs_built(owner: Any) -> Optional[int]:
    """The programs ``owner`` built: a ragged executor's
    ``expected_compiles()``, a captured step's CUDA graphs (``graphs``),
    or ``None`` for anything else (nothing to count)."""
    count = getattr(owner, "expected_compiles", None)
    if callable(count):
        return int(count())
    graphs = getattr(owner, "graphs", None)
    if isinstance(graphs, dict):
        return len(graphs)
    return None


def note_cache_size(site: str, size: Optional[int]) -> int:
    """Record a dispatch site's current count of built programs; any growth
    since the last observation is counted as fresh compiles on
    ``byzpy_jit_compiles_total{site}``. Returns the number of NEW
    compiles counted (0 when unchanged, shrunk, or ``size`` is None —
    a cleared cache must not produce negative counts, and the next
    growth past the high-water mark still registers)."""
    if size is None:
        return 0
    size = int(size)
    with _LOCK:
        prev = _LAST.get(site, 0)
        if size <= prev:
            return 0
        _LAST[site] = size
    delta = size - prev
    _metrics.registry().counter(
        "byzpy_jit_compiles_total",
        help="programs built per dispatch site (ragged programs, CUDA-graph captures)",
        labels={"site": site},
    ).inc(delta)
    return delta


def compiles_seen(site: str) -> int:
    """The high-water program count observed at ``site`` (0 if never
    noted) — test/introspection helper."""
    with _LOCK:
        return _LAST.get(site, 0)


def reset() -> None:
    """Forget all per-site high-water marks (tests only; the registry
    counters themselves are reset via ``metrics.registry().reset()``)."""
    with _LOCK:
        _LAST.clear()


__all__ = ["compiles_seen", "note_cache_size", "programs_built", "reset"]
