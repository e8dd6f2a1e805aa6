"""Minimum Diameter Averaging: exact search over ``(n - f)``-subsets.

Counterpart of ``byzpy_tpu/aggregators/geometric_wise/minimum_diameter_average.py``
(behavioral parity: ``byzpy/aggregators/geometric_wise/minimum_diameter_average.py:80-444``).
The search is the JAX package's exact branch-and-bound on the host, its
incumbent global and pre-seeded with a greedy-peeling upper bound. The
``(n, n)`` distance matrix is the only data that leaves the device:

* on the CPU it is the JAX package's numpy form (the same f32 BLAS
  product), so the distances and the search equal the JAX class's bit
  for bit;
* on the card it is ``ops.robust.pairwise_sq_dists`` (B3), read to the
  host once; the winner's mean is taken on the card.

A batched device scorer (``subset_diameters`` over combo index tensors)
is kept for range scoring and validation. The pool fan-out
(``create_subtasks`` / ``reduce_subtasks``) needs the actor pools and
comes with them (ROADMAP A.4).
"""

from __future__ import annotations

import math
from itertools import islice
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops import kernels, robust
from ...utils.combinatorics import iter_combinations
from ...utils.device import DeviceLike
from ..base import Aggregator, check_chunk_size

_DEVICE_BATCH = 4096


def _dists_for_search(x: torch.Tensor) -> np.ndarray:
    """The ``(n, n)`` squared distances the search reads, on the host."""
    if x.device.type == "cpu":
        arr = x.detach().to(torch.float64 if x.dtype == torch.float64 else torch.float32).numpy()
        norms = np.sum(arr * arr, axis=1, keepdims=True)
        d2 = norms + norms.T - 2.0 * (arr @ arr.T)
        return np.maximum(d2, 0.0)
    return robust.pairwise_sq_dists(x).cpu().numpy()  # the one host read


def _to_device(combo, device: torch.device) -> torch.Tensor:
    """A host index list as an int64 tensor on ``device``, copied without a
    host synchronization."""
    return torch.as_tensor(np.asarray(combo, dtype=np.int64)).to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# Exact search: greedy bound + branch-and-bound DFS
# ---------------------------------------------------------------------------


def greedy_peel_bound(d2: np.ndarray, m: int) -> Tuple[float, List[int]]:
    """Upper bound: repeatedly drop the point with the largest max-distance
    to the survivors until ``m`` remain. O(n^2) and usually near-optimal —
    a strong incumbent for the B&B."""
    alive = list(range(d2.shape[0]))
    while len(alive) > m:
        sub = d2[np.ix_(alive, alive)]
        worst = int(np.argmax(sub.max(axis=1)))
        alive.pop(worst)
    diam = float(d2[np.ix_(alive, alive)].max()) if len(alive) > 1 else 0.0
    return diam, alive


def branch_and_bound_min_diameter(
    d2: np.ndarray,
    m: int,
    *,
    prefixes: Optional[Iterable[Sequence[int]]] = None,
    initial_bound: float = math.inf,
    initial_combo: Optional[Sequence[int]] = None,
) -> Tuple[float, List[int]]:
    """Exact minimum-diameter ``m``-subset by DFS over increasing indices.

    A branch extends the current set with index ``idx``; its diameter so
    far is the running max distance, and any branch whose max already
    reaches the incumbent is cut. ``initial_bound`` prunes from the very
    first branch even without ``initial_combo`` — a fully pruned search
    returns ``(initial_bound, [])``, meaning nothing beat the bound. With
    ``prefixes``, only subsets starting with one of the given index
    prefixes are explored (the incumbent still tightens across prefixes
    within one call).
    """
    n = d2.shape[0]
    best = [float(initial_bound), list(initial_combo or [])]

    def dfs(indices: List[int], current: float, start: int, remain: int) -> None:
        if remain == 0:
            if current < best[0]:
                best[0], best[1] = current, list(indices)
            return
        for idx in range(start, n - remain + 1):
            new_max = current
            if indices:
                row = d2[idx, indices]
                new_max = max(current, float(row.max()))
            if new_max >= best[0]:
                continue  # bound: cannot beat the incumbent
            indices.append(idx)
            dfs(indices, new_max, idx + 1, remain - 1)
            indices.pop()

    if prefixes is None:
        prefixes = [()]
    for prefix in prefixes:
        prefix = list(prefix)
        if len(prefix) > m:
            continue
        current = (
            float(d2[np.ix_(prefix, prefix)].max()) if len(prefix) > 1 else 0.0
        )
        if current >= best[0]:
            continue
        start = (prefix[-1] + 1) if prefix else 0
        dfs(prefix, current, start, m - len(prefix))
    return best[0], best[1]


def _exact_min_diameter(d2: np.ndarray, m: int) -> List[int]:
    bound, combo = greedy_peel_bound(d2, m)
    # strict-improvement DFS keeps the greedy combo unless something beats it
    _, best = branch_and_bound_min_diameter(
        d2, m, initial_bound=bound, initial_combo=combo
    )
    return best


# ---------------------------------------------------------------------------
# Device-batched scorer (range scoring + validation)
# ---------------------------------------------------------------------------


def _combo_batches(
    n: int, m: int, batch: int, *, start: int = 0, count: int | None = None
) -> Iterable[np.ndarray]:
    """Fixed-size ``(batch, m)`` blocks; the tail is padded by repeating its
    first combo (padding can't win the min — it duplicates a real
    candidate)."""
    it = iter_combinations(n, m, start)
    if count is not None:
        it = islice(it, count)
    while True:
        block = list(islice(it, batch))
        if not block:
            return
        arr = np.asarray(block, dtype=np.int32)
        if arr.shape[0] < batch:
            pad = np.repeat(arr[:1], batch - arr.shape[0], axis=0)
            arr = np.concatenate([arr, pad], axis=0)
        yield arr


def _device_best(
    matrix: torch.Tensor,
    batches: Iterable[np.ndarray],
    score_fn=robust.subset_diameters,
) -> tuple[float, np.ndarray]:
    """Scan batches keeping the per-batch best on ``matrix``'s device; one
    host read at the end picks the global winner. ``score_fn(matrix,
    combos) -> (c,) scores``; minimum wins, the first on ties."""
    best_scores = []
    best_combos = []
    for combos in batches:
        combos = _to_device(combos, matrix.device)
        scores = score_fn(matrix, combos)
        i = robust.best_subset_by_score(scores).reshape(1)
        best_scores.append(scores.index_select(0, i)[0])
        best_combos.append(combos.index_select(0, i)[0])
    stacked = torch.stack(best_scores)
    k = int(robust.best_subset_by_score(stacked))  # the one host read
    return float(stacked[k]), best_combos[k].cpu().numpy().astype(np.int32)


def _score_combo_range(
    host_d2: np.ndarray, n: int, m: int, start: int, count: int
) -> tuple[float, np.ndarray]:
    """Best (min-diameter) combo among combinations [start, start+count),
    by brute-force scoring: the pool subtasks' scorer (ROADMAP A.4), on the
    host's distances."""
    d2 = torch.as_tensor(host_d2)
    batch = min(_DEVICE_BATCH, count)
    return _device_best(d2, _combo_batches(n, m, batch, start=start, count=count))


def _search_seed_group(
    host_d2: np.ndarray, seeds: Tuple[Tuple[int, ...], ...], m: int, bound: float
) -> tuple[float, np.ndarray]:
    """B&B restricted to the given seed prefixes (ref:
    ``_mda_best_subset_seeded``, minimum_diameter_average.py:297-325)."""
    score, combo = branch_and_bound_min_diameter(
        np.asarray(host_d2), m, prefixes=seeds, initial_bound=bound
    )
    return score, np.asarray(combo if combo else [], dtype=np.int32)


def check_rows_on_card(agg: Aggregator, x: torch.Tensor) -> None:
    """On the card the Gram is B3, which takes at most 128 rows."""
    if x.is_cuda and x.shape[0] > kernels.MAX_NETWORK_ROWS:
        raise NotImplementedError(
            f"{type(agg).__name__} on the card takes at most {kernels.MAX_NETWORK_ROWS} rows "
            f"(its Gram is B3's, capped there); got n={x.shape[0]}"
        )


class MinimumDiameterAveraging(Aggregator):
    """Average of the (n - f)-subset with the smallest pairwise diameter,
    found by branch-and-bound over the distance matrix (B3's on the card,
    read to the host once)."""

    name = "minimum-diameter-averaging"

    def __init__(
        self,
        f: int,
        *,
        chunk_size: int = 20000,
        seed_prefix: int = 2,
        seeds_per_task: int = 4,
        device: DeviceLike = None,
    ) -> None:
        if f < 0:
            raise ValueError("f must be >= 0")
        check_chunk_size(chunk_size, 20000)
        # both only shape the pool-partitioned search
        for key, value, default in (("seed_prefix", seed_prefix, 2),
                                    ("seeds_per_task", seeds_per_task, 4)):
            if value != default:
                raise NotImplementedError(
                    f"{key}={value}: the pool-partitioned search is not ported yet "
                    f"(leave it at {default})"
                )
        self.f = int(f)
        self.chunk_size = int(chunk_size)
        self.seed_prefix = int(seed_prefix)
        self.seeds_per_task = int(seeds_per_task)
        super().__init__(device=device)
        #: the row indices the last aggregation averaged, on its device
        self.last_selection: Optional[torch.Tensor] = None

    def validate_n(self, n: int) -> None:
        if self.f >= n:
            raise ValueError(f"f must satisfy 0 <= f < n (got n={n}, f={self.f})")

    def _aggregate_matrix(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        check_rows_on_card(self, x)
        d2 = _dists_for_search(x)
        combo = _to_device(_exact_min_diameter(d2, n - self.f), x.device)
        self.last_selection = combo
        return robust.subset_mean(x, combo)


__all__ = [
    "MinimumDiameterAveraging",
    "branch_and_bound_min_diameter",
    "greedy_peel_bound",
]
