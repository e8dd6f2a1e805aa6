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

A batched scorer (``subset_diameters`` over combo index tensors) serves
range scoring and validation. On an actor pool the search fans out as the
reference's does (``create_subtasks`` / ``reduce_subtasks``): groups of
index prefixes searched by branch-and-bound from the greedy bound
(``seed_prefix``, ``seeds_per_task``), or, with ``seed_prefix=0``, ranges
of ``chunk_size`` subsets scored by brute force, all on the host's copy of
the distances; the winner's mean is taken on the matrix's device.
"""

from __future__ import annotations

import math
from itertools import combinations, islice
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops import robust
from ...utils.combinatorics import iter_combinations
from ...utils.device import DeviceLike
from ...engine.graph.chunking import pool_size_from_context, select_adaptive_chunk_size
from ...engine.graph.operator import OpContext
from ...engine.graph.subtask import SubTask
from ...utils.trees import stack_gradients
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
    by brute-force scoring: the pool subtasks' scorer, on the host's
    distances."""
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


class MinimumDiameterAveraging(Aggregator):
    """Average of the (n - f)-subset with the smallest pairwise diameter,
    found by branch-and-bound over the distance matrix (B3's on the card up
    to 128 rows, ``robust.gram_matrix``'s matmul above; read to the host
    once)."""

    name = "minimum-diameter-averaging"
    supports_subtasks = True

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
        self.f = int(f)
        self.chunk_size = check_chunk_size(chunk_size)
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
        d2 = _dists_for_search(x)
        combo = _to_device(_exact_min_diameter(d2, n - self.f), x.device)
        self.last_selection = combo
        return robust.subset_mean(x, combo)

    # -- pool path ----------------------------------------------------------

    def create_subtasks(self, inputs, *, context: OpContext):
        matrix, _ = stack_gradients(inputs.get(self.input_key), device=self.device)
        self.validate_n(matrix.shape[0])
        n = matrix.shape[0]
        m = n - self.f
        host_d2 = _dists_for_search(matrix)

        if 0 < self.seed_prefix < m:
            # partition the space by index prefixes; every task gets the
            # greedy incumbent so pruning starts tight everywhere. Tasks
            # where nothing beats it return an empty combo; if all do, the
            # greedy subset itself was optimal (reduce falls back to it).
            bound, _ = greedy_peel_bound(host_d2, m)
            depth = self.seed_prefix
            max_last = n - (m - depth) - 1

            def gen_seeded():
                group: List[Tuple[int, ...]] = []
                for seed in combinations(range(n), depth):
                    if seed[-1] > max_last:
                        continue
                    group.append(seed)
                    if len(group) >= self.seeds_per_task:
                        yield SubTask(fn=_search_seed_group, args=(host_d2, tuple(group), m, bound),
                                      name=f"mda-seeds-{group[0]}")
                        group = []
                if group:
                    yield SubTask(fn=_search_seed_group, args=(host_d2, tuple(group), m, bound),
                                  name=f"mda-seeds-{group[0]}")

            return gen_seeded()

        total = math.comb(n, m)
        chunk = select_adaptive_chunk_size(
            total, self.chunk_size, pool_size=pool_size_from_context(context)
        )

        def gen():
            for start in range(0, total, chunk):
                count = min(chunk, total - start)
                yield SubTask(fn=_score_combo_range, args=(host_d2, n, m, start, count),
                              name=f"mda-combos[{start}:{start + count}]")

        return gen()

    def reduce_subtasks(self, partials, inputs, *, context: OpContext):
        matrix, unravel = stack_gradients(inputs.get(self.input_key), device=self.device)
        viable = [p for p in partials if len(np.atleast_1d(p[1]))]
        if not viable:
            # every seeded task was pruned by the shared bound: the greedy
            # incumbent is optimal (the same distances as create_subtasks, so
            # the recomputed combo matches the bound's derivation)
            _, combo = greedy_peel_bound(_dists_for_search(matrix), matrix.shape[0] - self.f)
        else:
            combo = min(viable, key=lambda p: p[0])[1]
        self.last_selection = _to_device(combo, matrix.device)
        return unravel(robust.subset_mean(matrix, self.last_selection))


__all__ = [
    "MinimumDiameterAveraging",
    "branch_and_bound_min_diameter",
    "greedy_peel_bound",
]
