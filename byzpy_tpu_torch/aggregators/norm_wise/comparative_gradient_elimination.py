"""CGE: drop the ``f`` largest-L2-norm gradients, average the rest.

Counterpart of
``byzpy_tpu/aggregators/norm_wise/comparative_gradient_elimination.py``
(behavioral parity:
``byzpy/aggregators/norm_wise/comparative_gradient_elimination.py:28-154``).
The barrier path is ``robust.cge`` (B3 + B4's ``cge`` mode on the card);
the streaming fold takes each squared norm as its gradient arrives and
finalizes with ``robust.ranked_mean``, plain PyTorch as in the JAX
package. On an actor pool it fans out row ranges of squared norms
(``aggregators/chunked.py``).
"""

from __future__ import annotations

from typing import Any

import torch

from ...ops import ragged as ragged_ops
from ...ops import robust
from ...utils.device import DeviceLike
from ..base import Aggregator, SlotFoldState, check_chunk_size
from ..chunked import RowScoredAggregator


def _sq_norm_rows(x: torch.Tensor, start: int, end: int) -> torch.Tensor:
    block = x[start:end]
    return torch.sum(block * block, dim=1)


class _NormFoldState:
    """Incremental CGE state: each node's squared norm, taken the moment
    its gradient arrives (one reduction over that row alone, so any
    arrival order gives the same norms). Parity with the barrier path is
    to float tolerance: the barrier reads the norms off B3's Gram."""

    __slots__ = ("slots", "norms")

    def __init__(self, n: int, device: DeviceLike) -> None:
        self.slots = SlotFoldState(n, device)
        self.norms: dict = {}


class ComparativeGradientElimination(RowScoredAggregator, Aggregator):
    """CGE: drop the f largest-norm rows and average the rest."""

    name = "comparative-gradient-elimination"
    _score_fn = staticmethod(_sq_norm_rows)

    def __init__(self, f: int, *, chunk_size: int = 32, device: DeviceLike = None) -> None:
        if f < 0:
            raise ValueError("f must be >= 0")
        self.chunk_size = check_chunk_size(chunk_size)
        self.f = int(f)
        super().__init__(device=device)

    def validate_n(self, n: int) -> None:
        if self.f >= n:
            raise ValueError(f"f must satisfy 0 <= f < n (got n={n}, f={self.f})")

    def _select_from_scores(self, scores: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
        return robust.selection_sweep_mean(matrix, scores, matrix.shape[0] - self.f)

    def _aggregate_matrix(self, x: torch.Tensor) -> torch.Tensor:
        return robust.cge(x, f=self.f)

    supports_masked_finalize = True

    def _aggregate_matrix_masked(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return robust.masked_cge(x, valid, f=self.f)

    def _masked_view(self, state):
        return Aggregator._masked_view(self, state.slots)

    def _aggregate_stream_matrix(self, xs: torch.Tensor) -> torch.Tensor:
        return robust.cge_stream(xs, f=self.f)

    ragged_score_kind = "norm"
    #: one shared norm pass scores the whole batch
    ragged_coalesce = True

    def ragged_matrix_fn(self):
        """The specialized ragged program on every device: one squared-norm
        pass scores every cohort (``ops.ragged.ragged_cge``); the L2 norms
        and the keep set are the fused forensics view."""
        f = self.f

        def fn(flat, seg, offsets, lengths, *, n_cohorts, segment_sum=None, long_slots=False):
            return ragged_ops.ragged_cge(flat, seg, lengths, f=f, n_cohorts=n_cohorts,
                                         segment_sum=segment_sum)

        return fn

    # -- arrival-order streaming fold ------------------------------------

    def fold_init(self, n: int) -> Any:
        return _NormFoldState(n, self.device)

    def fold(self, state: Any, index: int, gradient: Any) -> None:
        row = state.slots.insert(index, gradient)
        state.norms[index] = torch.sum(row * row)

    def fold_finalize(self, state: Any) -> Any:
        m = state.slots.filled
        self.validate_n(m)
        matrix, unravel = state.slots.stacked()
        scores = torch.stack([state.norms[s] for s in sorted(state.norms)])
        return unravel(robust.ranked_mean(matrix, scores, m - self.f))


__all__ = ["ComparativeGradientElimination"]
