"""Krum / Multi-Krum (Blanchard et al. 2017).

Counterpart of ``byzpy_tpu/aggregators/geometric_wise/krum.py``
(behavioral parity: ``byzpy/aggregators/geometric_wise/krum.py:82-475``).
The barrier path is ``robust.multi_krum`` (B3's Gram, then B4). The
streaming fold builds the Gram one row per arrival
(``robust.gram_fold_update``) and its finalize selects from that Gram
without recomputing it (``robust.multi_krum_from_gram``, B5 on the card).
On an actor pool it fans out row ranges of Krum scores against the whole
matrix, which stays on its device (``aggregators/chunked.py``), and
selects centrally with B4's row sweep (``robust.selection_sweep_mean``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ...ops import ragged as ragged_ops
from ...ops import robust
from ...utils.device import DeviceLike
from ..base import Aggregator, SlotFoldState, check_chunk_size
from ..chunked import RowScoredAggregator


def _krum_score_rows(x: torch.Tensor, start: int, end: int, *, f: int) -> torch.Tensor:
    """Scores of rows ``[start, end)``: the sum of each row's ``n - f - 1``
    smallest squared distances to the other rows."""
    block = x[start:end]
    n = x.shape[0]
    d2 = (torch.sum(block * block, dim=1, keepdim=True) + torch.sum(x * x, dim=1)[None, :]
          - 2.0 * block @ x.T)
    d2 = torch.clamp(d2, min=0.0)
    # a row's distance to itself: (i, start + i)
    d2.diagonal(offset=start).fill_(float("inf"))
    return torch.sum(torch.sort(d2, dim=1).values[:, : n - f - 1], dim=1)


class _GramFoldState:
    """Incremental Gram state for streaming Multi-Krum: a slot buffer (each
    arriving gradient written in place into its slot of the ``(n, d)``
    buffer) and an ``(n, n)`` Gram to which each arrival adds its row and
    column through one matvec (``robust.gram_fold_update``). The Gram is
    complete the moment the last gradient lands, indexed in canonical slot
    order; finalize scores and selects straight from it."""

    __slots__ = ("slots", "gram")

    def __init__(self, n: int, device: DeviceLike) -> None:
        self.slots = SlotFoldState(n, device)
        self.gram: Optional[torch.Tensor] = None  # (n, n) accumulator


def _gram_dtype(dtype: torch.dtype) -> torch.dtype:
    """The Gram's dtype for rows of ``dtype``: f32 for 16-bit rows."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


class MultiKrum(RowScoredAggregator, Aggregator):
    """Average the q rows with the best Krum scores (sum of distances to
    each row's n - f - 1 nearest neighbours)."""

    name = "multi-krum"
    _score_fn = staticmethod(_krum_score_rows)

    def __init__(
        self, f: int, q: int, *, chunk_size: int = 32, device: DeviceLike = None
    ) -> None:
        if f < 0:
            raise ValueError("f must be >= 0")
        if q < 1:
            raise ValueError("q must be >= 1")
        self.chunk_size = check_chunk_size(chunk_size)
        self.f = int(f)
        self.q = int(q)
        super().__init__(device=device)

    def validate_n(self, n: int) -> None:
        if self.f >= n - 1:
            raise ValueError(f"f must satisfy 0 <= f < n-1 (got n={n}, f={self.f})")
        if self.q > n - self.f:
            raise ValueError(
                f"q must satisfy 1 <= q <= n - f (got n={n}, f={self.f}, q={self.q})"
            )

    def _score_params(self):
        return {"f": self.f}

    def _select_from_scores(self, scores: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
        return robust.selection_sweep_mean(matrix, scores, self.q)

    def _aggregate_matrix(self, x: torch.Tensor) -> torch.Tensor:
        return robust.multi_krum(x, f=self.f, q=self.q)

    supports_masked_finalize = True

    def _aggregate_matrix_masked(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return robust.masked_multi_krum(x, valid, f=self.f, q=self.q)

    def _masked_view(self, state):
        # the Gram fold's staging buffer is a padded matrix (zero rows for
        # absent slots); the masked program recomputes the Gram from it as
        # the barrier path does, so the result is bitwise, not the
        # incremental Gram's tolerance
        return Aggregator._masked_view(self, state.slots)

    def _aggregate_stream_matrix(self, xs: torch.Tensor) -> torch.Tensor:
        return robust.multi_krum_stream(xs, f=self.f, q=self.q)

    ragged_score_kind = "krum_distance"
    #: one shared Gram scores the whole batch
    ragged_coalesce = True

    def ragged_matrix_fn(self):
        """The specialized ragged program on every device: one shared Gram
        scores every cohort (``ops.ragged.ragged_multi_krum``); the Krum
        scores and the lowest-``q`` keep set are the fused forensics
        view."""
        f, q = self.f, self.q

        def fn(flat, seg, offsets, lengths, *, n_cohorts, segment_sum=None, long_slots=False):
            return ragged_ops.ragged_multi_krum(flat, seg, lengths, f=f, q=q, n_cohorts=n_cohorts,
                                                segment_sum=segment_sum)

        return fn

    evidence_selects = True

    def round_evidence(self, matrix, valid, *, aggregate=None):
        """Krum-distance scores (``robust.krum_scores`` on the rows' device:
        B3's Gram on the card) and the lowest-``q`` selection, scattered to
        the padded positions; the tie rule is the aggregate's stable
        lowest-``q`` pick."""
        pre = self._evidence_rows(matrix, valid)
        if pre is None:
            return None
        rows, idx, n = pre
        scores = robust.krum_scores(rows, f=self.f).cpu().numpy()
        keep_local = np.argsort(scores, kind="stable")[: int(self.q)]
        return self._evidence_view("krum_distance", n, idx, scores, keep_local)

    # -- arrival-order streaming fold ------------------------------------

    def fold_init(self, n: int) -> Any:
        return _GramFoldState(n, self.device)

    def fold(self, state: Any, index: int, gradient: Any) -> None:
        slots = state.slots
        row = slots.admit(index, gradient)
        # f32 for 16-bit rows; promoted with the buffer in a mixed round
        dtype = _gram_dtype(slots.buffer.dtype)
        if state.gram is None:
            state.gram = torch.zeros((slots.n, slots.n), dtype=dtype, device=slots.buffer.device)
        elif state.gram.dtype != dtype:
            state.gram = state.gram.to(dtype)
        robust.gram_fold_update(slots.buffer, state.gram, row, index)

    def fold_finalize(self, state: Any) -> Any:
        slots = state.slots
        self.validate_n(slots.filled)
        matrix, unravel = slots.stacked()
        gram = state.gram
        if slots.filled < slots.n:
            # partial round: the Gram's absent rows and columns were never
            # written past their zero init
            idx = slots.filled_slots()
            gram = gram[idx][:, idx]
        return unravel(robust.multi_krum_from_gram(matrix, gram, f=self.f, q=self.q))


class Krum(MultiKrum):
    """Classic Krum: the single lowest-score gradient (Multi-Krum q=1;
    ref: ``krum.py:302-368``)."""

    name = "krum"

    def __init__(self, f: int, *, chunk_size: int = 32, device: DeviceLike = None) -> None:
        super().__init__(f, 1, chunk_size=chunk_size, device=device)


__all__ = ["MultiKrum", "Krum"]
