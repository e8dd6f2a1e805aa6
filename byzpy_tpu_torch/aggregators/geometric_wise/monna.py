"""MoNNA: mean of the ``n - f`` nearest neighbours of a trusted reference.

Counterpart of ``byzpy_tpu/aggregators/geometric_wise/monna.py``
(behavioral parity: ``byzpy/aggregators/geometric_wise/monna.py:36-178``):
``robust.monna``, B3 + B4's ``monna`` mode on the card. On an actor pool it
fans out row ranges of distances to the reference row
(``aggregators/chunked.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import kernels, robust
from ...utils.device import DeviceLike
from ..base import Aggregator, check_chunk_size
from ..chunked import RowScoredAggregator


def _monna_dist_rows(x: torch.Tensor, start: int, end: int, *, reference_index: int) -> torch.Tensor:
    diff = x[start:end] - x[reference_index][None, :]
    return torch.sum(diff * diff, dim=1)


class MoNNA(RowScoredAggregator, Aggregator):
    """Mean of the n - f nearest neighbours of a trusted pivot row."""

    name = "monna"
    _score_fn = staticmethod(_monna_dist_rows)

    def __init__(
        self,
        f: int,
        *,
        reference_index: int = 0,
        chunk_size: int = 32,
        device: DeviceLike = None,
    ) -> None:
        if f < 0:
            raise ValueError("f must be >= 0")
        if reference_index < 0:
            raise ValueError("reference_index must be >= 0")
        self.chunk_size = check_chunk_size(chunk_size)
        self.f = int(f)
        self.reference_index = int(reference_index)
        super().__init__(device=device)

    def validate_n(self, n: int) -> None:
        if 2 * self.f >= n:
            raise ValueError(f"Cannot tolerate 2f >= n (got n={n}, f={self.f})")
        if not 0 <= self.reference_index < n:
            raise ValueError(
                f"reference_index must be between 0 and {n - 1} (got {self.reference_index})"
            )

    def _score_params(self):
        return {"reference_index": self.reference_index}

    def _select_from_scores(self, scores: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
        return robust.selection_sweep_mean(matrix, scores, matrix.shape[0] - self.f)

    def _aggregate_matrix(self, x: torch.Tensor) -> torch.Tensor:
        return robust.monna(x, f=self.f, reference_index=self.reference_index)

    supports_masked_finalize = True

    def _aggregate_matrix_masked(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return robust.masked_monna(x, valid, f=self.f, reference_index=self.reference_index)

    def _aggregate_stream_matrix(self, xs: torch.Tensor) -> torch.Tensor:
        return robust.monna_stream(xs, f=self.f, reference_index=self.reference_index)

    evidence_selects = True

    def round_evidence(self, matrix, valid, *, aggregate=None):
        """Squared distances to the trusted pivot row
        (``kernels.row_sq_dists`` on the rows' device) and the nearest
        ``m - f`` selection (stable tie rule)."""
        pre = self._evidence_rows(matrix, valid)
        if pre is None:
            return None
        rows, idx, n = pre
        m = rows.shape[0]
        d2 = kernels.row_sq_dists(rows, rows[int(self.reference_index) % m].contiguous()).cpu().numpy()
        keep_local = np.argsort(d2, kind="stable")[: m - int(self.f)]
        return self._evidence_view("reference_distance", n, idx, d2, keep_local)


__all__ = ["MoNNA"]
