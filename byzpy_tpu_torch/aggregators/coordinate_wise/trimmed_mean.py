"""Coordinate-wise trimmed mean (Yin et al. 2018).

Counterpart of ``byzpy_tpu/aggregators/coordinate_wise/trimmed_mean.py``
(behavioral parity: ``byzpy/aggregators/coordinate_wise/trimmed_mean.py:27-211``).
The barrier path is ``robust.trimmed_mean`` (B1 on the card); the
streaming fold keeps a running sum and the extreme buffers in plain
PyTorch, as the JAX package leaves them to XLA; the ragged program is the
segmented sort-reduce on the card. On an actor pool it fans out feature
chunks (``aggregators/chunked.py``), each chunk B1 on the card.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...ops import ragged as ragged_ops
from ...ops import robust
from ...utils.device import DeviceLike
from ..base import Aggregator, SlotFoldState, check_chunk_size
from ..chunked import FeatureChunkedAggregator


def _trimmed_mean_chunk(chunk: torch.Tensor, *, f: int) -> torch.Tensor:
    return robust.trimmed_mean(chunk.contiguous(), f=f)


class _TrimmedMeanFoldState:
    """Incremental trimmed-mean state: a running coordinate sum and the
    ``f`` smallest / largest values per coordinate
    (``robust.extremes_fold_update``), so per-arrival and finalize work are
    O(f d). Raw rows are kept in a slot buffer for the exact fallback: a
    non-finite gradient would corrupt the extreme buffers, so finalize
    reads one flag (``nonfinite``, a device bool, never read per arrival)
    and reruns the barrier path on the kept rows."""

    __slots__ = ("slots", "total", "low", "high", "nonfinite")

    def __init__(self, n: int, device: DeviceLike) -> None:
        self.slots = SlotFoldState(n, device)
        self.total = None
        self.low = None
        self.high = None
        self.nonfinite = None


class CoordinateWiseTrimmedMean(FeatureChunkedAggregator, Aggregator):
    """Drop the f largest and f smallest values per coordinate, average the rest."""

    name = "coordinate-wise-trimmed-mean"
    _chunk_fn = staticmethod(_trimmed_mean_chunk)

    def __init__(self, f: int, *, chunk_size: int = 8192, device: DeviceLike = None) -> None:
        if f < 0:
            raise ValueError("f must be >= 0")
        self.chunk_size = check_chunk_size(chunk_size)
        self.f = int(f)
        super().__init__(device=device)

    def validate_n(self, n: int) -> None:
        if 2 * self.f >= n:
            raise ValueError(
                f"trim parameter f must satisfy 0 <= 2f < n (got n={n}, f={self.f})"
            )

    def _chunk_params(self):
        return {"f": self.f}

    def _aggregate_matrix(self, x: torch.Tensor) -> torch.Tensor:
        return robust.trimmed_mean(x, f=self.f)

    supports_masked_finalize = True

    def _aggregate_matrix_masked(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return robust.masked_trimmed_mean(x, valid, f=self.f)

    def _masked_view(self, state):
        # the incremental fold keeps the raw rows in a slot buffer for its
        # exact fallback; the masked finalize reads that buffer
        return Aggregator._masked_view(self, state.slots)

    def _aggregate_stream_matrix(self, xs: torch.Tensor) -> torch.Tensor:
        return robust.trimmed_mean_stream(xs, f=self.f)

    def ragged_matrix_fn(self):
        """The ragged program, chosen here from the device, as the
        reference chooses from ``_on_tpu()``: on the card the segmented
        program (``ops.ragged.ragged_trimmed_mean``, one launch of the
        segmented sort-reduce for the whole batch); on the CPU the
        per-cohort masked program of the generic door."""
        if self.device.type != "cuda":
            return super().ragged_matrix_fn()
        f = self.f

        def fn(flat, seg, offsets, lengths, *, n_cohorts, segment_sum=None, long_slots=False):
            aggs = ragged_ops.ragged_trimmed_mean(flat, seg, offsets, lengths, f=f,
                                                  n_cohorts=n_cohorts, long_slots=long_slots)
            return aggs, None, None

        return fn

    #: Coordinate cap of the clip-fraction evidence: past it the rank pass
    #: reads an evenly strided subset of the columns (evidence is a
    #: screening signal, not the aggregate).
    _EVIDENCE_MAX_COORDS = 65536

    def round_evidence(self, matrix, valid, *, aggregate=None):
        """Per-row clip counts: the fraction of a row's coordinates that
        fell in the trimmed ``f``-smallest / ``f``-largest window. The
        (sampled) columns are read to the host once and ranked there with
        the reference's stable order; ``keep`` is None (trimming is per
        coordinate)."""
        pre = self._evidence_rows(matrix, valid)
        if pre is None:
            return None
        rows, idx, n = pre
        m, d = rows.shape
        if self.f == 0:
            return self._evidence_view("trim_fraction", n, idx, np.zeros((m,), np.float32))
        if d > self._EVIDENCE_MAX_COORDS:
            sample = np.linspace(0, d - 1, self._EVIDENCE_MAX_COORDS, dtype=np.int64)
            rows = rows[:, torch.from_numpy(sample).to(rows.device)]
        cols = rows.cpu().numpy()
        order = np.argsort(cols, axis=0, kind="stable")
        ranks = np.empty_like(order)
        np.put_along_axis(ranks, order, np.arange(m, dtype=order.dtype)[:, None], axis=0)
        trimmed = (ranks < self.f) | (ranks >= m - self.f)
        frac = trimmed.mean(axis=1).astype(np.float32)
        return self._evidence_view("trim_fraction", n, idx, frac)

    # -- arrival-order streaming fold ------------------------------------

    def fold_init(self, n: int) -> Any:
        return _TrimmedMeanFoldState(n, self.device)

    def fold(self, state: Any, index: int, gradient: Any) -> None:
        row = state.slots.insert(index, gradient)
        f = self.f
        if state.total is None:
            # a copy: the sum is updated in place, and row may be a view of
            # the caller's gradient
            state.total = row.clone()
        else:
            if state.total.dtype != state.slots.buffer.dtype:
                # a wider row than the round's so far: promote the sum and
                # the extremes with the slot buffer, as torch.stack would
                dtype = state.slots.buffer.dtype
                state.total = state.total.to(dtype)
                if state.low is not None:
                    state.low, state.high = state.low.to(dtype), state.high.to(dtype)
            robust.fold_add(state.total, row)
        bad = ~torch.all(torch.isfinite(row))
        state.nonfinite = bad if state.nonfinite is None else state.nonfinite | bad
        if f > 0:
            if state.low is None:
                d = row.shape[0]
                state.low = torch.full((f, d), float("inf"), dtype=row.dtype, device=row.device)
                state.high = torch.full((f, d), float("-inf"), dtype=row.dtype, device=row.device)
            robust.extremes_fold_update(state.low, row, largest=False)
            robust.extremes_fold_update(state.high, row, largest=True)

    def fold_finalize(self, state: Any) -> Any:
        n = state.slots.filled
        self.validate_n(n)
        if state.nonfinite is None or bool(state.nonfinite):
            # the exact sorted path on the kept rows (the barrier's
            # NaN-propagation and inf-trimming semantics, bit for bit)
            return Aggregator.fold_finalize(self, state.slots)
        vec = robust.trimmed_mean_from_extremes(
            state.total, state.low, state.high, n, f=self.f
        )
        return state.slots.unravel(vec)


__all__ = ["CoordinateWiseTrimmedMean"]
