"""Cohort assembly: a round's submissions padded into a bucket, and the
masked finalize that aggregates them.

Counterpart of ``byzpy_tpu/serving/cohort.py``, its dense layout. A
:class:`Cohort` holds the ``(bucket, d)`` float32 matrix (valid rows
first in admission order, zero rows after) on the cohort's device, with
the host-side validity mask and staleness weights.
:class:`CohortAggregator` scales stale rows and reduces the cohort through
``Aggregator.aggregate_masked``; ``parallel.ps.build_serving_ps_step``
takes the same matrix, mask and weights inside one update step.

The quantized layout (the wire's codes and scales kept compressed until
the device decodes them) comes with the ragged executor:
``build_cohort(quantized=True)`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..aggregators.base import Aggregator
from ..utils.device import DeviceLike, resolve_device
from .buckets import BucketLadder
from .queue import Submission
from .staleness import StalenessPolicy


@dataclass(frozen=True)
class Cohort:
    """One closed round's padded cohort.

    ``valid``: ``(bucket,)`` bool; ``weights``: ``(bucket,)`` float32
    staleness discounts (1.0 for fresh rows, 0.0 for padding), both numpy;
    ``clients``: the valid rows' client ids; ``first_arrival_s``: the
    earliest admission time; ``dense``: the ``(bucket, d)`` float32 matrix
    on the cohort's device; ``wire_inflations``: per valid row, the
    frame's pre-decode inflation (``None`` for lossless rows)."""

    valid: np.ndarray
    weights: np.ndarray
    clients: Tuple[str, ...]
    first_arrival_s: float
    dense: torch.Tensor
    wire_inflations: Tuple[Optional[float], ...] = ()

    @property
    def matrix(self) -> torch.Tensor:
        """The ``(bucket, d)`` float32 rows."""
        return self.dense

    @property
    def bucket(self) -> int:
        """Padded row count."""
        return int(self.valid.shape[0])

    @property
    def m(self) -> int:
        """Actual cohort size (valid rows)."""
        return int(self.valid.sum())


def _row(gradient: Any, device: torch.device) -> torch.Tensor:
    """One submission row as a float32 tensor on ``device``: a tensor
    already there is not copied through the host."""
    return torch.as_tensor(gradient).to(device=device, dtype=torch.float32)


def build_cohort(
    submissions: Sequence[Submission],
    server_round: int,
    ladder: Optional[BucketLadder],
    staleness: StalenessPolicy,
    *,
    quantized: bool = False,
    device: DeviceLike = None,
) -> Cohort:
    """Pad one round's submissions into the smallest bucket that holds
    them (``ladder=None``: the exact size, ``bucket == m``), stamping each
    row's staleness discount against ``server_round``. The matrix is
    assembled on ``device`` (``None``: the card), under the profiler range
    ``serving.bucket_pad``. The reference's ``tenant`` and ``track``
    (trace-row attribution) come with the observability plane."""
    if quantized:
        raise NotImplementedError(
            "quantized cohorts (wire codes decoded on the device) come with the "
            "ragged executor; build the dense cohort"
        )
    dev = resolve_device(device)
    m = len(submissions)
    bucket = m if ladder is None else ladder.bucket_for(m)
    with record_function("serving.bucket_pad"):
        weights = np.zeros((bucket,), np.float32)
        valid = np.zeros((bucket,), bool)
        for slot, sub in enumerate(submissions):
            weights[slot] = staleness.discount(server_round - sub.round_submitted)
            valid[slot] = True
        rows = torch.stack([_row(s.gradient, dev) for s in submissions])
        matrix = torch.zeros((bucket, rows.shape[1]), dtype=torch.float32, device=dev)
        matrix[:m] = rows
        return Cohort(
            valid=valid,
            weights=weights,
            clients=tuple(s.client for s in submissions),
            first_arrival_s=min(s.arrived_s for s in submissions),
            dense=matrix,
            wire_inflations=tuple(s.wire_inflation for s in submissions),
        )


class CohortAggregator:
    """Masked-finalize execution of one tenant's robust aggregator.

    ``aggregate(cohort)`` scales any stale rows by their discount (a fresh
    row's weight is exactly 1.0 and its bits never change), then reduces
    the padded matrix through ``Aggregator.aggregate_masked``: the masked
    program for a finite cohort, the exact subset path otherwise."""

    def __init__(self, aggregator: Aggregator) -> None:
        self.aggregator = aggregator

    def aggregate(self, cohort: Cohort) -> Any:
        """Aggregate one cohort to a ``(d,)`` vector."""
        with record_function("serving.fold"):
            matrix = cohort.matrix
            if bool((cohort.weights[: cohort.m] != 1.0).any()):
                weights = torch.from_numpy(cohort.weights).to(matrix.device)
                matrix = matrix * weights[:, None]
            return self.aggregator.aggregate_masked(matrix, cohort.valid)


__all__ = ["Cohort", "CohortAggregator", "build_cohort"]
