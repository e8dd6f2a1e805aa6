"""Cohort assembly: a round's submissions padded into a bucket, and the
masked finalize that aggregates them.

Counterpart of ``byzpy_tpu/serving/cohort.py``. A :class:`Cohort` holds
its rows on the cohort's device in one of two layouts, with the
host-side validity mask and staleness weights:

* dense: the ``(bucket, d)`` float32 matrix (valid rows first in
  admission order, zero rows after);
* quantized (``build_cohort(quantized=True)`` when every submission is a
  :class:`~byzpy_tpu_torch.engine.actor.wire.QuantizedWireArray` of one
  wire spec): the stacked wire codes and per-block scales, decoded on the
  device by whoever reads them (the ragged executor's quantized program),
  or on first access by ``Cohort.matrix``, bit for bit the per-frame
  decode.

:class:`CohortAggregator` scales stale rows and reduces the cohort through
``Aggregator.aggregate_masked``; ``parallel.ps.build_serving_ps_step``
takes the same matrix, mask and weights inside one update step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..aggregators.base import Aggregator
from ..engine.actor import wire
from ..observability import tracing as obs_tracing
from ..parallel.quantization import dequantize_rows
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
    earliest admission time; ``wire_inflations``: per valid row, the
    frame's pre-decode inflation (``None`` for lossless rows).

    Rows, on the cohort's device, in one of two layouts: ``dense``, the
    ``(bucket, d)`` float32 matrix; or ``qcodes`` ``(bucket, ncodes)`` and
    ``qscales`` ``(bucket, nb)``, every row's wire codes and block scales
    (``qmode`` / ``qblock`` / ``qdim`` the shared wire spec), with
    ``dense`` ``None`` until :attr:`matrix` decodes it."""

    valid: np.ndarray
    weights: np.ndarray
    clients: Tuple[str, ...]
    first_arrival_s: float
    dense: Optional[torch.Tensor] = None
    wire_inflations: Tuple[Optional[float], ...] = ()
    qcodes: Optional[torch.Tensor] = None
    qscales: Optional[torch.Tensor] = None
    qmode: Optional[str] = None
    qblock: int = 0
    qdim: int = 0

    @property
    def matrix(self) -> torch.Tensor:
        """The ``(bucket, d)`` float32 rows: for a quantized cohort decoded
        on first access (``dequantize_rows``, bit for bit the per-frame
        decode), the padding rows set to +0.0 as a dense cohort's, and
        kept."""
        if self.dense is None:
            mat = dequantize_rows(self.qcodes, self.qscales, mode=self.qmode,
                                  block=self.qblock, d=self.qdim)
            # a zero-scaled padding row decodes to +-0.0; dense cohorts pad
            # with +0.0
            mat[torch.from_numpy(~self.valid).to(mat.device)] = 0.0
            object.__setattr__(self, "dense", mat)
        return self.dense

    @property
    def quantized(self) -> bool:
        """True while the rows are wire codes (no f32 matrix decoded yet)."""
        return self.qmode is not None

    @property
    def bucket(self) -> int:
        """Padded row count."""
        return int(self.valid.shape[0])

    @property
    def m(self) -> int:
        """Actual cohort size (valid rows)."""
        return int(self.valid.sum())

    def finite(self) -> bool:
        """Whether every value of :attr:`matrix` is finite (one host read),
        without decoding a quantized cohort: per block, the largest code
        magnitude times the scale is finite exactly when every decoded
        value is (an IEEE product is monotone in magnitude)."""
        if self.dense is not None or self.qmode is None:
            return bool(torch.isfinite(self.matrix).all())
        absmax = wire.rows_code_absmax(self.qcodes, mode=self.qmode, block=self.qblock,
                                       nb=int(self.qscales.shape[1]))
        return bool(torch.isfinite(absmax * self.qscales).all())


def _row_dense(gradient: Any, device: torch.device) -> torch.Tensor:
    """One submission row as a float32 tensor on ``device``: a wire row
    decodes through ``dequantize_rows`` (bit for bit an ingress decode);
    a tensor already there is not copied through the host."""
    if isinstance(gradient, wire.QuantizedWireArray):
        return dequantize_rows(gradient.codes.reshape(1, -1).to(device),
                               gradient.scales.reshape(1, -1).to(device), mode=gradient.mode,
                               block=gradient.block, d=_row_dim(gradient))[0]
    return torch.as_tensor(gradient).to(device=device, dtype=torch.float32)


def _row_dim(gradient: Any) -> int:
    if isinstance(gradient, wire.QuantizedWireArray):
        return int(gradient.shape[0])
    return int(torch.as_tensor(gradient).shape[0])


def _wire_spec(gradient: Any) -> Optional[tuple]:
    """``(mode, block, code count, scale count, d)`` of a wire row, ``None``
    for any other row."""
    if not isinstance(gradient, wire.QuantizedWireArray):
        return None
    return (gradient.mode, gradient.block, gradient.codes.numel(), gradient.scales.numel(),
            _row_dim(gradient))


def build_cohort(
    submissions: Sequence[Submission],
    server_round: int,
    ladder: Optional[BucketLadder],
    staleness: StalenessPolicy,
    *,
    quantized: bool = False,
    device: DeviceLike = None,
    tenant: str = "",
    track: Optional[str] = None,
) -> Cohort:
    """Pad one round's submissions into the smallest bucket that holds
    them (``ladder=None``: the exact size, ``bucket == m``, the ragged
    door's layout), stamping each row's staleness discount against
    ``server_round``. The rows are assembled on ``device`` (``None``: the
    card), under the profiler range ``serving.bucket_pad``.

    ``quantized=True`` keeps the round compressed when every submission is
    a wire row of the same spec (mode, block, code and scale counts, ``d``):
    the cohort stacks the codes and scales, and the rows are decoded on the
    device by whoever reads them. Mixed or dense rounds take the dense
    layout, wire rows decoded as an ingress decode would decode them.
    ``tenant`` attributes the telemetry span ``serving.bucket_pad`` to the
    tenant's trace row; ``track`` overrides the row's name."""
    dev = resolve_device(device)
    m = len(submissions)
    bucket = m if ladder is None else ladder.bucket_for(m)
    with obs_tracing.span("serving.bucket_pad", track=track or (f"tenant:{tenant}" if tenant else None),
                          round=server_round, m=m, bucket=bucket, tenant=tenant), \
            record_function("serving.bucket_pad"):
        g0 = submissions[0].gradient
        weights = np.zeros((bucket,), np.float32)
        valid = np.zeros((bucket,), bool)
        for slot, sub in enumerate(submissions):
            weights[slot] = staleness.discount(server_round - sub.round_submitted)
            valid[slot] = True
        common = dict(
            valid=valid,
            weights=weights,
            clients=tuple(s.client for s in submissions),
            first_arrival_s=min(s.arrived_s for s in submissions),
            wire_inflations=tuple(s.wire_inflation for s in submissions),
        )
        spec = _wire_spec(g0)
        if quantized and spec is not None and all(
                _wire_spec(s.gradient) == spec for s in submissions):
            qcodes = torch.zeros((bucket, spec[2]), dtype=g0.codes.dtype, device=dev)
            qscales = torch.zeros((bucket, spec[3]), dtype=torch.float32, device=dev)
            qcodes[:m] = torch.stack([s.gradient.codes.reshape(-1).to(dev) for s in submissions])
            qscales[:m] = torch.stack([s.gradient.scales.reshape(-1).to(dev) for s in submissions])
            return Cohort(qcodes=qcodes, qscales=qscales, qmode=g0.mode, qblock=g0.block,
                          qdim=spec[4], **common)
        rows = torch.stack([_row_dense(s.gradient, dev) for s in submissions])
        matrix = torch.zeros((bucket, rows.shape[1]), dtype=torch.float32, device=dev)
        matrix[:m] = rows
        return Cohort(dense=matrix, **common)


class CohortAggregator:
    """Masked-finalize execution of one tenant's robust aggregator.

    ``aggregate(cohort)`` scales any stale rows by their discount (a fresh
    row's weight is exactly 1.0 and its bits never change), then reduces
    the padded matrix through ``Aggregator.aggregate_masked``: the masked
    program for a finite cohort, the exact subset path otherwise.
    ``tenant`` / ``track`` attribute the telemetry spans ``serving.fold``
    and ``serving.device_step``."""

    def __init__(self, aggregator: Aggregator, *, tenant: str = "", track: Optional[str] = None) -> None:
        self.aggregator = aggregator
        self.tenant = tenant
        self._track = track or (f"tenant:{tenant}" if tenant else None)

    def aggregate(self, cohort: Cohort) -> Any:
        """Aggregate one cohort to a ``(d,)`` vector."""
        with obs_tracing.span("serving.fold", track=self._track, m=cohort.m, bucket=cohort.bucket,
                              tenant=self.tenant), record_function("serving.fold"):
            matrix = cohort.matrix
            if bool((cohort.weights[: cohort.m] != 1.0).any()):
                weights = torch.from_numpy(cohort.weights).to(matrix.device)
                matrix = matrix * weights[:, None]
            with obs_tracing.device_span("serving.device_step", track=self._track, m=cohort.m,
                                         bucket=cohort.bucket, tenant=self.tenant):
                return self.aggregator.aggregate_masked(matrix, cohort.valid)


__all__ = ["Cohort", "CohortAggregator", "build_cohort"]
