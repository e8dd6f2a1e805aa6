"""PreAggregator base class.

Counterpart of ``byzpy_tpu/pre_aggregators/base.py`` (API parity:
``byzpy/pre_aggregators/base.py:9-74``). A pre-aggregator transforms a
sequence of vectors before aggregation and returns a list of vectors,
possibly fewer (bucketing). Subclasses implement ``_transform_matrix`` on
the stacked ``(n, d)`` matrix with :mod:`byzpy_tpu_torch.ops.preagg`.
Like the aggregators, every class takes a keyword-only ``device`` and
moves its inputs there.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List, Mapping, Sequence

import torch

from ..engine.graph.operator import OpContext, Operator
from ..utils.device import DeviceLike, resolve_device
from ..utils.trees import stack_gradients, unstack_rows


class PreAggregator(Operator, ABC):
    """Pre-aggregation: ``pre_aggregate`` transforms the ``(n, d)`` stack
    (clip, bucket, mix) before the aggregator runs."""

    name = "pre_aggregator"
    input_key = "vectors"

    def __init__(self, *, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)

    def compute(self, inputs: Mapping[str, Any], *, context: OpContext) -> List[Any]:
        if self.input_key not in inputs:
            raise KeyError(f"{self.name} expects input key {self.input_key!r}")
        values = inputs[self.input_key]
        if not isinstance(values, Sequence) and not hasattr(values, "ndim"):
            raise TypeError(f"{self.name} expects a sequence at {self.input_key!r}")
        return self.pre_aggregate(values)

    def pre_aggregate(self, xs: Sequence[Any]) -> List[Any]:
        matrix, unravel = stack_gradients(xs, device=self.device)
        self.validate_n(matrix.shape[0])
        return unstack_rows(self._transform_matrix(matrix), unravel)

    def pre_aggregate_stream(self, rounds: Sequence[Sequence[Any]]) -> List[List[Any]]:
        """Pre-aggregate ``K`` buffered rounds through
        ``_transform_stream_matrix`` on the stacked ``(K, n, d)`` rounds."""
        if not rounds:
            return []
        stacked = []
        unravel = None
        for xs in rounds:
            matrix, unravel = stack_gradients(xs, device=self.device)
            self.validate_n(matrix.shape[0])
            stacked.append(matrix)
        ys = self._transform_stream_matrix(torch.stack(stacked))
        return [unstack_rows(ys[i], unravel) for i in range(ys.shape[0])]

    def _transform_stream_matrix(self, xs: torch.Tensor) -> torch.Tensor:
        """Transform stacked rounds ``(K, n, d)`` round by round."""
        return torch.stack([self._transform_matrix(xs[k]) for k in range(xs.shape[0])])

    def validate_n(self, n: int) -> None:
        """Hook for subclasses to validate hyperparameters against n."""

    @abstractmethod
    def _transform_matrix(self, x: torch.Tensor) -> torch.Tensor:
        """Transform the stacked ``(n, d)`` matrix to ``(m, d)``."""


__all__ = ["PreAggregator"]
