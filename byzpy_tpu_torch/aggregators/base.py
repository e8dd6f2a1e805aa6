"""Aggregator base class.

Counterpart of ``byzpy_tpu/aggregators/base.py`` (API parity:
``byzpy/aggregators/base.py:11-103``). An aggregator reduces a sequence of
per-node gradients (tensors or numpy arrays of any rank, nested
dictionaries / lists / tuples of them, or an already stacked ``(n, d)``
matrix) to one aggregated gradient with the structure of one input.
Subclasses implement ``_aggregate_matrix`` on the stacked matrix, with
the functions of :mod:`byzpy_tpu_torch.ops.robust`.

Every class takes a keyword-only ``device`` (``None``: the CUDA card,
raising where there is none; ``"cpu"`` on request). Every input, numpy
or tensor, is moved there, and results stay there. The JAX package's rule
that small host-resident inputs run on the CPU (``utils/placement.py``)
is not ported: it would hide the device.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Mapping, Optional, Sequence

import torch

from ..engine.graph.operator import OpContext, Operator
from ..ops import robust
from ..utils.device import DeviceLike, resolve_device
from ..utils.trees import ravel_pytree, stack_gradients


def ravel_gradient(gradient: Any, device: DeviceLike = None) -> tuple:
    """Flatten one gradient to a ``(d,)`` row on ``device`` the way
    :func:`~byzpy_tpu_torch.utils.trees.stack_gradients` would (a row that
    is not floating becomes float32). Returns ``(row, unravel)``."""
    row, unravel = ravel_pytree(gradient, device=device)
    if not row.is_floating_point():
        row = row.float()
    return row, unravel


def check_chunk_size(chunk_size: int, default: int) -> None:
    """Validate ``chunk_size`` as the JAX classes do. It sizes the subtasks
    of the actor pools, which are not ported yet, so a value other than
    the class's default raises rather than being ignored."""
    if chunk_size <= 0:
        raise ValueError("chunk_size must be > 0")
    if chunk_size != default:
        raise NotImplementedError(
            f"chunk_size={chunk_size}: the pool-chunked subtasks are not ported yet "
            f"(leave it at {default})"
        )


class SlotFoldState:
    """Default streaming-fold state: an arrival-order ingestion buffer.

    Each gradient is flattened the moment it arrives (``fold``) and
    written in place into its canonical node slot of a preallocated ``(n,
    d)`` buffer on the aggregator's device; ``fold_finalize`` aggregates
    the filled slots in slot order. The matrix is the barrier path's
    (same per-row flatten, same order), so the result is bit-identical to
    ``aggregate`` for any arrival order. A partial round gathers the
    filled slots. A row of a wider dtype than the buffer's promotes the
    buffer in place as ``torch.stack`` promotes the barrier matrix (an
    exact upcast of the rows staged so far)."""

    __slots__ = ("n", "device", "present", "unravel", "dim", "filled", "buffer")

    def __init__(self, n: int, device: DeviceLike = None) -> None:
        # the one capacity guard for every fold state (the incremental
        # folds all embed a slot buffer)
        if n <= 0:
            raise ValueError(f"fold_init needs n >= 1 (got {n})")
        self.n = n
        self.device = device
        self.present = [False] * n
        self.unravel: Optional[Callable[[torch.Tensor], Any]] = None
        self.dim: Optional[int] = None
        self.filled = 0
        #: (n, d) ingest buffer; None until the first row
        self.buffer: Optional[torch.Tensor] = None

    def admit(self, index: int, gradient: Any) -> torch.Tensor:
        """Check slot ``index``, flatten ``gradient``, and allocate or
        promote the buffer for it; returns the row, which the caller
        writes into ``buffer[index]``."""
        if not 0 <= index < self.n:
            raise IndexError(f"slot {index} outside [0, {self.n})")
        if self.present[index]:
            raise ValueError(f"slot {index} folded twice")
        row, unravel = ravel_gradient(gradient, self.device)
        if self.dim is None:
            self.dim = int(row.shape[0])
            self.unravel = unravel
        elif int(row.shape[0]) != self.dim:
            raise ValueError(
                f"all gradients must flatten to the same length "
                f"(got {row.shape[0]} != {self.dim})"
            )
        if self.buffer is None:
            self.buffer = torch.zeros((self.n, self.dim), dtype=row.dtype, device=row.device)
        elif row.dtype != self.buffer.dtype:
            self.buffer = self.buffer.to(torch.promote_types(self.buffer.dtype, row.dtype))
        self.present[index] = True
        self.filled += 1
        return row

    def insert(self, index: int, gradient: Any) -> torch.Tensor:
        """Flatten ``gradient`` into slot ``index``; returns the row."""
        row = self.admit(index, gradient)
        self.buffer[index] = row
        return row

    def filled_slots(self) -> torch.Tensor:
        """The filled slots' indices, ascending, on the buffer's device."""
        idx = [i for i, p in enumerate(self.present) if p]
        return torch.tensor(idx, device=self.buffer.device)

    def stacked(self) -> tuple:
        """``(matrix, unravel)`` over the filled slots, in slot order: the
        buffer itself for a complete round, its filled rows for a partial
        one."""
        if self.filled == 0:
            raise ValueError("fold_finalize before any gradient was folded")
        if self.filled == self.n:
            return self.buffer, self.unravel
        return self.buffer[self.filled_slots()], self.unravel


class Aggregator(Operator, ABC):
    """Robust gradient aggregator: subclasses map an ``(n, d)`` stack of
    per-node gradients to one ``(d,)`` vector through ``aggregate`` /
    ``aggregate_stream`` / the fold hooks."""

    name = "aggregator"
    input_key = "gradients"

    #: Arrival-order streaming capability: gradients may be fed through
    #: ``fold``/``fold_finalize`` as they land. The base implementation
    #: (slot buffer, slot-order aggregate) is bit-identical to
    #: ``aggregate``; subclasses with incremental math (running sums,
    #: extreme buffers, Gram rows) override the hooks.
    supports_streaming: bool = True

    def __init__(self, *, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)

    def compute(self, inputs: Mapping[str, Any], *, context: OpContext) -> Any:
        if self.input_key not in inputs:
            raise KeyError(f"{self.name} expects input key {self.input_key!r}")
        gradients = inputs[self.input_key]
        if not isinstance(gradients, Sequence) and not hasattr(gradients, "ndim"):
            raise TypeError(f"{self.name} expects a sequence at {self.input_key!r}")
        return self.aggregate(gradients)

    def aggregate(self, gradients: Sequence[Any]) -> Any:
        """Reduce a sequence of gradients to one aggregated gradient."""
        matrix, unravel = stack_gradients(gradients, device=self.device)
        self.validate_n(matrix.shape[0])
        return unravel(self._aggregate_matrix(matrix))

    def aggregate_stream(self, rounds: Sequence[Sequence[Any]]) -> list:
        """Aggregate ``K`` buffered rounds (``K`` sequences of per-node
        gradients of one structure) through ``_aggregate_stream_matrix`` on
        the stacked ``(K, n, d)`` rounds."""
        if not rounds:
            return []
        stacked = []
        unravel = None
        for grads in rounds:
            matrix, unravel = stack_gradients(grads, device=self.device)
            self.validate_n(matrix.shape[0])
            stacked.append(matrix)
        ys = self._aggregate_stream_matrix(torch.stack(stacked))
        return [unravel(ys[i]) for i in range(ys.shape[0])]

    def _aggregate_stream_matrix(self, xs: torch.Tensor) -> torch.Tensor:
        """Aggregate stacked rounds ``(K, n, d)`` to ``(K, d)``."""
        return robust.aggregate_stream(self._aggregate_matrix, xs)

    # -- arrival-order streaming ------------------------------------------

    def fold_init(self, n: int) -> Any:
        """Streaming-fold state for up to ``n`` gradients. Slots are
        canonical node positions, not arrival ranks, so selection tie rules
        see the row indices of ``aggregate``."""
        return SlotFoldState(n, self.device)

    def fold(self, state: Any, index: int, gradient: Any) -> None:
        """Ingest one gradient the moment it arrives (slot ``index``)."""
        state.insert(index, gradient)

    def fold_finalize(self, state: Any) -> Any:
        """Aggregate everything folded so far, in slot order."""
        matrix, unravel = state.stacked()
        self.validate_n(matrix.shape[0])
        return unravel(self._aggregate_matrix(matrix))

    def validate_n(self, n: int) -> None:
        """Hook for subclasses to validate hyperparameters against n."""

    @abstractmethod
    def _aggregate_matrix(self, x: torch.Tensor) -> torch.Tensor:
        """Aggregate the stacked ``(n, d)`` matrix to a ``(d,)`` vector."""

    def matrix_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """The bare matrix -> vector function, for a training step's
        ``aggregate`` (``parallel.ps.build_ps_train_step``)."""
        return self._aggregate_matrix


__all__ = ["Aggregator", "SlotFoldState", "check_chunk_size", "ravel_gradient"]
