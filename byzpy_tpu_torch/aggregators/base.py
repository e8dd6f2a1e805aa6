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

The masked finalize (``supports_masked_finalize``,
``_aggregate_matrix_masked``, ``masked_matrix_fn``, ``_masked_view``,
``aggregate_masked``, ``fold_finalize_masked``) aggregates a cohort of
``m`` rows padded into a bucket of ``n`` through the class's masked
program in :mod:`byzpy_tpu_torch.ops.robust`. The JAX package's jit
caches of that program (``_masked_jitted``, ``_masked_jitted_donated``)
have no counterpart: PyTorch runs eagerly, so the port calls the
function.

The ragged members (``ragged_score_kind``, ``ragged_coalesce``,
``supports_ragged``, ``ragged_group_key``, ``ragged_matrix_fn``) hand the
serving tier's flat-rows door (:mod:`byzpy_tpu_torch.serving.ragged`) a
program that aggregates a batch of cohorts at once; the default runs the
masked program per cohort (:func:`~byzpy_tpu_torch.ops.ragged.ragged_via_masked`).

The evidence members (``evidence_selects``, ``round_evidence``,
``merged_score_view``, ``_evidence_rows``, ``_evidence_view``) give the
forensics plane (:mod:`byzpy_tpu_torch.forensics`) each row's score and
the selection of one cohort. The scores run on the cohort matrix's device
through the port's own programs (``robust.krum_scores``,
``kernels.row_sq_dists``) and are read to the host once a view; the keep
set is the stable lowest-score pick of the aggregate, on the host.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..engine.graph.operator import OpContext, Operator
from ..ops import ragged as ragged_ops
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


def check_chunk_size(chunk_size: int) -> int:
    """``chunk_size`` as an int, validated as the JAX classes do: it sizes
    the subtasks of the actor pools (``aggregators/chunked.py``)."""
    if chunk_size <= 0:
        raise ValueError("chunk_size must be > 0")
    return int(chunk_size)


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

    # -- masked finalize (serving-tier bucketed cohorts) --------------------

    #: True when the subclass has a masked matrix program
    #: (``_aggregate_matrix_masked``): a fold declared for ``n`` slots, or a
    #: padded ``(n, d)`` matrix, then finalizes a cohort of ``m <= n`` valid
    #: rows at the bucket's shape. Without one (CAF), the exact subset path.
    supports_masked_finalize: bool = False

    def _aggregate_matrix_masked(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """Aggregate the valid rows of the padded ``(n, d)`` matrix to a
        ``(d,)`` vector, with size-``m`` semantics at the bucket's shape
        (:mod:`~byzpy_tpu_torch.ops.robust`'s masked section). Only called
        when :attr:`supports_masked_finalize` is True."""
        raise NotImplementedError(f"{type(self).__name__} has no masked matrix program")

    def masked_matrix_fn(self) -> Optional[Callable]:
        """The bare masked ``(matrix, valid) -> vector`` function, for the
        serving step (``parallel.ps.build_serving_ps_step``), or ``None``
        when the aggregator has no masked program."""
        if not self.supports_masked_finalize:
            return None
        return self._aggregate_matrix_masked

    def _masked_view(self, state: Any) -> Optional[tuple]:
        """``(buffer, valid_rows, unravel)``: the fold state's padded ingest
        buffer, a host list of booleans per slot and the unravel, or
        ``None`` when the state has no buffer."""
        if isinstance(state, SlotFoldState) and state.buffer is not None:
            return state.buffer, list(state.present), state.unravel
        return None

    def aggregate_masked(self, matrix: Any, valid: Any) -> torch.Tensor:
        """Aggregate of the valid rows of an already padded ``(n, d)``
        matrix (numpy or tensor; ``valid`` a host or device mask, read on
        the host), at the padded shape: finite cohorts run the masked
        program on the aggregator's device; non-finite cohorts, and
        aggregators without a masked program, take the exact subset path
        (``aggregate`` on the valid rows). ``m == 0`` raises, as does an
        ``m`` that ``validate_n`` refuses."""
        mask = valid.cpu().numpy() if isinstance(valid, torch.Tensor) else np.asarray(valid)
        valid_rows = [bool(v) for v in mask]
        m = sum(valid_rows)
        if m == 0:
            # validate_n is a no-op for the median, and the masked gathers
            # at (m - 1) // 2 would read a padding row on m = 0
            raise ValueError("aggregate_masked requires at least one valid row")
        self.validate_n(m)
        x = torch.as_tensor(matrix, device=self.device)
        if self.supports_masked_finalize and bool(torch.isfinite(x).all()):
            return self._aggregate_matrix_masked(
                x, torch.tensor(valid_rows, dtype=torch.bool, device=self.device))
        return self.aggregate([x[i] for i, v in enumerate(valid_rows) if v])

    def fold_finalize_masked(self, state: Any) -> Any:
        """Finish a round at the bucket's shape: aggregate the ``m``
        gradients folded into a state declared for ``n >= m`` slots through
        the masked program, on the fold's padded buffer. Falls back to
        :meth:`fold_finalize` when the class has no masked program, the
        state has no padded buffer, or the cohort holds a non-finite value
        (NaN and inf rows sort differently against the padding; the
        fallback keeps the barrier path's semantics)."""
        view = self._masked_view(state) if self.supports_masked_finalize else None
        if view is None:
            return self.fold_finalize(state)
        buffer, valid_rows, unravel = view
        m = sum(bool(v) for v in valid_rows)
        if m == 0:
            raise ValueError("fold_finalize before any gradient was folded")
        self.validate_n(m)
        # absent slots are zero in every fold buffer, so one reduction
        # answers whether the cohort is finite
        if not bool(torch.isfinite(buffer).all()):
            return self.fold_finalize(state)
        valid = torch.tensor(valid_rows, dtype=torch.bool, device=buffer.device)
        return unravel(self._aggregate_matrix_masked(buffer, valid))

    # -- ragged multi-cohort aggregation (serving-tier flat batches) --------

    #: Score family published by :meth:`ragged_matrix_fn`'s fused evidence
    #: outputs ("" = no per-row scores).
    ragged_score_kind: str = ""

    #: Whether several cohorts should share one ragged call for this
    #: aggregator: True where the program shares work across the batch
    #: (the selection families' one Gram or norm pass). Read by the
    #: reference's cross-tenant batcher, which comes with the async
    #: serving tier (ROADMAP A.6).
    ragged_coalesce: bool = False

    @property
    def supports_ragged(self) -> bool:
        """True when the aggregator can serve the flat-rows ragged door:
        any aggregator with a masked program (the generic per-cohort loop
        is always available)."""
        return self.supports_masked_finalize

    def ragged_group_key(self) -> tuple:
        """Hashable key for batching tenants: two aggregators may share one
        ragged call only when they run the same program (same class, same
        scalar hyperparameters). The device and any generator are not
        scalars and do not enter the key; the gradient dimension joins it
        at the dispatcher."""
        statics = tuple(sorted(
            (k, v) for k, v in vars(self).items() if isinstance(v, (int, float, str, bool))
        ))
        return (type(self).__qualname__, statics)

    def ragged_matrix_fn(self) -> Optional[Callable]:
        """The ragged program ``(flat, seg, offsets, lengths, *, n_cohorts,
        segment_sum=None, long_slots=False) -> (aggregates, scores, keep)``
        for one batch of cohorts (:mod:`byzpy_tpu_torch.ops.ragged`'s
        layout; ``long_slots``: some cohort may hold more than
        ``kernels.MAX_NETWORK_ROWS`` rows, a host fact the caller knows), or ``None``
        without a masked program. The default runs the masked program per
        cohort (no shared work, no scores); classes with a specialized
        program override it. Each cohort's result is bit for bit its
        unpadded aggregate under the masked contract (finite rows, an
        admissible ``m``: the serving door checks both)."""
        if not self.supports_masked_finalize:
            return None
        masked = self._aggregate_matrix_masked

        def generic(flat, seg, offsets, lengths, *, n_cohorts, segment_sum=None, long_slots=False):
            return ragged_ops.ragged_via_masked(masked, flat, seg, n_cohorts=n_cohorts), None, None

        return generic

    # -- forensics evidence (per-row score view) ---------------------------

    #: True when :meth:`round_evidence` publishes a binary keep set
    #: (selection aggregators: the Krum family, CGE, MoNNA), so a
    #: selection-only consumer can skip aggregators whose view carries
    #: scores but no selection.
    evidence_selects: bool = False

    def merged_score_view(self, merged: Mapping[str, Any], *, aggregate: Any = None) -> Optional[dict]:
        """Per-row ``{"kind", "scores", "keep"}`` view of a merged cohort
        (``merged["rows"]``, every row valid): :meth:`round_evidence` on the
        merged rows, or ``None`` for an empty merge. The reference's
        families that reuse merged extras here come with the sharded tier
        (ROADMAP A.6(c))."""
        rows = merged["rows"]
        if int(rows.shape[0]) == 0:
            return None
        return self.round_evidence(rows, np.ones((int(rows.shape[0]),), bool), aggregate=aggregate)

    def round_evidence(self, matrix: Any, valid: Any, *, aggregate: Any = None) -> Optional[dict]:
        """Per-row score/selection view of one (padded) cohort for the
        forensics plane, or ``None`` when the aggregator publishes no
        per-row scores (or the valid cohort is empty or inadmissible).

        Returns ``{"kind": str, "scores": (n,) float32 numpy, "keep": (n,)
        bool numpy or None}`` aligned to the padded slots (invalid rows
        carry NaN scores and False keeps). ``matrix`` is a tensor (scored
        on its device) or an array (scored on the aggregator's device);
        ``aggregate`` (the round's broadcast) is needed only by the
        centre-seeking aggregators, whose scores are distances to it."""
        return None

    def _evidence_rows(self, matrix: Any, valid: Any) -> Optional[tuple]:
        """Shared preamble of the ``round_evidence`` overrides: the valid
        rows as a float32 tensor (on the matrix's device, or the
        aggregator's for an array), their padded indices (host numpy) and
        the padded row count, or ``None`` when the valid cohort is empty or
        ``validate_n`` rejects its size."""
        mask = valid.cpu().numpy() if isinstance(valid, torch.Tensor) else valid
        mask = np.asarray(mask, bool)
        idx = np.flatnonzero(mask)
        m = int(idx.size)
        if m == 0:
            return None
        try:
            self.validate_n(m)
        except ValueError:
            return None
        if isinstance(matrix, torch.Tensor):
            x = matrix
        else:
            x = torch.as_tensor(np.asarray(matrix, np.float32), device=self.device)
        rows = x[torch.from_numpy(idx).to(x.device)].to(torch.float32)
        return rows, idx, int(mask.shape[0])

    @staticmethod
    def _evidence_view(kind: str, n: int, idx, scores, keep_local=None) -> dict:
        """Scatter compacted per-row ``scores`` (a tensor, read to the host
        here, or an array) and an optional local keep index set back to the
        padded positions."""
        if isinstance(scores, torch.Tensor):
            scores = scores.cpu().numpy()
        full = np.full((n,), np.nan, np.float32)
        full[idx] = np.asarray(scores, np.float32)
        keep = None
        if keep_local is not None:
            keep = np.zeros((n,), bool)
            keep[idx[np.asarray(keep_local)]] = True
        return {"kind": kind, "scores": full, "keep": keep}

    @staticmethod
    def _evidence_center(aggregate: Any, rows: torch.Tensor) -> torch.Tensor:
        """The round's aggregate as a ``(d,)`` float32 tensor on the rows'
        device (the centre-seeking views' distances are to it)."""
        return torch.as_tensor(aggregate).reshape(-1).to(device=rows.device, dtype=torch.float32)

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
