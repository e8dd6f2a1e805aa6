"""The ragged serving door, its synchronous half: one program per tenant
group aggregates a whole batch of cohorts at once.

Counterpart of ``byzpy_tpu/serving/ragged.py`` (:1-415): :class:`RaggedView`
and :class:`RaggedExecutor`, on
:mod:`byzpy_tpu_torch.ops.ragged`'s flat-rows programs. A batch holds at
most ``max_cohorts`` cohorts in at most ``row_capacity`` rows; every
cohort's aggregate is bit for bit its unpadded aggregate, and the masked
finalize's (``CohortAggregator``), for any batch composition, on finite
rows.

Batched quantized ingress: when every cohort of a batch is still wire
codes of one spec (``build_cohort(quantized=True)``), the batch enters
the program as codes and scales. Its first operation decodes them on the
device (``parallel.quantization.dequantize_rows``: B14, or B17 for s4),
and the
contraction over the scaled rows reads the codes themselves (B12,
``kernels.segment_sum_dequant``, the staleness discount applied per row
inside it), so a quantized dispatch gives the dense program's bits on the
decoded rows.

The reference's env gate on its Pallas kernels (``BYZPY_TPU_RAGGED_PALLAS``)
has no counterpart: the executor always hands the program B11 for its row
contractions, and B12 for the contraction over the scaled rows of a
quantized batch. ``jax.jit`` has none either: the "compiled programs"
counted by :meth:`RaggedExecutor.expected_compiles` are the programs the
executor built. The async half (``RaggedRuntime``, ``RaggedBatcher``,
the admission queue) and the door's switch ``ragged_enabled``, which
only the runtime reads, are serving code that waits for the front end
(ROADMAP A.6).

Any row capacity runs on the card: above 128 rows the Gram and the
masked programs' sorts take ``ops.robust``'s PyTorch counterparts, and the
segmented sort-reduce takes the batch whole. A batch with a cohort of more
than 128 rows (a fact of the host's sizes) runs the segmented programs'
PyTorch path (``long_slots=True``), never a slot the network cannot hold.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ..ops import kernels
from ..ops import ragged as ragged_ops
from ..parallel.quantization import dequantize_rows
from .cohort import Cohort


@dataclass(frozen=True)
class RaggedView:
    """One cohort's slice of a ragged dispatch, on the executor's device:
    the aggregate vector and the fused forensics outputs (``scores`` /
    ``keep`` ``None`` for aggregators that publish no scores; ``norms`` /
    ``cos`` computed on the discounted rows, ``None`` without evidence)."""

    vector: torch.Tensor
    score_kind: str
    scores: Optional[torch.Tensor]
    keep: Optional[torch.Tensor]
    norms: Optional[torch.Tensor]
    cos: Optional[torch.Tensor]

    def precomputed(self) -> Optional[dict]:
        """The forensics plane's ``precomputed=`` payload, or ``None`` when
        the aggregator publishes no score view."""
        if self.scores is None:
            return None
        return {"kind": self.score_kind, "scores": self.scores, "keep": self.keep}


class RaggedExecutor:
    """One tenant group's ragged program: ``row_capacity`` flat rows and
    ``max_cohorts`` cohorts of dimension ``dim``, on the aggregator's
    device. A dispatch scales each row by its staleness discount (a weight
    of 1.0 keeps the row's bits), aggregates every cohort and, with
    ``with_evidence``, computes each row's norm and cosine to its cohort's
    aggregate."""

    def __init__(
        self,
        aggregator: Any,
        dim: int,
        row_capacity: int,
        max_cohorts: int,
        with_evidence: bool = True,
    ) -> None:
        fn = aggregator.ragged_matrix_fn()
        if fn is None:
            raise ValueError(f"{type(aggregator).__name__} has no ragged program")
        self.device = aggregator.device
        self.dim = int(dim)
        self.rows = int(row_capacity)
        self.max_cohorts = int(max_cohorts)
        self.score_kind = aggregator.ragged_score_kind
        self.dispatches = 0
        self.cohorts_dispatched = 0
        #: largest number of cohorts one dispatch carried
        self.max_batch = 0
        #: dispatches whose rows entered the program as wire codes
        self.quantized_dispatches = 0
        self._fn = fn
        self._with_evidence = bool(with_evidence)
        #: whether the batch in flight has a cohort longer than the networks
        self._long_slots = False
        #: the quantized programs built, one per wire spec (mode, block)
        self._quant_programs: Dict[tuple, Callable] = {}

    def _run(self, scaled, seg, offsets, lengths, segment_sum):
        """The aggregation body shared by both programs."""
        with record_function("serving.ragged_aggregate"):
            aggs, score, keep = self._fn(scaled, seg, offsets, lengths,
                                         n_cohorts=self.max_cohorts, segment_sum=segment_sum,
                                         long_slots=self._long_slots)
        if not self._with_evidence:
            return aggs, score, keep, None, None
        with record_function("serving.ragged_evidence"):
            norm, cos = ragged_ops.ragged_evidence(scaled, seg, aggs, n_cohorts=self.max_cohorts)
        return aggs, score, keep, norm, cos

    def _program(self, flat, seg, offsets, lengths, weights, fill):
        """The dense program: scale the rows, aggregate with B11 bounded by
        the batch's fill."""
        with record_function("serving.ragged_scale"):
            scaled = flat * weights[:, None].to(flat.dtype)

        def segment_sum(x, w):
            return kernels.segment_sum(x, w, fill=fill)

        return self._run(scaled, seg, offsets, lengths, segment_sum)

    def _jitted_quant(self, mode: str, block: int) -> Callable:
        """The quantized program for one wire spec, built once: decode the
        codes as its first operation, scale, then the dense program's body,
        except that the contraction over the scaled rows (``x is scaled``,
        an identity test: sorted or derived operands are not wire rows)
        reads the codes through B12 with the discounts as its row weights.
        A quantized batch's aggregates are the dense program's on the
        decoded rows, bit for bit."""
        key = (mode, block)
        program = self._quant_programs.get(key)
        if program is not None:
            return program
        dim = self.dim

        def program_q(codes, scales_q, seg, offsets, lengths, weights, fill):
            with record_function("serving.ragged_dequant"):
                flat = dequantize_rows(codes, scales_q, mode=mode, block=block, d=dim)
            with record_function("serving.ragged_scale"):
                scaled = flat * weights[:, None]

            def segment_sum(x, w):
                if x is scaled:
                    return kernels.segment_sum_dequant(codes, scales_q, w, mode=mode, block=block,
                                                       d=dim, fill=fill, row_weights=weights)
                return kernels.segment_sum(x, w, fill=fill)

            return self._run(scaled, seg, offsets, lengths, segment_sum)

        self._quant_programs[key] = program_q
        return program_q

    @staticmethod
    def _quant_spec(cohorts: Sequence[Cohort]) -> Optional[tuple]:
        """The shared wire spec ``(mode, block, ncodes, nb, d)`` when every
        cohort of the batch is still quantized with one layout, else
        ``None`` (the batch is decoded and takes the dense program)."""
        specs = {
            (c.qmode, c.qblock, int(c.qcodes.shape[1]), int(c.qscales.shape[1]), c.qdim)
            if c.quantized else None
            for c in cohorts
        }
        return specs.pop() if len(specs) == 1 else None

    def expected_compiles(self) -> int:
        """Programs this executor owns: the dense one plus one per wire
        spec seen."""
        return 1 + len(self._quant_programs)

    def aggregate(self, cohorts: Sequence[Cohort], tenants: Sequence[str]) -> List[RaggedView]:
        """One dispatch for ``cohorts`` (at most ``max_cohorts``, their rows
        at most ``row_capacity``); one :class:`RaggedView` per cohort, in
        order. Callers guarantee each cohort is finite and admissible. The
        batch layout (segment ids, offsets, lengths, discounts) is built
        on the host from host sizes and copied to the device; nothing is
        read back. ``tenants`` names the cohorts' tenants (trace
        attribution in the reference; unused here)."""
        n = len(cohorts)
        if not 1 <= n <= self.max_cohorts:
            raise ValueError(f"batch of {n} cohorts exceeds max_cohorts={self.max_cohorts}")
        for cohort in cohorts:
            d = cohort.qdim if cohort.quantized else int(cohort.matrix.shape[1])
            if d != self.dim:
                raise ValueError(f"cohort of dimension {d} in an executor of dimension {self.dim}")
        sizes = [c.m for c in cohorts]
        fill = sum(sizes)
        if fill > self.rows:
            raise ValueError(f"batch of {fill} rows exceeds row capacity {self.rows}")
        seg = np.full((self.rows,), self.max_cohorts, np.int32)
        weights = np.zeros((self.rows,), np.float32)
        offsets = np.full((self.max_cohorts,), fill, np.int32)
        lengths = np.zeros((self.max_cohorts,), np.int32)
        off = 0
        for c, cohort in enumerate(cohorts):
            m = sizes[c]
            weights[off:off + m] = cohort.weights[:m]
            seg[off:off + m] = c
            offsets[c] = off
            lengths[c] = m
            off += m
        self._long_slots = max(sizes) > kernels.MAX_NETWORK_ROWS
        dev = self.device
        qspec = self._quant_spec(cohorts)
        if qspec is not None:
            mode, block, ncodes, nb, _ = qspec
            codes = torch.zeros((self.rows, ncodes), dtype=cohorts[0].qcodes.dtype, device=dev)
            scales = torch.zeros((self.rows, nb), dtype=torch.float32, device=dev)
            off = 0
            for c, cohort in enumerate(cohorts):
                codes[off:off + sizes[c]] = cohort.qcodes[:sizes[c]]
                scales[off:off + sizes[c]] = cohort.qscales[:sizes[c]]
                off += sizes[c]
            program = self._jitted_quant(mode, block)
            rows_args = (codes, scales)
            self.quantized_dispatches += 1
        else:
            flat = torch.zeros((self.rows, self.dim), dtype=torch.float32, device=dev)
            off = 0
            for c, cohort in enumerate(cohorts):
                flat[off:off + sizes[c]] = cohort.matrix[:sizes[c]]
                off += sizes[c]
            program = self._program
            rows_args = (flat,)
        with record_function("serving.fold"):
            aggs, score, keep, norm, cos = program(
                *rows_args, *(torch.from_numpy(a).to(dev) for a in (seg, offsets, lengths, weights)),
                fill)
        self.dispatches += 1
        self.cohorts_dispatched += n
        self.max_batch = max(self.max_batch, n)
        views = []
        off = 0
        for c, m in enumerate(sizes):
            part = slice(off, off + m)
            views.append(RaggedView(
                vector=aggs[c],
                score_kind=self.score_kind,
                scores=None if score is None else score[part],
                keep=None if keep is None else keep[part],
                norms=None if norm is None else norm[part],
                cos=None if cos is None else cos[part],
            ))
            off += m
        return views


__all__ = ["RaggedExecutor", "RaggedView"]
