"""The ragged serving door: one program per tenant group aggregates a
whole batch of cohorts at once, and the runtime that feeds it.

Counterpart of ``byzpy_tpu/serving/ragged.py``: :class:`RaggedView` and
:class:`RaggedExecutor` on :mod:`byzpy_tpu_torch.ops.ragged`'s flat-rows
programs, and the frontend's async plane: :class:`RaggedRuntime` (tenant
groups, one executor a group, program-build accounting),
:func:`_dispatch_group` (one group's device call on an executor thread)
and :class:`RaggedBatcher` (the cross-tenant coalescer). A batch holds at
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
has no counterpart: :func:`ragged_segment_sum_fn` always hands the program
B11 for its row contractions, and :func:`ragged_segment_dequant_fn` B12
for the contraction over the scaled rows of a quantized batch. ``jax.jit``
has none either: the "compiled programs" counted by
:meth:`RaggedExecutor.expected_compiles` are the programs the executor
built, which the runtime reports to ``observability.jitstats``. The door's
switch is ``BYZPY_TPU_TORCH_RAGGED`` (:func:`ragged_enabled`; the
reference reads ``BYZPY_TPU_RAGGED``).

Streams: every dispatch runs on the calling thread's current stream, the
device's default stream for the runtime's executor threads as for the
event loop's, so a reader of a view's tensors on any thread is ordered
after the program that wrote them.

Any row capacity runs on the card: above 128 rows the Gram and the
masked programs' sorts take ``ops.robust``'s PyTorch counterparts, and the
segmented sort-reduce takes the batch whole. A batch with a cohort of more
than 128 rows (a fact of the host's sizes) runs the segmented programs'
PyTorch path (``long_slots=True``), never a slot the network cannot hold.
"""

from __future__ import annotations

import asyncio
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..observability import jitstats as obs_jitstats
from ..ops import kernels
from ..ops import ragged as ragged_ops
from ..parallel.quantization import dequantize_rows
from .cohort import Cohort

#: jitstats site of every ragged executor's built programs: over a
#: mixed-size swarm ``byzpy_jit_compiles_total{site="serving.ragged"}``
#: equals the tenant-group count (one program a group, plus one a wire
#: spec).
RAGGED_SITE = "serving.ragged"


def ragged_enabled() -> bool:
    """The ragged door's switch (``BYZPY_TPU_TORCH_RAGGED``; default on).
    Read at frontend construction: flipping it changes the next frontend
    built, not a live one."""
    return os.environ.get("BYZPY_TPU_TORCH_RAGGED", "1") != "0"


def ragged_segment_sum_fn(rows: int, dim: int) -> Callable:
    """The ragged program's row contraction ``(x, w, fill) -> (C, d)``:
    B11 (``kernels.segment_sum``) bounded by the batch's fill, for a
    program of ``rows`` flat rows of ``dim`` columns. The reference
    returns its Pallas kernel only on opt-in and ``None`` (its XLA
    contraction) otherwise; the port always takes B11, whose FMA chain is
    the XLA contraction's order."""

    def segment_sum(x, w, fill=None):
        return kernels.segment_sum(x, w, fill=fill)

    return segment_sum


def ragged_segment_dequant_fn(mode: str, block: int) -> Callable:
    """The fused-dequant contraction of a quantized batch, ``(codes,
    scales, w, *, d, fill, row_weights) -> (C, d)``: B12
    (``kernels.segment_sum_dequant``) for one wire spec, the staleness
    discounts applied per row inside it."""

    def seg_dequant(codes, scales, w, *, d, fill=None, row_weights=None):
        return kernels.segment_sum_dequant(codes, scales, w, mode=mode, block=block, d=d,
                                           fill=fill, row_weights=row_weights)

    return seg_dequant


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
        self._segment_sum = ragged_segment_sum_fn(self.rows, self.dim)
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
            return self._segment_sum(x, w, fill=fill)

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
        fused = ragged_segment_dequant_fn(mode, block)

        def program_q(codes, scales_q, seg, offsets, lengths, weights, fill):
            with record_function("serving.ragged_dequant"):
                flat = dequantize_rows(codes, scales_q, mode=mode, block=block, d=dim)
            with record_function("serving.ragged_scale"):
                scaled = flat * weights[:, None]

            def segment_sum(x, w):
                if x is scaled:
                    return fused(codes, scales_q, w, d=dim, fill=fill, row_weights=weights)
                return self._segment_sum(x, w, fill=fill)

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


class RaggedRuntime:
    """The frontend's ragged plane: tenant grouping, one executor a group,
    the cross-tenant batcher and the program-build accounting.

    Groups are computed once at construction: tenants sharing an
    aggregator signature (``Aggregator.ragged_group_key``) and gradient
    dimension share one executor, so their cohorts may coalesce into one
    device call. Tenants whose aggregator has no ragged program (no
    masked program: CAF, MDA, SMEA) are absent here and keep the
    bucket-ladder path."""

    def __init__(self, tenant_cfgs: Sequence[Any]) -> None:
        self._groups: Dict[tuple, dict] = {}
        self._by_tenant: Dict[str, tuple] = {}
        for cfg in tenant_cfgs:
            agg = cfg.aggregator
            if not getattr(agg, "supports_ragged", False):
                continue
            if agg.ragged_matrix_fn() is None:  # pragma: no cover
                continue
            key = (agg.ragged_group_key(), int(cfg.dim))
            g = self._groups.setdefault(
                key,
                {"aggregator": agg, "dim": int(cfg.dim), "caps": [], "names": [], "executor": None},
            )
            g["caps"].append(int(cfg.cohort_cap))
            g["names"].append(cfg.name)
            self._by_tenant[cfg.name] = key
        self._batcher: Optional["RaggedBatcher"] = None

    # -- introspection ---------------------------------------------------

    def serves(self, tenant: str) -> bool:
        return tenant in self._by_tenant

    def executor_for(self, tenant: str) -> Optional[RaggedExecutor]:
        """The tenant's group executor, built on first use: the row
        capacity is the group's largest cohort cap, the cohort cap the
        group's size for a coalescing family (one cohort a call
        otherwise), and no norm / cosine evidence (the plane reads the
        score view only)."""
        key = self._by_tenant.get(tenant)
        if key is None:
            return None
        g = self._groups[key]
        if g["executor"] is None:
            coalesce = bool(getattr(g["aggregator"], "ragged_coalesce", False))
            g["executor"] = RaggedExecutor(
                g["aggregator"], g["dim"],
                row_capacity=max(g["caps"]),
                max_cohorts=len(g["caps"]) if coalesce else 1,
                with_evidence=False,
            )
        return g["executor"]

    def _executors(self) -> List[RaggedExecutor]:
        return [g["executor"] for g in self._groups.values() if g["executor"] is not None]

    def snapshot(self) -> dict:
        """JSON-ready accounting for ``ServingFrontend.stats()``
        (``compile_entries``: the programs the executors built)."""
        execs = self._executors()
        batched = self._batcher
        return {
            "groups": len(self._groups),
            "tenants": sorted(self._by_tenant),
            "dispatches": sum(e.dispatches for e in execs),
            "cohorts_dispatched": sum(e.cohorts_dispatched for e in execs),
            "quantized_dispatches": sum(e.quantized_dispatches for e in execs),
            "compile_entries": sum(e.expected_compiles() for e in execs),
            "batched_calls": 0 if batched is None else batched.batched_calls,
            "max_batch": max([e.max_batch for e in execs], default=0),
        }

    # -- program-build accounting ----------------------------------------

    def note_compiles(self) -> None:
        """Report the programs the executors built to the
        ``serving.ragged`` jitstats site. The reference also warns when its
        jit caches outgrow one program a group plus one a wire spec; the
        port counts the programs it built, which are exactly those."""
        obs_jitstats.note_cache_size(
            RAGGED_SITE, sum(obs_jitstats.programs_built(e) for e in self._executors()))

    # -- dispatch doors --------------------------------------------------

    def aggregate_sync(self, tenant: str, cohort: Cohort) -> Optional[RaggedView]:
        """Single-cohort synchronous dispatch (the virtual-time round
        closer's door); ``None`` when the tenant is not ragged-served."""
        ex = self.executor_for(tenant)
        if ex is None:
            return None
        (view,) = ex.aggregate([cohort], [tenant])
        self.note_compiles()
        return view

    async def start(self, device_lock: asyncio.Lock) -> None:
        self._batcher = RaggedBatcher(self, device_lock)
        await self._batcher.start()

    async def close(self) -> None:
        if self._batcher is not None:
            await self._batcher.close()
            self._batcher = None

    async def aggregate_async(self, tenant: str, cohort: Cohort, fallback: Any = None) -> RaggedView:
        """Enqueue one closed cohort for batched dispatch and await its view
        (the async scheduler's door; requires :meth:`start`). ``fallback``
        (a :class:`~byzpy_tpu_torch.serving.cohort.CohortAggregator`)
        serves non-finite cohorts through the exact guarded door; the
        finite gate runs on the dispatch thread, never on the event loop."""
        assert self._batcher is not None, "RaggedRuntime.start() first"
        return await self._batcher.submit(tenant, cohort, fallback)


def _dispatch_group(ex: RaggedExecutor, items: Sequence[Tuple[str, Cohort, Any]]) -> List[Any]:
    """One group's device call, on an executor thread: gate each cohort's
    finiteness (one host read a cohort), send the finite ones through the
    ragged program in as few dispatches as its capacity allows, and route
    non-finite cohorts through their tenant's exact guarded door
    (``CohortAggregator.aggregate``). Returns one ``RaggedView`` or
    ``Exception`` per item, in order."""
    finite_items: List[Tuple[int, str, Cohort]] = []
    results: List[Any] = [None] * len(items)
    for i, (tenant, cohort, fallback) in enumerate(items):
        if cohort.finite():
            finite_items.append((i, tenant, cohort))
        else:
            try:
                if fallback is None:
                    raise ValueError("non-finite cohort and no fallback aggregator")
                results[i] = RaggedView(vector=fallback.aggregate(cohort), score_kind="", scores=None,
                                        keep=None, norms=None, cos=None)
            except Exception as exc:  # noqa: BLE001 — its round fails, the batch serves
                results[i] = exc
    # greedy chunking against the program's capacity: a non-coalescing
    # executor (max_cohorts=1) serves one cohort a call
    chunks: List[List[Tuple[int, str, Cohort]]] = []
    chunk: List[Tuple[int, str, Cohort]] = []
    rows = 0
    for item in finite_items:
        m = item[2].m
        if chunk and (len(chunk) == ex.max_cohorts or rows + m > ex.rows):
            chunks.append(chunk)
            chunk, rows = [], 0
        chunk.append(item)
        rows += m
    if chunk:
        chunks.append(chunk)
    for chunk in chunks:
        try:
            views = ex.aggregate([c for _, _, c in chunk], [t for _, t, _ in chunk])
        except Exception as exc:  # noqa: BLE001
            for i, _, _ in chunk:
                results[i] = exc
        else:
            for (i, _, _), view in zip(chunk, views, strict=True):
                results[i] = view
    return results


class RaggedBatcher:
    """Cross-tenant cohort coalescer: one dispatcher task holds the device
    lock while a batch runs and drains everything pending the moment it
    reacquires it, so cohorts that closed while the previous batch was on
    the device ride the next call together."""

    def __init__(self, runtime: RaggedRuntime, device_lock: asyncio.Lock) -> None:
        self._runtime = runtime
        self._lock = device_lock
        self._pending: List[Tuple[str, Cohort, Any, asyncio.Future]] = []
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        #: dispatcher wake-ups that reached the device
        self.batched_calls = 0

    async def start(self) -> None:
        self._task = asyncio.create_task(self._run(), name="serving-ragged-batcher")

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._task = None
        for _, _, _, fut in self._pending:
            if not fut.done():
                fut.cancel()
        self._pending = []

    async def submit(self, tenant: str, cohort: Cohort, fallback: Any = None) -> RaggedView:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending.append((tenant, cohort, fallback, fut))
        self._wake.set()
        return await fut

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            await self._wake.wait()
            self._wake.clear()
            if not self._pending:
                continue
            # one yield so tenant loops whose windows expired in the same
            # pass join this batch instead of trailing it
            await asyncio.sleep(0)
            batch: List[Tuple[str, Cohort, Any, asyncio.Future]] = []
            try:
                async with self._lock:
                    batch, self._pending = self._pending, []
                    if not batch:
                        continue
                    by_exec: Dict[int, dict] = {}
                    for tenant, cohort, fallback, fut in batch:
                        ex = self._runtime.executor_for(tenant)
                        assert ex is not None, tenant
                        slot = by_exec.setdefault(id(ex), {"ex": ex, "items": []})
                        slot["items"].append((tenant, cohort, fallback, fut))
                    for slot in by_exec.values():
                        items = slot["items"]
                        results = await loop.run_in_executor(
                            None, _dispatch_group, slot["ex"], [(t, c, fb) for t, c, fb, _ in items])
                        self.batched_calls += 1
                        for (_, _, _, fut), res in zip(items, results, strict=True):
                            if fut.done():
                                continue
                            if isinstance(res, Exception):
                                fut.set_exception(res)
                            else:
                                fut.set_result(res)
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — the dispatcher outlives any
                # failure: the drained batch's rounds fail, serving goes on
                for _, _, _, fut in batch:
                    if not fut.done():
                        fut.set_exception(exc)
            self._runtime.note_compiles()


__all__ = [
    "RAGGED_SITE",
    "RaggedBatcher",
    "RaggedExecutor",
    "RaggedRuntime",
    "RaggedView",
    "ragged_enabled",
    "ragged_segment_dequant_fn",
    "ragged_segment_sum_fn",
]
