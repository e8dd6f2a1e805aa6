"""Subtask-chunking mixins for aggregators on actor pools.

Counterpart of ``byzpy_tpu/aggregators/chunked.py``. The reference
parallelizes aggregators by slicing the stacked gradient matrix into
chunks fanned out to pool workers (feature chunks for coordinate-wise
ops, ``median.py:108-134``; row / score chunks for geometric ops,
``krum.py:371-475``; per-iteration row chunks for the centre-seeking
ones, ``geometric_median.py:106-158``). On one card the direct path (a
few kernel launches over the whole matrix) is the fast one; the chunked
path serves pools and keeps the reference's scheduling behaviour.

Unlike the JAX package, which copies the matrix to the host
(``np.asarray``) and ships numpy chunks, the chunks here never leave the
matrix's device: a feature chunk is a column view of the stacked matrix
(made contiguous by the chunk function, on the worker, before it reaches
a kernel), a row-score subtask gets the whole matrix and its row range,
and the barriered mode passes row blocks (views) by reference instead of
the shared store's handles; its centre is a tensor on the device too.
The in-process workers of ``engine.actor`` take the views as they are
(ROADMAP C).

The chunk functions are module-level, as the reference's are.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Sequence

import torch

from ..engine.graph.chunking import pool_size_from_context, select_adaptive_chunk_size
from ..engine.graph.operator import OpContext, _maybe_await
from ..engine.graph.subtask import SubTask
from ..utils.trees import stack_gradients, unravel_like


class FeatureChunkedAggregator:
    """Mixin: fan out column (feature) chunks; concatenate the partial
    vectors.

    Subclasses set ``_chunk_fn`` to a module-level ``fn(chunk, **params)``
    returning the aggregated vector of those coordinates, and
    ``_chunk_params()`` for its keyword arguments.
    """

    supports_subtasks = True
    chunk_size = 8192
    _chunk_fn: Any = None

    def _chunk_params(self) -> Mapping[str, Any]:
        return {}

    def create_subtasks(self, inputs, *, context: OpContext) -> Iterable[SubTask]:
        # stateless across create / reduce: reduce re-derives the unravel
        # from `inputs`, so one instance can serve several graph nodes at once
        matrix, _ = stack_gradients(inputs.get(self.input_key), device=self.device)
        self.validate_n(matrix.shape[0])
        d = matrix.shape[1]
        chunk = select_adaptive_chunk_size(
            d, self.chunk_size, pool_size=pool_size_from_context(context)
        )
        params = dict(self._chunk_params())
        fn = type(self)._chunk_fn

        def gen():
            for start in range(0, d, chunk):
                end = min(d, start + chunk)
                yield SubTask(
                    fn=fn,
                    args=(matrix[:, start:end],),
                    kwargs=params,
                    name=f"{self.name}-feat[{start}:{end}]",
                )

        return gen()

    def reduce_subtasks(self, partials: Sequence[Any], inputs, *, context: OpContext) -> Any:
        # a process or remote worker answers with host tensors
        vec = torch.cat([p.to(self.device) for p in partials])
        return unravel_like(inputs.get(self.input_key), self.device)(vec)


class RowScoredAggregator:
    """Mixin: fan out row-range scoring against the full matrix, then
    select rows centrally (the Krum / MoNNA / CGE pattern)."""

    supports_subtasks = True
    chunk_size = 32
    _score_fn: Any = None

    def _score_params(self) -> Mapping[str, Any]:
        return {}

    def _select_from_scores(self, scores: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def create_subtasks(self, inputs, *, context: OpContext) -> Iterable[SubTask]:
        matrix, _ = stack_gradients(inputs.get(self.input_key), device=self.device)
        self.validate_n(matrix.shape[0])
        n = matrix.shape[0]
        chunk = select_adaptive_chunk_size(
            n, self.chunk_size, pool_size=pool_size_from_context(context)
        )
        params = dict(self._score_params())
        fn = type(self)._score_fn

        def gen():
            for start in range(0, n, chunk):
                end = min(n, start + chunk)
                yield SubTask(
                    fn=fn,
                    args=(matrix, start, end),
                    kwargs=params,
                    name=f"{self.name}-rows[{start}:{end}]",
                )

        return gen()

    def reduce_subtasks(self, partials: Sequence[Any], inputs, *, context: OpContext) -> Any:
        matrix, unravel = stack_gradients(inputs.get(self.input_key), device=self.device)
        scores = torch.cat([p.to(matrix.device) for p in partials])
        return unravel(self._select_from_scores(scores, matrix))


# ---------------------------------------------------------------------------
# Barriered iterative fan-out (the reference's third execution mode:
# ``byzpy/engine/graph/operator.py:50-60`` dispatching to per-iteration
# chunk fan-outs like ``geometric_median.py:106-158`` and
# ``center_clipping.py:158-257``)
# ---------------------------------------------------------------------------


def _weiszfeld_chunk(block: torch.Tensor, center: torch.Tensor, *, eps: float):
    """One Weiszfeld term over a row block: ``(sum_i w_i x_i, sum_i w_i)``
    with ``w_i = 1 / max(||x_i - z||, eps)``, both on the block's device
    (the sum of weights a 0-d tensor: no host read)."""
    diff = block - center[None, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=1))
    w = 1.0 / torch.clamp(dist, min=eps)
    return torch.sum(w[:, None] * block, dim=0), torch.sum(w)


def _centered_clip_chunk(block: torch.Tensor, center: torch.Tensor, *, c_tau: float, eps: float):
    """One centred-clipping contribution over a row block:
    ``(sum_i clip(x_i - v, c_tau), rows)``."""
    diff = block - center[None, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=1))
    scale = torch.clamp(c_tau / torch.clamp(dist, min=eps), max=1.0)
    return torch.sum(diff * scale[:, None], dim=0), int(block.shape[0])


def _on_device(partial: Any, device: torch.device) -> Any:
    """A barrier partial (a tuple of tensors and ints) on ``device``: a
    process or remote worker answers with host tensors."""
    return tuple(v.to(device) if isinstance(v, torch.Tensor) else v for v in partial)


def sum_in_order(values: Sequence[Any]) -> Any:
    """``values[0] + values[1] + ...``, left to right (the partials of a
    barrier, in row order)."""
    total = values[0]
    for v in values[1:]:
        total = total + v
    return total


class BarrieredIterativeAggregator:
    """Mixin: per-iteration fan-out of row-block contributions with a
    barrier and a coordinator-side update of the centre.

    Subclasses set the module-level ``_barrier_chunk_fn`` plus the hooks
    below. Row blocks are views of the stacked matrix, passed by
    reference; only the centre (a device tensor) changes per iteration,
    and the convergence test reads the host once an iteration. With no
    pool (or one worker) the direct ``compute`` path runs instead: one B7
    launch for the whole loop on the card.
    """

    supports_barriered_subtasks = True
    row_chunk_size = 16
    _barrier_chunk_fn: Any = None

    def _barrier_params(self) -> Mapping[str, Any]:
        return {}

    def _barrier_init(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _barrier_update(self, partials: Sequence[Any], center: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _barrier_max_iters(self) -> int:
        raise NotImplementedError

    def _barrier_converged(self, old: torch.Tensor, new: torch.Tensor) -> bool:
        return False

    async def run_barriered_subtasks(self, inputs, *, context: OpContext, pool) -> Any:
        if pool is None or pool.size <= 1:
            return await _maybe_await(self.compute(inputs, context=context))
        matrix, unravel = stack_gradients(inputs.get(self.input_key), device=self.device)
        self.validate_n(matrix.shape[0])
        n = matrix.shape[0]
        chunk = select_adaptive_chunk_size(n, self.row_chunk_size, pool_size=pool.size)
        params = dict(self._barrier_params())
        fn = type(self)._barrier_chunk_fn
        spans = [(start, min(n, start + chunk)) for start in range(0, n, chunk)]
        blocks = [matrix[s:e] for s, e in spans]
        center = self._barrier_init(matrix)
        for _ in range(self._barrier_max_iters()):
            tasks = [
                SubTask(fn=fn, args=(b, center), kwargs=params,
                        name=f"{self.name}-iter-rows[{s}:{e}]")
                for b, (s, e) in zip(blocks, spans, strict=True)
            ]
            partials = [_on_device(p, matrix.device)
                        for p in await self._run_subtasks(pool, tasks, context)]
            new_center = self._barrier_update(partials, center)
            done = self._barrier_converged(center, new_center)
            center = new_center
            if done:
                break
        return unravel(center.to(matrix.dtype))


__all__ = [
    "FeatureChunkedAggregator",
    "RowScoredAggregator",
    "BarrieredIterativeAggregator",
    "sum_in_order",
]
