"""Parameter-server training round, single-device form.

Counterpart of ``byzpy_tpu/parallel/ps.py:build_ps_train_step`` on one
device with the sharded update off: with ``comm_precision`` off, the
reference's ``mesh=None`` round; with it on, the reference's round on a
one-device mesh, whose gradient transpose moves nothing but still
encodes and decodes. One step:

1. per-node gradients of every node's batch, ``torch.func.vmap`` over
   ``torch.func.grad_and_value`` of the loss (the JAX ``vmap`` at :403);
2. with ``comm_precision`` on, every node's raw gradient row, byzantine
   nodes' too, crosses the compressed wire hop (``collectives.reshard_q``,
   :404-422): int8 through B13 + B14, fp8 through B15 + B14, s4 through
   B16 + B17;
3. the byzantine rows: the attack, run on the (decoded) honest rows,
   replaces the last ``n_byzantine`` rows of the ``(n, d)`` matrix (:345);
4. the optional ``pre_aggregate`` hook, then ``aggregate(matrix)`` (:441);
   on the card this is where the hand-written kernels run;
5. SGD with momentum (:75, :479-481), exactly ``optax.sgd(lr, momentum)``.

The step is a pure function of its inputs, like the JAX one: parameters
and optimizer state are returned anew, never updated in place.

``build_serving_ps_step`` is the serving tier's bucketed update (ref
``ps.py:504``): it takes a padded cohort instead of computing gradients;
``build_ragged_serving_ps_step`` (ref ``ps.py:585``) takes the same
cohort in the ragged door's flat-rows layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap
from torch.profiler import record_function

from ..models.bundle import ModelBundle, Params
from ..ops import kernels
from ..ops import ragged as ragged_ops
from ..utils.trees import ravel_fn
from .collectives import reshard_q, reshard_q_ef
from .quantization import as_comm_precision

AggFn = Callable[[torch.Tensor], torch.Tensor]      # (n, d) -> (d,)
# (bucket, d), (bucket,) bool -> (d,)
MaskedAggFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# (flat, seg, offsets, lengths, *, n_cohorts, segment_sum) -> (aggregates,
# scores, keep): an Aggregator.ragged_matrix_fn()
RaggedAggFn = Callable[..., Tuple[torch.Tensor, Any, Any]]
PreAggFn = Callable[[torch.Tensor], torch.Tensor]   # (n, d) -> (m, d)
# attack: (honest (h, d), generator) -> (n_byz, d) or (d,)
AttackFn = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]
OptState = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class PSStepConfig:
    n_nodes: int
    n_byzantine: int = 0
    learning_rate: float = 0.05
    momentum: float = 0.9

    @property
    def n_honest(self) -> int:
        return self.n_nodes - self.n_byzantine


class SGD:
    """SGD with heavy-ball momentum on a flat parameter vector, equal to
    ``optax.sgd(learning_rate, momentum)``: the trace starts at zero and
    becomes ``g + momentum * trace``, the update is ``-lr * trace`` (so
    step 1's trace is ``g``: torch's SGD with dampening 0)."""

    def __init__(self, learning_rate: float, momentum: Optional[float] = None):
        self.learning_rate = learning_rate
        self.momentum = momentum

    def init(self, flat_params: torch.Tensor) -> OptState:
        return {"trace": torch.zeros_like(flat_params)} if self.momentum else {}

    def step(
        self, flat_params: torch.Tensor, grad: torch.Tensor, state: OptState
    ) -> Tuple[torch.Tensor, OptState]:
        if self.momentum:
            trace = grad + self.momentum * state["trace"]
            state = {"trace": trace}
        else:
            trace = grad
        return flat_params + trace * (-self.learning_rate), state


def default_optimizer(cfg: PSStepConfig) -> SGD:
    """SGD + momentum, matching the reference examples' torch SGD."""
    return SGD(cfg.learning_rate, momentum=cfg.momentum)


def build_ps_train_step(
    bundle: ModelBundle,
    aggregate: AggFn,
    cfg: PSStepConfig,
    *,
    attack: Optional[AttackFn] = None,
    pre_aggregate: Optional[PreAggFn] = None,
    comm_precision: Any = None,
) -> Tuple[Callable, Any]:
    """Build ``(train_step, opt_state0)``.

    ``train_step(params, opt_state, xs, ys, generator=None)`` takes
    per-node batches stacked on a leading node axis (``xs: (n_nodes, B,
    28, 28, 1)``, ``ys: (n_nodes, B)``) and returns ``(params, opt_state,
    metrics)``; metrics are the mean honest loss and the aggregated
    gradient's norm. ``generator`` feeds a randomized attack. With
    ``n_byzantine > 0`` and no attack, byzantine rows echo honest rows.

    ``comm_precision`` (``None``/``"off"``/``"bf16"``/``"int8"``/``"fp8"``/
    ``"fp8_e5m2"``/``"s4"`` or a :class:`~byzpy_tpu_torch.parallel.quantization.CommPrecision`)
    compresses the gradient hop. This is the reference's round on a
    one-device mesh: the node -> feature transpose moves nothing, but
    every raw row is encoded and decoded, and the attack and the
    aggregator see the decoded rows. ``None``/``"off"`` leaves the round
    bit-identical to the uncompressed one. With ``error_feedback=True``
    the round carries each node's quantization residual: ``opt_state0``
    becomes ``(base_opt_state, {"transpose": zeros(n, d)})``, the step
    returns the new residual in the same slot, and the metrics gain
    ``ef_transpose_norm``. The reference's ``param_gather_precision``
    and sharded update need a mesh (ROADMAP A.7)."""
    opt = default_optimizer(cfg)
    comm = as_comm_precision(comm_precision)
    ef = comm.enabled and comm.error_feedback
    ravel, unravel = ravel_fn(bundle.params)
    names = list(bundle.params)
    h, b = cfg.n_honest, cfg.n_byzantine
    if not 0 <= b < cfg.n_nodes:
        raise ValueError(f"need 0 <= n_byzantine < n_nodes (got {b}/{cfg.n_nodes})")
    per_node = vmap(grad_and_value(bundle.loss_fn), in_dims=(None, 0, 0))
    flat0 = ravel(bundle.params)
    opt_state0 = opt.init(flat0)
    if ef:
        opt_state0 = (opt_state0, {"transpose": flat0.new_zeros((cfg.n_nodes, flat0.shape[0]))})

    def build_matrix(grads_n: torch.Tensor, generator) -> torch.Tensor:
        honest = grads_n[:h]
        if not b:
            return honest
        if attack is not None:
            byz = attack(honest, generator)
        else:
            byz = honest.repeat((b + h - 1) // h, 1)[:b]
        byz = byz.expand(b, honest.shape[1]).to(honest.dtype)
        return torch.cat([honest, byz], dim=0)

    def train_step(params: Params, opt_state, xs, ys, generator=None):
        if xs.shape[0] != cfg.n_nodes or ys.shape[0] != cfg.n_nodes:
            raise ValueError(
                f"expected {cfg.n_nodes} node batches, got {xs.shape[0]} and {ys.shape[0]}"
            )
        if ef:
            opt_state, ef_state = opt_state
        grads, losses = per_node(params, xs, ys)
        flat = torch.cat([grads[k].reshape(cfg.n_nodes, -1) for k in names], dim=1)
        if ef:
            flat, residual = reshard_q_ef(flat, ef_state["transpose"], precision=comm)
            ef_state = {**ef_state, "transpose": residual}
        elif comm.enabled:
            flat = reshard_q(flat, precision=comm)
        matrix = build_matrix(flat, generator)
        if pre_aggregate is not None:
            matrix = pre_aggregate(matrix)
        flat_params = ravel(params)
        agg = aggregate(matrix).to(flat_params.dtype)
        agg_norm = torch.sqrt(torch.sum(agg * agg))
        new_flat, opt_state = opt.step(flat_params, agg, opt_state)
        metrics = {"honest_loss": losses[:h].mean(), "agg_grad_norm": agg_norm}
        if ef:
            res = ef_state["transpose"].float()
            metrics["ef_transpose_norm"] = torch.sqrt(torch.sum(res * res))
            opt_state = (opt_state, ef_state)
        return unravel(new_flat), opt_state, metrics

    return train_step, opt_state0


def build_serving_ps_step(
    bundle: ModelBundle,
    masked_aggregate: MaskedAggFn,
    *,
    optimizer: Any = None,
    learning_rate: float = 0.05,
    momentum: float = 0.9,
    mesh: Any = None,
) -> Tuple[Callable, Any]:
    """The serving tier's bucketed update step (ref ``ps.py:504``).

    ``step(params, opt_state, matrix, valid, weights) -> (params,
    opt_state, metrics)`` consumes a cohort the front end assembled
    (``serving.cohort.Cohort``): ``matrix`` the ``(bucket, d)`` zero-padded
    gradient rows (in this package's ravel order of ``params``), ``valid``
    the ``(bucket,)`` bool row mask, ``weights`` the ``(bucket,)`` float32
    staleness discounts (1.0 fresh, 0 padding), all on the parameters'
    device. It scales the rows by their weights, reduces the valid rows
    with ``masked_aggregate`` (an ``Aggregator.masked_matrix_fn()``, whose
    cohort size stays on the device) and steps SGD with momentum, equal to
    ``optax.sgd(learning_rate, momentum)``. The metrics are
    ``agg_grad_norm`` and ``cohort_m``, device scalars. The stages run
    under the profiler ranges ``serving.staleness_scale``,
    ``serving.masked_aggregate`` and ``serving.opt_update``, the
    reference's named scopes.

    Preconditions, as in the reference: the cohort is admissible for the
    aggregator and its valid rows are finite (``Aggregator.aggregate_masked``
    is the guarded door). ``optimizer=`` and ``mesh=`` raise
    ``NotImplementedError``: only the built-in SGD and one device are
    ported. Returns ``(step, opt_state0)``."""
    if optimizer is not None:
        raise NotImplementedError("optimizer=: only the built-in SGD with momentum is ported")
    if mesh is not None:
        raise NotImplementedError("mesh=: the feature-sharded serving step is not ported")
    opt = SGD(learning_rate, momentum=momentum)
    ravel, unravel = ravel_fn(bundle.params)
    param_dtype = ravel(bundle.params).dtype

    def step(params: Params, opt_state, matrix, valid, weights):
        with record_function("serving.staleness_scale"):
            # a weight of exactly 1.0 leaves a row's bits; padding stays zero
            matrix = matrix * weights[:, None].to(matrix.dtype)
        with record_function("serving.masked_aggregate"):
            agg = masked_aggregate(matrix, valid).to(param_dtype)
        with record_function("serving.opt_update"):
            new_flat, opt_state = opt.step(ravel(params), agg, opt_state)
        metrics = {
            "agg_grad_norm": torch.sqrt(torch.sum(agg * agg)),
            "cohort_m": torch.sum(valid.to(torch.int32)),
        }
        return unravel(new_flat), opt_state, metrics

    return step, opt.init(ravel(bundle.params))


def build_ragged_serving_ps_step(
    bundle: ModelBundle,
    ragged_aggregate: RaggedAggFn,
    *,
    row_capacity: int,
    optimizer: Any = None,
    learning_rate: float = 0.05,
    momentum: float = 0.9,
    mesh: Any = None,
) -> Tuple[Callable, Any]:
    """The serving update step over the ragged door's flat-rows layout (ref
    ``ps.py:585``), the ladder-free twin of :func:`build_serving_ps_step`.

    ``step(params, opt_state, flat, offsets, lengths, weights) -> (params,
    opt_state, metrics)`` consumes one cohort as ``flat: (row_capacity,
    d)`` float32 (the cohort's rows first, zero rows after), ``offsets`` /
    ``lengths``: ``(1,)`` int32 (the cohort's placement, on the device, so
    the cohort size is data) and ``weights``: ``(row_capacity,)`` float32
    staleness discounts (0 for capacity rows), all on the parameters'
    device. It scales the rows, derives the segment ids and the fill on the
    device (``ops.ragged.segment_ids``), aggregates with
    ``ragged_aggregate`` (an ``Aggregator.ragged_matrix_fn()``, its row
    contractions B11 bounded by the fill) and steps SGD with momentum. No
    value is read on the host (the geometric median's Weiszfeld loop
    excepted). The per-cohort contract of the ragged programs makes the
    step's parameters bit for bit :func:`build_serving_ps_step`'s on the
    same cohort in its bucket. The metrics are ``agg_grad_norm`` and
    ``cohort_m``, device scalars; the stages run under the profiler ranges
    ``serving.ragged_scale``, ``serving.ragged_aggregate`` and
    ``serving.opt_update``.

    Preconditions as in the bucketed step: an admissible cohort of finite
    rows. ``optimizer=`` and ``mesh=`` raise ``NotImplementedError``. The
    reference's jitted wrapper (``jit_ragged_serving_ps_step``) has no
    counterpart: PyTorch runs eagerly. Returns ``(step, opt_state0)``."""
    if optimizer is not None:
        raise NotImplementedError("optimizer=: only the built-in SGD with momentum is ported")
    if mesh is not None:
        raise NotImplementedError("mesh=: the feature-sharded serving step is not ported")
    opt = SGD(learning_rate, momentum=momentum)
    ravel, unravel = ravel_fn(bundle.params)
    param_dtype = ravel(bundle.params).dtype
    rows = int(row_capacity)

    def step(params: Params, opt_state, flat, offsets, lengths, weights):
        with record_function("serving.ragged_scale"):
            flat = flat * weights[:, None].to(flat.dtype)
        seg = ragged_ops.segment_ids(offsets, lengths, rows, 1)
        fill = (offsets[:1] + lengths[:1]).to(torch.int32)

        def segment_sum(x, w):
            return kernels.segment_sum(x, w, fill=fill)

        with record_function("serving.ragged_aggregate"):
            aggs, _, _ = ragged_aggregate(flat, seg, offsets, lengths, n_cohorts=1,
                                          segment_sum=segment_sum)
            agg = aggs[0].to(param_dtype)
        with record_function("serving.opt_update"):
            new_flat, opt_state = opt.step(ravel(params), agg, opt_state)
        metrics = {"agg_grad_norm": torch.sqrt(torch.sum(agg * agg)), "cohort_m": lengths[0]}
        return unravel(new_flat), opt_state, metrics

    return step, opt.init(ravel(bundle.params))


__all__ = [
    "AggFn",
    "AttackFn",
    "MaskedAggFn",
    "PSStepConfig",
    "RaggedAggFn",
    "SGD",
    "build_ps_train_step",
    "build_ragged_serving_ps_step",
    "build_serving_ps_step",
    "default_optimizer",
]
