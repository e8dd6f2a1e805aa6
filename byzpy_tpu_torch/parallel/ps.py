"""Parameter-server training round, on one device or over a device mesh.

Counterpart of ``byzpy_tpu/parallel/ps.py:build_ps_train_step``. Without
a mesh it is the reference's ``mesh=None`` round (with ``comm_precision``
on, its round on a one-device mesh, whose gradient transpose moves
nothing but still encodes and decodes). One step:

1. per-node gradients of every node's batch, ``torch.func.vmap`` over
   ``torch.func.grad_and_value`` of the loss (the JAX ``vmap`` at :403),
   each node's flat gradient cast to ``grad_dtype`` where one is given
   (:263-268);
2. with ``comm_precision`` on, every node's raw gradient row, byzantine
   nodes' too, crosses the compressed wire hop (``collectives.reshard_q``,
   :404-422): int8 through B13 + B14, fp8 through B15 + B14, s4 through
   B16 + B17;
3. the byzantine rows: the attack, run on the (decoded) honest rows,
   replaces the last ``n_byzantine`` rows of the ``(n, d)`` matrix (:345);
4. the optional ``pre_aggregate`` hook, then ``aggregate(matrix)`` (:441);
   on the card this is where the hand-written kernels run;
5. the optimizer on the flat parameters: by default SGD with momentum
   (:75, :479-481), exactly ``optax.sgd(lr, momentum)``; :class:`Adam` is
   ``optax.adam``.

With ``mesh=`` (a 1-D ``nodes`` mesh or a ``(nodes, data)`` grid,
``parallel.mesh``) the round is SPMD over the mesh's ranks, the
reference's GSPMD program written out: each rank computes its block of
nodes' gradients (on a grid, over its slice of each node's batch, the
slices' means all-reduced over ``data``), the ``(n, d)`` matrix is
transposed node -> feature by an all-to-all (of codes with
``comm_precision``), the attack, the pre-aggregate and the aggregate run on
the rank's columns (``parallel.feature_sharded``), and the update is
sharded (each rank keeps its exact flat shard of the parameters and the
optimizer state and all-gathers the refreshed parameters, optionally
compressed) or replicated (the aggregate is all-gathered).

The step is a pure function of its inputs, like the JAX one: parameters
and optimizer state are returned anew, never updated in place.

``build_serving_ps_step`` is the serving tier's bucketed update (ref
``ps.py:504``): it takes a padded cohort instead of computing gradients;
``build_ragged_serving_ps_step`` (ref ``ps.py:585``) takes the same
cohort in the ragged door's flat-rows layout. ``adaptive_attack_rows``
(ref ``ps.py:673``) turns an attack class into a round's byzantine rows.

``jit_ps_train_step``, ``jit_serving_ps_step`` and
``jit_ragged_serving_ps_step`` (ref :723, :706, :654) are the compiled
steps, the counterpart of ``jax.jit`` with donation: on the card each
captures its step in one CUDA graph per input signature and replays it
(``utils.cuda_graph``); on CPU tensors it runs the step as it is.
``jit_ps_train_step(mesh=)`` captures the mesh round with its NCCL
collectives inside the graph; a gloo group refuses the capture. The
serving builders' ``mesh=`` raises (ROADMAP A.6).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.func import grad_and_value, vmap
from torch.profiler import record_function

from ..models.bundle import ModelBundle, Params
from ..ops import kernels
from ..ops import ragged as ragged_ops
from ..utils.cuda_graph import CapturedStep, capture_guard
from ..utils.trees import ravel_fn
from .collectives import all_reduce_sum, axis_index, axis_size, reshard_q, reshard_q_ef
from .quantization import CommPrecision, as_comm_precision

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
_INT32_MAX = 2**31 - 1


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


class Adam:
    """Adam on a flat parameter vector, equal to ``optax.adam(learning_rate,
    b1, b2, eps)``: the moments ``mu = (1 - b1) g + b1 mu`` and ``nu = (1 -
    b2) g^2 + b2 nu`` from zero, each divided by ``1 - b^t``, the update
    ``-lr * mu_hat / (sqrt(nu_hat) + eps)``. The step
    count ``t`` is an int32 0-d tensor of the state on the parameters'
    device (optax's ``count``), so a step captured in a CUDA graph counts
    on at every replay."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, flat_params: torch.Tensor) -> OptState:
        return {
            "count": torch.zeros((), dtype=torch.int32, device=flat_params.device),
            "mu": torch.zeros_like(flat_params),
            "nu": torch.zeros_like(flat_params),
        }

    def step(
        self, flat_params: torch.Tensor, grad: torch.Tensor, state: OptState
    ) -> Tuple[torch.Tensor, OptState]:
        mu = (1 - self.b1) * grad + self.b1 * state["mu"]
        nu = (1 - self.b2) * (grad * grad) + self.b2 * state["nu"]
        count = state["count"]
        count = torch.where(count < _INT32_MAX, count + 1, count)  # optax.safe_increment
        t = count.to(torch.float32)
        mu_hat = mu / (1 - torch.pow(self.b1, t)).to(mu.dtype)
        nu_hat = nu / (1 - torch.pow(self.b2, t)).to(nu.dtype)
        update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        return flat_params + update * (-self.learning_rate), {"count": count, "mu": mu, "nu": nu}


def _checked_optimizer(optimizer: Any, default: Any) -> Any:
    """``optimizer``, or ``default`` for ``None``; raises ``TypeError`` for
    an object without the ``init`` / ``step`` protocol."""
    opt = default if optimizer is None else optimizer
    if not (callable(getattr(opt, "init", None)) and callable(getattr(opt, "step", None))):
        raise TypeError(f"optimizer must have init(flat_params) and step(flat_params, grad, "
                        f"state), got {type(opt).__name__}")
    return opt


def default_optimizer(cfg: PSStepConfig) -> SGD:
    """SGD + momentum, matching the reference examples' torch SGD."""
    return SGD(cfg.learning_rate, momentum=cfg.momentum)


_SHARDED_UPDATE_MODES = ("off", "on", "auto")


@dataclass(frozen=True)
class ShardedUpdateConfig:
    """Policy for the feature-sharded weight update (ref ``ps.py:85-145``).

    ``mode``: ``"off"``, the replicated update (the aggregate is gathered
    to every rank, every rank holds the whole optimizer state and applies
    the whole update); ``"on"``, the flat aggregate, the flat parameters
    and the optimizer state stay feature-sharded through the optimizer and
    one all-gather of the refreshed parameters follows; ``"auto"`` (the
    default), ``"on"`` whenever the mesh's feature grid spans more than one
    rank.

    ``param_gather_precision`` (``None`` / ``"off"`` / ``"bf16"`` /
    ``"int8"`` / ``"fp8"`` / ``"fp8_e5m2"`` / ``"s4"`` or a
    :class:`~byzpy_tpu_torch.parallel.quantization.CommPrecision`)
    compresses that gather. Each rank's exact shard stays in the carried
    state and only the gathered replica feeds the next forward pass, so
    the compression error does not compound; with ``error_feedback=True``
    the gather's residual rides beside the optimizer state as well. With
    an elementwise optimizer (SGD, momentum, Adam) the sharded update is
    the replicated one, coordinate for coordinate."""

    mode: str = "auto"
    param_gather_precision: Any = None

    def __post_init__(self):
        if self.mode not in _SHARDED_UPDATE_MODES:
            raise ValueError(f"mode must be one of {_SHARDED_UPDATE_MODES}, got {self.mode!r}")
        as_comm_precision(self.param_gather_precision)  # validate eagerly

    def resolve(self, feat_shards: int) -> bool:
        """Whether the sharded update is active on a ``feat_shards``-way grid."""
        if self.mode == "on":
            return True
        if self.mode == "off":
            return False
        return feat_shards > 1


def as_sharded_update(
    value: Union["ShardedUpdateConfig", str, bool, None],
) -> "ShardedUpdateConfig":
    """Coerce a ``ShardedUpdateConfig``, a mode string, a bool or ``None``
    into a :class:`ShardedUpdateConfig`."""
    if value is None:
        return ShardedUpdateConfig()
    if isinstance(value, ShardedUpdateConfig):
        return value
    if isinstance(value, bool):
        return ShardedUpdateConfig(mode="on" if value else "off")
    if isinstance(value, str):
        return ShardedUpdateConfig(mode=value)
    raise TypeError(f"cannot interpret {value!r} as a ShardedUpdateConfig")


def build_ps_train_step(
    bundle: ModelBundle,
    aggregate: AggFn,
    cfg: PSStepConfig,
    *,
    attack: Optional[AttackFn] = None,
    pre_aggregate: Optional[PreAggFn] = None,
    optimizer: Any = None,
    mesh: Any = None,
    grad_dtype: Optional[torch.dtype] = None,
    comm_precision: Any = None,
    sharded_update: Any = None,
) -> Tuple[Callable, Any]:
    """Build ``(train_step, opt_state0)``.

    ``train_step(params, opt_state, xs, ys, generator=None)`` takes
    per-node batches stacked on a leading node axis (``xs: (n_nodes, B,
    28, 28, 1)``, ``ys: (n_nodes, B)``) and returns ``(params, opt_state,
    metrics)``; metrics are the mean honest loss and the aggregated
    gradient's norm. ``generator`` feeds a randomized attack. With
    ``n_byzantine > 0`` and no attack, byzantine rows echo honest rows.

    ``optimizer`` is any object with ``init(flat_params) -> state`` and
    ``step(flat_params, grad, state) -> (flat_params, state)`` on the flat
    parameter vector (:class:`SGD`, :class:`Adam`); the default is
    :func:`default_optimizer`'s SGD with momentum. ``grad_dtype`` (e.g.
    ``torch.bfloat16``) casts each node's flat gradient before the wire,
    the attack and the aggregator, as the reference does; the aggregate
    returns to the parameters' dtype for the update.

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
    ``ef_transpose_norm``; the residual has ``grad_dtype`` where one is
    given.

    ``mesh`` (a ``DeviceMesh`` from ``parallel.mesh``; default: the
    default mesh of ``configs.mesh``) makes the step an SPMD program over
    the mesh's ranks, every rank calling it with the same arguments (the
    whole ``(n, ...)`` batch; a rank reads its nodes' rows). ``n_nodes``
    must divide over the ``nodes`` axis. The flat parameter vector pads
    with zeros to the rank grid times the quantization block of any
    blockwise collective of the round (the transpose's, the params
    gather's), so no block straddles a shard; every aggregator maps the
    zero columns to zero and the pad stays zero. ``aggregate`` and
    ``pre_aggregate`` must have a feature-sharded form
    (``parallel.feature_sharded``); CAF, MDA, SMEA, bucketing and unknown
    callables raise ``NotImplementedError``. ``honest_loss`` and
    ``agg_grad_norm`` are all-reduced, and every rank returns the same
    parameters. On a ``(nodes, data)`` grid (``parallel.mesh.grid_mesh``)
    rank ``(i, j)`` takes node rank ``i``'s nodes and the ``j``-th slice of
    each node's batch (the batch must divide over ``data``); each node's
    batch-mean gradient and loss are the data ranks' means all-reduced over
    ``data`` and divided by its size, and the columns split over
    ``(nodes, data)``, nodes major: the grid's product group runs the
    transpose's all-to-all (over ``nodes``, after each rank keeps its
    ``data`` slice of the columns), the forms' all-reduces and the update's
    all-gather, and the flat vector pads to ``nodes x data`` times the
    block.

    ``sharded_update`` (:class:`ShardedUpdateConfig`, a mode string, a
    bool or ``None`` = ``"auto"``): when active, ``opt_state0`` is
    ``(flat_params, inner_state)`` over this rank's shard of the padded
    flat vector, each rank applies the update to its shard and all-gathers
    the refreshed parameters (compressed per ``param_gather_precision``;
    with its error feedback the state gains ``{"gather": residual}``).
    Without a mesh, ``"on"`` runs the same flat update unsharded. With
    ``comm_precision``'s error feedback on a mesh the transpose residual is
    this rank's ``(n / ranks, d_pad)`` rows."""
    opt = _checked_optimizer(optimizer, default_optimizer(cfg))
    comm = as_comm_precision(comm_precision)
    su = as_sharded_update(sharded_update)
    mesh = _mesh_or_default(mesh)
    if mesh is not None:
        return _build_mesh_train_step(
            bundle, aggregate, cfg, attack=attack, pre_aggregate=pre_aggregate, opt=opt,
            mesh=mesh, grad_dtype=grad_dtype, comm=comm, su=su)
    su_on = su.resolve(1)
    ef = comm.enabled and comm.error_feedback
    ravel, unravel = ravel_fn(bundle.params)
    names = list(bundle.params)
    h, b = cfg.n_honest, cfg.n_byzantine
    if not 0 <= b < cfg.n_nodes:
        raise ValueError(f"need 0 <= n_byzantine < n_nodes (got {b}/{cfg.n_nodes})")
    per_node = vmap(grad_and_value(bundle.loss_fn), in_dims=(None, 0, 0))
    flat0 = ravel(bundle.params)
    # the sharded update without a mesh: the flat update path, unsharded
    opt_state0 = (flat0, opt.init(flat0)) if su_on else opt.init(flat0)
    if ef:
        residual0 = flat0.new_zeros((cfg.n_nodes, flat0.shape[0]), dtype=grad_dtype or flat0.dtype)
        opt_state0 = (opt_state0, {"transpose": residual0})

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
        if grad_dtype is not None:
            flat = flat.to(grad_dtype)
        if ef:
            flat, residual = reshard_q_ef(flat, ef_state["transpose"], precision=comm)
            ef_state = {**ef_state, "transpose": residual}
        elif comm.enabled:
            flat = reshard_q(flat, precision=comm)
        matrix = build_matrix(flat, generator)
        if pre_aggregate is not None:
            matrix = pre_aggregate(matrix)
        if su_on:
            flat_params, inner = opt_state
        else:
            flat_params, inner = ravel(params), opt_state
        agg = aggregate(matrix).to(flat_params.dtype)
        agg_norm = torch.sqrt(torch.sum(agg * agg))
        new_flat, inner = opt.step(flat_params, agg, inner)
        opt_state = (new_flat, inner) if su_on else inner
        metrics = {"honest_loss": losses[:h].mean(), "agg_grad_norm": agg_norm}
        if ef:
            res = ef_state["transpose"].float()
            metrics["ef_transpose_norm"] = torch.sqrt(torch.sum(res * res))
            opt_state = (opt_state, ef_state)
        return unravel(new_flat), opt_state, metrics

    return train_step, opt_state0


def _mesh_or_default(mesh: Any) -> Any:
    """``mesh``, or the default mesh of ``configs.mesh`` for ``None``; a
    ``mesh`` that is not a ``DeviceMesh`` raises ``TypeError``."""
    if mesh is None:
        from ..configs.mesh import get_default_mesh

        return get_default_mesh()
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (parallel.mesh.make_mesh), got "
                        f"{type(mesh).__name__}")
    return mesh


def _grid(k: int, *precisions: CommPrecision) -> int:
    """The padded flat vector's grid: ``k`` ranks times the lcm of the
    blocks of the blockwise precisions in use."""
    block = 1
    for p in precisions:
        if p.blockwise:
            block = block * p.block // math.gcd(block, p.block)
    return k * block


def mesh_layout(mesh) -> Tuple[str, Tuple[str, ...], Any]:
    """The mesh round's axes: the node axis, the extra axes of extent > 1
    (in the mesh's order; the first one splits each node's batch) and the
    axis key the feature columns split over: the node axis alone on a 1-D
    mesh, else ``(node axis, *extra)``, nodes major, the reference's
    ``P(None, (axis, *extra))``."""
    from .mesh import node_axis

    axis = node_axis(mesh)
    names = mesh.mesh_dim_names
    extra = tuple(name for i, name in enumerate(names) if name != axis and mesh.size(i) > 1)
    return axis, extra, ((axis, *extra) if extra else axis)


def _build_mesh_train_step(bundle, aggregate, cfg, *, attack, pre_aggregate, opt, mesh,
                           grad_dtype, comm: CommPrecision, su: ShardedUpdateConfig,
                           guard: bool = False):
    """The SPMD round of :func:`build_ps_train_step` over a 1-D ``nodes``
    mesh or a ``(nodes, data, ...)`` grid. ``guard`` wraps the sharded
    forms and the attack in ``capture_guard`` (the compiled step)."""
    from .feature_sharded import FeatureGroup, sharded_form
    from .mesh import axis_group, replicated, sharding

    axis, extra, feat = mesh_layout(mesh)
    axis_group(mesh, feat)  # a grid's product group, made here once
    k = axis_size(axis, mesh=mesh)
    me = axis_index(axis, mesh=mesh)
    data = extra[0] if extra else None
    n_data = axis_size(data, mesh=mesh) if data else 1
    dj = axis_index(data, mesh=mesh) if data else 0
    shards = axis_size(feat, mesh=mesh)
    fidx = axis_index(feat, mesh=mesh)
    n, h, b = cfg.n_nodes, cfg.n_honest, cfg.n_byzantine
    if not 0 <= b < n:
        raise ValueError(f"need 0 <= n_byzantine < n_nodes (got {b}/{n})")
    if n % k:
        raise ValueError(f"n_nodes ({n}) must divide over the {k} ranks of the {axis!r} axis")
    rows = n // k
    mine = slice(me * rows, (me + 1) * rows)
    su_on = su.resolve(shards)
    gather_p = as_comm_precision(su.param_gather_precision)
    ravel, unravel = ravel_fn(bundle.params)
    names = list(bundle.params)
    per_node = vmap(grad_and_value(bundle.loss_fn), in_dims=(None, 0, 0))
    flat0 = ravel(bundle.params)
    param_dtype, d = flat0.dtype, flat0.shape[0]
    grid = _grid(shards, comm, *([gather_p] if su_on else []))
    d_pad = -(-d // grid) * grid
    d_loc = d_pad // shards
    lo = fidx * d_loc
    row_layout = sharding(mesh, axis, None)
    feat_layout = sharding(mesh, None, feat)
    flat_layout = sharding(mesh, feat)
    repl = replicated(mesh)
    group = FeatureGroup(mesh, feat)
    agg_local = sharded_form(aggregate, group)
    pre_local = sharded_form(pre_aggregate, group) if pre_aggregate is not None else None
    if guard:
        agg_local = capture_guard(agg_local, "aggregate")
        pre_local = capture_guard(pre_local, "pre_aggregate")
        attack = capture_guard(attack, "attack")
    # the columns of this rank's shard that are real coordinates
    real = (torch.arange(lo, lo + d_loc, device=flat0.device) < d)

    def pad(t: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(t, (0, d_pad - t.shape[-1])) if d_pad != t.shape[-1] else t

    if su_on:
        shard0 = pad(flat0)[lo:lo + d_loc].clone()
        opt_state0 = (shard0, opt.init(shard0))
    else:
        opt_state0 = opt.init(flat0)
    ef_transpose = comm.enabled and comm.error_feedback
    ef_gather = su_on and gather_p.enabled and gather_p.error_feedback
    ef0 = {}
    if ef_transpose:
        ef0["transpose"] = flat0.new_zeros((rows, d_pad), dtype=grad_dtype or param_dtype)
    if ef_gather:
        ef0["gather"] = flat0.new_zeros((d_loc,))
    has_ef = bool(ef0)
    if has_ef:
        opt_state0 = (opt_state0, ef0)

    def build_matrix(cols: torch.Tensor, generator) -> torch.Tensor:
        """Honest rows and byzantine rows on this rank's columns: every
        attack is coordinate-wise over the node axis."""
        honest = cols[:h]
        if not b:
            return honest
        if attack is not None:
            byz = attack(honest, generator)
        else:
            byz = honest.repeat((b + h - 1) // h, 1)[:b]
        byz = byz.expand(b, honest.shape[1]).to(honest.dtype)
        return torch.cat([honest, byz], dim=0)

    def train_step(params: Params, opt_state, xs, ys, generator=None):
        if xs.shape[0] != n or ys.shape[0] != n:
            raise ValueError(f"expected {n} node batches, got {xs.shape[0]} and {ys.shape[0]}")
        ef_state: Dict[str, torch.Tensor] = {}
        if has_ef:
            opt_state, ef_state = opt_state
        xs_mine, ys_mine = xs[mine], ys[mine]
        if data:
            # this rank's slice of each node's batch along the data axis
            batch = xs_mine.shape[1]
            if batch % n_data:
                raise ValueError(f"a node's batch ({batch}) must divide over the {n_data} ranks "
                                 f"of the {data!r} axis")
            part = slice(dj * (batch // n_data), (dj + 1) * (batch // n_data))
            xs_mine, ys_mine = xs_mine[:, part], ys_mine[:, part]
        grads, losses = per_node(params, xs_mine, ys_mine)
        flat = torch.cat([grads[key].reshape(rows, -1) for key in names], dim=1)
        if data:
            # the batch-mean gradient and loss of each node: the mean of the
            # data ranks' means (the reference's automatic psum)
            flat = all_reduce_sum(flat, data, mesh=mesh) / n_data
            losses = all_reduce_sum(losses, data, mesh=mesh) / n_data
        if grad_dtype is not None:
            flat = flat.to(grad_dtype)
        flat = pad(flat)
        # the gradient transpose: node rows -> feature columns
        if ef_transpose:
            cols, residual = reshard_q_ef(flat, ef_state["transpose"], row_layout, feat_layout,
                                          precision=comm)
            ef_state = {**ef_state, "transpose": residual}
        else:
            cols = reshard_q(flat, row_layout, feat_layout, precision=comm)
        matrix = build_matrix(cols, generator)
        if pre_local is not None:
            matrix = pre_local(matrix)
        agg = agg_local(matrix).to(param_dtype)
        # the pad columns stay exactly zero
        agg = torch.where(real, agg, torch.zeros((), dtype=agg.dtype, device=agg.device))
        agg_norm = torch.sqrt(all_reduce_sum(torch.sum(agg * agg), feat, mesh=mesh))
        if su_on:
            flat_params, inner = opt_state
            new_shard, inner = opt.step(flat_params, agg, inner)
            if ef_gather:
                gathered, residual = reshard_q_ef(new_shard, ef_state["gather"], flat_layout, repl,
                                                  precision=gather_p)
                ef_state = {**ef_state, "gather": residual}
            else:
                gathered = reshard_q(new_shard, flat_layout, repl, precision=gather_p)
            params = unravel(gathered[:d])
            opt_state = (new_shard, inner)
        else:
            agg_full = reshard_q(agg, flat_layout, repl)[:d]
            new_flat, opt_state = opt.step(ravel(params), agg_full, opt_state)
            params = unravel(new_flat)
        honest = (torch.arange(me * rows, (me + 1) * rows, device=losses.device) < h)
        loss_sum = torch.sum(torch.where(honest, losses, torch.zeros_like(losses)))
        metrics = {"honest_loss": all_reduce_sum(loss_sum, axis, mesh=mesh) / h,
                   "agg_grad_norm": agg_norm}
        if has_ef:
            for key, t in ef_state.items():
                tf = t.float()
                # a rank's part of the residual: its energy summed over the ranks
                metrics[f"ef_{key}_norm"] = torch.sqrt(
                    all_reduce_sum(torch.sum(tf * tf), axis if key == "transpose" else feat,
                                   mesh=mesh))
            opt_state = (opt_state, ef_state)
        return params, opt_state, metrics

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
    is the guarded door). ``mesh=`` raises ``NotImplementedError``: only
    one device is ported. Returns ``(step, opt_state0)``."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: the feature-sharded serving step is not ported (ROADMAP A.6)")
    opt = _checked_optimizer(optimizer, SGD(learning_rate, momentum=momentum))
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
    contractions B11 bounded by the fill) and steps ``optimizer`` (by
    default SGD with momentum). No value is read on the host (the
    geometric median's Weiszfeld loop excepted). The per-cohort contract
    of the ragged programs makes the step's parameters bit for bit
    :func:`build_serving_ps_step`'s on the same cohort in its bucket. The metrics are ``agg_grad_norm`` and
    ``cohort_m``, device scalars; the stages run under the profiler ranges
    ``serving.ragged_scale``, ``serving.ragged_aggregate`` and
    ``serving.opt_update``.

    Preconditions as in the bucketed step: an admissible cohort of finite
    rows. ``mesh=`` raises ``NotImplementedError``. Returns ``(step,
    opt_state0)``."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: the feature-sharded serving step is not ported (ROADMAP A.6)")
    opt = _checked_optimizer(optimizer, SGD(learning_rate, momentum=momentum))
    ravel, unravel = ravel_fn(bundle.params)
    param_dtype = ravel(bundle.params).dtype
    rows = int(row_capacity)
    # the cohort's size is data: above the networks' width it may not fit one
    long_slots = rows > kernels.MAX_NETWORK_ROWS

    def step(params: Params, opt_state, flat, offsets, lengths, weights):
        with record_function("serving.ragged_scale"):
            flat = flat * weights[:, None].to(flat.dtype)
        seg = ragged_ops.segment_ids(offsets, lengths, rows, 1)
        fill = (offsets[:1] + lengths[:1]).to(torch.int32)

        def segment_sum(x, w):
            return kernels.segment_sum(x, w, fill=fill)

        with record_function("serving.ragged_aggregate"):
            aggs, _, _ = ragged_aggregate(flat, seg, offsets, lengths, n_cohorts=1,
                                          segment_sum=segment_sum, long_slots=long_slots)
            agg = aggs[0].to(param_dtype)
        with record_function("serving.opt_update"):
            new_flat, opt_state = opt.step(ravel(params), agg, opt_state)
        metrics = {"agg_grad_norm": torch.sqrt(torch.sum(agg * agg)), "cohort_m": lengths[0]}
        return unravel(new_flat), opt_state, metrics

    return step, opt.init(ravel(bundle.params))


def _guarded(kwargs: dict, roles: Tuple[str, ...]) -> dict:
    """``kwargs`` with each callable named in ``roles`` wrapped by
    :func:`~byzpy_tpu_torch.utils.cuda_graph.capture_guard`."""
    return {k: capture_guard(v, k) if k in roles and v is not None else v
            for k, v in kwargs.items()}


def jit_ps_train_step(
    bundle: ModelBundle,
    aggregate: AggFn,
    cfg: PSStepConfig,
    *,
    mesh: Any = None,
    donate: bool = True,
    **kwargs: Any,
) -> Tuple[Callable, Any]:
    """:func:`build_ps_train_step` compiled: ``(step, opt_state0)``, ``step``
    a :class:`~byzpy_tpu_torch.utils.cuda_graph.CapturedStep` with the
    train step's signature (ref ``ps.py:723``, ``jax.jit`` with donation).

    On the card the first call of each input signature (shapes, dtypes,
    whether a generator is given) runs the step once on copies of its
    inputs, captures it in a CUDA graph and replays it; later calls copy
    their inputs into the graph's buffers and replay. A generator is
    registered with the graph, so each replay draws fresh numbers and
    advances it as the eager step would. With ``donate=True`` the new
    parameters and optimizer state are written into the graph's input
    buffers and returned as they are: passing them back in costs no copy,
    and the previous round's references are overwritten. ``donate=False``
    returns clones. A step that reads the host (a synchronizing operation)
    cannot be captured: the capture raises
    :class:`~byzpy_tpu_torch.utils.cuda_graph.GraphCaptureError` naming the
    aggregate, pre-aggregate or attack callable that read; nothing runs
    eagerly on the card in its place. On CPU tensors ``step`` is the eager
    step.

    With ``mesh=`` (or a default mesh) the step is the mesh round of
    :func:`build_ps_train_step`, captured whole: its NCCL collectives (the
    transpose's all-to-all, the forms' all-reduces, the update's
    all-gather) run inside the graph, and every rank captures and replays
    the same graph. The sharded forms and the attack are wrapped in
    ``capture_guard``; a form that reads the host (the geometric
    median's Weiszfeld loop, which tests its stop on the host each step)
    raises ``GraphCaptureError`` at the capture, and so does the first
    collective over a gloo group (``collectives.refuse_gloo_capture``: gloo
    moves CUDA tensors through the host). Nothing then runs eagerly in the
    graph's place."""
    mesh = _mesh_or_default(mesh)
    if mesh is not None:
        opt = _checked_optimizer(kwargs.pop("optimizer", None), default_optimizer(cfg))
        step, opt_state0 = _build_mesh_train_step(
            bundle, aggregate, cfg, attack=kwargs.pop("attack", None),
            pre_aggregate=kwargs.pop("pre_aggregate", None), opt=opt, mesh=mesh,
            grad_dtype=kwargs.pop("grad_dtype", None),
            comm=as_comm_precision(kwargs.pop("comm_precision", None)),
            su=as_sharded_update(kwargs.pop("sharded_update", None)), guard=True, **kwargs)
        return CapturedStep(step, name="ps_train_step", donate=donate), opt_state0
    kwargs = _guarded(kwargs, ("attack", "pre_aggregate"))
    step, opt_state0 = build_ps_train_step(bundle, capture_guard(aggregate, "aggregate"), cfg,
                                           **kwargs)
    return CapturedStep(step, name="ps_train_step", donate=donate), opt_state0


def jit_serving_ps_step(
    bundle: ModelBundle,
    masked_aggregate: MaskedAggFn,
    *,
    donate: bool = False,
    **kwargs: Any,
) -> Tuple[Callable, Any]:
    """:func:`build_serving_ps_step` compiled as :func:`jit_ps_train_step`
    compiles the train step (ref ``ps.py:706``): one CUDA graph per bucket
    shape, the cohort size flowing through the mask."""
    step, opt_state0 = build_serving_ps_step(
        bundle, capture_guard(masked_aggregate, "masked_aggregate"), **kwargs)
    return CapturedStep(step, name="serving_ps_step", donate=donate), opt_state0


def jit_ragged_serving_ps_step(
    bundle: ModelBundle,
    ragged_aggregate: RaggedAggFn,
    *,
    row_capacity: int,
    donate: bool = False,
    **kwargs: Any,
) -> Tuple[Callable, Any]:
    """:func:`build_ragged_serving_ps_step` compiled as
    :func:`jit_ps_train_step` compiles the train step (ref ``ps.py:654``):
    one CUDA graph per row capacity, the cohort's placement data."""
    step, opt_state0 = build_ragged_serving_ps_step(
        bundle, capture_guard(ragged_aggregate, "ragged_aggregate"), row_capacity=row_capacity,
        **kwargs)
    return CapturedStep(step, name="ragged_serving_ps_step", donate=donate), opt_state0


__all__ = [
    "Adam",
    "AggFn",
    "AttackFn",
    "MaskedAggFn",
    "PSStepConfig",
    "RaggedAggFn",
    "SGD",
    "ShardedUpdateConfig",
    "as_sharded_update",
    "adaptive_attack_rows",
    "build_ps_train_step",
    "build_ragged_serving_ps_step",
    "build_serving_ps_step",
    "default_optimizer",
    "jit_ps_train_step",
    "jit_ragged_serving_ps_step",
    "jit_serving_ps_step",
]


def adaptive_attack_rows(
    attack: Any, n_byz: int, *, honest: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The ``(n_byz, d)`` byzantine rows of one round from an attack class
    (``byzpy_tpu_torch.attacks``), each row its one ``apply``.

    A stateful adaptive attack updates its Python state between rounds
    (``observe_round``), so it runs outside the step: the round's
    ``attack`` closure calls this, e.g. ``lambda honest, g:
    adaptive_attack_rows(atk, 2, honest=honest)``, and the caller feeds
    the step's aggregate back through ``atk.observe_round``. ``honest``
    (an ``(h, d)`` matrix) is forwarded, row by row, only to attacks that
    declare ``uses_honest_grads``; public-feed-only attacks ignore it."""
    if n_byz < 1:
        raise ValueError(f"n_byz must be >= 1 (got {n_byz})")
    kwargs: dict = {}
    if getattr(attack, "uses_honest_grads", False):
        if honest is None:
            raise ValueError(f"{attack.name} needs the honest matrix")
        kwargs["honest_grads"] = list(honest)
    row = torch.as_tensor(attack.apply(**kwargs))
    return row.reshape(1, -1).repeat(n_byz, 1)
