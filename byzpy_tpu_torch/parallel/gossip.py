"""Peer-to-peer (gossip) training round, replicated single-device form.

Counterpart of ``byzpy_tpu/parallel/gossip.py:build_gossip_train_step``
with ``mesh=None`` (:154-248). Every node is a row of a stacked ``(n, d)``
parameter matrix. One round:

1. half-step: every node takes one SGD step on its own parameters and its
   own batch (``torch.func.vmap`` of ``grad_and_value`` over the stacked
   parameters, the reference's ``vmap(half_step)`` :173);
2. broadcast: honest nodes send their half-step row; byzantine nodes
   (``[n_honest, n_nodes)``) send ``attack(honest_rows, generator)``;
3. exchange and aggregate: every node aggregates the ``(k + 1, d)``
   matrix of its in-neighbourhood, self first
   (``Topology.in_neighbor_groups(include_self=True)``), one
   ``aggregate`` call per node (the reference vmaps one call per
   in-degree group);
4. byzantine nodes keep their own half-step row.

``comm_precision`` compresses the exchange as the reference's replicated
path does (:217-235): ``bf16`` casts the broadcast matrix, ``int8`` encodes
it once (B13 on the card) and decodes each neighbourhood's gathered codes
and scales (B14, once per node). Every other mode, ``fp8``, ``fp8_e5m2``
and ``s4`` included, exchanges uncompressed rows, as the reference's
``else`` branch (:233-235) does (ROADMAP C).

With ``mesh=`` (a ``nodes`` mesh of ``parallel.mesh``, or a grid whose
extra axes split the columns) the round is SPMD over the mesh's ranks,
the reference's :62-250 written out. ``theta`` is node-sharded: each
rank holds the ``(n / ranks, d)`` rows of its nodes, and every rank calls
the step with the whole ``(n, B, ...)`` batch and reads its nodes' rows.
With ``update_sharding`` off, each rank encodes its nodes' broadcast rows
(``comm_precision``) and the codes are all-gathered; each rank aggregates
its own nodes' neighbourhoods. With it on (``"on"``, or ``"auto"`` on
more than one rank), the broadcast transposes node -> feature (an
all-to-all of codes per ``comm_precision``), every node's neighbourhood
aggregates on the rank's columns through ``feature_sharded.sharded_form``
(the forms all-reduce their sums over ``d``, so Multi-Krum and NNM run as
well as the coordinate-wise family), and the refreshed rows transpose
back feature -> node (``param_gather_precision``). Byzantine rows keep
their half-step. The omniscient adversary's view is one exact all-gather
of the honest half-steps, made only when an ``attack`` is given: every
rank then computes the byzantine rows from the same rows and draws.

:func:`ring_exchange` and :func:`build_ring_gossip_train_step` are the
reference's ``ppermute`` ring (:253-395): one node a rank, the ``k``
hops by ``collectives.neighbor_shift``, the bf16 or int8 payload encoded
once and decoded by the receiver, and the opt-in shard split
(``update_sharding="on"``: two ``all_to_all_q`` around the ``n`` ring
neighbourhoods on a ``d / n`` slice, coordinate-wise aggregators only).

:func:`jit_gossip_train_step` is the round compiled, the counterpart of
the reference examples' ``jax.jit(step)``
(``examples/p2p/resnet_cifar_gossip.py:107``): one CUDA graph a signature
(``utils/cuda_graph.py``), the node parameters donated; with ``mesh=`` its
NCCL collectives run inside the graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap

from ..engine.peer_to_peer.topology import Topology
from ..models.bundle import ModelBundle
from ..utils.cuda_graph import CapturedStep, capture_guard
from ..utils.trees import ravel_fn
from .collectives import all_gather, all_reduce_sum, all_to_all_q, axis_index, axis_size, \
    neighbor_shift, reshard_q
from .quantization import QuantizedBlocks, as_comm_precision, dequantize_blockwise, quantize_blockwise

AggFn = Callable[[torch.Tensor], torch.Tensor]  # (k + 1, d) -> (d,)
# attack: (honest half-step rows (h, d), generator) -> (n_byz, d) or (d,)
AttackFn = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


@dataclass(frozen=True)
class GossipStepConfig:
    n_nodes: int
    n_byzantine: int = 0
    learning_rate: float = 0.05

    @property
    def n_honest(self) -> int:
        return self.n_nodes - self.n_byzantine


def _exchange_fn(broadcast: torch.Tensor, comm, gather: Callable = lambda t: t):
    """``gather_rows(idx)``: the rows ``idx`` of the broadcast matrix as the
    exchange delivers them (the reference's replicated path, :217-235):
    the rows encoded where they are (``bf16`` cast, ``int8`` codes and
    scales), the payload moved by ``gather`` (on a mesh, the all-gather of
    every rank's rows), each neighbourhood decoded."""
    if comm.mode == "bf16":
        enc = gather(broadcast.to(torch.bfloat16))
        return lambda idx: enc[idx].to(broadcast.dtype)
    if comm.mode == "int8":
        qb = quantize_blockwise(broadcast, block=comm.block)
        values, scales = gather(qb.values), gather(qb.scales)
        return lambda idx: dequantize_blockwise(
            QuantizedBlocks(values[idx], scales[idx], qb.block, qb.orig_dtype),
            dtype=broadcast.dtype)
    whole = gather(broadcast)
    return lambda idx: whole[idx]


def _byzantine_rows(attack, honest: torch.Tensor, b: int, generator) -> torch.Tensor:
    return attack(honest, generator).expand(b, honest.shape[1]).to(honest.dtype)


def build_gossip_train_step(
    bundle: ModelBundle,
    aggregate: AggFn,
    topology: Topology,
    cfg: GossipStepConfig,
    *,
    attack: Optional[AttackFn] = None,
    comm_precision: Any = None,
    mesh: Any = None,
    update_sharding: Any = None,
) -> Tuple[Callable, Callable]:
    """Build ``(train_step, init_stacked_params)``.

    ``init_stacked_params()`` replicates the bundle's parameters into an
    ``(n, d)`` flat matrix on their device (every node starts from the same
    point). ``train_step(theta, xs, ys, generator=None)`` runs one gossip
    round on per-node batches ``xs: (n, B, ...)``, ``ys: (n, B)`` and
    returns ``(theta, metrics)``, ``metrics["honest_loss"]`` the mean loss
    of the honest nodes at their starting point. ``generator`` feeds a
    randomized attack; without an attack, byzantine nodes broadcast their
    half-step rows.

    ``mesh`` (default: the default mesh of ``configs.mesh``) makes the round
    SPMD over the mesh's ranks (module docstring): ``n_nodes`` divides over
    the ``nodes`` axis, ``init_stacked_params()`` and ``theta`` are this
    rank's ``(n / ranks, d)`` rows, and every rank passes the whole batch.
    ``update_sharding`` (a ``parallel.ps.ShardedUpdateConfig``, a mode
    string, a bool, or ``None`` = ``"auto"``) picks the exchange: off, the
    encoded broadcast rows are all-gathered; on, node -> feature -> node
    all-to-alls around the sharded forms, which need a feature-sharded
    form (``parallel.feature_sharded``) of ``aggregate``. Without a mesh it
    is not read."""
    if topology.n_nodes != cfg.n_nodes:
        raise ValueError("topology size must match cfg.n_nodes")
    if not 0 <= cfg.n_byzantine < cfg.n_nodes:
        raise ValueError(
            f"need 0 <= n_byzantine < n_nodes (got {cfg.n_byzantine}/{cfg.n_nodes})"
        )
    from .ps import _mesh_or_default

    mesh = _mesh_or_default(mesh)
    if mesh is not None:
        return _build_mesh_gossip_step(bundle, aggregate, topology, cfg, attack=attack,
                                       comm_precision=comm_precision, mesh=mesh,
                                       update_sharding=update_sharding)
    ravel, _ = ravel_fn(bundle.params)
    names = list(bundle.params)
    shapes = [tuple(bundle.params[k].shape) for k in names]
    sizes = [int(bundle.params[k].numel()) for k in names]
    h, b, n = cfg.n_honest, cfg.n_byzantine, cfg.n_nodes
    lr = cfg.learning_rate
    comm = as_comm_precision(comm_precision)
    half_grads = vmap(grad_and_value(bundle.loss_fn), in_dims=(0, 0, 0))
    # (node, its in-neighbourhood with itself first), in the reference's
    # group order, the indices on the parameters' device
    device = next(iter(bundle.params.values())).device
    neighbourhoods = [
        (int(i), torch.tensor(nbrs, dtype=torch.long, device=device))
        for idxs, nbr_rows in topology.in_neighbor_groups(include_self=True)
        for i, nbrs in zip(idxs.tolist(), nbr_rows.tolist())
    ]

    def init_stacked_params() -> torch.Tensor:
        return ravel(bundle.params)[None, :].repeat(n, 1)

    def stacked(theta: torch.Tensor) -> Dict[str, torch.Tensor]:
        parts = torch.split(theta, sizes, dim=1)
        return {k: p.reshape(n, *s) for k, p, s in zip(names, parts, shapes)}

    def train_step(theta: torch.Tensor, xs, ys, generator=None):
        if theta.shape != (n, sum(sizes)):
            raise ValueError(f"expected theta of shape {(n, sum(sizes))}, got {tuple(theta.shape)}")
        if xs.shape[0] != n or ys.shape[0] != n:
            raise ValueError(f"expected {n} node batches, got {xs.shape[0]} and {ys.shape[0]}")
        grads, losses = half_grads(stacked(theta), xs, ys)
        flat_g = torch.cat([grads[k].reshape(n, -1) for k in names], dim=1)
        theta_half = theta - lr * flat_g
        if b and attack is not None:
            byz = _byzantine_rows(attack, theta_half[:h], b, generator)
            broadcast = torch.cat([theta_half[:h], byz], dim=0)
        else:
            broadcast = theta_half
        gather_rows = _exchange_fn(broadcast, comm)
        rows: List[Optional[torch.Tensor]] = [None] * n
        for i, idx in neighbourhoods:
            rows[i] = aggregate(gather_rows(idx)).to(theta.dtype)
        theta_new = torch.stack(rows)
        if b:
            # byzantine nodes keep their own half-step state
            theta_new = torch.cat([theta_new[:h], theta_half[h:]], dim=0)
        return theta_new, {"honest_loss": losses[:h].mean()}

    return train_step, init_stacked_params


def _build_mesh_gossip_step(bundle, aggregate, topology, cfg, *, attack, comm_precision, mesh,
                            update_sharding, guard: bool = False):
    """The SPMD gossip round of :func:`build_gossip_train_step` over
    ``mesh``. ``guard`` wraps the aggregate and the attack in
    ``capture_guard`` (the compiled step)."""
    from .feature_sharded import FeatureGroup, sharded_form
    from .mesh import axis_group, sharding
    from .ps import _grid, as_sharded_update, mesh_layout

    axis, _, feat = mesh_layout(mesh)
    axis_group(mesh, feat)  # a grid's product group, made here once
    k, me = axis_size(axis, mesh=mesh), axis_index(axis, mesh=mesh)
    shards = axis_size(feat, mesh=mesh)
    h, b, n = cfg.n_honest, cfg.n_byzantine, cfg.n_nodes
    if n % k:
        raise ValueError(f"n_nodes ({n}) must divide over the {k} ranks of the {axis!r} axis")
    rows = n // k
    mine = slice(me * rows, (me + 1) * rows)
    lr = cfg.learning_rate
    comm = as_comm_precision(comm_precision)
    su = as_sharded_update(update_sharding)
    gather_p = as_comm_precision(su.param_gather_precision)
    su_on = su.resolve(shards)
    ravel, _ = ravel_fn(bundle.params)
    names = list(bundle.params)
    shapes = [tuple(bundle.params[key].shape) for key in names]
    sizes = [int(bundle.params[key].numel()) for key in names]
    d = sum(sizes)
    half_grads = vmap(grad_and_value(bundle.loss_fn), in_dims=(0, 0, 0))
    device = next(iter(bundle.params.values())).device
    neighbourhoods = [
        (int(i), torch.tensor(nbrs, dtype=torch.long, device=device))
        for idxs, nbr_rows in topology.in_neighbor_groups(include_self=True)
        for i, nbrs in zip(idxs.tolist(), nbr_rows.tolist())
    ]
    agg = sharded_form(aggregate, FeatureGroup(mesh, feat)) if su_on else aggregate
    if guard:
        agg = capture_guard(agg, "aggregate")
        attack = capture_guard(attack, "attack")
    if su_on:
        grid = _grid(shards, comm, gather_p)
        d_pad = -(-d // grid) * grid
        row_layout, feat_layout = sharding(mesh, axis, None), sharding(mesh, None, feat)
    else:
        # this rank's nodes, by their row in this rank's block
        neighbourhoods = [(i - me * rows, idx) for i, idx in neighbourhoods if mine.start <= i < mine.stop]
    byz_local = torch.arange(me * rows, (me + 1) * rows, device=device) >= h

    def init_stacked_params() -> torch.Tensor:
        return ravel(bundle.params)[None, :].repeat(rows, 1)

    def stacked(theta: torch.Tensor) -> Dict[str, torch.Tensor]:
        parts = torch.split(theta, sizes, dim=1)
        return {key: p.reshape(rows, *s) for key, p, s in zip(names, parts, shapes)}

    def train_step(theta: torch.Tensor, xs, ys, generator=None):
        if theta.shape != (rows, d):
            raise ValueError(f"expected this rank's theta of shape {(rows, d)}, got "
                             f"{tuple(theta.shape)}")
        if xs.shape[0] != n or ys.shape[0] != n:
            raise ValueError(f"expected {n} node batches, got {xs.shape[0]} and {ys.shape[0]}")
        grads, losses = half_grads(stacked(theta), xs[mine], ys[mine])
        flat_g = torch.cat([grads[key].reshape(rows, -1) for key in names], dim=1)
        half = theta - lr * flat_g
        whole = None  # every node's broadcast row, where the attack needed them
        if b and attack is not None:
            # the omniscient adversary: the honest half-steps, exact, everywhere
            everyone = all_gather(half, axis, mesh=mesh)
            whole = torch.cat([everyone[:h], _byzantine_rows(attack, everyone[:h], b, generator)])
            broadcast = whole[mine]
        else:
            broadcast = half
        if su_on:
            padded = torch.nn.functional.pad(broadcast, (0, d_pad - d)) if d_pad != d else broadcast
            cols = reshard_q(padded, row_layout, feat_layout, precision=comm)
            out: List[Optional[torch.Tensor]] = [None] * n
            for i, idx in neighbourhoods:
                out[i] = agg(cols[idx]).to(cols.dtype)
            theta_new = reshard_q(torch.stack(out), feat_layout, row_layout,
                                  precision=gather_p)[:, :d].to(theta.dtype)
        else:
            gather_rows = (_exchange_fn(whole, comm) if whole is not None else
                           _exchange_fn(broadcast, comm, lambda t: all_gather(t, axis, mesh=mesh)))
            out = [None] * rows
            for i, idx in neighbourhoods:
                out[i] = agg(gather_rows(idx)).to(theta.dtype)
            theta_new = torch.stack(out)
        if b:
            # byzantine nodes keep their own half-step state
            theta_new = torch.where(byz_local[:, None], half, theta_new)
        loss_sum = torch.sum(torch.where(byz_local, torch.zeros_like(losses), losses))
        return theta_new, {"honest_loss": all_reduce_sum(loss_sum, axis, mesh=mesh) / h}

    return train_step, init_stacked_params


def ring_exchange(x: torch.Tensor, k: int, *, axis_name: Any, mesh: Any = None) -> torch.Tensor:
    """The ``k`` counter-clockwise ring neighbours of this rank's ``(d,)``
    vector (``lax.ppermute`` hops, the reference's :253): ``(k, d)``, hop
    ``s`` the vector of the rank ``s`` places behind, nearest first. Each
    hop is one ``collectives.neighbor_shift``."""
    return torch.stack([neighbor_shift(x, axis_name, offset=s, mesh=mesh)
                        for s in range(1, k + 1)])


def build_ring_gossip_train_step(
    bundle: ModelBundle,
    aggregate: AggFn,
    cfg: GossipStepConfig,
    mesh: Any,
    *,
    k: int = 1,
    attack: Optional[AttackFn] = None,
    comm_precision: Any = None,
    update_sharding: Any = None,
) -> Tuple[Callable, Callable]:
    """Ring-topology gossip, one node a rank of the mesh's ``nodes`` axis
    (the reference's ``shard_map`` program, :270-395): the parameters
    leave their rank only as ring traffic.

    ``(train_step, init_stacked_params)``: ``init_stacked_params()`` is
    this rank's ``(1, d)`` row; ``train_step(theta, xs, ys,
    generator=None) -> (theta, honest_loss)`` takes the whole ``(n, B,
    ...)`` batch and reads this rank's node. Its semantics are
    :func:`build_gossip_train_step`'s with ``Topology.ring(n, k)`` and a
    local byzantine model: a byzantine node broadcasts ``-half`` without an
    attack, else ``attack(half[None, :], generator)``, and keeps its
    half-step.

    ``comm_precision`` ``bf16`` / ``int8`` compresses the hops: the vector
    is encoded once, the payload rides all ``k`` shifts, the receiver
    decodes; the node's own row stays exact; other modes move f32, as in
    the reference. ``update_sharding="on"`` (or a config of mode ``"on"``)
    takes the shard split: one ``all_to_all_q`` (``comm_precision``) gives
    this rank slice ``me`` of every node's vector, the ``n`` ring
    neighbourhoods aggregate on that ``d / n`` slice, and a second
    ``all_to_all_q`` (``param_gather_precision``) returns each node its
    slices; the node's own row crosses the wire too. The split needs a
    coordinate-wise aggregator, since each neighbourhood sees a slice of
    the vectors, and the aggregator runs once on the ``n`` neighbourhoods
    side by side (``(k + 1, n * d / n)``). ``"auto"`` stays off."""
    from .mesh import node_axis
    from .ps import as_sharded_update

    axis = node_axis(mesh)
    n = cfg.n_nodes
    size = axis_size(axis, mesh=mesh)
    if size != n:
        raise ValueError(f"mesh axis {axis!r} must have size {n}")
    if not 0 <= cfg.n_byzantine < n:
        raise ValueError(f"need 0 <= n_byzantine < n_nodes (got {cfg.n_byzantine}/{n})")
    me = axis_index(axis, mesh=mesh)
    h, lr = cfg.n_honest, cfg.learning_rate
    is_byz = me >= h
    comm = as_comm_precision(comm_precision)
    su = as_sharded_update(update_sharding)
    split = su.mode == "on"
    gather_p = as_comm_precision(su.param_gather_precision)
    ravel, _ = ravel_fn(bundle.params)
    names = list(bundle.params)
    shapes = [tuple(bundle.params[key].shape) for key in names]
    sizes = [int(bundle.params[key].numel()) for key in names]
    d = sum(sizes)
    dpn = -(-d // n)
    half_grad = grad_and_value(bundle.loss_fn)
    device = next(iter(bundle.params.values())).device
    # ring neighbourhood of node i: [i, i-1, ..., i-k], the replicated path's row order
    ring_idx = (torch.arange(n, device=device)[:, None] - torch.arange(k + 1, device=device)) % n

    def init_stacked_params() -> torch.Tensor:
        return ravel(bundle.params)[None, :]

    def train_step(theta: torch.Tensor, xs, ys, generator=None):
        if theta.shape != (1, d):
            raise ValueError(f"expected this rank's theta of shape {(1, d)}, got "
                             f"{tuple(theta.shape)}")
        if xs.shape[0] != n or ys.shape[0] != n:
            raise ValueError(f"expected {n} node batches, got {xs.shape[0]} and {ys.shape[0]}")
        row = theta[0]
        params = {key: p.reshape(s) for key, p, s in zip(names, torch.split(row, sizes), shapes)}
        g, loss = half_grad(params, xs[me], ys[me])
        half = row - lr * torch.cat([g[key].reshape(-1) for key in names])
        if not is_byz:
            outgoing = half
        elif attack is not None:
            outgoing = attack(half[None, :], generator).reshape(-1, d)[0].to(half.dtype)
        else:
            outgoing = -half
        if split:
            chunks = torch.nn.functional.pad(outgoing, (0, dpn * n - d)).reshape(n, dpn)
            # row j after the exchange: node j's slice `me`
            cols = all_to_all_q(chunks, axis, split_axis=0, concat_axis=0, precision=comm,
                                mesh=mesh)
            hoods = cols[ring_idx]  # (n, k + 1, dpn)
            agg_shards = aggregate(hoods.transpose(0, 1).reshape(k + 1, n * dpn)).reshape(n, dpn)
            # row j after the return: slice j of this rank's aggregate
            back = all_to_all_q(agg_shards.to(half.dtype), axis, split_axis=0, concat_axis=0,
                                precision=gather_p, mesh=mesh)
            agg = back.reshape(-1)[:d]
        else:
            if comm.mode == "bf16":
                received = ring_exchange(outgoing.to(torch.bfloat16), k, axis_name=axis,
                                         mesh=mesh).to(outgoing.dtype)
            elif comm.mode == "int8":
                q = quantize_blockwise(outgoing, block=comm.block)
                received = dequantize_blockwise(
                    QuantizedBlocks(ring_exchange(q.values, k, axis_name=axis, mesh=mesh),
                                    ring_exchange(q.scales, k, axis_name=axis, mesh=mesh),
                                    q.block, q.orig_dtype),
                    dtype=outgoing.dtype)
            else:
                received = ring_exchange(outgoing, k, axis_name=axis, mesh=mesh)
            agg = aggregate(torch.cat([half[None, :], received], dim=0))
        new_row = half if is_byz else agg.to(half.dtype)
        honest = torch.zeros_like(loss) if is_byz else loss
        honest_loss = all_reduce_sum(honest, axis, mesh=mesh) / max(h, 1)
        return new_row[None, :], honest_loss

    return train_step, init_stacked_params


def jit_gossip_train_step(
    bundle: ModelBundle,
    aggregate: AggFn,
    topology: Topology,
    cfg: GossipStepConfig,
    *,
    attack: Optional[AttackFn] = None,
    comm_precision: Any = None,
    mesh: Any = None,
    update_sharding: Any = None,
    donate: bool = True,
) -> Tuple[Callable, Callable]:
    """:func:`build_gossip_train_step` compiled: ``(step,
    init_stacked_params)``, ``step`` a
    :class:`~byzpy_tpu_torch.utils.cuda_graph.CapturedStep` with the train
    step's signature ``step(theta, xs, ys, generator=None) -> (theta,
    metrics)`` and one state argument, ``theta``.

    As :func:`~byzpy_tpu_torch.parallel.ps.jit_ps_train_step` compiles the
    PS step: on the card the first call of each input signature runs the
    step once on copies, captures it in a CUDA graph and replays it; a
    generator is registered with the graph; ``donate=True`` writes the new
    ``theta`` into the graph's input buffer and returns that buffer. The
    ``aggregate`` and ``attack`` callables (on a mesh with the sharded
    update, the aggregate's sharded form) are wrapped in
    :func:`~byzpy_tpu_torch.utils.cuda_graph.capture_guard`, so a step
    that reads the host raises ``GraphCaptureError`` naming the callable.
    With ``mesh=`` the mesh round is captured with its NCCL collectives
    inside the graph, ``theta`` this rank's rows; a collective over a gloo
    group raises ``GraphCaptureError`` naming gloo at the capture.
    On CPU tensors ``step`` is the eager step. Each replay counts one
    ``graph_replay:gossip_train_step``."""
    from .ps import _mesh_or_default

    mesh = _mesh_or_default(mesh)
    if mesh is not None:
        if topology.n_nodes != cfg.n_nodes:
            raise ValueError("topology size must match cfg.n_nodes")
        step, init = _build_mesh_gossip_step(
            bundle, aggregate, topology, cfg, attack=attack, comm_precision=comm_precision,
            mesh=mesh, update_sharding=update_sharding, guard=True)
        return CapturedStep(step, name="gossip_train_step", donate=donate, state_args=1), init
    step, init = build_gossip_train_step(
        bundle, capture_guard(aggregate, "aggregate"), topology, cfg,
        attack=capture_guard(attack, "attack"), comm_precision=comm_precision)
    return CapturedStep(step, name="gossip_train_step", donate=donate, state_args=1), init


__all__ = ["AggFn", "AttackFn", "GossipStepConfig", "build_gossip_train_step",
           "build_ring_gossip_train_step", "jit_gossip_train_step", "ring_exchange"]
