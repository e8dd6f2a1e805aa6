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
``else`` branch (:233-235) does (ROADMAP C). ``mesh=``, the sharded
update (``update_sharding``) and :func:`build_ring_gossip_train_step` raise
``NotImplementedError``: the gossip round over a device mesh is ROADMAP
A.7's.

:func:`jit_gossip_train_step` is the round compiled, the counterpart of
the reference examples' ``jax.jit(step)``
(``examples/p2p/resnet_cifar_gossip.py:107``): one CUDA graph a signature
(``utils/cuda_graph.py``), the node parameters donated.
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


def _refuse_mesh(mesh: Any) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: the gossip round over a device mesh is not ported (ROADMAP A.7)")


def build_ring_gossip_train_step(*args: Any, **kwargs: Any):
    """The reference's ring gossip over a mesh axis (``ppermute`` hops):
    not ported, raises ``NotImplementedError`` (ROADMAP A.7)."""
    raise NotImplementedError(
        "build_ring_gossip_train_step: the ring gossip over a device mesh is not ported "
        "(ROADMAP A.7)")


def build_gossip_train_step(
    bundle: ModelBundle,
    aggregate: AggFn,
    topology: Topology,
    cfg: GossipStepConfig,
    *,
    attack: Optional[AttackFn] = None,
    comm_precision: Any = None,
    mesh: Any = None,
) -> Tuple[Callable, Callable]:
    """Build ``(train_step, init_stacked_params)``.

    ``init_stacked_params()`` replicates the bundle's parameters into an
    ``(n, d)`` flat matrix on their device (every node starts from the same
    point). ``train_step(theta, xs, ys, generator=None)`` runs one gossip
    round on per-node batches ``xs: (n, B, ...)``, ``ys: (n, B)`` and
    returns ``(theta, metrics)``, ``metrics["honest_loss"]`` the mean loss
    of the honest nodes at their starting point. ``generator`` feeds a
    randomized attack; without an attack, byzantine nodes broadcast their
    half-step rows. ``mesh=`` raises ``NotImplementedError`` (ROADMAP A.7)."""
    _refuse_mesh(mesh)
    if topology.n_nodes != cfg.n_nodes:
        raise ValueError("topology size must match cfg.n_nodes")
    if not 0 <= cfg.n_byzantine < cfg.n_nodes:
        raise ValueError(
            f"need 0 <= n_byzantine < n_nodes (got {cfg.n_byzantine}/{cfg.n_nodes})"
        )
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
            byz = attack(theta_half[:h], generator)
            byz = byz.expand(b, theta_half.shape[1]).to(theta_half.dtype)
            broadcast = torch.cat([theta_half[:h], byz], dim=0)
        else:
            broadcast = theta_half
        if comm.mode == "bf16":
            enc = broadcast.to(torch.bfloat16)

            def gather_rows(idx):
                return enc[idx].to(broadcast.dtype)
        elif comm.mode == "int8":
            qb = quantize_blockwise(broadcast, block=comm.block)

            def gather_rows(idx):
                return dequantize_blockwise(
                    QuantizedBlocks(qb.values[idx], qb.scales[idx], qb.block, qb.orig_dtype),
                    dtype=broadcast.dtype,
                )
        else:
            def gather_rows(idx):
                return broadcast[idx]

        rows: List[Optional[torch.Tensor]] = [None] * n
        for i, idx in neighbourhoods:
            rows[i] = aggregate(gather_rows(idx)).to(theta.dtype)
        theta_new = torch.stack(rows)
        if b:
            # byzantine nodes keep their own half-step state
            theta_new = torch.cat([theta_new[:h], theta_half[h:]], dim=0)
        return theta_new, {"honest_loss": losses[:h].mean()}

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
    ``aggregate`` and ``attack`` callables are wrapped in
    :func:`~byzpy_tpu_torch.utils.cuda_graph.capture_guard`, so a step
    that reads the host raises ``GraphCaptureError`` naming the callable.
    On CPU tensors ``step`` is the eager step. Each replay counts one
    ``graph_replay:gossip_train_step``."""
    _refuse_mesh(mesh)
    step, init = build_gossip_train_step(
        bundle, capture_guard(aggregate, "aggregate"), topology, cfg,
        attack=capture_guard(attack, "attack"), comm_precision=comm_precision)
    return CapturedStep(step, name="gossip_train_step", donate=donate, state_args=1), init


__all__ = ["AggFn", "AttackFn", "GossipStepConfig", "build_gossip_train_step",
           "build_ring_gossip_train_step", "jit_gossip_train_step"]
