"""Accuracy-under-attack study harness: robust *learning*, not only robust
arithmetic.

Counterpart of ``byzpy_tpu/utils/robust_study.py``: a grid of (aggregator x
attack) cells, each a full training run through the port's PS round
(:func:`~byzpy_tpu_torch.parallel.ps.jit_ps_train_step`, on the card one
CUDA graph replayed a round) or its gossip round
(:func:`~byzpy_tpu_torch.parallel.gossip.jit_gossip_train_step`), evaluated
on held-out real data.

Data defaults to the handwritten digits bundled with scikit-learn
(:func:`~byzpy_tpu_torch.models.data.load_digits_dataset`); pass MNIST IDX
tensors from :func:`~byzpy_tpu_torch.models.data.load_mnist_idx` for the
full-size study. Cells run on the card unless ``device="cpu"`` is given.

Randomness comes from seeded ``torch.Generator`` objects on the data's
device: one draws the node batches, the other feeds the step (the
Gaussian attack). A cell is a function of its seed; it does not reproduce
the JAX package's draws (``jax.random`` keys), so the two packages agree on
what the study shows, not on its digits. A member of the zoo that reads
the host inside the step raises ``GraphCaptureError`` at the capture, as
the compiled twins do; every member of the zoo captures.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..models.bundle import ModelBundle
from ..models.data import ShardedDataset, sample_node_batches
from ..ops import attack_ops, preagg, robust
from ..parallel.ps import PSStepConfig, jit_ps_train_step
from .device import DeviceLike, resolve_device

AggFn = Callable[[torch.Tensor], torch.Tensor]

#: the study zoo names (the CLI's ``study`` mirrors these as choices)
STUDY_AGGREGATORS = (
    "mean",
    "median",
    "trimmed_mean",
    "multi_krum",
    "geometric_median",
    "nnm_trimmed_mean",
)
STUDY_ATTACKS = ("none", "sign_flip", "empire", "little", "gaussian", "mimic")


@dataclass(frozen=True)
class StudyConfig:
    n_nodes: int = 8
    n_byzantine: int = 2
    rounds: int = 300
    batch_size: int = 32
    learning_rate: float = 0.1
    momentum: float = 0.9
    eval_every: int = 50
    seed: int = 0
    # dtype the per-node gradients are cast to before the attack and the
    # aggregation (None: keep f32), e.g. "bfloat16"; parameters and the
    # optimizer state stay f32
    grad_dtype: Optional[str] = None


def _tile(vec: torch.Tensor, b: int) -> torch.Tensor:
    return vec[None, :].repeat(b, 1)


def _sign_flip(honest, generator, *, b):
    return _tile(attack_ops.sign_flip(honest.mean(dim=0), scale=-4.0), b)


def _empire(honest, generator, *, b):
    return _tile(attack_ops.empire(honest, scale=-4.0), b)


def _little(honest, generator, *, b, n_nodes):
    return _tile(attack_ops.little(honest, f=b, n_total=n_nodes), b)


def _gaussian(honest, generator, *, b):
    noise = torch.randn((honest.shape[1],), generator=generator, dtype=honest.dtype,
                        device=honest.device)
    return _tile(10.0 * noise, b)


def _mimic(honest, generator, *, b):
    return _tile(attack_ops.mimic(honest, epsilon=0), b)


def named_attack(
    name: str, *, n_byzantine: int, n_nodes: int
) -> Optional[Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]]:
    """The PS-step attack callback for a named attack: ``honest`` rows
    arrive as ``(h, d)`` with the step's generator, and the callback
    returns the ``(n_byzantine, d)`` malicious rows (colluding byzantine
    nodes all send the same vector, as in the reference's studies).
    ``"none"`` is ``None``. The callbacks are ``functools.partial`` objects
    of module-level functions, so they pickle by reference."""
    b = n_byzantine
    if name == "none":
        return None
    if name == "sign_flip":
        return functools.partial(_sign_flip, b=b)
    if name == "empire":
        # -4 beats -h/b for any b >= n/5, so the poisoned mean ascends and
        # the study separates robust aggregators from the mean
        return functools.partial(_empire, b=b)
    if name == "little":
        return functools.partial(_little, b=b, n_nodes=n_nodes)
    if name == "gaussian":
        return functools.partial(_gaussian, b=b)
    if name == "mimic":
        return functools.partial(_mimic, b=b)
    raise ValueError(f"unknown attack {name!r}")


def _nnm_trimmed_mean(x: torch.Tensor, *, f: int) -> torch.Tensor:
    return robust.trimmed_mean(preagg.nnm(x, f=f), f=f)


def named_aggregator(name: str, *, n_nodes: int, n_byzantine: int) -> AggFn:
    """The study's aggregator zoo, keyed as the results tables name them.
    ``mean`` is the non-robust baseline every attack defeats."""
    f = n_byzantine
    if name == "mean":
        return functools.partial(torch.mean, dim=0)
    if name == "median":
        return robust.coordinate_median
    if name == "trimmed_mean":
        return functools.partial(robust.trimmed_mean, f=f)
    if name == "multi_krum":
        return functools.partial(robust.multi_krum, f=f, q=n_nodes - f)
    if name == "geometric_median":
        return functools.partial(robust.geometric_median, max_iter=64)
    if name == "nnm_trimmed_mean":
        return functools.partial(_nnm_trimmed_mean, f=f)
    raise ValueError(f"unknown aggregator {name!r}")


@dataclass
class CellResult:
    aggregator: str
    attack: str
    final_accuracy: float
    history: List[Tuple[int, float]] = field(default_factory=list)

    def row(self) -> Dict[str, Any]:
        return {
            "aggregator": self.aggregator,
            "attack": self.attack,
            "final_accuracy": round(self.final_accuracy, 4),
            "history": [(r, round(a, 4)) for r, a in self.history],
        }


def _generators(seed: int, device: torch.device) -> Tuple[torch.Generator, torch.Generator]:
    """The cell's batch and step generators, seeded from ``seed``."""
    batches = torch.Generator(device=device).manual_seed(seed)
    step = torch.Generator(device=device).manual_seed(seed + 1)
    return batches, step


def _train_eval_history(
    step_fn: Callable,
    state: Any,
    xs_all: torch.Tensor,
    ys_all: torch.Tensor,
    accuracy_fn: Callable,
    cfg: StudyConfig,
) -> List[Tuple[int, float]]:
    """The shared round loop: sample per-node batches, step, record
    held-out accuracy every ``eval_every`` rounds (and the last).
    ``step_fn(state, xs, ys, generator) -> state``; ``accuracy_fn(state)``."""
    g_batches, g_step = _generators(cfg.seed, xs_all.device)
    history: List[Tuple[int, float]] = []
    for r in range(cfg.rounds):
        xs, ys = sample_node_batches(xs_all, ys_all, g_batches, cfg.batch_size)
        state = step_fn(state, xs, ys, g_step)
        if (r + 1) % cfg.eval_every == 0 or r == cfg.rounds - 1:
            history.append((r + 1, float(accuracy_fn(state))))
    return history


def _accuracy(bundle: ModelBundle, params, x_test, y_test) -> torch.Tensor:
    with torch.no_grad():
        logits = bundle.apply(params, x_test)
    return torch.mean((torch.argmax(logits, -1) == y_test).to(torch.float32))


def _grad_dtype(cfg: StudyConfig) -> Optional[torch.dtype]:
    return None if cfg.grad_dtype is None else getattr(torch, cfg.grad_dtype)


def run_cell(
    bundle_factory: Callable[[], ModelBundle],
    data: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    aggregator: str,
    attack: str,
    cfg: StudyConfig,
    *,
    mesh: Any = None,
) -> CellResult:
    """Train one (aggregator, attack) cell from scratch through the
    compiled PS round and return its held-out accuracy trajectory.
    ``mesh=`` (a ``DeviceMesh``) trains through the compiled mesh round,
    every rank running the cell."""
    if cfg.rounds < 1:
        raise ValueError(f"rounds must be >= 1 (got {cfg.rounds})")
    x_train, y_train, x_test, y_test = data
    bundle = bundle_factory()
    ps_cfg = PSStepConfig(
        n_nodes=cfg.n_nodes,
        n_byzantine=cfg.n_byzantine,
        learning_rate=cfg.learning_rate,
        momentum=cfg.momentum,
    )
    step, opt_state = jit_ps_train_step(
        bundle,
        named_aggregator(aggregator, n_nodes=cfg.n_nodes, n_byzantine=cfg.n_byzantine),
        ps_cfg,
        attack=named_attack(attack, n_byzantine=cfg.n_byzantine, n_nodes=cfg.n_nodes),
        mesh=mesh,
        grad_dtype=_grad_dtype(cfg),
    )
    xs_all, ys_all = ShardedDataset(x_train, y_train, cfg.n_nodes).stacked_shards()

    def step_fn(state, xs, ys, generator):
        params, opt = state
        params, opt, _ = step(params, opt, xs, ys, generator=generator)
        return params, opt

    history = _train_eval_history(
        step_fn, (bundle.params, opt_state), xs_all, ys_all,
        lambda state: _accuracy(bundle, state[0], x_test, y_test), cfg,
    )
    return CellResult(aggregator, attack, history[-1][1], history)


def run_gossip_cell(
    bundle_factory: Callable[[], ModelBundle],
    data: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    aggregator: str,
    attack: str,
    cfg: StudyConfig,
    *,
    mesh: Any = None,
) -> CellResult:
    """Decentralized counterpart of :func:`run_cell`: the same cell trained
    by P2P gossip over the complete topology (honest nodes half-step on
    their shards, byzantine nodes broadcast the attack vector, each node
    robust-aggregates its in-neighbourhood). Accuracy is node 0's model
    on held-out data. The gossip half-step is plain SGD (parameters
    themselves gossip), so ``cfg.momentum`` applies to the PS cells only."""
    if cfg.rounds < 1:
        raise ValueError(f"rounds must be >= 1 (got {cfg.rounds})")
    if cfg.grad_dtype is not None:
        raise ValueError(
            "grad_dtype is a PS-study knob (the gossip step exchanges "
            "parameters, not gradients — there is no gradient cast point); "
            "run the gossip cell with grad_dtype=None"
        )
    from ..engine.peer_to_peer import Topology
    from ..parallel.gossip import GossipStepConfig, jit_gossip_train_step
    from .trees import ravel_fn

    x_train, y_train, x_test, y_test = data
    bundle = bundle_factory()
    gcfg = GossipStepConfig(
        n_nodes=cfg.n_nodes,
        n_byzantine=cfg.n_byzantine,
        learning_rate=cfg.learning_rate,
    )
    step, init = jit_gossip_train_step(
        bundle,
        named_aggregator(aggregator, n_nodes=cfg.n_nodes, n_byzantine=cfg.n_byzantine),
        Topology.complete(cfg.n_nodes), gcfg,
        attack=named_attack(attack, n_byzantine=cfg.n_byzantine, n_nodes=cfg.n_nodes),
        mesh=mesh,
    )
    xs_all, ys_all = ShardedDataset(x_train, y_train, cfg.n_nodes).stacked_shards()
    _, unravel = ravel_fn(bundle.params)

    def step_fn(theta, xs, ys, generator):
        theta, _ = step(theta, xs, ys, generator=generator)
        return theta

    history = _train_eval_history(
        step_fn, init(), xs_all, ys_all,
        lambda theta: _accuracy(bundle, unravel(theta[0]), x_test, y_test), cfg,
    )
    return CellResult(aggregator, attack, history[-1][1], history)


def run_study(
    *,
    aggregators: Sequence[str] = (
        "mean",
        "median",
        "trimmed_mean",
        "multi_krum",
        "nnm_trimmed_mean",
    ),
    attacks: Sequence[str] = ("none", "sign_flip", "little", "empire"),
    cfg: StudyConfig = StudyConfig(),
    bundle_factory: Optional[Callable[[], ModelBundle]] = None,
    data: Optional[Tuple[torch.Tensor, ...]] = None,
    mesh: Any = None,
    verbose: bool = True,
    mode: str = "ps",
    device: DeviceLike = None,
) -> List[CellResult]:
    """The whole accuracy-under-attack grid on real data, on ``device``
    (the card by default; it places the default data and model).
    ``mode="ps"`` trains each cell through the PS round, ``mode="gossip"``
    through the gossip round (see :func:`run_gossip_cell`)."""
    if mode not in ("ps", "gossip"):
        raise ValueError(f"mode must be 'ps' or 'gossip' (got {mode!r})")
    dev = resolve_device(device)
    if data is None:
        from ..models.data import load_digits_dataset

        data = load_digits_dataset(seed=cfg.seed, device=dev)
    if bundle_factory is None:
        from ..models.nets import digits_mlp

        bundle_factory = functools.partial(digits_mlp, seed=cfg.seed, device=dev)
    cell_fn = run_cell if mode == "ps" else run_gossip_cell
    results: List[CellResult] = []
    for attack in attacks:
        for agg in aggregators:
            cell = cell_fn(bundle_factory, data, agg, attack, cfg, mesh=mesh)
            results.append(cell)
            if verbose:
                print(
                    f"{attack:>10} x {agg:<18} final_acc={cell.final_accuracy:.3f}",
                    flush=True,
                )
    return results


def results_table(results: Sequence[CellResult]) -> str:
    """Markdown accuracy matrix: rows are aggregators, columns attacks."""
    attacks = list(dict.fromkeys(r.attack for r in results))
    aggs = list(dict.fromkeys(r.aggregator for r in results))
    cell = {(r.aggregator, r.attack): r.final_accuracy for r in results}
    lines = ["| aggregator | " + " | ".join(attacks) + " |"]
    lines.append("|---" * (len(attacks) + 1) + "|")
    for a in aggs:
        row = [a] + [f"{cell.get((a, atk), float('nan')):.3f}" for atk in attacks]
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


__all__ = [
    "STUDY_AGGREGATORS",
    "STUDY_ATTACKS",
    "StudyConfig",
    "CellResult",
    "named_attack",
    "named_aggregator",
    "run_cell",
    "run_gossip_cell",
    "run_study",
    "results_table",
]
