"""P2P worker behaviours: the per-node training logic the runner installs
into :class:`~byzpy_tpu_torch.engine.node.decentralized.DecentralizedNode`
pipelines.

Counterpart of ``byzpy_tpu/engine/peer_to_peer/nodes.py`` (behavior
parity: ``byzpy/engine/peer_to_peer/runner.py:79-104``,
``mixin.py:59-69``). Parameters travel as one flat ``(d,)`` tensor.

Gossip frames are shared by reference: the in-process context hands the
very tensor a worker returned from ``half_step`` to every neighbour's
queue. A worker therefore replaces its vector on every step and every
aggregate, and never updates it in place: a frame already queued at a
neighbour keeps its bits whatever the sender does next.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, List, Optional, Tuple

import torch
from torch.func import grad_and_value

from ...models.convert import flax_layout, from_flax_layout
from ...utils.trees import ravel_pytree_fn


class HonestP2PWorker(abc.ABC):
    """Local training logic of one honest peer."""

    @abc.abstractmethod
    def half_step(self, lr: float) -> torch.Tensor:
        """Take a half SGD step on local data; return the flat parameter
        vector to gossip."""

    @abc.abstractmethod
    def parameters(self) -> torch.Tensor:
        """The current flat parameter vector."""

    @abc.abstractmethod
    def apply_aggregate(self, vector: Any) -> None:
        """Replace the local parameters with the robust aggregate."""


class ByzantineP2PWorker(abc.ABC):
    """Malicious-vector crafting of one byzantine peer."""

    @abc.abstractmethod
    def malicious_vector(self, honest_vectors: List[torch.Tensor]) -> torch.Tensor:
        """The vector to gossip, given the honest vectors observed from
        in-neighbours this round (possibly none)."""


class SGDModelWorker(HonestP2PWorker):
    """Honest worker over a :class:`~byzpy_tpu_torch.models.ModelBundle`.

    ``batch_fn()`` supplies ``(x, y)``; the half step is the loss's
    gradient (``torch.func.grad_and_value`` of the bundle's loss through
    ``functional_call``) and an SGD update of the flat vector. The vector
    is the JAX package's ``ravel_pytree`` of the flax parameters: flax's
    sorted order and its kernel layouts (:func:`~byzpy_tpu_torch.models.
    convert.flax_layout`), so flat vectors and gossip frames compare with
    the JAX package's coordinate by coordinate. It lies on the bundle's
    device.
    """

    def __init__(self, bundle: Any, batch_fn: Callable[[], Tuple[Any, Any]]) -> None:
        self.bundle = bundle
        self.batch_fn = batch_fn
        self._derive()
        # a vector of its own: a one-leaf model's ravel is a view
        self._flat = self._ravel(bundle.params).clone()
        self._loss: Optional[torch.Tensor] = None

    def _derive(self) -> None:
        """The ravel / unravel pair and the gradient function, derived from
        the bundle (rebuilt, not pickled, when the worker crosses into a
        process node: ``batch_fn`` and the bundle's loss pickle by
        reference there)."""
        example = self.bundle.params
        self._flat_fns = ravel_pytree_fn(flax_layout(example))
        self._grad = grad_and_value(self.bundle.loss_fn)

    def _ravel(self, params: Any) -> torch.Tensor:
        return self._flat_fns[0](flax_layout(params))

    def _unravel(self, flat: torch.Tensor) -> Any:
        return from_flax_layout(self._flat_fns[1](flat), self.bundle.params)

    def __getstate__(self) -> dict:
        return {"bundle": self.bundle, "batch_fn": self.batch_fn, "_flat": self._flat,
                "_loss": self._loss}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._derive()

    def half_step(self, lr: float) -> torch.Tensor:
        x, y = self.batch_fn()
        grads, self._loss = self._grad(self._unravel(self._flat), x, y)
        # a new tensor, never an in-place update (module docstring)
        self._flat = self._flat - lr * self._ravel(grads)
        return self._flat

    @property
    def last_loss(self) -> Optional[float]:
        """The last half step's loss (read from the device when asked)."""
        return None if self._loss is None else float(self._loss)

    def parameters(self) -> torch.Tensor:
        return self._flat

    def apply_aggregate(self, vector: Any) -> None:
        self._flat = torch.as_tensor(vector, device=self._flat.device)

    @property
    def params(self) -> Any:
        """The parameters as the bundle's ``name -> tensor`` dictionary."""
        return self._unravel(self._flat)


class AttackP2PWorker(ByzantineP2PWorker):
    """Byzantine worker delegating to an :class:`~byzpy_tpu_torch.attacks.
    base.Attack` (``uses_honest_grads`` attacks consume the observed
    vectors; others ignore them)."""

    def __init__(self, attack: Any, *, dim: Optional[int] = None) -> None:
        self.attack = attack
        self.dim = dim

    def malicious_vector(self, honest_vectors: List[torch.Tensor]) -> torch.Tensor:
        if not honest_vectors:
            if self.dim is None:
                raise ValueError(
                    "byzantine worker observed no honest vectors and has no dim fallback; give "
                    "AttackP2PWorker(dim=...) or a topology where byzantine nodes have honest "
                    "in-neighbors")
            honest_vectors = [torch.zeros((self.dim,), dtype=torch.float32,
                                          device=self.attack.device)]
        kwargs: dict = {}
        if getattr(self.attack, "uses_honest_grads", False):
            kwargs["honest_grads"] = list(honest_vectors)
        if getattr(self.attack, "uses_base_grad", False):
            kwargs["base_grad"] = honest_vectors[0]
        return self.attack.apply_placed(**kwargs)


class FunctionP2PWorker(ByzantineP2PWorker):
    """Byzantine worker from a function ``f(honest_vectors) -> vector``."""

    def __init__(self, fn: Callable[[List[torch.Tensor]], torch.Tensor]) -> None:
        self.fn = fn

    def malicious_vector(self, honest_vectors: List[torch.Tensor]) -> torch.Tensor:
        return self.fn(honest_vectors)


__all__ = [
    "HonestP2PWorker",
    "ByzantineP2PWorker",
    "SGDModelWorker",
    "AttackP2PWorker",
    "FunctionP2PWorker",
]
