"""Attack base class.

Counterpart of ``byzpy_tpu/attacks/base.py`` (API parity:
``byzpy/attacks/base.py:12-119``). Attacks simulate Byzantine behaviour by
generating adversarial gradients. Subclasses declare needs via flags —
``uses_base_grad`` (own honest gradient), ``uses_model_batch`` (model +
batch for a gradient computation), ``uses_honest_grads`` (other nodes'
gradients) — and implement ``apply``.

Every class takes a keyword-only ``device`` (``None``: the CUDA card,
raising where there is none; ``"cpu"`` on request): the gradients it is
handed are moved there and what it returns lies there. The JAX package's
placement policy (small host inputs computed on the CPU,
``utils/placement.py``) is not ported: :meth:`Attack.apply_placed` calls
``apply`` as it is.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Mapping, Optional

from ..engine.graph.operator import OpContext, Operator
from ..utils.device import DeviceLike, resolve_device
from ..utils.trees import stack_gradients


class Attack(Operator, ABC):
    """Byzantine attack ABC: ``apply`` builds the malicious gradient from
    whatever the needs-flags request (model/batch, base grad, honest
    grads)."""

    uses_base_grad: bool = False
    uses_model_batch: bool = False
    uses_honest_grads: bool = False

    #: True for stateful attacks that consume the public round feed
    #: (:meth:`observe_round`) to optimize their next submission — see
    #: ``attacks/adaptive.py``. Static attacks stay pure functions.
    is_adaptive: bool = False

    name = "attack"

    def __init__(self, *, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)

    def observe_round(self, public_state: Any) -> None:
        """Receive one closed round's PUBLIC outcome (a
        :class:`~byzpy_tpu_torch.attacks.adaptive.PublicRoundState`: the
        broadcast aggregate, the round counter and whatever
        acceptance/admission verdicts the fabric publishes). The base
        attack is stateless, so the default is a no-op; adaptive
        subclasses override it to update their strategy."""

    def compute(self, inputs: Mapping[str, Any], *, context: OpContext) -> Any:
        return self.apply_placed(**self._collect_inputs(inputs))

    def apply_placed(self, **kwargs: Any) -> Any:
        """``apply`` itself: the JAX package's placement policy is not
        ported (it would hide the device)."""
        return self.apply(**kwargs)

    @abstractmethod
    def apply(
        self,
        *,
        model: Any = None,
        x: Any = None,
        y: Any = None,
        honest_grads: Optional[List[Any]] = None,
        base_grad: Any = None,
    ) -> Any:
        """Return one malicious gradient shaped like the honest ones.

        ``model`` is a :class:`byzpy_tpu_torch.models.ModelBundle` (or
        anything with ``loss_fn(params, x, y)`` and ``params``) for
        ``uses_model_batch`` attacks."""

    def _stack_honest(self, honest_grads: List[Any]) -> tuple:
        """``(matrix, unravel)`` of the honest gradients on the attack's
        device."""
        return stack_gradients(honest_grads, device=self.device)

    def _collect_inputs(self, inputs: Mapping[str, Any]) -> Dict[str, Any]:
        kwargs: Dict[str, Any] = {}
        if self.uses_model_batch:
            for key in ("model", "x", "y"):
                if key not in inputs:
                    raise KeyError(f"Attack requires input {key!r}")
            kwargs["model"] = inputs["model"]
            kwargs["x"] = inputs["x"]
            kwargs["y"] = inputs["y"]
        if self.uses_honest_grads:
            if "honest_grads" not in inputs:
                raise KeyError("Attack requires 'honest_grads'")
            kwargs["honest_grads"] = inputs["honest_grads"]
        if self.uses_base_grad:
            if "base_grad" not in inputs:
                raise KeyError("Attack requires 'base_grad'")
            kwargs["base_grad"] = inputs["base_grad"]
        return kwargs


__all__ = ["Attack"]
