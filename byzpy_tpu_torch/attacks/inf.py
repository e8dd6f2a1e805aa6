"""Inf attack: a ``+inf``-filled vector shaped like the gradients.

Counterpart of ``byzpy_tpu/attacks/inf.py`` (behavioral parity:
``byzpy/attacks/inf.py:35-119``). The pool fan-out mixin comes with the
actor pools (ROADMAP A.4)."""

from __future__ import annotations

from typing import Any, List, Optional

from ..ops import attack_ops
from .base import Attack


class InfAttack(Attack):
    """Send a ``+inf``-filled vector (crash-the-mean probe)."""

    name = "inf"
    uses_honest_grads = True

    def apply(self, *, model=None, x=None, y=None,
              honest_grads: Optional[List[Any]] = None, base_grad: Any = None) -> Any:
        if not honest_grads:
            raise ValueError("InfAttack requires honest_grads")
        matrix, unravel = self._stack_honest(honest_grads)
        return unravel(attack_ops.inf_vector((matrix.shape[1],), dtype=matrix.dtype,
                                             device=matrix.device))


__all__ = ["InfAttack"]
