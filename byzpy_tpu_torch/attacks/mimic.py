"""Mimic attack: replay honest worker ``epsilon``'s gradient.

Counterpart of ``byzpy_tpu/attacks/mimic.py`` (behavioral parity:
``byzpy/attacks/mimic.py:35-142``). The pool fan-out mixin comes with the
actor pools (ROADMAP A.4)."""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from ..utils.device import DeviceLike
from ..utils.trees import map_leaves
from .base import Attack


class MimicAttack(Attack):
    """Copy one honest worker's gradient (breaks uniqueness assumptions
    without being an outlier)."""

    name = "mimic"
    uses_honest_grads = True

    def __init__(self, *, epsilon: int = 0, device: DeviceLike = None) -> None:
        if epsilon < 0:
            raise ValueError("epsilon must be >= 0")
        self.epsilon = int(epsilon)
        super().__init__(device=device)

    def apply(self, *, model=None, x=None, y=None,
              honest_grads: Optional[List[Any]] = None, base_grad: Any = None) -> Any:
        if not honest_grads:
            raise ValueError("MimicAttack requires honest_grads")
        if self.epsilon >= len(honest_grads):
            raise ValueError(
                f"epsilon must index an honest worker in [0, {len(honest_grads)}) "
                f"(got {self.epsilon})"
            )
        # a copy, so that mutating the attack's output cannot alias the
        # honest gradient (the reference copies too)
        return map_leaves(lambda a: torch.as_tensor(a, device=self.device).clone(),
                          honest_grads[self.epsilon])


__all__ = ["MimicAttack"]
