"""ModelBundle: a module, an explicit parameter dictionary and a loss.

Counterpart of ``byzpy_tpu/models/bundle.py``. The module supplies the
architecture; the parameters live beside it as a plain ``name -> tensor``
dictionary and enter through ``torch.func.functional_call``, so training
code can take per-node gradients of pure functions of ``(params, x, y)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..utils.trees import Params

LossFn = Callable[[Params, torch.Tensor, torch.Tensor], torch.Tensor]


class _SoftmaxCrossEntropy:
    """The default loss as an object of a module-level class, so a bundle
    pickles by reference into a process node."""

    def __init__(self, module: nn.Module) -> None:
        self.module = module

    def __call__(self, params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        logits = functional_call(self.module, params, (x,))
        return F.cross_entropy(logits, y)


def softmax_cross_entropy_loss(module: nn.Module) -> LossFn:
    """Softmax cross-entropy over integer labels, mean-reduced."""
    return _SoftmaxCrossEntropy(module)


@dataclass
class ModelBundle:
    module: nn.Module
    params: Params
    loss_fn: Optional[LossFn] = None

    def __post_init__(self) -> None:
        if self.loss_fn is None:
            self.loss_fn = softmax_cross_entropy_loss(self.module)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.module, params, (x,))

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.loss_fn(self.params, x, y)


__all__ = ["ModelBundle", "Params", "softmax_cross_entropy_loss"]
