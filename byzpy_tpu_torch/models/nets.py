"""MNIST-shaped networks of the PS round: ``MLP`` and ``SmallCNN``.

Counterpart of ``byzpy_tpu/models/nets.py``. The public input stays NHWC
``(B, 28, 28, 1)`` as in the JAX package; the CNN permutes to NCHW inside.
Layer names follow flax's (``Dense_0`` -> ``dense_0``, ``Conv_1`` ->
``conv_1``) so ``models.convert`` maps parameters by name.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from .bundle import ModelBundle, Params


class MLP(nn.Module):
    """Plain MLP classifier; flattens its (NHWC) input."""

    def __init__(self, in_features: int = 784, features: Sequence[int] = (128, 10)):
        super().__init__()
        self.n_layers = len(features)
        prev = in_features
        for i, feat in enumerate(features):
            self.add_module(f"dense_{i}", nn.Linear(prev, feat))
            prev = feat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_layers):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x


class SmallCNN(nn.Module):
    """MNIST CNN conv32-pool-conv64-pool-fc128-fc10 (d = 421,642).

    Flax ``SAME`` padding on a 3x3 stride-1 conv is ``padding=1``;
    ``max_pool`` (2, 2)/(2, 2) is ``max_pool2d(2)``. Flax flattens NHWC,
    so the features are permuted back to (h, w, c) order before
    ``dense_0``, which then maps from flax's ``Dense_0`` as a plain
    transpose."""

    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.conv_0 = nn.Conv2d(1, 32, 3, padding=1)
        self.conv_1 = nn.Conv2d(32, 64, 3, padding=1)
        self.dense_0 = nn.Linear(7 * 7 * 64, 128)
        self.dense_1 = nn.Linear(128, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(F.relu(self.conv_0(x)), 2)
        x = F.max_pool2d(F.relu(self.conv_1(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in NHWC order
        x = F.relu(self.dense_0(x))
        return self.dense_1(x)


def init_params(module: nn.Module, *, seed: int = 0, device: DeviceLike = None) -> Params:
    """Fresh parameters for ``module`` from ``seed``: flax's defaults,
    LeCun-normal weights (truncated at two standard deviations) and zero
    biases, drawn from an explicit ``torch.Generator`` on the CPU (so
    every device starts from the same values)."""
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            t = torch.zeros(p.shape)
        else:
            fan_in = math.prod(p.shape[1:])
            # flax's truncated-normal stddev correction for the +-2 sigma cut
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            t = torch.empty(p.shape)
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
        params[name] = t.to(resolve_device(device))
    return params


def make_bundle(module: nn.Module, *, seed: int = 0, device: DeviceLike = None) -> ModelBundle:
    """Initialize ``module`` (see :func:`init_params`) and wrap it."""
    dev = resolve_device(device)
    return ModelBundle(module=module.to(dev), params=init_params(module, seed=seed, device=dev))


def mnist_mlp(seed: int = 0, hidden: int = 128, *, device: DeviceLike = None) -> ModelBundle:
    """MLP(hidden, 10) bundle for 28x28x1 inputs."""
    return make_bundle(MLP(784, (hidden, 10)), seed=seed, device=device)


def mnist_cnn(seed: int = 0, *, device: DeviceLike = None) -> ModelBundle:
    """SmallCNN bundle for 28x28x1 inputs."""
    return make_bundle(SmallCNN(), seed=seed, device=device)


__all__ = ["MLP", "SmallCNN", "init_params", "make_bundle", "mnist_cnn", "mnist_mlp"]
