"""The model zoo of the PS round: ``MLP``, ``SmallCNN`` and the ResNet
family.

Counterpart of ``byzpy_tpu/models/nets.py``. The public input stays NHWC
(``(B, 28, 28, 1)``, ``(B, 32, 32, 3)``, ``(B, 224, 224, 3)``) as in the
JAX package; the convolutional nets permute to NCHW inside. Module names
follow flax's, lower-cased (``Dense_0`` -> ``dense_0``, ``Conv_1`` ->
``conv_1``, ``BottleneckBlock_3/GroupNorm_2`` ->
``bottleneckblock_3.groupnorm_2``), so ``models.convert`` maps parameters
by name.

The ResNets take the reference's ``dtype``, the compute dtype: parameters
stay float32 (flax's ``param_dtype``) and each layer casts them to
``dtype`` where it uses them; the logits come back as float32. Where a
plain translation to PyTorch differs from flax:

* flax's ``"SAME"`` padding puts the odd pixel at the end: a 3x3 stride-2
  convolution on an even input pads ``(0, 1)`` (:func:`same_padding`),
  where ``Conv2d(padding=1)`` pads ``(1, 1)`` and shifts every output; the
  ImageNet stem's ``max_pool(3, 2, "SAME")`` likewise pads ``(0, 1)`` with
  ``-inf``; a 1x1 stride-2 convolution pads nothing;
* :class:`GroupNorm` is flax's: 32 groups unless ``num_groups`` says
  otherwise, epsilon 1e-6 (PyTorch's default is 1e-5), mean and mean
  square reduced in float32, the variance ``max(0, E[x^2] - E[x]^2)``,
  normalized, scaled and shifted in float32, then cast to ``dtype``. The
  ResNets' ``norm=`` (flax's ``norm: Callable``) is a factory
  ``norm(channels, dtype=...)``, e.g. ``functools.partial(GroupNorm,
  num_groups=math.gcd(32, filters))`` for widths 32 does not divide;
* convolutions have no bias; ``dense_0`` has one, added after the product
  in ``dtype`` as flax adds it;
* the global average pool is ``jnp.mean``'s: summed and divided in
  float32, cast to ``dtype``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Sequence, Tuple

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


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """``(before, after)`` padding of flax's (lax's) ``"SAME"`` along one
    spatial axis of ``size``: the output has ``ceil(size / stride)`` positions
    and the odd pixel of the padding goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Bias-free square convolution ``(B, C, H, W) -> (B, features, H', W')``
    in ``dtype``: ``padding="SAME"`` as flax pads (:func:`same_padding`),
    or an int padded on every side."""

    def __init__(self, in_channels: int, features: int, kernel: int, stride: int = 1, *,
                 padding="SAME", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel, kernel))
        self.kernel, self.stride, self.padding, self.dtype = kernel, stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.padding
        if pad == "SAME":
            top, bottom = same_padding(x.shape[-2], self.kernel, self.stride)
            left, right = same_padding(x.shape[-1], self.kernel, self.stride)
            if top or bottom or left or right:
                x = F.pad(x, (left, right, top, bottom))
            pad = 0
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride, padding=pad)


# flax.linen.GroupNorm's defaults, which the reference's ResNets take
_GN_GROUPS, _GN_EPSILON = 32, 1e-6


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm(num_groups=num_groups)`` on NCHW input:
    statistics of each group of channels over the group and the spatial
    axes, in float32 (``mean(x)``, ``mean(x * x)``, variance ``max(0,
    mean(x * x) - mean(x)^2)``), then ``(x - mean) * (rsqrt(var + 1e-6) *
    weight) + bias`` in float32, cast to ``dtype``. ``weight`` is flax's
    ``scale``."""

    def __init__(self, channels: int, *, num_groups: int = _GN_GROUPS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_groups < 1 or channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {channels} channels")
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.num_groups, self.dtype = num_groups, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.num_groups
        xf = x.float()
        grouped = xf.reshape(b, g, c // g, h, w)
        mean = grouped.mean(dim=(2, 3, 4), keepdim=True)
        mean_sq = (grouped * grouped).mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp_min(mean_sq - mean * mean, 0.0)
        mean = mean.expand(b, g, c // g, 1, 1).reshape(b, c, 1, 1)
        mul = torch.rsqrt(var + _GN_EPSILON).expand(b, g, c // g, 1, 1).reshape(b, c, 1, 1)
        mul = mul * self.weight.reshape(1, c, 1, 1)
        y = (xf - mean) * mul + self.bias.reshape(1, c, 1, 1)
        return y.to(self.dtype)


# a ResNet's norm=: channels, then the compute dtype as a keyword
NormFactory = Callable[..., nn.Module]


class Dense(nn.Module):
    """``flax.linen.Dense`` in ``dtype``: the product in ``dtype``, then the
    bias added in ``dtype``."""

    def __init__(self, in_features: int, features: int, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(self.dtype)) + self.bias.to(self.dtype)


class ResNetBlock(nn.Module):
    """Basic residual block (two 3x3 convolutions), ref ``nets.py:66``. The
    residual is projected (a 1x1 convolution and a norm) where the block
    changes the shape: a stride other than 1 or another channel count.
    ``norm`` makes each norm layer (:data:`NormFactory`); its modules keep
    the names ``groupnorm_k`` whatever they are."""

    expansion = 1

    def __init__(self, in_channels: int, filters: int, stride: int = 1, *,
                 dtype: torch.dtype = torch.float32, norm: NormFactory = GroupNorm):
        super().__init__()
        self.conv_0 = Conv(in_channels, filters, 3, stride, dtype=dtype)
        self.groupnorm_0 = norm(filters, dtype=dtype)
        self.conv_1 = Conv(filters, filters, 3, dtype=dtype)
        self.groupnorm_1 = norm(filters, dtype=dtype)
        self.project = stride != 1 or in_channels != filters
        if self.project:
            self.conv_2 = Conv(in_channels, filters, 1, stride, dtype=dtype)
            self.groupnorm_2 = norm(filters, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.groupnorm_0(self.conv_0(x)))
        y = self.groupnorm_1(self.conv_1(y))
        residual = self.groupnorm_2(self.conv_2(x)) if self.project else x
        return F.relu(y + residual)


class BottleneckBlock(nn.Module):
    """Bottleneck residual block (1x1 -> 3x3 -> 1x1, 4x expansion), ref
    ``nets.py:91``; the residual projected and ``norm`` taken as in
    :class:`ResNetBlock`."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, stride: int = 1, *,
                 dtype: torch.dtype = torch.float32, norm: NormFactory = GroupNorm):
        super().__init__()
        out = filters * 4
        self.conv_0 = Conv(in_channels, filters, 1, dtype=dtype)
        self.groupnorm_0 = norm(filters, dtype=dtype)
        self.conv_1 = Conv(filters, filters, 3, stride, dtype=dtype)
        self.groupnorm_1 = norm(filters, dtype=dtype)
        self.conv_2 = Conv(filters, out, 1, dtype=dtype)
        self.groupnorm_2 = norm(out, dtype=dtype)
        self.project = stride != 1 or in_channels != out
        if self.project:
            self.conv_3 = Conv(in_channels, out, 1, stride, dtype=dtype)
            self.groupnorm_3 = norm(out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.groupnorm_0(self.conv_0(x)))
        y = F.relu(self.groupnorm_1(self.conv_1(y)))
        y = self.groupnorm_2(self.conv_2(y))
        residual = self.groupnorm_3(self.conv_3(x)) if self.project else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet with GroupNorm for CIFAR-style (3x3 stem, ``small_input``) or
    ImageNet-style (7x7 stride-2 stem padded 3, then a 3x3 stride-2 max
    pool) NHWC inputs of ``in_channels`` channels, ref ``nets.py:118``.
    Stage ``i`` has ``stage_sizes[i]`` blocks of ``num_filters * 2**i``
    filters, its first block strided 2 from the second stage on; then the
    global average pool and ``dense_0``. ``norm`` makes every norm layer,
    the stem's and the blocks' (:data:`NormFactory`)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls=ResNetBlock, num_classes: int = 10,
                 num_filters: int = 64, small_input: bool = True, *,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 norm: NormFactory = GroupNorm):
        super().__init__()
        self.small_input, self.dtype = small_input, dtype
        if small_input:
            self.conv_0 = Conv(in_channels, num_filters, 3, dtype=dtype)
        else:
            self.conv_0 = Conv(in_channels, num_filters, 7, 2, padding=3, dtype=dtype)
        self.groupnorm_0 = norm(num_filters, dtype=dtype)
        prefix = block_cls.__name__.lower()
        channels, k = num_filters, 0
        self.blocks = []
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                block = block_cls(channels, num_filters * 2**i, 2 if i > 0 and j == 0 else 1,
                                  dtype=dtype, norm=norm)
                self.add_module(f"{prefix}_{k}", block)
                self.blocks.append(f"{prefix}_{k}")
                channels, k = num_filters * 2**i * block_cls.expansion, k + 1
        self.dense_0 = Dense(channels, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = self.conv_0(x)
        if not self.small_input:
            top, bottom = same_padding(x.shape[-2], 3, 2)
            left, right = same_padding(x.shape[-1], 3, 2)
            x = F.max_pool2d(F.pad(x, (left, right, top, bottom), value=-math.inf), 3, 2)
        x = F.relu(self.groupnorm_0(x))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        return self.dense_0(x).float()


ResNet18 = functools.partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=ResNetBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock)


def init_params(module: nn.Module, *, seed: int = 0, device: DeviceLike = None) -> Params:
    """Fresh parameters for ``module`` from ``seed``: flax's defaults,
    LeCun-normal weights (truncated at two standard deviations), zero
    biases and :class:`GroupNorm` scales of one, drawn from an explicit
    ``torch.Generator`` on the CPU (so every device starts from the same
    values)."""
    gen = torch.Generator().manual_seed(seed)
    scales = {f"{name}.weight" for name, m in module.named_modules() if isinstance(m, GroupNorm)}
    params = {}
    for name, p in module.named_parameters():
        if name in scales:
            t = torch.ones(p.shape)
        elif name.endswith("bias"):
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


def digits_mlp(seed: int = 0, hidden: int = 64, *, device: DeviceLike = None) -> ModelBundle:
    """MLP(hidden, 10) bundle for the 8x8x1 digits (``data.load_digits_dataset``)."""
    return make_bundle(MLP(64, (hidden, 10)), seed=seed, device=device)


def cifar_resnet18(seed: int = 0, dtype: torch.dtype = torch.float32, *,
                   device: DeviceLike = None, norm: NormFactory = GroupNorm) -> ModelBundle:
    """ResNet-18 bundle for 32x32x3 inputs, 10 classes (d = 11,173,962)."""
    return make_bundle(ResNet18(num_classes=10, dtype=dtype, norm=norm), seed=seed, device=device)


def imagenet_resnet50(seed: int = 0, dtype: torch.dtype = torch.bfloat16, *,
                      device: DeviceLike = None) -> ModelBundle:
    """ResNet-50 bundle for 224x224x3 inputs, 1,000 classes, bf16 compute
    by default (d = 25,557,032)."""
    return make_bundle(ResNet50(num_classes=1000, small_input=False, dtype=dtype), seed=seed,
                       device=device)


__all__ = [
    "MLP",
    "SmallCNN",
    "Conv",
    "Dense",
    "GroupNorm",
    "NormFactory",
    "ResNetBlock",
    "BottleneckBlock",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "init_params",
    "make_bundle",
    "mnist_mlp",
    "mnist_cnn",
    "digits_mlp",
    "cifar_resnet18",
    "imagenet_resnet50",
    "same_padding",
]
