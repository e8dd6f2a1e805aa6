"""Synthetic classification data for tests and the PS round.

Counterpart of ``byzpy_tpu/models/data.py:synthetic_classification``. The
arrays are made with numpy exactly as there, so both packages see the same
values bit for bit; only the container differs (torch tensors, labels as
int64 for ``cross_entropy``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


def synthetic_classification(
    *,
    n_samples: int = 4096,
    input_shape: Sequence[int] = (28, 28, 1),
    num_classes: int = 10,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-conditional Gaussian blobs ``(x, y)``: ``x`` float32 of shape
    ``(n_samples, *input_shape)``, ``y`` int64 labels."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=(n_samples,))
    centers = rng.normal(size=(num_classes, int(np.prod(input_shape)))).astype(np.float32)
    x = centers[y] + 0.5 * rng.normal(size=(n_samples, centers.shape[1])).astype(np.float32)
    return (
        torch.from_numpy(x.reshape((n_samples, *input_shape))).to(dev),
        torch.from_numpy(y.astype(np.int64)).to(dev),
    )


__all__ = ["synthetic_classification"]
