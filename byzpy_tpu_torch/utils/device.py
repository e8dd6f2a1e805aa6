"""Device resolution for the port's entry points.

Counterpart of ``byzpy_tpu/utils/platform.py``: there the platform comes
from ``JAX_PLATFORMS``; here every entry point takes an explicit
``device`` argument. ``None`` means the CUDA card. A caller that wants the
CPU says so (``device="cpu"``, as the tests do); nothing falls back to
the CPU on its own.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``torch.device`` for ``device``; ``None`` resolves to ``cuda``.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: byzpy_tpu_torch runs on an NVIDIA GPU by "
            "default; pass device='cpu' to run on the CPU"
        )
    return dev


__all__ = ["DeviceLike", "resolve_device"]
