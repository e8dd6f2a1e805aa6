"""Parameters between the JAX package's layout and the port's.

The JAX package keeps flax parameter trees; the tests hand them over as a
nested dictionary of numpy arrays (``{"params": {"Dense_0": {"kernel",
"bias"}, ...}}``). The port keeps ``name -> tensor`` dictionaries named
after its modules (``dense_0.weight``, ``conv_1.bias``). The maps:

* Dense kernel ``(in, out)`` -> Linear weight ``(out, in)``;
* Conv kernel ``HWIO`` -> Conv2d weight ``OIHW``;
* biases as they are.

``SmallCNN`` flattens in NHWC order, as flax does, so ``Dense_0`` needs no
permutation beyond the transpose.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .bundle import Params

_TO_TORCH = {"Dense": (1, 0), "Conv": (3, 2, 0, 1)}
_TO_FLAX = {"dense": (1, 0), "conv": (2, 3, 1, 0)}


def from_flax(flax_params: Mapping[str, Any], *, device: DeviceLike = None) -> Params:
    """The port's parameter dictionary for a flax tree (with or without
    the outer ``"params"`` level)."""
    tree = flax_params.get("params", flax_params)
    dev = resolve_device(device)
    out: Params = {}
    for layer in sorted(tree):
        kind, idx = layer.rsplit("_", 1)
        if kind not in _TO_TORCH:
            raise ValueError(f"no mapping for flax layer {layer!r}")
        prefix = f"{kind.lower()}_{idx}"
        kernel = np.asarray(tree[layer]["kernel"], dtype=np.float32)
        out[f"{prefix}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(_TO_TORCH[kind]))
        ).to(dev)
        out[f"{prefix}.bias"] = torch.from_numpy(
            np.array(tree[layer]["bias"], dtype=np.float32)
        ).to(dev)
    return out


def to_flax(params: Params) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """Inverse of :func:`from_flax`: ``{"params": {layer: {"kernel",
    "bias"}}}`` of numpy arrays."""
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for name, t in params.items():
        prefix, leaf = name.rsplit(".", 1)
        kind, idx = prefix.rsplit("_", 1)
        if kind not in _TO_FLAX:
            raise ValueError(f"no mapping for parameter {name!r}")
        layer = f"{kind.capitalize()}_{idx}"
        arr = t.detach().cpu().numpy()
        if leaf == "weight":
            tree.setdefault(layer, {})["kernel"] = np.ascontiguousarray(arr.transpose(_TO_FLAX[kind]))
        else:
            tree.setdefault(layer, {})["bias"] = arr.copy()
    return {"params": tree}


def ordered_like(params: Params, example: Params) -> Params:
    """``params`` re-keyed in ``example``'s order (the module's
    ``named_parameters`` order, which the flat vectors follow); the two
    must hold the same names and shapes."""
    if set(params) != set(example):
        raise ValueError(f"parameter names differ: {sorted(set(params) ^ set(example))}")
    for k in example:
        if params[k].shape != example[k].shape:
            raise ValueError(f"{k}: shape {tuple(params[k].shape)} != {tuple(example[k].shape)}")
    return {k: params[k] for k in example}


__all__ = ["from_flax", "ordered_like", "to_flax"]
