"""Parameters between the JAX package's layout and the port's.

The JAX package keeps flax parameter trees; the tests hand them over as a
nested dictionary of numpy arrays (``{"params": {"Dense_0": {"kernel",
"bias"}, ...}}``, and for the ResNets ``{"params": {"Conv_0": {"kernel"},
"GroupNorm_0": {"scale", "bias"}, "BottleneckBlock_3": {"Conv_1":
{"kernel"}, ...}, ...}}``). The port keeps flat ``name -> tensor``
dictionaries named after its modules, each flax name lower-cased and the
path joined by dots (``dense_0.weight``, ``bottleneckblock_3.conv_1.weight``,
``groupnorm_0.bias``). The maps:

* Dense kernel ``(in, out)`` -> Linear weight ``(out, in)``;
* Conv kernel ``HWIO`` -> Conv2d weight ``OIHW`` (the ResNets' convolutions
  have no bias);
* GroupNorm ``scale`` -> ``weight``;
* biases as they are.

``SmallCNN`` flattens in NHWC order, as flax does, so ``Dense_0`` needs no
permutation beyond the transpose.

The two packages ravel a model's parameters in different orders. The port
follows its modules' order of creation (:func:`ordered_like` re-keys a
converted dictionary that way), flax sorts each level's names as strings
(``ResNetBlock_10`` before ``ResNetBlock_2``, ``Conv_0`` before
``Dense_0`` before ``GroupNorm_0``, ``bias`` before ``kernel``). A flat
vector of one package is therefore a permutation of the other's: that
matters to nothing coordinate-wise, only to the blockwise wire codes,
whose blocks group different coordinates.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .bundle import Params

# flax module kinds by the port's lower-cased prefix: layers with parameters
# and the blocks that hold them
_FLAX_KINDS = {"dense": "Dense", "conv": "Conv", "groupnorm": "GroupNorm",
               "resnetblock": "ResNetBlock", "bottleneckblock": "BottleneckBlock"}
_LAYERS = {"Dense", "Conv", "GroupNorm"}
_TO_TORCH = {2: (1, 0), 4: (3, 2, 0, 1)}   # kernel rank -> permutation
_TO_FLAX = {2: (1, 0), 4: (2, 3, 1, 0)}


def _kind(name: str, what: str) -> str:
    kind, idx = name.rsplit("_", 1) if "_" in name else (name, "")
    if kind not in _FLAX_KINDS.values() or not idx.isdigit():
        raise ValueError(f"no mapping for flax {what} {name!r}")
    return kind


def from_flax(flax_params: Mapping[str, Any], *, device: DeviceLike = None) -> Params:
    """The port's parameter dictionary for a flax tree (with or without
    the outer ``"params"`` level), in flax's sorted order."""
    tree = flax_params.get("params", flax_params)
    dev = resolve_device(device)
    out: Params = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name in sorted(node):
            kind = _kind(name, "layer")
            path = f"{prefix}{name.lower()}"
            if kind not in _LAYERS:
                walk(node[name], path + ".")
                continue
            for leaf in sorted(node[name]):
                arr = np.asarray(node[name][leaf], dtype=np.float32)
                if leaf == "kernel":
                    out[f"{path}.weight"] = torch.from_numpy(
                        np.ascontiguousarray(arr.transpose(_TO_TORCH[arr.ndim]))).to(dev)
                elif leaf in ("scale", "bias"):
                    key = "weight" if leaf == "scale" else "bias"
                    out[f"{path}.{key}"] = torch.from_numpy(arr.copy()).to(dev)
                else:
                    raise ValueError(f"no mapping for flax parameter {path}/{leaf}")

    walk(tree, "")
    return out


def _flax_slot(name: str) -> tuple:
    """``(flax module path, flax leaf name, kernel?)`` of a port parameter."""
    *modules, leaf = name.split(".")
    path, kind = [], None
    for m in modules:
        prefix, _, idx = m.rpartition("_")
        if prefix not in _FLAX_KINDS or not idx.isdigit():
            raise ValueError(f"no mapping for parameter {name!r}")
        kind = _FLAX_KINDS[prefix]
        path.append(f"{kind}_{idx}")
    if kind not in _LAYERS or leaf not in ("weight", "bias"):
        raise ValueError(f"no mapping for parameter {name!r}")
    if leaf == "bias":
        return path, "bias", False
    return path, ("scale" if kind == "GroupNorm" else "kernel"), kind != "GroupNorm"


def to_flax(params: Params) -> Dict[str, Any]:
    """Inverse of :func:`from_flax`: ``{"params": {...}}``, nested as flax
    nests the modules, of numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, t in params.items():
        path, leaf, kernel = _flax_slot(name)
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        arr = t.detach().cpu().numpy()
        node[leaf] = np.ascontiguousarray(arr.transpose(_TO_FLAX[arr.ndim])) if kernel else arr.copy()
    return {"params": tree}


def flax_layout(params: Params) -> Dict[str, Any]:
    """``params`` nested and laid out as flax keeps them (``{"params":
    {"Dense_0": {"bias", "kernel"}, ...}}``, kernels ``(in, out)`` and
    ``HWIO``), as tensor views on the parameters' device: no copy. With
    :func:`~byzpy_tpu_torch.utils.trees.ravel_pytree_fn` it ravels a model
    in the JAX package's order and layout, so the flat vectors of the two
    packages compare coordinate by coordinate."""
    tree: Dict[str, Any] = {}
    for name, t in params.items():
        path, leaf, kernel = _flax_slot(name)
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.permute(_TO_FLAX[t.ndim]) if kernel else t
    return {"params": tree}


def from_flax_layout(tree: Mapping[str, Any], example: Params) -> Params:
    """Inverse of :func:`flax_layout`: the port's parameters, in
    ``example``'s order, as tensor views of ``tree``'s leaves."""
    tree = tree.get("params", tree)
    out: Params = {}
    for name in example:
        path, leaf, kernel = _flax_slot(name)
        node = tree
        for key in path:
            node = node[key]
        t = node[leaf]
        out[name] = t.permute(_TO_TORCH[t.ndim]) if kernel else t
    return out


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


__all__ = ["flax_layout", "from_flax", "from_flax_layout", "ordered_like", "to_flax"]
