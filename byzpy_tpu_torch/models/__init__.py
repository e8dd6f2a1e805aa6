"""Models, data and parameter conversion for the PS round."""

from .bundle import ModelBundle, softmax_cross_entropy_loss
from .convert import from_flax, ordered_like, to_flax
from .data import synthetic_classification
from .nets import MLP, SmallCNN, init_params, make_bundle, mnist_cnn, mnist_mlp

__all__ = [
    "MLP",
    "ModelBundle",
    "SmallCNN",
    "from_flax",
    "init_params",
    "make_bundle",
    "mnist_cnn",
    "mnist_mlp",
    "ordered_like",
    "softmax_cross_entropy_loss",
    "synthetic_classification",
    "to_flax",
]
