"""Robust aggregation, attacks and the CUDA kernels under them."""

from . import attack_ops, kernels, robust

__all__ = ["attack_ops", "kernels", "robust"]
