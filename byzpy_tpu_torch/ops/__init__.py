"""Robust aggregation, pre-aggregation, attacks and the CUDA kernels under them."""

from . import attack_ops, kernels, preagg, robust

__all__ = ["attack_ops", "kernels", "preagg", "robust"]
