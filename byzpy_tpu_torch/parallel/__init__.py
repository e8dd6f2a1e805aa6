"""Training rounds."""

from .ps import PSStepConfig, SGD, build_ps_train_step, default_optimizer

__all__ = ["PSStepConfig", "SGD", "build_ps_train_step", "default_optimizer"]
