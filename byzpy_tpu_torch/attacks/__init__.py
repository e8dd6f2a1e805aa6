"""Byzantine attack classes (counterpart of ``byzpy_tpu/attacks``): the
seven static attacks on :mod:`byzpy_tpu_torch.ops.attack_ops` and the
adaptive adversaries on the public round feed. Each keeps the JAX class's
name, constructor arguments and error messages, and takes a keyword-only
``device``."""

from .adaptive import (
    AdaptiveAttack,
    InfluenceAscentAttack,
    KrumEvasionAttack,
    PublicRoundState,
    ResidualShapingAttack,
    StalenessAbuseAttack,
)
from .base import Attack
from .empire import EmpireAttack
from .gaussian import GaussianAttack
from .inf import InfAttack
from .label_flip import LabelFlipAttack
from .little import LittleAttack
from .mimic import MimicAttack
from .sign_flip import SignFlipAttack

__all__ = [
    "Attack",
    "SignFlipAttack",
    "EmpireAttack",
    "LittleAttack",
    "GaussianAttack",
    "InfAttack",
    "MimicAttack",
    "LabelFlipAttack",
    "AdaptiveAttack",
    "InfluenceAscentAttack",
    "KrumEvasionAttack",
    "PublicRoundState",
    "ResidualShapingAttack",
    "StalenessAbuseAttack",
]
