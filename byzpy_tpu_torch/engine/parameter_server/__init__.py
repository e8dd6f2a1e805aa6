"""The actor-mode parameter server (counterpart of
``byzpy_tpu/engine/parameter_server``): :class:`ParameterServer` with its
elastic and overlapped rounds."""

from ..overlap import OverlapConfig, RoundOverlapStats
from .elastic import ElasticPolicy, ElasticState, QuorumLostError, SuspectRecord
from .ps import ParameterServer

__all__ = [
    "ElasticPolicy",
    "ElasticState",
    "OverlapConfig",
    "ParameterServer",
    "QuorumLostError",
    "RoundOverlapStats",
    "SuspectRecord",
]
