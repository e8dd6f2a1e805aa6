"""The graph engine's operator protocol (the schedulers and pools are not
ported yet)."""

from .operator import OpContext, Operator
from .subtask import SubTask

__all__ = ["OpContext", "Operator", "SubTask"]
