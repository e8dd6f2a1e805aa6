from .caf import CAF
from .center_clipping import CenteredClipping
from .comparative_gradient_elimination import ComparativeGradientElimination

__all__ = ["CenteredClipping", "CAF", "ComparativeGradientElimination"]
