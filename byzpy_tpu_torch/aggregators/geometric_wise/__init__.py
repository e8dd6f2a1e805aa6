from .geometric_median import GeometricMedian
from .krum import Krum, MultiKrum
from .monna import MoNNA

__all__ = ["MultiKrum", "Krum", "GeometricMedian", "MoNNA"]
