from .geometric_median import GeometricMedian
from .krum import Krum, MultiKrum
from .minimum_diameter_average import MinimumDiameterAveraging
from .monna import MoNNA
from .smea import SMEA

__all__ = ["MultiKrum", "Krum", "GeometricMedian", "MinimumDiameterAveraging", "MoNNA", "SMEA"]
