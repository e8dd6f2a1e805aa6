from .mean_of_medians import MeanOfMedians
from .median import CoordinateWiseMedian
from .trimmed_mean import CoordinateWiseTrimmedMean

__all__ = ["CoordinateWiseMedian", "CoordinateWiseTrimmedMean", "MeanOfMedians"]
