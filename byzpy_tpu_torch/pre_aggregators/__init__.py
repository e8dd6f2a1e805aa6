"""Pre-aggregator classes (counterpart of ``byzpy_tpu/pre_aggregators``)."""

from .arc import ARC
from .base import PreAggregator
from .bucketing import Bucketing
from .clipping import Clipping
from .nnm import NearestNeighborMixing

__all__ = ["PreAggregator", "Clipping", "Bucketing", "NearestNeighborMixing", "ARC"]
