"""Robust aggregator classes (counterpart of ``byzpy_tpu/aggregators``;
the ported ones). Each keeps the JAX class's name, constructor
arguments and ``validate_n`` messages, and takes a keyword-only
``device``."""

from .base import Aggregator, SlotFoldState, ravel_gradient
from .coordinate_wise import CoordinateWiseMedian, CoordinateWiseTrimmedMean, MeanOfMedians
from .geometric_wise import GeometricMedian, Krum, MinimumDiameterAveraging, MoNNA, MultiKrum, SMEA
from .norm_wise import CAF, CenteredClipping, ComparativeGradientElimination
from .pipelines import fused_pipeline_matrix_fn

__all__ = [
    "Aggregator",
    "SlotFoldState",
    "ravel_gradient",
    "CoordinateWiseMedian",
    "CoordinateWiseTrimmedMean",
    "MeanOfMedians",
    "MultiKrum",
    "Krum",
    "GeometricMedian",
    "MoNNA",
    "MinimumDiameterAveraging",
    "SMEA",
    "CenteredClipping",
    "CAF",
    "ComparativeGradientElimination",
    "fused_pipeline_matrix_fn",
]
