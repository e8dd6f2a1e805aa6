"""The serving tier's bucketed update path (counterpart of
``byzpy_tpu/serving``, the ported part): the bucket ladder, staleness
discounts, the submission record and dense cohort assembly. The update
step itself is ``parallel.ps.build_serving_ps_step``."""

from .buckets import BucketLadder
from .cohort import Cohort, CohortAggregator, build_cohort
from .queue import Submission
from .staleness import StalenessPolicy

__all__ = [
    "BucketLadder",
    "Cohort",
    "CohortAggregator",
    "StalenessPolicy",
    "Submission",
    "build_cohort",
]
