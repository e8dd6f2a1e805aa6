"""The serving tier's update paths (counterpart of ``byzpy_tpu/serving``,
the ported part): the bucket ladder, staleness discounts, the submission
record, cohort assembly (dense and quantized) and the ragged door's
synchronous executor. The update steps themselves are
``parallel.ps.build_serving_ps_step`` and
``parallel.ps.build_ragged_serving_ps_step``."""

from .buckets import BucketLadder
from .cohort import Cohort, CohortAggregator, build_cohort
from .queue import Submission
from .ragged import RaggedExecutor, RaggedView
from .staleness import StalenessPolicy

__all__ = [
    "BucketLadder",
    "Cohort",
    "CohortAggregator",
    "RaggedExecutor",
    "RaggedView",
    "StalenessPolicy",
    "Submission",
    "build_cohort",
]
