"""Runtime checks of the serving tier (counterpart of
``byzpy_tpu/analysis``, its runtime sanitizer only; the static rules and
the CLI's ``lint`` wait for ROADMAP A.8)."""

from . import sanitize

__all__ = ["sanitize"]
