"""Execution engine (counterpart of ``byzpy_tpu/engine``): so far the
operator protocol of ``engine.graph``."""
