"""Runtime telemetry: the switch, spans and the metrics registry.

Counterpart of ``byzpy_tpu/observability``, cut to what the orchestrators
read (``runtime.STATE``, ``tracing.span`` / ``device_span`` /
``begin_span`` / ``end_span``, ``metrics.registry()``); the flight
recorder, SLOs, the critical path and the exporters wait for ROADMAP A.6.
Telemetry is off by default; :func:`enable` or ``BYZPY_TPU_TELEMETRY=1``
turns it on. This package imports no engine module and not torch at
import time.
"""

from .metrics import registry
from .runtime import STATE, TelemetryState, disable, enable, enabled
from .tracing import device_span, span, tracer

__all__ = [
    "STATE",
    "TelemetryState",
    "device_span",
    "disable",
    "enable",
    "enabled",
    "registry",
    "span",
    "tracer",
]
