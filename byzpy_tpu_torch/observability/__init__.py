"""Runtime telemetry: the switch, spans and the metrics registry.

Counterpart of ``byzpy_tpu/observability``, cut to what the orchestrators
and the serving frontend read: ``runtime.STATE``, the spans and their
context (``tracing``), the registry of counters, gauges and histograms
with its Prometheus and JSONL exporters (``metrics``), and the
program-build counts (``jitstats``). The flight recorder, SLOs, the
critical path and the catalog wait for ROADMAP A.6(c).
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
