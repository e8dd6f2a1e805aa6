"""Process-wide telemetry switch.

Counterpart of ``byzpy_tpu/observability/runtime.py``. Every instrumented
hot path (the round loops of ``engine.parameter_server`` and
``engine.peer_to_peer``, the overlap engine) guards its telemetry behind
``STATE.enabled``, one attribute read on a module singleton: with
telemetry off a span is the shared no-op :data:`~.tracing.NULL_SPAN` and
nothing is allocated.

Telemetry is off by default. Turn it on with ``BYZPY_TPU_TELEMETRY=1`` in
the environment (read once at import), the JAX package's variable, or
with :func:`enable`.
"""

from __future__ import annotations

import os

_TRUTHY = ("1", "on", "true", "yes")


def _env_enabled() -> bool:
    """Initial switch position from ``BYZPY_TPU_TELEMETRY``."""
    return os.environ.get("BYZPY_TPU_TELEMETRY", "").strip().lower() in _TRUTHY


class TelemetryState:
    """Mutable process-wide telemetry switch (module singleton
    :data:`STATE`); hot paths read ``STATE.enabled`` directly."""

    __slots__ = ("enabled",)

    def __init__(self) -> None:
        self.enabled = _env_enabled()


#: The process-wide switch.
STATE = TelemetryState()


def enabled() -> bool:
    """Whether telemetry (tracing and metrics publishing) is on."""
    return STATE.enabled


def enable() -> None:
    """Turn telemetry on for this process."""
    STATE.enabled = True


def disable() -> None:
    """Turn telemetry off."""
    STATE.enabled = False


__all__ = ["STATE", "TelemetryState", "disable", "enable", "enabled"]
