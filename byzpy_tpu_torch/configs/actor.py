"""Global default actor-backend spec.

Counterpart of ``byzpy_tpu/configs/actor.py`` (API parity:
``byzpy/configs/actor.py:1-30``): ``set_actor`` / ``get_actor`` plus a
context-manager override. Specs are the strings
``engine.actor.factory.resolve_backend`` understands, ``"thread"``,
``"cuda"``, ``"cuda:N"``, ``"process"`` and ``"tcp://host:port"``,
validated by the same parser; anything else raises ``ValueError``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

from ..engine.actor.factory import parse_spec

_DEFAULT_ACTOR = "thread"
_actor_spec = _DEFAULT_ACTOR


def set_actor(spec: str) -> None:
    """Set the process-wide default actor backend spec."""
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"invalid actor spec {spec!r}")
    parse_spec(spec)
    global _actor_spec
    _actor_spec = spec


def get_actor() -> str:
    """Current default actor-backend spec string (see ``set_actor``)."""
    return _actor_spec


@contextlib.contextmanager
def use_actor(spec: str) -> Iterator[None]:
    """Temporarily override the default actor spec."""
    global _actor_spec
    parse_spec(spec)
    previous = _actor_spec
    _actor_spec = spec
    try:
        yield
    finally:
        _actor_spec = previous


__all__ = ["set_actor", "get_actor", "use_actor"]
