"""Backend spec resolution.

Counterpart of ``byzpy_tpu/engine/actor/factory.py`` (ref:
``byzpy/engine/actor/factory.py:14-67``). Specs:

* ``"thread"``: a dedicated-thread actor in this process (the default);
* ``"cuda"`` / ``"cuda:N"``: an actor pinned to card N (0 by default) on
  a stream of its own, the counterpart of the JAX package's ``"tpu"``;
* ``"process"`` and ``"tcp://host:port"`` (the spawned-process and remote
  actors) are not ported yet and raise ``NotImplementedError`` (ROADMAP
  A.4); any other spec, ``"tpu"`` included, is unknown.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from .backends.cuda import CudaActorBackend
from .backends.thread import ThreadActorBackend


def parse_spec(spec: str) -> Tuple[str, Optional[int]]:
    """``(scheme, device index or None)`` of a backend spec, validated
    without building anything: ``("thread", None)``, ``("cuda", N)``."""
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"invalid backend spec {spec!r}")
    if spec == "thread":
        return "thread", None
    if spec == "cuda":
        return "cuda", 0
    if spec.startswith("cuda:"):
        index = spec.split(":", 1)[1]
        if not index.isdigit():
            raise ValueError(f"cuda spec must be cuda:<device-index> (got {spec!r})")
        return "cuda", int(index)
    if spec == "process" or spec.startswith("tcp://"):
        raise NotImplementedError(
            f"actor backend {spec!r} is not ported yet: the process and remote backends "
            f"come later (ROADMAP A.4); use 'thread' or 'cuda'"
        )
    raise ValueError(f"unknown actor backend spec {spec!r}")


def resolve_backend(spec: str = "thread", **kwargs: Any):
    """Build an actor backend from a spec string: ``thread`` or
    ``cuda[:N]``."""
    scheme, index = parse_spec(spec)
    if scheme == "thread":
        return ThreadActorBackend(**kwargs)
    return CudaActorBackend(device_index=index, **kwargs)


__all__ = ["parse_spec", "resolve_backend"]
