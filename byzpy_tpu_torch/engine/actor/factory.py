"""Backend spec resolution.

Counterpart of ``byzpy_tpu/engine/actor/factory.py`` (ref:
``byzpy/engine/actor/factory.py:14-67``). Specs:

* ``"thread"``: a dedicated-thread actor in this process (the default);
* ``"cuda"`` / ``"cuda:N"``: an actor pinned to card N (0 by default) on
  a stream of its own, the counterpart of the JAX package's ``"tpu"``;
* ``"process"``: an actor in a spawned child process (on the card by
  default, ``child_device="cpu"`` to keep it off);
* ``"tcp://host:port"``: an actor hosted on a remote ``RemoteActorServer``.

Any other spec, ``"tpu"`` included, is unknown.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from .backends.cuda import CudaActorBackend
from .backends.process import ProcessActorBackend
from .backends.remote import RemoteActorBackend
from .backends.thread import ThreadActorBackend


def _tcp_address(spec: str) -> Tuple[str, int]:
    host, _, port = spec[len("tcp://"):].rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"tcp spec must be tcp://host:port (got {spec!r})")
    return host, int(port)


def parse_spec(spec: str) -> Tuple[str, Optional[int]]:
    """``(scheme, device index or port)`` of a backend spec, validated
    without building anything: ``("thread", None)``, ``("cuda", N)``,
    ``("process", None)``, ``("tcp", port)``."""
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"invalid backend spec {spec!r}")
    if spec in ("thread", "process"):
        return spec, None
    if spec == "cuda":
        return "cuda", 0
    if spec.startswith("cuda:"):
        index = spec.split(":", 1)[1]
        if not index.isdigit():
            raise ValueError(f"cuda spec must be cuda:<device-index> (got {spec!r})")
        return "cuda", int(index)
    if spec.startswith("tcp://"):
        return "tcp", _tcp_address(spec)[1]
    raise ValueError(f"unknown actor backend spec {spec!r}")


def resolve_backend(spec: str = "thread", **kwargs: Any):
    """Build an actor backend from a spec string: ``thread``, ``cuda[:N]``,
    ``process`` or ``tcp://host:port``."""
    scheme, index = parse_spec(spec)
    if scheme == "thread":
        return ThreadActorBackend(**kwargs)
    if scheme == "process":
        return ProcessActorBackend(**kwargs)
    if scheme == "tcp":
        return RemoteActorBackend(*_tcp_address(spec), **kwargs)
    return CudaActorBackend(device_index=index, **kwargs)


__all__ = ["parse_spec", "resolve_backend"]
