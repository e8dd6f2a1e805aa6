"""The actor layer (counterpart of ``byzpy_tpu/engine/actor``): the actor
protocol, channels, the in-process backends (``thread``, ``cuda``), the
out-of-process ones (``process``, the ``tcp://`` remote backend and its
``RemoteActorServer``), the shm payload wrapping (``ipc``) and the wire's
frames and compressed rows (``wire``)."""

from .base import ActorBackend, ActorRef, spawn_actor
from .channels import ChannelRef, Endpoint, open_channel
from .factory import resolve_backend

__all__ = ["ActorBackend", "ActorRef", "ChannelRef", "Endpoint", "open_channel",
           "resolve_backend", "spawn_actor"]
