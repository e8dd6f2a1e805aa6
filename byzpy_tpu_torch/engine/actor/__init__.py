"""The actor layer (counterpart of ``byzpy_tpu/engine/actor``): the actor
protocol, channels and the in-process backends (``thread``, ``cuda``),
and the compressed wire rows (``wire``) that the serving tier's quantized
cohorts read."""

from .base import ActorBackend, ActorRef, spawn_actor
from .channels import ChannelRef, Endpoint, open_channel
from .factory import resolve_backend

__all__ = ["ActorBackend", "ActorRef", "ChannelRef", "Endpoint", "open_channel",
           "resolve_backend", "spawn_actor"]
