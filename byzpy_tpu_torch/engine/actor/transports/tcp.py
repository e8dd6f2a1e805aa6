"""Connection-per-request TCP channel transport.

Counterpart of ``byzpy_tpu/engine/actor/transports/tcp.py``: used when a
local backend delivers a channel payload to an actor hosted on a remote
``RemoteActorServer`` with no connection of its own to it.

The dial is retried under a :class:`~byzpy_tpu_torch.resilience.retry.RetryPolicy`
(a restarting server is ridden out), but a request already sent is never
replayed: a channel put carries no idempotency key, so an ambiguous
failure surfaces to the caller. ``BYZPY_TPU_TORCH_TCP_RETRIES`` and
``BYZPY_TPU_TORCH_TCP_RETRY_DEADLINE_S`` set the dial attempts (4) and
the total seconds (10).
"""

from __future__ import annotations

import os
from typing import Any, Tuple

from ....resilience.retry import RetryPolicy, connect_with_retry
from .. import wire
from ..channels import Endpoint


def _split(address: str) -> Tuple[str, int]:
    host, _, port = address.rpartition(":")
    return host, int(port)


def dial_policy() -> RetryPolicy:
    """The dial retry policy, read from the environment per call."""
    try:
        attempts = int(os.environ.get("BYZPY_TPU_TORCH_TCP_RETRIES", "4"))
    except ValueError:
        attempts = 4
    try:
        deadline = float(os.environ.get("BYZPY_TPU_TORCH_TCP_RETRY_DEADLINE_S", "10"))
    except ValueError:
        deadline = 10.0
    return RetryPolicy(max_attempts=max(1, attempts), base_s=0.05, cap_s=1.0,
                       deadline_s=max(0.1, deadline))


async def _roundtrip(address: str, msg: dict) -> Any:
    host, port = _split(address)
    reader, writer = await connect_with_retry(host, port, policy=dial_policy(),
                                              component="actor_tcp")
    try:
        await wire.send_obj(writer, {**msg, "req_id": 0})
        reply = await wire.recv_obj(reader)
        if not reply["ok"]:
            name, text, tb = reply["result"]
            raise RuntimeError(f"{name} on remote server: {text}\n{tb}")
        return reply["result"]
    finally:
        writer.close()


async def chan_put(endpoint: Endpoint, name: str, payload: Any) -> None:
    """Send ``payload`` into the remote channel ``name`` at ``endpoint``."""
    await _roundtrip(endpoint.address, {"op": "chan_put", "actor_id": endpoint.actor_id,
                                        "name": name, "payload": wire.host_view(payload)})


async def chan_get(endpoint: Endpoint, name: str) -> Any:
    """The next item of the remote channel ``name`` (blocks on the server)."""
    return await _roundtrip(endpoint.address,
                            {"op": "chan_get", "actor_id": endpoint.actor_id, "name": name})


__all__ = ["chan_get", "chan_put", "dial_policy"]
