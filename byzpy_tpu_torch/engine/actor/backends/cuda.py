"""CUDA actor backend: an actor pinned to one card, on a stream of its own.

Counterpart of ``byzpy_tpu/engine/actor/backends/tpu.py:31-134``, the
reference's ``GPUActorBackend`` (ref:
``byzpy/engine/actor/backends/gpu.py:23-204``). One thread per actor, as
the thread backend; what differs is the device context:

* ``construct`` and ``call`` run under ``torch.cuda.device(i)`` and a
  ``torch.cuda.Stream`` the actor owns, so every kernel the hosted object
  launches (the port's wrappers launch on the current stream) queues on
  that stream, and several actors on one card run their kernels side by
  side;
* arguments and channel payloads pass by reference: a CUDA tensor, or a
  view of one, stays where it is.

The stream discipline that makes the reference passing safe, per call
(and for ``construct``, which builds the hosted object):

1. the actor's stream waits on an event recorded on the caller's current
   stream, so the actor never reads a tensor the caller has not finished
   writing;
2. every CUDA tensor argument on the actor's card (views included) gets
   ``record_stream(actor_stream)``, so the caching allocator does not hand
   its memory to another allocation while the actor may still read it,
   even if the caller drops its last reference at once;
3. when the call returns, the caller's current stream waits on an event
   recorded on the actor's stream, and every CUDA tensor of the result
   gets ``record_stream(caller_stream)``.

No call synchronizes the device. While a call runs on an actor's thread
no CUDA graph capture may start (``utils.cuda_graph``: a capture refuses
with ``GraphCaptureError``), and no call starts while one is capturing.

There is no fallback: without CUDA the backend raises ``RuntimeError``;
the ``thread`` backend is the CPU's.
"""

from __future__ import annotations

import asyncio
import inspect
from typing import Any, Callable, List

import torch

from ....utils.cuda_graph import launching_actors
from ..channels import Endpoint
from .thread import ThreadActorBackend, _invoke


def _cuda_tensors(obj: Any, device: torch.device, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The CUDA tensors on ``device`` in ``obj``, through tuples, lists and
    dictionaries."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda and obj.device == device:
            out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_tensors(v, device, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_tensors(v, device, out)
    return out


class CudaActorBackend(ThreadActorBackend):
    """Device-pinned backend: one actor on card ``device_index``, its calls
    on a stream of its own (module docstring)."""

    scheme = "cuda"

    def __init__(self, *, device_index: int = 0, actor_id: str | None = None) -> None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the 'cuda' actor backend runs on an NVIDIA GPU; "
                "use the 'thread' backend on the CPU"
            )
        count = torch.cuda.device_count()
        if not 0 <= device_index < count:
            raise ValueError(
                f"device_index {device_index} out of range; {count} devices visible"
            )
        self.device = torch.device("cuda", device_index)
        self.device_index = device_index
        #: the actor's stream, made by ``start``
        self.stream: torch.cuda.Stream | None = None
        super().__init__(actor_id=actor_id)

    async def start(self) -> None:
        if self._started:
            return
        self.stream = torch.cuda.Stream(device=self.device)
        await super().start()

    def _on_actor(self, work: Callable[[], Any]) -> Callable[[], Any]:
        def run():
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                return work()

        return run

    async def construct(self, target: Any, /, *args: Any, **kwargs: Any) -> None:
        """Build the hosted object on the actor's thread and stream, under
        the calls' discipline: the actor's stream first waits on the
        caller's (a node built from a data shard the caller just wrote),
        and the arguments' memory is kept for the actor's stream."""
        self._ensure_started()
        stream = self.stream
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        for t in _cuda_tensors((args, kwargs), self.device, []):
            t.record_stream(stream)

        def build():
            with launching_actors.call():
                stream.wait_event(ready)
                return target(*args, **kwargs)

        loop = asyncio.get_running_loop()
        self._obj = await loop.run_in_executor(self._executor, self._on_actor(build))

    async def call(self, method: str, /, *args: Any, **kwargs: Any) -> Any:
        self._ensure_started()
        if self._obj is None:
            raise RuntimeError("actor not constructed")
        fn = getattr(self._obj, method)
        stream = self.stream
        ready, done = torch.cuda.Event(), torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        for t in _cuda_tensors((args, kwargs), self.device, []):
            t.record_stream(stream)

        def run():
            with launching_actors.call(), torch.cuda.device(self.device), torch.cuda.stream(stream):
                stream.wait_event(ready)
                try:
                    return _invoke(fn, args, kwargs)
                finally:
                    done.record(stream)

        loop = asyncio.get_running_loop()
        try:
            result = await loop.run_in_executor(self._executor, run)
        finally:
            # a failed call may have queued work too (an unrecorded event
            # is no wait)
            caller = torch.cuda.current_stream(self.device)
            caller.wait_event(done)
        for t in _cuda_tensors(result, self.device, []):
            t.record_stream(caller)
        if inspect.isawaitable(result):
            result = await result
        return result

    def get_endpoint(self) -> Endpoint:
        return Endpoint(self.scheme, f"cuda:{self.device_index}", self.actor_id)


__all__ = ["CudaActorBackend"]
