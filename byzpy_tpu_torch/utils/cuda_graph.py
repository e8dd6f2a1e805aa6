"""Steps captured in CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package compiles its training and serving steps with ``jax.jit``,
one program per input shape, parameters and optimizer state donated
(``byzpy_tpu/parallel/ps.py:654-735``). Here the same step runs eagerly,
one kernel launch at a time from Python, until :class:`CapturedStep`
captures it: on CUDA inputs it records the whole step in one
``torch.cuda.CUDAGraph`` per input signature and replays it, a launch of
the graph and the copies of the inputs into its buffers in place of the
step's ~100-1,700 launches.

* **Signature.** The structure of the arguments, each tensor's shape and
  dtype (each other leaf's value), the device and whether a generator is
  given: the shape keying of ``jax.jit`` (one graph per serving bucket,
  one per ragged capacity).
* **Warm-up.** Before capturing a signature, the step runs once eagerly
  on copies of the inputs, on the stream it is then captured on. That
  run reaches every kernel's first-launch setup (``cudaFuncSetAttribute``)
  and makes the caches kept per stream (B5's ticket scratch) outside the
  capture. Its launches are taken off ``kernels.launch_counts`` again, the
  default generator's state is restored and the caller's generator is
  never drawn from: the caller's state does not advance.
* **State.** The step's first ``state_args`` arguments are its state:
  the PS twins' parameters and optimizer state (2), a gossip round's
  stacked node parameters (1). The step returns the new state, shaped like
  those arguments, then its metrics: ``(*state', metrics)``.
* **Capture.** The new state is written back into the graph's input
  buffers of the state arguments as the graph's last work, so a replay
  updates them in place. The wrappers count their launches once, at the
  capture; each replay adds one to
  ``kernels.launch_counts["graph_replay:<name>"]``.
* **Donation.** With ``donate=True`` the call returns those input buffers
  themselves: passed back in, they need no copy, and the previous
  round's references are overwritten (``jax.jit``'s ``donate_argnums``
  over the state arguments). With ``donate=False`` it returns clones.
  Metrics are always clones.
* **Randomness.** A generator passed to the step is not captured itself:
  the graph holds a generator of its own, registered with it, whose state
  is set from the caller's before each replay and copied back after, so
  each replay draws what the eager step would draw from that state and
  advances the caller's generator as the eager step would.
* **No fallback.** A step that reads the host while it is captured (a
  synchronizing operation: ``.item()``, ``.cpu()``, a ``bool`` of a
  tensor; or a copy from host memory, as of a numpy state) cannot be
  captured; the capture raises
  :class:`GraphCaptureError`, naming the callable that read where
  :func:`capture_guard` wrapped it. Nothing then runs eagerly on the card.

* **Actor pools.** A capture uses CUDA's global capture mode, in which
  another thread's unsafe call (an allocation, a synchronization) fails
  the capture. So a capture refuses with :class:`GraphCaptureError` while
  a ``cuda`` actor (``engine/actor/backends/cuda.py``) runs a call on its
  thread, and no actor call starts while a capture runs
  (:data:`launching_actors`).

On CPU inputs the step runs eagerly: the caller asked for the CPU.
Graphs capture on one side stream of the :class:`CapturedStep` and replay
on the caller's current stream; replays of one :class:`CapturedStep` on
two streams at once are not supported.
"""

from __future__ import annotations

import contextlib
import functools
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..ops import kernels
from .trees import _build, _spec

# what PyTorch and CUDA report for an operation a stream capture does not
# allow (a host synchronization, a copy between the host's pageable memory
# and the card) and for a capture it invalidated
_CAPTURE_ERRORS = re.compile(
    r"not permitted when stream is capturing|StreamCapture|stream is capturing|"
    r"during CUDA graph capture|capture.*invalidated|CUDA error 90[01]\b", re.IGNORECASE)


class GraphCaptureError(RuntimeError):
    """A step could not be captured in a CUDA graph."""


class LaunchingActors:
    """The process's ``cuda`` actor calls in flight and its captures in
    progress, kept apart: an actor call and a capture never overlap."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._calls = 0
        self._captures = 0

    @property
    def calls(self) -> int:
        return self._calls

    @contextlib.contextmanager
    def call(self):
        """Around a ``cuda`` actor's call on its thread."""
        with self._lock:
            if self._captures:
                raise RuntimeError(
                    "a CUDA graph capture is in progress in this process: a cuda actor cannot "
                    "launch work until it ends")
            self._calls += 1
        try:
            yield
        finally:
            with self._lock:
                self._calls -= 1

    @contextlib.contextmanager
    def capture(self, name: str):
        """Around a capture (warm-up included) of step ``name``."""
        with self._lock:
            if self._calls:
                raise GraphCaptureError(
                    f"{name} cannot be captured while {self._calls} cuda actor call(s) are "
                    f"running: their threads launch and allocate on their own streams, which "
                    f"a capture in global mode does not allow; wait for the actor pool's "
                    f"subtasks to finish (or close the pool) first")
            self._captures += 1
        try:
            yield
        finally:
            with self._lock:
                self._captures -= 1


#: the process's one record: CUDA's capture mode is process-wide
launching_actors = LaunchingActors()


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def capture_guard(fn: Callable, role: str) -> Callable:
    """``fn`` unchanged outside a stream capture; inside one, an exception
    it raises becomes a :class:`GraphCaptureError` that names ``role`` and
    ``fn`` and, for the capture's own errors, says that ``fn`` reads the
    host."""
    if fn is None:
        return None
    what = getattr(fn, "__qualname__", None) or getattr(fn, "__name__", None) or repr(fn)
    if isinstance(fn, functools.partial):
        what = repr(fn)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not _capturing():
            return fn(*args, **kwargs)
        try:
            return fn(*args, **kwargs)
        except GraphCaptureError:
            raise
        except Exception as exc:
            if _CAPTURE_ERRORS.search(str(exc)):
                raise GraphCaptureError(
                    f"the {role} callable {what} reads the host inside the step (a "
                    f"synchronization or a copy between host memory and the card while the "
                    f"stream is capturing), so the step cannot run in a CUDA graph: {exc}") from exc
            raise GraphCaptureError(
                f"the {role} callable {what} failed while the step was captured: {exc}") from exc

    return call


def _is_tensor(leaf: Any) -> bool:
    return isinstance(leaf, torch.Tensor)


def _leaves(tree: Any) -> tuple:
    leaves: List[Any] = []
    spec = _spec(tree, leaves)
    return leaves, spec


def _device(device) -> torch.device:
    """``device`` with the current CUDA device's index where it has none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _same_buffer(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.stride() == b.stride()
                      and a.shape == b.shape and a.dtype == b.dtype)


class _Graph:
    """One captured signature: the graph, its input buffers (the leaves of
    the arguments), its metrics and its registered generator."""

    def __init__(self, graph, static_in: list, spec, outputs, generator):
        self.graph, self.static_in, self.spec = graph, static_in, spec
        self.outputs, self.generator = outputs, generator


class CapturedStep:
    """``step(*args[, generator=...])`` replayed from CUDA graphs on the card
    (module docstring). ``step`` returns ``(args[0]', ..., args[k - 1]',
    metrics)`` for ``k = state_args``: the new state shaped like the first
    ``k`` arguments, and a structure of tensors. ``name`` keys the replay
    counter ``graph_replay:<name>``.

    :attr:`graphs` holds one entry a captured signature;
    :attr:`last_capture` has the launches the last capture recorded (its
    ``kernels.launch_counts`` increments), its warm-up's and its wall
    time in ms."""

    def __init__(self, step: Callable, *, name: str, donate: bool, state_args: int = 2):
        if state_args < 1:
            raise ValueError(f"state_args must be >= 1, got {state_args}")
        self.step, self.name, self.donate, self.state_args = step, name, donate, state_args
        self.counter = f"graph_replay:{name}"
        if self.counter not in kernels.launch_counts:
            raise ValueError(f"no replay counter {self.counter!r} in kernels.launch_counts")
        self.graphs: Dict[Any, _Graph] = {}
        self.last_capture: Optional[dict] = None
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    # -- dispatch -----------------------------------------------------------

    def __call__(self, *args, generator: Optional[torch.Generator] = None):
        leaves, spec = _leaves(args)
        devices = {_device(t.device) for t in leaves if _is_tensor(t)}
        if generator is not None:
            devices.add(_device(generator.device))
        if not devices or devices == {torch.device("cpu")}:
            return self.step(*args, **self._gen_kw(generator))
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"a compiled step takes its tensors and generator on one CUDA "
                             f"device, got {sorted(map(str, devices))}")
        device = next(iter(devices))
        key = (spec, device, generator is not None,
               tuple((tuple(t.shape), t.dtype) if _is_tensor(t) else ("value", t) for t in leaves))
        entry = self.graphs.get(key)
        if entry is None:
            entry = self._capture(device, leaves, spec, generator)
            self.graphs[key] = entry
        return self._replay(entry, leaves, generator)

    @staticmethod
    def _gen_kw(generator) -> dict:
        return {} if generator is None else {"generator": generator}

    # -- replay -------------------------------------------------------------

    def _replay(self, entry: _Graph, leaves: list, generator):
        for static, leaf in zip(entry.static_in, leaves):
            if _is_tensor(leaf) and not _same_buffer(static, leaf):
                static.copy_(leaf)
        if generator is not None:
            entry.generator.set_state(generator.get_state())
        entry.graph.replay()
        if generator is not None:
            generator.set_state(entry.generator.get_state())
        kernels.count_launch(self.counter)
        state = _build(entry.spec, iter(entry.static_in))[:self.state_args]
        if not self.donate:
            state = tuple(_map(torch.clone, s) for s in state)
        return (*state, _map(torch.clone, entry.outputs))

    # -- capture ------------------------------------------------------------

    def _capture(self, device: torch.device, leaves: list, spec, generator) -> _Graph:
        with launching_actors.capture(self.name):
            return self._capture_alone(device, leaves, spec, generator)

    def _capture_alone(self, device: torch.device, leaves: list, spec, generator) -> _Graph:
        t0 = time.perf_counter()
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device=device)
        # the input buffers belong to the caller's stream, where replays copy
        # into them and launch the graph
        static_in = [t.detach().clone() if _is_tensor(t) else t for t in leaves]
        stream.wait_stream(torch.cuda.current_stream(device))
        args = _build(spec, iter(static_in))
        own = None
        if generator is not None:
            own = torch.Generator(device=device)
            own.set_state(generator.get_state())
        # warm-up on the capture stream, on copies; its launches and draws
        # are taken back
        counts = dict(kernels.launch_counts)
        default_rng = torch.cuda.get_rng_state(device)
        with torch.cuda.stream(stream):
            self.step(*args, **self._gen_kw(own))
        torch.cuda.synchronize(device)
        warmup = {k: v - counts.get(k, 0) for k, v in kernels.launch_counts.items()
                  if v != counts.get(k, 0)}
        kernels.launch_counts.clear()
        kernels.launch_counts.update(counts)
        torch.cuda.set_rng_state(default_rng, device)
        if own is not None:
            own.set_state(generator.get_state())
        graph = torch.cuda.CUDAGraph()
        if own is not None:
            graph.register_generator_state(own)
        torch.cuda.empty_cache()
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="global")
            try:
                out = self.step(*args, **self._gen_kw(own))
                if len(out) != self.state_args + 1:
                    raise ValueError(f"{self.name} returned {len(out)} values, not its "
                                     f"{self.state_args} state(s) and metrics")
                for i in range(self.state_args):
                    new, _ = _leaves(out[i])
                    old, _ = _leaves(args[i])
                    if len(new) != len(old):
                        raise ValueError(f"output {i} of {self.name} is not shaped like "
                                         f"argument {i}")
                    for dst, src in zip(old, new):
                        dst.copy_(src)
            except BaseException as exc:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is invalid after a failure inside it
                kernels.launch_counts.clear()  # nothing it recorded will run
                kernels.launch_counts.update(counts)
                if isinstance(exc, GraphCaptureError) or not isinstance(exc, Exception):
                    raise
                raise GraphCaptureError(
                    f"{self.name} could not be captured in a CUDA graph: {exc}") from exc
            graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(stream)
        recorded = {k: v - counts.get(k, 0) for k, v in kernels.launch_counts.items()
                    if v != counts.get(k, 0)}
        self.last_capture = {"launches": recorded, "warmup_launches": warmup,
                             "ms": (time.perf_counter() - t0) * 1e3}
        return _Graph(graph, static_in, spec, out[self.state_args], own)


def _map(fn: Callable, tree: Any) -> Any:
    leaves, spec = _leaves(tree)
    return _build(spec, iter([fn(t) if _is_tensor(t) else t for t in leaves]))


__all__ = ["CapturedStep", "GraphCaptureError", "LaunchingActors", "capture_guard", "launching_actors"]
