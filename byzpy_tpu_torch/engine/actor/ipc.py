"""Cross-process payload wrapping via the native shm store.

Counterpart of ``byzpy_tpu/engine/actor/ipc.py``: large tensors in a
payload tree are swapped for shm handles before pickling, and swapped
back (as tensors over the mapping, no copy) on the receiving side. A CUDA
tensor enters as its host copy, as the reference's device arrays do:
there is no CUDA-IPC handoff. Tensors smaller than ``min_bytes`` travel
inline: the pickle round trip is cheaper than two
mmap system calls for small payloads.

``wrap_payload(..., precision="int8"|"bf16")`` composes with the wire's
compressed tensor frames (:mod:`.wire`): large float tensors are
quantized first, so what lands in shm is the codes and per-block scales
(the :class:`~.wire.QuantizedWireArray` envelope recurses through the shm
swap like any other dataclass). ``unwrap_payload`` reverses both layers.
The default is lossless.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from . import wire as _wire
from ..storage import native_store

_TAG = "__BYZPY_SHARED_TENSOR__"
DEFAULT_MIN_BYTES = 64 * 1024


def _is_dataclass_instance(x: Any) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _rebuild_tuple(x: tuple, values: list) -> tuple:
    # keep namedtuples (and tuple subclasses with a sequence constructor)
    if hasattr(x, "_fields"):
        return type(x)(*values)
    if type(x) is not tuple:
        try:
            return type(x)(values)
        except TypeError:
            pass
    return tuple(values)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def wrap_payload(
    obj: Any,
    *,
    min_bytes: int = DEFAULT_MIN_BYTES,
    precision: Optional[str] = None,
) -> Tuple[Any, List[native_store.SharedTensorHandle]]:
    """Recursively replace large tensors with shm handles. Returns the
    wrapped payload and the handles registered (the caller owns their
    cleanup; on an error everything registered so far is unlinked before
    the raise).

    ``precision`` (``"int8"``/``"bf16"``) quantizes large float tensors into
    :class:`~.wire.QuantizedWireArray` frames before the shm swap: 4x (2x)
    fewer bytes, lossy; ``unwrap_payload`` dequantizes. ``None`` (default)
    is lossless; another value raises."""
    if precision is not None:
        if precision not in ("int8", "bf16"):
            raise ValueError(f"precision must be None, 'int8', or 'bf16' (got {precision!r})")
        obj = _wire.compress_payload(_wire.host_view(obj), precision)
    handles: List[native_store.SharedTensorHandle] = []

    def wrap(x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            if _nbytes(x) >= min_bytes:
                handle = native_store.register_tensor(x)
                handles.append(handle)
                return (_TAG, handle)
            return x.detach().cpu() if x.is_cuda else x
        if _is_dataclass_instance(x):
            return dataclasses.replace(
                x, **{f.name: wrap(getattr(x, f.name)) for f in dataclasses.fields(x)})
        if isinstance(x, dict):
            return {k: wrap(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return _rebuild_tuple(x, [wrap(v) for v in x])
        if isinstance(x, list):
            return [wrap(v) for v in x]
        return x

    try:
        return wrap(obj), handles
    except BaseException:
        cleanup_handles(handles)
        raise


def unwrap_payload(obj: Any, *, copy: bool = False, close: bool = False) -> Any:
    """Swap shm handles back for tensors. With ``copy=False`` the tensors
    lie over the segment, valid only while it lives; ``copy=True`` when
    the result must outlive the sender's cleanup. ``close=True`` (requires
    ``copy``) unmaps each segment right after copying, so the receiving
    process's mappings do not pile up. Quantized frames are dequantized
    back to (lossy) float tensors."""
    if close and not copy:
        raise ValueError("close=True requires copy=True (views need the mapping)")

    def unwrap(x: Any) -> Any:
        if (
            isinstance(x, tuple)
            and len(x) == 2
            and isinstance(x[0], str)
            and x[0] == _TAG
            and isinstance(x[1], native_store.SharedTensorHandle)
        ):
            view = native_store.open_tensor(x[1])
            if copy:
                out = view.clone()
                if close:
                    del view  # the mapping cannot close under a live view
                    native_store.close_tensor(x[1])
                return out
            return view
        if _is_dataclass_instance(x):
            return dataclasses.replace(
                x, **{f.name: unwrap(getattr(x, f.name)) for f in dataclasses.fields(x)})
        if isinstance(x, dict):
            return {k: unwrap(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return _rebuild_tuple(x, [unwrap(v) for v in x])
        if isinstance(x, list):
            return [unwrap(v) for v in x]
        return x

    return _wire.decompress_payload(unwrap(obj))


def cleanup_handles(handles: List[native_store.SharedTensorHandle]) -> None:
    """Unlink the shm segments behind ``handles`` (receiver-side teardown)."""
    for handle in handles:
        try:
            native_store.cleanup_tensor(handle)
        except OSError:
            pass


__all__ = ["DEFAULT_MIN_BYTES", "cleanup_handles", "unwrap_payload", "wrap_payload"]
