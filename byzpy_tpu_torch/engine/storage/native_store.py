"""Shared-memory tensor store over the native ``bshm`` C library.

Counterpart of ``byzpy_tpu/engine/storage/native_store.py``:
``register_tensor`` copies a tensor into a named POSIX shm segment and
returns a picklable :class:`SharedTensorHandle`; ``open_tensor`` maps it in
any process as a CPU tensor over the mapping, with no copy;
``cleanup_tensor`` unlinks it. The C library (the package's own copy of
``native/bshm.c``) is compiled with the host C compiler at first use into
``byzpy_tpu_torch/_build/bshm-<hash>/`` and probe-loaded (:func:`available`).
It avoids ``multiprocessing.shared_memory``'s resource tracker, whose
at-exit unlinking misfires across independently spawned actor processes.
Without a C compiler a pure-Python path on ``multiprocessing.shared_memory``
keeps the same API.

A handle carries the tensor's torch dtype name (``"float32"``,
``"bfloat16"``, ``"float8_e4m3fn"``, ...) and its shape, so every torch
dtype crosses as raw bytes. The store is host memory: a CUDA tensor is
registered from its host copy (the process tier's host views).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False

_C_SRC = Path(__file__).resolve().parent / "native" / "bshm.c"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "_build"


def _loadable(path: str) -> bool:
    """Probe-load a candidate library: a compile can succeed and still
    produce a .so with unresolved symbols (glibc < 2.34 keeps
    ``shm_open``/``shm_unlink`` in librt, so a link without ``-lrt`` only
    fails at dlopen time)."""
    try:
        ctypes.CDLL(path)
        return True
    except OSError:
        return False


def _build_library() -> Optional[str]:
    """Compile bshm.c to ``_build/bshm-<source hash>/libbshm.so`` (kept
    across processes, probe-loaded); ``None`` without a working compiler."""
    digest = hashlib.sha256(_C_SRC.read_bytes()).hexdigest()[:16]
    out_dir = _BUILD_ROOT / f"bshm-{digest}"
    lib_path = out_dir / "libbshm.so"
    if lib_path.exists():
        if _loadable(str(lib_path)):
            return str(lib_path)
        try:  # a broken artifact: rebuild rather than poison every process
            lib_path.unlink()
        except OSError:
            pass
    try:
        out_dir.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    # -lrt second: a stub on glibc >= 2.34, required for shm_open before
    for cc in ("cc", "gcc", "clang"):
        for extra in ((), ("-lrt",)):
            try:
                with tempfile.NamedTemporaryFile(suffix=".so", dir=out_dir, delete=False) as tmp:
                    tmp_path = tmp.name
                proc = subprocess.run(
                    [cc, "-O2", "-shared", "-fPIC", "-o", tmp_path, str(_C_SRC), *extra],
                    capture_output=True, timeout=120,
                )
                if proc.returncode == 0 and _loadable(tmp_path):
                    os.replace(tmp_path, lib_path)  # atomic for concurrent builders
                    return str(lib_path)
                os.unlink(tmp_path)
            except (OSError, subprocess.TimeoutExpired):
                continue
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    with _LIB_LOCK:
        if _LIB is not None or _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        path = _build_library()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.bshm_map.restype = ctypes.c_void_p
        lib.bshm_map.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int)]
        lib.bshm_unmap.restype = ctypes.c_int
        lib.bshm_unmap.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.bshm_unlink.restype = ctypes.c_int
        lib.bshm_unlink.argtypes = [ctypes.c_char_p]
        lib.bshm_size.restype = ctypes.c_uint64
        lib.bshm_size.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        _LIB = lib
        return _LIB


def available() -> bool:
    """True when the native library is (or can be) built and loaded."""
    return _load() is not None


def _dtype_of(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown torch dtype {name!r}")
    return dtype


@dataclass(frozen=True)
class SharedTensorHandle:
    """Picklable descriptor of a shm-resident tensor: the segment's name,
    the shape and the torch dtype name."""

    name: str
    shape: Tuple[int, ...]
    dtype: str

    @property
    def torch_dtype(self) -> torch.dtype:
        return _dtype_of(self.dtype)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.torch_dtype.itemsize


# maps kept per process so views can be unmapped deterministically; a name
# may be mapped more than once, so each mapping is tracked
_mappings: Dict[str, List[Tuple[int, int]]] = {}  # name -> [(ptr, nbytes)]
_fallback_segments: Dict[str, List[object]] = {}


def _map(name: str, nbytes: int, create: bool) -> torch.Tensor:
    """A uint8 CPU tensor over ``nbytes`` of the segment ``name``."""
    lib = _load()
    if lib is not None:
        err = ctypes.c_int(0)
        if not create:
            # touching pages past the segment's real size is SIGBUS, not an
            # exception: refuse a stale or mismatched handle first
            actual = int(lib.bshm_size(name.encode(), ctypes.byref(err)))
            if actual == 0 and err.value != 0:
                raise OSError(err.value, f"bshm_size({name!r}) failed: errno {err.value}")
            if actual < nbytes:
                raise ValueError(f"shared segment {name!r} holds {actual} bytes but the "
                                 f"handle expects {nbytes}: stale or mismatched handle")
        ptr = lib.bshm_map(name.encode(), nbytes, 1 if create else 0, ctypes.byref(err))
        if not ptr:
            raise OSError(err.value, f"bshm_map({name!r}) failed: errno {err.value}")
        _mappings.setdefault(name, []).append((ptr, nbytes))
        buf = (ctypes.c_ubyte * nbytes).from_address(ptr)
        return torch.frombuffer(buf, dtype=torch.uint8)
    from multiprocessing import resource_tracker, shared_memory

    shm = shared_memory.SharedMemory(name=name.lstrip("/"), create=create, size=nbytes)
    # the tracker would unlink other processes' segments at exit: an opener
    # unregisters to stay hands-off
    if not create:
        try:
            resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
        except Exception:  # noqa: BLE001 - the tracker's API is private
            pass
    if not create and shm.size < nbytes:
        shm.close()
        raise ValueError(f"shared segment {name!r} holds {shm.size} bytes but the "
                         f"handle expects {nbytes}: stale or mismatched handle")
    _fallback_segments.setdefault(name, []).append(shm)
    return torch.frombuffer(shm.buf, dtype=torch.uint8)[:nbytes]


def register_tensor(tensor: torch.Tensor, *, name: Optional[str] = None) -> SharedTensorHandle:
    """Copy ``tensor`` into a fresh shm segment; returns its handle."""
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"register_tensor takes a tensor, got {type(tensor).__name__}")
    src = tensor.detach().cpu().contiguous()
    name = name or f"/byzpy-torch-{uuid.uuid4().hex[:16]}"
    handle = SharedTensorHandle(name, tuple(src.shape), str(src.dtype).removeprefix("torch."))
    view = _map(name, max(1, handle.nbytes), create=True)
    if handle.nbytes:
        view[: handle.nbytes].copy_(src.reshape(-1).view(torch.uint8))
    return handle


def open_tensor(handle: SharedTensorHandle) -> torch.Tensor:
    """A CPU tensor over the registered segment in this process, no copy."""
    view = _map(handle.name, max(1, handle.nbytes), create=False)
    return view[: handle.nbytes].view(handle.torch_dtype).reshape(handle.shape)


def close_tensor(handle: SharedTensorHandle) -> None:
    """Unmap this process's views of the segment (the segment persists).
    Callers drop their tensors over it first; on the pure-Python path a
    segment whose buffer is still exported stays open until a later call."""
    lib = _load()
    if lib is not None:
        for ptr, nbytes in _mappings.pop(handle.name, []):
            lib.bshm_unmap(ptr, nbytes)
        return
    survivors = []
    for shm in _fallback_segments.pop(handle.name, []):
        try:
            shm.close()
        except BufferError:
            survivors.append(shm)
    if survivors:
        _fallback_segments[handle.name] = survivors


def cleanup_tensor(handle: SharedTensorHandle) -> None:
    """Unmap and unlink the segment."""
    close_tensor(handle)
    lib = _load()
    if lib is not None:
        lib.bshm_unlink(handle.name.encode())
        return
    from multiprocessing import shared_memory

    try:
        shm = shared_memory.SharedMemory(name=handle.name.lstrip("/"))
        shm.close()
        shm.unlink()
    except FileNotFoundError:
        pass


__all__ = [
    "SharedTensorHandle",
    "available",
    "cleanup_tensor",
    "close_tensor",
    "open_tensor",
    "register_tensor",
]
