"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, from the package's own sources, into
``byzpy_tpu_torch/_build/<hash>/`` (gitignored), where ``<hash>`` covers
every source and the flags, so an edited source rebuilds. All sources
compile in parallel, one ``nvcc`` process each. The flags must never
include ``--use_fast_math``: the codecs (``csrc/quantize.cu``) divide
``1 / scale`` as one IEEE division, as the reference does. A change to a
shared header (``csrc/*.cuh``) changes the hash too.

Nothing here runs at import time. Without ``nvcc`` the loader raises: a
CUDA tensor launches its kernel or fails, it never falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = (
    "sorted_reduce", "gram", "selection", "nnm", "clip_selection", "meamed", "center_step",
    "quantize", "segment_sum", "sort_columns", "segmented_sort",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c_void_p, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_c_float = ctypes.c_float
# C signature of every exported function: (library, argtypes)
SIGNATURES = {
    "byz_sorted_reduce": ("sorted_reduce", [
        _c_void_p, _c_void_p, _c_int, _c_int, _c_ll, _c_int, _c_int, _c_int, _c_int, _c_void_p,
    ]),
    "byz_gram": ("gram", [
        _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int, _c_ll, _c_ll, _c_int, _c_int,
        _c_int, _c_void_p,
    ]),
    "byz_selection_weights": ("selection", [
        _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_void_p,
    ]),
    "byz_weighted_rows": ("selection", [
        _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int, _c_ll, _c_int, _c_void_p,
    ]),
    "byz_selection_mean_from_gram": ("selection", [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_ll, _c_int, _c_int, _c_int, _c_int,
        _c_int, _c_void_p,
    ]),
    "byz_from_gram_scratch_bytes": ("selection", []),
    "byz_nnm_weights": ("nnm", [
        _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_void_p,
    ]),
    "byz_mix_rows": ("nnm", [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_ll, _c_int,
        _c_int, _c_void_p,
    ]),
    "byz_nnm_selection_weights": ("nnm", [
        _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
        _c_void_p,
    ]),
    "byz_clip_selection_weights": ("clip_selection", [
        _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_float, _c_int, _c_int, _c_int,
        _c_int, _c_int, _c_void_p,
    ]),
    "byz_meamed": ("meamed", [
        _c_void_p, _c_void_p, _c_int, _c_int, _c_ll, _c_int, _c_int, _c_int, _c_void_p,
    ]),
    "byz_center_loop": ("center_step", [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
        _c_void_p, _c_int, _c_ll, _c_int, _c_float, _c_float, _c_float, _c_int, _c_int, _c_void_p,
    ]),
    "byz_quantize": ("quantize", [
        _c_void_p, _c_void_p, _c_void_p, _c_ll, _c_ll, _c_int, _c_int, _c_int, _c_int, _c_void_p,
    ]),
    "byz_dequantize": ("quantize", [
        _c_void_p, _c_void_p, _c_void_p, _c_ll, _c_ll, _c_int, _c_ll, _c_int, _c_int, _c_void_p,
    ]),
    "byz_quantize_s4": ("quantize", [
        _c_void_p, _c_void_p, _c_void_p, _c_ll, _c_ll, _c_int, _c_int, _c_int, _c_void_p,
    ]),
    "byz_dequantize_s4": ("quantize", [
        _c_void_p, _c_void_p, _c_void_p, _c_ll, _c_ll, _c_ll, _c_int, _c_ll, _c_int, _c_void_p,
    ]),
    "byz_segment_sum": ("segment_sum", [
        _c_void_p, _c_void_p, _c_void_p, _c_int, _c_void_p, _c_int, _c_int, _c_ll, _c_int,
        _c_void_p,
    ]),
    "byz_segment_sum_dequant": ("segment_sum", [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_void_p, _c_int, _c_int,
        _c_ll, _c_ll, _c_int, _c_int, _c_int, _c_void_p,
    ]),
    "byz_row_sq_dists": ("segment_sum", [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_ll, _c_int, _c_void_p,
    ]),
    "byz_sort_columns": ("sort_columns", [
        _c_void_p, _c_void_p, _c_int, _c_ll, _c_int, _c_void_p,
    ]),
    "byz_segmented_sort_reduce": ("segmented_sort", [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int, _c_ll, _c_int, _c_int,
        _c_int, _c_void_p,
    ]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output of the last build (ptxas register / spill report)
build_log: Dict[str, str] = {}


def find_nvcc() -> Optional[str]:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``; ``None`` if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source that has no library yet; return name -> path.

    Raises ``RuntimeError`` when ``nvcc`` is missing or a compile fails."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the CUDA "
            "kernels of byzpy_tpu_torch cannot be built on this machine"
        )
    out_dir = BUILD_ROOT / source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    procs: List[tuple] = []
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, building all sources on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        paths = build_all()
        for lib_name, path in paths.items():
            cdll = ctypes.CDLL(str(path))
            for fn, (owner, argtypes) in SIGNATURES.items():
                if owner == lib_name:
                    getattr(cdll, fn).argtypes = argtypes
                    getattr(cdll, fn).restype = ctypes.c_int
            _libs[lib_name] = cdll
        return _libs[name]


def function(fn: str):
    """The ctypes function ``fn`` (see :data:`SIGNATURES`)."""
    return getattr(load(SIGNATURES[fn][0]), fn)


def timed_build() -> float:
    """Build (or find) and load every library; return the seconds it took."""
    t0 = time.perf_counter()
    for name in SOURCES:
        load(name)
    return time.perf_counter() - t0


__all__ = ["build_all", "build_log", "find_nvcc", "function", "load", "timed_build"]
