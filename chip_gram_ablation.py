#!/usr/bin/env python3
"""Take B3, the split-K Gram of ``byzpy_tpu_torch/csrc/gram.cu``, apart on
one NVIDIA GPU, to see what bounds it.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 chip_gram_ablation.py

It builds the source as it is and variants of it, each into its own library
under ``byzpy_tpu_torch/_build/gram_ablation/``:

* ``copies_only``: the partials' ``cp.async`` ring, barriers and stores,
  no FMA (not the function: never checked);
* ``compute_only``: the partials' FMAs on shared memory that no copy
  fills (not the function: never checked);
* ``unswizzled``: every staged row's 16-byte pieces in place, so the rows
  a quarter-warp reads at one column share banks (the same bits: checked);

and times each at the shapes B3 serves (f32; the main path's 8 rows, the
serving and ragged capacity of 64, the executor's 128, the 64 x 1,048,576
headline) with CUDA events (mean of 20 calls) and, per launch, the
partials' and the reduce's device times (torch.profiler), beside one read
of x (``x.sum()``) and ``x @ x.T``. The checked variants must equal
``kernels.gram_split_k_plain`` bit for bit. One JSON object a line; the
card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (anchor in gram.cu, replacement) for each variant
VARIANTS = {
    "kernel": [],
    "copies_only": [("    if (live) {\n      const int nsub", "    if (live && ntiles < 0) {\n      const int nsub")],
    "compute_only": [("  for (int idx = threadIdx.x; idx < n * PPR; idx += GramShape<NPAD>::THREADS) {",
                      "  for (int idx = threadIdx.x; idx < n * PPR && row_bytes < 0;"
                      " idx += GramShape<NPAD>::THREADS) {")],
    "unswizzled": [("__device__ __forceinline__ int swizzle(int r) { return (r ^ (r >> 3)) & 7; }",
                    "__device__ __forceinline__ int swizzle(int r) { return 0; }"),
                   ("(ya ^ ((qq ^ u) << 4))", "(ya ^ (qq << 4))"),
                   ("(yb ^ ((qq ^ v) << 4))", "(yb ^ (qq << 4))")],
}
UNCHECKED = ("copies_only", "compute_only")
SHAPES = [(8, 421_642), (64, 421_642), (128, 421_642), (64, 1_048_576)]


def build(nvcc: str, flags, out_dir: str) -> dict:
    """Every variant's library, built in parallel; name -> ctypes CDLL."""
    from byzpy_tpu_torch.ops import _build

    csrc = os.path.join(HERE, "byzpy_tpu_torch", "csrc")
    base = open(os.path.join(csrc, "gram.cu")).read()
    procs = {}
    for name, patches in VARIANTS.items():
        src = base
        for anchor, repl in patches:
            if anchor not in src:
                raise SystemExit(f"gram.cu no longer holds {anchor!r}: update VARIANTS")
            src = src.replace(anchor, repl)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        cmd = [nvcc, *flags, "-I", csrc, "-o", os.path.join(out_dir, f"lib{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        print(json.dumps({"variant": name, "spills": spills}), flush=True)
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        lib.byz_gram.argtypes = _build.SIGNATURES["byz_gram"][1]
        lib.byz_gram.restype = ctypes.c_int
        libs[name] = lib
    return libs


def cuda_time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 10) -> dict:
    """Device time per launch of the partials and of the reduce."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for part in ("gram_partial_kernel", "gram_reduce_kernel"):
            if part in ev.key and ev.count:
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = getattr(ev, "self_cuda_time_total", 0.0)
                out[part] = out.get(part, 0.0) + us / 1e3 / ev.count
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_gram_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    from byzpy_tpu_torch.ops import _build, kernels

    nvcc = _build.find_nvcc()
    if nvcc is None:
        print("chip_gram_ablation: nvcc not found", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    out_dir = str(_build.BUILD_ROOT / "gram_ablation")
    os.makedirs(out_dir, exist_ok=True)
    libs = build(nvcc, _build.NVCC_FLAGS, out_dir)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    for n, d in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn((1, n, d), generator=gen, device="cuda")
        chunk, nchunks = kernels.gram_chunks(d, 1, sms)
        partial = torch.empty(nchunks * (n * (n + 1) // 2), device="cuda")
        out = torch.empty((1, n, n), device="cuda")
        ref = kernels.gram_split_k_plain(x, chunk)

        def run(lib):
            rc = lib.byz_gram(x.data_ptr(), partial.data_ptr(), out.data_ptr(), 1, n, d, chunk,
                              nchunks, max(16, kernels.network_width(n)), 0, stream)
            if rc:
                raise RuntimeError(f"byz_gram returned {rc}")

        # one read of x; the symmetric half's FMAs (2 flops each)
        row = {"kernel": "B3", "shape": [1, n, d], "chunks": [nchunks, chunk],
               "bytes_ms": n * d * 4 / 3.35e9, "fma_ms": n * (n + 1) * d / 67e9}
        for name, lib in libs.items():
            run(lib)
            torch.cuda.synchronize()
            if name not in UNCHECKED and not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
                raise SystemExit(f"B3 {name} differs from gram_split_k_plain at {row['shape']}")
            row[f"{name}_ms"] = cuda_time_ms(lambda lib=lib: run(lib))
            row[f"{name}_device_ms"] = device_ms(lambda lib=lib: run(lib))
        row["read_x_ms"] = cuda_time_ms(lambda: x.sum())
        row["library_ms"] = cuda_time_ms(lambda: x[0] @ x[0].T)
        print(json.dumps(row), flush=True)
        del x, partial, out, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
