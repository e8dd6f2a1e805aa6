#!/usr/bin/env python3
"""Take B8's mixing sweep (``byzpy_tpu_torch/csrc/nnm.cu``, ``mix_rows_kernel``)
apart on one NVIDIA GPU, to see what bounds it.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 chip_mix_ablation.py

It builds the sweep as it is and four variants of the same source, each
into its own library under ``byzpy_tpu_torch/_build/ablation/``:

* ``wide``: 8 x 8 register micro-tiles (16 x 4 at n = 128), 3 ring stages,
  one block a SM;
* ``copies_only``: the tiles are copied and the outputs stored, no adds;
* ``adds_only``: the adds and the stores, no copies after the first tiles;
* ``no_division``: the outputs scaled by a multiply instead of ``__fdiv_rn``.

and times each at 64 x 1,048,576 (f32 and bf16), 8 x 421,642 and 128 x
421,642 (f32) with CUDA events, beside a copy of ``x`` (``y.copy_(x)``),
the library call ``(mask.T @ x) / k`` and a streaming read of the same rows
in 64-row pieces (a small kernel of its own, no shared memory). The sweep
and ``wide`` are checked bit for bit against ``kernels.mix_rows_plain``.
One JSON object a line; the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (anchor in nnm.cu, replacement) for each variant
VARIANTS = {
    "sweep": [],
    "wide": [("static constexpr int C = 32 / I;", "static constexpr int C = 64 / I;"),
             ("constexpr int kMixStages = 2;", "constexpr int kMixStages = 3;"),
             ("constexpr int kMixBlocksPerSm = 3;", "constexpr int kMixBlocksPerSm = 1;")],
    # the outputs start at 1.0, so the division by k stays on its fast path
    "copies_only": [("const int groups = (n + 7) >> 3;", "const int groups = 0;"),
                    ("acc[ii][c] = 0.0f;", "acc[ii][c] = 1.0f;")],
    # every tile sums ring buffer 0, which holds the block's first tile
    "adds_only": [("if (tn < total_tiles) stage_tile", "if (false) stage_tile"),
                  ("const T* tile = ring + buf * NPAD * TW + col_off;",
                   "const T* tile = ring + col_off;")],
    # a multiply in place of the IEEE division (other bits: not checked)
    "no_division": [("__fdiv_rn(acc[ii][c], kf)", "acc[ii][c] * kf")],
}
CHECKED = ("sweep", "wide")
SHAPES = [(64, 1_048_576, "float32"), (64, 1_048_576, "bfloat16"), (8, 421_642, "float32"),
          (128, 421_642, "float32"), (8, 421_640, "float32")]

# a streaming read of an (n, d) f32 matrix in tiles of n rows x 512 bytes,
# one block a tile, rows walked in order by each thread's 16-byte loads
STREAM_SRC = r"""
#include <cuda_runtime.h>
__global__ void stream_rows(const float* x, unsigned* out, int n, long long d) {
  const long long c0 = (long long)blockIdx.x * 128;
  unsigned h = 0;
  for (int e = threadIdx.x; e < n * 32; e += blockDim.x) {
    const long long col = c0 + (e % 32) * 4;
    if (col + 3 < d) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + (long long)(e / 32) * d + col));
      h ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (h == 0x12345678u) out[blockIdx.x] = h;
}
extern "C" int byz_stream_rows(const void* x, void* out, int n, long long d, void* stream) {
  stream_rows<<<(unsigned)((d + 127) / 128), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<unsigned*>(out), n, d);
  return cudaGetLastError();
}
"""


def build(nvcc: str, flags, out_dir: str) -> dict:
    """Every variant's library (and the streaming read's), built in
    parallel; name -> ctypes function."""
    from byzpy_tpu_torch.ops import _build

    base = open(os.path.join(HERE, "byzpy_tpu_torch", "csrc", "nnm.cu")).read()
    csrc = os.path.join(HERE, "byzpy_tpu_torch", "csrc")
    procs = {}
    for name, patches in list(VARIANTS.items()) + [("stream", None)]:
        src = STREAM_SRC if patches is None else base
        for anchor, repl in patches or ():
            if anchor not in src:
                raise SystemExit(f"nnm.cu no longer holds {anchor!r}: update VARIANTS")
            src = src.replace(anchor, repl)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        cmd = [nvcc, *flags, "-I", csrc, "-o", os.path.join(out_dir, f"lib{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        if name == "stream":
            fn = lib.byz_stream_rows
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_void_p]
        else:
            fn = lib.byz_mix_rows
            fn.argtypes = _build.SIGNATURES["byz_mix_rows"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_mix_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from byzpy_tpu_torch.ops import _build, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    nvcc = _build.find_nvcc()
    if nvcc is None:
        print("chip_mix_ablation: nvcc not found", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    out_dir = str(_build.BUILD_ROOT / "ablation")
    os.makedirs(out_dir, exist_ok=True)
    fns = build(nvcc, _build.NVCC_FLAGS, out_dir)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    scratch = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    for n, d, dt in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn((1, n, d), generator=gen, device="cuda").to(getattr(torch, dt))
        k = n - n // 8
        mask, st = kernels.nnm_weights(kernels.gram(x), k=k)
        ref = kernels.mix_rows_plain(x, mask, st, k=k)
        ints = torch.int32 if x.element_size() == 4 else torch.int16

        def run(fn, out):
            rc = fn(x.data_ptr(), mask.data_ptr(), st.data_ptr(), out.data_ptr(), 1, n, k, d,
                    4 * sms, kernels._DTYPE_CODES[x.dtype], stream)
            if rc:
                raise RuntimeError(f"byz_mix_rows returned {rc}")

        row = {"shape": [n, d], "dtype": dt, "bound_ms": 2 * n * d * x.element_size() / 3.35e9}
        out = torch.empty_like(x)
        for name in VARIANTS:
            run(fns[name], out)
            torch.cuda.synchronize()
            if name in CHECKED and not torch.equal(out.view(ints), ref.view(ints)):
                raise SystemExit(f"{name} differs from mix_rows_plain at {(n, d, dt)}")
            row[f"{name}_ms"] = cuda_time_ms(lambda fn=fns[name]: run(fn, out))
        y = torch.empty_like(x)
        row["copy_ms"] = cuda_time_ms(lambda: y.copy_(x))
        m = mask[0].T.to(x.dtype)
        row["library_ms"] = cuda_time_ms(lambda: (m @ x[0]) / k)
        if dt == "float32" and d % 4 == 0:  # its 16-byte loads need 16-byte rows
            row["stream_read_ms"] = cuda_time_ms(
                lambda: fns["stream"](x.data_ptr(), scratch.data_ptr(), n, d, stream))
        print(json.dumps(row), flush=True)
        del x, mask, st, ref, out, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
