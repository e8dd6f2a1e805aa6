#!/usr/bin/env python3
"""Take B11 and B12, the segment sums of ``byzpy_tpu_torch/csrc/segment_sum.cu``,
apart on one NVIDIA GPU, to see what bounds them.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 chip_segment_sum_ablation.py

It builds the source as it is and variants of it, each into its own library
under ``byzpy_tpu_torch/_build/segment_sum_ablation/``:

* ``column_tail`` (B12): a row's last thread, whose columns do not fill a
  word, reads its codes and scales one column at a time, row after row;
* ``second_scale`` (B12): every thread reads a second scale a row, as the
  threads whose columns cross a scale block do;
* ``convert_decode`` (B12): each code decoded by a conversion
  (``decode_code`` / ``s4_code``'s arithmetic) in place of ``decode_word``;
* ``loads_fma_only`` (B12): the loads and the FMAs, no decode (not the
  function: never checked);
* ``b11_8byte`` / ``b11_16byte`` (B11): 8 or 16 bytes of a row a thread at
  every cohort tile, where the kernel picks by the tile;

and times each with CUDA events (mean of 20 calls) at the shapes the
ragged executor and the serving path give them, beside a streaming copy of
the rows read (``y.copy_(x)``) and, for B11, ``w @ x``. Every variant but
``loads_fma_only`` is checked bit for bit against the kernel's plain
version. The scales are given one column of padding, so that
``second_scale`` never reads past them. One JSON object a line; the card's
name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

_DECODE = "decode_word<CODE>(join_code_word(lo, hi, sh), v);"
# (anchor in segment_sum.cu, replacement) for each variant
VARIANTS = {
    "kernel": [],
    "column_tail": [("    if (by_word) {\n      if (two)", "    if (by_word && nv == V) {\n      if (two)")],
    "second_scale": [("      if (two)\n        sum_rows_by_word<CODE, CT, V, U, true>",
                      "      if (true)\n        sum_rows_by_word<CODE, CT, V, U, true>")],
    "convert_decode": [(_DECODE, """{
    const unsigned int wd = join_code_word(lo, hi, sh);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if constexpr (CODE == kS4) {
        v[k] = (float)(int)((wd >> (4 * k)) & 0xFu) - 8.0f;
      } else {
        v[k] = decode_code<CODE>((uint8_t)(wd >> (8 * k)));
      }
    }
  }""")],
    "loads_fma_only": [(_DECODE, """{
    const unsigned int wd = join_code_word(lo, hi, sh);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __uint_as_float(((wd >> k) & 0x007FFFFFu) | 0x3F800000u);
  }""")],
    "b11_8byte": [("  return (CT <= 2 || (sizeof(T) == 2 && CT <= 4) ? 16 : 8) / (int)sizeof(T);",
                   "  return 8 / (int)sizeof(T);")],
    "b11_16byte": [("  return (CT <= 2 || (sizeof(T) == 2 && CT <= 4) ? 16 : 8) / (int)sizeof(T);",
                    "  return 16 / (int)sizeof(T);")],
}
B12_VARIANTS = ("kernel", "column_tail", "second_scale", "convert_decode", "loads_fma_only")
B11_VARIANTS = ("kernel", "b11_8byte", "b11_16byte")
UNCHECKED = ("loads_fma_only",)
# B12: (R, d, C, wire modes); block 256
B12_CASES = [(128, 421_642, 4, ("int8", "fp8", "s4")), (128, 421_642, 1, ("int8", "s4")),
             (64, 1_048_576, 1, ("int8", "s4"))]
# B11: (R, d, C, dtype)
B11_CASES = [(64, 421_642, 1, "float32"), (64, 1_048_576, 1, "float32"),
             (128, 421_642, 4, "float32"), (128, 421_642, 4, "bfloat16")]
BLOCK = 256


def build(nvcc: str, flags, out_dir: str) -> dict:
    """Every variant's library, built in parallel; name -> ctypes CDLL."""
    from byzpy_tpu_torch.ops import _build

    csrc = os.path.join(HERE, "byzpy_tpu_torch", "csrc")
    base = open(os.path.join(csrc, "segment_sum.cu")).read()
    procs = {}
    for name, patches in VARIANTS.items():
        src = base
        for anchor, repl in patches:
            if anchor not in src:
                raise SystemExit(f"segment_sum.cu no longer holds {anchor!r}: update VARIANTS")
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
        for fn in ("byz_segment_sum", "byz_segment_sum_dequant"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn][1]
            getattr(lib, fn).restype = ctypes.c_int
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_segment_sum_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    from byzpy_tpu_torch.ops import _build, kernels
    from byzpy_tpu_torch.ops import codec_kernels as ck
    from byzpy_tpu_torch.parallel import CommPrecision, encode_blockwise

    nvcc = _build.find_nvcc()
    if nvcc is None:
        print("chip_segment_sum_ablation: nvcc not found", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    out_dir = str(_build.BUILD_ROOT / "segment_sum_ablation")
    os.makedirs(out_dir, exist_ok=True)
    libs = build(nvcc, _build.NVCC_FLAGS, out_dir)
    stream = torch.cuda.current_stream().cuda_stream

    for R, d, C, modes in B12_CASES:
        gen = torch.Generator(device="cuda").manual_seed(R + C)
        x = torch.randn((R, d), generator=gen, device="cuda") * 3.0
        w = torch.randn((C, R), generator=gen, device="cuda")
        out = torch.empty((C, d), device="cuda")
        for mode in modes:
            enc = encode_blockwise(x, CommPrecision(mode, block=BLOCK))
            codes = ck.from_wire(enc.values if mode in ("int8", "s4") else enc.values.view(torch.uint8),
                                 mode).contiguous()
            nb = enc.scales.shape[1]
            padded = torch.zeros((R, nb + 1), device="cuda")
            padded[:, :nb] = enc.scales
            ref = kernels.segment_sum_dequant_plain(codes, enc.scales, w, mode=mode, block=BLOCK, d=d)

            def run(lib):
                rc = lib.byz_segment_sum_dequant(
                    codes.data_ptr(), padded.data_ptr(), w.data_ptr(), None, None, R, out.data_ptr(),
                    C, R, d, codes.shape[1], nb + 1, BLOCK, ck.WIRE_CODES[mode], stream)
                if rc:
                    raise RuntimeError(f"byz_segment_sum_dequant returned {rc}")

            row = {"kernel": "B12", "mode": mode, "shape": [C, R, d], "block": BLOCK,
                   "bound_ms": (codes.numel() + R * nb * 4 + C * R * 4 + C * d * 4) / 3.35e9}
            for name in B12_VARIANTS:
                run(libs[name])
                torch.cuda.synchronize()
                if name not in UNCHECKED and not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
                    raise SystemExit(f"B12 {name} differs from the plain version at {mode} {row['shape']}")
                row[f"{name}_ms"] = cuda_time_ms(lambda lib=libs[name]: run(lib))
            y = torch.empty_like(codes)
            row["copy_ms"] = cuda_time_ms(lambda: y.copy_(codes))
            print(json.dumps(row), flush=True)
            del enc, codes, padded, ref, y
        del x, w, out
        torch.cuda.empty_cache()

    for R, d, C, dtype in B11_CASES:
        gen = torch.Generator(device="cuda").manual_seed(R + C + 1)
        x = torch.randn((R, d), generator=gen, device="cuda").to(getattr(torch, dtype))
        w = torch.randn((C, R), generator=gen, device="cuda")
        out = torch.empty((C, d), dtype=x.dtype, device="cuda")
        ref = kernels.segment_sum_plain(x, w)

        def run(lib):
            rc = lib.byz_segment_sum(x.data_ptr(), w.data_ptr(), None, R, out.data_ptr(), C, R, d,
                                     kernels._DTYPE_CODES[x.dtype], stream)
            if rc:
                raise RuntimeError(f"byz_segment_sum returned {rc}")

        ints = torch.int32 if x.element_size() == 4 else torch.int16
        row = {"kernel": "B11", "dtype": dtype, "shape": [C, R, d],
               "bound_ms": (x.numel() * x.element_size() + C * R * 4 + C * d * x.element_size()) / 3.35e9}
        for name in B11_VARIANTS:
            run(libs[name])
            torch.cuda.synchronize()
            if not torch.equal(out.view(ints), ref.view(ints)):
                raise SystemExit(f"B11 {name} differs from the plain version at {dtype} {row['shape']}")
            row[f"{name}_ms"] = cuda_time_ms(lambda lib=libs[name]: run(lib))
        y = torch.empty_like(x)
        row["copy_ms"] = cuda_time_ms(lambda: y.copy_(x))
        row["library_ms"] = cuda_time_ms(lambda: w @ x) if dtype == "float32" else None
        print(json.dumps(row), flush=True)
        del x, w, out, ref, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
