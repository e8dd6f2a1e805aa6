#!/usr/bin/env python3
"""Take the segmented sort-reduce (``byzpy_tpu_torch/csrc/segmented_sort.cu``)
apart on one NVIDIA GPU, to see what bounds it.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 chip_segmented_ablation.py

It builds the kernel as it is and variants of the same source, each into
its own library under ``byzpy_tpu_torch/_build/segmented_ablation/``:

* ``loads_only``: the slot's rows are staged and one value a column is
  stored, no sort;
* ``compute_only``: the sort and the reduce on whatever shared memory
  holds, no staging;
* ``runs_inline``: the run sort of cohorts above 64 rows inlined into the
  kernel (ptxas then allocates every path's registers for it);

and times each with CUDA events on ragged batches of f32 rows: the ragged
executor's (cohorts of 6, 13, 29 and 64 rows and a padding slot in 128 x
421,642), four cohorts of 32 in 128 x 421,642, one cohort of 64 in 64 x
1,048,576 and one of 128 in 128 x 421,642, beside a copy of the cohorts'
rows (``y.copy_(x)``) and a column sum of them (``x.sum(0)``), each a
streaming pass. The kernel and ``runs_inline`` are checked bit for bit
against ``kernels.segmented_sort_reduce_plain``. One JSON object a line; the
card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (anchor in segmented_sort.cu, replacement) for each variant
VARIANTS = {
    "kernel": [],
    "loads_only": [("    sort_narrow(tile + tid, m, red);\n    oc[c0 + tid] = from_f32<float>(red.value(m, f));",
                    "    oc[c0 + tid] = __int_as_float(tile[tid] ^ tile[(m - 1) * kThreads + tid]);"),
                   ("    sort_runs(tile, m);\n", ""),
                   ("      merge_wide(tile + tid, m, r);\n      oc[cs + tid] = from_f32<float>(r.value(m, f));",
                    "      oc[cs + tid] = __int_as_float(tile[tid] ^ tile[(m - 1) * (kThreads / 2) + tid]);")],
    "compute_only": [("for (int r = warp; r < m; r += kThreads / 32) {",
                      "for (int r = warp; r < 0; r += kThreads / 32) {")],
    "runs_inline": [("__device__ __noinline__ void sort_runs(",
                     "__device__ __forceinline__ void sort_runs(")],
}
CHECKED = ("kernel", "runs_inline")
# (label, R, d, cohort sizes, padding slots, modes)
BATCHES = [
    ("n_batch", 128, 421_642, (6, 13, 29, 64), 1, (("trimmed", 2), ("median", 0))),
    ("4x32", 128, 421_642, (32, 32, 32, 32), 0, (("trimmed", 2), ("median", 0))),
    ("headline_64", 64, 1_048_576, (64,), 0, (("trimmed", 8), ("median", 0))),
    ("one_128", 128, 421_642, (128,), 0, (("trimmed", 8),)),
]


def build(nvcc: str, flags, out_dir: str) -> dict:
    """Every variant's library, built in parallel; name -> ctypes function."""
    from byzpy_tpu_torch.ops import _build

    csrc = os.path.join(HERE, "byzpy_tpu_torch", "csrc")
    base = open(os.path.join(csrc, "segmented_sort.cu")).read()
    procs = {}
    for name, patches in VARIANTS.items():
        src = base
        for anchor, repl in patches:
            if anchor not in src:
                raise SystemExit(f"segmented_sort.cu no longer holds {anchor!r}: update VARIANTS")
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
        regs = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
        fn = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so")).byz_segmented_sort_reduce
        fn.argtypes = _build.SIGNATURES["byz_segmented_sort_reduce"][1]
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
        print("chip_segmented_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from byzpy_tpu_torch.ops import _build, kernels

    nvcc = _build.find_nvcc()
    if nvcc is None:
        print("chip_segmented_ablation: nvcc not found", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    out_dir = str(_build.BUILD_ROOT / "segmented_ablation")
    os.makedirs(out_dir, exist_ok=True)
    fns = build(nvcc, _build.NVCC_FLAGS, out_dir)
    stream = torch.cuda.current_stream().cuda_stream
    for label, R, d, sizes, pad, modes in BATCHES:
        gen = torch.Generator(device="cuda").manual_seed(R + len(sizes))
        x = torch.randn((R, d), generator=gen, device="cuda")
        offsets = torch.tensor([sum(sizes[:c]) for c in range(len(sizes))] + [sum(sizes)] * pad,
                               dtype=torch.int32, device="cuda")
        lengths = torch.tensor(list(sizes) + [0] * pad, dtype=torch.int32, device="cuda")
        C, fill = len(sizes) + pad, sum(sizes)
        out = torch.empty((C, d), device="cuda")
        for mode, f in modes:
            code = {"median": 0, "trimmed": 1}[mode]

            def run(fn):
                rc = fn(x.data_ptr(), offsets.data_ptr(), lengths.data_ptr(), out.data_ptr(), R, C,
                        d, code, f, stream)
                if rc:
                    raise RuntimeError(f"byz_segmented_sort_reduce returned {rc}")

            ref = kernels.segmented_sort_reduce_plain(x, offsets, lengths, mode=mode, f=f)
            row = {"batch": label, "shape": [R, d], "cohorts": list(sizes), "mode": mode, "f": f,
                   "bound_ms": (fill + C) * d * 4 / 3.35e9}
            for name in VARIANTS:
                run(fns[name])
                torch.cuda.synchronize()
                if name in CHECKED and not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
                    raise SystemExit(f"{name} differs from the plain version at {label} {mode}")
                row[f"{name}_ms"] = cuda_time_ms(lambda fn=fns[name]: run(fn))
            rows = x[:fill]
            y = torch.empty_like(rows)
            row["copy_ms"] = cuda_time_ms(lambda: y.copy_(rows))
            row["colsum_ms"] = cuda_time_ms(lambda: rows.sum(0))
            print(json.dumps(row), flush=True)
            del ref, y
        del x, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
