#!/usr/bin/env python3
"""Take B7, the centre-seeking loop kernel of ``byzpy_tpu_torch/csrc/center_step.cu``,
apart on one NVIDIA GPU, to see what bounds it.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 chip_center_ablation.py

It builds the source as it is and variants of it, each into its own library
under ``byzpy_tpu_torch/_build/center_ablation/``:

* ``two_buffers``: a second staging buffer, so that a step's copies fly
  while the block works on the step before (the same bits: checked);
* ``chunk_steps_at_8``: steps of a whole 1024-column chunk at 8 rows and
  below, where the kernel takes 512 (the same bits: checked);
* ``no_min_blocks``: no register caps; ``min_blocks_1``: a cap for one
  block an SM above 16 rows, in place of two (the same bits: checked);
* ``grid_132`` / ``grid_264``: at most 132 / 264 blocks, each walking more
  chunks, for cheaper grid barriers (the same bits: checked);
* ``steps_only``: no pass over x, only each step's two grid barriers, row
  reduce and weights (not the function: never checked);
* ``no_row_reduce`` / ``one_barrier``: ``steps_only`` without the row
  reduce / without the second barrier (never checked);

prints each instance's registers and spill stores (ptxas), and times each
(f32, CUDA events, mean of 10 calls) at the main path's 8 x
421,642, at 64 x 421,642 and at the 64 x 1,048,576 headline, one step and
256 forced steps (clip mode, so that ``steps_only`` runs them all), beside
one read of x (``x.sum()``). The checked variants must equal
``kernels.center_loop_plain`` bit for bit at 10 steps. One JSON object a
line; the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

GRID = "  const int grid = (int)(a.nchunks < fit ? a.nchunks : fit);"
# (anchor in center_step.cu, replacement) for each variant
VARIANTS = {
    "kernel": [],
    "two_buffers": [("constexpr int NBUF = 1;", "constexpr int NBUF = 2;")],
    "chunk_steps_at_8": [("constexpr int KC = NR <= 16 ? 2 : 1;",
                          "constexpr int KC = NR <= 8 ? 4 : (NR <= 16 ? 2 : 1);")],
    "no_min_blocks": [("__launch_bounds__(kThreads, NR <= 16 ? 4 : (NR < 128 ? 2 : 1))",
                       "__launch_bounds__(kThreads)")],
    "min_blocks_1": [("__launch_bounds__(kThreads, NR <= 16 ? 4 : (NR < 128 ? 2 : 1))",
                      "__launch_bounds__(kThreads, NR <= 16 ? 4 : 1)")],
    "grid_132": [(GRID, GRID.replace("fit ? a.nchunks : fit)", "fit ? a.nchunks : fit) < 132 ? "
                                     "(int)(a.nchunks < fit ? a.nchunks : fit) : 132"))],
    "grid_264": [(GRID, GRID.replace("fit ? a.nchunks : fit)", "fit ? a.nchunks : fit) < 264 ? "
                                     "(int)(a.nchunks < fit ? a.nchunks : fit) : 264"))],
    "steps_only": [("  if (nq > 0) stage_tile", "  if (nq > 0 && n < 0) stage_tile"),
                   ("  for (int q = 0; q < nq; ++q) {", "  for (int q = 0; q < nq && n < 0; ++q) {")],
}
UNCHECKED = ("steps_only", "no_row_reduce", "one_barrier")
VARIANTS["no_row_reduce"] = VARIANTS["steps_only"] + [
    ("  for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < rows; r += stride) {",
     "  for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < rows && rows < 0; r += stride) {")]
VARIANTS["one_barrier"] = VARIANTS["steps_only"] + [
    ("    reduce_rows<T>(a, with_step);\n    grid_sync(a.counter);", "    reduce_rows<T>(a, with_step);")]
SHAPES = [(8, 421_642), (64, 421_642), (64, 1_048_576)]


def build(nvcc: str, flags, out_dir: str) -> dict:
    """Every variant's library, built in parallel; name -> ctypes function."""
    import chip_smoke
    from byzpy_tpu_torch.ops import _build

    csrc = os.path.join(HERE, "byzpy_tpu_torch", "csrc")
    base = open(os.path.join(csrc, "center_step.cu")).read()
    procs = {}
    for name, patches in VARIANTS.items():
        src = base
        for anchor, repl in patches:
            if anchor not in src:
                raise SystemExit(f"center_step.cu no longer holds {anchor!r}: update VARIANTS")
            src = src.replace(anchor, repl)  # every occurrence
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
        instances = [[e["kernel"].split("<")[-1].rstrip(">"), e.get("registers"), e["spill_stores"]]
                     for e in chip_smoke.ptxas_report(log, nvcc, ("center_loop_kernel",))]
        print(json.dumps({"variant": name, "dtype_rows_kc_nbuf_registers_spill_stores": instances}),
              flush=True)
        fn = getattr(ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so")), "byz_center_loop")
        fn.argtypes = _build.SIGNATURES["byz_center_loop"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launcher(fn, x, z, c_tau: float, steps: int):
    """A call of ``fn`` as ``kernels.center_loop`` makes it (clip mode),
    its buffers allocated once; returns (call, out, ints)."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    n, d = x.shape
    nchunks = -(-d // kernels._CENTER_CHUNK)
    out = torch.empty_like(z)
    scratch = torch.empty(((n + 1) * nchunks + n + 1,), dtype=torch.float32, device=x.device)
    ints = torch.empty((2,), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(x.data_ptr(), z.data_ptr(), out.data_ptr(), None, None, None, scratch.data_ptr(),
                 ints.data_ptr(), n, d, 1, 1e-12, c_tau, -1.0, steps, 0, stream)
        if err:
            raise RuntimeError(f"byz_center_loop: CUDA error {err}")
    return call, out, ints


def events_ms(call, iters: int = 10) -> float:
    import torch

    call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_center_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from byzpy_tpu_torch.ops import _build, kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    nvcc = _build.find_nvcc()
    out_dir = os.path.join(HERE, "byzpy_tpu_torch", "_build", "center_ablation")
    os.makedirs(out_dir, exist_ok=True)
    fns = build(nvcc, _build.NVCC_FLAGS, out_dir)
    failed = []
    for n, d in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n + d)
        x = torch.randn((n, d), generator=gen, device="cuda")
        x[::3] *= 3.0
        z = kernels.sorted_reduce_stream(x[None], mode="median")[0]
        c_tau = 2.0 * d ** 0.5
        ref, _ = kernels.center_loop_plain(x, z, mode="clip", c_tau=c_tau, max_iter=10)
        row = {"shape": [n, d], "read_x_ms": events_ms(lambda: x.sum())}
        for name, fn in fns.items():
            call10, out10, ints10 = launcher(fn, x, z, c_tau, 10)
            call10()
            torch.cuda.synchronize()
            entry = {}
            if name not in UNCHECKED:
                entry["bitwise"] = (torch.equal(out10.view(torch.int32), ref.view(torch.int32))
                                    and int(ints10[0]) == 10)
                if not entry["bitwise"]:
                    failed.append(f"{name} differs from the plain loop at {(n, d)}")
            one = events_ms(launcher(fn, x, z, c_tau, 1)[0])
            many = events_ms(launcher(fn, x, z, c_tau, 256)[0], iters=3)
            entry.update(one_step_ms=one, steps_256_ms=many, ms_per_step=(many - one) / 255)
            row[name] = entry
        print(json.dumps(row), flush=True)
        del x, z, ref
        torch.cuda.empty_cache()
    for msg in failed:
        print(f"chip_center_ablation: {msg}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
