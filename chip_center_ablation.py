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

``python3 chip_center_ablation.py --masked`` takes the masked modes'
lane-group kernel (``masked_loop_kernel``) apart the same way, into
``byzpy_tpu_torch/_build/center_ablation_masked/``:

* ``no_copy``: the producer warps copy nothing (the consumers' time on
  stale tiles); ``no_consume``: the consumers form no centre and add no
  distance (the copies' time); ``steps_only``: no pass, only a step's two
  grid barriers, row reduce and weights (none of them the function: never
  checked);
* ``bulk_copy``: one ``cp.async.bulk`` a tile row from one producer warp,
  completing on the slot's mbarrier by its bytes, in place of the two
  warps' 16-byte ``cp.async`` pieces (the same bits: checked);
* ``four_producers``: four producer warps in place of two (checked);

each timed (CUDA events, mean of 5 calls) at 1 and 10 forced steps of
``masked_weiszfeld`` (the kernel also ``masked_clip``) on 3 in 4 rows
valid, at 8, 64 and 128 x 421,642 and 64 x 1,048,576 f32 and the latter
in bf16, beside ``x.sum()``; the checked variants bitwise
``kernels.center_loop_plain`` at 3 steps up to 421,642 columns.
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

# the masked modes' variants (--masked)
_COPY = "        if (piece * 16u < sh + bytes) cp_async<16>(dst, src - sh, 16);"
_BULK = """    unsigned total = 0;
    for (int r = lane; r < a.n; r += 32)
      total += (((a16 + (unsigned)r * e16) & 15u) + bytes + 15u) & ~15u;
    for (int o = 16; o >= 1; o /= 2) total += __shfl_xor_sync(0xFFFFFFFFu, total, o);
    if (lane == 0) mbar_expect_tx(ring.full(pos), total);
    __syncwarp();
    for (int r = lane; r < a.n; r += 32) {
      const unsigned sh = (a16 + (unsigned)r * e16) & 15u;
      bulk_copy(smem_addr(ring.slot(pos) + r * ring_row<T>()),
                x + c0 * (long long)sizeof(T) + r * row_bytes - sh, (sh + bytes + 15u) & ~15u,
                ring.full(pos));
    }"""
_PIECES = """    if (ro < kRowsAt) {
      for (int r = ro; r < a.n; r += kRowsAt) {
        const unsigned sh = (a16 + (unsigned)r * e16) & 15u;
        if (piece * 16u < sh + bytes) cp_async<16>(dst, src - sh, 16);
        dst += kRowsAt * ring_row<T>();
        src += kRowsAt * row_bytes;
      }
    }
    cp_async_mbar_arrive(ring.full(pos));"""
MASKED_VARIANTS = {
    "kernel": [],
    "no_copy": [(_COPY, _COPY.replace("bytes) cp_async", "bytes && a.n < 0) cp_async"))],
    "no_consume": [("        if (sweep) {\n          const unsigned char* col",
                    "        if (sweep && a.n < 0) {\n          const unsigned char* col"),
                   ("      if (dist) {\n        for (int j = 0; j < tiles; ++j)",
                    "      if (dist && a.n < 0) {\n        for (int j = 0; j < tiles; ++j)")],
    "steps_only": [("      produce<T>(a, ring, issued, to, per_pass);",
                    "      if (a.n < 0) produce<T>(a, ring, issued, to, per_pass);"),
                   ("      masked_pass<T, NR>(a, ring, seq, zin,", "      if (a.n < 0) masked_pass<T, NR>(a, ring, seq, zin,"),
                   ("      issued = to;", "      issued = a.n < 0 ? to : issued;")],
    "bulk_copy": [(_PIECES, _BULK), ("mbar_init(ring.full(ring.at(s)), 32);", "mbar_init(ring.full(ring.at(s)), 1);"),
                  ("constexpr int kProducers = 2;", "constexpr int kProducers = 1;")],
    "four_producers": [("constexpr int kProducers = 2;", "constexpr int kProducers = 4;")],
}
MASKED_UNCHECKED = ("no_copy", "no_consume", "steps_only")
MASKED_SHAPES = [(8, 421_642, "float32"), (64, 421_642, "float32"), (128, 421_642, "float32"),
                 (64, 1_048_576, "float32"), (64, 1_048_576, "bfloat16")]


def build(nvcc: str, flags, out_dir: str, variants: dict, kernel: str) -> dict:
    """Every variant's library, built in parallel; name -> ctypes function."""
    import chip_smoke
    from byzpy_tpu_torch.ops import _build

    csrc = os.path.join(HERE, "byzpy_tpu_torch", "csrc")
    base = open(os.path.join(csrc, "center_step.cu")).read()
    procs = {}
    for name, patches in variants.items():
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
                     for e in chip_smoke.ptxas_report(log, nvcc, (kernel,))]
        print(json.dumps({"variant": name, "instance_registers_spill_stores": instances}), flush=True)
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
                 ints.data_ptr(), None, n, d, 1, 1e-12, c_tau, -1.0, steps, 0, stream)
        if err:
            raise RuntimeError(f"byz_center_loop: CUDA error {err}")
    return call, out, ints


def masked_launcher(fn, x, z, valid, mode: str, c_tau: float, steps: int):
    """A call of ``fn`` as ``kernels.center_loop`` makes it in a masked
    mode (``steps`` forced), its buffers allocated once; returns (call, out,
    ints)."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    n, d = x.shape
    nchunks = -(-d // kernels._CENTER_CHUNK)
    out = torch.empty_like(z)
    scratch = torch.empty(((n + 1) * nchunks + n + 1 + n * kernels._ROW_LANES + d,),
                          dtype=torch.float32, device=x.device)
    ints = torch.empty((2,), dtype=torch.int32, device=x.device)
    flags = valid.to(torch.uint8)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(x.data_ptr(), z.data_ptr(), out.data_ptr(), None, None, None, scratch.data_ptr(),
                 ints.data_ptr(), flags.data_ptr(), n, d, kernels._CENTER_MODES[mode], 1e-12, c_tau,
                 -1.0, steps, kernels._DTYPE_CODES[x.dtype], stream)
        if err:
            raise RuntimeError(f"byz_center_loop: CUDA error {err}")
    return call, out, ints


def masked_main(fns: dict) -> list:
    """The masked variants' rows (see the module docstring); returns the
    checked variants that differed from the plain loop."""
    import torch

    from byzpy_tpu_torch.ops import kernels, robust

    failed = []
    for n, d, dt in MASKED_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n + d)
        x = (torch.randn((n, d), generator=gen, device="cuda")
             * torch.linspace(0.5, 3.0, n, device="cuda")[:, None]).to(getattr(torch, dt))
        valid = torch.arange(n, device="cuda") % 4 != 3
        z = robust.masked_mean(x, valid)
        c_tau = 1.5 * d ** 0.5
        ref = (kernels.center_loop_plain(x, z, mode="masked_weiszfeld", valid=valid, tol=-1.0,
                                         max_iter=3)[0] if d <= 421_642 else None)
        row = {"shape": [n, d], "dtype": dt, "read_x_ms": events_ms(lambda: x.sum()),
               "bound_10_steps_ms": 10 * x.numel() * x.element_size() / 3.35e9}
        for name, fn in fns.items():
            for mode in (("masked_weiszfeld", "masked_clip") if name == "kernel"
                         else ("masked_weiszfeld",)):
                one = events_ms(masked_launcher(fn, x, z, valid, mode, c_tau, 1)[0], iters=5)
                ten = events_ms(masked_launcher(fn, x, z, valid, mode, c_tau, 10)[0], iters=5)
                entry = {"one_step_ms": one, "steps_10_ms": ten, "ms_per_step": (ten - one) / 9}
                if ref is not None and mode == "masked_weiszfeld" and name not in MASKED_UNCHECKED:
                    call3, out3, _ = masked_launcher(fn, x, z, valid, mode, c_tau, 3)
                    call3()
                    torch.cuda.synchronize()
                    ints = torch.int32 if x.element_size() == 4 else torch.int16
                    entry["bitwise"] = torch.equal(out3.view(ints), ref.view(ints))
                    if not entry["bitwise"]:
                        failed.append(f"{name} differs from the plain loop at {(n, d)} {dt}")
                row[f"{name}:{mode}"] = entry
        print(json.dumps(row), flush=True)
        del x, z, ref
        torch.cuda.empty_cache()
    return failed


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
    if "--masked" in sys.argv[1:]:
        out_dir = os.path.join(HERE, "byzpy_tpu_torch", "_build", "center_ablation_masked")
        os.makedirs(out_dir, exist_ok=True)
        failed = masked_main(build(nvcc, _build.NVCC_FLAGS, out_dir, MASKED_VARIANTS,
                                   "masked_loop_kernel"))
        for msg in failed:
            print(f"chip_center_ablation: {msg}", file=sys.stderr)
        return 1 if failed else 0
    out_dir = os.path.join(HERE, "byzpy_tpu_torch", "_build", "center_ablation")
    os.makedirs(out_dir, exist_ok=True)
    fns = build(nvcc, _build.NVCC_FLAGS, out_dir, VARIANTS, "center_loop_kernel")
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
