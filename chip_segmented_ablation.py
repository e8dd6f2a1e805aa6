#!/usr/bin/env python3
"""Take the column-sort kernels apart on one NVIDIA GPU, to see what bounds
them: the segmented sort-reduce (``byzpy_tpu_torch/csrc/segmented_sort.cu``)
and B1 (``csrc/sorted_reduce.cu``), both instances of the engine in
``csrc/column_sort.cuh``.

Run from the repository root on a machine with a card and ``nvcc``:

    python3 chip_segmented_ablation.py [--before DIR]

It builds each kernel as it is and variants of the same sources (text
patches of the engine or of a kernel's file), each into its own library
under ``byzpy_tpu_torch/_build/segmented_ablation/``:

* ``loads_only``: the slot's rows are staged through the ring and one value
  a column is reduced, no sort;
* ``compute_only``: the sort and the reduce on whatever shared memory
  holds, no copy (the producer still signals each step);
* ``release_after_sort``: a consumer releases the stage after its sort,
  not once its keys are in registers (no overlap within a block);
* ``one_buffer``: one stage buffer (34 KB: four blocks an SM instead of
  three; a small slot's ring half as deep, a 64-row slot's one step);
* ``depth_2``: two steps in flight at most, whatever the slot's width;
* ``min_blocks_3``: registers for three blocks an SM (128 a thread) in
  place of four (96);
* ``runs_inline``: the run sort of slots above 64 rows inlined;
* ``waves_2`` / ``waves_4``: the kernel as it is, a slot's runs two / four
  times as many (``kernels.column_runs`` as if the card had 2x / 4x its
  SMs);
* ``slots_interleaved``: the grid (slot, run) in place of (run, slot), so
  that the card dispatches every slot's blocks side by side;
* ``launch_only``: every block returns at once (the grid's launch and
  dispatch with the ring's shared memory, nothing else);
* ``depth_1``: a ring of one step (a step's copy starts once the step
  before it is in registers);
* ``protocol_only``: neither copy nor sort: the ring's waits, releases
  and stores alone (a narrow slot's);
* ``init_only``: every block returns once its mbarriers are set up (the
  launch, the mbarriers' init and fence, one block barrier);
* ``cta_init_fence``: the mbarriers' init made visible to the bulk copies
  with a CTA-scope proxy fence in place of the cluster-scope init fence;
* ``one_buffer_waves_2``: ``one_buffer`` at runs half as long (a slot of
  at most 8 f32 rows keeps its ring depth in one buffer, and six blocks
  fit an SM);

and, with ``--before DIR`` (a ``csrc`` directory of an older tree, whose C
entry points take the same arguments, or those without the run length),
that tree's two kernels as ``before``. B1's variants are built for f32 only. It times each with CUDA
events (and B1 also with torch.profiler's device time, since a main-path
call is shorter than a launch gap) on f32 rows:

* segmented: the ragged executor's batch (cohorts of 6, 13, 29 and 64 rows
  and a padding slot in 128 x 421,642), four cohorts of 32 in 128 x
  421,642, one cohort of 64 in 64 x 1,048,576 and one of 128 in 128 x
  421,642;
* B1: 64 x 1,048,576 (the headline), 8 x 421,642 (the main path) and 128 x
  421,642;

beside a copy of the rows (``y.copy_(x)``) and a column sum of them
(``x.sum(0)``), each a streaming pass. Every variant that computes the
result is checked bit for bit against the plain version. One JSON object a
line; the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "byzpy_tpu_torch", "csrc")
HDR, SEG, B1 = "column_sort.cuh", "segmented_sort.cu", "sorted_reduce.cu"
NARROW = """      batcher_sort<N>(k);
      Red red = red0;
      red.take(k, 0);"""
NARROW_LOADS = """      int32_t one[1] = {k[0] ^ k[N - 1]};
      Red red = red0;
      red.take(one, 0);"""
RELEASE = """    consume_release(ring, j, steps);\n    const long long c = c0 + (long long)j * kTile + tid;"""
NO_COPIES = [(HDR, "      total += (sh + bytes + 15u) & ~15u;", "      total += 0 * sh;"),
             (HDR, "      bulk_copy(ring.stage(j) + r * RS, src - sh, (sh + bytes + 15u) & ~15u, ring.full(j));\n",
              "")]
# (file, anchor, replacement) for each variant; a variant applies to both
# kernels unless it names only one's file (an anchor in a file the kernel
# does not build from must still be found in one of the two)
VARIANTS = {
    "kernel": [],
    "loads_only": [(HDR, NARROW, NARROW_LOADS),
                   (HDR, "    sort_runs<K, RS>(base, tile, m);\n", ""),
                   (HDR, "      merge_wide<K, RS / (int)sizeof(E)>(tile + tid, m, red);",
                    "      int32_t k[1] = {K::key(tile[tid]) ^ K::key(tile[(m - 1) * (RS / (int)sizeof(E)) + tid])};\n"
                    "      red.take(k, 0);")],
    "compute_only": NO_COPIES,
    "release_after_sort": [(HDR, RELEASE, "    const long long c = c0 + (long long)j * kTile + tid;"),
                           (HDR, "      out[c] = red.value();\n    }\n  }\n}\n",
                            "      out[c] = red.value();\n    }\n    consume_release(ring, j, steps);\n  }\n}\n")],
    "one_buffer": [(HDR, "constexpr int kStages = 2;", "constexpr int kStages = 1;")],
    "one_buffer_waves_2": [(HDR, "constexpr int kStages = 2;", "constexpr int kStages = 1;")],
    "depth_2": [(HDR, "constexpr int kMaxDepth = 8;", "constexpr int kMaxDepth = 2;")],
    "min_blocks_3": [(HDR, "constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 3;")],
    "runs_inline": [(HDR, "__device__ __noinline__ void sort_runs(", "__device__ __forceinline__ void sort_runs(")],
    "slots_interleaved": [(HDR, "  c0 = (long long)blockIdx.x * run_tiles * kTile;",
                           "  c0 = (long long)blockIdx.y * run_tiles * kTile;"),
                          (HDR, "KERNEL<<<dim3((unsigned)runs, (unsigned)slots)",
                           "KERNEL<<<dim3((unsigned)slots, (unsigned)runs)"),
                          (SEG, "  const int c = blockIdx.y;", "  const int c = blockIdx.x;"),
                          (B1, "  const long long k = blockIdx.y;", "  const long long k = blockIdx.x;")],
    "launch_only": [(HDR, "  run_columns(d, run_tiles, c0, c1);\n  if (threadIdx.x == 0) {",
                     "  run_columns(d, run_tiles, c0, c1);\n  if (run_tiles > 0) return;\n  if (threadIdx.x == 0) {")],
    "depth_1": [(HDR, "constexpr int kMaxDepth = 8;", "constexpr int kMaxDepth = 1;")],
    "protocol_only": NO_COPIES + [(HDR, NARROW, NARROW_LOADS)],
    "init_only": [(HDR, "    mbar_fence_init();\n  }\n  __syncthreads();\n",
                   "    mbar_fence_init();\n  }\n  __syncthreads();\n  if (run_tiles > 0) return;\n")],
    "cta_init_fence": [(HDR, 'asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");',
                        'asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");')],
}
# variants run at other run lengths (SMs x this); those not in VARIANTS
# run the kernel as it is
RUN_WAVES = {"waves_2": 2, "waves_4": 4, "one_buffer_waves_2": 2}
UNCHECKED = ("loads_only", "compute_only", "launch_only", "protocol_only", "init_only")
# B1's ablation builds: f32 only (a third of the instances to compile)
# (anchors of this tree and of an older one's; a missing anchor is skipped)
B1_F32_ONLY = [(B1, "    case kBF16: return launch<__nv_bfloat16>(x, out, K, n, d, mode, f, run_tiles, s);\n", ""),
               (B1, "    case kF16: return launch<__half>(x, out, K, n, d, mode, f, run_tiles, s);\n", ""),
               (B1, "    case kBF16: return launch<__nv_bfloat16>(x, out, K, n, d, mode, f, s);\n", ""),
               (B1, "    case kF16: return launch<__half>(x, out, K, n, d, mode, f, s);\n", "")]
# (label, R, d, cohort sizes, padding slots, modes)
BATCHES = [
    ("n_batch", 128, 421_642, (6, 13, 29, 64), 1, (("trimmed", 2), ("median", 0))),
    ("4x32", 128, 421_642, (32, 32, 32, 32), 0, (("trimmed", 2), ("median", 0))),
    ("headline_64", 64, 1_048_576, (64,), 0, (("trimmed", 8), ("median", 0))),
    ("one_128", 128, 421_642, (128,), 0, (("trimmed", 8),)),
]
# (label, n, d, modes) of B1's single round
ROUNDS = [
    ("b1_headline", 64, 1_048_576, (("median", 0), ("trimmed", 8))),
    ("b1_main_path", 8, 421_642, (("median", 0), ("trimmed", 2))),
    ("b1_128", 128, 421_642, (("median", 0), ("trimmed", 42))),
]


def sources(name: str, before: str | None) -> dict:
    """The variant's patched file texts, by file name (both kernels' files
    and the engine)."""
    src_dir = before if name == "before" else CSRC
    texts = {}
    for fn in os.listdir(src_dir):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(src_dir, fn)) as fh:
                texts[fn] = fh.read()
    for fn, anchor, repl in VARIANTS.get(name, []):
        if anchor not in texts.get(fn, ""):
            raise SystemExit(f"{fn} no longer holds {anchor!r}: update VARIANTS[{name!r}]")
        texts[fn] = texts[fn].replace(anchor, repl)
    return texts


def build(nvcc: str, flags, out_dir: str, before: str | None) -> dict:
    """Every variant's two libraries, built in parallel; (variant, kernel)
    -> (ctypes function, whether it takes the run length, SMs factor of
    the run rule). A variant that patches only one kernel's file is built
    for that kernel alone; a RUN_WAVES variant calls the kernel's own."""
    from byzpy_tpu_torch.ops import _build

    names = list(VARIANTS) + (["before"] if before else [])
    takes_runs = {}
    procs = {}
    for name in names:
        vdir = os.path.join(out_dir, name)
        shutil.rmtree(vdir, ignore_errors=True)
        os.makedirs(vdir)
        texts = sources(name, before)
        files = {fn for fn, _, _ in VARIANTS.get(name, [])}
        for kern, src in (("segmented", SEG), ("b1", B1)):
            if files and HDR not in files and src not in files:
                continue
            text = texts[src]
            if kern == "b1":
                for _, anchor, repl in B1_F32_ONLY:
                    text = text.replace(anchor, repl)
            with open(os.path.join(vdir, src), "w") as fh:
                fh.write(text)
            takes_runs[(name, kern)] = "int run_tiles, void* stream" in text
            for fn, t in texts.items():
                if fn.endswith(".cuh"):
                    with open(os.path.join(vdir, fn), "w") as fh:
                        fh.write(t)
            lib = os.path.join(vdir, f"lib{kern}.so")
            cmd = [nvcc, *flags, "-o", lib, os.path.join(vdir, src)]
            procs[(name, kern)] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (name, kern), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} {kern}:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        print(json.dumps({"variant": name, "kernel": kern, "ptxas": regs}), flush=True)
        entry = "byz_segmented_sort_reduce" if kern == "segmented" else "byz_sorted_reduce"
        fn = getattr(ctypes.CDLL(lib), entry)
        argtypes = list(_build.SIGNATURES[entry][1])
        if not takes_runs[(name, kern)]:
            del argtypes[-2]  # an older entry point: no run length before the stream
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[(name, kern)] = (fn, takes_runs[(name, kern)], RUN_WAVES.get(name, 1))
    for name, waves in RUN_WAVES.items():
        for kern in ("segmented", "b1"):
            if name not in VARIANTS:
                fns[(name, kern)] = (fns[("kernel", kern)][0], True, waves)
    return fns


def call(entry, d: int, *args) -> None:
    """Call a variant's entry point (``fns``' value) on rows of ``d``
    columns, ``args`` up to the dtype; raise on a refused launch."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    fn, takes_runs, waves = entry
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    runs = (kernels.column_runs(d, sms * waves)[0],) if takes_runs else ()
    rc = fn(*args, *runs, stream)
    if rc:
        raise RuntimeError(f"{fn.__name__} returned {rc}")


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


def device_ms(fn, kernel: str, calls: int = 20) -> float | None:
    """Device time a launch of ``kernel`` (torch.profiler), or None when the
    profile recorded none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = count = 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and kernel in ev.key:
            us += getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0.0)
            count += ev.count
    return us / 1e3 / count if count else None


def bits_equal(a, b) -> bool:
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def segmented_rows(fns) -> None:
    import torch

    from byzpy_tpu_torch.ops import kernels

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
                call(fn, d, x.data_ptr(), offsets.data_ptr(), lengths.data_ptr(), out.data_ptr(), R, C,
                     d, code, f)

            ref = kernels.segmented_sort_reduce_plain(x, offsets, lengths, mode=mode, f=f)
            row = {"kernel": "segmented", "batch": label, "shape": [R, d], "cohorts": list(sizes),
                   "mode": mode, "f": f, "bytes_bound_ms": (fill + C) * d * 4 / 3.35e9}
            for (name, kern), fn in fns.items():
                if kern != "segmented":
                    continue
                run(fn)
                torch.cuda.synchronize()
                if name not in UNCHECKED and not bits_equal(out, ref):
                    raise SystemExit(f"{name} differs from the plain version at {label} {mode}")
                row[f"{name}_ms"] = cuda_time_ms(lambda fn=fn: run(fn))
            rows = x[:fill]
            y = torch.empty_like(rows)
            row["copy_ms"] = cuda_time_ms(lambda: y.copy_(rows))
            row["colsum_ms"] = cuda_time_ms(lambda: rows.sum(0))
            print(json.dumps(row), flush=True)
            del ref, y
        del x, out
        torch.cuda.empty_cache()


def b1_rows(fns) -> None:
    import torch

    from byzpy_tpu_torch.ops import kernels

    for label, n, d, modes in ROUNDS:
        gen = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn((1, n, d), generator=gen, device="cuda")
        out = torch.empty((1, d), device="cuda")
        for mode, f in modes:
            code = {"median": 0, "trimmed": 1}[mode]

            def run(fn):
                call(fn, d, x.data_ptr(), out.data_ptr(), 1, n, d, code, f, 0)

            ref = kernels.sorted_reduce_stream_plain(x, mode=mode, f=f)
            row = {"kernel": "b1", "batch": label, "shape": [1, n, d], "mode": mode, "f": f,
                   "bytes_bound_ms": (n + 1) * d * 4 / 3.35e9}
            for (name, kern), fn in fns.items():
                if kern != "b1":
                    continue
                run(fn)
                torch.cuda.synchronize()
                if name not in UNCHECKED and not bits_equal(out, ref):
                    raise SystemExit(f"B1 {name} differs from the plain version at {label} {mode}")
                row[f"{name}_ms"] = cuda_time_ms(lambda fn=fn: run(fn))
                row[f"{name}_device_ms"] = device_ms(lambda fn=fn: run(fn), "sorted_reduce_kernel")
            rows = x[0]
            y = torch.empty_like(rows)
            row["copy_ms"] = cuda_time_ms(lambda: y.copy_(rows))
            row["colsum_ms"] = cuda_time_ms(lambda: rows.sum(0))
            print(json.dumps(row), flush=True)
            del ref, y
        del x, out
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--before", help="csrc directory of an older tree, built as 'before'")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_segmented_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from byzpy_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    if nvcc is None:
        print("chip_segmented_ablation: nvcc not found", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    out_dir = str(_build.BUILD_ROOT / "segmented_ablation")
    os.makedirs(out_dir, exist_ok=True)
    fns = build(nvcc, _build.NVCC_FLAGS, out_dir, args.before and os.path.abspath(args.before))
    segmented_rows(fns)
    b1_rows(fns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
