#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (byzpy_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. device probe: the card's name and power limit (``nvidia-smi``);
2. kernel build from ``byzpy_tpu_torch/csrc`` with ``nvcc`` (timed), with
   the registers and spills of B3's, B7's, B11/B12's, the column-sort
   engine's, B6's and ``nnm.cu``'s instances (a spill in B3, the engine, B6
   or ``nnm.cu`` fails the run);
3. every kernel (B1 sorted reduce, bit for bit in f32, bf16 and f16 at n =
   1 to 128 on odd d, at the main path's shape and at the headline; B3 Gram, B4 selection mean in its
   krum / cge / monna modes, B5 selection mean from a given Gram, B6
   MeaMed, B7's loop kernel (whole Weiszfeld and centred-clipping loops
   and their one-step phases, bit for bit with the iteration counts), B8
   NNM, B9 NNM ->
   selection mean (its weights also on rows repeated in threes at 64 and
   128 rows, in all three modes), B10 clip / ARC -> selection mean) against its plain
   PyTorch version on the card (B3 also bit for bit its own split-K
   order, ``gram_split_k_plain``, at 8, 64 and 128 x 421,642 and 2 x 13 x
   50,000 in f32, bf16 and f16), at the main path's shapes, at the 64 x
   1,048,576 headline and, for B5-B10, on rows holding NaN and inf (B8's
   mixing sweep also bitwise where rows start off a 16-byte boundary, at
   K = 3, n = 128, d below a tile, in bf16 and f16, and finite under a
   mask that leaves the non-finite rows unselected; B5,
   B6 and B7 also in f32, bf16 and f16; B5 on a B3 Gram and on one folded
   row by row; B6 and B7 also at ByzPy's 64 x 65,536, at n = 128 and 13,
   B6 also at 100 rows of odd d;
   the codecs B13 int8 encode, B15 fp8 e4m3fn / e5m2 encode and B14
   decode bitwise, in f32, bf16 and f16, at block 256 and 100, on rows
   holding NaN, +-inf, zero blocks and a partial last block; B11 segment
   sum, B2 column sort and the row reduction beside B11 bitwise, in f32,
   bf16 and f16, on rows holding NaN and +-inf; B16 s4 encode and B17 s4
   decode bitwise in f32, bf16 and f16 at blocks 32-1024, odd d and d not
   a block multiple, a capacity row decoding to -0.0; B12, the fused-dequant
   segment sum, bitwise on int8, fp8, fp8_e5m2 and s4 wire rows at C = 1, 4
   and 16, with and without staleness row weights and with a device fill;
   the segmented sort-reduce of the ragged sort family bitwise, trimmed
   mean at f = 0, 2, 8 and median, at 128 x 421,642 (cohorts 6, 13, 29, 64
   and a padding slot), 128 x 50,001 (1, 2, 5, 120) and 16 x 37, on finite
   rows and on rows holding NaN and +-inf);
4. the main path: the SmallCNN parameter-server round (d = 421,642, 8
   nodes of which 2 sign-flip the honest mean, batch 64) for 5 steps with
   each configuration: coordinate median, trimmed mean (f=2), Multi-Krum
   (f=2, q=4), the pre-aggregated ones (a) static clipping + trimmed mean,
   (b) NNM + coordinate median, (c) NNM + Multi-Krum, (d) clipping +
   Multi-Krum, (e) ARC + Multi-Krum, and MeaMed (f=2), the geometric
   median, centred clipping (M=10), CGE (f=2), MoNNA (f=2) and CAF (f=2)
   (the geometric median and centred clipping exactly one B7 launch a
   step, their host reads per aggregation counted: at most 1 and 0);
   then through the operator classes: Multi-Krum, trimmed mean and CGE
   folded gradient by gradient in a seeded arrival order (the Multi-Krum
   finalize runs B5 and no Gram), ``CoordinateWiseMedian().aggregate`` of
   per-node dictionaries, and the fused NNM + Multi-Krum callable of
   ``fused_pipeline_matrix_fn``; each configuration's kernels must launch
   (and those a fold bypasses must not), its clip must engage at step 1,
   losses stay finite, and the first 2 steps match the same round on the
   CPU; 3 more steps run under torch.profiler for the device's busy share
   and kernel breakdown; the same loop runs the subset-search aggregators
   and the attack classes: (o) MDA (f=2: one B3 a step, its distances the
   one host read of an aggregation) and (p) SMEA (f=2, C(8, 6) = 28
   subsets on the device: one B3 a step, no host read), each subset the
   CPU port's or a printed near tie; the byzantine rows from attack
   classes through ``parallel.adaptive_attack_rows``: (q)
   ``LittleAttack`` with Multi-Krum, (r) ``EmpireAttack(scale=-1.1)`` with
   the trimmed mean, (s) ``InfAttack`` with SMEA (finite aggregate, no
   byzantine row selected) and (t) ``InfluenceAscentAttack`` with the
   trimmed mean, fed each step's aggregate, its submissions equal bit for
   bit to a CPU replay of the card's observations (the CPU run observes
   the card's aggregates); then the compressed wire: the PS
   round with its gradient hop in int8 (trimmed mean), fp8 (Multi-Krum)
   and int8 with error feedback (median), and (l) s4 with error feedback
   (trimmed mean: exactly one B16, one B17 and one B1 a step); then (4b)
   the gossip round on
   the complete graph (trimmed mean, off and int8) and on ring(8, 2)
   (median, int8). A compressed configuration makes exactly its listed
   launches per step, its step-1 encode is checked bitwise, and its CPU
   comparison allows each coordinate the code steps its wire rows may
   flip, carried through the round; then (4c) the serving round: cohorts
   of 6, 8, 13, 29 and 64 clients (buckets 8, 8, 16, 32, 64), every fourth
   client one round stale and every fourth byzantine, padded by
   ``build_cohort`` and stepped by ``build_serving_ps_step`` through the
   masked trimmed mean, median, Multi-Krum, MeaMed, CGE, centred clipping
   and geometric median: exactly their listed launches (B2, B3, B11 and
   the row reduction; never B1, B4, B6 or B7), the padded step bit for bit
   the compacted one, ``CohortAggregator`` the step's aggregate, host
   reads per step counted; then (4d) the ragged door: (m)
   ``build_ragged_serving_ps_step`` on the same cohorts in a flat capacity
   of 64 (trimmed mean and median through the segmented sort-reduce, one
   launch a step, MeaMed through the generic door, Multi-Krum and CGE on
   their own programs), bit for bit the bucketed step, exactly its
   launches and no host read a step; (n) ``RaggedExecutor``: one dispatch
   of four cohorts (6, 13, 29, 64 rows in a capacity of 128) of dense,
   int8, fp8 and s4 client rows (encoded on the card), through Multi-Krum,
   CGE, the trimmed mean and the median (one segmented sort-reduce a
   dispatch), every cohort bit for bit ``CohortAggregator``'s, the dense
   program's on the decoded rows and (s4) the CPU port's;
5. kernel timing at 64 x 1,048,576 f32 (and at the main path's 8 x
   421,642; B1, B6 (f = 40) and B9's weights also at 128 x 421,642, the
   engine's two runs and merge and the weights block's largest tile; B6 and
   B9's weights also by torch.profiler device time)
   beside the card's bound (sort networks at the int32 min/max rate), the
   plain version and, where one exists, a single PyTorch call (B3 also at 64 and 128 x 421,642, its
   partials' and reduce's device times apart; B8's mixing sweep also with its
   torch.profiler device time and in bf16), with a whole Multi-Krum fold round beside
   the barrier Multi-Krum, the codecs at block 256, B2, B11 and the row
   reduction at the headline and at 64 x 421,642, B16 and B17, B12 at 64 x
   1,048,576 (C = 1) and 128 x 421,642 (C = 4) beside the unfused decode +
   B11, and the ragged door's segmented sort beside B2; the segmented
   sort-reduce at the (n) batch, at 4 x 32 rows in 128 and at one cohort
   of 64 in 64 x 1,048,576, beside its plain version, the generic door on
   the same batch and (at the last) B1; B7's loop at 10, 1 and 256
   forced steps beside (steps + 1) reads of x; then the six
   centre-seeking and coordinate aggregators, whole, at ByzPy's grid
   shapes (64 x 65,536); then MDA (30 x 2,048, f = 10) and SMEA (16 x
   4,096, f = 5), whole, at ByzPy's subset-search shapes: host and device
   ms, launches and host reads of a call, the subset against the CPU
   port's, beside ByzPy's direct times (BASELINE.md).

TF32 is off for matmuls and cuDNN convolutions, so f32 stays f32. The
line before the last is a JSON object with every kernel; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet peaks (dense, no sparsity)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12  # non-tensor-core f32
# int32 min and max (the sort networks' compare-exchanges): 64 results per
# clock cycle per SM for compute capability 9.0 (CUDA C++ Programming
# Guide, "Arithmetic Instructions", throughput of "compare, minimum,
# maximum"), half the f32 FMA's 128, on 132 SMs at the H100 SXM's
# 1,980 MHz boost clock (NVIDIA data sheet; nvidia-smi's clocks.max.sm,
# printed in phase 1)
PEAK_INT_MINMAX_PER_S = 64 * 132 * 1.98e9

HEADLINE = (64, 1_048_576)
MAIN_N, MAIN_BYZ, MAIN_BATCH, MAIN_STEPS, CPU_STEPS = 8, 2, 64, 5, 2
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5  # the CPU tests' tolerance for PS steps
# the main path's static clip threshold: SmallCNN's per-node gradient norms
# at step 1 are 10.0-11.9 on the H100 (torch 2.11), so 11.0 clips some rows
# and leaves others; phase 4 fails if it clips none or all
MAIN_TAU = 11.0
# pre-aggregated kernel checks and timings: (f of the pre-aggregator, f, q,
# tau) by n; every third row is scaled x3, so norms sit at ~sqrt(d) and
# ~3 sqrt(d) and tau between them clips a third of the rows
PRE_ARGS = {8: (2, 2, 4, 1000.0), 13: (3, 3, 4, 300.0), 64: (8, 8, 12, 1500.0),
            128: (16, 16, 24, 1500.0)}
# Krum's (f, q) of the selection weights' checks and timings by n: the main
# path's at 8 rows, the headline's at 64, the same shares at 128
SEL_ARGS = {8: (2, 4), 64: (8, 12), 128: (16, 24)}
# centred clipping's threshold on the main path: at step 1 the honest rows
# sit 6.0-8.0 from the row mean and the two byzantine rows 15.0 on the H100
# (torch 2.11); phase 4 fails if the first iteration clips none or all
MAIN_CTAU = 10.0
# ByzPy's grid shape for the whole-aggregator times (benchmarks/full_grid.py)
GRID = (64, 65_536)
# steps of B7's timed loop: centred clipping's M on the main path
LOOP_STEPS = 10


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# helpers on the card
# ---------------------------------------------------------------------------


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back calls, by CUDA
    events. A headline input (268 MB) exceeds the 50 MB L2, so each call
    starts cold; a main-path input (13.5 MB) stays in L2, and there the
    calls are short enough that the host's launch rate sets the time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_rounds(shape, seed: int, *, specials: bool = False, dtype=None):
    """Normal data made on the card from ``seed``; with ``specials``, columns
    holding NaN, +-inf and -0.0, and NaN sprinkled over 1e-4 of the entries."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda")
    if specials:
        x[:, 0, 1] = float("nan")
        x[:, 1, 2] = float("inf")
        x[:, 0, 3] = float("-inf")
        x[:, 0, 4], x[:, 1, 4] = float("inf"), float("-inf")
        x[:, :, 5] = -0.0
        sprinkle = torch.rand(shape, generator=gen, device="cuda") < 1e-4
        x[sprinkle] = float("nan")
    return x if dtype is None else x.to(dtype)


def ulp_diff(a, b) -> int:
    """Largest distance in ulps of ``a``'s dtype (f32, bf16 or f16, normal
    range) over entries finite in both; NaN and +-inf must sit at the same
    places (NaN payloads may differ: the card's f32 -> bf16 conversion has
    its own NaN)."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    fa, fb = a.float(), b.float()
    check(torch.equal(torch.isnan(fa), torch.isnan(fb)), "NaN pattern differs")
    fin = torch.isfinite(fa) & torch.isfinite(fb)
    inf = torch.isinf(fa) | torch.isinf(fb)
    check(torch.equal(fa[inf], fb[inf]), "infinities differ")
    if not bool(fin.any()):
        return 0
    ka = kernels.float_sort_keys(fa[fin].contiguous()).long()
    kb = kernels.float_sort_keys(fb[fin].contiguous()).long()
    shift = {torch.bfloat16: 16, torch.float16: 13}.get(a.dtype, 0)
    return int(((ka - kb).abs() >> shift).max())


def max_abs_err(a, b) -> float:
    import torch

    fa, fb = a.float(), b.float()
    fin = torch.isfinite(fa) & torch.isfinite(fb)
    return float((fa[fin] - fb[fin]).abs().max()) if bool(fin.any()) else 0.0


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_sorted_reduce(errs: dict) -> None:
    """B1 bit for bit its plain version, median and trimmed mean, in f32,
    bf16 and f16, on rows holding NaN and +-inf: at K = 2 rounds of odd d
    (several tiles a block, rows at every alignment) at n on both sides of
    each network width, 65 and 128 rows through the engine's two runs and
    merge; at the main path's 8 x 421,642 and the headline."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    shapes = [(2, n, 100_003) for n in (1, 7, 8, 9, 33, 64, 65, 128)] + [(1, MAIN_N, 421_642), (1, *HEADLINE)]
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            if shape[2] == HEADLINE[1] and dtype != torch.float32:
                continue
            x = random_rounds(shape, seed=shape[1], specials=shape[1] >= 4, dtype=dtype)
            n = shape[1]
            f = 2 if n == MAIN_N else (n - 1) // 3
            for mode, ff in (("median", 0), ("trimmed", f)):
                out = kernels.sorted_reduce_stream(x, mode=mode, f=ff)
                ref = kernels.sorted_reduce_stream_plain(x, mode=mode, f=ff)
                check(bits_equal(out, ref) and nan_is_canonical(out),
                      f"B1 {mode} differs from plain at {shape} {dtype}")
                errs[f"sorted_reduce:{mode}"] = max(errs[f"sorted_reduce:{mode}"], max_abs_err(out, ref))
            log(f"  B1 {tuple(shape)} {str(dtype)[6:]}: median and trimmed (f = {f}) bitwise")
            del x
        torch.cuda.empty_cache()


def check_gram_and_selection(errs: dict) -> None:
    import torch

    from byzpy_tpu_torch.ops import kernels

    cases = [
        ((1, MAIN_N, 421_642), 2, 4, ("krum", "cge", "monna")),
        ((2, 13, 50_000), 3, 5, ("krum", "cge", "monna")),
        ((4,) + HEADLINE, 8, 12, ("krum",)),
        ((1, EXEC_CAP, 421_642), 16, 24, ("krum", "cge", "monna")),
    ]
    for shape, f, q, modes in cases:
        x = random_rounds(shape, seed=100 + shape[1])
        if shape[1] == 13:
            x[1, 4] = float("nan")  # a NaN gradient must rank last, never be selected
        g = kernels.gram(x)
        g_ref = kernels.gram_plain(x)
        norms = torch.linalg.vector_norm(x, dim=2)
        bound = 1e-5 * norms[:, :, None] * norms[:, None, :]
        fin = torch.isfinite(g_ref)
        check(torch.equal(torch.isfinite(g), fin), f"B3 Gram non-finite pattern differs at {shape}")
        excess = float(((g - g_ref)[fin].abs() / bound[fin]).max())
        check(excess <= 1.0, f"B3 Gram off plain at {shape}: {excess:.3g} x the bound")
        check(torch.equal(g.view(torch.int32), kernels.gram(x).view(torch.int32)),
              f"B3 Gram not bit-stable at {shape}")
        errs["gram"] = max(errs["gram"], max_abs_err(g, g_ref))
        if shape[0] == 4:
            # why the plain Gram runs one matmul per round: each f32 Gram
            # against a float64 one
            g64 = torch.stack([xk.double() @ xk.double().T for xk in x])
            batched = torch.matmul(x, x.transpose(1, 2))
            log(f"  B3 Gram at {shape}, max |error| against float64: kernel "
                f"{float((g - g64).abs().max()):.4g}, one f32 matmul per round "
                f"{float((g_ref - g64).abs().max()):.4g}, one batched f32 matmul "
                f"{float((batched - g64).abs().max()):.4g}")
            del g64, batched
        for mode in modes:
            # each B4 launch against its plain version on the same inputs
            w = kernels.selection_weights(g, f=f, q=q, mode=mode, reference_index=1)
            w_plain = kernels.selection_weights_plain(g, f=f, q=q, mode=mode, reference_index=1)
            check(torch.equal(w, w_plain), f"B4 {mode} weights differ from plain at {shape}")
            errs[f"selection_weights:{mode}"] = max(
                errs[f"selection_weights:{mode}"], float((w - w_plain).abs().max()))
            rows = kernels.weighted_rows(x, w)
            rows_ref = kernels.weighted_rows_plain(x, w)
            rows_ulps = ulp_diff(rows, rows_ref)
            check(rows_ulps <= 2, f"B4 row sweep {rows_ulps} ulp from plain at {shape}")
            errs["weighted_rows"] = max(errs["weighted_rows"], max_abs_err(rows, rows_ref))
            # and the whole selection mean against the plain pipeline
            w_ref = kernels.selection_weights_plain(g_ref, f=f, q=q, mode=mode, reference_index=1)
            check(torch.equal(w > 0, w_ref > 0), f"B4 {mode} selects other rows at {shape}")
            if shape[1] == 13:
                check(float(w[1, 4]) == 0.0, f"B4 {mode} selected the NaN row")
            out = kernels.selection_mean_stream(x, f=f, q=q, mode=mode, reference_index=1)
            ulps = ulp_diff(out, kernels.weighted_rows_plain(x, w_ref))
            check(ulps <= 2, f"B4 {mode} aggregate {ulps} ulp from plain at {shape}")
            log(f"  B3+B4 {shape} {mode}: Gram within 1e-5|xi||xj|, weights equal, same rows "
                f"as the plain Gram's, sweep {rows_ulps} ulp, aggregate {ulps} ulp")
        del x, g, g_ref
        torch.cuda.empty_cache()


# B3's bitwise shapes: the main path's, the serving and ragged (m)
# capacity, the executor's, and two rounds with a NaN row
GRAM_ORDER_SHAPES = [((1, MAIN_N, 421_642), False), ((1, 64, 421_642), False),
                     ((1, 128, 421_642), False), ((2, 13, 50_000), True)]


def check_gram_order(errs: dict) -> None:
    """B3 against ``gram_split_k_plain`` at the card's chunking, bit for bit
    (NaN at the same places: the card's NaN payload is its own), in f32,
    bf16 and f16, and the same bits on a second call."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape, nan_row in GRAM_ORDER_SHAPES:
        chunk, nchunks = kernels.gram_chunks(shape[2], shape[0], sms)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            x = random_rounds(shape, seed=200 + shape[1], dtype=dtype)
            if nan_row:
                x[1, 4] = float("nan")
            g = kernels.gram(x)
            ref = kernels.gram_split_k_plain(x, chunk)
            nan = torch.isnan(g)
            check(torch.equal(nan, torch.isnan(ref)),
                  f"B3 NaN pattern differs from its order at {shape} {dtype}")
            check(torch.equal(g[~nan].view(torch.int32), ref[~nan].view(torch.int32)),
                  f"B3 differs from gram_split_k_plain at {shape} {dtype}")
            check(torch.equal(g.view(torch.int32), kernels.gram(x).view(torch.int32)),
                  f"B3 not bit-stable at {shape} {dtype}")
            errs["gram"] = max(errs["gram"], max_abs_err(g, ref))
            log(f"  B3 {shape} {str(dtype)[6:]}: bit for bit gram_split_k_plain ({nchunks} chunks of "
                f"{chunk}), {int(nan.sum())} NaN entries, stable")
            del x, g, ref
        torch.cuda.empty_cache()


def check_selection_from_gram(errs: dict) -> None:
    """B5 (one launch: B4's weights block and the selected rows' sweep on a
    given Gram, no Gram launch) against its plain version and B4's two
    kernels, K = 1, in f32, bf16 and f16, bit for bit: on a Gram from B3
    and on one folded by ``robust.gram_fold_update`` in a seeded arrival
    order (16-bit rows into an f32 Gram), on tie-heavy rows (duplicated and
    zero rows) and on ``random_rounds(specials=True)``'s NaN and inf; then
    the edges of its sweep (``check_from_gram_edges``)."""
    import torch

    from byzpy_tpu_torch.ops import kernels, robust

    cases = [((MAIN_N, 421_642), MAIN_BYZ, 4), ((13, 50_000), 3, 5), (HEADLINE, 8, 12)]
    for (n, d), f, q in cases:
        for name in DTYPES:
            for specials in (False, True):
                x = random_rounds((1, n, d), seed=600 + n, specials=specials,
                                  dtype=getattr(torch, name))[0]
                if not specials:
                    x[5], x[7], x[1], x[3] = x[2], x[2], 0.0, 0.0
                buf = torch.zeros_like(x)
                folded = torch.zeros((n, n), device=x.device)
                order = torch.randperm(n, generator=torch.Generator().manual_seed(n)).tolist()
                for i in order:
                    robust.gram_fold_update(buf, folded, x[i], i)
                check(bits_equal(buf, x), f"B5: the fold staged other rows at {(n, d)} {name}")
                for label, g in (("B3", kernels.gram(x[None])[0]), ("fold", folded)):
                    w = kernels.selection_weights(g[None], f=f, q=q)
                    w_plain = kernels.selection_weights_plain(g[None], f=f, q=q, mode="krum")
                    check(torch.equal(w, w_plain),
                          f"B5 weights differ from plain on the {label} Gram at {(n, d)} {name}")
                    before = dict(kernels.launch_counts)
                    out = kernels.selection_mean_from_gram(x, g, f=f, q=q)
                    moved = {k: v - before[k] for k, v in kernels.launch_counts.items() if v != before[k]}
                    check(moved == {"selection_mean_from_gram:krum": 1},
                          f"B5 launched {moved}, not one selection_mean_from_gram:krum")
                    ref = kernels.weighted_rows_plain(x[None], w_plain)[0]
                    check(bits_equal(out, ref) and nan_is_canonical(out),
                          f"B5 differs from plain on the {label} Gram at {(n, d)} {name}")
                    check(bits_equal(out, kernels.weighted_rows(x[None], w)[0]),
                          f"B5 differs from B4's two kernels on the {label} Gram at {(n, d)} {name}")
                    errs["selection_mean_from_gram:krum"] = max(errs["selection_mean_from_gram:krum"],
                                                                max_abs_err(out, ref))
                    log(f"  B5 {(n, d)} {name} {'specials' if specials else 'ties'} {label} Gram: "
                        f"one launch, bitwise plain and B4's two kernels, rows "
                        f"{(w[0] != 0).nonzero().flatten().tolist()}, {int(torch.isnan(out).sum())} NaN")
                del x, buf, folded
        torch.cuda.empty_cache()
    check_from_gram_edges(errs)


# B5's sweep where its design has edges: d below a 16-byte slot, around
# one, at the main path's d (every other f32 row only 8-byte aligned) and
# the headline's, rows that start an element past an aligned address
FROM_GRAM_EDGES = [(8, 1), (8, 255), (13, 256), (13, 257), (MAIN_N, 421_642), (64, 1_048_576),
                   (128, 4099)]


def check_from_gram_edges(errs: dict) -> None:
    """B5 bit for bit its plain version and B4's two kernels, one launch a
    call, in every mode and dtype at ``FROM_GRAM_EDGES``, on rows viewed at
    element offsets 0 and 1 of a larger buffer, with a NaN row and an inf
    row (ranked last, so taken only where q reaches them: the log counts
    the calls that took one)."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    for n, d in FROM_GRAM_EDGES:
        for name in DTYPES:
            x = random_rounds((1, n, d), seed=620 + n, dtype=getattr(torch, name))[0]
            x[2], x[5], x[3] = x[1], x[1], 0.0
            x[n - 1, ::7] = float("nan")
            x[n // 2] = float("inf")
            g = kernels.gram(x[None])[0]
            for start in (0, 1):
                big = torch.zeros(n * d + start, dtype=x.dtype, device=x.device)
                big[start:] = x.reshape(-1)
                xv = big[start:].view(n, d)
                picked = []
                for mode in ("krum", "cge", "monna"):
                    f = max(0, (n - 3) // 4) if mode == "krum" else 0
                    for q in sorted({max(1, n // 3), n - f}):
                        sel = dict(f=f, q=q, mode=mode, reference_index=(n - 1) // 2)
                        before = kernels.launch_counts[f"selection_mean_from_gram:{mode}"]
                        out = kernels.selection_mean_from_gram(xv, g, **sel)
                        check(kernels.launch_counts[f"selection_mean_from_gram:{mode}"] == before + 1,
                              f"B5 ({mode}) did not count one launch")
                        ref = kernels.selection_mean_from_gram_plain(x, g, **sel)
                        w = kernels.selection_weights(g[None], **sel)
                        check(bits_equal(out, ref) and bits_equal(out, kernels.weighted_rows(x[None], w)[0]),
                              f"B5 ({mode}, q={q}) differs at n={n}, d={d}, {name}, offset {start}")
                        key = f"selection_mean_from_gram:{mode}"
                        if key in errs:
                            errs[key] = max(errs[key], max_abs_err(out, ref))
                        picked.append(int(bool(w[0, n - 1] != 0 or w[0, n // 2] != 0)))
            log(f"  B5 edges n={n} d={d} {name}: bitwise at offsets 0 and 1, every mode, "
                f"non-finite rows taken by mode and q {picked[-6:]}")
            del x, g, big, xv
        torch.cuda.empty_cache()


def pre_rows(shape, seed: int, *, nonfinite: bool = False):
    """Normal rows on the card, every third x3; with ``nonfinite``, round 0
    holds an all-inf row and round 1 a NaN entry (rows 7 and 4)."""
    x = random_rounds(shape, seed=seed)
    x[:, ::3] *= 3.0
    if nonfinite:
        x[0, 7] = float("inf")
        x[-1, 4, 10] = float("nan")
    return x


def bits_equal(a, b) -> bool:
    import torch

    ints = torch.int32 if a.element_size() == 4 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


def nan_is_canonical(t) -> bool:
    """Every NaN of ``t`` is the positive quiet NaN of its dtype, read in
    the dtype's own bits."""
    import torch

    ints, bits = {torch.float32: (torch.int32, 0x7FC00000), torch.bfloat16: (torch.int16, 0x7FC0),
                  torch.float16: (torch.int16, 0x7E00)}[t.dtype]
    return bool((t[torch.isnan(t)].view(ints) == bits).all())


# B8's mixing sweep where its design has edges: rows that start off a
# 16-byte boundary (d = 421,642 and 50,001), K = 3 rounds a block crosses,
# a 16-bit dtype, n = 128, and d below one column tile
MIX_EDGES = [((3, 13, 50_001), "float32"), ((3, MAIN_N, 421_642), "bfloat16"),
             ((2, 64, 50_001), "float16"), ((2, 128, 421_642), "bfloat16"), ((3, 64, 37), "float32")]


def check_mixing_edges(errs: dict) -> None:
    """B8's mixing sweep bitwise against its plain version at ``MIX_EDGES``,
    on rows holding inf and NaN (the selectors of a non-finite row give the
    canonical NaN, the others stay finite), and under a hand-made 0/1 mask
    that leaves a non-finite row unselected: every output stays finite."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    for shape, dt in MIX_EDGES:
        K, n, d = shape
        k = n - n // 4
        x = pre_rows(shape, seed=500 + n, nonfinite=n > 7).to(getattr(torch, dt))
        mask, st = kernels.nnm_weights(kernels.gram(x), k=k)
        mixed, mixed_p = kernels.mix_rows(x, mask, st, k=k), kernels.mix_rows_plain(x, mask, st, k=k)
        check(bits_equal(mixed, mixed_p), f"B8 mixing sweep differs from plain at {shape} {dt}")
        check(bits_equal(kernels.nnm_stream(x, f=n - k), mixed), f"B8 call differs at {shape} {dt}")
        poisoned = st[:, :, None].expand_as(mixed) != 0
        check(nan_is_canonical(mixed) and bool(torch.isnan(mixed[poisoned]).all())
              and bool(torch.isfinite(mixed[~poisoned]).all()),
              f"B8 mixing sweep's non-finite outputs are not the poisoned rows at {shape} {dt}")
        errs["mix_rows"] = max(errs["mix_rows"], max_abs_err(mixed, mixed_p))
        # an arbitrary 0/1 mask: source rows 0 (all inf) and n - 1 (NaN
        # entries) are selected by no output
        gen = torch.Generator(device="cuda").manual_seed(n)
        hand = (torch.rand((K, n, n), generator=gen, device="cuda") < 0.6).float()
        hand[:, 0, :] = 0.0
        hand[:, n - 1, :] = 0.0
        y = pre_rows(shape, seed=600 + n).to(x.dtype)
        y[:, 0] = float("inf")
        y[:, n - 1, ::7] = float("nan")
        zero = torch.zeros((K, n), device="cuda")
        out = kernels.mix_rows(y, hand, zero, k=k)
        check(bits_equal(out, kernels.mix_rows_plain(y, hand, zero, k=k))
              and bool(torch.isfinite(out).all()),
              f"B8 mixing sweep added an unselected non-finite row at {shape} {dt}")
        log(f"  B8 mixing sweep {shape} {dt}: bitwise equal ({int(st.sum())} poisoned mixers), "
            f"finite under a mask that skips the non-finite rows")
        del x, y, mixed, mixed_p, out
    torch.cuda.empty_cache()


# B8's selection state where its block has edges: a lane a column (up to 16
# rows) and 8 lanes a column (32 and up), n at and around each width
NNM_EDGE_N = (1, 2, 3, 7, 8, 9, 31, 33, 64, 100, 127, 128)


def check_nnm_selection_edges(errs: dict) -> None:
    """B8's selection state bit for bit its plain version at ``NNM_EDGE_N``
    rows, K = 1 and 3, k = 1, n - n // 4 and n, on B3's Gram of rows
    repeated in threes with zero rows (ties at the cut), of rows holding an
    inf row and a NaN entry, and on a Gram of small integers that is not
    symmetric; one launch a call."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    for n in NNM_EDGE_N:
        for K in (1, 3):
            x = pre_rows((K, n, 4099), seed=340 + n + K)
            ties = x[:, torch.arange(n, device=x.device) // 3 * 3].clone()
            ties[:, [i for i in (1, 4) if i < n]] = 0.0
            bad = x.clone()
            bad[0, n // 2] = float("inf")
            bad[-1, n - 1, 10] = float("nan")
            gen = torch.Generator(device=x.device).manual_seed(350 + n + K)
            ints = torch.randint(-3, 4, (K, n, n), generator=gen, device=x.device).float()
            ints.diagonal(dim1=1, dim2=2).copy_(torch.randint(6, 9, (K, n), generator=gen, device=x.device))
            tainted = 0
            for label, g in (("ties", kernels.gram(ties)), ("non-finite", kernels.gram(bad)),
                             ("integer", ints)):
                for k in sorted({1, n - n // 4, n}):
                    before = kernels.launch_counts["nnm_weights"]
                    mask, st = kernels.nnm_weights(g, k=k)
                    check(kernels.launch_counts["nnm_weights"] == before + 1, "B8 did not count one launch")
                    mask_p, st_p = kernels.nnm_weights_plain(g, k=k)
                    check(bits_equal(mask, mask_p) and bits_equal(st, st_p),
                          f"B8 selection differs from plain on the {label} Gram at n={n}, K={K}, k={k}")
                    errs["nnm_weights"] = max(errs["nnm_weights"], float((mask - mask_p).abs().max()))
                    tainted += int(st.sum())
            del x, ties, bad, ints
        log(f"  B8 selection state n={n}: bitwise at K = 1 and 3, k in {sorted({1, n - n // 4, n})}, "
            f"ties, non-finite rows ({tainted} tainted mixers) and an integer Gram")
    torch.cuda.empty_cache()


def check_pre_aggregation(errs: dict) -> None:
    """B8, B9, B10-clip and B10-arc against their plain versions: each
    weights launch bitwise on the kernel Gram, each sweep bitwise (B8) or
    within 2 ulp (B9/B10 through B4's sweep), and the whole call selects
    the rows that the plain Gram selects."""
    import torch

    from byzpy_tpu_torch.ops import kernels
    from byzpy_tpu_torch.ops.preagg import arc_cut_off

    check_mixing_edges(errs)
    check_nnm_selection_edges(errs)
    cases = [((1, MAIN_N, 421_642), False), ((1,) + HEADLINE, False), ((2, 13, 50_000), True)]
    for shape, nonfinite in cases:
        n = shape[1]
        f_pre, f, q, tau = PRE_ARGS[n]
        k = n - f_pre
        x = pre_rows(shape, seed=300 + n, nonfinite=nonfinite)
        g, g_ref = kernels.gram(x), kernels.gram_plain(x)
        # B8
        mask, st = kernels.nnm_weights(g, k=k)
        mask_p, st_p = kernels.nnm_weights_plain(g, k=k)
        check(torch.equal(mask, mask_p) and torch.equal(st, st_p), f"B8 selection differs at {shape}")
        errs["nnm_weights"] = max(errs["nnm_weights"], float((mask - mask_p).abs().max()))
        check(torch.equal(mask, kernels.nnm_weights_plain(g_ref, k=k)[0]),
              f"B8 selects other rows than the plain Gram's at {shape}")
        mixed = kernels.mix_rows(x, mask, st, k=k)
        mixed_p = kernels.mix_rows_plain(x, mask, st, k=k)
        check(bits_equal(mixed, mixed_p), f"B8 mixing sweep differs from plain at {shape}")
        check(bits_equal(kernels.nnm_stream(x, f=f_pre), mixed), f"B8 call differs at {shape}")
        errs["mix_rows"] = max(errs["mix_rows"], max_abs_err(mixed, mixed_p))
        log(f"  B8 {shape}: selection equal ({int(st.sum())} mixed rows took a non-finite row), "
            f"mixing bitwise equal")
        del mixed, mixed_p
        # B9, B10-clip, B10-arc: weights on the kernel Gram, then B4's sweep
        sel = dict(f=f, q=q, mode="krum")
        pipelines = {
            "nnm_selection_weights:krum": (
                kernels.nnm_selection_weights, kernels.nnm_selection_weights_plain, dict(k=k),
                lambda: kernels.nnm_selection_mean_stream(x, f_nnm=f_pre, **sel)),
            "clip_selection_weights:clip": (
                kernels.clip_selection_weights, kernels.clip_selection_weights_plain,
                dict(pre="clip", tau=tau), lambda: kernels.clip_selection_mean_stream(x, tau=tau, **sel)),
            "clip_selection_weights:arc": (
                kernels.clip_selection_weights, kernels.clip_selection_weights_plain,
                dict(pre="arc", cut_off=arc_cut_off(n, f_pre)),
                lambda: kernels.arc_selection_mean_stream(x, f_arc=f_pre, **sel)),
        }
        for key, (kernel, plain, kw, whole) in pipelines.items():
            w = kernel(g, **kw, **sel)
            w_plain = plain(g, **kw, **sel)
            check(bits_equal(w, w_plain), f"{key} differs from plain at {shape}")
            check(torch.equal(w != 0, plain(g_ref, **kw, **sel) != 0),
                  f"{key} selects other rows than the plain Gram's at {shape}")
            errs[key] = max(errs[key], max_abs_err(w, w_plain))
            out = whole()
            out_p = kernels.weighted_rows_plain(x, w)
            ulps = ulp_diff(out, out_p)
            check(ulps <= 2 and nan_is_canonical(out), f"{key} aggregate {ulps} ulp from plain at {shape}")
            errs["weighted_rows"] = max(errs["weighted_rows"], max_abs_err(out, out_p))
            nan_rounds = [int(torch.isnan(out[r]).all()) for r in range(shape[0])]
            log(f"  {key} {shape}: weights bitwise, {int((w != 0).sum())} rows weighted, same rows "
                f"as the plain Gram's, aggregate {ulps} ulp, all-NaN rounds {nan_rounds}")
        del x, g, g_ref
        torch.cuda.empty_cache()


def check_b9_ties(errs: dict) -> None:
    """B9's weights where the block-wide design has its edges: rows repeated
    in groups of three (B3's Gram then ties at NNM's cut and in Krum's
    sort), at 64 and 128 rows of the main path's d, in all three modes,
    bitwise against the plain version on the same Gram; the whole call
    within 2 ulp of the plain sweep under the kernel's weights."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    for n in (64, 128):
        f_pre, f, q = n // 8, n // 8, 3 * n // 16
        x = pre_rows((1, n, 421_642), seed=310 + n)
        x = x[:, torch.arange(n, device=x.device) // 3 * 3].contiguous()
        g = kernels.gram(x)
        for mode in ("krum", "cge", "monna"):
            sel = dict(f=f, q=q, mode=mode, reference_index=n // 2)
            w = kernels.nnm_selection_weights(g, k=n - f_pre, **sel)
            w_plain = kernels.nnm_selection_weights_plain(g, k=n - f_pre, **sel)
            check(bits_equal(w, w_plain), f"B9 weights ({mode}) differ from plain on repeated rows at n={n}")
            errs["nnm_selection_weights:krum"] = max(errs["nnm_selection_weights:krum"], max_abs_err(w, w_plain))
            out = kernels.nnm_selection_mean_stream(x, f_nnm=f_pre, **sel)
            ulps = ulp_diff(out, kernels.weighted_rows_plain(x, w))
            check(ulps <= 2, f"B9 aggregate ({mode}) {ulps} ulp from plain on repeated rows at n={n}")
            log(f"  B9 weights ({mode}) on rows repeated in threes, (1, {n}, 421642): bitwise, "
                f"{int((w != 0).sum())} rows weighted, aggregate {ulps} ulp")
        del x, g
        torch.cuda.empty_cache()


def check_selection_ties(errs: dict) -> None:
    """B4's and B10's weights where the block-wide design has its edges,
    bit for bit the plain version on the same Gram, in every mode: K = 3
    rounds of rows repeated in groups of three (ties in Krum's sort, the
    ranks and ARC's threshold) at 8, 64 and 128 rows of the main path's d,
    and a Gram of small integers that is not symmetric; B10 with clip
    (tau a norm of the round: rows at the threshold) and ARC."""
    import torch

    from byzpy_tpu_torch.ops import kernels
    from byzpy_tpu_torch.ops.preagg import arc_cut_off

    for n in (MAIN_N, 64, EXEC_CAP):
        f, q = SEL_ARGS[n]
        x = pre_rows((3, n, 421_642), seed=320 + n)
        x = x[:, torch.arange(n, device=x.device) // 3 * 3].contiguous()
        gen = torch.Generator(device=x.device).manual_seed(330 + n)
        ints = torch.randint(-3, 4, (3, n, n), generator=gen, device=x.device).float()
        ints.diagonal(dim1=1, dim2=2).copy_(torch.randint(6, 9, (3, n), generator=gen, device=x.device))
        for label, g in (("rows repeated in threes", kernels.gram(x)), ("integer, not symmetric", ints)):
            tau = float(torch.sqrt(torch.diagonal(g, dim1=1, dim2=2)).median())
            weighted = []
            for mode in ("krum", "cge", "monna"):
                sel = dict(f=f, q=q, mode=mode) if mode == "krum" else dict(f=0, q=n - f, mode=mode)
                sel["reference_index"] = n // 2
                w = kernels.selection_weights(g, **sel)
                w_plain = kernels.selection_weights_plain(g, **sel)
                check(bits_equal(w, w_plain), f"B4 weights ({mode}) differ from plain on the {label} Gram at n={n}")
                key = f"selection_weights:{mode}"
                errs[key] = max(errs[key], max_abs_err(w, w_plain))
                weighted.append(int((w != 0).sum()))
                for pre, kw in (("clip", dict(tau=tau)), ("arc", dict(cut_off=arc_cut_off(n, f)))):
                    w = kernels.clip_selection_weights(g, pre=pre, **kw, **sel)
                    w_plain = kernels.clip_selection_weights_plain(g, pre=pre, **kw, **sel)
                    check(bits_equal(w, w_plain),
                          f"B10 {pre} weights ({mode}) differ from plain on the {label} Gram at n={n}")
                    key = f"clip_selection_weights:{pre}"
                    errs[key] = max(errs[key], max_abs_err(w, w_plain))
                    weighted.append(int((w != 0).sum()))
            log(f"  B4 and B10 weights on the {label} Gram, K = 3, n = {n}: bitwise in every mode "
                f"(rows weighted, B4 / clip / arc by mode: {weighted})")
        del x, g, ints
        torch.cuda.empty_cache()


DTYPES = ("float32", "bfloat16", "float16")


def check_meamed(errs: dict) -> None:
    """B6 against its plain version, bitwise (both add the selected values
    in node order and multiply by the f32 reciprocal of k), NaN canonical:
    on rows holding NaN, +-inf and -0.0, and on values quantized to halves,
    whose deviations tie at the cut (filled in node order)."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    cases = [((1, MAIN_N, 421_642), MAIN_BYZ), ((1,) + HEADLINE, 8), ((2,) + GRID, 8),
             ((2, 128, 50_000), 40), ((2, 100, 50_001), 25), ((2, 13, 50_000), 3),
             ((2, 13, 50_000), 0), ((2, 13, 50_000), 12)]
    for shape, f in cases:
        for quantized in (False, True):
            base = random_rounds(shape, seed=400 + shape[1] + f, specials=True)
            if quantized:
                base = torch.round(base * 2.0) / 2.0
            for name in DTYPES:
                x = base.to(getattr(torch, name))
                out = kernels.meamed_stream(x, f=f)
                ref = kernels.meamed_stream_plain(x, f=f)
                check(bits_equal(out, ref) and nan_is_canonical(out),
                      f"B6 differs from plain at {shape} f={f} {name} quantized={quantized}")
                check(bool(torch.isnan(out[:, 1]).all()), f"B6 NaN column not NaN at {shape}")
                errs["meamed"] = max(errs["meamed"], max_abs_err(out, ref))
            log(f"  B6 {shape} f={f} {'halves' if quantized else 'normal'}: bitwise equal in "
                f"{', '.join(DTYPES)}; NaN columns {int(torch.isnan(out[0]).sum())} of {shape[2]}")
            del base, x, out, ref
        torch.cuda.empty_cache()


def centre_inputs(n: int, d: int, seed: int, dtype):
    """``(x, z, c_tau)``: rows every third x3, their coordinate median as
    the centre, and a clip threshold between the two scales' distances."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    x = pre_rows((1, n, d), seed=seed)[0].to(dtype)
    z = kernels.sorted_reduce_stream(x[None], mode="median")[0]
    return x, z, 2.0 * math.sqrt(d)


def check_center_step(errs: dict) -> None:
    """B7's loop kernel against its plain version, bit for bit (the order
    of every sum is fixed by d alone, and the plain version takes it):
    the one-step phases (weights and alpha, the sweep on the same weights,
    the whole step) at the main path's shape, the headline, ByzPy's grid
    and 128 and 13 x 50,000; then whole loops, the centre and the iteration
    count, Weiszfeld to tol = 1e-6 (at most 256 steps) and centred
    clipping's M = 10, at the main path's shape, the grid and 13 x 50,000
    in f32, bf16 and f16 and at the headline in f32; an all-inf row or one
    NaN entry makes the step and the loop all canonical NaN in both, and
    stops Weiszfeld after its first step."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    shapes = [(MAIN_N, 421_642), HEADLINE, GRID, (128, 50_000), (13, 50_000)]
    for n, d in shapes:
        for name in DTYPES:
            dtype = getattr(torch, name)
            x, z, c_tau = centre_inputs(n, d, 500 + n, dtype)
            for mode in ("weiszfeld", "clip"):
                kw = dict(mode=mode, c_tau=c_tau)
                w, alpha = kernels.center_weights(x, z, **kw)
                w_p, alpha_p = kernels.center_weights_plain(x, z, **kw)
                check(bits_equal(w, w_p) and bits_equal(alpha, alpha_p),
                      f"B7 {mode} weights differ from plain at {(n, d)} {name}")
                clipped = int((w_p < w_p.max()).sum())
                if mode == "clip":
                    check(0 < clipped < n, f"B7 clip took {clipped} of {n} rows at {(n, d)}")
                sweep = kernels.center_sweep(x, z, w, alpha)
                check(bits_equal(sweep, kernels.center_sweep_plain(x, z, w, alpha)),
                      f"B7 sweep differs from plain at {(n, d)} {name}")
                out = kernels.weighted_center_step(x, z, **kw)
                ref = kernels.weighted_center_step_plain(x, z, **kw)
                check(bits_equal(out, ref), f"B7 {mode} step differs from plain at {(n, d)} {name}")
                line = (f"  B7 {mode} {(n, d)} {name}: weights, alpha {float(alpha):.6f}, "
                        f"{clipped if mode == 'clip' else '-'} rows clipped, sweep and step bitwise")
                if (n, d) != (128, 50_000) and (name == "float32" or (n, d) != HEADLINE):
                    line += "; " + check_center_loop(x, z, mode, c_tau, errs, f"{(n, d)} {name}")
                log(line)
            del x, z
        torch.cuda.empty_cache()
    for name in DTYPES:
        for case in ("inf_row", "nan_entry"):
            x, z, c_tau = centre_inputs(13, 50_000, 9, getattr(torch, name))
            if case == "inf_row":
                x[5] = float("inf")
            else:
                x[5, 17] = float("nan")
            for mode in ("weiszfeld", "clip"):
                out = kernels.weighted_center_step(x, z, mode=mode, c_tau=c_tau)
                ref = kernels.weighted_center_step_plain(x, z, mode=mode, c_tau=c_tau)
                check(bool(torch.isnan(out).all()) and nan_is_canonical(out) and bits_equal(out, ref),
                      f"B7 {mode} with an {case} is not all canonical NaN in {name}")
                out, its = kernels.center_loop(x, z, mode=mode, c_tau=c_tau, max_iter=10)
                check(bool(torch.isnan(out).all()) and nan_is_canonical(out)
                      and int(its) == (1 if mode == "weiszfeld" else 10),
                      f"B7 {mode} loop with an {case} in {name}: {int(its)} steps, not all NaN")
                check_center_loop(x, z, mode, c_tau, errs, f"{case} {name}")
        log(f"  B7 {name}: an inf row or a NaN entry makes the whole step and loop canonical NaN, "
            f"both modes, the loops bitwise their plain versions (Weiszfeld stops after 1 step)")


def check_center_loop(x, z, mode: str, c_tau: float, errs: dict, what: str) -> str:
    """One launch of the whole loop (Weiszfeld: tol 1e-6, max_iter 256;
    clip: M = 10) equal to its plain version bit for bit, iteration counts
    equal; returns a line for the log."""
    from byzpy_tpu_torch.ops import kernels

    kw = dict(mode=mode, c_tau=c_tau, max_iter=256 if mode == "weiszfeld" else 10)
    before = dict(kernels.launch_counts)
    out, its = kernels.center_loop(x, z, **kw)
    launched = {k: v - before[k] for k, v in kernels.launch_counts.items() if v != before[k]}
    check(launched == {f"center_loop:{mode}": 1}, f"B7 {mode} loop at {what} launched {launched}")
    ref, its_p = kernels.center_loop_plain(x, z, **kw)
    check(int(its) == int(its_p), f"B7 {mode} loop at {what}: {int(its)} steps, plain {int(its_p)}")
    check(bits_equal(out, ref) and nan_is_canonical(out),
          f"B7 {mode} loop differs from plain at {what} ({int(its)} steps)")
    errs[f"center_loop:{mode}"] = max(errs[f"center_loop:{mode}"], max_abs_err(out, ref))
    return f"loop {int(its)} steps, one launch, bitwise"


CODEC_MODES = ("int8", "fp8", "fp8_e5m2")


def codec_rows(rows: int, d: int, seed: int, dtype):
    """Codec inputs on the card: ``random_rounds(specials=True)``'s NaN,
    +-inf, -0.0 and sprinkled NaN, an all-zero first 300 values in row 2
    (whole blocks at block 100, and block 0 at block 256) and an all-zero
    row 3."""
    x = random_rounds((1, rows, d), seed=seed, specials=True)[0] * 3.0
    x[2, :300] = 0.0
    x[3] = 0.0
    return x.to(dtype)


def check_codecs(errs: dict) -> None:
    """B13 (int8) and B15 (fp8 e4m3fn / e5m2) against their plain versions
    on the card, codes and scales bitwise, and B14's decode of each into
    f32 and the input dtype bitwise, in f32, bf16 and f16, at block 256 and
    100, at the main path's 8 x 421,642 (a partial last block at both
    blocks) and the headline 64 x 1,048,576 (partial at block 100). Every
    step is one IEEE operation, so nothing may differ."""
    import torch

    from byzpy_tpu_torch.ops import codec_kernels as ck

    for rows, d in ((MAIN_N, 421_642), HEADLINE):
        for name in DTYPES:
            dtype = getattr(torch, name)
            x = codec_rows(rows, d, 700 + rows, dtype)
            for block in (256, 100):
                for mode in CODEC_MODES:
                    codes, scales = ck.encode_rows(x, block=block, mode=mode)
                    pc, ps = ck.encode_rows_plain(x, block=block, mode=mode)
                    check(torch.equal(codes.view(torch.uint8), pc.view(torch.uint8))
                          and bits_equal(scales, ps),
                          f"{mode} encode differs from plain at {(rows, d)} {name} block {block}")
                    for out in {torch.float32, dtype}:
                        dec = ck.decode_rows(codes, scales, block=block, dtype=out)
                        ref = ck.decode_rows_plain(codes, scales, block=block, dtype=out)
                        check(bits_equal(dec, ref) and bool(torch.isfinite(dec).all()),
                              f"{mode} decode to {out} differs from plain at {(rows, d)} {name}")
                        errs["dequantize"] = max(errs["dequantize"], max_abs_err(dec, ref))
                    key = "quantize:int8" if mode == "int8" else "quantize:fp8"
                    errs[key] = max(errs[key], float(
                        (codes.float() - pc.float()).abs().max()))
                    del codes, scales, pc, ps, dec, ref
                log(f"  B13/B15/B14 {(rows, d)} {name} block {block}: int8, fp8, fp8_e5m2 codes "
                    f"and scales bitwise, decodes bitwise, all finite")
            del x
            torch.cuda.empty_cache()


def masked_rows(shape, seed: int, dtype, *, specials: bool = True):
    """Rows for the masked family's kernels: normal data at per-row scales
    0.1-50 (so sums cancel and round), with ``specials``, an all-NaN row,
    an all-inf row and ``random_rounds``' NaN, +-inf and -0.0 columns."""
    import torch

    x = random_rounds((1,) + tuple(shape), seed=seed, specials=specials)[0]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x *= torch.rand((shape[0], 1), generator=gen, device="cuda") * 50.0 + 0.1
    if specials and shape[0] > 7:
        x[6] = float("nan")
        x[7] = float("inf")
    return x.to(dtype).contiguous()


def check_masked_kernels(errs: dict) -> None:
    """B11, B2 and the row reduction against their plain versions, bit for
    bit, in f32, bf16 and f16, on rows holding NaN, +-inf and -0.0: B11 at
    1, 4, 8 and 17 cohorts (every cohort tile up to 8, and two tiles of 16),
    fill = R and R / 2 (an int and a device int32, the rows past the fill
    NaN, which must not be read), at the serving path's 64 x 421,642, R =
    8, the executor's 128 rows at an odd d (row starts at every alignment)
    and the headline; B2 at n = 8 ... 128 (and 13, 29) x 421,642 and the
    headline, n = 129 raising; the row reduction with and without a
    centre."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    for (R, d) in ((64, 421_642), (8, 421_642), (EXEC_CAP, 421_641), HEADLINE):
        for name in DTYPES if (R, d) != HEADLINE else ("float32",):
            x = masked_rows((R, d), 600 + R, getattr(torch, name))
            for C in B11_COHORTS if (R, d) != HEADLINE else (1, 4):
                gen = torch.Generator(device="cuda").manual_seed(C)
                w = torch.randn((C, R), generator=gen, device="cuda")
                out = kernels.segment_sum(x, w)
                ref = kernels.segment_sum_plain(x, w)
                check(bits_equal(out, ref) and nan_is_canonical(out),
                      f"B11 differs from plain at C={C} {(R, d)} {name}")
                errs["segment_sum"] = max(errs["segment_sum"], max_abs_err(out, ref))
                fill = R // 2
                xz, wz = x.clone(), w.clone()
                xz[fill:], wz[:, fill:] = 0, 0
                want = kernels.segment_sum_plain(xz, wz)
                xg = x.clone()
                xg[fill:] = float("nan")
                for f in (fill, torch.tensor([fill], dtype=torch.int32, device="cuda")):
                    check(bits_equal(kernels.segment_sum(xg, wz, fill=f), want),
                          f"B11 fill={fill} ({type(f).__name__}) differs at C={C} {(R, d)} {name}")
                del w, out, ref, xz, wz, want, xg
            log(f"  B11 {(R, d)} {name}: C in {B11_COHORTS if (R, d) != HEADLINE else (1, 4)} "
                f"bitwise equal to plain, fill = R and R/2 (int and device int32) bitwise, NaN "
                f"canonical")
            del x
            torch.cuda.empty_cache()
    for n in (8, 13, 16, 29, 32, 64, 128):
        for name in DTYPES:
            x = masked_rows((n, 421_642), 700 + n, getattr(torch, name))
            out = kernels.sort_columns(x)
            ref = kernels.sort_columns_plain(x)
            check(bits_equal(out, ref) and nan_is_canonical(out),
                  f"B2 differs from plain at n={n} {name}")
            errs["sort_columns"] = max(errs["sort_columns"], max_abs_err(out, ref))
            del x, out, ref
        torch.cuda.empty_cache()
    x = masked_rows(HEADLINE, 7, torch.float32)
    check(bits_equal(kernels.sort_columns(x), kernels.sort_columns_plain(x)), "B2 differs at the headline")
    del x
    try:
        kernels.sort_columns(torch.zeros((129, 16), device="cuda"))
        check(False, "B2 took n = 129")
    except NotImplementedError:
        pass
    log(f"  B2 n in 8, 13, 16, 29, 32, 64, 128 x 421,642 in {', '.join(DTYPES)} and the "
        f"headline: bitwise equal to plain, NaN canonical; n = 129 raises NotImplementedError")
    for (n, d) in ((64, 421_642), (8, 421_642), HEADLINE):
        for name in DTYPES if (n, d) != HEADLINE else ("float32",):
            x = masked_rows((n, d), 800 + n, getattr(torch, name), specials=False)
            x[3, 11] = float("nan")
            x[4, 12] = float("inf")
            for z in (None, x[n // 2].clone()):
                out, ref = kernels.row_sq_dists(x, z), kernels.row_sq_dists_plain(x, z)
                check(bits_equal(out, ref) and nan_is_canonical(out),
                      f"row_sq_dists differs from plain at {(n, d)} {name}")
                errs["row_sq_dists"] = max(errs["row_sq_dists"], max_abs_err(out, ref))
            del x
        torch.cuda.empty_cache()
    log("  row_sq_dists at 64 and 8 x 421,642 and the headline, with and without a centre, "
        f"in {', '.join(DTYPES)}: bitwise equal to plain")


# B11's cohort counts in phase 3: one, the executor's four, a full tile of 8
# and 17 (two tiles of 16)
B11_COHORTS = (1, 4, 8, 17)


# blocks of the s4 codec's checks: 100 is not a multiple of 8, so B16 writes
# a byte a lane there and a 32-bit word of 4 packed bytes elsewhere
S4_BLOCKS = (32, 100, 256, 1024)
WIRE_MODES = ("int8", "fp8", "fp8_e5m2", "s4")


def b12_key(mode: str) -> str:
    """The JSON entry a B12 mode's numbers go to (fp8_e5m2 beside fp8)."""
    return "segment_sum_dequant:fp8" if mode == "fp8_e5m2" else f"segment_sum_dequant:{mode}"


def check_s4_codec(errs: dict) -> None:
    """B16 (s4 encode) against its plain version, packed codes and scales
    bitwise, and B17's decode into f32 and the input dtype bitwise, in f32,
    bf16 and f16, on ``codec_rows``' NaN, +-inf, zero blocks and zero row:
    at the main path's 8 x 421,642 and an odd 8 x 421,641 (blocks 32, 100,
    256, 1024; d not a block multiple) and the headline 64 x 1,048,576
    (block 256). A capacity row (zero bytes and scales) decodes to -0.0."""
    import torch

    from byzpy_tpu_torch.ops import codec_kernels as ck

    for rows, d, blocks in ((MAIN_N, 421_642, S4_BLOCKS), (MAIN_N, 421_641, S4_BLOCKS),
                            (*HEADLINE, (256,))):
        for name in DTYPES:
            dtype = getattr(torch, name)
            x = codec_rows(rows, d, 900 + d % 97, dtype)
            for block in blocks:
                packed, scales = ck.encode_rows_s4(x, block=block)
                pp, ps = ck.encode_rows_s4_plain(x, block=block)
                check(torch.equal(packed, pp) and bits_equal(scales, ps),
                      f"B16 differs from plain at {(rows, d)} {name} block {block}")
                errs["quantize:s4"] = max(errs["quantize:s4"], float(
                    (ck.s4_values(packed) - ck.s4_values(pp)).abs().max()))
                for out in {torch.float32, dtype}:
                    dec = ck.decode_rows_s4(packed, scales, block=block, d=d, dtype=out)
                    ref = ck.decode_rows_s4_plain(packed, scales, block=block, d=d, dtype=out)
                    check(bits_equal(dec, ref) and bool(torch.isfinite(dec).all()),
                          f"B17 decode to {out} differs from plain at {(rows, d)} {name} block {block}")
                    errs["dequantize:s4"] = max(errs["dequantize:s4"], max_abs_err(dec, ref))
                del packed, scales, pp, ps, dec, ref
            log(f"  B16/B17 {(rows, d)} {name} blocks {blocks}: packed codes and scales bitwise, "
                f"decodes bitwise, all finite")
            del x
            torch.cuda.empty_cache()
    zero = ck.decode_rows_s4(torch.zeros((2, 128), dtype=torch.uint8, device="cuda"),
                             torch.zeros((2, 1), device="cuda"), block=256, d=256)
    check(bool(torch.signbit(zero).all()) and not bool(zero.any()),
          "B17: a capacity row does not decode to -0.0")
    log("  B17: a capacity row (zero bytes, zero scales) decodes to -0.0")


def check_segment_sum_dequant(errs: dict) -> None:
    """B12 against its plain version (the plain decode, the rows times the
    row weights, B11's plain chain) bit for bit: int8, fp8, fp8_e5m2 and s4
    wire rows (block 256) of 128 x 421,642 with C = 1, 4, 16 and 17
    cohorts, and of 128 x 421,641 (int8 / fp8 code rows of odd width, so
    row starts at every byte alignment) with C = 4 and 17, row weights None
    and stale (every fourth 0.5), and a device fill of 96 (the rows past it
    NaN-scaled, which must not be read); and 64 x 1,048,576 at C = 1."""
    import torch

    from byzpy_tpu_torch.ops import kernels
    from byzpy_tpu_torch.parallel import CommPrecision, encode_blockwise

    block = 256
    for R, d, cohorts in ((128, 421_642, (1, 4, 16, 17)), (128, 421_641, (4, 17)), (*HEADLINE, (1,))):
        x = masked_rows((R, d), 1000 + R, torch.float32, specials=False)
        omega = torch.where(torch.arange(R, device="cuda") % 4 == 1, 0.5, 1.0)
        fill = R * 3 // 4
        for mode in WIRE_MODES:
            enc = encode_blockwise(x, CommPrecision(mode, block=block))
            codes = enc.values if mode in ("int8", "s4") else enc.values.view(torch.uint8)
            bad = enc.scales.clone()
            bad[fill:] = float("nan")
            for C in cohorts:
                w = torch.randn((C, R), generator=torch.Generator(device="cuda").manual_seed(C),
                                device="cuda")
                for rw in (None, omega):
                    out = kernels.segment_sum_dequant(codes, enc.scales, w, mode=mode, block=block,
                                                      d=d, row_weights=rw)
                    ref = kernels.segment_sum_dequant_plain(codes, enc.scales, w, mode=mode,
                                                            block=block, d=d, row_weights=rw)
                    check(bits_equal(out, ref) and nan_is_canonical(out),
                          f"B12 {mode} differs from plain at C={C} {(R, d)} row weights "
                          f"{rw is not None}")
                    errs[b12_key(mode)] = max(errs[b12_key(mode)], max_abs_err(out, ref))
                wz = w.clone()
                wz[:, fill:] = 0
                want = kernels.segment_sum_dequant_plain(codes, enc.scales, wz, mode=mode,
                                                         block=block, d=d, row_weights=omega)
                got = kernels.segment_sum_dequant(
                    codes, bad, w, mode=mode, block=block, d=d, row_weights=omega,
                    fill=torch.tensor([fill], dtype=torch.int32, device="cuda"))
                check(bits_equal(got, want), f"B12 {mode} with a device fill differs at C={C} {(R, d)}")
                del w, out, ref, wz, want, got
            del enc, codes, bad
            torch.cuda.empty_cache()
        log(f"  B12 {(R, d)}: {', '.join(WIRE_MODES)} at C in {cohorts}, row weights None and stale, "
            f"bitwise equal to plain; a device fill of {fill} bitwise, the rows past it unread")
        del x


# the segmented sort-reduce's shapes, as the card tests take them: (R, d,
# cohort sizes, padding slots): the executor's batch (odd rows 8-byte
# aligned), an odd d (rows at every alignment) with a one-row and a 120-row
# cohort, and d below one column tile
SEGMENTED_CASES = ((128, 421_642, (6, 13, 29, 64), 1), (128, 50_001, (1, 2, 5, 120), 0),
                   (16, 37, (3, 8, 5), 1))
SEGMENTED_MODES = (("trimmed", 0), ("trimmed", 2), ("trimmed", 8), ("median", 0))


def ragged_layout(sizes, pad: int = 0) -> tuple:
    """``(offsets, lengths)`` int32 on the card: cohorts packed from row 0
    in order, then ``pad`` padding slots (offset the fill, length 0), as
    ``RaggedExecutor.aggregate`` lays them out."""
    import torch

    offsets = [sum(sizes[:c]) for c in range(len(sizes))] + [sum(sizes)] * pad
    lengths = list(sizes) + [0] * pad
    return (torch.tensor(offsets, dtype=torch.int32, device="cuda"),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def check_segmented_sort(errs: dict) -> None:
    """The segmented sort-reduce against its plain version, bit for bit, at
    ``SEGMENTED_CASES`` in every mode of ``SEGMENTED_MODES``: on finite rows
    and on ``masked_rows``' rows holding NaN and +-inf (an all-NaN and an
    all-inf row at R > 7), NaN canonical; R = 129 raises."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    for R, d, sizes, pad in SEGMENTED_CASES:
        offsets, lengths = ragged_layout(sizes, pad)
        for specials in (False, True):
            x = masked_rows((R, d), 1100 + R + d % 89, torch.float32, specials=specials)
            for mode, f in SEGMENTED_MODES:
                out = kernels.segmented_sort_reduce(x, offsets, lengths, mode=mode, f=f)
                ref = kernels.segmented_sort_reduce_plain(x, offsets, lengths, mode=mode, f=f)
                check(bits_equal(out, ref) and nan_is_canonical(out),
                      f"segmented sort-reduce {mode} f={f} differs from plain at {(R, d)} "
                      f"cohorts {sizes} (+{pad}), non-finite rows {specials}")
                errs["segmented_sort_reduce"] = max(errs["segmented_sort_reduce"], max_abs_err(out, ref))
                del out, ref
            del x
            torch.cuda.empty_cache()
        log(f"  segmented sort-reduce {(R, d)} cohorts {list(sizes)} + {pad} padding: trimmed f = 0, 2, "
            f"8 and median bitwise equal to plain, on finite rows and on rows holding NaN / +-inf")
    try:
        kernels.segmented_sort_reduce(torch.zeros((129, 16), device="cuda"), *ragged_layout((129,)),
                                      mode="median")
        check(False, "the segmented sort-reduce took R = 129")
    except NotImplementedError:
        pass


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def class_api_configs(example_params: dict) -> tuple:
    """Phase 4's class-API configurations, each an ``(n, d) -> (d,)``
    aggregate for the PS round that goes through the operator classes:

    - ``fold_multi_krum``, ``fold_trimmed_mean``, ``fold_cge``: each step
      unravels the matrix into per-node gradient dictionaries, folds them
      with ``fold`` in a seeded per-step permutation of the slots and
      calls ``fold_finalize``;
    - ``class_median``: ``CoordinateWiseMedian().aggregate`` of the list
      of dictionaries;
    - ``pipeline_nnm_multi_krum``: the callable that
      ``fused_pipeline_matrix_fn(NearestNeighborMixing(2), MultiKrum(2, 4))``
      returns.

    On the card every class is built with ``device=None``. Returns
    ``(configs, forbidden, checks, fold_flags)``: the main path's entries,
    the kernels that must not launch, a check of each against its barrier
    function on a step-1 matrix, and the trimmed-mean fold's non-finite
    fallback flag per CUDA step."""
    import torch

    from byzpy_tpu_torch.aggregators import (
        ComparativeGradientElimination,
        CoordinateWiseMedian,
        CoordinateWiseTrimmedMean,
        MultiKrum,
        fused_pipeline_matrix_fn,
    )
    from byzpy_tpu_torch.ops import preagg, robust
    from byzpy_tpu_torch.pre_aggregators import NearestNeighborMixing
    from byzpy_tpu_torch.utils import ravel_fn, unstack_rows

    ravel, unravel = ravel_fn(example_params)
    b = MAIN_BYZ
    fold_flags: dict = {}

    def device_arg(m):
        return None if m.is_cuda else "cpu"

    def folded(name, make):
        made, steps = {}, {"cuda": 0, "cpu": 0}

        def call(m):
            dev = m.device.type
            if dev not in made:
                made[dev] = make(device_arg(m))
            agg = made[dev]
            perm = torch.randperm(m.shape[0], generator=torch.Generator().manual_seed(steps[dev]))
            steps[dev] += 1
            state = agg.fold_init(m.shape[0])
            for i in perm.tolist():
                agg.fold(state, i, unravel(m[i]))
            out = ravel(agg.fold_finalize(state))
            if m.is_cuda and hasattr(state, "nonfinite"):
                fold_flags.setdefault(name, []).append(bool(state.nonfinite))
            return out
        return call

    medians = {}

    def class_median(m):
        dev = m.device.type
        if dev not in medians:
            medians[dev] = CoordinateWiseMedian(device=device_arg(m))
        return ravel(medians[dev].aggregate(unstack_rows(m, unravel)))

    fused = fused_pipeline_matrix_fn(NearestNeighborMixing(b), MultiKrum(b, 4))
    check(fused is not None, "fused_pipeline_matrix_fn(NNM, MultiKrum) gave no fused callable")
    fold_mk = folded("fold_multi_krum", lambda dev: MultiKrum(b, 4, device=dev))
    fold_tm = folded("fold_trimmed_mean", lambda dev: CoordinateWiseTrimmedMean(b, device=dev))
    fold_cge = folded("fold_cge", lambda dev: ComparativeGradientElimination(b, device=dev))
    sweep = "weighted_rows"
    configs = {
        "fold_multi_krum": (None, fold_mk, ["selection_mean_from_gram:krum"], None),
        "fold_trimmed_mean": (None, fold_tm, [], None),
        "fold_cge": (None, fold_cge, [], None),
        "class_median": (None, class_median, ["sorted_reduce:median"], None),
        "pipeline_nnm_multi_krum": (None, fused, ["gram", "nnm_selection_weights:krum", sweep],
                                    None),
    }
    forbidden = {
        # the finalize is B5 on the folded Gram, one launch
        "fold_multi_krum": ["gram", "selection_weights:krum", sweep],
        "fold_trimmed_mean": ["sorted_reduce:trimmed"],  # the extremes path, no fallback
        "fold_cge": ["gram", "selection_weights:cge"],
    }

    def near(name, fn, barrier):
        def run(m):
            out, ref = fn(m), barrier(m)
            diff = float((out - ref).abs().max())
            check(torch.allclose(out, ref, rtol=1e-5, atol=1e-6),
                  f"{name}: max |diff| {diff:.3g} from its barrier function")
            return {"max_abs_diff_vs_barrier": diff}
        return run

    def median_bitwise(m):
        check(bits_equal(class_median(m), robust.coordinate_median(m)),
              "class_median: not bitwise equal to robust.coordinate_median")
        return {"bitwise_equal_to_coordinate_median": True}

    checks = {
        "fold_multi_krum": near("fold_multi_krum", fold_mk, lambda m: robust.multi_krum(m, f=b, q=4)),
        "fold_trimmed_mean": near("fold_trimmed_mean", fold_tm, lambda m: robust.trimmed_mean(m, f=b)),
        "fold_cge": near("fold_cge", fold_cge, lambda m: robust.cge(m, f=b)),
        "class_median": median_bitwise,
        "pipeline_nnm_multi_krum": near(
            "pipeline_nnm_multi_krum", fused,
            lambda m: robust.multi_krum(preagg.nnm(m, f=b), f=b, q=4)),
    }
    return configs, forbidden, checks, fold_flags


def drive(name: str, build) -> dict:
    """Drive one configuration's round on the card and on the CPU.

    ``build(dev)`` makes the round on ``dev`` and returns ``(run,
    snapshot)``: ``run()`` takes one step and returns its metrics,
    ``snapshot()`` the flat parameters on the host. The card runs
    ``MAIN_STEPS`` steps with the counts set to 0 just before and read just
    after, then 3 more under torch.profiler; the CPU runs ``CPU_STEPS``.
    Returns ``{dev: {"snaps", "losses", "times", "metrics"}}``, the card's
    with its ``"counts"``, ``"profile"`` and ``"ms_per_step"`` (the median
    of steps 2-MAIN_STEPS). Fails if a card loss is not finite."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    data = {}
    for dev in ("cuda", "cpu"):
        run, snapshot = build(dev)
        out = {"snaps": [], "losses": [], "times": [], "metrics": []}
        steps = MAIN_STEPS if dev == "cuda" else CPU_STEPS
        if dev == "cuda":
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
        for s in range(steps):
            t0 = time.perf_counter()
            metrics = run()
            if dev == "cuda":
                torch.cuda.synchronize()
            out["times"].append((time.perf_counter() - t0) * 1e3)
            out["metrics"].append(metrics)
            out["losses"].append(float(metrics["honest_loss"]))
            if s < CPU_STEPS:
                out["snaps"].append(snapshot())
        if dev == "cuda":
            out["counts"] = dict(kernels.launch_counts)
            out["profile"] = profile_steps(run)
        data[dev] = out
    card = data["cuda"]
    check(all(map(math.isfinite, card["losses"])), f"{name}: loss not finite {card['losses']}")
    later = sorted(card["times"][1:])
    card["ms_per_step"] = later[len(later) // 2]
    return data


def compare_to_cpu(name: str, data: dict, slack=None):
    """Hold the card's parameters after each of the first ``CPU_STEPS``
    steps to the CPU's: within PARAM_RTOL / PARAM_ATOL, plus ``slack[s]``
    (a per-coordinate tensor) after step s + 1 where given. Returns the
    largest |diff| and the largest share of the tolerance used."""
    worst, used = 0.0, 0.0
    for s, (g, c) in enumerate(zip(data["cuda"]["snaps"], data["cpu"]["snaps"])):
        diff = (g - c).abs()
        tol = PARAM_ATOL + PARAM_RTOL * c.abs()
        if slack is not None:
            tol = tol + slack[s]
        share = float((diff / tol).max())
        check(share <= 1.0, f"{name}: step {s + 1} differs from the CPU port (max |diff| "
              f"{float(diff.max()):.3g}, {share:.3g} x the tolerance)")
        worst, used = max(worst, float(diff.max())), max(used, share)
    return worst, used


def code_steps(rows, comm):
    """One code step of ``comm``'s codec at each coordinate, the largest over
    ``rows`` (twice the round-to-nearest bound of each row's own block; the
    1.001 covers the few ulp by which a decoded block's absmax can fall
    short of the encoded one's), on the host."""
    from byzpy_tpu_torch.parallel import quantization_error_bound

    bound = quantization_error_bound(rows, block=comm.block, mode=comm.mode)
    return (2.002 * bound).amax(dim=0).cpu()


def ps_wire_slack(steps_c: list, cfg, error_feedback: bool) -> list:
    """What the card's and the CPU's codes may differ by, run through the PS
    round's optimizer, per coordinate after each step. A value at a
    rounding boundary may flip one code where the two devices' gradients
    differ in their last bits, so each decoded row, and with it the
    coordinate-wise or selection aggregate, may move by one code step
    ``c_t``; with error feedback the carried residual moves by the previous
    step's too. The momentum trace and the parameters carry it on
    (``trace = w + momentum * trace``, ``params += lr * trace``)."""
    out, trace, moved = [], None, None
    for t, c in enumerate(steps_c):
        w = c + steps_c[t - 1] if error_feedback and t else c
        trace = w if trace is None else w + cfg.momentum * trace
        moved = cfg.learning_rate * trace if moved is None else moved + cfg.learning_rate * trace
        out.append(moved)
    return out


# the subset-search aggregators and the attack classes on the main path:
# name -> (aggregator, attack, launches a step of every counter that moves,
# host reads of each aggregation on the card; None: not counted)
SUBSET_ATTACK_CONFIGS = {
    "o_mda": ("mda", None, {"gram": 1}, 1),
    "p_smea": ("smea", None, {"gram": 1}, 0),
    "q_little_multi_krum": ("multi_krum", "little",
                            {"gram": 1, "selection_weights:krum": 1, "weighted_rows": 1}, None),
    "r_empire_trimmed_mean": ("trimmed_mean", "empire", {"sorted_reduce:trimmed": 1}, None),
    "s_inf_smea": ("smea", "inf", {"gram": 1}, 0),
    "t_influence_trimmed_mean": ("trimmed_mean", "influence", {"sorted_reduce:trimmed": 1}, None),
}
# f32 rounding of a subset's diameter or eigenvalue score at these rows:
# where the CPU's runner-up is within it of the CPU's winner, the card may
# pick either
SUBSET_RTOL = 1e-5


class SubsetAttackPath:
    """Phase 4's configurations (o)-(t): MDA and SMEA through their classes,
    and the byzantine rows of attack classes through
    ``parallel.adaptive_attack_rows``, on the SmallCNN PS round.

    Each device gets its own aggregator and attack instances (``device=None``
    on the card, ``"cpu"`` on the CPU). The hooks record what the checks
    need: the subset each aggregation selected (read after the step, not
    inside the counted aggregation), the CPU's score of every subset at each
    step (for the near-tie rule), the influence attack's submissions and the
    observations fed to it. The CPU run of (t) observes the card run's
    aggregates, not its own, so that both runs submit the same rows and the
    CPU comparison holds the round, not the attacker's branch choices."""

    def __init__(self, n: int, b: int, d: int) -> None:
        self.n, self.b, self.d = n, b, d
        self.made = {}
        self.selections = {name: {"cuda": [], "cpu": []} for name in SUBSET_ATTACK_CONFIGS}
        self.cpu_scores = {name: [] for name in SUBSET_ATTACK_CONFIGS}
        self.captured = {}
        self.submissions = {"cuda": [], "cpu": []}
        self.observed = []  # the card's aggregates, in step order
        self.agg_norms = {name: [] for name in SUBSET_ATTACK_CONFIGS}

    def _instance(self, name: str, dev: str, make):
        key = (name, dev)
        if key not in self.made:
            self.made[key] = make(None if dev == "cuda" else "cpu")
        return self.made[key]

    def aggregators(self) -> dict:
        """The entries of the main path's aggregator table."""
        from byzpy_tpu_torch.aggregators import SMEA, MinimumDiameterAveraging
        from byzpy_tpu_torch.ops import robust

        b = self.b
        out = {}
        for name, (kind, _, launches, _) in SUBSET_ATTACK_CONFIGS.items():
            if kind in ("mda", "smea"):
                make = (lambda dev: MinimumDiameterAveraging(b, device=dev)) if kind == "mda" \
                    else (lambda dev: SMEA(b, device=dev))

                def agg(m, name=name, make=make, kind=kind):
                    dev = m.device.type
                    if dev == "cpu":
                        self.cpu_scores[name].append(self._all_scores(kind, m))
                    return self._instance(name, dev, make).matrix_fn()(m)
            elif kind == "multi_krum":
                def agg(m):
                    return robust.multi_krum(m, f=b, q=4)
            else:
                def agg(m, name=name):
                    out = robust.trimmed_mean(m, f=b)
                    self.captured[m.device.type] = out
                    return out
            out[name] = (None, agg, list(launches), None)
        return out

    def _all_scores(self, kind: str, m):
        """The CPU's score of every (n - b)-subset of ``m``, in enumeration
        order: diameters on the search's distances (MDA), the Jacobi
        scores on the Gram (SMEA)."""
        import torch

        from byzpy_tpu_torch.aggregators.geometric_wise.minimum_diameter_average import (
            _dists_for_search,
        )
        from byzpy_tpu_torch.aggregators.geometric_wise.smea import _device_combos
        from byzpy_tpu_torch.ops import robust

        combos = _device_combos(self.n, self.n - self.b, torch.device("cpu"))
        if kind == "mda":
            return robust.subset_diameters(torch.from_numpy(_dists_for_search(m)), combos)
        return robust.subset_max_eigvals_jacobi(robust.gram_matrix(m), combos)

    def attack(self, name: str, dev: str):
        """The round's ``attack`` for ``name`` on ``dev``, or None."""
        from byzpy_tpu_torch.attacks import (
            EmpireAttack, InfAttack, InfluenceAscentAttack, LittleAttack,
        )
        from byzpy_tpu_torch.parallel import adaptive_attack_rows

        kind = SUBSET_ATTACK_CONFIGS.get(name, (None, None))[1]
        if kind is None:
            return None
        make = {"little": lambda d: LittleAttack(self.b, device=d),
                "empire": lambda d: EmpireAttack(scale=-1.1, device=d),
                "inf": lambda d: InfAttack(device=d),
                "influence": lambda d: InfluenceAscentAttack(self.d, device=d)}[kind]
        atk = self._instance(name + ":attack", dev, make)

        def rows(honest, generator):
            out = adaptive_attack_rows(atk, self.b, honest=honest)
            if kind == "influence":
                self.submissions[dev].append(out[0].cpu().clone())
            return out
        return rows

    def after_step(self, name: str, dev: str, metrics: dict) -> None:
        """Read what the step chose, outside its counted aggregation; feed
        (t)'s attack its observation."""
        from byzpy_tpu_torch.attacks import PublicRoundState

        if name not in SUBSET_ATTACK_CONFIGS:
            return
        kind, attack = SUBSET_ATTACK_CONFIGS[name][:2]
        self.agg_norms[name].append(float(metrics["agg_grad_norm"]))
        if kind in ("mda", "smea"):
            sel = self.made[(name, dev)].last_selection
            self.selections[name][dev].append(sel.tolist())
        if attack == "influence":
            atk = self.made[(name + ":attack", dev)]
            step = len(atk.observations)
            if dev == "cuda":
                self.observed.append(self.captured["cuda"].float().cpu().numpy())
            atk.observe_round(PublicRoundState(step, self.observed[step]))

    def finish(self, name: str) -> dict:
        """The checks of ``name`` after its drive: the same subsets as the
        CPU port (or a near tie, printed), no byzantine row under (s), the
        adaptive submissions replayed bit for bit."""
        import torch

        from byzpy_tpu_torch.aggregators.geometric_wise.smea import _device_combos
        from byzpy_tpu_torch.attacks import InfluenceAscentAttack, PublicRoundState

        kind, attack = SUBSET_ATTACK_CONFIGS[name][:2]
        out = {"agg_grad_norms": self.agg_norms[name]}
        check(all(map(math.isfinite, self.agg_norms[name])),
              f"{name}: the aggregate is not finite {self.agg_norms[name]}")
        if kind in ("mda", "smea"):
            combos = _device_combos(self.n, self.n - self.b, torch.device("cpu")).tolist()
            card, cpu = self.selections[name]["cuda"], self.selections[name]["cpu"]
            gaps, ties = [], []
            for s, (g, c, scores) in enumerate(zip(card, cpu, self.cpu_scores[name])):
                order = torch.sort(scores[torch.isfinite(scores)]).values
                best = float(order[0])
                # None: no other subset scores finite (every other one holds an inf row)
                gaps.append(float((order[1] - order[0]) / max(abs(best), 1e-30))
                            if order.numel() > 1 else None)
                if g != c:
                    mine = float(scores[combos.index(g)])
                    ties.append({"step": s + 1, "card": g, "cpu": c,
                                 "rel_score_above_cpu_winner": (mine - best) / max(abs(best), 1e-30)})
                    check(mine <= best + SUBSET_RTOL * abs(best),
                          f"{name}: step {s + 1} selected {g} on the card, {c} on the CPU, "
                          f"and no near tie ({ties[-1]})")
            if ties:
                log(f"    {name}: near ties the card broke the other way: {ties}")
            out.update(selected_card=card, selected_cpu=cpu, near_ties=ties,
                       runner_up_rel_gap_per_step=gaps)
        if attack == "inf":
            honest = list(range(self.n - self.b))
            check(all(sel == honest for sel in self.selections[name]["cuda"]),
                  f"{name}: a byzantine row was selected {self.selections[name]['cuda']}")
        if attack == "influence":
            subs = self.submissions["cuda"]
            check(len(subs) == len(self.observed) == MAIN_STEPS + 3,
                  f"{name}: {len(subs)} submissions, {len(self.observed)} observations")
            replay = InfluenceAscentAttack(self.d, device="cpu")
            for s, (sub, obs) in enumerate(zip(subs, self.observed)):
                check(bits_equal(replay.apply(), sub),
                      f"{name}: the CPU replay's submission {s + 1} differs from the card's")
                replay.observe_round(PublicRoundState(s, obs))
            for s, sub in enumerate(self.submissions["cpu"]):
                check(bits_equal(sub, subs[s]),
                      f"{name}: the CPU run's submission {s + 1} differs from the card's")
            out.update(replayed_submissions_bitwise=len(subs),
                       attack_scale_after=float(replay.scale))
        return out


def main_path(counts: dict) -> dict:
    import torch
    from torch.func import grad_and_value, vmap

    from byzpy_tpu_torch.models import SmallCNN, make_bundle, synthetic_classification
    from byzpy_tpu_torch.ops import attack_ops, preagg, robust
    from byzpy_tpu_torch.parallel import (
        CommPrecision, PSStepConfig, as_comm_precision, build_ps_train_step,
    )

    n, b, batch = MAIN_N, MAIN_BYZ, MAIN_BATCH
    cfg = PSStepConfig(n_nodes=n, n_byzantine=b)
    # CAF's start vector, one draw on the host for both devices' rounds
    caf_start = torch.randn((421_642,), generator=torch.Generator().manual_seed(0))
    caf_starts = {"cpu": caf_start, "cuda": caf_start.cuda()}
    # name -> (pre_aggregate, aggregate, kernels that must launch, the
    # threshold rule whose clipped rows at step 1 are counted)
    sweep = "weighted_rows"
    krum = {"gram": 1, "selection_weights:krum": 1, sweep: 1}
    aggregators = {
        "coordinate_median": (None, robust.coordinate_median, ["sorted_reduce:median"], None),
        "trimmed_mean": (None, lambda m: robust.trimmed_mean(m, f=b), ["sorted_reduce:trimmed"],
                         None),
        "multi_krum": (None, lambda m: robust.multi_krum(m, f=b, q=4), list(krum), None),
        "a_clip_trimmed_mean": (lambda m: preagg.clip_rows(m, threshold=MAIN_TAU),
                                lambda m: robust.trimmed_mean(m, f=b),
                                ["sorted_reduce:trimmed"], "clip"),
        "b_nnm_coordinate_median": (lambda m: preagg.nnm(m, f=b), robust.coordinate_median,
                                    ["gram", "nnm_weights", "mix_rows", "sorted_reduce:median"],
                                    None),
        "c_nnm_multi_krum": (None, lambda m: robust.nnm_multi_krum(m, f_nnm=b, f=b, q=4),
                             ["gram", "nnm_selection_weights:krum", sweep], None),
        "d_clipped_multi_krum": (None, lambda m: robust.clipped_multi_krum(m, tau=MAIN_TAU, f=b, q=4),
                                 ["gram", "clip_selection_weights:clip", sweep], "clip"),
        "e_arc_multi_krum": (None, lambda m: robust.arc_multi_krum(m, f_arc=b, f=b, q=4),
                             ["gram", "clip_selection_weights:arc", sweep], "arc"),
        "meamed": (None, lambda m: robust.mean_of_medians(m, f=b), ["meamed"], None),
        "geometric_median": (None, robust.geometric_median,
                             ["sorted_reduce:median", "center_loop:weiszfeld"], None),
        "centered_clipping": (None, lambda m: robust.centered_clipping(m, c_tau=MAIN_CTAU, M=10),
                              ["center_loop:clip"], "centre"),
        "cge": (None, lambda m: robust.cge(m, f=b), ["gram", "selection_weights:cge", sweep], None),
        "monna": (None, lambda m: robust.monna(m, f=b, reference_index=0),
                  ["gram", "selection_weights:monna", sweep], None),
        "caf": (None, lambda m: robust.caf(m, f=b, v_init=caf_starts[m.device.type]), [], None),
    }
    # the compressed gradient hop, name -> (comm_precision, the launches
    # each step makes, every other counter staying 0)
    wire = {
        "f_ps_int8_trimmed": ("int8", {"quantize:int8": 1, "dequantize:int8": 1,
                                       "sorted_reduce:trimmed": 1}),
        "g_ps_fp8_multi_krum": ("fp8", {"quantize:fp8": 1, "dequantize:fp8": 1, **krum}),
        "h_ps_int8_ef_median": (CommPrecision("int8", error_feedback=True),
                                {"quantize:int8": 1, "dequantize:int8": 1,
                                 "sorted_reduce:median": 1}),
        "l_ps_s4_ef_trimmed": (CommPrecision("s4", error_feedback=True),
                               {"quantize:s4": 1, "dequantize:s4": 1, "sorted_reduce:trimmed": 1}),
    }
    for name, agg in (("f_ps_int8_trimmed", aggregators["trimmed_mean"][1]),
                      ("g_ps_fp8_multi_krum", aggregators["multi_krum"][1]),
                      ("h_ps_int8_ef_median", robust.coordinate_median),
                      ("l_ps_s4_ef_trimmed", aggregators["trimmed_mean"][1])):
        aggregators[name] = (None, agg, list(wire[name][1]), None)
    # the loops whose iterations each step reports (robust.last_iterations)
    loops = {"geometric_median": "geometric_median", "caf": "caf"}
    # B7's loops: exactly one launch a step, and at most this many host
    # reads a call (the geometric median reads its iteration count)
    centre_loops = {"geometric_median": ("center_loop:weiszfeld", 1),
                    "centered_clipping": ("center_loop:clip", 0)}
    host_reads = {name: [] for name in centre_loops}
    # the subset-search aggregations' host reads: exactly this many a call
    subset_reads = {name: cfg[3] for name, cfg in SUBSET_ATTACK_CONFIGS.items() if cfg[3] is not None}
    host_reads.update({name: [] for name in subset_reads})

    def reads_counted(name, fn):
        """``fn`` whose host reads on the card are counted, call by call."""
        def call(m):
            if not m.is_cuda:
                return fn(m)
            out, reads = count_syncs(lambda: fn(m))
            host_reads[name].append(reads)
            return out
        return call
    first_norms, first_centre_dists, first_matrix = {}, {}, {}

    def recording(name, fn):
        """``fn`` that keeps the row norms of the first CUDA matrix it sees
        and the rows' distances to their mean (centred clipping's first
        centre), and the matrix itself for the class-API checks: copies at
        step 1, outside the steps the median is taken of."""
        def call(m):
            if m.is_cuda and name not in first_norms:
                first_norms[name] = torch.linalg.vector_norm(m.float(), dim=1).cpu()
                first_centre_dists[name] = torch.linalg.vector_norm(
                    m.float() - m.float().mean(dim=0), dim=1).cpu()
                if name in class_checks:
                    first_matrix[name] = m.detach().clone()
            return fn(m)
        return call

    cpu_bundle = make_bundle(SmallCNN(), seed=0, device="cpu")
    d = sum(int(v.numel()) for v in cpu_bundle.params.values())
    check(d == 421_642, f"SmallCNN has d={d}")
    class_api, forbidden, class_checks, fold_flags = class_api_configs(cpu_bundle.params)
    aggregators.update(class_api)
    subset = SubsetAttackPath(n, b, d)
    aggregators.update(subset.aggregators())
    results = {}
    for name, (pre, agg, kernel_keys, clip_rule) in aggregators.items():
        if name in host_reads:
            agg = reads_counted(name, agg)
        if pre is not None:
            pre = recording(name, pre)
        else:
            agg = recording(name, agg)
        comm = as_comm_precision(wire[name][0] if name in wire else None)
        # the code step of each compared step's decoded honest rows, by device
        wire_steps = {"cuda": [], "cpu": []}
        made = {}

        def build(dev, name=name, pre=pre, agg=agg, comm=comm, wire_steps=wire_steps, made=made):
            x, y = synthetic_classification(n_samples=n * batch, seed=3, device=dev)
            xs, ys = x.reshape(n, batch, 28, 28, 1), y.reshape(n, batch)
            bundle = make_bundle(SmallCNN(), seed=0, device=dev)

            def attack(honest, generator):
                if comm.enabled and len(wire_steps[dev]) < CPU_STEPS:
                    wire_steps[dev].append(code_steps(honest, comm))
                return attack_ops.sign_flip(honest.mean(dim=0))

            step, opt = build_ps_train_step(bundle, agg, cfg, attack=subset.attack(name, dev) or attack,
                                            pre_aggregate=pre, comm_precision=comm)
            state = [bundle.params, opt]
            made[dev] = (bundle, xs, ys)

            def run():
                state[0], state[1], metrics = step(state[0], state[1], xs, ys)
                if name in loops:
                    metrics["iterations"] = robust.last_iterations[loops[name]]
                subset.after_step(name, dev, metrics)
                return metrics

            def snapshot():
                return torch.cat([v.detach().reshape(-1) for v in state[0].values()]).cpu()
            return run, snapshot

        data = drive(name, build)
        card, run_counts = data["cuda"], data["cuda"]["counts"]
        for k in kernel_keys:
            check(run_counts[k] > 0, f"{name}: kernel {k} never launched on the main path")
            counts[k] += run_counts[k]
        for k in forbidden.get(name, ()):
            check(run_counts[k] == 0, f"{name}: {k} launched {run_counts[k]} times")
        if name in wire:
            per_step = wire[name][1]
            for k, v in run_counts.items():
                want = per_step.get(k, 0) * MAIN_STEPS
                check(v == want, f"{name}: {k} launched {v} times in {MAIN_STEPS} steps, not {want}")
        if name in centre_loops:
            key, most = centre_loops[name]
            others = {k: v for k, v in run_counts.items()
                      if v and k not in (key, "sorted_reduce:median")}
            check(run_counts[key] == MAIN_STEPS and not others,
                  f"{name}: {run_counts[key]} {key} launches in {MAIN_STEPS} steps, others {others}")
            reads = host_reads[name]
            check(len(reads) >= MAIN_STEPS and max(reads) <= most,
                  f"{name}: host reads per aggregation {reads}, more than {most}")
        if name in SUBSET_ATTACK_CONFIGS:
            per_step = SUBSET_ATTACK_CONFIGS[name][2]
            moved = {k: v for k, v in run_counts.items() if v}
            want = {k: v * MAIN_STEPS for k, v in per_step.items()}
            check(moved == want, f"{name}: launches {moved} in {MAIN_STEPS} steps, not {want}")
        if name in subset_reads:
            reads = host_reads[name]
            check(len(reads) >= MAIN_STEPS and all(r == subset_reads[name] for r in reads),
                  f"{name}: host reads per aggregation {reads}, not {subset_reads[name]} each")
        if name == "fold_multi_krum":
            # B5 alone, one launch a step
            others = {k: v for k, v in run_counts.items() if v and k != "selection_mean_from_gram:krum"}
            check(run_counts["selection_mean_from_gram:krum"] == MAIN_STEPS and not others,
                  f"{name}: {run_counts['selection_mean_from_gram:krum']} B5 launches in {MAIN_STEPS} "
                  f"steps, others {others}")
        slack = None
        if comm.enabled:
            steps_c = [torch.maximum(a, c) for a, c in zip(wire_steps["cuda"], wire_steps["cpu"])]
            slack = ps_wire_slack(steps_c, cfg, comm.error_feedback)
        worst, used = compare_to_cpu(name, data, slack)
        ms_step = card["ms_per_step"]
        iters = [m["iterations"] for m in card["metrics"]] if name in loops else None
        cpu_iters = [m["iterations"] for m in data["cpu"]["metrics"]] if name in loops else None
        clipped = None
        if clip_rule is not None:
            norms = first_centre_dists[name] if clip_rule == "centre" else first_norms[name]
            threshold = {"clip": MAIN_TAU, "centre": MAIN_CTAU}.get(clip_rule)
            if clip_rule == "arc":
                threshold = float(torch.sort(norms).values[preagg.arc_cut_off(n, b) - 1])
            clipped = int((norms > threshold).sum())
            check(0 < clipped < n, f"{name}: the clip took {clipped} of {n} rows at step 1")
        profile = card["profile"]
        results[name] = {
            "ms_per_step": ms_step, "first_step_ms": card["times"][0], "losses": card["losses"],
            "cpu_max_abs_param_diff": worst, "cpu_tolerance_used": used,
            "launches": {k: run_counts[k] for k in kernel_keys},
            "profile": profile,
            "device_busy_share": profile["device_ms_per_step"] / ms_step,
            "clipped_rows_step1": clipped,
            "row_norms_step1": [round(float(v), 4) for v in first_norms[name]],
            "row_dists_to_mean_step1": [round(float(v), 4) for v in first_centre_dists[name]],
            "iterations_per_step": iters,
            "cpu_iterations_per_step": cpu_iters,
            "aggregator_host_reads_per_call": host_reads.get(name),
        }
        if name in SUBSET_ATTACK_CONFIGS:
            results[name].update(subset.finish(name))
            extra_subset = {k: results[name][k] for k in (
                "selected_card", "near_ties", "runner_up_rel_gap_per_step",
                "replayed_submissions_bitwise") if k in results[name]}
            log(f"    subset/attack checks: {json.dumps(extra_subset)}")
        if name in class_checks:
            flags = list(fold_flags.get(name, []))
            check(not any(flags), f"{name}: the fold fell back to the exact path {flags}")
            results[name]["fold_nonfinite_fallbacks"] = flags or None
            results[name]["class_check"] = class_checks[name](first_matrix.pop(name))
            log(f"    class API check: {json.dumps(results[name]['class_check'])}"
                + (f", non-finite fallbacks per step {flags}" if flags else ""))
        extra = ""
        if comm.enabled:
            ef_norms = [float(m["ef_transpose_norm"]) for m in card["metrics"]
                        if "ef_transpose_norm" in m]
            if comm.error_feedback:
                check(len(ef_norms) == MAIN_STEPS and all(map(math.isfinite, ef_norms))
                      and max(ef_norms) <= 4 * ef_norms[0],
                      f"{name}: ef_transpose_norm not finite or drifting {ef_norms}")
            # the exact check, outside the counted run: the card's encode of
            # the card's step-1 raw gradient rows against the plain version's
            bundle, xs, ys = made["cuda"]
            grads, _ = vmap(grad_and_value(bundle.loss_fn), in_dims=(None, 0, 0))(
                bundle.params, xs, ys)
            rows = torch.cat([grads[k].reshape(n, -1) for k in bundle.params], dim=1)
            results[name].update(
                comm_precision=comm.mode, error_feedback=comm.error_feedback,
                launches_per_step=wire[name][1], ef_transpose_norms=ef_norms or None,
                code_step_slack_step2_max=float(slack[-1].max()),
                exact_step1=exact_encode(name, rows, comm))
            extra = (f", comm {comm.mode}{' + EF' if comm.error_feedback else ''}, exactly "
                     f"{wire[name][1]} a step, step-1 encode bitwise on {list(rows.shape)}"
                     + (f", ef_transpose_norm {[round(v, 5) for v in ef_norms]}" if ef_norms else ""))
        log(f"  {name}: {ms_step:.3f} ms/step (median of steps 2-{MAIN_STEPS}; first "
            f"{card['times'][0]:.1f} ms), losses {[round(v, 4) for v in card['losses']]}, "
            f"params vs CPU max |diff| {worst:.3g} ({used:.3g} x the tolerance), launches "
            f"{results[name]['launches']}, device busy {results[name]['device_busy_share']:.3f}, "
            f"rows clipped at step 1 {clipped} (norms {results[name]['row_norms_step1']}, "
            f"distances to the row mean {results[name]['row_dists_to_mean_step1']})"
            + (f", {loops[name]} iterations per step {iters} (CPU {cpu_iters})"
               if name in loops else "")
            + (f", host reads per aggregation {host_reads[name]}" if name in host_reads else "")
            + extra)
        log(f"    profile: {json.dumps(profile)}")
    return results


def exact_encode(name: str, rows, comm) -> dict:
    """The card's encode of ``rows`` (a matrix the round encoded on the
    card) and its decode equal the plain versions' bit for bit."""
    import torch

    from byzpy_tpu_torch.ops import codec_kernels as ck

    if comm.mode == "s4":
        d = rows.shape[1]
        codes, scales = ck.encode_rows_s4(rows, block=comm.block)
        pc, ps = ck.encode_rows_s4_plain(rows, block=comm.block)
        dec = ck.decode_rows_s4(codes, scales, block=comm.block, d=d)
        ref = ck.decode_rows_s4_plain(pc, ps, block=comm.block, d=d)
    else:
        codes, scales = ck.encode_rows(rows, block=comm.block, mode=comm.mode)
        pc, ps = ck.encode_rows_plain(rows, block=comm.block, mode=comm.mode)
        dec = ck.decode_rows(codes, scales, block=comm.block)
        ref = ck.decode_rows_plain(pc, ps, block=comm.block)
    check(torch.equal(codes.view(torch.uint8), pc.view(torch.uint8)) and bits_equal(scales, ps)
          and bits_equal(dec, ref),
          f"{name}: the card's step-1 encode differs from the plain version's")
    return {"rows": list(rows.shape), "codes_scales_decode_bitwise": True}


def gossip_path(counts: dict) -> dict:
    """The single-card gossip round on SmallCNN, 8 nodes, batch 64, the main
    path's data and weights, through :func:`drive`: each configuration
    makes exactly its listed launches a step, its losses stay finite and
    it matches the same round on the CPU, uncompressed within PARAM_RTOL /
    PARAM_ATOL, int8 within that plus, per coordinate, one code step of the
    broadcast rows a step, carried on x 1.5 a step (the wire carries
    parameters: a flipped code moves the aggregate by one code step, and
    the next half-step carries it on through the gradient). At step 1 the
    card's encode of its broadcast matrix equals the plain version's bit for
    bit."""
    import torch

    from byzpy_tpu_torch.engine.peer_to_peer import Topology
    from byzpy_tpu_torch.models import SmallCNN, make_bundle, synthetic_classification
    from byzpy_tpu_torch.ops import attack_ops, robust
    from byzpy_tpu_torch.parallel import GossipStepConfig, as_comm_precision, build_gossip_train_step

    n, b, batch = MAIN_N, MAIN_BYZ, MAIN_BATCH

    def trimmed(m):
        return robust.trimmed_mean(m, f=b)

    # name -> (comm_precision, aggregate, topology, byzantine nodes, the
    # launches each step makes, every other counter staying 0)
    configs = {
        "i_gossip_complete_trimmed": ("off", trimmed, Topology.complete(n), b, {
            "sorted_reduce:trimmed": n}),
        "j_gossip_complete_trimmed_int8": ("int8", trimmed, Topology.complete(n), b, {
            "quantize:int8": 1, "dequantize:int8": n, "sorted_reduce:trimmed": n}),
        "k_gossip_ring_median_int8": ("int8", robust.coordinate_median, Topology.ring(n, 2), 1, {
            "quantize:int8": 1, "dequantize:int8": n, "sorted_reduce:median": n}),
    }
    results = {}
    for name, (precision, agg, topo, byz, per_step) in configs.items():
        comm = as_comm_precision(precision)
        # the code step of each compared step's broadcast rows, by device,
        # and the card's step-1 broadcast
        wire_steps, first_rows = {"cuda": [], "cpu": []}, []

        def build(dev, agg=agg, topo=topo, byz=byz, comm=comm, wire_steps=wire_steps,
                  first_rows=first_rows):
            x, y = synthetic_classification(n_samples=n * batch, seed=3, device=dev)
            xs, ys = x.reshape(n, batch, 28, 28, 1), y.reshape(n, batch)
            bundle = make_bundle(SmallCNN(), seed=0, device=dev)

            def attack(honest, generator):
                out = attack_ops.sign_flip(honest.mean(dim=0))
                if comm.enabled and len(wire_steps[dev]) < CPU_STEPS:
                    rows = torch.cat([honest, out.expand(byz, -1)], dim=0)
                    wire_steps[dev].append(code_steps(rows, comm))
                    if dev == "cuda" and not first_rows:
                        first_rows.append(rows.detach().clone())
                return out

            step, init = build_gossip_train_step(bundle, agg, topo, GossipStepConfig(n, byz),
                                                 attack=attack, comm_precision=comm)
            state = [init()]

            def run():
                state[0], metrics = step(state[0], xs, ys)
                return metrics

            def snapshot():
                return state[0].detach().cpu().clone()
            return run, snapshot

        data = drive(name, build)
        card, run_counts = data["cuda"], data["cuda"]["counts"]
        for k, v in run_counts.items():
            want = per_step.get(k, 0) * MAIN_STEPS
            check(v == want, f"{name}: {k} launched {v} times in {MAIN_STEPS} steps, not {want}")
        for k in per_step:
            counts[k] += run_counts[k]
        slack, exact = None, None
        if comm.enabled:
            slack, carried = [], 0.0
            for a, c in zip(wire_steps["cuda"], wire_steps["cpu"]):
                carried = 1.5 * carried + torch.maximum(a, c)[None, :]
                slack.append(carried)
            exact = exact_encode(name, first_rows[0], comm)
        worst, used = compare_to_cpu(name, data, slack)
        ms_step, profile = card["ms_per_step"], card["profile"]
        results[name] = {
            "comm_precision": comm.mode, "n_byzantine": byz,
            "neighbourhood_sizes": [len(r) for r in topo.in_neighbor_lists(include_self=True)],
            "ms_per_step": ms_step, "first_step_ms": card["times"][0], "losses": card["losses"],
            "cpu_max_abs_param_diff": worst, "cpu_tolerance_used": used,
            "code_step_slack_step2_max": float(slack[-1].max()) if slack else None,
            "launches_per_step": per_step, "exact_step1": exact,
            "profile": profile, "device_busy_share": profile["device_ms_per_step"] / ms_step,
        }
        log(f"  {name}: {ms_step:.3f} ms/step (median of steps 2-{MAIN_STEPS}; first "
            f"{card['times'][0]:.1f} ms), losses {[round(v, 4) for v in card['losses']]}, params "
            f"vs CPU max |diff| {worst:.3g} ({used:.3g} x the tolerance), launches per step "
            f"{per_step}, device busy {results[name]['device_busy_share']:.3f}"
            + (f", step-1 encode bitwise on {exact['rows']}" if exact else ""))
        log(f"    profile: {json.dumps(profile)}")
    return results


# ---------------------------------------------------------------------------
# phase 4c: the serving round
# ---------------------------------------------------------------------------

# cohorts of the serving round, one per step (buckets 8, 8, 16, 32, 64 of
# BucketLadder(64, min_bucket=8)), cycled by the profiled steps
SERVE_COHORTS = (6, 8, 13, 29, 64)
SERVE_CAP, SERVE_MIN_BUCKET = 64, 8


def serving_configs() -> dict:
    """name -> (class factory of ``device``, the launches one serving step
    makes, a function of the step's Weiszfeld iterations)."""
    from byzpy_tpu_torch.aggregators import (
        CenteredClipping, ComparativeGradientElimination, CoordinateWiseMedian,
        CoordinateWiseTrimmedMean, GeometricMedian, MeanOfMedians, MultiKrum,
    )

    b = MAIN_BYZ
    return {
        "serve_trimmed_mean": (lambda dev: CoordinateWiseTrimmedMean(b, device=dev),
                               lambda it: {"sort_columns": 1, "segment_sum": 1}),
        "serve_median": (lambda dev: CoordinateWiseMedian(device=dev),
                         lambda it: {"sort_columns": 1}),
        # the Gram (B3), the scores' window sum and the mean
        "serve_multi_krum": (lambda dev: MultiKrum(b, 4, device=dev),
                             lambda it: {"gram": 1, "segment_sum": 2}),
        "serve_meamed": (lambda dev: MeanOfMedians(b, device=dev),
                         lambda it: {"sort_columns": 1, "segment_sum": 1}),
        "serve_cge": (lambda dev: ComparativeGradientElimination(b, device=dev),
                      lambda it: {"row_sq_dists": 1, "segment_sum": 1}),
        # the start (the masked mean), then per iteration the distances
        # and the step
        "serve_centered_clipping": (lambda dev: CenteredClipping(c_tau=MAIN_CTAU, M=10, device=dev),
                                    lambda it: {"row_sq_dists": 10, "segment_sum": 11}),
        # the start (the masked median), then per Weiszfeld iteration the
        # distances, the numerator and the denominator
        "serve_geometric_median": (lambda dev: GeometricMedian(device=dev),
                                   lambda it: {"sort_columns": 1, "row_sq_dists": it,
                                               "segment_sum": 2 * it}),
    }


def cohort_submissions(per_node, names, params, prev, xs, ys, m: int, d: int, s: int):
    """The serving round's cohort of ``m`` clients at step ``s``: client i's
    gradient is the port's per-node ``vmap(grad)`` on its own batch; every
    fourth client (i % 4 == 1) is one round stale (its gradient at the
    previous round's parameters ``prev``, submitted at round s - 1); every
    fourth (i % 4 == 3) is byzantine, the sign-flipped mean of the honest
    rows. Returns ``(submissions, the fresh honest clients' mean loss)``."""
    import torch

    from byzpy_tpu_torch.ops import attack_ops
    from byzpy_tpu_torch.serving import Submission

    def rows_at(p, idx):
        grads, losses = per_node(p, xs[idx], ys[idx])
        return torch.cat([grads[k].reshape(len(idx), -1) for k in names], dim=1), losses

    fresh = [i for i in range(m) if i % 4 != 1]
    stale = [i for i in range(m) if i % 4 == 1]
    rows = torch.empty((m, d), device="cuda")
    rows[fresh], losses = rows_at(params, fresh)
    if stale:
        rows[stale] = rows_at(prev, stale)[0]
    honest = [i for i in range(m) if i % 4 != 3]
    byz = [i for i in range(m) if i % 4 == 3]
    if byz:
        rows[byz] = attack_ops.sign_flip(rows[honest].mean(dim=0))
    subs = [Submission(client=f"c{i}", round_submitted=s - (i % 4 == 1), gradient=rows[i],
                       arrived_s=float(i)) for i in range(m)]
    return subs, float(losses[[j for j, i in enumerate(fresh) if i % 4 != 3]].mean())


def count_syncs(fn):
    """``(fn(), host reads)``: the synchronizing CUDA operations ``fn`` made,
    counted by PyTorch's sync debug mode (one warning each)."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def serving_path(counts: dict) -> dict:
    """The serving tier's bucketed round on SmallCNN (d = 421,642), for each
    configuration: per step, a cohort of ``SERVE_COHORTS[s]`` clients, each
    gradient the port's per-node ``vmap(grad)`` on its own batch of 64
    (client i's fixed batch; every fourth client, i % 4 == 1, one round
    stale: its gradient at the previous round's parameters, discounted by
    ``StalenessPolicy("exponential", gamma=0.5)``; every fourth, i % 4 ==
    3, byzantine: the sign-flipped mean of the honest rows), through
    ``build_cohort`` (``BucketLadder(64, min_bucket=8)``) and
    ``build_serving_ps_step`` with the class's ``masked_matrix_fn()``.

    The card runs ``MAIN_STEPS`` steps with the counts set to 0 just before
    and read just after: exactly the listed launches a step and no other
    (so none of B1, B4, B6, B7); then 3 more under torch.profiler. After the counted run, on
    each of the five cohorts: the padded step equals the compacted one bit
    for bit (parameters, momentum, gradient norm), ``cohort_m`` is m, and
    ``CohortAggregator.aggregate`` of the cohort, stepped by the same SGD,
    gives the step's parameters bit for bit. The CPU port's serving step
    on the card's inputs of steps 1-2 (copied to the CPU) gives the card's
    parameters within PARAM_RTOL / PARAM_ATOL (bit for bit where its kernels'
    plain versions are the kernels' bits; the CPU Gram and the Weiszfeld
    step length sum in another order). The whole round is not compared
    with a CPU round: the clients' convolution gradients differ between
    the devices by up to ~1e-5 relative, and MeaMed's selection is not
    continuous in its inputs (a swap at a near-tie moves a coordinate by
    a quarter of the swapped values' gap). The serving step alone: host
    ms per cohort size, host reads (sync debug mode) and, replayed on the
    m = 64 cohort, device ms, launches and the busy share."""
    import torch
    from torch.func import grad_and_value, vmap

    from byzpy_tpu_torch.models import SmallCNN, make_bundle, synthetic_classification
    from byzpy_tpu_torch.ops import kernels, robust
    from byzpy_tpu_torch.parallel import SGD, build_serving_ps_step
    from byzpy_tpu_torch.serving import BucketLadder, CohortAggregator, StalenessPolicy, build_cohort
    from byzpy_tpu_torch.utils import ravel_fn

    ladder = BucketLadder(SERVE_CAP, min_bucket=SERVE_MIN_BUCKET)
    policy = StalenessPolicy("exponential", gamma=0.5)
    clients = max(SERVE_COHORTS)
    x, y = synthetic_classification(n_samples=clients * MAIN_BATCH, seed=3, device="cuda")
    xs, ys = x.reshape(clients, MAIN_BATCH, 28, 28, 1), y.reshape(clients, MAIN_BATCH)
    cpu_bundle = make_bundle(SmallCNN(), seed=0, device="cpu")
    results = {}
    for name, (make, per_step) in serving_configs().items():
        bundle = make_bundle(SmallCNN(), seed=0, device="cuda")
        agg = make(None)
        step, opt0 = build_serving_ps_step(bundle, agg.masked_matrix_fn())
        per_node = vmap(grad_and_value(bundle.loss_fn), in_dims=(None, 0, 0))
        ravel, _ = ravel_fn(bundle.params)
        names = list(bundle.params)
        d = sum(int(v.numel()) for v in bundle.params.values())
        state = {"params": bundle.params, "prev": bundle.params, "opt": opt0, "s": 0}
        record = []

        def run():
            s = state["s"]
            m = SERVE_COHORTS[s % len(SERVE_COHORTS)]
            subs, loss = cohort_submissions(per_node, names, state["params"], state["prev"], xs, ys,
                                            m, d, s)
            cohort = build_cohort(subs, s, ladder, policy)
            inputs = (state["params"], state["opt"], cohort.matrix,
                      torch.from_numpy(cohort.valid).cuda(), torch.from_numpy(cohort.weights).cuda())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (params, opt, metrics), reads = count_syncs(lambda: step(*inputs))
            torch.cuda.synchronize()
            metrics = dict(metrics, m=m, bucket=cohort.bucket, host_reads=reads,
                           serve_ms=(time.perf_counter() - t0) * 1e3, honest_loss=loss,
                           iterations=robust.last_iterations["geometric_median"])
            if len(record) < MAIN_STEPS:
                record.append((inputs, cohort, params, opt, metrics))
            state.update(prev=state["params"], params=params, opt=opt, s=s + 1)
            return metrics

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        times, metrics = [], []
        for _ in range(MAIN_STEPS):
            t0 = time.perf_counter()
            metrics.append(run())
            times.append((time.perf_counter() - t0) * 1e3)
        run_counts = dict(kernels.launch_counts)
        round_profile = profile_steps(run)
        losses = [mt["honest_loss"] for mt in metrics]
        check(all(map(math.isfinite, losses)), f"{name}: loss not finite {losses}")
        iters = [mt["iterations"] for mt in metrics] if name == "serve_geometric_median" else None
        want = {}
        for mt in metrics:
            for k, v in per_step(mt["iterations"]).items():
                want[k] = want.get(k, 0) + v
        for k, v in run_counts.items():
            check(v == want.get(k, 0),
                  f"{name}: {k} launched {v} times in {MAIN_STEPS} steps, not {want.get(k, 0)}")
        for k, v in want.items():
            counts[k] += v
        # the checks, outside the counted run
        checks = []
        for inputs, cohort, p_pad, o_pad, m_pad in record:
            params, opt, matrix, valid, weights = inputs
            m = cohort.m
            check(int(m_pad["cohort_m"]) == m, f"{name}: cohort_m {int(m_pad['cohort_m'])} != {m}")
            p_c, o_c, m_c = step(params, opt, matrix[:m].contiguous(), valid[:m].contiguous(),
                                 weights[:m].contiguous())
            same = (bits_equal(ravel(p_pad), ravel(p_c)) and bits_equal(o_pad["trace"], o_c["trace"])
                    and bits_equal(m_pad["agg_grad_norm"], m_c["agg_grad_norm"]))
            check(same, f"{name}: the padded step at m={m} (bucket {cohort.bucket}) differs from "
                  f"the compacted one")
            via_cohort = CohortAggregator(agg).aggregate(cohort)
            p_ca, _ = SGD(0.05, momentum=0.9).step(ravel(params), via_cohort, opt)
            check(bits_equal(p_ca, ravel(p_pad)),
                  f"{name}: CohortAggregator.aggregate at m={m} does not give the step's parameters")
            checks.append({"m": m, "bucket": cohort.bucket, "padded_equals_compacted": True,
                           "cohort_aggregator_equals_step": True})
        # the CPU port's serving step on the card's inputs of steps 1-2
        cpu_step, _ = build_serving_ps_step(cpu_bundle, make("cpu").masked_matrix_fn())
        worst, used, bitwise, cpu_iters = 0.0, 0.0, [], []
        for inputs, cohort, p_pad, _, _ in record[:CPU_STEPS]:
            params, opt, matrix, valid, weights = inputs
            on_cpu = lambda t: {k: v.cpu() for k, v in t.items()}  # noqa: E731
            p_cpu, _, _ = cpu_step(on_cpu(params), on_cpu(opt), matrix.cpu(), valid.cpu(),
                                   weights.cpu())
            cpu_iters.append(robust.last_iterations["geometric_median"])
            g, c = ravel(p_pad).cpu(), ravel(p_cpu)
            diff = (g - c).abs()
            share = float((diff / (PARAM_ATOL + PARAM_RTOL * c.abs())).max())
            check(share <= 1.0, f"{name}: the CPU port's step on the card's cohort at m={cohort.m} "
                  f"differs (max |diff| {float(diff.max()):.3g}, {share:.3g} x the tolerance)")
            worst, used = max(worst, float(diff.max())), max(used, share)
            bitwise.append(bits_equal(g, c))
        # the serving step alone, replayed on the m = 64 cohort
        inputs = record[-1][0]
        replay = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*inputs)
            torch.cuda.synchronize()
            replay.append((time.perf_counter() - t0) * 1e3)
        replay_ms = sorted(replay)[2]
        serve_profile = profile_steps(lambda: step(*inputs))
        record.clear()
        ms_step = sorted(times[1:])[len(times[1:]) // 2]
        results[name] = {
            "cohorts": [[mt["m"], mt["bucket"]] for mt in metrics],
            "round_ms_per_step": ms_step,
            "serving_step_ms": [round(mt["serve_ms"], 4) for mt in metrics],
            "host_reads_per_step": [mt["host_reads"] for mt in metrics],
            "iterations_per_step": iters,
            "cpu_iterations_steps_1_2": cpu_iters if iters else None,
            "losses": losses, "cpu_same_inputs_max_abs_param_diff": worst,
            "cpu_tolerance_used": used, "cpu_same_inputs_bitwise": bitwise,
            "launches": {k: v for k, v in run_counts.items() if v},
            "checks": checks,
            "round_profile": round_profile,
            "round_device_busy_share": round_profile["device_ms_per_step"] / ms_step,
            "serving_step_at_64": {
                "ms": replay_ms, "profile": serve_profile,
                "device_busy_share": serve_profile["device_ms_per_step"] / replay_ms,
            },
        }
        log(f"  {name}: cohorts {results[name]['cohorts']}, serving step ms "
            f"{results[name]['serving_step_ms']}, host reads per step "
            f"{results[name]['host_reads_per_step']}, launches {results[name]['launches']}"
            + (f", Weiszfeld iterations {iters} (CPU on steps 1-2 {cpu_iters})" if iters else "")
            + f"; padded == compacted and CohortAggregator == step bitwise at every cohort; the "
            f"CPU port on the card's inputs of steps 1-2: max |diff| {worst:.3g} ({used:.3g} x the "
            f"tolerance), bitwise {bitwise}; round {ms_step:.3f} ms/step, losses "
            f"{[round(v, 4) for v in losses]}; serving step at m = 64 {replay_ms:.3f} ms, device "
            f"{serve_profile['device_ms_per_step']:.4f} ms, busy "
            f"{results[name]['serving_step_at_64']['device_busy_share']:.3f}")
        log(f"    serving step profile at m = 64: {json.dumps(serve_profile)}")
        del bundle, agg, step, state
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 4d: the ragged door
# ---------------------------------------------------------------------------

# (m): one cohort a step in a flat capacity of 64 (SERVE_COHORTS' sizes)
RAGGED_CAP = 64
# (n): one dispatch of four tenants' cohorts, 112 rows in a capacity of 128
EXEC_COHORTS = (6, 13, 29, 64)
EXEC_CAP, EXEC_MAX_COHORTS = 128, 4
INGRESS = ("dense", "int8", "fp8", "s4")
DECODE_KEY = {"int8": "dequantize:int8", "fp8": "dequantize:fp8", "s4": "dequantize:s4"}


def ragged_step_configs() -> dict:
    """(m)'s configurations: name -> (class factory of ``device``, the
    launches one ragged step makes). The sort family takes its segmented
    program (one segmented sort-reduce, no B2 or B11); MeaMed the generic
    door (its masked program: B2, then B11 under its window)."""
    from byzpy_tpu_torch.aggregators import (
        ComparativeGradientElimination, CoordinateWiseMedian, CoordinateWiseTrimmedMean,
        MeanOfMedians, MultiKrum,
    )

    b = MAIN_BYZ
    return {
        "ragged_trimmed_mean": (lambda dev: CoordinateWiseTrimmedMean(b, device=dev),
                                {"segmented_sort_reduce": 1}),
        "ragged_median": (lambda dev: CoordinateWiseMedian(device=dev), {"segmented_sort_reduce": 1}),
        # the shared Gram, the scores' window sum and the mean
        "ragged_multi_krum": (lambda dev: MultiKrum(b, 4, device=dev), {"gram": 1, "segment_sum": 2}),
        "ragged_cge": (lambda dev: ComparativeGradientElimination(b, device=dev),
                       {"row_sq_dists": 1, "segment_sum": 1}),
        "ragged_meamed": (lambda dev: MeanOfMedians(b, device=dev), {"sort_columns": 1, "segment_sum": 1}),
    }


def ragged_step_path(counts: dict) -> dict:
    """(m) ``build_ragged_serving_ps_step`` on SmallCNN (d = 421,642): per
    step the serving round's cohort (``cohort_submissions``: 6, 8, 13, 29,
    64 clients, every fourth stale, every fourth byzantine) in a flat
    capacity of 64. Each step makes exactly its listed launches (counts set
    to 0 just before the ragged step and read just after) and no host read
    (sync debug mode); its parameters, momentum and gradient norm equal,
    bit for bit, ``build_serving_ps_step``'s on the same cohort in its
    bucket (``BucketLadder(64, min_bucket=8)``) from the same state. Then
    the ragged step alone, replayed on the m = 64 cohort: host ms (median
    of 5), device ms, launches and busy share (torch.profiler)."""
    import torch
    from torch.func import grad_and_value, vmap

    from byzpy_tpu_torch.models import SmallCNN, make_bundle, synthetic_classification
    from byzpy_tpu_torch.ops import kernels
    from byzpy_tpu_torch.parallel import build_ragged_serving_ps_step, build_serving_ps_step
    from byzpy_tpu_torch.serving import BucketLadder, StalenessPolicy, build_cohort
    from byzpy_tpu_torch.utils import ravel_fn

    ladder = BucketLadder(SERVE_CAP, min_bucket=SERVE_MIN_BUCKET)
    policy = StalenessPolicy("exponential", gamma=0.5)
    clients = max(SERVE_COHORTS)
    x, y = synthetic_classification(n_samples=clients * MAIN_BATCH, seed=3, device="cuda")
    xs, ys = x.reshape(clients, MAIN_BATCH, 28, 28, 1), y.reshape(clients, MAIN_BATCH)
    results = {}
    for name, (make, per_step) in ragged_step_configs().items():
        bundle = make_bundle(SmallCNN(), seed=0, device="cuda")
        agg = make(None)
        rstep, opt = build_ragged_serving_ps_step(bundle, agg.ragged_matrix_fn(), row_capacity=RAGGED_CAP)
        bstep, _ = build_serving_ps_step(bundle, agg.masked_matrix_fn())
        per_node = vmap(grad_and_value(bundle.loss_fn), in_dims=(None, 0, 0))
        ravel, _ = ravel_fn(bundle.params)
        names = list(bundle.params)
        d = sum(int(v.numel()) for v in bundle.params.values())
        params = prev = bundle.params
        steps, losses = [], []
        for s in range(MAIN_STEPS):
            m = SERVE_COHORTS[s % len(SERVE_COHORTS)]
            subs, loss = cohort_submissions(per_node, names, params, prev, xs, ys, m, d, s)
            cohort = build_cohort(subs, s, None, policy)
            bucketed = build_cohort(subs, s, ladder, policy)
            flat = torch.zeros((RAGGED_CAP, d), device="cuda")
            flat[:m] = cohort.matrix
            weights = torch.zeros(RAGGED_CAP, device="cuda")
            weights[:m] = torch.from_numpy(cohort.weights).cuda()
            inputs = (params, opt, flat, torch.zeros(1, dtype=torch.int32, device="cuda"),
                      torch.tensor([m], dtype=torch.int32, device="cuda"), weights)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            (p_r, o_r, m_r), reads = count_syncs(lambda: rstep(*inputs))
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            run_counts = dict(kernels.launch_counts)
            for k, v in run_counts.items():
                check(v == per_step.get(k, 0),
                      f"{name}: {k} launched {v} times in the step at m={m}, not {per_step.get(k, 0)}")
                counts[k] += v
            check(reads == 0, f"{name}: {reads} host reads in the step at m={m}")
            check(int(m_r["cohort_m"]) == m, f"{name}: cohort_m {int(m_r['cohort_m'])} != {m}")
            p_b, o_b, m_b = bstep(params, opt, bucketed.matrix, torch.from_numpy(bucketed.valid).cuda(),
                                  torch.from_numpy(bucketed.weights).cuda())
            check(bits_equal(ravel(p_r), ravel(p_b)) and bits_equal(o_r["trace"], o_b["trace"])
                  and bits_equal(m_r["agg_grad_norm"], m_b["agg_grad_norm"]),
                  f"{name}: the ragged step at m={m} differs from the bucketed step in bucket "
                  f"{bucketed.bucket}")
            steps.append({"m": m, "bucket": bucketed.bucket, "ms": round(step_ms, 4), "host_reads": reads})
            losses.append(loss)
            prev, params, opt = params, p_r, o_r
        check(all(map(math.isfinite, losses)), f"{name}: loss not finite {losses}")
        replay = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rstep(*inputs)
            torch.cuda.synchronize()
            replay.append((time.perf_counter() - t0) * 1e3)
        replay_ms = sorted(replay)[2]
        profile = profile_steps(lambda: rstep(*inputs))
        results[name] = {
            "steps": steps, "launches_per_step": per_step, "losses": losses,
            "ragged_equals_bucketed_bitwise": True,
            "step_at_64": {"ms": replay_ms, "profile": profile,
                           "device_busy_share": profile["device_ms_per_step"] / replay_ms},
        }
        log(f"  (m) {name}: steps {steps}, exactly {per_step} a step, 0 host reads, parameters == "
            f"the bucketed step's bitwise at every cohort; losses {[round(v, 4) for v in losses]}; "
            f"step at m = 64 {replay_ms:.3f} ms, device {profile['device_ms_per_step']:.4f} ms, busy "
            f"{results[name]['step_at_64']['device_busy_share']:.3f}")
        log(f"    profile at m = 64: {json.dumps(profile)}")
        del bundle, agg, rstep, bstep, inputs, flat
        torch.cuda.empty_cache()
    return results


def executor_configs() -> dict:
    """(n)'s aggregators: name -> class factory of ``device``."""
    from byzpy_tpu_torch.aggregators import (
        ComparativeGradientElimination, CoordinateWiseMedian, CoordinateWiseTrimmedMean, MultiKrum,
    )

    b = MAIN_BYZ
    return {
        "multi_krum": lambda dev: MultiKrum(b, 4, device=dev),
        "cge": lambda dev: ComparativeGradientElimination(b, device=dev),
        "trimmed_mean": lambda dev: CoordinateWiseTrimmedMean(b, device=dev),
        "median": lambda dev: CoordinateWiseMedian(device=dev),
    }


def executor_launches(name: str, mode: str) -> dict:
    """The launches one (n) dispatch makes: the decode of a quantized batch,
    the program's kernels (Multi-Krum's and CGE's contraction over the
    scaled rows B12 for a quantized batch, else B11; the sort family's
    segmented program one segmented sort-reduce for all cohorts, no B2 or
    B11) and the evidence's two row reductions."""
    q = mode != "dense"
    final = {f"segment_sum_dequant:{mode}": 1} if q else {"segment_sum": 1}
    out = {
        "multi_krum": {"gram": 1, "segment_sum": 1, "row_sq_dists": 2},
        "cge": {"row_sq_dists": 3},
        "trimmed_mean": {"segmented_sort_reduce": 1, "row_sq_dists": 2},
        "median": {"segmented_sort_reduce": 1, "row_sq_dists": 2},
    }[name]
    if name in ("multi_krum", "cge"):
        for k, v in final.items():
            out[k] = out.get(k, 0) + v
    if q:
        out[DECODE_KEY[mode]] = 1
    return out


def ragged_executor_path(counts: dict) -> dict:
    """(n) ``RaggedExecutor`` (capacity 128, 4 cohorts, evidence on): one
    dispatch of four tenants' cohorts of 6, 13, 29 and 64 SmallCNN client
    gradients (each client its own batch of 64 at the initial parameters;
    every fourth one round stale, every fourth byzantine), for each ingress
    (dense rows; int8, fp8 and s4 wire rows, each cohort encoded on the card
    by ``encode_blockwise``, B13, B15, B16: one launch a cohort) and each of
    Multi-Krum, CGE, the trimmed mean and the median. Each dispatch makes
    exactly ``executor_launches`` (so a quantized Multi-Krum or CGE dispatch
    one decode and one B12, and no B11 for its final contraction); every
    cohort's vector equals, bit for bit, ``CohortAggregator.aggregate`` of
    that cohort alone and, for a quantized batch, the dense program fed the
    decoded rows; for s4, the CPU port's executor on the card's inputs gives
    the same bits. Per configuration: host ms (median of 3 replays), the
    synchronizing operations of a dispatch (sync debug mode), device ms,
    launches and busy share (torch.profiler)."""
    import dataclasses

    import torch
    from torch.func import grad_and_value, vmap

    from byzpy_tpu_torch.engine.actor import wire
    from byzpy_tpu_torch.models import SmallCNN, make_bundle, synthetic_classification
    from byzpy_tpu_torch.ops import attack_ops, kernels
    from byzpy_tpu_torch.parallel import CommPrecision, encode_blockwise
    from byzpy_tpu_torch.serving import (
        CohortAggregator, RaggedExecutor, StalenessPolicy, Submission, build_cohort,
    )

    policy = StalenessPolicy("exponential", gamma=0.5)
    bundle = make_bundle(SmallCNN(), seed=0, device="cuda")
    per_node = vmap(grad_and_value(bundle.loss_fn), in_dims=(None, 0, 0))
    x, y = synthetic_classification(n_samples=sum(EXEC_COHORTS) * MAIN_BATCH, seed=5, device="cuda")
    xs, ys = x.reshape(-1, MAIN_BATCH, 28, 28, 1), y.reshape(-1, MAIN_BATCH)
    cohort_rows, first = [], 0
    for m in EXEC_COHORTS:
        grads, _ = per_node(bundle.params, xs[first:first + m], ys[first:first + m])
        rows = torch.cat([grads[k].reshape(m, -1) for k in bundle.params], dim=1)
        byz = [i for i in range(m) if i % 4 == 3]
        rows[byz] = attack_ops.sign_flip(rows[[i for i in range(m) if i % 4 != 3]].mean(dim=0))
        cohort_rows.append(rows)
        first += m
    del grads, x, y, xs, ys
    d = cohort_rows[0].shape[1]
    tenants = [f"t{k}" for k in range(len(EXEC_COHORTS))]
    results = {}
    for mode in INGRESS:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        cohorts = []
        for k, rows in enumerate(cohort_rows):
            if mode == "dense":
                grads = [rows[i] for i in range(rows.shape[0])]
            else:
                enc = encode_blockwise(rows, CommPrecision(mode))
                codes = enc.values if mode in ("int8", "s4") else enc.values.view(torch.uint8)
                grads = [wire.QuantizedWireArray(mode, codes[i], enc.scales[i], enc.block, (d,), "float32")
                         for i in range(rows.shape[0])]
            subs = [Submission(f"{tenants[k]}/c{i}", 4 if i % 4 == 1 else 5, g, float(i))
                    for i, g in enumerate(grads)]
            cohorts.append(build_cohort(subs, 5, None, policy, quantized=True))
        enc_counts = dict(kernels.launch_counts)
        want = {} if mode == "dense" else {f"quantize:{mode}": len(EXEC_COHORTS)}
        check(all(v == want.get(k, 0) for k, v in enc_counts.items()),
              f"(n) {mode}: the clients' encodes launched {enc_counts}, not {want}")
        check(all(c.quantized == (mode != "dense") for c in cohorts), f"(n) {mode}: cohort layout")
        for k, v in enc_counts.items():
            counts[k] += v
        for name, make in executor_configs().items():
            agg = make(None)
            ex = RaggedExecutor(agg, d, EXEC_CAP, EXEC_MAX_COHORTS)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            views, syncs = count_syncs(lambda: ex.aggregate(cohorts, tenants))
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            run_counts = dict(kernels.launch_counts)
            per = executor_launches(name, mode)
            for k, v in run_counts.items():
                check(v == per.get(k, 0), f"(n) {mode} {name}: {k} launched {v} times, not {per.get(k, 0)}")
                counts[k] += v
            check(ex.quantized_dispatches == (mode != "dense") and ex.dispatches == 1,
                  f"(n) {mode} {name}: dispatch counters")
            # the checks, outside the counted dispatch
            for view, cohort in zip(views, cohorts):
                check(bits_equal(view.vector, CohortAggregator(agg).aggregate(cohort)),
                      f"(n) {mode} {name}: cohort of {cohort.m} differs from CohortAggregator")
            if mode != "dense":
                dense = [dataclasses.replace(c, dense=c.matrix, qcodes=None, qscales=None, qmode=None)
                         for c in cohorts]
                for view, dv in zip(views, ex.aggregate(dense, tenants)):
                    check(bits_equal(view.vector, dv.vector),
                          f"(n) {mode} {name}: differs from the dense program on the decoded rows")
            cpu_bitwise = None
            if mode == "s4":
                on_cpu = [dataclasses.replace(c, dense=None, qcodes=c.qcodes.cpu(), qscales=c.qscales.cpu())
                          for c in cohorts]
                cpu_views = RaggedExecutor(make("cpu"), d, EXEC_CAP, EXEC_MAX_COHORTS).aggregate(on_cpu, tenants)
                for view, cv in zip(views, cpu_views):
                    check(bits_equal(view.vector.cpu(), cv.vector),
                          f"(n) {mode} {name}: the CPU port differs on the card's inputs")
                cpu_bitwise = True
            replay = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ex.aggregate(cohorts, tenants)
                torch.cuda.synchronize()
                replay.append((time.perf_counter() - t0) * 1e3)
            host_ms = sorted(replay)[1]
            profile = profile_steps(lambda: ex.aggregate(cohorts, tenants))
            key = f"{mode}_{name}"
            results[key] = {
                "cohorts": list(EXEC_COHORTS), "launches": per, "syncs_per_dispatch": syncs,
                "first_dispatch_ms": first_ms, "host_ms": host_ms, "profile": profile,
                "device_busy_share": profile["device_ms_per_step"] / host_ms,
                "cohort_aggregator_bitwise": True,
                "dense_program_on_decoded_rows_bitwise": mode != "dense" or None,
                "cpu_port_bitwise": cpu_bitwise,
            }
            log(f"  (n) {key}: exactly {per}, {syncs} synchronizing operations, every cohort == "
                f"CohortAggregator bitwise" + ("" if mode == "dense" else
                                               ", == the dense program on the decoded rows bitwise")
                + (", == the CPU port bitwise" if cpu_bitwise else "")
                + f"; dispatch {host_ms:.3f} ms (first {first_ms:.1f}), device "
                f"{profile['device_ms_per_step']:.4f} ms, busy {results[key]['device_busy_share']:.3f}")
            log(f"    profile: {json.dumps(profile)}")
            del views, ex, agg
        del cohorts
        torch.cuda.empty_cache()
    return results


PORT_KERNELS = ("sorted_reduce_kernel", "gram_partial_kernel", "gram_reduce_kernel",
                "selection_weights_kernel", "weighted_rows_kernel", "selection_mean_from_gram_kernel",
                "nnm_weights_kernel",
                "mix_rows_kernel", "nnm_selection_weights_kernel", "clip_selection_weights_kernel",
                "meamed_kernel", "center_loop_kernel", "quantize_kernel", "dequantize_kernel",
                "sort_columns_kernel", "segment_sum_kernel", "row_sq_partial_kernel",
                "row_sq_reduce_kernel", "quantize_s4_kernel", "dequantize_s4_kernel",
                "segment_sum_dequant_kernel", "segmented_sort_reduce_kernel")


def device_events(prof, calls: int) -> dict:
    """``{kernel: (device ms, launches)}`` per call from a torch.profiler
    profile of ``calls`` calls: device-side events only (an operator's row
    repeats its kernels' time)."""
    from torch.autograd import DeviceType

    by_kernel = {}
    for ev in prof.key_averages():
        # a record_function range (the serving step's stages) shows on the
        # device too: its time is its kernels', already counted
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False) \
                or ev.key.startswith("serving."):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        by_kernel[ev.key] = (dev_us / 1e3 / calls, ev.count / calls)
    return by_kernel


def port_part(by_kernel: dict) -> dict:
    """The port's kernels among ``device_events``'s, summed by kernel."""
    ours = {}
    for key, (ms, count) in by_kernel.items():
        for p in PORT_KERNELS:
            if re.search(rf"\b{p}\b", key):  # selection_weights_kernel is in nnm_selection_...
                ms0, count0 = ours.get(p, (0.0, 0.0))
                ours[p] = (ms0 + ms, count0 + count)
    return ours


def profile_steps(run, steps: int = 3) -> dict:
    """Device time of ``steps`` calls of ``run`` (one training step each)
    by kernel (torch.profiler): the total, the port's kernels' part, the
    launches and the largest kernels. The profiler slows the host, so the
    busy share divides by the unprofiled step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = device_events(prof, steps)
    ours = port_part(by_kernel)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    return {
        "profiled_wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": sum(v[0] for v in by_kernel.values()),
        "port_kernels_ms_per_step": sum(v[0] for v in ours.values()),
        "port_kernels": {p: [ms, count] for p, (ms, count) in ours.items()},
        "device_launches_per_step": sum(v[1] for v in by_kernel.values()),
        "top": [[k[:60], round(v[0], 4), v[1]] for k, v in top],
    }


def port_device_ms(fn, calls: int = 10) -> dict:
    """Device time per launch of each port kernel that ``fn()`` launches
    once a call (torch.profiler): the card's time without the host's
    launch gaps, which CUDA events of a short call include. Divided by the
    launches the profiler recorded, not by ``calls``: a profile can miss
    some (one H100 run recorded 4 of 10 launches of one kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile that recorded none of the launches is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {p: ms / count for p, (ms, count) in port_part(device_events(prof, calls)).items()
               if count}
        if out:
            return out
    return out


def kernel_device_ms(fn, name: str, calls: int = 10) -> float:
    """``port_device_ms(fn)[name]``, profiled again (five profiles in all)
    while a profile recorded no launch of ``name``: the device profile of a
    short call can miss its launches."""
    for _ in range(5):
        out = port_device_ms(fn, calls)
        if name in out:
            return out[name]
    check(False, f"torch.profiler recorded no {name} launch in five profiles")


# ---------------------------------------------------------------------------
# phase 5: kernel timing
# ---------------------------------------------------------------------------


def bound_ms(bytes_moved: float, ops: float, minmax: float = 0.0):
    """The least time for ``bytes_moved`` bytes, ``ops`` f32 operations and
    ``minmax`` int32 min/max operations: the larger of the bytes over the
    memory rate and the operations over their rates (the f32 and integer
    pipes run side by side, so their times do not add)."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = max(ops / PEAK_F32_OPS_PER_S, minmax / PEAK_INT_MINMAX_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sort_exchanges(m: int) -> int:
    """Compare-exchanges a column of ``m`` rows needs: Batcher's network at
    the width that holds m (19, 63, 191, 543 and 1,471 at 8-128 rows), as
    B2's and B6's bounds count them. The engine (``csrc/column_sort.cuh``)
    runs more above 64 rows (two runs of 64 and a bitonic merge: 1,534);
    the bound counts what the function needs."""
    from byzpy_tpu_torch.ops import kernels

    return len(kernels.batcher_pairs(kernels.network_width(m)))


def sorted_reduce_times(n: int, d: int, *, f_trim: int, seed: int, x=None) -> dict:
    """B1 (median, and trimmed mean at ``f_trim``) on one (1, n, d) f32
    round: CUDA events, torch.profiler device ms, the plain version and the
    bound (the rows read once, the engine's compare-exchanges at the int32
    rate)."""
    from byzpy_tpu_torch.ops import kernels

    x = random_rounds((1, n, d), seed=seed) if x is None else x
    isz = x.element_size()
    out = {}
    sort_ops = 2 * sort_exchanges(n) * d  # one int32 min and one max per compare-exchange
    for mode, f in (("median", 0), ("trimmed", f_trim)):
        # the median's add and multiply, or the window's adds and a divide
        adds = 2 * d if mode == "median" else (n - 2 * f + 1) * d
        b_ms, b_by = bound_ms(n * d * isz + d * isz, adds, sort_ops)
        kern = lambda mode=mode, f=f: kernels.sorted_reduce_stream(x, mode=mode, f=f)  # noqa: E731
        out[f"sorted_reduce:{mode}"] = {
            "ms": cuda_time_ms(kern), "device_ms": port_device_ms(kern),
            "plain_ms": cuda_time_ms(lambda: kernels.sorted_reduce_stream_plain(x, mode=mode, f=f), iters=3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "shape": [1, n, d], "f": f,
        }
    return out


def kernel_times(n: int, d: int, *, f_trim: int, f_krum: int, q: int, seed: int) -> dict:
    """Each kernel's time on one (1, n, d) f32 round beside its bound, its
    plain version and, where one exists, a single PyTorch call."""
    import torch

    from byzpy_tpu_torch.ops import kernels, robust

    x = random_rounds((1, n, d), seed=seed)
    isz = x.element_size()
    out = sorted_reduce_times(n, d, f_trim=f_trim, seed=seed, x=x)
    # B4's two launches on the kernel Gram of x: the weights read only the
    # (n, n) Gram; the sweep reads only the q selected rows
    g = kernels.gram(x)
    w = kernels.selection_weights(g, f=f_krum, q=q, mode="krum")
    npad = kernels.network_width(n)
    weight_ops = (5 * n * n  # d2 (add, mul, sub, clamp) and the rank compares
                  + 2 * len(kernels.batcher_pairs(npad)) * n + (n - f_krum - 1) * n)
    b_ms, b_by = bound_ms(n * n * 4 + n * 4, weight_ops)

    def plain_pipeline():
        wp = kernels.selection_weights_plain(kernels.gram_plain(x), f=f_krum, q=q, mode="krum")
        return kernels.weighted_rows_plain(x, wp)

    out["selection_weights:krum"] = {
        "ms": cuda_time_ms(lambda: kernels.selection_weights(g, f=f_krum, q=q, mode="krum")),
        "plain_ms": cuda_time_ms(lambda: kernels.selection_weights_plain(g, f=f_krum, q=q, mode="krum")),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "shape": [1, n, d],
        # the whole B4 call (B3 Gram, weights, sweep) beside the plain pipeline
        "selection_mean_ms": cuda_time_ms(
            lambda: kernels.selection_mean_stream(x, f=f_krum, q=q, mode="krum")),
        "selection_mean_plain_ms": cuda_time_ms(plain_pipeline, iters=3),
    }
    # CGE's and MoNNA's weights (f = 0, q = n - f, as robust.cge / monna
    # call them): the scores read the Gram's diagonal (and MoNNA the
    # reference row), then n^2 rank compares
    for mode, score_reads, score_ops in (("cge", n, 0), ("monna", 2 * n, 3 * n)):
        sel = dict(f=0, q=n - f_krum, mode=mode)
        b_ms, b_by = bound_ms(score_reads * 4 + n * 4, score_ops + n * n)
        whole = {"cge": lambda: robust.cge(x[0], f=f_krum),
                 "monna": lambda: robust.monna(x[0], f=f_krum)}[mode]
        out[f"selection_weights:{mode}"] = {
            "ms": cuda_time_ms(lambda sel=sel: kernels.selection_weights(g, **sel)),
            "plain_ms": cuda_time_ms(lambda sel=sel: kernels.selection_weights_plain(g, **sel)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "shape": [1, n, d],
            f"{mode}_ms": cuda_time_ms(whole),
        }
    b_ms, b_by = bound_ms(q * d * isz + n * 4 + d * isz, 2 * q * d)
    out["weighted_rows"] = {
        "ms": cuda_time_ms(lambda: kernels.weighted_rows(x, w)),
        "device_ms": kernel_device_ms(lambda: kernels.weighted_rows(x, w), "weighted_rows_kernel"),
        "plain_ms": cuda_time_ms(lambda: kernels.weighted_rows_plain(x, w), iters=3),
        # w @ x: the same function on these finite inputs (it reads all n rows)
        "library_ms": cuda_time_ms(lambda: w[0] @ x[0]),
        "bound_ms": b_ms, "bound_by": b_by, "shape": [1, n, d],
    }
    if n % 2:  # torch.median returns the lower middle value: the same function only at odd n
        out["sorted_reduce:median"]["library_ms"] = cuda_time_ms(lambda: torch.median(x[0], dim=0))
    for k, v in out.items():
        log(f"  {k} {v['shape']}: {v['ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
            f"({v['bound_by']}), plain {v['plain_ms']:.4f} ms, library {v['library_ms']}")
    del x
    torch.cuda.empty_cache()
    return out


def mix_rows_times(x, mask, st, k: int) -> dict:
    """B8's mixing sweep on one ``(1, n, d)`` round: CUDA events, the
    device time by torch.profiler, the plain version, ``(mask^T x) / k``
    in ``x``'s dtype (the same function on these finite inputs; in bf16 a
    tensor-core product with its own roundings) and the
    bound (read x, the mask and the taint flags, write the mixed rows; n k
    d selected adds)."""
    from byzpy_tpu_torch.ops import kernels

    _, n, d = x.shape
    b_ms, b_by = bound_ms(2 * n * d * x.element_size() + n * n * 4 + n * 4, n * k * d)
    m = mask[0].T.to(x.dtype)
    return {
        "ms": cuda_time_ms(lambda: kernels.mix_rows(x, mask, st, k=k)),
        "device_ms": kernel_device_ms(lambda: kernels.mix_rows(x, mask, st, k=k), "mix_rows_kernel"),
        "plain_ms": cuda_time_ms(lambda: kernels.mix_rows_plain(x, mask, st, k=k), iters=3),
        "library_ms": cuda_time_ms(lambda: (m @ x[0]) / k),
        "bound_ms": b_ms, "bound_by": b_by, "shape": [1, n, d], "dtype": str(x.dtype).split(".")[-1],
    }


def b9_weights_times(g, n: int, *, f_pre: int, f: int, q: int) -> dict:
    """B9's weights (krum) on the Gram ``g`` of one round of ``n`` rows:
    CUDA events, torch.profiler device ms (the call is shorter than a
    launch gap), the plain version and the bound: the Gram read once; a
    column sort a node and d2 for NNM's selection, GA's and Gm's k selected
    adds an entry, w_eff's k a row and the Krum scores."""
    from byzpy_tpu_torch.ops import kernels

    k = n - f_pre
    sel = dict(f=f, q=q, mode="krum")
    pairs = len(kernels.batcher_pairs(kernels.network_width(n)))
    select_ops = 2 * pairs * n + 5 * n * n
    krum_ops = select_ops + (n - f - 1) * n
    b_ms, b_by = bound_ms(n * n * 4 + n * 4, krum_ops + 2 * n * n * k + n * k)
    call = lambda: kernels.nnm_selection_weights(g, k=k, **sel)  # noqa: E731
    return {
        "ms": cuda_time_ms(call), "device_ms": kernel_device_ms(call, "nnm_selection_weights_kernel"),
        "plain_ms": cuda_time_ms(lambda: kernels.nnm_selection_weights_plain(g, k=k, **sel)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "f_nnm": f_pre, "f": f, "q": q,
    }


# An empty kernel, launched with a weights block's threads and dynamic
# shared memory: the floor of such a launch on the card
EMPTY_BLOCK_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_block_kernel() {}
extern "C" int byz_empty_block(int threads, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&empty_block_kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  empty_block_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
"""
@functools.lru_cache(maxsize=None)
def empty_block_fn():
    """The C entry point of EMPTY_BLOCK_CU, built with the port's flags."""
    import ctypes

    from byzpy_tpu_torch.ops import _build

    out_dir = _build.BUILD_ROOT / "chip_smoke_empty_block"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "empty_block.cu").write_text(EMPTY_BLOCK_CU)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / "libempty_block.so"),
                    str(out_dir / "empty_block.cu")], check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(out_dir / "libempty_block.so")).byz_empty_block
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def empty_block_ms(threads: int, smem: int) -> float:
    """Device ms (torch.profiler) of one block of ``threads`` threads with
    ``smem`` bytes of dynamic shared memory that does nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    stream = torch.cuda.current_stream().cuda_stream

    def run():
        check(empty_block_fn()(threads, smem, stream) == 0, f"empty block ({threads}, {smem}) refused")

    run()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile that recorded none of the launches is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                run()
            torch.cuda.synchronize()
        got = [v for k, v in device_events(prof, 10).items() if "empty_block_kernel" in k]
        if got and got[0][1]:
            return got[0][0] / got[0][1]
    return float("nan")


def selection_weights_times(seed: int) -> dict:
    """B4's weights (krum, cge, monna) and B10's (clip, arc; krum) on B3's
    Gram of one (1, n, 421,642) f32 round (every third row x3) at 8, 64 and
    128 rows: CUDA events, torch.profiler device ms, the plain version, the
    bound (the Gram's entries read; d2, the sorts' compare-exchanges, the
    adds and the rank compares at the f32 rate) and the device ms of an
    empty block of the kernel's shape (``empty_ms``: its threads, min(1024,
    NPAD^2), and krum's two square buffers of dynamic shared memory).
    Krum's (f, q) from SEL_ARGS; cge and monna at f = 0, q = n - f, as
    ``robust.cge`` and ``robust.monna`` call them; B10's tau and ARC's f
    from PRE_ARGS."""
    import torch

    from byzpy_tpu_torch.ops import kernels
    from byzpy_tpu_torch.ops.preagg import arc_cut_off

    out = {k: {} for k in ("selection_weights:krum", "selection_weights:cge", "selection_weights:monna",
                           "clip_selection_weights:clip", "clip_selection_weights:arc")}
    for n in (MAIN_N, 64, EXEC_CAP):
        f, q = SEL_ARGS[n]
        f_pre, _, _, tau = PRE_ARGS[n]
        x = pre_rows((1, n, 421_642), seed=seed + n)
        g = kernels.gram(x)
        del x
        npad = kernels.network_width(n)
        threads, square = min(1024, npad * npad), 2 * npad * (npad + 1) * 4
        krum_ops = 5 * n * n + 2 * len(kernels.batcher_pairs(npad)) * n + (n - f - 1) * n
        calls = {
            "selection_weights:krum": (dict(f=f, q=q, mode="krum"), None,
                                       bound_ms(n * n * 4 + n * 4, krum_ops), square),
            "selection_weights:cge": (dict(f=0, q=n - f, mode="cge"), None,
                                      bound_ms(2 * n * 4, n * n), 0),
            "selection_weights:monna": (dict(f=0, q=n - f, mode="monna"), None,
                                        bound_ms(3 * n * 4, 3 * n + n * n), 0),
            "clip_selection_weights:clip": (dict(f=f, q=q, mode="krum"), dict(pre="clip", tau=tau),
                                            bound_ms(n * n * 4 + n * 4, krum_ops + 2 * n * n), square),
            "clip_selection_weights:arc": (dict(f=f, q=q, mode="krum"),
                                           dict(pre="arc", cut_off=arc_cut_off(n, f_pre)),
                                           bound_ms(n * n * 4 + n * 4, krum_ops + 3 * n * n), square),
        }
        for key, (sel, clip, (b_ms, b_by), smem) in calls.items():
            if clip is None:
                call = lambda sel=sel: kernels.selection_weights(g, **sel)  # noqa: E731
                plain = lambda sel=sel: kernels.selection_weights_plain(g, **sel)  # noqa: E731
                name = "selection_weights_kernel"
            else:
                call = lambda sel=sel, clip=clip: kernels.clip_selection_weights(g, **clip, **sel)  # noqa: E731
                plain = lambda sel=sel, clip=clip: kernels.clip_selection_weights_plain(g, **clip, **sel)  # noqa: E731
                name = "clip_selection_weights_kernel"
            out[key][str(n)] = {
                "ms": cuda_time_ms(call), "device_ms": kernel_device_ms(call, name),
                "empty_ms": empty_block_ms(threads, smem), "plain_ms": cuda_time_ms(plain),
                "bound_ms": b_ms, "bound_by": b_by, "threads": threads, "smem": smem, **sel,
            }
        del g
        torch.cuda.empty_cache()
    for key, rows in out.items():
        log(f"  {key} weights by rows (device ms; empty block): " + ", ".join(
            f"{n}: {v['device_ms']:.5f} ({v['empty_ms']:.5f})" for n, v in rows.items()))
    return out


def nnm_weights_times(seed: int) -> dict:
    """B8's selection state on B3's Gram of one (1, n, 421,642) f32 round
    (every third row x3) at 8, 64 and 128 rows, k = n - f_pre (PRE_ARGS):
    CUDA events, torch.profiler device ms, the plain version, the bound
    (the Gram read, the mask and sel_taint written; d2 and a column sort a
    mixer at the int32 rate) and an empty block of the kernel's shape
    (min(512, NPAD^2) threads, the keys' padded buffer)."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    out = {}
    for n in (MAIN_N, 64, EXEC_CAP):
        k = n - PRE_ARGS[n][0]
        x = pre_rows((1, n, 421_642), seed=seed + n)
        g = kernels.gram(x)
        del x
        npad = kernels.network_width(n)
        threads = min(512, npad * npad)
        r = npad if npad <= 16 else npad // 8
        smem = npad * ((npad + npad // r) | 1) * 4
        b_ms, b_by = bound_ms(2 * n * n * 4 + n * 4, 5 * n * n,
                              2 * len(kernels.batcher_pairs(npad)) * n)
        call = lambda: kernels.nnm_weights(g, k=k)  # noqa: E731
        out[str(n)] = {
            "ms": cuda_time_ms(call), "device_ms": kernel_device_ms(call, "nnm_weights_kernel"),
            "empty_ms": empty_block_ms(threads, smem),
            "plain_ms": cuda_time_ms(lambda: kernels.nnm_weights_plain(g, k=k)),
            "bound_ms": b_ms, "bound_by": b_by, "threads": threads, "smem": smem, "k": k,
        }
        del g
        torch.cuda.empty_cache()
    log("  nnm_weights by rows (device ms; empty block): " + ", ".join(
        f"{n}: {v['device_ms']:.5f} ({v['empty_ms']:.5f})" for n, v in out.items()))
    return out


def pre_kernel_times(n: int, d: int, *, seed: int) -> dict:
    """B8's, B9's and B10's launches on one (1, n, d) f32 round (every third
    row x3, so the clip engages) beside their bounds, plain versions and,
    where one exists, a single PyTorch call; and B4's sweep under B9's and
    B10's weights (entry ``weighted_rows``)."""
    import torch

    from byzpy_tpu_torch.ops import kernels
    from byzpy_tpu_torch.ops.preagg import arc_cut_off

    f_pre, f, q, tau = PRE_ARGS[n]
    k = n - f_pre
    x = pre_rows((1, n, d), seed=seed)
    isz = x.element_size()
    g = kernels.gram(x)
    gram_bytes = n * n * 4
    pairs = len(kernels.batcher_pairs(kernels.network_width(n)))
    # a column sort per node, d2 (add, mul, sub, clamp) and the rank compares
    select_ops = 2 * pairs * n + 5 * n * n
    krum_ops = select_ops + (n - f - 1) * n
    out = {}

    mask, st = kernels.nnm_weights(g, k=k)
    b_ms, b_by = bound_ms(2 * gram_bytes + n * 4, select_ops)

    def nnm_plain():
        mask_p, st_p = kernels.nnm_weights_plain(kernels.gram_plain(x), k=k)
        return kernels.mix_rows_plain(x, mask_p, st_p, k=k)

    out["nnm_weights"] = {
        "ms": cuda_time_ms(lambda: kernels.nnm_weights(g, k=k)),
        "plain_ms": cuda_time_ms(lambda: kernels.nnm_weights_plain(g, k=k)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "shape": [1, n, d],
        # the whole B8 call (B3's Gram, selection, mixing) beside the plain pipeline
        "nnm_stream_ms": cuda_time_ms(lambda: kernels.nnm_stream(x, f=f_pre)),
        "nnm_stream_plain_ms": cuda_time_ms(nnm_plain, iters=3),
    }
    out["mix_rows"] = mix_rows_times(x, mask, st, k)
    if (n, d) == HEADLINE:  # the sweep in bf16, beside its own bound and library call
        out["mix_rows"]["bf16"] = mix_rows_times(x.to(torch.bfloat16), mask, st, k)

    sel = dict(f=f, q=q, mode="krum")
    w_nnm = kernels.nnm_selection_weights(g, k=k, **sel)

    def nnm_selection_plain():
        wp = kernels.nnm_selection_weights_plain(kernels.gram_plain(x), k=k, **sel)
        return kernels.weighted_rows_plain(x, wp)

    out["nnm_selection_weights:krum"] = dict(
        b9_weights_times(g, n, f_pre=f_pre, f=f, q=q), shape=[1, n, d],
        nnm_selection_mean_ms=cuda_time_ms(
            lambda: kernels.nnm_selection_mean_stream(x, f_nnm=f_pre, **sel)),
        nnm_selection_mean_plain_ms=cuda_time_ms(nnm_selection_plain, iters=3),
    )
    cut_off = arc_cut_off(n, f_pre)
    clip_kw = {"clip": dict(pre="clip", tau=tau), "arc": dict(pre="arc", cut_off=cut_off)}
    whole = {"clip": lambda: kernels.clip_selection_mean_stream(x, tau=tau, **sel),
             "arc": lambda: kernels.arc_selection_mean_stream(x, f_arc=f_pre, **sel)}
    for pre, kw in clip_kw.items():
        # the clipped Gram (2 muls an entry), the ARC rank compares
        ops = krum_ops + 2 * n * n + (n * n if pre == "arc" else 0)
        b_ms, b_by = bound_ms(gram_bytes + n * 4, ops)

        def clip_plain(kw=kw):
            wp = kernels.clip_selection_weights_plain(kernels.gram_plain(x), **kw, **sel)
            return kernels.weighted_rows_plain(x, wp)

        out[f"clip_selection_weights:{pre}"] = {
            "ms": cuda_time_ms(lambda kw=kw: kernels.clip_selection_weights(g, **kw, **sel)),
            "plain_ms": cuda_time_ms(lambda kw=kw: kernels.clip_selection_weights_plain(g, **kw, **sel)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "shape": [1, n, d],
            f"{pre}_selection_mean_ms": cuda_time_ms(whole[pre]),
            f"{pre}_selection_mean_plain_ms": cuda_time_ms(clip_plain, iters=3),
        }
    w_clip = kernels.clip_selection_weights(g, **clip_kw["clip"], **sel)
    sweeps = {}
    for label, w in (("with_nnm_weights", w_nnm), ("with_clip_weights", w_clip)):
        rows = int((w != 0).sum())  # the sweep reads these rows only
        b_ms, b_by = bound_ms(rows * d * isz + n * 4 + d * isz, 2 * rows * d)
        sweeps[label] = {
            "rows_read": rows,
            "ms": cuda_time_ms(lambda w=w: kernels.weighted_rows(x, w)),
            "device_ms": kernel_device_ms(lambda w=w: kernels.weighted_rows(x, w), "weighted_rows_kernel"),
            "plain_ms": cuda_time_ms(lambda w=w: kernels.weighted_rows_plain(x, w), iters=3),
            "library_ms": cuda_time_ms(lambda w=w: w[0] @ x[0]),  # reads all n rows
            "bound_ms": b_ms, "bound_by": b_by,
        }
    for key, v in list(out.items()) + [(f"weighted_rows {k_}", v_) for k_, v_ in sweeps.items()]:
        log(f"  {key} {[1, n, d]}: {v['ms']:.4f} ms, bound {v['bound_ms']:.6f} ms "
            f"({v['bound_by']}), plain {v['plain_ms']:.4f} ms, library {v['library_ms']}")
    for key in ("nnm_weights", "nnm_selection_weights:krum", "clip_selection_weights:clip",
                "clip_selection_weights:arc"):
        log(f"    whole call: {json.dumps({k_: v_ for k_, v_ in out[key].items() if k_.endswith('_ms')})}")
    out["weighted_rows"] = sweeps
    del x, g
    torch.cuda.empty_cache()
    return out


def meamed_times(x, f: int) -> dict:
    """B6 on the rounds ``x: (1, n, d)``: CUDA events, torch.profiler device
    ms, the plain version and the bound: the rows read once and the output
    written; the key sort's int32 min/max; the window cut (2 subs, a max, a
    min per start), the select's two passes (a sub, an abs, a compare each)
    and the k adds in f32."""
    from byzpy_tpu_torch.ops import kernels

    _, n, d = x.shape
    isz = x.element_size()
    pairs = len(kernels.batcher_pairs(kernels.network_width(n)))
    b_ms, b_by = bound_ms(n * d * isz + d * isz, (4 * (f + 1) + 6 * n + (n - f)) * d, 2 * pairs * d)
    call = lambda: kernels.meamed_stream(x, f=f)  # noqa: E731
    return {
        "ms": cuda_time_ms(call), "device_ms": kernel_device_ms(call, "meamed_kernel"),
        "plain_ms": cuda_time_ms(lambda: kernels.meamed_stream_plain(x, f=f), iters=3),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "shape": list(x.shape), "f": f,
    }


def centre_kernel_times(n: int, d: int, *, f: int, seed: int) -> dict:
    """B6's launch and B7's loop on one (n, d) f32 round (every third row
    x3; B7 from the coordinate median, c_tau between the two scales)
    beside their bounds and plain versions. B7 by mode: LOOP_STEPS forced
    steps (the entry's numbers), one step, and 256 forced steps, each
    beside (steps + 1) reads of x, the kernel's own floor; ``torch.cdist``
    times one step's distances alone. No single PyTorch call computes
    MeaMed or a centre-seeking loop."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    x, z, c_tau = centre_inputs(n, d, seed, torch.float32)
    isz = x.element_size()
    out = {"meamed": meamed_times(x[None], f)}
    read_ms = n * d * isz / PEAK_BYTES_PER_S * 1e3
    for mode in ("weiszfeld", "clip"):
        kw = dict(mode=mode, c_tau=c_tau)
        # the entry's call: LOOP_STEPS steps (Weiszfeld forced by tol = -1).
        # Its bound: read x and z once, write the centre; per step and
        # entry the sweep's mul and add and the distances' sub, mul and add
        loop = dict(kw, tol=-1.0, max_iter=LOOP_STEPS)
        b_ms, b_by = bound_ms(n * d * isz + 2 * d * isz, 5 * n * d * LOOP_STEPS)
        entry = {
            "ms": cuda_time_ms(lambda: kernels.center_loop(x, z, **loop)),
            "plain_ms": cuda_time_ms(lambda: kernels.center_loop_plain(x, z, **loop), iters=2,
                                     warmup=1),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "shape": [n, d],
            "steps": LOOP_STEPS,
            # the kernel's own floor: a first pass, then one read of x a step
            "reads_bound_ms": (LOOP_STEPS + 1) * read_ms,
            # one step (two reads of x), and 256 forced steps
            "one_step_ms": cuda_time_ms(lambda: kernels.weighted_center_step(x, z, **kw)),
            "one_step_plain_ms": cuda_time_ms(lambda: kernels.weighted_center_step_plain(x, z, **kw),
                                              iters=3),
            "steps_256_ms": cuda_time_ms(lambda: kernels.center_loop(
                x, z, **dict(kw, tol=-1.0, max_iter=256)), iters=3, warmup=1),
            "steps_256_reads_bound_ms": 257 * read_ms,
            # one PyTorch call for one step's distances alone (no single call
            # computes a loop, or a step)
            "cdist_ms": cuda_time_ms(lambda: torch.cdist(
                x, z[None], compute_mode="donot_use_mm_for_euclid_dist")),
        }
        entry["ms_per_step"] = (entry["steps_256_ms"] - entry["one_step_ms"]) / 255
        out[f"center_loop:{mode}"] = entry
    for key, v in out.items():
        log(f"  {key} {v['shape']}: {v['ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
            f"({v['bound_by']}), plain {v['plain_ms']:.4f} ms, library {v['library_ms']}"
            + (f"; {v['steps']} steps (reads bound {v['reads_bound_ms']:.4f}), one step "
               f"{v['one_step_ms']:.4f} (plain {v['one_step_plain_ms']:.4f}), 256 steps "
               f"{v['steps_256_ms']:.4f} (reads bound {v['steps_256_reads_bound_ms']:.4f}), "
               f"{v['ms_per_step']:.5f} a step, cdist {v['cdist_ms']:.4f}" if "steps" in v else ""))
    del x, z
    torch.cuda.empty_cache()
    return out


def from_gram_times(n: int, d: int, *, f: int, q: int, seed: int) -> dict:
    """B5 on one (n, d) f32 round and its B3 Gram: the whole call, its
    weights launch and its sweep apart (CUDA events), beside its bound
    (the Gram and the q selected rows read once, the (d,) row written),
    the plain version and ``w @ x`` for the sweep. Then what streaming
    costs on one card: a whole Multi-Krum fold round (n
    ``gram_fold_update`` calls in a seeded order, then
    ``multi_krum_from_gram``) beside the barrier ``robust.multi_krum`` (B3
    + B4) on the same rows. No single PyTorch call computes B5."""
    import torch

    from byzpy_tpu_torch.ops import kernels, robust

    x = random_rounds((1, n, d), seed=seed)[0]
    isz = x.element_size()
    g = kernels.gram(x[None])[0]
    w = kernels.selection_weights(g[None], f=f, q=q)
    npad = kernels.network_width(n)
    weight_ops = 5 * n * n + 2 * len(kernels.batcher_pairs(npad)) * n + (n - f - 1) * n
    b_ms, b_by = bound_ms(n * n * 4 + q * d * isz + d * isz, weight_ops + 2 * q * d)
    out = {
        "ms": cuda_time_ms(lambda: kernels.selection_mean_from_gram(x, g, f=f, q=q)),
        "plain_ms": cuda_time_ms(lambda: kernels.selection_mean_from_gram_plain(x, g, f=f, q=q),
                                 iters=3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "shape": [n, d],
        # B4's two kernels on the same inputs, B5 before it was one launch
        "weights_ms": cuda_time_ms(lambda: kernels.selection_weights(g[None], f=f, q=q)),
        "sweep_ms": cuda_time_ms(lambda: kernels.weighted_rows(x[None], w)),
        "two_launches_ms": cuda_time_ms(lambda: kernels.weighted_rows(
            x[None], kernels.selection_weights(g[None], f=f, q=q))),
        # w @ x: the sweep's function on these finite inputs (it reads all n rows)
        "sweep_library_ms": cuda_time_ms(lambda: w[0] @ x),
    }
    # the device time of the one launch and of the two: the CUDA-event times
    # above follow the host's launch rate where a launch is short
    out["device_ms"] = kernel_device_ms(lambda: kernels.selection_mean_from_gram(x, g, f=f, q=q),
                                        "selection_mean_from_gram_kernel")
    out["two_launches_device_ms"] = port_device_ms(
        lambda: kernels.weighted_rows(x[None], kernels.selection_weights(g[None], f=f, q=q)))
    buf = torch.zeros_like(x)
    gram = torch.zeros((n, n), device=x.device)
    order = torch.randperm(n, generator=torch.Generator().manual_seed(seed)).tolist()

    def fold_round():
        for i in order:
            robust.gram_fold_update(buf, gram, x[i], i)
        return robust.multi_krum_from_gram(buf, gram, f=f, q=q)

    folded, barrier = fold_round(), robust.multi_krum(x, f=f, q=q)
    check(torch.allclose(folded, barrier, rtol=1e-5, atol=1e-6),
          f"fold round differs from the barrier Multi-Krum at {(n, d)}")
    out["fold_round"] = {
        "fold_round_ms": cuda_time_ms(fold_round, iters=3, warmup=1),
        "gram_fold_update_ms": cuda_time_ms(lambda: robust.gram_fold_update(buf, gram, x[3], 3)),
        "barrier_multi_krum_ms": cuda_time_ms(lambda: robust.multi_krum(x, f=f, q=q)),
        "max_abs_diff_vs_barrier": max_abs_err(folded, barrier),
    }
    log(f"  selection_mean_from_gram {[n, d]}: {out['ms']:.4f} ms, device {out['device_ms']:.5f} ms in "
        f"one launch; B4's two launches {out['two_launches_ms']:.4f} ms (weights {out['weights_ms']:.4f}, "
        f"sweep {out['sweep_ms']:.4f}; w @ x {out['sweep_library_ms']:.4f}), device "
        f"{json.dumps(out['two_launches_device_ms'])}; bound {b_ms:.4f} ms ({b_by}), plain "
        f"{out['plain_ms']:.4f} ms")
    log(f"  Multi-Krum fold round at {[n, d]}: {json.dumps(out['fold_round'])}")
    del x, g, buf
    torch.cuda.empty_cache()
    return out


def masked_kernel_times(n: int, d: int, *, seed: int) -> dict:
    """B11 (one cohort, fill = n), B2 and the row reduction on one (n, d)
    f32 matrix beside their bounds, plain versions and, where one exists,
    a single PyTorch call that computes the same function: ``w @ x`` for
    B11, ``torch.sort(x, dim=0)`` for B2 (the same sorted values on these
    finite inputs). For the row reduction, ``torch.linalg.vecdot(x, x)``
    computes the sums without a centre, timed beside the kernel's
    ``row_sq_dists(x)`` (``no_centre_ms``); ``torch.cdist`` (the square roots
    of the centred sums) is timed as ``cdist_ms``."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    x = masked_rows((n, d), seed, torch.float32, specials=False)
    isz = x.element_size()
    w = torch.randn((1, n), generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    z = x[n // 2].clone()
    out = {}
    # read x and w, write the (1, d) sum; one FMA (2 flops) per entry
    b_ms, b_by = bound_ms(n * d * isz + n * 4 + d * isz, 2 * n * d)
    out["segment_sum"] = {
        "ms": cuda_time_ms(lambda: kernels.segment_sum(x, w)),
        "plain_ms": cuda_time_ms(lambda: kernels.segment_sum_plain(x, w), iters=3),
        "library_ms": cuda_time_ms(lambda: w @ x),
        "bound_ms": b_ms, "bound_by": b_by, "shape": [1, n, d],
        "device_ms": port_device_ms(lambda: kernels.segment_sum(x, w)),
    }
    pairs = len(kernels.batcher_pairs(kernels.network_width(n)))
    # read and write the matrix; an int32 min and max per compare-exchange
    b_ms, b_by = bound_ms(2 * n * d * isz, 0, 2 * pairs * d)
    out["sort_columns"] = {
        "ms": cuda_time_ms(lambda: kernels.sort_columns(x)),
        "plain_ms": cuda_time_ms(lambda: kernels.sort_columns_plain(x), iters=3),
        "library_ms": cuda_time_ms(lambda: torch.sort(x, dim=0)),
        "bound_ms": b_ms, "bound_by": b_by, "shape": [n, d],
        "device_ms": port_device_ms(lambda: kernels.sort_columns(x)),
    }
    # read x and z, write n sums; a sub, a mul and an add per entry
    b_ms, b_by = bound_ms(n * d * isz + d * isz + n * 4, 3 * n * d)
    out["row_sq_dists"] = {
        "ms": cuda_time_ms(lambda: kernels.row_sq_dists(x, z)),
        "plain_ms": cuda_time_ms(lambda: kernels.row_sq_dists_plain(x, z), iters=3),
        # the same sums without a centre: the kernel, and one PyTorch call
        "no_centre_ms": cuda_time_ms(lambda: kernels.row_sq_dists(x)),
        "library_ms": cuda_time_ms(lambda: torch.linalg.vecdot(x, x)),
        "cdist_ms": cuda_time_ms(lambda: torch.cdist(
            x, z[None], compute_mode="donot_use_mm_for_euclid_dist")),
        "bound_ms": b_ms, "bound_by": b_by, "shape": [n, d],
        "device_ms": port_device_ms(lambda: kernels.row_sq_dists(x, z)),
    }
    for key, v in out.items():
        log(f"  {key} {v['shape']}: {v['ms']:.4f} ms (device {json.dumps(v['device_ms'])}), bound "
            f"{v['bound_ms']:.4f} ms ({v['bound_by']}), plain {v['plain_ms']:.4f} ms, library "
            f"{v['library_ms']}" + (f", cdist {v['cdist_ms']:.4f} ms, no centre "
                                    f"{v['no_centre_ms']:.4f} ms" if "cdist_ms" in v else ""))
    del x, w, z
    torch.cuda.empty_cache()
    return out


# B3's timed shapes: the main path's 8 rows, the serving and ragged (m)
# capacity, the (n) executor's, and the headline
GRAM_SHAPES = [(MAIN_N, 421_642), (64, 421_642), (128, 421_642), HEADLINE]


def gram_times(seed: int) -> dict:
    """B3 on one ``(1, n, d)`` f32 round at each of ``GRAM_SHAPES``: CUDA
    events (before and after the library call), the partials' and the
    reduce's device times (torch.profiler), the bound (the symmetric half's
    FMAs or one read of x), the plain version and ``x @ x.T``, the library
    call B3 is ordered by."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    out = {}
    for n, d in GRAM_SHAPES:
        x = random_rounds((1, n, d), seed=seed + n)
        # read x once, write the (n, n) Gram; the symmetric half's FMAs, 2 flops each
        b_ms, b_by = bound_ms(n * d * 4 + n * n * 4, n * (n + 1) * d)
        v = {
            "ms": cuda_time_ms(lambda: kernels.gram(x)),
            "device_ms": port_device_ms(lambda: kernels.gram(x)),
            "plain_ms": cuda_time_ms(lambda: kernels.gram_plain(x)),
            "library_ms": cuda_time_ms(lambda: x[0] @ x[0].T),
            "bound_ms": b_ms, "bound_by": b_by, "shape": [1, n, d],
        }
        v["ms_after_library"] = cuda_time_ms(lambda: kernels.gram(x))
        out[f"{n}x{d}"] = v
        log(f"  gram {v['shape']}: {v['ms']:.4f} / {v['ms_after_library']:.4f} ms (device "
            f"{json.dumps(v['device_ms'])}), bound {v['bound_ms']:.4f} ms ({v['bound_by']}), "
            f"plain {v['plain_ms']:.4f} ms, library {v['library_ms']:.4f} ms")
        del x
        torch.cuda.empty_cache()
    return out


def cohort_kernel_times(seed: int) -> dict:
    """B11 at the executor's capacity, 128 x 421,642 f32, with C = 4
    cohorts (the (n) dispatch's contraction; C = 16 beside it), beside its
    bound, its plain version and ``w @ x``."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    R, d = EXEC_CAP, 421_642
    x = masked_rows((R, d), seed, torch.float32, specials=False)
    out = {}
    for C in (EXEC_MAX_COHORTS, 16):
        w = torch.randn((C, R), generator=torch.Generator(device="cuda").manual_seed(C), device="cuda")
        # read x and w once, write the (C, d) sums; one FMA (2 flops) per (c, r, col)
        b_ms, b_by = bound_ms(R * d * 4 + C * R * 4 + C * d * 4, 2 * C * R * d)
        out[f"segment_sum:C={C}"] = {
            "ms": cuda_time_ms(lambda: kernels.segment_sum(x, w)),
            "device_ms": port_device_ms(lambda: kernels.segment_sum(x, w)),
            "plain_ms": cuda_time_ms(lambda: kernels.segment_sum_plain(x, w), iters=1, warmup=1),
            "library_ms": cuda_time_ms(lambda: w @ x),
            "bound_ms": b_ms, "bound_by": b_by, "shape": [C, R, d],
        }
        del w
    for key, v in out.items():
        log(f"  {key} {v['shape']}: {v['ms']:.4f} ms (device {json.dumps(v['device_ms'])}), bound "
            f"{v['bound_ms']:.4f} ms ({v['bound_by']}), plain {v['plain_ms']:.4f} ms, library "
            f"{v['library_ms']:.4f} ms")
    del x
    torch.cuda.empty_cache()
    return out


def aggregator_times() -> dict:
    """The six aggregators of this slice, whole, on one ByzPy grid input
    (64 x 65,536 f32 normal, benchmarks/full_grid.py), by CUDA events
    around each call (the loops' host reads included), with the loops'
    iteration counts."""
    import torch

    from byzpy_tpu_torch.ops import robust

    n, d = GRID
    x = random_rounds((1, n, d), seed=23)[0]
    v = torch.randn((d,), generator=torch.Generator().manual_seed(0)).cuda()
    calls = {
        "meamed_64x65536_f8": (lambda: robust.mean_of_medians(x, f=8), None),
        "geometric_median_64x65536": (lambda: robust.geometric_median(x), "geometric_median"),
        "centered_clipping_64x65536_M10": (lambda: robust.centered_clipping(x, c_tau=10.0, M=10), None),
        "cge_64x65536_f8": (lambda: robust.cge(x, f=8), None),
        "monna_64x65536_f8": (lambda: robust.monna(x, f=8), None),
        "caf_64x65536_f8": (lambda: robust.caf(x, f=8, v_init=v), "caf"),
    }
    out = {}
    for name, (fn, loop) in calls.items():
        res = fn()
        check(bool(torch.isfinite(res).all()), f"{name}: result not finite")
        out[name] = {"ms": cuda_time_ms(fn, iters=5, warmup=1)}
        if loop is not None:
            out[name]["iterations"] = robust.last_iterations[loop]
        log(f"  {name}: {json.dumps(out[name])}")
    del x
    torch.cuda.empty_cache()
    return out


# ByzPy's subset-search workloads (BASELINE.md:20-21,
# benchmarks/aggregators_bench.py): (rows, d, f) and ByzPy's direct time (ms)
SUBSET_SEARCH_SHAPES = {"mda_30x2048_f10": ("mda", 30, 2048, 10, 353.0),
                        "smea_16x4096_f5": ("smea", 16, 4096, 5, 82.0)}


def subset_search_times() -> dict:
    """MDA and SMEA, whole, at ByzPy's shapes (normal f32 rows made from a
    numpy seed): host ms per call (perf_counter around a synchronized
    call, the median of 5), device ms and launches per call
    (torch.profiler), the port kernels' launches and the host reads of a
    call, the subset against the CPU port's on the same rows (or a near
    tie), beside ByzPy's direct time (BASELINE.md). SMEA at m = 11 runs its
    8 x 11 Jacobi rounds as ~20 PyTorch operations each."""
    import numpy as np
    import torch

    from byzpy_tpu_torch.aggregators import SMEA, MinimumDiameterAveraging
    from byzpy_tpu_torch.aggregators.geometric_wise.minimum_diameter_average import (
        _dists_for_search,
    )
    from byzpy_tpu_torch.aggregators.geometric_wise.smea import _device_combos
    from byzpy_tpu_torch.ops import kernels, robust

    out = {}
    for name, (kind, n, d, f, byzpy_ms) in SUBSET_SEARCH_SHAPES.items():
        host = torch.from_numpy(np.random.default_rng(n * d).normal(size=(n, d)).astype(np.float32))
        x = host.cuda()
        make = MinimumDiameterAveraging if kind == "mda" else SMEA
        agg, cpu = make(f), make(f, device="cpu")
        res = agg.aggregate(x)  # the combos and the Jacobi schedule reach the card once
        torch.cuda.synchronize()
        check(bool(torch.isfinite(res).all()), f"{name}: result not finite")
        kernels.reset_launch_counts()
        _, reads = count_syncs(lambda: agg.aggregate(x))
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launch_counts.items() if v}
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            agg.aggregate(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        host_ms = sorted(times)[len(times) // 2]
        prof = profile_steps(lambda: agg.aggregate(x), steps=3)
        got = agg.last_selection.tolist()
        cpu.aggregate(host)
        want = cpu.last_selection.tolist()
        if kind == "mda":
            d2 = _dists_for_search(host)

            def score(c, d2=d2):
                return float(d2[np.ix_(c, c)].max())
        else:
            combos = _device_combos(n, n - f, torch.device("cpu"))
            scores = robust.subset_max_eigvals_jacobi(robust.gram_matrix(host), combos)
            rank = {tuple(c): i for i, c in enumerate(combos.tolist())}

            def score(c, scores=scores, rank=rank):
                return float(scores[rank[tuple(c)]])
        best = score(want)
        check(got == want or score(got) <= best + SUBSET_RTOL * abs(best),
              f"{name}: the card selected {got}, the CPU port {want}, and no near tie")
        check(launches == {"gram": 1}, f"{name}: launches {launches}, not one B3")
        check(reads == (1 if kind == "mda" else 0), f"{name}: {reads} host reads a call")
        out[name] = {
            "host_ms": host_ms, "host_ms_calls": times,
            "device_ms": prof["device_ms_per_step"],
            "device_busy_share": prof["device_ms_per_step"] / host_ms,
            "device_launches": prof["device_launches_per_step"],
            "port_kernels": prof["port_kernels"], "port_launches": launches,
            "host_reads": reads, "selected_equals_cpu_port": got == want,
            "byzpy_direct_ms_baseline_md": byzpy_ms, "top": prof["top"],
        }
        log(f"  {name}: {json.dumps(out[name])}")
    return out


def codec_times() -> dict:
    """B13, B15 (both formats) and B14 (int8 codes, both fp8 formats) at
    block 256 on f32 rows at the headline 64 x 1,048,576 and the main
    path's 8 x 421,642: CUDA events and torch.profiler device time per
    call, beside the bound (an encode reads each f32 value once and writes
    a byte of code and 4 / 256 bytes of scale per value; a decode the
    reverse), the plain version and no library call (no single PyTorch
    call computes a blockwise codec). Keyed ``"rows x d"`` then counter."""
    import torch

    from byzpy_tpu_torch.ops import codec_kernels as ck

    block = 256
    out = {}
    for rows, d in (HEADLINE, (MAIN_N, 421_642)):
        x = random_rounds((1, rows, d), seed=31)[0]
        nb = -(-d // block)
        traffic = rows * d * 4 + rows * d + rows * nb * 4
        # per value: an abs, a select, a max, a multiply, a rint or cast, two clamps
        enc_ms, enc_by = bound_ms(traffic, 7 * rows * d)
        # per value: a code conversion, a multiply
        dec_ms, dec_by = bound_ms(traffic, 2 * rows * d)
        shape = {}
        for mode in CODEC_MODES:
            def enc(mode=mode):
                return ck.encode_rows(x, block=block, mode=mode)

            codes, scales = enc()
            shape[f"quantize:{mode}"] = {
                "ms": cuda_time_ms(enc),
                "plain_ms": cuda_time_ms(lambda mode=mode: ck.encode_rows_plain(
                    x, block=block, mode=mode), iters=3),
                "bound_ms": enc_ms, "bound_by": enc_by, "library_ms": None,
                "device_ms": port_device_ms(enc), "shape": [rows, d], "block": block,
            }

            def dec(codes=codes, scales=scales):
                return ck.decode_rows(codes, scales, block=block)

            shape[f"dequantize:{mode}"] = {
                "ms": cuda_time_ms(dec),
                "plain_ms": cuda_time_ms(lambda codes=codes, scales=scales: ck.decode_rows_plain(
                    codes, scales, block=block), iters=3),
                "bound_ms": dec_ms, "bound_by": dec_by, "library_ms": None,
                "device_ms": port_device_ms(dec), "shape": [rows, d], "block": block,
            }
            del codes, scales
        for key, v in shape.items():
            log(f"  {key} {v['shape']}: {v['ms']:.4f} ms (device {json.dumps(v['device_ms'])}), "
                f"bound {v['bound_ms']:.4f} ms ({v['bound_by']}), plain {v['plain_ms']:.4f} ms")
        out[f"{rows}x{d}"] = shape
        del x
        torch.cuda.empty_cache()
    return out


def codec_entries(times: dict) -> dict:
    """The three codec kernels' JSON entries' numbers: B13 ``quantize:int8``,
    B15 ``quantize:fp8`` (e4m3fn; e5m2 beside it) and B14 ``dequantize``
    (int8 codes; fp8 beside it), at the headline with the main path's shape
    under ``main_path_shape``."""
    head, main = times[f"{HEADLINE[0]}x{HEADLINE[1]}"], times[f"{MAIN_N}x421642"]
    keys = ("shape", "ms", "plain_ms", "bound_ms", "device_ms")

    def entry(key, **extra):
        return dict(head[key], main_path_shape={k: main[key][k] for k in keys}, **extra)

    return {
        "quantize:int8": entry("quantize:int8"),
        "quantize:fp8": entry("quantize:fp8", fp8_e5m2=head["quantize:fp8_e5m2"]),
        "dequantize": entry("dequantize:int8", fp8=head["dequantize:fp8"],
                            fp8_e5m2=head["dequantize:fp8_e5m2"]),
    }


def ragged_kernel_times() -> dict:
    """B16 and B17 at block 256 on f32 rows at the headline 64 x 1,048,576
    and the main path's 8 x 421,642; B12 on int8, fp8 and s4 wire rows at 64
    x 1,048,576 with C = 1 and at 128 x 421,642 (the executor's capacity)
    with C = 4: CUDA events and torch.profiler device time per call, beside
    the bound, the plain version and, for B12, the unfused decode (B14 or
    B17) + B11 that it replaces (no single PyTorch call computes a blockwise
    codec or a decoding contraction: ``library_ms`` null). Then the ragged
    door's segmented ``torch.sort`` of 128 x 421,642 (4 cohorts of 32 rows)
    beside 4 launches of B2, on each cohort's rows and (the generic door's)
    on the whole batch. Keyed by counter, then ``"rows x d"``."""
    import torch

    from byzpy_tpu_torch.ops import codec_kernels as ck
    from byzpy_tpu_torch.ops import kernels, ragged
    from byzpy_tpu_torch.parallel import CommPrecision, encode_blockwise

    block = 256
    out = {"quantize:s4": {}, "dequantize:s4": {}}
    for rows, d in (HEADLINE, (MAIN_N, 421_642)):
        x = random_rounds((1, rows, d), seed=51)[0]
        nb = -(-d // block)
        # read each f32 value once, write half a byte of code and 4 / 256
        # bytes of scale per value (a decode the reverse)
        traffic = rows * d * 4 + rows * nb * block // 2 + rows * nb * 4
        enc_ms, enc_by = bound_ms(traffic, 7 * rows * d)
        dec_ms, dec_by = bound_ms(traffic, 3 * rows * d)  # unpack, subtract 8, multiply
        packed, scales = ck.encode_rows_s4(x, block=block)
        enc = lambda: ck.encode_rows_s4(x, block=block)  # noqa: E731
        dec = lambda: ck.decode_rows_s4(packed, scales, block=block, d=d)  # noqa: E731
        key = f"{rows}x{d}"
        out["quantize:s4"][key] = {
            "ms": cuda_time_ms(enc), "device_ms": port_device_ms(enc),
            "plain_ms": cuda_time_ms(lambda: ck.encode_rows_s4_plain(x, block=block), iters=3),
            "bound_ms": enc_ms, "bound_by": enc_by, "library_ms": None, "shape": [rows, d],
            "block": block,
        }
        out["dequantize:s4"][key] = {
            "ms": cuda_time_ms(dec), "device_ms": port_device_ms(dec),
            "plain_ms": cuda_time_ms(lambda: ck.decode_rows_s4_plain(packed, scales, block=block, d=d),
                                     iters=3),
            "bound_ms": dec_ms, "bound_by": dec_by, "library_ms": None, "shape": [rows, d],
            "block": block,
        }
        del x, packed, scales
        torch.cuda.empty_cache()
    for R, d, C in ((*HEADLINE, 1), (EXEC_CAP, 421_642, 4)):
        x = masked_rows((R, d), 53, torch.float32, specials=False)
        w = torch.randn((C, R), generator=torch.Generator(device="cuda").manual_seed(C), device="cuda")
        for mode in ("int8", "fp8", "s4"):
            enc = encode_blockwise(x, CommPrecision(mode, block=block))
            codes = enc.values if mode in ("int8", "s4") else enc.values.view(torch.uint8)
            scales = enc.scales
            nb = scales.shape[1]
            # read the codes, scales and weights once, write the (C, d) sums;
            # a decode multiply per value and an FMA (2 flops) per (c, r, col)
            b_ms, b_by = bound_ms(R * codes.shape[1] + R * nb * 4 + C * R * 4 + C * d * 4,
                                  R * d + 2 * C * R * d)
            fused = lambda: kernels.segment_sum_dequant(codes, scales, w, mode=mode,  # noqa: E731
                                                        block=block, d=d)

            def unfused(codes=codes, scales=scales, mode=mode):
                if mode == "s4":
                    rows = ck.decode_rows_s4(codes, scales, block=block, d=d)
                else:
                    rows = ck.decode_rows(ck.from_wire(codes, mode), scales, block=block)
                return kernels.segment_sum(rows, w)

            out.setdefault(f"segment_sum_dequant:{mode}", {})[f"{R}x{d}"] = {
                "ms": cuda_time_ms(fused), "device_ms": port_device_ms(fused),
                "plain_ms": cuda_time_ms(lambda: kernels.segment_sum_dequant_plain(
                    codes, scales, w, mode=mode, block=block, d=d), iters=1, warmup=1),
                "unfused_ms": cuda_time_ms(unfused), "unfused_device_ms": port_device_ms(unfused),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "shape": [C, R, d],
                "block": block,
            }
            del enc, codes, scales
        del x, w
        torch.cuda.empty_cache()
    flat = masked_rows((EXEC_CAP, 421_642), 55, torch.float32, specials=False)
    cut = EXEC_CAP // EXEC_MAX_COHORTS
    seg = (torch.arange(EXEC_CAP, device="cuda") // cut).to(torch.int32)
    s = ragged.segmented_sort(flat, seg)
    for c in range(EXEC_MAX_COHORTS):
        check(bits_equal(s[c * cut:(c + 1) * cut], kernels.sort_columns(flat[c * cut:(c + 1) * cut])),
              f"segmented sort of cohort {c} differs from B2")
    out["segmented_sort"] = {
        "shape": [EXEC_CAP, 421_642], "cohorts": EXEC_MAX_COHORTS,
        "torch_sort_ms": cuda_time_ms(lambda: ragged.segmented_sort(flat, seg), iters=3),
        "b2_per_cohort_rows_ms": cuda_time_ms(lambda: [kernels.sort_columns(
            flat[c * cut:(c + 1) * cut]) for c in range(EXEC_MAX_COHORTS)]),
        "b2_whole_batch_per_cohort_ms": cuda_time_ms(lambda: [kernels.sort_columns(flat)
                                                              for _ in range(EXEC_MAX_COHORTS)]),
    }
    del flat, seg, s
    torch.cuda.empty_cache()
    out["segmented_sort_reduce"] = segmented_times()
    for key, by_shape in out.items():
        log(f"  {key}: {json.dumps(by_shape)}")
    return out


def segmented_bound(sizes, d: int, mode: str, f: int) -> tuple:
    """``bound_ms`` of one segmented sort-reduce: read each cohort's rows and
    the layout once and write the ``(C, d)`` result; an int32 min and max a
    compare-exchange of Batcher's network at each cohort's width
    (:func:`sort_exchanges`), then the window's adds
    and a multiply (trimmed) or an add and a multiply (median) a column."""
    C = len(sizes)
    ops = minmax = 0
    for m in sizes:
        if m:
            minmax += 2 * sort_exchanges(m)
            ops += (m - 2 * f + 1) if mode == "trimmed" else 2
    return bound_ms(sum(sizes) * d * 4 + 2 * C * 4 + C * d * 4, ops * d, minmax * d)


def segmented_times() -> dict:
    """The segmented sort-reduce (trimmed mean at f = 2, the main path's,
    and median) at the (n) batch (cohorts 6, 13, 29, 64 and a padding slot
    in 128 x 421,642) and at 4 x 32 rows in 128 x 421,642; the trimmed mean
    at f = 8 and the median at one cohort of 64 in 64 x 1,048,576, beside
    B1 on the same rows (the same function: B1 divides by n - 2f where the
    ragged door multiplies by its rounded reciprocal). Each: CUDA events,
    torch.profiler device ms, the bound, the plain version and the generic
    door (one masked program a cohort slot: B2 over the whole batch, B11)
    on the same batch. ``library_ms`` is null: no single PyTorch call
    computes a segmented trimmed mean or median."""
    import torch

    from byzpy_tpu_torch.ops import kernels, ragged, robust

    out = {}
    for label, (R, d), sizes, pad, modes in (
            ("n_batch", (EXEC_CAP, 421_642), EXEC_COHORTS, 1, (("trimmed", MAIN_BYZ), ("median", 0))),
            ("4x32", (EXEC_CAP, 421_642), (32,) * 4, 0, (("trimmed", MAIN_BYZ), ("median", 0))),
            ("headline_64", HEADLINE, (HEADLINE[0],), 0, (("trimmed", 8), ("median", 0)))):
        flat = masked_rows((R, d), 57, torch.float32, specials=False)
        offsets, lengths = ragged_layout(sizes, pad)
        C = len(sizes) + pad
        seg = ragged.segment_ids(offsets, lengths, R, C)
        for mode, f in modes:
            def kern(mode=mode, f=f):
                return kernels.segmented_sort_reduce(flat, offsets, lengths, mode=mode, f=f)

            def door(f=f, mode=mode):
                masked = ((lambda x, v: robust.masked_trimmed_mean(x, v, f=f)) if mode == "trimmed"
                          else robust.masked_coordinate_median)
                return ragged.ragged_via_masked(masked, flat, seg, n_cohorts=C)

            b_ms, b_by = segmented_bound(list(sizes) + [0] * pad, d, mode, f)
            entry = {
                "ms": cuda_time_ms(kern), "device_ms": port_device_ms(kern),
                "plain_ms": cuda_time_ms(lambda: kernels.segmented_sort_reduce_plain(
                    flat, offsets, lengths, mode=mode, f=f), iters=3, warmup=1),
                "door_ms": cuda_time_ms(door, iters=3), "door_device_ms": port_device_ms(door, calls=3),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "shape": [R, d],
                "cohorts": list(sizes), "padding_slots": pad, "f": f,
            }
            if label == "headline_64":
                b1 = lambda mode=mode, f=f: kernels.sorted_reduce_stream(flat[None], mode=mode, f=f)  # noqa: E731
                entry["b1_ms"] = cuda_time_ms(b1)
                entry["b1_device_ms"] = port_device_ms(b1)
            out[f"{label}:{mode}"] = entry
            log(f"  segmented_sort_reduce {label} {mode} (f = {f}): {entry['ms']:.4f} ms (device "
                f"{json.dumps(entry['device_ms'])}), bound {b_ms:.4f} ms ({b_by}), plain "
                f"{entry['plain_ms']:.4f} ms, door {entry['door_ms']:.4f} ms"
                + (f", B1 {entry['b1_ms']:.4f} ms" if "b1_ms" in entry else ""))
        del flat, seg
        torch.cuda.empty_cache()
    return out


def ragged_entries(times: dict) -> dict:
    """The JSON entries of B16 (``quantize:s4``), B17 (``dequantize:s4``) and
    B12 (``segment_sum_dequant:<mode>``): the headline numbers (B12's at C
    = 1), the main path's (8 x 421,642; B12's the executor's 128 x 421,642
    at C = 4) under ``main_path_shape``."""
    head = f"{HEADLINE[0]}x{HEADLINE[1]}"
    out = {}
    for key in ("quantize:s4", "dequantize:s4"):
        out[key] = dict(times[key][head], main_path_shape=times[key][f"{MAIN_N}x{421_642}"])
    for mode in ("int8", "fp8", "s4"):
        key = f"segment_sum_dequant:{mode}"
        out[key] = dict(times[key][head], main_path_shape=times[key][f"{EXEC_CAP}x{421_642}"])
    # the segmented sort-reduce: the (n) batch's trimmed mean (the main path's
    # shape) with the other shapes and modes beside it
    seg = times["segmented_sort_reduce"]
    out["segmented_sort_reduce"] = dict(seg["n_batch:trimmed"],
                                        **{k: v for k, v in seg.items() if k != "n_batch:trimmed"})
    return out


def timing() -> dict:
    """Kernel times at the headline 64 x 1,048,576 (the JSON line's
    numbers) and at the main path's 8 x 421,642. ``torch.median`` returns
    the lower middle value, the median kernel's function only at odd n, so
    the median's entry is taken at 63 x 1,048,576, where that library call
    computes the same function on the same inputs; its n = 64 numbers sit
    beside it under ``at_headline``."""
    from byzpy_tpu_torch.ops import kernels

    n, d = HEADLINE
    out = kernel_times(n, d, f_trim=8, f_krum=8, q=12, seed=7)
    odd = kernel_times(n - 1, d, f_trim=8, f_krum=8, q=12, seed=8)["sorted_reduce:median"]
    out["sorted_reduce:median"] = dict(odd, at_headline=out["sorted_reduce:median"])
    main = kernel_times(MAIN_N, 421_642, f_trim=MAIN_BYZ, f_krum=MAIN_BYZ, q=4, seed=9)
    # B1 at the executor's 128 rows: the engine's two runs of 64 and merge
    wide = sorted_reduce_times(EXEC_CAP, 421_642, f_trim=(EXEC_CAP - 1) // 3, seed=10)
    for mode in ("median", "trimmed"):
        out[f"sorted_reduce:{mode}"]["at_128_rows"] = wide[f"sorted_reduce:{mode}"]
    # B6 and B9's weights at the executor's 128 rows (the wide path; the
    # weights block's largest tile)
    wide_x = pre_rows((1, EXEC_CAP, 421_642), seed=11)
    wide_meamed = meamed_times(wide_x, 40)
    wide_b9 = dict(b9_weights_times(kernels.gram(wide_x), EXEC_CAP, f_pre=16, f=16, q=24),
                   shape=[1, EXEC_CAP, 421_642])
    del wide_x
    for times, shape, seed, f, q in ((out, HEADLINE, 17, 8, 12),
                                     (main, (MAIN_N, 421_642), 19, MAIN_BYZ, 4)):
        pre = pre_kernel_times(*shape, seed=seed)
        times["weighted_rows"].update(pre.pop("weighted_rows"))
        times.update(pre)
        times.update(centre_kernel_times(*shape, f=f, seed=seed + 10))
        times["selection_mean_from_gram:krum"] = from_gram_times(*shape, f=f, q=q, seed=seed + 20)
    out["meamed"]["at_128_rows"] = wide_meamed
    out["nnm_selection_weights:krum"]["at_128_rows"] = wide_b9
    # B4's and B10's weights by rows: the device ms at the headline's 64
    # rows and the main path's 8 go to the entries
    for key, rows in selection_weights_times(seed=23).items():
        out[key]["weights_by_rows"] = rows
        out[key]["device_ms"] = rows["64"]["device_ms"]
        main[key]["device_ms"] = rows[str(MAIN_N)]["device_ms"]
    # B8's selection state by rows, the same way
    rows = nnm_weights_times(seed=25)
    out["nnm_weights"]["weights_by_rows"] = rows
    out["nnm_weights"]["device_ms"] = rows["64"]["device_ms"]
    main["nnm_weights"]["device_ms"] = rows[str(MAIN_N)]["device_ms"]
    keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "with_nnm_weights",
            "with_clip_weights", "steps", "ms_per_step", "one_step_ms", "one_step_plain_ms",
            "steps_256_ms", "steps_256_reads_bound_ms", "reads_bound_ms", "cdist_ms",
            "weights_ms", "sweep_ms", "two_launches_ms", "two_launches_device_ms",
            "sweep_library_ms", "device_ms", "fold_round")
    for k, v in out.items():
        v["main_path_shape"] = {key: main[k][key] for key in keys if key in main[k]}
    # B2, B11 and the row reduction: the serving path's largest bucket,
    # 64 x 421,642, is their main-path shape
    masked = masked_kernel_times(*HEADLINE, seed=41)
    serve = masked_kernel_times(SERVE_CAP, 421_642, seed=43)
    for k, v in masked.items():
        v["main_path_shape"] = {key: serve[k][key] for key in keys + ("cdist_ms", "no_centre_ms")
                                if key in serve[k]}
    out.update(masked)
    # B11 at the (n) dispatch's 4 cohorts
    cohorts = cohort_kernel_times(seed=45)
    out["segment_sum"]["at_executor_capacity"] = {
        k.split("=")[1]: v for k, v in cohorts.items() if k.startswith("segment_sum")}
    # B3: the headline's numbers on the JSON line, every shape beside them
    grams = gram_times(seed=47)
    main_gram = grams[f"{MAIN_N}x421642"]
    out["gram"] = dict(grams[f"{HEADLINE[0]}x{HEADLINE[1]}"], by_shape=grams,
                       main_path_shape={key: main_gram[key] for key in keys if key in main_gram},
                       at_executor_capacity=grams["128x421642"])
    return out


KERNELS = [
    # (counter key, source, TPU kernel it replaces)
    ("sorted_reduce:median", "byzpy_tpu_torch/csrc/sorted_reduce.cu", "byzpy_tpu/ops/pallas_kernels.py:363"),
    ("sorted_reduce:trimmed", "byzpy_tpu_torch/csrc/sorted_reduce.cu", "byzpy_tpu/ops/pallas_kernels.py:363"),
    ("gram", "byzpy_tpu_torch/csrc/gram.cu", "byzpy_tpu/ops/pallas_kernels.py:289"),
    ("selection_weights:krum", "byzpy_tpu_torch/csrc/selection.cu", "byzpy_tpu/ops/pallas_kernels.py:928"),
    ("weighted_rows", "byzpy_tpu_torch/csrc/selection.cu", "byzpy_tpu/ops/pallas_kernels.py:928"),
    ("nnm_weights", "byzpy_tpu_torch/csrc/nnm.cu", "byzpy_tpu/ops/pallas_kernels.py:1245"),
    ("mix_rows", "byzpy_tpu_torch/csrc/nnm.cu", "byzpy_tpu/ops/pallas_kernels.py:1245"),
    ("nnm_selection_weights:krum", "byzpy_tpu_torch/csrc/nnm.cu", "byzpy_tpu/ops/pallas_kernels.py:1380"),
    ("clip_selection_weights:clip", "byzpy_tpu_torch/csrc/clip_selection.cu",
     "byzpy_tpu/ops/pallas_kernels.py:1466"),
    ("clip_selection_weights:arc", "byzpy_tpu_torch/csrc/clip_selection.cu",
     "byzpy_tpu/ops/pallas_kernels.py:1466"),
    ("selection_weights:cge", "byzpy_tpu_torch/csrc/selection.cu", "byzpy_tpu/ops/pallas_kernels.py:928"),
    ("selection_weights:monna", "byzpy_tpu_torch/csrc/selection.cu", "byzpy_tpu/ops/pallas_kernels.py:928"),
    ("meamed", "byzpy_tpu_torch/csrc/meamed.cu", "byzpy_tpu/ops/pallas_kernels.py:619"),
    # B7: the whole loop in one launch (its one-step phases, center_weights
    # and center_sweep, are the same kernel and launch on no path)
    ("center_loop:weiszfeld", "byzpy_tpu_torch/csrc/center_step.cu",
     "byzpy_tpu/ops/pallas_kernels.py:470"),
    ("center_loop:clip", "byzpy_tpu_torch/csrc/center_step.cu", "byzpy_tpu/ops/pallas_kernels.py:470"),
    # B5: B4's weights block and the selected rows' sweep in one launch
    # (fold_multi_krum's finalize), no Gram
    ("selection_mean_from_gram:krum", "byzpy_tpu_torch/csrc/selection.cu",
     "byzpy_tpu/ops/pallas_kernels.py:1094"),
    # B13, B15 and B14; launches: quantize:fp8 counts both fp8 formats'
    # encodes, dequantize both codes' decodes (their counters beside them)
    ("quantize:int8", "byzpy_tpu_torch/csrc/quantize.cu", "byzpy_tpu/parallel/quantization.py:256"),
    ("quantize:fp8", "byzpy_tpu_torch/csrc/quantize.cu", "byzpy_tpu/parallel/quantization.py:479"),
    ("dequantize", "byzpy_tpu_torch/csrc/quantize.cu", "byzpy_tpu/parallel/quantization.py:279"),
    # B2 and B11, the serving path's (phase 4c); the row reduction beside
    # B11 replaces no Pallas kernel: it stands in for the masked family's
    # plain XLA row reduce
    ("sort_columns", "byzpy_tpu_torch/csrc/sort_columns.cu", "byzpy_tpu/ops/pallas_kernels.py:155"),
    ("segment_sum", "byzpy_tpu_torch/csrc/segment_sum.cu", "byzpy_tpu/ops/pallas_kernels.py:1840"),
    ("row_sq_dists", "byzpy_tpu_torch/csrc/segment_sum.cu",
     "byzpy_tpu/ops/robust.py:1542 (plain XLA reduce; no Pallas kernel)"),
    # B16 and B17 (the PS round (l), the ragged door's s4 ingress) and B12,
    # the ragged door's fused-dequant contraction, by wire mode (phase 4d);
    # launches: segment_sum_dequant:fp8 counts e4m3fn codes (e5m2 is checked
    # in phase 3 only)
    ("quantize:s4", "byzpy_tpu_torch/csrc/quantize.cu", "byzpy_tpu/parallel/quantization.py:504"),
    ("dequantize:s4", "byzpy_tpu_torch/csrc/quantize.cu", "byzpy_tpu/parallel/quantization.py:525"),
    ("segment_sum_dequant:int8", "byzpy_tpu_torch/csrc/segment_sum.cu",
     "byzpy_tpu/ops/pallas_kernels.py:1973"),
    ("segment_sum_dequant:fp8", "byzpy_tpu_torch/csrc/segment_sum.cu",
     "byzpy_tpu/ops/pallas_kernels.py:1973"),
    ("segment_sum_dequant:s4", "byzpy_tpu_torch/csrc/segment_sum.cu",
     "byzpy_tpu/ops/pallas_kernels.py:1973"),
    # the ragged door's sort family (phase 4d): one launch a (m) step and a
    # (n) trimmed-mean or median dispatch; no Pallas kernel
    ("segmented_sort_reduce", "byzpy_tpu_torch/csrc/segmented_sort.cu",
     "byzpy_tpu/ops/ragged.py:96 (segmented lax.sort + windowed einsum; no Pallas kernel)"),
]
# kernels that must launch on the main path beside each configuration's own
# checks: B8's redesigned mixing sweep and selection state, B5 in one
# launch, and the ragged door's kernels (the segmented sort-reduce among
# them)
NEW_KERNELS = ("mix_rows", "nnm_weights", "selection_mean_from_gram:krum", "quantize:s4", "dequantize:s4", "segment_sum_dequant:int8",
               "segment_sum_dequant:fp8", "segment_sum_dequant:s4", "segmented_sort_reduce",
               "center_loop:weiszfeld", "center_loop:clip")
# the launch counters each codec entry sums
CODEC_COUNTERS = {
    "quantize:int8": ("quantize:int8",),
    "quantize:fp8": ("quantize:fp8", "quantize:fp8_e5m2"),
    "dequantize": ("dequantize:int8", "dequantize:fp8"),
}


def ptxas_report(text: str, nvcc: str, kernels: tuple) -> list:
    """Registers, spill bytes and stack frame of each instance of the named
    kernels in one source's ``-Xptxas -v`` output, named as ``cu++filt``
    (beside ``nvcc``) demangles them."""
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    out, fn = [], None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line) or re.search(
            r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        if fn is None or not any(k in fn for k in kernels):
            continue
        if "stack frame" in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", line)]
            entry = {"kernel": fn, "stack_frame": nums[0], "spill_stores": nums[1], "spill_loads": nums[2]}
            out.append(entry)
        elif "Used" in line and out and out[-1]["kernel"] == fn:
            out[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    if os.path.isfile(filt) and out:
        names = subprocess.run([filt], input="\n".join(e["kernel"] for e in out), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        for e, name in zip(out, names):
            name = re.sub(r"\(anonymous namespace\)::|<unnamed>::|^void |\((int|bool)\)", "", name)
            depth = 0
            for i, ch in enumerate(name):  # cut the argument list: the first '(' outside <>
                depth += (ch == "<") - (ch == ">")
                if ch == "(" and depth == 0:
                    name = name[:i]
                    break
            e["kernel"] = name.strip()
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "byzpy_tpu_torch", "csrc")):
        print("chip_smoke: byzpy_tpu_torch not found beside this script", file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from byzpy_tpu_torch.ops import _build, kernels

    log("== 1. device")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"  {kind} x{count}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    log("  TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False")

    log("== 2. build")
    build_s = _build.timed_build()
    nvcc = _build.find_nvcc()
    release = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
    log(f"  kernels built and loaded in {build_s:.1f} s by {nvcc}: {release.stdout.strip().splitlines()[-1]}")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                log(f"  [{name}] {line.strip()}")
    log("SEGMENT_SUM_PTXAS " + json.dumps(ptxas_report(_build.build_log.get("segment_sum", ""),
                                                       nvcc, ("segment_sum_kernel",
                                                              "segment_sum_dequant_kernel"))))
    gram_ptxas = ptxas_report(_build.build_log.get("gram", ""), nvcc,
                              ("gram_partial_kernel", "gram_reduce_kernel"))
    log("GRAM_PTXAS " + json.dumps(gram_ptxas))
    spilled = [e["kernel"] for e in gram_ptxas if e["spill_stores"] or e["spill_loads"]]
    check(not spilled, f"B3 instances spill: {spilled}")
    log("CENTER_PTXAS " + json.dumps(ptxas_report(_build.build_log.get("center_step", ""), nvcc,
                                                   ("center_loop_kernel",))))
    # the column-sort engine's instances (B1 a dtype and width; the
    # segmented sort-reduce one) and its out-of-line run sort
    sort_ptxas = (ptxas_report(_build.build_log.get("sorted_reduce", ""), nvcc,
                               ("sorted_reduce_kernel", "sort_runs"))
                  + ptxas_report(_build.build_log.get("segmented_sort", ""), nvcc,
                                 ("segmented_sort_reduce_kernel", "sort_runs")))
    log("COLUMN_SORT_PTXAS " + json.dumps(sort_ptxas))
    spilled = [e["kernel"] for e in sort_ptxas if e["spill_stores"] or e["spill_loads"]]
    check(not spilled, f"column-sort instances spill: {spilled}")
    # B6, the engine's third instance (a dtype and width each), and nnm.cu's
    # kernels (B8's two, B9's weights block)
    meamed_ptxas = ptxas_report(_build.build_log.get("meamed", ""), nvcc, ("meamed_kernel", "sort_runs"))
    log("MEAMED_PTXAS " + json.dumps(meamed_ptxas))
    nnm_ptxas = ptxas_report(_build.build_log.get("nnm", ""), nvcc,
                             ("nnm_weights_kernel", "mix_rows_kernel", "nnm_selection_weights_kernel"))
    log("NNM_PTXAS " + json.dumps(nnm_ptxas))
    spilled = [e["kernel"] for e in meamed_ptxas + nnm_ptxas if e["spill_stores"] or e["spill_loads"]]
    check(not spilled, f"B6 or nnm.cu instances spill: {spilled}")
    # B4's weights block and sweep, B5's one kernel, B10's weights block
    selection_ptxas = (ptxas_report(_build.build_log.get("selection", ""), nvcc,
                                    ("selection_weights_kernel", "weighted_rows_kernel",
                                     "selection_mean_from_gram_kernel"))
                       + ptxas_report(_build.build_log.get("clip_selection", ""), nvcc,
                                      ("clip_selection_weights_kernel",)))
    log("SELECTION_PTXAS " + json.dumps(selection_ptxas))
    spilled = [e["kernel"] for e in selection_ptxas if e["spill_stores"] or e["spill_loads"]]
    check(not spilled, f"selection.cu or clip_selection.cu instances spill: {spilled}")

    log("== 3. kernels against their plain versions")
    errs = {key: 0.0 for key, _, _ in KERNELS}
    check_sorted_reduce(errs)
    check_gram_and_selection(errs)
    check_gram_order(errs)
    check_selection_from_gram(errs)
    check_pre_aggregation(errs)
    check_b9_ties(errs)
    check_selection_ties(errs)
    check_meamed(errs)
    check_center_step(errs)
    check_codecs(errs)
    check_masked_kernels(errs)
    check_s4_codec(errs)
    check_segment_sum_dequant(errs)
    check_segmented_sort(errs)

    log("== 4. main path: SmallCNN PS round, plain, pre-aggregated, centre-seeking and class-API "
        "configurations")
    counts = {k: 0 for k in kernels.launch_counts}
    log("MAIN_PATH " + json.dumps(main_path(counts)))
    log("== 4b. main path: the gossip round (SmallCNN)")
    log("GOSSIP_PATH " + json.dumps(gossip_path(counts)))
    log("== 4c. main path: the serving round (SmallCNN, bucketed cohorts, masked aggregators)")
    log("SERVING_PATH " + json.dumps(serving_path(counts)))
    log("== 4d. main path: the ragged door (SmallCNN: (m) the ragged serving step, (n) the "
        "ragged executor with quantized ingress)")
    log("RAGGED_PATH " + json.dumps({"m_ragged_serving_step": ragged_step_path(counts),
                                     "n_ragged_executor": ragged_executor_path(counts)}))
    for key in NEW_KERNELS:
        check(counts[key] > 0, f"{key} never launched on the main path")
    for key, parts in CODEC_COUNTERS.items():
        counts[key] = sum(counts[p] for p in parts)

    log("== 5. kernel timing at 64 x 1,048,576 and 8 x 421,642 f32")
    times = timing()
    codec = codec_times()
    log("CODECS " + json.dumps(codec))
    times.update(codec_entries(codec))
    ragged_times = ragged_kernel_times()
    log("RAGGED_KERNELS " + json.dumps(ragged_times))
    times.update(ragged_entries(ragged_times))
    log("AGGREGATORS at 64 x 65,536 f32 " + json.dumps(aggregator_times()))
    log("SUBSET_SEARCH at ByzPy's shapes " + json.dumps(subset_search_times()))

    entries = []
    for key, source, replaces in KERNELS:
        t = times[key]
        entry = {
            "name": key, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[key], "max_abs_err": errs[key],
        }
        if key in CODEC_COUNTERS:
            entry["launches_by_counter"] = {p: counts[p] for p in CODEC_COUNTERS[key]}
        entry.update(t)
        entries.append(entry)
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
