#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (byzpy_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. device probe: the card's name and power limit (``nvidia-smi``);
2. kernel build from ``byzpy_tpu_torch/csrc`` with ``nvcc`` (timed);
3. every kernel (B1 sorted reduce, B3 Gram, B4 selection mean, B8 NNM,
   B9 NNM -> selection mean, B10 clip / ARC -> selection mean) against its
   plain PyTorch version on the card, at the main path's shapes, at the
   64 x 1,048,576 headline and, for B8-B10, on rows holding NaN and inf;
4. the main path: the SmallCNN parameter-server round (d = 421,642, 8
   nodes of which 2 sign-flip the honest mean, batch 64) for 5 steps with
   each configuration: coordinate median, trimmed mean (f=2), Multi-Krum
   (f=2, q=4), and the pre-aggregated ones (a) static clipping + trimmed
   mean, (b) NNM + coordinate median, (c) NNM + Multi-Krum, (d) clipping
   + Multi-Krum, (e) ARC + Multi-Krum; each configuration's kernels must
   launch, its clip must engage at step 1, losses stay finite, and the
   first 2 steps match the same round on the CPU; 3 more steps run under
   torch.profiler for the device's busy share and kernel breakdown;
5. kernel timing at 64 x 1,048,576 f32 (and at the main path's 8 x
   421,642) beside the card's bound, the plain version and, where one
   exists, a single PyTorch call.

TF32 is off for matmuls and cuDNN convolutions, so f32 stays f32. The
line before the last is a JSON object with every kernel; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, the script exits nonzero and prints no result.
"""

from __future__ import annotations

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
PEAK_F32_OPS_PER_S = 67e12  # non-tensor-core f32; int32 min/max counted at this rate too

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
PRE_ARGS = {8: (2, 2, 4, 1000.0), 13: (3, 3, 4, 300.0), 64: (8, 8, 12, 1500.0)}


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
    """Largest distance in ulps of ``a``'s dtype (f32 or bf16) over entries
    finite in both; NaN and +-inf must sit at the same places (NaN payloads
    may differ: the card's f32 -> bf16 conversion has its own NaN)."""
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
    shift = 16 if a.dtype == torch.bfloat16 else 0
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
    import torch

    from byzpy_tpu_torch.ops import kernels

    shapes = [(2, n, 100_003) for n in (7, 8, 64, 128)] + [(1, MAIN_N, 421_642)]
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = random_rounds(shape, seed=shape[1], specials=True, dtype=dtype)
            n = shape[1]
            med = kernels.sorted_reduce_stream(x, mode="median")
            ref = kernels.sorted_reduce_stream_plain(x, mode="median")
            ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
            check(torch.equal(med.view(ints), ref.view(ints)),
                  f"B1 median differs from plain at {shape} {dtype}")
            f = 2 if n == MAIN_N else (n - 1) // 3
            tm = kernels.sorted_reduce_stream(x, mode="trimmed", f=f)
            tref = kernels.sorted_reduce_stream_plain(x, mode="trimmed", f=f)
            ulps = ulp_diff(tm, tref)
            check(ulps <= 2, f"B1 trimmed mean {ulps} ulp from plain at {shape} {dtype}")
            errs["sorted_reduce:median"] = max(errs["sorted_reduce:median"], max_abs_err(med, ref))
            errs["sorted_reduce:trimmed"] = max(errs["sorted_reduce:trimmed"], max_abs_err(tm, tref))
            log(f"  B1 {tuple(shape)} {str(dtype)[6:]}: median bitwise, trimmed {ulps} ulp")


def check_gram_and_selection(errs: dict) -> None:
    import torch

    from byzpy_tpu_torch.ops import kernels

    cases = [
        ((1, MAIN_N, 421_642), 2, 4, ("krum",)),
        ((2, 13, 50_000), 3, 5, ("krum", "cge", "monna")),
        ((4,) + HEADLINE, 8, 12, ("krum",)),
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
    import torch

    nan = torch.isnan(t)
    return bool(torch.equal(t[nan].float().view(torch.int32),
                            torch.full_like(t[nan].float(), float("nan")).view(torch.int32)))


def check_pre_aggregation(errs: dict) -> None:
    """B8, B9, B10-clip and B10-arc against their plain versions: each
    weights launch bitwise on the kernel Gram, each sweep bitwise (B8) or
    within 2 ulp (B9/B10 through B4's sweep), and the whole call selects
    the rows that the plain Gram selects."""
    import torch

    from byzpy_tpu_torch.ops import kernels
    from byzpy_tpu_torch.ops.preagg import arc_cut_off

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


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def main_path(counts: dict) -> dict:
    import torch

    from byzpy_tpu_torch.models import SmallCNN, make_bundle, synthetic_classification
    from byzpy_tpu_torch.ops import attack_ops, kernels, preagg, robust
    from byzpy_tpu_torch.parallel import PSStepConfig, build_ps_train_step

    n, b, batch = MAIN_N, MAIN_BYZ, MAIN_BATCH
    cfg = PSStepConfig(n_nodes=n, n_byzantine=b)
    # name -> (pre_aggregate, aggregate, kernels that must launch, the
    # threshold rule whose clipped rows at step 1 are counted)
    sweep = "weighted_rows"
    aggregators = {
        "coordinate_median": (None, robust.coordinate_median, ["sorted_reduce:median"], None),
        "trimmed_mean": (None, lambda m: robust.trimmed_mean(m, f=b), ["sorted_reduce:trimmed"],
                         None),
        "multi_krum": (None, lambda m: robust.multi_krum(m, f=b, q=4),
                       ["gram", "selection_weights:krum", sweep], None),
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
    }
    first_norms = {}

    def recording(name, fn):
        """``fn`` that keeps the row norms of the first CUDA matrix it sees
        (a host copy at step 1, outside the steps the median is taken of)."""
        def call(m):
            if m.is_cuda and name not in first_norms:
                first_norms[name] = torch.linalg.vector_norm(m.float(), dim=1).cpu()
            return fn(m)
        return call

    def attack(honest, generator):
        return attack_ops.sign_flip(honest.mean(dim=0))

    cpu_bundle = make_bundle(SmallCNN(), seed=0, device="cpu")
    d = sum(int(v.numel()) for v in cpu_bundle.params.values())
    check(d == 421_642, f"SmallCNN has d={d}")
    results = {}
    for name, (pre, agg, kernel_keys, clip_rule) in aggregators.items():
        if pre is not None:
            pre = recording(name, pre)
        else:
            agg = recording(name, agg)
        data = {}
        for dev in ("cuda", "cpu"):
            x, y = synthetic_classification(n_samples=n * batch, seed=3, device=dev)
            xs, ys = x.reshape(n, batch, 28, 28, 1), y.reshape(n, batch)
            bundle = make_bundle(SmallCNN(), seed=0, device=dev)
            step, opt = build_ps_train_step(bundle, agg, cfg, attack=attack, pre_aggregate=pre)
            params = bundle.params
            snaps, losses, times = [], [], []
            steps = MAIN_STEPS if dev == "cuda" else CPU_STEPS
            if dev == "cuda":
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
            for s in range(steps):
                t0 = time.perf_counter()
                params, opt, metrics = step(params, opt, xs, ys)
                if dev == "cuda":
                    torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(metrics["honest_loss"]))
                if s < CPU_STEPS:
                    snaps.append({k: v.detach().cpu().clone() for k, v in params.items()})
            if dev == "cuda":
                run_counts = dict(kernels.launch_counts)
                for k in kernel_keys:
                    check(run_counts[k] > 0, f"{name}: kernel {k} never launched on the main path")
                    counts[k] += run_counts[k]
                profile = profile_steps(step, params, opt, xs, ys)
            data[dev] = (snaps, losses, times)
        snaps, losses, times = data["cuda"]
        check(all(map(math.isfinite, losses)), f"{name}: loss not finite {losses}")
        worst = 0.0
        for s, (g_snap, c_snap) in enumerate(zip(snaps, data["cpu"][0])):
            for k in g_snap:
                check(
                    torch.allclose(g_snap[k], c_snap[k], rtol=PARAM_RTOL, atol=PARAM_ATOL),
                    f"{name}: step {s + 1} {k} differs from the CPU port",
                )
                worst = max(worst, float((g_snap[k] - c_snap[k]).abs().max()))
        ms_step = sorted(times[1:])[len(times[1:]) // 2]
        clipped = None
        if clip_rule is not None:
            norms = first_norms[name]
            threshold = (MAIN_TAU if clip_rule == "clip"
                         else float(torch.sort(norms).values[preagg.arc_cut_off(n, b) - 1]))
            clipped = int((norms > threshold).sum())
            check(0 < clipped < n, f"{name}: the clip took {clipped} of {n} rows at step 1")
        results[name] = {
            "ms_per_step": ms_step, "first_step_ms": times[0], "losses": losses,
            "cpu_max_abs_param_diff": worst, "launches": {k: run_counts[k] for k in kernel_keys},
            "profile": profile,
            "device_busy_share": profile["device_ms_per_step"] / ms_step,
            "clipped_rows_step1": clipped,
            "row_norms_step1": [round(float(v), 4) for v in first_norms[name]],
        }
        log(f"  {name}: {ms_step:.3f} ms/step (median of steps 2-{MAIN_STEPS}; first "
            f"{times[0]:.1f} ms), losses {[round(v, 4) for v in losses]}, "
            f"params vs CPU max |diff| {worst:.3g}, launches {results[name]['launches']}, "
            f"device busy {results[name]['device_busy_share']:.3f}, rows clipped at step 1 "
            f"{clipped} (norms {results[name]['row_norms_step1']})")
        log(f"    profile: {json.dumps(profile)}")
    return results


PORT_KERNELS = ("sorted_reduce_kernel", "gram_partial_kernel", "gram_reduce_kernel",
                "selection_weights_kernel", "weighted_rows_kernel", "nnm_weights_kernel",
                "mix_rows_kernel", "nnm_selection_weights_kernel", "clip_selection_weights_kernel")


def profile_steps(step, params, opt, xs, ys, steps: int = 3) -> dict:
    """Device time of ``steps`` PS steps by kernel (torch.profiler): the
    total, the port's kernels' part, the launches and the largest kernels.
    The profiler slows the host, so the busy share divides by the
    unprofiled step time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            params, opt, _ = step(params, opt, xs, ys)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for ev in prof.key_averages():
        # device-side events only: an operator's row repeats its kernels' time
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        by_kernel[ev.key] = (dev_us / 1e3 / steps, ev.count / steps)
    device_ms = sum(v[0] for v in by_kernel.values())
    ours = {}
    for key, (ms, count) in by_kernel.items():
        for p in PORT_KERNELS:
            if re.search(rf"\b{p}\b", key):  # selection_weights_kernel is in nnm_selection_...
                ms0, count0 = ours.get(p, (0.0, 0.0))
                ours[p] = (ms0 + ms, count0 + count)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    return {
        "profiled_wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": device_ms,
        "port_kernels_ms_per_step": sum(v[0] for v in ours.values()),
        "port_kernels": {p: [ms, count] for p, (ms, count) in ours.items()},
        "device_launches_per_step": sum(v[1] for v in by_kernel.values()),
        "top": [[k[:60], round(v[0], 4), v[1]] for k, v in top],
    }


# ---------------------------------------------------------------------------
# phase 5: kernel timing
# ---------------------------------------------------------------------------


def bound_ms(bytes_moved: float, ops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_times(n: int, d: int, *, f_trim: int, f_krum: int, q: int, seed: int) -> dict:
    """Each kernel's time on one (1, n, d) f32 round beside its bound, its
    plain version and, where one exists, a single PyTorch call."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    x = random_rounds((1, n, d), seed=seed)
    isz = x.element_size()
    rows_in = n * d * isz
    out = {}
    pairs = len(kernels.batcher_pairs(kernels.network_width(n)))
    sort_ops = 2 * pairs * d  # one int32 min and one max per compare-exchange
    for mode, f in (("median", 0), ("trimmed", f_trim)):
        adds = 0 if mode == "median" else (n - 2 * f) * d
        b_ms, b_by = bound_ms(rows_in + d * isz, sort_ops + adds)
        out[f"sorted_reduce:{mode}"] = {
            "ms": cuda_time_ms(lambda: kernels.sorted_reduce_stream(x, mode=mode, f=f)),
            "plain_ms": cuda_time_ms(lambda: kernels.sorted_reduce_stream_plain(x, mode=mode, f=f), iters=3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "shape": [1, n, d],
        }
    gram_ops = n * (n + 1) * d  # symmetric half, 2 flops per FMA
    b_ms, b_by = bound_ms(rows_in + n * n * 4, gram_ops)
    out["gram"] = {
        "ms": cuda_time_ms(lambda: kernels.gram(x)),
        "plain_ms": cuda_time_ms(lambda: kernels.gram_plain(x)),
        "library_ms": cuda_time_ms(lambda: x[0] @ x[0].T),
        "bound_ms": b_ms, "bound_by": b_by, "shape": [1, n, d],
    }

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
    b_ms, b_by = bound_ms(q * d * isz + n * 4 + d * isz, 2 * q * d)
    out["weighted_rows"] = {
        "ms": cuda_time_ms(lambda: kernels.weighted_rows(x, w)),
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
    b_ms, b_by = bound_ms(2 * n * d * isz + gram_bytes + n * 4, n * k * d)
    out["mix_rows"] = {
        "ms": cuda_time_ms(lambda: kernels.mix_rows(x, mask, st, k=k)),
        "plain_ms": cuda_time_ms(lambda: kernels.mix_rows_plain(x, mask, st, k=k), iters=3),
        # (mask^T x) / k: the same function on these finite inputs
        "library_ms": cuda_time_ms(lambda: (mask[0].T @ x[0]) / k),
        "bound_ms": b_ms, "bound_by": b_by, "shape": [1, n, d],
    }

    sel = dict(f=f, q=q, mode="krum")
    w_nnm = kernels.nnm_selection_weights(g, k=k, **sel)
    # GA and Gm add k selected terms per entry, w_eff k per row
    b_ms, b_by = bound_ms(gram_bytes + n * 4, krum_ops + 2 * n * n * k + n * k)

    def nnm_selection_plain():
        wp = kernels.nnm_selection_weights_plain(kernels.gram_plain(x), k=k, **sel)
        return kernels.weighted_rows_plain(x, wp)

    out["nnm_selection_weights:krum"] = {
        "ms": cuda_time_ms(lambda: kernels.nnm_selection_weights(g, k=k, **sel)),
        "plain_ms": cuda_time_ms(lambda: kernels.nnm_selection_weights_plain(g, k=k, **sel)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "shape": [1, n, d],
        "nnm_selection_mean_ms": cuda_time_ms(
            lambda: kernels.nnm_selection_mean_stream(x, f_nnm=f_pre, **sel)),
        "nnm_selection_mean_plain_ms": cuda_time_ms(nnm_selection_plain, iters=3),
    }
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


def timing() -> dict:
    """Kernel times at the headline 64 x 1,048,576 (the JSON line's
    numbers) and at the main path's 8 x 421,642. ``torch.median`` returns
    the lower middle value, the median kernel's function only at odd n, so
    the median's entry is taken at 63 x 1,048,576, where that library call
    computes the same function on the same inputs; its n = 64 numbers sit
    beside it under ``at_headline``."""
    n, d = HEADLINE
    out = kernel_times(n, d, f_trim=8, f_krum=8, q=12, seed=7)
    odd = kernel_times(n - 1, d, f_trim=8, f_krum=8, q=12, seed=8)["sorted_reduce:median"]
    out["sorted_reduce:median"] = dict(odd, at_headline=out["sorted_reduce:median"])
    main = kernel_times(MAIN_N, 421_642, f_trim=MAIN_BYZ, f_krum=MAIN_BYZ, q=4, seed=9)
    for times, shape, seed in ((out, HEADLINE, 17), (main, (MAIN_N, 421_642), 19)):
        pre = pre_kernel_times(*shape, seed=seed)
        times["weighted_rows"].update(pre.pop("weighted_rows"))
        times.update(pre)
    keys = ("shape", "ms", "plain_ms", "bound_ms", "library_ms", "with_nnm_weights",
            "with_clip_weights")
    for k, v in out.items():
        v["main_path_shape"] = {key: main[k][key] for key in keys if key in main[k]}
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
]


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

    log("== 3. kernels against their plain versions")
    errs = {key: 0.0 for key, _, _ in KERNELS}
    errs.update({"selection_weights:cge": 0.0, "selection_weights:monna": 0.0})
    check_sorted_reduce(errs)
    check_gram_and_selection(errs)
    check_pre_aggregation(errs)

    log("== 4. main path: SmallCNN PS round, plain and pre-aggregated configurations")
    counts = {k: 0 for k in kernels.launch_counts}
    results = main_path(counts)
    log("MAIN_PATH " + json.dumps(results))

    log("== 5. kernel timing at 64 x 1,048,576 and 8 x 421,642 f32")
    times = timing()

    entries = []
    for key, source, replaces in KERNELS:
        t = times[key]
        entry = {
            "name": key, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[key], "max_abs_err": errs[key],
        }
        entry.update(t)
        entries.append(entry)
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
