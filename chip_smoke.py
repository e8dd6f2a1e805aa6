#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (byzpy_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

``--phases 4j,4k`` runs the device probe, the build and the phases named
(of 3, 4, 4b-4h, 5, 4i, 4j, 4k, 4l) and ends on the ``ok`` line without the
kernels line (its numbers need phases 3 and 5); with no argument every
phase runs, as below.

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
   and their one-step phases, bit for bit with the iteration counts; its
   masked Weiszfeld mode bit for bit with the count in f32, bf16 and f16
   at 8, 64 and 128 rows of 50,001 with padding rows, padded equal to
   compacted, and on rows holding NaN and +-inf), B8
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
   step, their host reads per aggregation counted: at most 1 and 0; CAF's
   fixed passes 0);
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
   and geometric median: exactly their listed launches (B2, B3, B11, the
   row reduction and B7's masked mode, one launch a geometric-median step;
   never B1, B4, B6 or B7's unmasked modes), the padded step bit for bit
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
   program's on the decoded rows and (s4) the CPU port's; then (4e) the
   compiled step, with cuDNN's deterministic algorithms: each compiled
   twin (``jit_ps_train_step``, ``jit_serving_ps_step``,
   ``jit_ragged_serving_ps_step``: a CUDA graph captured once and replayed)
   runs 5 steps from the eager step's start, its parameters, optimizer
   state and metrics bit for bit the eager step's at every step, its
   counted launches the capture's once and one ``graph_replay:<twin>`` a
   step: (u) BASELINE config #5 at full width, ResNet-50 at 224 x 224
   (bf16 compute, d = 25,557,032), 8 nodes of which 2 send Empire rows, 16
   images a node, bf16 gradients, centred clipping (M = 3, some but not
   all rows clipped at step 1), with its peak memory, the per-node forward
   and backward's device ms and B7's; (v) ResNet-18 at 32 x 32 (d =
   11,173,962) with Multi-Krum; (w) SmallCNN's median, trimmed mean,
   Multi-Krum, CGE, geometric median, centred clipping, (h) int8 + EF
   median and (p) SMEA; (x) the serving step at bucket 64 (Multi-Krum,
   MeaMed) and the ragged step at capacity 64 (trimmed mean, cohorts of 6
   to 64 rows in one graph), each also equal to ``CohortAggregator``; host
   and device ms, host-issued and device launches a step, eager beside
   compiled, and the capture's launches and wall ms; (y) MDA and influence
   ascent through a twin: each capture refused with ``GraphCaptureError``
   naming the host-reading callable; CAF (fixed passes) in the PS step and
   the masked geometric median (B7's masked mode) in the serving step at
   bucket 64: each captured, 5 compiled steps bit for bit the eager ones,
   no host read a compiled step or an eager aggregation; then (4f) the
   engine, every await bounded: (a) BASELINE
   config #1, ``CoordinateWiseMedian`` on 10 x 100,000 as a
   single-operator graph under ``NodeScheduler`` on a thread and a cuda
   actor pool of 4 (16 chunks of 6,250 columns: exactly 16 B1 launches,
   bit for bit the direct call and the plain version; beside it 16 empty
   subtasks, and the pooled run at a 0.1 ms interpreter switch interval);
   (b) config #2, ``MultiKrum(f=8, q=12)`` at 64 x 1,048,576
   on a cuda pool of 4 (16 row ranges; the selection of B3 + B4, the
   aggregate within 1e-6 of its largest value, B4's sweep launched once;
   a torch.profiler trace with the subtasks' kernels on two streams or
   more besides the caller's); (c) ByzPy's pool table at its shapes
   through ``run_operator`` with no pool and on cuda pools of 2, 4 and 6,
   host ms beside ByzPy's, each pooled result the direct one's bits
   (coordinate-wise work and the row selections) or within rtol 1e-6,
   atol 3e-6 (Little) or 1e-4 (the geometric median's and centred
   clipping's barriered loops); (d) ByzPy's 4-branch scheduler pipeline
   at 64 x 200,000 under ``NodeScheduler`` and ``ParallelScheduler`` on
   cuda pools of 2, 4 and 6, the two schedulers' outputs bit for bit;
   (e) configs #1 and #2 on a pool of 6 bit for bit a pool of 1, a
   ``jit_ps_train_step`` capture refused with ``GraphCaptureError`` while
   a pool's call runs and captured after the pool closed; then (4g) the
   orchestrators, every await bounded, host ms and launches a round
   beside the card's name and power limit: (a) BASELINE config #3 at
   ``examples/ps/thread_mnist.py``'s shape (6 ``mnist_mlp(hidden=128)``
   nodes and 2 sign-flip nodes in ``cuda`` actors, the trimmed mean f = 2,
   30 rounds through ``train_with_progress_async``: accuracy > 0.5, one
   B1 launch a round, each aggregate the direct call's bits; again on
   ``thread`` actors, the same bits); (b) ``ParameterServer`` on SmallCNN
   (6 + 2 ``cuda`` actors, 5 rounds a configuration): the trimmed mean
   serial, overlapped with the barrier ingest (bit for bit the serial
   round, aggregates and every node's parameters) and streaming (the
   incremental fold, within rtol 1e-5 of the serial round), Multi-Krum
   streaming (B5 alone), NNM + Multi-Krum (the fused pipeline: B3, B9,
   B4's sweep) and the geometric median on a cuda pool of 2 (within the
   barriered loop's tolerance); (c) ``ElasticPolicy``: a node raises in
   round 2, another outlives the call timeout in round 3 (its NaN result
   never gathered), both resynced and re-admitted, every aggregate the
   direct call over the survivors, then ``QuorumLostError``; (d)
   ``PeerToPeer`` at ``examples/p2p/gossip_mnist.py``'s shape (40
   rounds, worker 0's accuracy > 0.5), then SmallCNN on ``ring(8, 2)``
   with 2 Empire peers and the geometric median, the barrier and
   streaming rounds the same bits and each aggregate the direct call on
   its node's vectors in arrival order; (e)
   ``examples/p2p/decentralized_autonomous.py``'s cluster (spread <
   0.15); (f) ``HeartbeatPolicy`` removing a peer that stopped answering,
   the rounds after it the bits of a run without the peer; then (4h)
   BASELINE config #4 at ``examples/p2p/resnet_cifar_gossip.py``'s shape
   (ResNet-18 at 64 filters, d = 11,173,962, GroupNorm with gcd(32, 64)
   groups; 8 nodes on ring(8, 2), node 7 byzantine, 32 images a node from
   4 rotating batches, lr 0.05; NNM f = 1 then ``geometric_median(max_iter
   = 32)``) through ``jit_gossip_train_step`` with cuDNN's deterministic
   algorithms: the example's 10 compiled steps, the first 5 bit for bit
   the eager steps (theta and the honest loss), the capture exactly 8
   launches each of B3, B8's two kernels, B1 and B7 and one
   ``graph_replay:gossip_train_step`` a step; the same graph on to step 40,
   the honest loss of steps 37-40 below step 1's (lr 0.05 overshoots first
   at this width, in the reference too); then 5 steps
   with a Gaussian attack drawn from the step's generator, bit for bit;
   host ms eager and compiled, the graph's span, peak memory, the
   per-node forward and backward's and B7's device ms, each node's
   Weiszfeld count read after each replay;
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
   B11, B7's masked mode (10 forced steps, 3 of 4 rows valid) at the
   headline and 64 x 421,642, and the ragged door's segmented sort beside
   B2; the segmented
   sort-reduce at the (n) batch, at 4 x 32 rows in 128 and at one cohort
   of 64 in 64 x 1,048,576, beside its plain version, the generic door on
   the same batch and (at the last) B1; B7's loop at 10, 1 and 256
   forced steps beside (steps + 1) reads of x; then the six
   centre-seeking and coordinate aggregators, whole, at ByzPy's grid
   shapes (64 x 65,536); then MDA (30 x 2,048, f = 10) and SMEA (16 x
   4,096, f = 5), whole, at ByzPy's subset-search shapes: host and device
   ms, launches and host reads of a call, the subset against the CPU
   port's, beside ByzPy's direct times (BASELINE.md).

After the timing, phase 4i (more than 128 rows, the out-of-process tier)
and phase 4j: (a) three ``NodeRunner`` children on the card stepping
SmallCNN workers under ``StepParameterServer`` with the trimmed mean, 5
rounds bit for bit the same rounds in process, and a ``TcpMailbox``
round trip of a tensor; (b) ``MeshRemoteContext`` at
``examples/p2p/mesh_tcp.py``'s shape on loopback, the aggregates bit for
bit an ``InProcessContext`` run, a killed peer re-dialled by the monitor;
(c) the CLI: ``doctor`` names the card and builds every source, ``bench``
(any row with an error fails), ``list``, a short ``study``; (d) the mesh
PS round on one NCCL rank at ResNet-18's full width (8 nodes, 2
sign-flipping, 32 images each, 5 steps) for the trimmed mean, Multi-Krum,
the geometric median and clip + trimmed mean, the sharded update on and
off, the int8 transpose and gather: the trimmed mean bit for bit the
``mesh=None`` round, the others within f32 rounding (the geometric median
1e-3: its two loops stop on their own sums), the compressed ones within
the codec bound, the traffic record equal to ``comms.ps_round_wire_bytes``,
each configuration's kernels launched every step, host ms, launches and
peak memory printed; (e) 2 and 4 gloo ranks sharing the card (CUDA
tensors through gloo), every rank's parameters equal, within 1e-4 of the
single-device round (a rank's vmap holds fewer nodes, and cuDNN's
per-node gradients move in their last bits with that).

Last, phase 4k: on one NCCL rank, (a) ``jit_ps_train_step(mesh=)`` at
ResNet-18's full width (8 x 64 images, the trimmed mean and Multi-Krum,
the sharded update on), its replays bit for bit the eager mesh steps
(``compiled_vs_eager``), the traffic record against the law, and the
geometric median's sharded form refused at the capture; (b) the gossip
round over the mesh at ResNet-18's width on ring(8, 2), the median and
NNM + Multi-Krum with the sharded update off and on (the median bit for
bit, NNM + Multi-Krum within 1e-4 of the largest weight), and the
median's round compiled, bit for bit its eager steps; (e)
``ParameterServer(update_sharding="on")`` against ``None`` on SmallCNN's
gradients (the trimmed mean bit for bit, NNM -> Multi-Krum within f32
rounding); then on 4 gloo ranks sharing the card, (c) the ring(4, 2) round
at ResNet-18's width, the shard split bit for bit the unsplit round and
the int8 payload within a code step a step, and (d) the (2, 2) grid round
of SmallCNN, within 1e-4 of the largest weight from the single-device
round, its all-gather equal to the law's term for 4 shards. Host ms a step,
peak GiB and launches are printed beside the card's name and power limit.

Last, phase 4l: ``ServingFrontend`` at SmallCNN's width (d = 421,642,
each client's gradient its own batch of 64), (a) four tenants (the
trimmed mean f = 2, the median, Multi-Krum f = 2, q = 4 with forensics on,
the geometric median), cohorts of 6, 13, 29 and 64 clients with 2
sign-flipped, 5 rounds each, through in-process ``submit`` and
``close_round_nowait`` with the ragged door on: every round's aggregate
bit for bit the port's executor called directly on the same submissions,
each family's kernels launched and no plain version called; (b) the same
with the door off (``CohortAggregator`` on the ladder's bucket); (c)
``serve()`` and ``ServingClient`` over loopback TCP, 16 clients on 4
connections, the async scheduler closing a Multi-Krum round, the wire off,
int8 and s4, bit for bit the executor on the rows the wire delivered, B12
and the B14 / B17 decode launched for the compressed modes; (d) a WAL and
snapshots in a temporary directory, then ``recover``: the recovered round's
digest equals an uninterrupted run's; (e) a trimmed-mean tenant at
ResNet-18's width (d = 11,173,962), 8 clients, 2 rounds. It prints submit
and close-to-aggregate host ms, the launches, device ms and host reads of a
round, and peak GiB.

TF32 is off for matmuls and cuDNN convolutions, so f32 stays f32. The
line before the last is a JSON object with every kernel; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import asyncio
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


_START = time.perf_counter()


def log(msg: str) -> None:
    if msg.startswith("== "):
        msg += f" [{time.perf_counter() - _START:.0f} s]"
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


# B7's masked modes in phase 3: (rows, valid rows, columns)
MASKED_LOOP_CASES = ((8, 6, 50_001), (64, 41, 50_001), (128, 100, 50_001))
# the masked modes' runs in phase 3: Weiszfeld to tol 1e-6 (at most 256
# steps) and 10 forced steps; centred clipping 10 and 3 steps at c_tau
# MASKED_CLIP_CTAU * sqrt(d) (the rows' scales run 0.1-50: some clip)
MASKED_CLIP_CTAU = 10.0


def masked_loop_runs(mode: str, d: int) -> tuple:
    """The keyword arguments of ``kernels.center_loop``'s phase-3 runs."""
    if mode == "masked_clip":
        c_tau = MASKED_CLIP_CTAU * d ** 0.5
        return dict(c_tau=c_tau, max_iter=10), dict(c_tau=c_tau, max_iter=3)
    return dict(tol=1e-6, max_iter=256), dict(tol=-1.0, max_iter=10)


def check_masked_center_loop(errs: dict) -> None:
    """B7's masked modes (``masked_weiszfeld``, ``masked_clip``) against
    their plain version, bit for bit with the iteration count, in f32, bf16
    and f16 at 8, 64 and 128 rows of an odd d, each with padding rows
    (zeros; the valid rows shuffled among them), to tol 1e-6 (at most 256
    steps) and 10 forced steps (centred clipping: 10 and 3 steps); then on
    rows holding NaN and +-inf after one step, in a valid row (the centre
    turns canonical NaN) and in a padding row (whose weight 0 still reads
    it: 0 * inf is NaN, as in B11's chain: three NaN columns); one launch
    a loop, and the padded loop equal to the compacted one bit for bit."""
    import torch

    from byzpy_tpu_torch.ops import kernels, robust

    for mode in ("masked_weiszfeld", "masked_clip"):
        key = f"center_loop:{mode}"
        clip = mode == "masked_clip"
        for n, m, d in MASKED_LOOP_CASES:
            for name in DTYPES:
                dtype = getattr(torch, name)
                gen = torch.Generator(device="cuda").manual_seed(900 + n)
                x = torch.zeros((n, d), device="cuda")
                x[:m] = masked_rows((m, d), 900 + n, torch.float32, specials=False)
                x = x[torch.randperm(n, generator=gen, device="cuda")].to(dtype).contiguous()
                valid = (x != 0).any(dim=1)
                check(int(valid.sum()) == m, f"B7 masked: {int(valid.sum())} valid rows, not {m}")
                z0 = robust.masked_mean(x, valid) if clip else robust._masked_median_rows(x, valid)
                steps = []
                runs = masked_loop_runs(mode, d)
                for run in runs:
                    kw = dict(mode=mode, valid=valid, **run)
                    before = dict(kernels.launch_counts)
                    out, its = kernels.center_loop(x, z0, **kw)
                    launched = {k: v - before[k] for k, v in kernels.launch_counts.items()
                                if v != before[k]}
                    check(launched == {key: 1}, f"B7 {mode} at {(n, d)} {name} launched {launched}")
                    ref, its_p = kernels.center_loop_plain(x, z0, **kw)
                    check(int(its) == int(its_p),
                          f"B7 {mode} at {(n, d)} {name}: {int(its)} steps, plain {int(its_p)}")
                    check(bits_equal(out, ref) and nan_is_canonical(out),
                          f"B7 {mode} differs from plain at {(n, d)} {name} ({int(its)} steps)")
                    errs[key] = max(errs[key], max_abs_err(out, ref))
                    steps.append(int(its))
                keep = valid.nonzero()[:, 0]
                compact, its_c = kernels.center_loop(
                    x.index_select(0, keep).contiguous(), z0, mode=mode,
                    valid=torch.ones(m, dtype=torch.bool, device="cuda"), **runs[0])
                out, its = kernels.center_loop(x, z0, mode=mode, valid=valid, **runs[0])
                check(bits_equal(out, compact) and int(its) == int(its_c),
                      f"B7 {mode} at {(n, d)} {name}: padded differs from compacted")
                log(f"  B7 {mode} {(n, d)} ({m} valid) {name}: {steps[0]} and {steps[1]} steps, "
                    f"one launch each, bitwise equal to plain with the counts; padded == compacted")
                del x, valid, z0, out, ref, compact
            torch.cuda.empty_cache()
        for name in DTYPES:
            dtype = getattr(torch, name)
            for case in ("valid_row", "padding_row"):
                x = torch.zeros((64, 50_001), device="cuda")
                x[:41] = masked_rows((41, 50_001), 77, torch.float32, specials=False)
                valid = torch.zeros(64, dtype=torch.bool, device="cuda")
                valid[:41] = True
                row = 5 if case == "valid_row" else 50
                x[row, 17], x[row, 18], x[row, 19] = float("nan"), float("inf"), -float("inf")
                x = x.to(dtype)
                z0 = robust.masked_mean(x, valid) if clip else robust._masked_median_rows(x, valid)
                # one step: the Weiszfeld loop stops after it (its step length is NaN)
                kw = dict(mode=mode, valid=valid, **(dict(runs[0], max_iter=1) if clip
                                                     else dict(max_iter=10)))
                out, its = kernels.center_loop(x, z0, **kw)
                ref, its_p = kernels.center_loop_plain(x, z0, **kw)
                # a valid row's NaN weight reaches every column; a padding row's
                # weight 0 meets its NaN and +-inf entries only
                nan = torch.isnan(out)
                want = (bool(nan.all()) if case == "valid_row"
                        else nan.nonzero()[:, 0].tolist() == [17, 18, 19])
                check(want and nan_is_canonical(out) and int(its) == 1 and bits_equal(out, ref)
                      and int(its_p) == 1,
                      f"B7 {mode} with NaN and +-inf in a {case} in {name}: {int(its)} steps "
                      f"(plain {int(its_p)}), NaN at {nan.nonzero()[:8, 0].tolist()}")
            log(f"  B7 {mode} {name}: NaN and +-inf in a valid row make the centre canonical NaN, "
                f"in a padding row its three columns, after one step, bitwise the plain version")
        try:
            kernels.center_loop(torch.zeros((129, 16), device="cuda"), torch.zeros(16, device="cuda"),
                                mode=mode, valid=torch.ones(129, dtype=torch.bool, device="cuda"))
            check(False, f"B7's {mode} mode took n = 129")
        except NotImplementedError:
            pass


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
    all-inf row at R > 7), NaN canonical; a batch of 256 rows (slots of
    128, 100 and 27) too, R being free; a slot of 129 rows writes NaN."""
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
    x = masked_rows((256, 50_001), 1190, torch.float32, specials=False)
    for mode, f in SEGMENTED_MODES:
        out = kernels.segmented_sort_reduce(x, *ragged_layout((128, 100, 27), 1), mode=mode, f=f)
        ref = kernels.segmented_sort_reduce_plain(x, *ragged_layout((128, 100, 27), 1), mode=mode, f=f)
        check(bits_equal(out, ref), f"segmented sort-reduce {mode} f={f} differs from plain at R = 256")
        long = kernels.segmented_sort_reduce(x, *ragged_layout((129,)), mode=mode, f=f)
        check(nan_is_canonical(long) and bool(torch.isnan(long).all()),
              "the segmented sort-reduce wrote a 129-row slot")
    log("  segmented sort-reduce (256, 50001) cohorts [128, 100, 27] + 1 padding: bitwise equal to "
        "plain (R above 128); a 129-row slot writes NaN")
    del x


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
    # CAF's fixed passes read nothing on the host
    host_reads["caf"] = []
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
                    metrics["iterations"] = int(robust.last_iterations[loops[name]])
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
        if name == "caf":
            reads = host_reads[name]
            check(len(reads) >= MAIN_STEPS and max(reads) == 0,
                  f"caf: host reads per aggregation {reads}, not 0")
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
        # the start (the masked mean), then the whole loop in one launch of
        # B7's masked clip mode
        "serve_centered_clipping": (lambda dev: CenteredClipping(c_tau=MAIN_CTAU, M=10, device=dev),
                                    lambda it: {"segment_sum": 1, "center_loop:masked_clip": 1}),
        # the start (the masked median), then the whole Weiszfeld loop in
        # one launch of B7's masked mode
        "serve_geometric_median": (lambda dev: GeometricMedian(device=dev),
                                   lambda it: {"sort_columns": 1, "center_loop:masked_weiszfeld": 1}),
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
                           iterations=int(robust.last_iterations["geometric_median"]))
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
            cpu_iters.append(int(robust.last_iterations["geometric_median"]))
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


# ---------------------------------------------------------------------------
# phase 4e: the compiled step
# ---------------------------------------------------------------------------

# (u) BASELINE config #5 at full width: ResNet-50 at 224 x 224 (bf16 compute,
# f32 parameters, d = 25,557,032), 8 nodes of which 2 send Empire rows, 16
# images a node, bf16 gradients, centred clipping with M = 3
U_NODES, U_BYZ, U_BATCH, U_LR = 8, 2, 16, 0.01
# (u)'s clipping threshold: at step 1 the honest rows sit 24.95-26.47 from
# the rows' mean and the two Empire rows 19.14 on the H100 (torch 2.11), so
# 25.5 clips four; phase 4e fails if the first iteration clips none or all
U_CTAU = 25.5
# (v) ResNet-18 at 32 x 32 (d = 11,173,962), 8 nodes of which 2 sign-flip the
# honest mean, 64 images a node, Multi-Krum (f = 2, q = 4)
V_BATCH = 64
COMPILED_STEPS = 5
# the CUDA runtime and driver calls that put work on the card, as
# torch.profiler names them: a step's host-issued launches
HOST_LAUNCH = re.compile(r"^(cuda|cu)(LaunchKernel|LaunchCooperativeKernel|GraphLaunch|Memcpy|Memset)")


def tensors_of(tree) -> list:
    import torch

    from byzpy_tpu_torch.utils.trees import _spec

    leaves = []
    _spec(tree, leaves)
    return [t for t in leaves if isinstance(t, torch.Tensor)]


def states_bits_equal(a, b) -> bool:
    """Every tensor of two structures equal bit for bit (shapes, dtypes and
    bytes)."""
    import torch

    la, lb = tensors_of(a), tensors_of(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


# Host time a short profile waits inside its window before its first
# launch and after its last one: the profiler keeps only the device events
# that fall inside the window on the host's clock, and a profile of a few
# ms has recorded none of its launches late in a long run of this script
PROFILE_PAD_S = 0.025


def profile_host_device(run, steps: int = 3) -> dict:
    """``profile_steps``' device time and launches, and the host-issued
    launches a step: the CUDA API calls that put work on the card (kernel
    and graph launches, copies, memsets), by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)
    by_kernel = device_events(prof, steps)
    ours = port_part(by_kernel)
    host = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU and HOST_LAUNCH.match(ev.key):
            host[ev.key] = host.get(ev.key, 0.0) + ev.count / steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    return {
        "profiled_wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": sum(v[0] for v in by_kernel.values()),
        "device_launches_per_step": sum(v[1] for v in by_kernel.values()),
        "host_issued_per_step": sum(host.values()),
        "host_issued": host,
        "port_kernels": {p: [ms, count] for p, (ms, count) in ours.items()},
        "top": [[k[:60], round(v[0], 4), v[1]] for k, v in top],
    }


def span_ms(fn, reps: int = 3) -> float:
    """The device's time from before ``fn()``'s work to after it (CUDA
    events on the current stream), the median of ``reps`` calls: for a
    graph replay, the graph's time on the card."""
    import torch

    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return sorted(out)[len(out) // 2]


def compiled_vs_eager(name: str, eager, compiled, state0, inputs, kernel_keys, counts: dict) -> dict:
    """``COMPILED_STEPS`` eager steps, then as many of the compiled twin from
    the same start with the counts set to 0 just before and read just after,
    each step's parameters, optimizer state and metrics bit for bit the
    eager step's; the counts are the capture's launches once and a replay
    a step, ``kernel_keys`` among the captured. Then 3 more steps of each
    under torch.profiler. ``inputs(s)`` gives step s's other arguments."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    e_states, e_times = [], []
    p, o = state0
    for s in range(COMPILED_STEPS):
        (p, o, m), ms = timed(lambda: eager(p, o, *inputs(s)))
        e_states.append((p, o, m))
        e_times.append(ms)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    c_times = []
    p, o = state0
    for s in range(COMPILED_STEPS):
        (p, o, m), ms = timed(lambda: compiled(p, o, *inputs(s)))
        c_times.append(ms)
        check(states_bits_equal((p, o, m), e_states[s]),
              f"{name}: compiled step {s + 1} differs from the eager step")
    run_counts = {k: v for k, v in kernels.launch_counts.items() if v}
    capture = compiled.last_capture
    check(len(compiled.graphs) == 1, f"{name}: {len(compiled.graphs)} graphs captured, not 1")
    want = {**capture["launches"], compiled.counter: COMPILED_STEPS}
    check(run_counts == want, f"{name}: launches {run_counts}, not the capture's once and "
          f"{COMPILED_STEPS} replays {want}")
    for k in kernel_keys:
        check(capture["launches"].get(k, 0) > 0, f"{name}: kernel {k} is not in the captured step")
        counts[k] += capture["launches"][k]
    losses = [float(st[2].get("honest_loss", st[2]["agg_grad_norm"])) for st in e_states]
    check(all(map(math.isfinite, losses)), f"{name}: not finite {losses}")
    pe, oe = e_states[-1][:2]
    last = inputs(COMPILED_STEPS - 1)
    e_prof = profile_host_device(lambda: eager(pe, oe, *last))
    state = [p, o]

    def replay():
        state[0], state[1], _ = compiled(state[0], state[1], *last)

    c_prof = profile_host_device(replay)
    e_span, c_span = span_ms(lambda: eager(pe, oe, *last)), span_ms(replay)
    e_ms, c_ms = sorted(e_times[1:])[len(e_times[1:]) // 2], sorted(c_times[1:])[len(c_times[1:]) // 2]
    out = {
        "bitwise_steps": COMPILED_STEPS, "losses_or_norms": losses,
        "eager": {"host_ms": e_ms, "first_ms": e_times[0], "span_ms": e_span, "profile": e_prof,
                  "busy": e_prof["device_ms_per_step"] / e_ms},
        "compiled": {"host_ms": c_ms, "first_ms": c_times[0], "span_ms": c_span, "profile": c_prof,
                     "busy": c_prof["device_ms_per_step"] / c_ms},
        "capture": {"ms": capture["ms"], "launches": capture["launches"],
                    "warmup_launches": capture["warmup_launches"]},
        "first_eager_state": e_states[0],
    }
    log(f"  {name}: {COMPILED_STEPS} compiled steps == eager bitwise; host ms a step eager "
        f"{e_ms:.3f} / compiled {c_ms:.3f} (median of steps 2-{COMPILED_STEPS}); device ms "
        f"{e_prof['device_ms_per_step']:.4f} / {c_prof['device_ms_per_step']:.4f}; host-issued "
        f"launches a step {e_prof['host_issued_per_step']:.1f} / {c_prof['host_issued_per_step']:.1f} "
        f"(device launches {e_prof['device_launches_per_step']:.1f} / "
        f"{c_prof['device_launches_per_step']:.1f}); busy {out['eager']['busy']:.3f} / "
        f"{out['compiled']['busy']:.3f}; device span (CUDA events) {e_span:.3f} / {c_span:.3f} ms; "
        f"profiled wall {e_prof['profiled_wall_ms_per_step']:.3f} / "
        f"{c_prof['profiled_wall_ms_per_step']:.3f} ms; capture {capture['ms']:.1f} ms, its "
        f"launches {capture['launches']}")
    log(f"    host-issued eager {json.dumps(e_prof['host_issued'])}, compiled "
        f"{json.dumps(c_prof['host_issued'])}")
    log(f"    eager profile top {json.dumps(e_prof['top'])}; compiled {json.dumps(c_prof['top'])}; "
        f"compiled port kernels {json.dumps(c_prof['port_kernels'])}")
    return out


def ps_twins(bundle, agg, cfg, **kw):
    """The eager train step and its compiled twin, and the start."""
    from byzpy_tpu_torch.parallel import build_ps_train_step, jit_ps_train_step

    eager, opt0 = build_ps_train_step(bundle, agg, cfg, **kw)
    compiled, copt0 = jit_ps_train_step(bundle, agg, cfg, **kw)
    check(states_bits_equal(opt0, copt0), "the twin's opt_state0 differs from the eager one")
    return eager, compiled, (bundle.params, opt0)


def compiled_resnet50(counts: dict) -> dict:
    """(u) BASELINE config #5 at full width, compiled."""
    import torch
    from torch.func import grad_and_value, vmap

    from byzpy_tpu_torch.models import imagenet_resnet50
    from byzpy_tpu_torch.ops import attack_ops, robust
    from byzpy_tpu_torch.parallel import PSStepConfig

    torch.cuda.reset_peak_memory_stats()
    bundle = imagenet_resnet50(seed=0, device="cuda")
    d = sum(int(v.numel()) for v in bundle.params.values())
    check(d == 25_557_032, f"imagenet_resnet50 has d={d}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    xs = torch.randn((U_NODES, U_BATCH, 224, 224, 3), generator=gen, device="cuda")
    ys = torch.randint(0, 1000, (U_NODES, U_BATCH), generator=gen, device="cuda")
    cfg = PSStepConfig(n_nodes=U_NODES, n_byzantine=U_BYZ, learning_rate=U_LR)
    first = {}

    def agg(m):
        return robust.centered_clipping(m, c_tau=U_CTAU, M=3)

    def recording(m):
        if "dists" not in first:
            check(m.dtype == torch.bfloat16, f"(u): the aggregator sees {m.dtype}, not bf16")
            mf = m.float()
            first["dists"] = torch.linalg.vector_norm(mf - mf.mean(dim=0), dim=1).cpu()
        return agg(m)

    kw = dict(attack=lambda honest, g: attack_ops.empire(honest), grad_dtype=torch.bfloat16)
    from byzpy_tpu_torch.parallel import build_ps_train_step, jit_ps_train_step

    eager, opt0 = build_ps_train_step(bundle, recording, cfg, **kw)
    compiled, _ = jit_ps_train_step(bundle, agg, cfg, **kw)
    res = compiled_vs_eager("(u) ResNet-50, centred clipping under Empire, bf16 gradients", eager,
                            compiled, (bundle.params, opt0), lambda s: (xs, ys), ["center_loop:clip"],
                            counts)
    dists = [round(float(v), 4) for v in first["dists"]]
    clipped = int((first["dists"] > U_CTAU).sum())
    log(f"    (u) step-1 distances of the rows from their mean {dists}, c_tau {U_CTAU}: "
        f"{clipped} of {U_NODES} clipped at the first iteration")
    check(0 < clipped < U_NODES, f"(u): the first iteration clipped {clipped} of {U_NODES} rows")
    per_node = vmap(grad_and_value(bundle.loss_fn), in_dims=(None, 0, 0))
    fwd_bwd = profile_host_device(lambda: per_node(bundle.params, xs, ys), steps=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    res.update(d=d, step1_row_dists=dists, c_tau=U_CTAU, clipped_step1=clipped,
               per_node_forward_backward_device_ms=fwd_bwd["device_ms_per_step"],
               per_node_forward_backward_top=fwd_bwd["top"],
               b7_device_ms=res["compiled"]["profile"]["port_kernels"].get("center_loop_kernel"),
               peak_memory_gib=peak)
    log(f"    (u) d = {d}; per-node forward and backward {fwd_bwd['device_ms_per_step']:.3f} device "
        f"ms ({json.dumps(fwd_bwd['top'])}); B7 {res['b7_device_ms']}; peak memory {peak:.2f} GiB")
    del bundle, eager, compiled, xs, ys
    torch.cuda.empty_cache()
    return res


def compiled_resnet18(counts: dict) -> dict:
    """(v) ResNet-18 at full width with Multi-Krum, compiled."""
    import torch

    from byzpy_tpu_torch.models import cifar_resnet18, synthetic_classification
    from byzpy_tpu_torch.ops import attack_ops, robust
    from byzpy_tpu_torch.parallel import PSStepConfig

    bundle = cifar_resnet18(seed=0, device="cuda")
    d = sum(int(v.numel()) for v in bundle.params.values())
    check(d == 11_173_962, f"cifar_resnet18 has d={d}")
    x, y = synthetic_classification(n_samples=MAIN_N * V_BATCH, input_shape=(32, 32, 3), seed=3,
                                    device="cuda")
    xs, ys = x.reshape(MAIN_N, V_BATCH, 32, 32, 3), y.reshape(MAIN_N, V_BATCH)
    cfg = PSStepConfig(n_nodes=MAIN_N, n_byzantine=MAIN_BYZ)
    eager, compiled, state0 = ps_twins(
        bundle, lambda m: robust.multi_krum(m, f=MAIN_BYZ, q=4), cfg,
        attack=lambda honest, g: attack_ops.sign_flip(honest.mean(dim=0)))
    res = compiled_vs_eager("(v) ResNet-18, Multi-Krum", eager, compiled, state0, lambda s: (xs, ys),
                            ["gram", "selection_weights:krum", "weighted_rows"], counts)
    res["d"] = d
    del bundle, eager, compiled
    torch.cuda.empty_cache()
    return res


def compiled_smallcnn(counts: dict) -> dict:
    """(w) SmallCNN's main path, compiled."""
    import torch

    from byzpy_tpu_torch.aggregators import SMEA
    from byzpy_tpu_torch.models import SmallCNN, make_bundle, synthetic_classification
    from byzpy_tpu_torch.ops import attack_ops, robust
    from byzpy_tpu_torch.parallel import CommPrecision, PSStepConfig

    b = MAIN_BYZ
    krum = ["gram", "selection_weights:krum", "weighted_rows"]
    configs = {
        "coordinate_median": (robust.coordinate_median, ["sorted_reduce:median"], None),
        "trimmed_mean": (lambda m: robust.trimmed_mean(m, f=b), ["sorted_reduce:trimmed"], None),
        "multi_krum": (lambda m: robust.multi_krum(m, f=b, q=4), krum, None),
        "cge": (lambda m: robust.cge(m, f=b), ["gram", "selection_weights:cge", "weighted_rows"], None),
        "geometric_median": (robust.geometric_median,
                             ["sorted_reduce:median", "center_loop:weiszfeld"], None),
        "centered_clipping": (lambda m: robust.centered_clipping(m, c_tau=MAIN_CTAU, M=10),
                              ["center_loop:clip"], None),
        "h_ps_int8_ef_median": (robust.coordinate_median,
                                ["quantize:int8", "dequantize:int8", "sorted_reduce:median"],
                                CommPrecision("int8", error_feedback=True)),
        "p_smea": (None, ["gram"], None),
    }
    x, y = synthetic_classification(n_samples=MAIN_N * MAIN_BATCH, seed=3, device="cuda")
    xs, ys = x.reshape(MAIN_N, MAIN_BATCH, 28, 28, 1), y.reshape(MAIN_N, MAIN_BATCH)
    cfg = PSStepConfig(n_nodes=MAIN_N, n_byzantine=b)
    results = {}
    for name, (agg, keys, comm) in configs.items():
        bundle = make_bundle(SmallCNN(), seed=0, device="cuda")
        if agg is None:
            agg = SMEA(b).matrix_fn()
        eager, compiled, state0 = ps_twins(
            bundle, agg, cfg, attack=lambda honest, g: attack_ops.sign_flip(honest.mean(dim=0)),
            comm_precision=comm)
        results[name] = compiled_vs_eager(f"(w) {name}", eager, compiled, state0, lambda s: (xs, ys),
                                          keys, counts)
        results[name].pop("first_eager_state")
    return results


def compiled_serving(counts: dict) -> dict:
    """(x) the serving twins at bucket and capacity 64."""
    import torch
    from torch.func import grad_and_value, vmap

    from byzpy_tpu_torch.aggregators import CoordinateWiseTrimmedMean, MeanOfMedians, MultiKrum
    from byzpy_tpu_torch.models import SmallCNN, make_bundle, synthetic_classification
    from byzpy_tpu_torch.parallel import (
        SGD, build_ragged_serving_ps_step, build_serving_ps_step, jit_ragged_serving_ps_step,
        jit_serving_ps_step,
    )
    from byzpy_tpu_torch.serving import BucketLadder, CohortAggregator, StalenessPolicy, build_cohort
    from byzpy_tpu_torch.utils import ravel_fn

    ladder = BucketLadder(SERVE_CAP, min_bucket=SERVE_MIN_BUCKET)
    policy = StalenessPolicy("exponential", gamma=0.5)
    clients = max(SERVE_COHORTS)
    x, y = synthetic_classification(n_samples=clients * MAIN_BATCH, seed=3, device="cuda")
    xs, ys = x.reshape(clients, MAIN_BATCH, 28, 28, 1), y.reshape(clients, MAIN_BATCH)
    bundle = make_bundle(SmallCNN(), seed=0, device="cuda")
    per_node = vmap(grad_and_value(bundle.loss_fn), in_dims=(None, 0, 0))
    ravel, _ = ravel_fn(bundle.params)
    names = list(bundle.params)
    d = sum(int(v.numel()) for v in bundle.params.values())
    subs = {m: cohort_submissions(per_node, names, bundle.params, bundle.params, xs, ys, m, d, 1)[0]
            for m in SERVE_COHORTS}
    results = {}
    bucketed = build_cohort(subs[64], 1, ladder, policy)
    bucket_in = (bucketed.matrix, torch.from_numpy(bucketed.valid).cuda(),
                 torch.from_numpy(bucketed.weights).cuda())
    for name, make, keys in (("serve_multi_krum", lambda: MultiKrum(MAIN_BYZ, 4), ["gram", "segment_sum"]),
                             ("serve_meamed", lambda: MeanOfMedians(MAIN_BYZ),
                              ["sort_columns", "segment_sum"])):
        agg = make()
        eager, opt0 = build_serving_ps_step(bundle, agg.masked_matrix_fn())
        compiled, _ = jit_serving_ps_step(bundle, agg.masked_matrix_fn())
        res = compiled_vs_eager(f"(x) {name}, bucket 64", eager, compiled, (bundle.params, opt0),
                                lambda s: bucket_in, keys, counts)
        p1 = res.pop("first_eager_state")[0]
        via = CohortAggregator(agg).aggregate(bucketed)
        p_ca, _ = SGD(0.05, momentum=0.9).step(ravel(bundle.params), via, opt0)
        check(bits_equal(p_ca, ravel(p1)), f"{name}: CohortAggregator does not give the step's parameters")
        res["cohort_aggregator_bitwise"] = True
        results[name] = res
    agg = CoordinateWiseTrimmedMean(MAIN_BYZ)
    eager, opt0 = build_ragged_serving_ps_step(bundle, agg.ragged_matrix_fn(), row_capacity=RAGGED_CAP)
    compiled, _ = jit_ragged_serving_ps_step(bundle, agg.ragged_matrix_fn(), row_capacity=RAGGED_CAP)
    ragged_in, cohorts = [], []
    for s in range(COMPILED_STEPS):
        m = SERVE_COHORTS[s % len(SERVE_COHORTS)]
        cohort = build_cohort(subs[m], 1, None, policy)
        flat = torch.zeros((RAGGED_CAP, d), device="cuda")
        flat[:m] = cohort.matrix
        weights = torch.zeros(RAGGED_CAP, device="cuda")
        weights[:m] = torch.from_numpy(cohort.weights).cuda()
        ragged_in.append((flat, torch.zeros(1, dtype=torch.int32, device="cuda"),
                          torch.tensor([m], dtype=torch.int32, device="cuda"), weights))
        cohorts.append(cohort)
    res = compiled_vs_eager("(x) ragged trimmed mean, capacity 64, cohorts "
                            f"{[c.m for c in cohorts]}", eager, compiled, (bundle.params, opt0),
                            lambda s: ragged_in[s], ["segmented_sort_reduce"], counts)
    p1 = res.pop("first_eager_state")[0]
    via = CohortAggregator(agg).aggregate(cohorts[0])
    p_ca, _ = SGD(0.05, momentum=0.9).step(ravel(bundle.params), via, opt0)
    check(bits_equal(p_ca, ravel(p1)), "ragged: CohortAggregator does not give the step's parameters")
    res["cohort_aggregator_bitwise"] = True
    results["ragged_trimmed_mean"] = res
    return results


def compiled_refusals() -> dict:
    """(y) host-reading callables through a twin: MDA's branch-and-bound
    and influence ascent's state machine read the host by design, so each
    capture raises ``GraphCaptureError`` naming the callable's role, and
    nothing replays."""
    import torch

    from byzpy_tpu_torch.aggregators import MinimumDiameterAveraging
    from byzpy_tpu_torch.attacks import InfluenceAscentAttack
    from byzpy_tpu_torch.models import SmallCNN, make_bundle, synthetic_classification
    from byzpy_tpu_torch.ops import kernels, robust
    from byzpy_tpu_torch.parallel import PSStepConfig, adaptive_attack_rows, jit_ps_train_step
    from byzpy_tpu_torch.utils.cuda_graph import GraphCaptureError

    cfg = PSStepConfig(n_nodes=MAIN_N, n_byzantine=MAIN_BYZ)
    x, y = synthetic_classification(n_samples=MAIN_N * MAIN_BATCH, seed=3, device="cuda")
    xs, ys = x.reshape(MAIN_N, MAIN_BATCH, 28, 28, 1), y.reshape(MAIN_N, MAIN_BATCH)
    bundle = make_bundle(SmallCNN(), seed=0, device="cuda")
    d = sum(int(v.numel()) for v in bundle.params.values())
    atk = InfluenceAscentAttack(d)
    cases = {
        "mda": (lambda: jit_ps_train_step(bundle, MinimumDiameterAveraging(MAIN_BYZ).matrix_fn(), cfg),
                "aggregate"),
        "influence_ascent": (lambda: jit_ps_train_step(
            bundle, robust.coordinate_median, cfg,
            attack=lambda h, g: adaptive_attack_rows(atk, MAIN_BYZ, honest=h)), "attack"),
    }
    results = {}
    for name, (make, role) in cases.items():
        step, opt0 = make()
        kernels.reset_launch_counts()
        try:
            step(bundle.params, opt0, xs, ys)
            raised = None
        except GraphCaptureError as exc:
            raised = str(exc)
        torch.cuda.synchronize()
        check(raised is not None, f"(y) {name}: the twin did not refuse the host-reading step")
        check(f"the {role} callable" in raised and "reads the host" in raised,
              f"(y) {name}: the refusal does not name the {role} callable's host read: {raised[:300]}")
        check(not step.graphs and not any(v for k, v in kernels.launch_counts.items()
                                          if k.startswith("graph_replay")),
              f"(y) {name}: a graph was kept or replayed after the refusal")
        results[name] = raised[:240]
        log(f"  (y) {name}: refused: {raised[:240]}")
    return results


def compiled_host_free(counts: dict) -> dict:
    """(y) the loops that read nothing on the host:
    CAF (f = 2, fixed passes, a seeded start vector) in the PS step, and
    the masked geometric median and the masked centred clipping (B7's
    masked modes) in the serving step at bucket 64 (41 valid rows): each
    twin captures, its 5 compiled steps equal the eager steps bit for bit,
    and a compiled step and the eager aggregate read nothing on the host."""
    import torch

    from byzpy_tpu_torch.aggregators import CenteredClipping, GeometricMedian
    from byzpy_tpu_torch.models import SmallCNN, make_bundle, synthetic_classification
    from byzpy_tpu_torch.ops import attack_ops, robust
    from byzpy_tpu_torch.parallel import (
        PSStepConfig, build_serving_ps_step, jit_serving_ps_step,
    )

    cfg = PSStepConfig(n_nodes=MAIN_N, n_byzantine=MAIN_BYZ)
    x, y = synthetic_classification(n_samples=MAIN_N * MAIN_BATCH, seed=3, device="cuda")
    xs, ys = x.reshape(MAIN_N, MAIN_BATCH, 28, 28, 1), y.reshape(MAIN_N, MAIN_BATCH)
    results = {}
    bundle = make_bundle(SmallCNN(), seed=0, device="cuda")
    d = sum(int(v.numel()) for v in bundle.params.values())
    v0 = torch.randn((d,), generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")

    def caf(m):
        return robust.caf(m, f=MAIN_BYZ, v_init=v0)

    eager, compiled, state0 = ps_twins(
        bundle, caf, cfg, attack=lambda honest, g: attack_ops.sign_flip(honest.mean(dim=0)))
    res = compiled_vs_eager("(y) CAF (f = 2), PS step", eager, compiled, state0,
                            lambda s: (xs, ys), [], counts)
    p, o = res.pop("first_eager_state")[:2]
    _, reads = count_syncs(lambda: compiled(p, o, xs, ys))
    matrix = torch.randn((MAIN_N, d), device="cuda")
    _, agg_reads = count_syncs(lambda: caf(matrix))
    passes = int(robust.last_iterations["caf"])
    check(reads == 0 and agg_reads == 0,
          f"(y) CAF: {reads} host reads a compiled step, {agg_reads} an eager aggregation")
    res.update(host_reads_compiled_step=reads, host_reads_eager_aggregate=agg_reads,
               passes_applied_on_a_normal_matrix=passes)
    log(f"    (y) CAF: host reads a compiled step {reads}, an eager aggregation {agg_reads} "
        f"({passes} of {2 * MAIN_BYZ} passes applied on a normal 8 x {d} matrix)")
    results["caf"] = res
    rows = 64
    gen = torch.Generator(device="cuda").manual_seed(13)
    matrix = torch.zeros((rows, d), device="cuda")
    matrix[:41] = torch.randn((41, d), generator=gen, device="cuda")
    valid = torch.zeros(rows, dtype=torch.bool, device="cuda")
    valid[:41] = True
    fn = GeometricMedian().masked_matrix_fn()
    eager, opt0 = build_serving_ps_step(bundle, fn)
    compiled, _ = jit_serving_ps_step(bundle, fn)
    res = compiled_vs_eager("(y) masked geometric median, serving step at bucket 64 (41 rows)",
                            eager, compiled, (bundle.params, opt0),
                            lambda s: (matrix, valid, valid.float()),
                            ["sort_columns", "center_loop:masked_weiszfeld"], counts)
    p, o = res.pop("first_eager_state")[:2]
    _, reads = count_syncs(lambda: compiled(p, o, matrix, valid, valid.float()))
    _, agg_reads = count_syncs(lambda: fn(matrix, valid))
    its = int(robust.last_iterations["geometric_median"])
    check(reads == 0 and agg_reads == 0,
          f"(y) masked geometric median: {reads} host reads a compiled step, {agg_reads} an "
          f"eager aggregation")
    res.update(host_reads_compiled_step=reads, host_reads_eager_aggregate=agg_reads,
               weiszfeld_iterations=its)
    log(f"    (y) masked geometric median: host reads a compiled step {reads}, an eager "
        f"aggregation {agg_reads}; {its} Weiszfeld iterations")
    results["masked_geometric_median"] = res
    fn = CenteredClipping(c_tau=MAIN_CTAU, M=10).masked_matrix_fn()
    eager, opt0 = build_serving_ps_step(bundle, fn)
    compiled, _ = jit_serving_ps_step(bundle, fn)
    res = compiled_vs_eager("(y) masked centred clipping, serving step at bucket 64 (41 rows)",
                            eager, compiled, (bundle.params, opt0),
                            lambda s: (matrix, valid, valid.float()),
                            ["segment_sum", "center_loop:masked_clip"], counts)
    p, o = res.pop("first_eager_state")[:2]
    _, reads = count_syncs(lambda: compiled(p, o, matrix, valid, valid.float()))
    _, agg_reads = count_syncs(lambda: fn(matrix, valid))
    check(reads == 0 and agg_reads == 0,
          f"(y) masked centred clipping: {reads} host reads a compiled step, {agg_reads} an "
          f"eager aggregation")
    res.update(host_reads_compiled_step=reads, host_reads_eager_aggregate=agg_reads)
    log(f"    (y) masked centred clipping: host reads a compiled step {reads}, an eager "
        f"aggregation {agg_reads}")
    results["masked_centered_clipping"] = res
    del bundle, eager, compiled
    torch.cuda.empty_cache()
    return results


def compiled_path(counts: dict) -> dict:
    """Phase 4e: the compiled steps (u)-(x) against their eager steps, bit
    for bit, with cuDNN's deterministic algorithms, then (y) the refusals
    and the two host-free loops' captures."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        out = {"u_resnet50_config5": compiled_resnet50(counts),
               "v_resnet18_multi_krum": compiled_resnet18(counts),
               "w_smallcnn": compiled_smallcnn(counts),
               "x_serving": compiled_serving(counts),
               "y_refusals": compiled_refusals(),
               "y_host_free": compiled_host_free(counts)}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    for part in ("u_resnet50_config5", "v_resnet18_multi_krum"):
        out[part].pop("first_eager_state", None)
    return out


# ---------------------------------------------------------------------------
# phase 4h: BASELINE config #4, the compiled gossip round
# ---------------------------------------------------------------------------

# examples/p2p/resnet_cifar_gossip.py: ResNet-18 at 64 filters (GroupNorm
# with gcd(32, 64) = 32 groups), 8 nodes on ring(8, 2), node 7 byzantine,
# 32 images a node from 4 rotating batches, lr 0.05, NNM (f = 1) then the
# geometric median (max_iter = 32), 10 steps
C4_NODES, C4_BYZ, C4_BATCH, C4_LR, C4_FILTERS = 8, 1, 32, 0.05, 64
C4_BATCHES, C4_STEPS = 4, 10
# the same graph replayed on to this step for the loss check: at full width
# lr 0.05 overshoots first (the reference's one-node SGD step too,
# tests/test_torch_gossip_config4.py), so step 10's loss is above step 1's;
# on an H100 it fell below step 1's from step 25 on
C4_TRAIN_STEPS = 40
# the attacked run: the byzantine node broadcasts N(0, 0.1^2) coordinates
# drawn from the step's generator
C4_SIGMA = 0.1
# each node's aggregate, captured once: B3's Gram and B8's two kernels
# (NNM), B1 (the median start) and B7's Weiszfeld loop
C4_CAPTURE = {"gram": C4_NODES, "nnm_weights": C4_NODES, "mix_rows": C4_NODES,
              "sorted_reduce:median": C4_NODES, "center_loop:weiszfeld": C4_NODES}


def config4_path(counts: dict, smi: str) -> dict:
    """Phase 4h: BASELINE config #4 at full width through the port's
    compiled gossip step (``jit_gossip_train_step``, the example's
    ``jax.jit(step)``), with cuDNN's deterministic algorithms: 5 eager steps
    from ``init_stacked_params()``, then 10 compiled steps from the same
    start with the counts set to 0 just before and read just after, the
    first 5 equal to the eager steps bit for bit (``theta`` and the honest
    loss), the capture exactly ``C4_CAPTURE``'s launches and a replay a
    step; the same graph replayed on to step ``C4_TRAIN_STEPS``, the honest
    loss of its last 4 steps (a cycle of the batches) below step 1's; then
    the same
    with a Gaussian attack drawn from the step's generator (5 steps each,
    bitwise, the generators' states equal). Each node's Weiszfeld count is
    read from the graph's own buffers after each replay."""
    import torch
    from torch.func import grad_and_value, vmap

    from byzpy_tpu_torch.engine.peer_to_peer import Topology
    from byzpy_tpu_torch.models import GroupNorm, ShardedDataset, cifar_resnet18, synthetic_classification
    from byzpy_tpu_torch.ops import attack_ops, kernels, preagg, robust
    from byzpy_tpu_torch.parallel import GossipStepConfig, build_gossip_train_step, jit_gossip_train_step

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    norm = functools.partial(GroupNorm, num_groups=math.gcd(32, C4_FILTERS))
    bundle = cifar_resnet18(seed=0, device="cuda", norm=norm)
    d = sum(int(v.numel()) for v in bundle.params.values())
    check(d == 11_173_962, f"config #4's ResNet-18 has d={d}")
    x, y = synthetic_classification(n_samples=C4_NODES * C4_BATCH * C4_BATCHES,
                                    input_shape=(32, 32, 3), seed=0, device="cuda")
    xs_all, ys_all = ShardedDataset(x, y, n_nodes=C4_NODES).stacked_shards()

    def batch_at(s):
        start = (s % C4_BATCHES) * C4_BATCH
        return xs_all[:, start:start + C4_BATCH], ys_all[:, start:start + C4_BATCH]

    # each node's Weiszfeld count: ints in eager steps, the graph's 0-d
    # buffers while capturing
    eager_iters, captured_iters = [], []

    def aggregate(m):
        mixed = preagg.nnm(m, f=min(C4_BYZ, m.shape[0] - 1))
        z = robust.geometric_median(mixed, max_iter=32)
        its = robust.last_iterations["geometric_median"]
        (captured_iters if torch.cuda.is_current_stream_capturing() else eager_iters).append(its)
        return z

    topo, cfg = Topology.ring(C4_NODES, 2), GossipStepConfig(C4_NODES, C4_BYZ, C4_LR)

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def median(v):
        return sorted(v)[len(v) // 2]

    results = {"d": d, "groups": math.gcd(32, C4_FILTERS), "nvidia_smi": smi}
    for attacked in (False, True):
        label = "attacked" if attacked else "plain"
        attack = None
        if attacked:
            def attack(honest, g):
                return attack_ops.gaussian(g, (honest.shape[1],), sigma=C4_SIGMA, device=honest.device)
        eager, init = build_gossip_train_step(bundle, aggregate, topo, cfg, attack=attack)
        compiled, cinit = jit_gossip_train_step(bundle, aggregate, topo, cfg, attack=attack)
        steps = C4_TRAIN_STEPS if not attacked else COMPILED_STEPS
        gen_e = torch.Generator(device="cuda").manual_seed(17) if attacked else None
        gen_c = torch.Generator(device="cuda").manual_seed(17) if attacked else None
        kw_e = {} if gen_e is None else {"generator": gen_e}
        kw_c = {} if gen_c is None else {"generator": gen_c}
        eager_iters.clear()
        e_states, e_times, theta = [], [], init()
        for s in range(COMPILED_STEPS):
            (theta, m), ms = synced(lambda: eager(theta, *batch_at(s), **kw_e))
            e_states.append((theta, m["honest_loss"], None if gen_e is None else gen_e.get_state()))
            e_times.append(ms)
        e_iters = [list(eager_iters[i:i + C4_NODES]) for i in range(0, len(eager_iters), C4_NODES)]
        captured_iters.clear()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        c_times, c_losses, c_iters, theta = [], [], [], cinit()
        for s in range(steps):
            (theta, m), ms = synced(lambda: compiled(theta, *batch_at(s), **kw_c))
            c_times.append(ms)
            c_losses.append(float(m["honest_loss"]))
            c_iters.append([int(t) for t in captured_iters])
            if s < COMPILED_STEPS:
                te, le, ge = e_states[s]
                check(bits_equal(theta, te) and bits_equal(m["honest_loss"], le),
                      f"(4h) {label}: compiled step {s + 1} differs from the eager step")
                if gen_c is not None:
                    check(torch.equal(gen_c.get_state(), ge),
                          f"(4h) {label}: the generators differ after step {s + 1}")
        run_counts = {k: v for k, v in kernels.launch_counts.items() if v}
        capture = compiled.last_capture
        check(len(compiled.graphs) == 1, f"(4h) {label}: {len(compiled.graphs)} graphs captured")
        check(capture["launches"] == C4_CAPTURE,
              f"(4h) {label}: the capture recorded {capture['launches']}, not {C4_CAPTURE}")
        want = {**C4_CAPTURE, compiled.counter: steps}
        check(run_counts == want, f"(4h) {label}: launches {run_counts}, not {want}")
        for k, v in want.items():
            counts[k] += v
        check(all(map(math.isfinite, c_losses)), f"(4h) {label}: losses not finite {c_losses}")
        check(len(captured_iters) == C4_NODES and all(1 <= it <= 32 for row in c_iters for it in row),
              f"(4h) {label}: Weiszfeld counts {c_iters}")
        res = {"bitwise_steps": COMPILED_STEPS, "compiled_steps": steps, "losses": c_losses,
               "eager_host_ms": median(e_times[1:]), "eager_first_ms": e_times[0],
               "compiled_host_ms": median(c_times[1:]), "compiled_first_ms": c_times[0],
               "capture": {"ms": capture["ms"], "launches": capture["launches"],
                           "warmup_launches": capture["warmup_launches"]},
               "weiszfeld_iterations_compiled": c_iters, "weiszfeld_iterations_eager": e_iters}
        if not attacked:
            check(max(c_losses[-C4_BATCHES:]) < c_losses[0],
                  f"(4h) the honest loss did not fall by step {steps}: {c_losses}")
            res["loss_step10_below_step1"] = c_losses[C4_STEPS - 1] < c_losses[0]
            xs, ys = batch_at(steps - 1)
            state = [theta]

            def replay():
                state[0], _ = compiled(state[0], xs, ys)

            th = e_states[-1][0]
            e_prof = profile_host_device(lambda: eager(th, xs, ys), steps=2)
            c_prof = profile_host_device(replay, steps=3)
            b7 = c_prof["port_kernels"].get("center_loop_kernel")
            names = list(bundle.params)
            sizes = [int(bundle.params[k].numel()) for k in names]
            stacked = {k: p.reshape(C4_NODES, *bundle.params[k].shape)
                       for k, p in zip(names, torch.split(th, sizes, dim=1))}
            half = vmap(grad_and_value(bundle.loss_fn), in_dims=(0, 0, 0))
            fwd_bwd = profile_host_device(lambda: half(stacked, xs, ys), steps=2)
            res.update(
                eager_span_ms=span_ms(lambda: eager(th, xs, ys)), compiled_span_ms=span_ms(replay),
                eager_profile=e_prof, compiled_profile=c_prof,
                eager_busy=e_prof["device_ms_per_step"] / res["eager_host_ms"],
                compiled_busy=c_prof["device_ms_per_step"] / res["compiled_host_ms"],
                per_node_forward_backward_device_ms=fwd_bwd["device_ms_per_step"],
                per_node_forward_backward_top=fwd_bwd["top"],
                b7_device_ms_per_step=None if b7 is None else b7[0],
                b7_launches_per_step=None if b7 is None else b7[1],
                b7_device_ms_per_launch=None if not b7 or not b7[1] else b7[0] / b7[1],
                peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
            log(f"  (4h) config #4 at d = {d} ({results['groups']} groups), {smi}: host ms a step eager "
                f"{res['eager_host_ms']:.3f} / compiled {res['compiled_host_ms']:.3f} (first "
                f"{res['eager_first_ms']:.1f} / {res['compiled_first_ms']:.1f} with the capture's "
                f"{capture['ms']:.1f}); span (CUDA events) {res['eager_span_ms']:.3f} / "
                f"{res['compiled_span_ms']:.3f} ms; device ms {e_prof['device_ms_per_step']:.3f} / "
                f"{c_prof['device_ms_per_step']:.3f}, busy {res['eager_busy']:.3f} / "
                f"{res['compiled_busy']:.3f}; host-issued launches {e_prof['host_issued_per_step']:.1f}"
                f" / {c_prof['host_issued_per_step']:.1f}; peak {res['peak_memory_gib']:.2f} GiB; "
                f"per-node forward and backward {fwd_bwd['device_ms_per_step']:.3f} device ms; B7 "
                f"at 3 x {d}: {res['b7_device_ms_per_launch']} device ms a launch ({b7})")
            log(f"    (4h) losses {[round(v, 4) for v in c_losses]} (step 1 {c_losses[0]:.4f}, "
                f"step {C4_STEPS} {c_losses[C4_STEPS - 1]:.4f}, steps {steps - C4_BATCHES + 1}-{steps} "
                f"at most {max(c_losses[-C4_BATCHES:]):.4f}); capture launches {capture['launches']}; "
                f"Weiszfeld counts per node and step (compiled) {c_iters}, eager {e_iters}")
            log(f"    (4h) eager top {json.dumps(e_prof['top'])}; compiled top "
                f"{json.dumps(c_prof['top'])}; forward and backward top {json.dumps(fwd_bwd['top'])}")
        else:
            log(f"  (4h) attacked (Gaussian, sigma {C4_SIGMA}, from the step's generator): "
                f"{COMPILED_STEPS} compiled steps == eager bitwise, generators equal; host ms "
                f"eager {res['eager_host_ms']:.3f} / compiled {res['compiled_host_ms']:.3f}; losses "
                f"{[round(v, 4) for v in c_losses]}; Weiszfeld counts {c_iters}")
        results[label] = res
        del eager, compiled, e_states, theta
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    return results


PORT_KERNELS = ("sorted_reduce_kernel", "gram_partial_kernel", "gram_reduce_kernel",
                "selection_weights_kernel", "weighted_rows_kernel", "selection_mean_from_gram_kernel",
                "nnm_weights_kernel",
                "mix_rows_kernel", "nnm_selection_weights_kernel", "clip_selection_weights_kernel",
                "meamed_kernel", "center_loop_kernel", "masked_loop_kernel", "quantize_kernel",
                "dequantize_kernel",
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
            time.sleep(PROFILE_PAD_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
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
# phase 4f: the engine (actor pools, schedulers, the subtask fan-out)
# ---------------------------------------------------------------------------

# ByzPy's per-workload table (BASELINE.md, benchmarks/README.md:15-28): ms
# direct and on process pools of 2, 4 and 6 workers (CPU, hardware
# unspecified)
BYZPY_POOL = {
    "cw_median_64x65536": (52.0, 56.0, 42.0, 37.0),
    "cwtm_64x65536_f8": (65.52, 27.72, 18.75, 15.15),
    "multi_krum_80x65536_f20_q12": (59.66, 39.65, 38.05, 26.30),
    "meamed_64x65536_f8": (113.0, 109.0, 73.0, 59.0),
    "cge_64x65536_f8": (100.0, 38.0, 28.0, 23.0),
    "monna_64x65536_f8": (67.0, 15.0, 11.0, 16.0),
    "geometric_median_64x65536": (398.21, 143.50, 145.05, 142.97),
    "centered_clipping_64x65536_M10": (112.0, 65.0, 58.0, 50.0),
    "empire_64x65536": (34.0, 26.0, 14.0, 15.0),
    "little_96x65536_f12": (67.03, 34.79, 32.86, 47.45),
}
# ByzPy's scheduler table (BASELINE.md:40-46, benchmarks/README.md:67-69):
# pool workers -> (NodeScheduler ms, ParallelScheduler ms)
BYZPY_SCHEDULER = {2: (3362.0, 1375.0), 4: (3361.0, 1252.0), 6: (3240.0, 1239.0)}
ENGINE_POOLS = (2, 4, 6)
# phase 4i's process pools (ByzPy's columns of 2 and 4 workers; its 6 is
# left out to keep the script's time)
PROCESS_POOLS = (2, 4)
# the engine's waits: no await of phase 4f may hang the run
ENGINE_WAIT_S = 600
# the loops' pool path (row-block sums a step) against B7's loop
LOOP_RTOL, LOOP_ATOL = 1e-4, 1e-4
# Little's means reduce over column views on the pool path
LITTLE_RTOL, LITTLE_ATOL = 1e-6, 3e-6


async def host_ms(fn, reps: int) -> tuple:
    """``(median host ms, last result)`` of ``reps`` awaited calls of
    ``fn()``, each synchronized on both ends."""
    import torch

    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = await fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], out


def engine_counts(counts: dict, run_counts: dict, name: str, want: dict) -> None:
    """Check a pooled run's launches against ``want`` (every key named,
    nothing else) and add them to the main path's counts."""
    got = {k: v for k, v in run_counts.items() if v}
    check(got == want, f"{name}: launches {got}, not {want}")
    for k, v in got.items():
        counts[k] += v


def kernel_streams(prof, marker: str) -> tuple:
    """``({stream id: launches and the first kernel names}, the one stream
    of the kernels whose names hold ``marker``)`` of a torch.profiler trace,
    from its Chrome trace (the kernels' ``stream`` argument)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    streams: dict = {}
    marked = set()
    for ev in events:
        if ev.get("cat") == "kernel":
            sid = str((ev.get("args") or {}).get("stream"))
            entry = streams.setdefault(sid, [0, set()])
            entry[0] += 1
            entry[1].add(ev.get("name", "")[:40])
            if marker in ev.get("name", ""):
                marked.add(sid)
    check(len(marked) == 1, f"kernel {marker!r} ran on streams {sorted(marked)}: {streams}")
    return ({k: {"launches": v[0], "kernels": sorted(v[1])[:6]} for k, v in streams.items()},
            marked.pop())


def no_work():
    """A subtask that does nothing: what a pool costs a subtask."""


async def engine_config1(counts: dict) -> dict:
    """(a) BASELINE config #1: the coordinate median of 10 x 100,000 seeded
    f32 gradients as a single-operator graph under ``NodeScheduler``, on a
    ``thread`` and a ``cuda`` pool of 4: 16 feature chunks of 6,250
    columns, one B1 launch each, bit for bit the direct B1 call and the
    plain version; beside it 16 subtasks that do nothing on the same
    pool, and the pooled run at a 0.1 ms interpreter switch interval."""
    import torch

    from byzpy_tpu_torch.aggregators import CoordinateWiseMedian
    from byzpy_tpu_torch.engine.graph import (ActorPool, ActorPoolConfig, NodeScheduler, SubTask,
                                              make_single_operator_graph,
                                              select_adaptive_chunk_size)
    from byzpy_tpu_torch.ops import kernels

    x = random_rounds((1, 10, 100_000), seed=41)[0]
    rows = list(x)
    agg = CoordinateWiseMedian()
    graph = make_single_operator_graph(agg)
    plain = kernels.sorted_reduce_stream_plain(x[None], mode="median")[0]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    direct = agg.aggregate(rows)
    torch.cuda.synchronize()
    engine_counts(counts, kernels.launch_counts, "(a) direct", {"sorted_reduce:median": 1})
    check(bits_equal(direct, plain), "(a) the direct median differs from the plain version")
    chunk = select_adaptive_chunk_size(100_000, agg.chunk_size, pool_size=4)
    check(chunk == 6250, f"(a) chunk {chunk}, not the reference's 6,250 at a pool of 4")
    out = {"chunk": chunk, "subtasks": -(-100_000 // chunk)}
    out["direct_ms"], _ = await host_ms(lambda: NodeScheduler(graph).run({"gradients": rows}), 10)
    for backend in ("thread", "cuda"):
        async with ActorPool(ActorPoolConfig(backend=backend, count=4)) as pool:
            sched = NodeScheduler(graph, pool=pool)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            res = (await sched.run({"gradients": rows}))["op"]
            torch.cuda.synchronize()
            engine_counts(counts, kernels.launch_counts, f"(a) {backend} pool of 4",
                          {"sorted_reduce:median": 16})
            check(bits_equal(res, direct), f"(a) the {backend} pool's median differs from B1's")
            out[f"{backend}_pool4_ms"], res = await host_ms(
                lambda: sched.run({"gradients": rows}), 10)
            check(bits_equal(res["op"], direct), f"(a) a timed {backend} run differs")
            noop = [SubTask(fn=no_work) for _ in range(16)]
            out[f"{backend}_pool4_16_empty_subtasks_ms"], _ = await host_ms(
                lambda: pool.run_many(noop), 10)
            # the interpreter hands the GIL to a waiting thread after its
            # switch interval (5 ms by default): the same run at 0.1 ms
            interval = sys.getswitchinterval()
            sys.setswitchinterval(1e-4)
            try:
                out[f"{backend}_pool4_switch_0.1ms_ms"], res = await host_ms(
                    lambda: sched.run({"gradients": rows}), 10)
            finally:
                sys.setswitchinterval(interval)
            check(bits_equal(res["op"], direct), f"(a) a timed {backend} run differs")
    log(f"  (a) config #1, median 10 x 100,000: {out['subtasks']} chunks of {chunk}; host ms "
        f"direct {out['direct_ms']:.3f}, thread pool of 4 {out['thread_pool4_ms']:.3f}, cuda "
        f"pool of 4 {out['cuda_pool4_ms']:.3f} (at a 0.1 ms switch interval "
        f"{out['thread_pool4_switch_0.1ms_ms']:.3f} / {out['cuda_pool4_switch_0.1ms_ms']:.3f}); "
        f"bit for bit B1 and the plain version; 16 empty subtasks: thread "
        f"{out['thread_pool4_16_empty_subtasks_ms']:.3f}, cuda "
        f"{out['cuda_pool4_16_empty_subtasks_ms']:.3f}")
    return out


def recording_krum(f: int, q: int):
    """A ``MultiKrum`` that keeps the pool path's scores."""
    from byzpy_tpu_torch.aggregators import MultiKrum

    class RecordingKrum(MultiKrum):
        scores = None

        def _select_from_scores(self, scores, matrix):
            self.scores = scores
            return super()._select_from_scores(scores, matrix)

    return RecordingKrum(f, q)


async def engine_config2(counts: dict) -> dict:
    """(b) BASELINE config #2: ``MultiKrum(f=8, q=12)`` on 64 x 1,048,576
    f32 (256 MiB) under ``NodeScheduler`` on a ``cuda`` pool of 4: 16
    subtasks of 4 rows' scores on the actors' streams, the compute path's
    (B3 + B4) selection and, through B4's row sweep, its bits; a
    torch.profiler trace shows the subtasks' kernels on two streams or
    more besides the caller's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from byzpy_tpu_torch.engine.graph import (ActorPool, ActorPoolConfig, NodeScheduler,
                                              make_single_operator_graph)
    from byzpy_tpu_torch.ops import kernels

    f, q = 8, 12
    x = random_rounds((1,) + HEADLINE, seed=42)[0]
    agg = recording_krum(f, q)
    graph = make_single_operator_graph(agg)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    direct = agg.aggregate(x)
    torch.cuda.synchronize()
    engine_counts(counts, kernels.launch_counts, "(b) direct",
                  {"gram": 1, "selection_weights:krum": 1, "weighted_rows": 1})
    w = kernels.selection_weights(kernels.gram(x[None]), f=f, q=q, mode="krum")[0]
    chosen = sorted(int(i) for i in torch.nonzero(w).flatten().tolist())
    out = {}
    out["direct_ms"], _ = await host_ms(lambda: NodeScheduler(graph).run({"gradients": x}), 5)
    async with ActorPool(ActorPoolConfig(backend="cuda", count=4)) as pool:
        sched = NodeScheduler(graph, pool=pool)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        res = (await sched.run({"gradients": x}))["op"]
        torch.cuda.synchronize()
        engine_counts(counts, kernels.launch_counts, "(b) cuda pool of 4", {"weighted_rows": 1})
        check(agg.scores is not None and agg.scores.shape == (64,), "(b) no pool scores recorded")
        pooled = sorted(int(i) for i in torch.argsort(agg.scores, stable=True)[:q].tolist())
        check(pooled == chosen, f"(b) the pool selected {pooled}, the compute path {chosen}")
        err = max_abs_err(res, direct)
        check(err <= 1e-6 * float(direct.abs().max()), f"(b) the pooled aggregate is {err} off")
        out["selected"], out["max_abs_err"], out["bitwise"] = pooled, err, bits_equal(res, direct)
        out["cuda_pool4_ms"], _ = await host_ms(lambda: sched.run({"gradients": x}), 5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            await sched.run({"gradients": x})
            torch.cuda.synchronize()
        # the reduce's B4 sweep is the caller's: its stream is the caller's
        streams, caller = kernel_streams(prof, "weighted_rows_kernel")
    others = {s: v for s, v in streams.items() if s != caller}
    check(len(others) >= 2, f"(b) the subtasks' kernels ran on {len(others)} stream(s) besides "
          f"the caller's: {streams}")
    out["streams"] = streams
    out["caller_stream"] = caller
    log(f"  (b) config #2, Multi-Krum (f=8, q=12) 64 x 1,048,576: 16 subtasks, selection "
        f"{pooled} == B3 + B4's, max |diff| {err} (bitwise {out['bitwise']}); host ms direct "
        f"{out['direct_ms']:.3f}, cuda pool of 4 {out['cuda_pool4_ms']:.3f}; kernels by stream "
        f"{json.dumps({s: v['launches'] for s, v in streams.items()})} (caller {caller})")
    del x
    torch.cuda.empty_cache()
    return out


def pool_table_cases():
    """(c)'s workloads at ByzPy's shapes: name -> (operator, inputs, how
    the pool's result is held to the direct one)."""
    from byzpy_tpu_torch import aggregators as P
    from byzpy_tpu_torch import attacks as A

    def rows(n, seed):
        return list(random_rounds((1, n, GRID[1]), seed=seed)[0])

    g64 = rows(64, 51)
    return {
        "cw_median_64x65536": (P.CoordinateWiseMedian(), {"gradients": g64}, "bitwise"),
        "cwtm_64x65536_f8": (P.CoordinateWiseTrimmedMean(8), {"gradients": g64}, "bitwise"),
        "multi_krum_80x65536_f20_q12": (P.MultiKrum(20, 12), {"gradients": rows(80, 52)},
                                        "bitwise"),
        "meamed_64x65536_f8": (P.MeanOfMedians(8), {"gradients": g64}, "bitwise"),
        "cge_64x65536_f8": (P.ComparativeGradientElimination(8), {"gradients": g64}, "bitwise"),
        "monna_64x65536_f8": (P.MoNNA(8), {"gradients": g64}, "bitwise"),
        "geometric_median_64x65536": (P.GeometricMedian(), {"gradients": g64}, "loop"),
        "centered_clipping_64x65536_M10": (P.CenteredClipping(c_tau=10.0, M=10),
                                           {"gradients": g64}, "loop"),
        "empire_64x65536": (A.EmpireAttack(), {"honest_grads": g64}, "bitwise"),
        "little_96x65536_f12": (A.LittleAttack(12), {"honest_grads": rows(96, 53)}, "little"),
    }


async def engine_pool_table(counts: dict) -> dict:
    """(c) ByzPy's pool table at its own shapes: each workload through
    ``run_operator`` with no pool and on ``cuda`` pools of 2, 4 and 6 (one
    pool of each size, started once), host median ms beside ByzPy's
    direct and pool figures; each pooled result held to the direct one."""
    import torch

    from byzpy_tpu_torch.engine.graph import ActorPool, ActorPoolConfig, run_operator
    from byzpy_tpu_torch.ops import kernels

    cases = pool_table_cases()
    pools = {k: ActorPool(ActorPoolConfig(backend="cuda", count=k)) for k in ENGINE_POOLS}
    out = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    try:
        for p in pools.values():
            await p.start()
        for name, (op, inputs, rule) in cases.items():
            reps = 3 if name.startswith("geometric") else 5
            direct_ms, direct = await host_ms(lambda: run_operator(op, inputs), reps)
            row = {"direct_ms": direct_ms, "byzpy_direct_ms": BYZPY_POOL[name][0]}
            for i, k in enumerate(ENGINE_POOLS):
                ms, res = await host_ms(lambda: run_operator(op, inputs, pool=pools[k]), reps)
                if rule == "bitwise":
                    ok, err = bits_equal(res, direct), max_abs_err(res, direct)
                elif rule == "little":
                    ok = bool(torch.allclose(res, direct, rtol=LITTLE_RTOL, atol=LITTLE_ATOL))
                    err = max_abs_err(res, direct)
                else:
                    ok = bool(torch.allclose(res, direct, rtol=LOOP_RTOL, atol=LOOP_ATOL))
                    err = max_abs_err(res, direct)
                check(ok, f"(c) {name}: the pool of {k}'s result is {err} off the direct one "
                      f"({rule})")
                row[f"pool{k}_ms"] = ms
                row[f"byzpy_pool{k}_ms"] = BYZPY_POOL[name][i + 1]
                row[f"pool{k}_max_abs_err"] = err
            out[name] = row
            log(f"  (c) {name}: host ms direct {direct_ms:.3f} (ByzPy {BYZPY_POOL[name][0]}), "
                + ", ".join(f"pool x{k} {row[f'pool{k}_ms']:.3f} (ByzPy "
                            f"{row[f'byzpy_pool{k}_ms']})" for k in ENGINE_POOLS)
                + f"; held {rule}")
    finally:
        for p in pools.values():
            await p.close()
    torch.cuda.synchronize()
    for k, v in kernels.launch_counts.items():
        counts[k] += v
    out["launches"] = {k: v for k, v in kernels.launch_counts.items() if v}
    del cases
    torch.cuda.empty_cache()
    return out


def scheduler_graph():
    """``benchmarks/scheduler_bench.py``'s 4-branch pipeline on the card:
    each branch a preprocessing node (5 rounds of row-standardize and
    clip, on the device) then median, trimmed mean (f = 15), CGE (f =
    15) or centred clipping (c_tau = 10, M = 5)."""
    import torch

    from byzpy_tpu_torch import aggregators as P
    from byzpy_tpu_torch.engine.graph import ComputationGraph, GraphInput, GraphNode, Operator

    class Preprocess(Operator):
        name = "preprocess"

        def compute(self, inputs, *, context):
            x = inputs["gradients"]
            for _ in range(5):
                x = x - x.mean(dim=1, keepdim=True)
                x = x / (x.std(dim=1, keepdim=True, correction=0) + 1e-8)
                x = torch.clamp(x, -3.0, 3.0)
            return x

    branches = {"median": P.CoordinateWiseMedian(), "trimmed": P.CoordinateWiseTrimmedMean(15),
                "cge": P.ComparativeGradientElimination(15),
                "clip": P.CenteredClipping(c_tau=10.0, M=5)}
    nodes = []
    for name, op in branches.items():
        nodes.append(GraphNode(f"pre_{name}", Preprocess(), {"gradients": GraphInput("gradients")}))
        nodes.append(GraphNode(name, op, {"gradients": f"pre_{name}"}))
    return ComputationGraph(nodes, outputs=list(branches))


async def engine_schedulers(counts: dict) -> dict:
    """(d) ByzPy's scheduler table: the 4-branch pipeline at 64 x 200,000
    under ``NodeScheduler`` and ``ParallelScheduler`` on ``cuda`` pools of
    2, 4 and 6; the two schedulers' outputs equal bit for bit."""
    import torch

    from byzpy_tpu_torch.engine.graph import (ActorPool, ActorPoolConfig, NodeScheduler,
                                              ParallelScheduler)
    from byzpy_tpu_torch.ops import kernels

    x = random_rounds((1, 64, 200_000), seed=61)[0]
    graph = scheduler_graph()
    out = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for k in ENGINE_POOLS:
        async with ActorPool(ActorPoolConfig(backend="cuda", count=k)) as pool:
            seq_ms, seq = await host_ms(lambda: NodeScheduler(graph, pool=pool).run(
                {"gradients": x}), 3)
            par_ms, par = await host_ms(lambda: ParallelScheduler(graph, pool=pool).run(
                {"gradients": x}), 3)
        for b in graph.outputs:
            check(bits_equal(seq[b], par[b]), f"(d) pool of {k}: {b} differs between the schedulers")
            check(bool(torch.isfinite(seq[b]).all()), f"(d) pool of {k}: {b} not finite")
        node, parallel = BYZPY_SCHEDULER[k]
        out[f"pool{k}"] = {"node_scheduler_ms": seq_ms, "parallel_scheduler_ms": par_ms,
                           "speedup": seq_ms / par_ms, "byzpy_node_scheduler_ms": node,
                           "byzpy_parallel_scheduler_ms": parallel}
        log(f"  (d) pool x{k}: NodeScheduler {seq_ms:.3f} ms (ByzPy {node}), ParallelScheduler "
            f"{par_ms:.3f} ms (ByzPy {parallel}), speedup {seq_ms / par_ms:.3f} (ByzPy "
            f"{node / parallel:.2f}); the outputs bit for bit equal")
    torch.cuda.synchronize()
    for key, v in kernels.launch_counts.items():
        counts[key] += v
    out["launches"] = {key: v for key, v in kernels.launch_counts.items() if v}
    return out


async def engine_many_streams(counts: dict) -> dict:
    """(e) configs #1 and #2 on a ``cuda`` pool of 6 give the bits of a
    pool of 1 (the direct path); then the capture guard."""
    import torch

    from byzpy_tpu_torch.aggregators import CoordinateWiseMedian, MultiKrum
    from byzpy_tpu_torch.engine.graph import (ActorPool, ActorPoolConfig, NodeScheduler,
                                              make_single_operator_graph)
    from byzpy_tpu_torch.ops import kernels

    x1 = list(random_rounds((1, 10, 100_000), seed=41)[0])
    x2 = random_rounds((1,) + HEADLINE, seed=42)[0]
    configs = {"config1": (make_single_operator_graph(CoordinateWiseMedian()), x1),
               "config2": (make_single_operator_graph(MultiKrum(8, 12)), x2)}
    bits = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for k in (1, 6):
        async with ActorPool(ActorPoolConfig(backend="cuda", count=k)) as pool:
            for name, (graph, inputs) in configs.items():
                bits[(name, k)] = (await NodeScheduler(graph, pool=pool).run(
                    {"gradients": inputs}))["op"]
    torch.cuda.synchronize()
    for key, v in kernels.launch_counts.items():
        counts[key] += v
    launches = {key: v for key, v in kernels.launch_counts.items() if v}
    for name in configs:
        check(bits_equal(bits[(name, 6)], bits[(name, 1)]),
              f"(e) {name}: a pool of 6 differs from a pool of 1")
    del x2, bits
    torch.cuda.empty_cache()
    log(f"  (e) pool of 6 == pool of 1 bit for bit on configs #1 and #2 (launches "
        f"{json.dumps(launches)})")
    return {"bitwise_pool6_vs_pool1": sorted(configs), "launches": launches,
            **await engine_capture_guard()}


async def engine_capture_guard() -> dict:
    """(e) the capture guard: a ``jit_ps_train_step`` capture while a
    ``cuda`` pool runs a call refuses with ``GraphCaptureError``; after the
    pool has closed the same step captures and replays."""
    import asyncio
    import threading

    import torch

    from byzpy_tpu_torch.engine.graph import ActorPool, ActorPoolConfig, SubTask
    from byzpy_tpu_torch.models import SmallCNN, make_bundle, synthetic_classification
    from byzpy_tpu_torch.ops import robust
    from byzpy_tpu_torch.parallel import PSStepConfig, jit_ps_train_step
    from byzpy_tpu_torch.utils.cuda_graph import GraphCaptureError

    bundle = make_bundle(SmallCNN(), seed=0, device="cuda")
    xs, ys = synthetic_classification(n_samples=MAIN_N * MAIN_BATCH, seed=3, device="cuda")
    xs, ys = xs.reshape(MAIN_N, MAIN_BATCH, 28, 28, 1), ys.reshape(MAIN_N, MAIN_BATCH)
    step, opt0 = jit_ps_train_step(bundle, robust.coordinate_median, PSStepConfig(n_nodes=MAIN_N))
    refused = None
    async with ActorPool(ActorPoolConfig(backend="cuda", count=6)) as pool:
        release = threading.Event()
        busy = asyncio.ensure_future(pool.run_subtask(SubTask(fn=release.wait, args=(60,))))
        await asyncio.sleep(0.2)
        try:
            step(bundle.params, opt0, xs, ys)
        except GraphCaptureError as exc:
            refused = str(exc)
        finally:
            release.set()
        await busy
    check(refused is not None and "cuda actor call" in refused,
          f"(e) a capture while the pool ran did not refuse: {refused}")
    check(not step.graphs, "(e) the refused capture left a graph")
    _, _, m = step(bundle.params, opt0, xs, ys)
    torch.cuda.synchronize()
    check(len(step.graphs) == 1 and math.isfinite(float(m["agg_grad_norm"])),
          "(e) the capture after the pool closed failed")
    log(f"  (e) a capture while the pool ran refused: {refused[:120]}...; after close "
        f"captured {len(step.graphs)} graph")
    return {"capture_refused": refused, "capture_after_close": len(step.graphs)}


def engine_path(counts: dict) -> dict:
    """Phase 4f: (a)-(e), every await bounded."""
    import asyncio

    async def phase():
        return {"a_config1": await engine_config1(counts),
                "b_config2": await engine_config2(counts),
                "c_pool_table": await engine_pool_table(counts),
                "d_schedulers": await engine_schedulers(counts),
                "e_many_streams": await engine_many_streams(counts)}

    return asyncio.run(asyncio.wait_for(phase(), ENGINE_WAIT_S))


# ---------------------------------------------------------------------------
# phase 4g: the orchestrators (node actors, ParameterServer, the P2P runner)
# ---------------------------------------------------------------------------

# every await of phase 4g is bounded by this
ORCH_WAIT_S = 600
ORCH_LR = 0.1
ORCH_BATCH = 64
# BASELINE config #3 at examples/ps/thread_mnist.py's shape
C3_HONEST, C3_BYZ, C3_ROUNDS = 6, 2, 30
ORCH_ROUNDS = 5
P2P_MNIST_ROUNDS = 40
AUTO_ROUNDS = 15
# the trimmed mean's and Multi-Krum's streaming folds sum (or take their
# Gram's dot products) in arrival order: f32 rounding of an aggregate of 8
# SmallCNN gradients (|g| <= ~1), against the barrier's kernels
FOLD_RTOL, FOLD_ATOL = 1e-5, 1e-6
# (c): a node call may take this long; the hanging node sleeps longer
ELASTIC_TIMEOUT_S, ELASTIC_HANG_S = 2.0, 4.0
ORCH_DEVICE = "cuda"


def orchestrator_nodes():
    """Phase 4g's node classes (made here: the port is importable only
    after ``main`` put the checkout on the path)."""
    import torch

    from byzpy_tpu_torch.engine.node import ByzantineNode, HonestNode
    from byzpy_tpu_torch.models import sample_batch

    class ModelNode(HonestNode):
        """An honest worker: its shard, a generator of its own, the
        gradient of the bundle's loss (``torch.func.grad``) and SGD.
        ``configure`` makes a later call raise, or sleep and return a NaN
        gradient (the result an abandoned call must never fold)."""

        def __init__(self, make_bundle, shard_x, shard_y, seed):
            self.bundle = make_bundle()
            self.x, self.y = shard_x, shard_y
            self.gen = torch.Generator(device=shard_x.device).manual_seed(seed)
            self._grad = torch.func.grad(self.bundle.loss_fn)
            self.calls = 0
            self.fail_at = self.hang_at = None

        def configure(self, fail_after=None, hang_after=None):
            """Raise at the ``fail_after``-th call from now (0: the next),
            sleep at the ``hang_after``-th."""
            self.fail_at = None if fail_after is None else self.calls + fail_after
            self.hang_at = None if hang_after is None else self.calls + hang_after

        def next_batch(self):
            return sample_batch(self.x, self.y, self.gen, ORCH_BATCH)

        def honest_gradient(self, x, y):
            call = self.calls
            self.calls += 1
            if call == self.fail_at:
                raise RuntimeError(f"node lost its card at call {call}")
            grads = self._grad(self.bundle.params, x, y)
            if call == self.hang_at:
                time.sleep(ELASTIC_HANG_S)
                return {k: torch.full_like(v, float("nan")) for k, v in grads.items()}
            return grads

        def apply_server_gradient(self, gradient):
            self.bundle.params = {k: p - ORCH_LR * gradient[k] for k, p in self.bundle.params.items()}

        def resync_params(self, params):
            self.bundle.params = {k: v.clone() for k, v in params.items()}

        def accuracy(self, x, y):
            logits = self.bundle.apply(self.bundle.params, x)
            return float((logits.argmax(-1) == y).float().mean())

        def flat_params(self):
            return torch.cat([v.reshape(-1) for v in self.bundle.params.values()])

    class SignFlipNode(ByzantineNode):
        """``-3 x`` the honest mean (examples/ps/thread_mnist.py)."""

        def next_batch(self):
            return None, None

        def byzantine_gradient(self, honest_gradients):
            return {k: -3.0 * (sum(g[k] for g in honest_gradients) / len(honest_gradients))
                    for k in honest_gradients[0]}

        def apply_server_gradient(self, gradient):
            pass

    return ModelNode, SignFlipNode


def tree_bits_equal(a, b) -> bool:
    """Two gradients (tensors or dictionaries of them) equal bit for bit."""
    if isinstance(a, dict):
        return list(a) == list(b) and all(bits_equal(a[k], b[k]) for k in a)
    return bits_equal(a, b)


def tree_flat(tree):
    import torch

    if isinstance(tree, dict):
        return torch.cat([v.reshape(-1) for v in tree.values()])
    return tree.reshape(-1)


def record_aggregate(agg):
    """``agg`` whose ``aggregate`` keeps each call's gradient list and
    result (``agg.calls``) and whose folds keep each round's slots
    (``agg.folds``: the rows in slot order and the result)."""
    plain, fold, finalize = agg.aggregate, agg.fold, agg.fold_finalize
    agg.calls, agg.folds, slots = [], [], {}

    def aggregate(gradients):
        out = plain(gradients)
        agg.calls.append((list(gradients), out))
        return out

    def fold_(state, index, gradient):
        slots.setdefault(id(state), {})[index] = gradient
        fold(state, index, gradient)

    def finalize_(state):
        out = finalize(state)
        got = slots.pop(id(state), {})
        agg.folds.append(([got[i] for i in sorted(got)], out))
        return out

    agg.aggregate, agg.fold, agg.fold_finalize, agg.plain_aggregate = (
        aggregate, fold_, finalize_, plain)
    return agg


class RoundClock:
    """A ``ps.round`` that keeps each round's host ms (synchronized at both
    ends) for ``train_with_progress_async``."""

    def __init__(self, ps) -> None:
        self.ps, self.ms = ps, []

    async def round(self):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = await self.ps.round()
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def median_ms(times) -> float:
    return sorted(times)[len(times) // 2]


def orch_counts(counts: dict, name: str, want: dict) -> dict:
    """The launches since the last reset, checked against ``want`` exactly
    (every key named, nothing else) and added to the main path's counts."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    got = {k: v for k, v in kernels.launch_counts.items() if v}
    check(got == want, f"{name}: launches {got}, not {want}")
    for k, v in got.items():
        counts[k] += v
    return got


async def spawn_model_nodes(make_bundle, data, n_honest: int, n_byz: int, backend: str):
    from byzpy_tpu_torch.engine.node import ByzantineNodeActor, HonestNodeActor

    ModelNode, SignFlipNode = orchestrator_nodes()
    honest = [await HonestNodeActor.spawn(ModelNode, make_bundle, *data.node_slice(i), i,
                                          backend=backend) for i in range(n_honest)]
    byz = [await ByzantineNodeActor.spawn(SignFlipNode, backend=backend) for _ in range(n_byz)]
    return honest, byz


async def close_all(actors) -> None:
    for a in actors:
        await a.close()


async def orch_config3(counts: dict, smi: str) -> dict:
    """(a) BASELINE config #3 at examples/ps/thread_mnist.py's shape: 6
    honest ``mnist_mlp(hidden=128)`` nodes and 2 sign-flip nodes in ``cuda``
    actors, 4,096 samples, batch 64, the trimmed mean (f = 2), 30 rounds
    through ``train_with_progress_async``; then the same on ``thread``
    actors, whose aggregates must be the same bits."""
    import torch

    from byzpy_tpu_torch.aggregators import CoordinateWiseTrimmedMean
    from byzpy_tpu_torch.engine.parameter_server import ParameterServer
    from byzpy_tpu_torch.models import ShardedDataset, mnist_mlp, synthetic_classification
    from byzpy_tpu_torch.ops import kernels
    from byzpy_tpu_torch.utils.training import train_with_progress_async

    x, y = synthetic_classification(n_samples=4096, seed=0, device=ORCH_DEVICE)
    data = ShardedDataset(x, y, C3_HONEST)
    torch.cuda.synchronize()
    out, aggregates = {}, {}
    for backend in ("cuda", "thread"):
        honest, byz = await spawn_model_nodes(
            lambda: mnist_mlp(seed=0, hidden=128, device=ORCH_DEVICE), data, C3_HONEST, C3_BYZ,
            backend)
        agg = record_aggregate(CoordinateWiseTrimmedMean(f=C3_BYZ, device=ORCH_DEVICE))
        ps = ParameterServer(honest, byz, aggregator=agg)
        clock = RoundClock(ps)

        async def evaluate(i, honest=honest):
            return await honest[0].accuracy(x, y)

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        history = await train_with_progress_async(clock, C3_ROUNDS, eval_callback=evaluate,
                                                  eval_interval=10, progress=False)
        got = orch_counts(counts, f"(a) {backend}", {"sorted_reduce:trimmed": C3_ROUNDS})
        check(len(agg.calls) == C3_ROUNDS, f"(a) {backend}: {len(agg.calls)} aggregations")
        d = int(tree_flat(agg.calls[0][1]).numel())
        check(d == 101_770, f"(a) mnist_mlp(hidden=128) has d = {d}")
        accuracy = history[-1][1]
        check(accuracy > 0.5, f"(a) {backend}: accuracy {accuracy} after {C3_ROUNDS} rounds")
        # each round's aggregate against the class's direct call on the
        # gathered list (launches outside the counted run)
        for r, (grads, res) in enumerate(agg.calls):
            check(len(grads) == C3_HONEST + C3_BYZ, f"(a) round {r} gathered {len(grads)}")
            check(tree_bits_equal(agg.plain_aggregate(grads), res),
                  f"(a) {backend} round {r}: the aggregate differs from the direct call")
        aggregates[backend] = [res for _, res in agg.calls]
        await close_all(honest + byz)
        out[backend] = {"host_ms_per_round": median_ms(clock.ms), "first_round_ms": clock.ms[0],
                        "launches_per_round": {k: v / C3_ROUNDS for k, v in got.items()},
                        "accuracy": [round(float(a), 4) for _, a in history]}
    check(all(tree_bits_equal(a, b) for a, b in zip(aggregates["cuda"], aggregates["thread"])),
          "(a) the cuda actors' aggregates differ from the thread actors'")
    out["cuda_equals_thread_bitwise"] = True
    log(f"  (a) config #3, mnist_mlp d = 101,770, 6 + 2 nodes, trimmed mean f = 2, "
        f"{C3_ROUNDS} rounds: host ms/round cuda actors {out['cuda']['host_ms_per_round']:.3f}, "
        f"thread actors {out['thread']['host_ms_per_round']:.3f}; accuracy "
        f"{out['cuda']['accuracy']}; B1 launches/round {out['cuda']['launches_per_round']}; every "
        f"aggregate = the direct call, cuda = thread bit for bit [{smi}]")
    return out


async def call_costs(honest, data, reps: int = 10) -> dict:
    """Host ms (median of ``reps``, synchronized) of one SmallCNN gradient:
    inline on the caller's thread, through one ``cuda`` node actor, and
    the six actors' calls at once."""
    import torch

    from byzpy_tpu_torch.models import SmallCNN, make_bundle

    ModelNode, _ = orchestrator_nodes()
    local = ModelNode(lambda: make_bundle(SmallCNN(), seed=0, device=ORCH_DEVICE), *data.node_slice(0), 0)

    async def inline():
        return local.honest_gradient_for_next_batch()

    async def all_six():
        return await asyncio.gather(*(h.honest_gradient_for_next_batch() for h in honest))

    out = {}
    for key, fn in (("inline", inline), ("one_cuda_actor", honest[0].honest_gradient_for_next_batch),
                    ("six_cuda_actors_at_once", all_six)):
        await fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            await fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[key] = median_ms(times)
    return out


async def orch_smallcnn(counts: dict, smi: str) -> dict:
    """(b) The ParameterServer at the main path's width: SmallCNN (d =
    421,642), 6 honest and 2 sign-flip nodes in ``cuda`` actors, batch
    64, 5 rounds a configuration."""
    import torch

    from byzpy_tpu_torch.aggregators import CoordinateWiseTrimmedMean, GeometricMedian, MultiKrum
    from byzpy_tpu_torch.engine.graph import ActorPoolConfig
    from byzpy_tpu_torch.engine.overlap import OverlapConfig
    from byzpy_tpu_torch.engine.parameter_server import ParameterServer
    from byzpy_tpu_torch.models import SmallCNN, ShardedDataset, make_bundle, synthetic_classification
    from byzpy_tpu_torch.ops import kernels, robust
    from byzpy_tpu_torch.pre_aggregators import NearestNeighborMixing

    x, y = synthetic_classification(n_samples=6 * 512, seed=3, device=ORCH_DEVICE)
    data = ShardedDataset(x, y, 6)
    torch.cuda.synchronize()
    n_rounds = ORCH_ROUNDS
    B1T, B1M = "sorted_reduce:trimmed", "sorted_reduce:median"
    configs = {
        "trimmed_serial": (lambda: CoordinateWiseTrimmedMean(f=2, device=ORCH_DEVICE), {}, {B1T: n_rounds}),
        "trimmed_barrier_prefetch": (lambda: CoordinateWiseTrimmedMean(f=2, device=ORCH_DEVICE),
                                     {"overlap": OverlapConfig(stream=False, prefetch_depth=1)},
                                     {B1T: n_rounds}),
        # the incremental fold (running sum and extreme buffers) is plain
        # PyTorch: no kernel
        "trimmed_stream_prefetch": (lambda: CoordinateWiseTrimmedMean(f=2, device=ORCH_DEVICE),
                                    {"overlap": OverlapConfig(stream=True, prefetch_depth=1)}, {}),
        "multi_krum_stream": (lambda: MultiKrum(f=2, q=4, device=ORCH_DEVICE),
                              {"overlap": OverlapConfig(stream=True, prefetch_depth=1)},
                              {"selection_mean_from_gram:krum": n_rounds}),
        "nnm_multi_krum": (lambda: MultiKrum(f=2, q=4, device=ORCH_DEVICE),
                           {"pre_aggregator": NearestNeighborMixing(f=2, device=ORCH_DEVICE)},
                           {"gram": n_rounds, "nnm_selection_weights:krum": n_rounds,
                            "weighted_rows": n_rounds}),
        "geometric_median_pool": (lambda: GeometricMedian(device=ORCH_DEVICE),
                                  {"pool_config": ActorPoolConfig(backend="cuda", count=2)},
                                  {B1M: n_rounds}),
    }
    out, finals = {}, {}
    for name, (make_agg, kw, want) in configs.items():
        honest, byz = await spawn_model_nodes(
            lambda: make_bundle(SmallCNN(), seed=0, device=ORCH_DEVICE), data, 6, 2, "cuda")
        agg = record_aggregate(make_agg())
        ps = ParameterServer(honest, byz, aggregator=agg, **kw)
        pooled, fused = [], []
        if ps._executor is not None:
            run = ps._executor.run

            async def run_logged(inputs, run=run, pooled=pooled):
                res = await run(inputs)
                pooled.append((list(inputs), res))
                return res
            ps._executor.run = run_logged
        if ps._fused_pipeline is not None:
            fn = ps._fused_pipeline

            def fused_logged(matrix, fn=fn, fused=fused):
                res = fn(matrix)
                fused.append((matrix, res))
                return res
            ps._fused_pipeline = fused_logged
        aggs, ms, modes = [], [], []

        async def on_round(i, a, aggs=aggs, ms=ms, ps=ps, modes=modes):
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - clock[0]) * 1e3)
            aggs.append(a)
            modes.append(None if ps.last_overlap_stats is None else ps.last_overlap_stats.mode)
            clock[0] = time.perf_counter()

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        clock = [time.perf_counter()]
        await ps.run(n_rounds, on_round=on_round)
        got = orch_counts(counts, f"(b) {name}", want)
        await ps.close()
        params = [await h.flat_params() for h in honest]
        check(int(params[0].numel()) == 421_642, f"(b) SmallCNN has d = {params[0].numel()}")
        calls = await call_costs(honest, data) if name == "trimmed_serial" else None
        await close_all(honest + byz)
        finals[name] = (aggs, params)
        entry = {"host_ms_per_round": median_ms(ms), "first_round_ms": ms[0],
                 "launches_per_round": {k: v / n_rounds for k, v in got.items()},
                 "overlap_modes": modes}
        if calls is not None:
            entry["gradient_call_ms"] = calls
            log(f"  (b) one SmallCNN gradient, host ms: {json.dumps(calls)} [{smi}]")
        # each configuration against its direct calls, outside the counted run
        if name.startswith("trimmed") and name != "trimmed_stream_prefetch":
            for grads, res in agg.calls:
                check(tree_bits_equal(agg.plain_aggregate(grads), res),
                      f"(b) {name}: an aggregate differs from the direct call")
        if name in ("trimmed_stream_prefetch", "multi_krum_stream"):
            check(len(agg.folds) == n_rounds and modes == ["stream"] * n_rounds,
                  f"(b) {name}: {len(agg.folds)} folded rounds, modes {modes}")
            worst = 0.0
            for rows, res in agg.folds:
                direct = agg.plain_aggregate(rows)
                a, b = tree_flat(res), tree_flat(direct)
                check(bool(torch.allclose(a, b, rtol=FOLD_RTOL, atol=FOLD_ATOL)),
                      f"(b) {name}: the fold's aggregate is off the barrier's")
                worst = max(worst, float((a - b).abs().max()))
            entry["fold_vs_barrier_max_abs"] = worst
        if name == "nnm_multi_krum":
            check(len(fused) == n_rounds, f"(b) {name}: {len(fused)} fused calls, not {n_rounds}")
            worst = 0.0
            for matrix, res in fused:
                check(bits_equal(robust.nnm_multi_krum(matrix, f_nnm=2, f=2, q=4), res),
                      f"(b) {name}: the fused call differs from robust.nnm_multi_krum")
                two = agg.plain_aggregate(NearestNeighborMixing(f=2, device=ORCH_DEVICE)
                                          .pre_aggregate(list(matrix)))
                worst = max(worst, float((two - res).abs().max()))
                check(bool(torch.allclose(two, res, rtol=FOLD_RTOL, atol=FOLD_ATOL)),
                      f"(b) {name}: the fused pipeline is off the two-step path")
            entry["fused_vs_two_step_max_abs"] = worst
        if name == "geometric_median_pool":
            check(len(pooled) == n_rounds, f"(b) {name}: {len(pooled)} pooled calls")
            worst = 0.0
            for grads, res in pooled:
                a, b = tree_flat(res), tree_flat(agg.plain_aggregate(grads))
                check(bool(torch.allclose(a, b, rtol=LOOP_RTOL, atol=LOOP_ATOL)),
                      f"(b) {name}: the pooled geometric median is off the direct call")
                worst = max(worst, float((a - b).abs().max()))
            entry["pool_vs_direct_max_abs"] = worst
        out[name] = entry
        log(f"  (b) {name}: host ms/round {entry['host_ms_per_round']:.3f} (first "
            f"{entry['first_round_ms']:.1f}), launches/round {entry['launches_per_round']}, "
            f"modes {modes}" + "".join(f", {k} {entry[k]:.3g}" for k in (
                "fold_vs_barrier_max_abs", "fused_vs_two_step_max_abs", "pool_vs_direct_max_abs")
                if k in entry) + f" [{smi}]")
    serial_aggs, serial_params = finals["trimmed_serial"]
    aggs, params = finals["trimmed_barrier_prefetch"]
    check(all(tree_bits_equal(a, b) for a, b in zip(aggs, serial_aggs))
          and all(bits_equal(a, b) for a, b in zip(params, serial_params)),
          "(b) the overlapped barrier round (prefetch 1) differs from the serial round")
    aggs, params = finals["trimmed_stream_prefetch"]
    worst = max(float((tree_flat(a) - tree_flat(b)).abs().max()) for a, b in zip(aggs, serial_aggs))
    worst_p = max(float((a - b).abs().max()) for a, b in zip(params, serial_params))
    bitwise = (all(tree_bits_equal(a, b) for a, b in zip(aggs, serial_aggs))
               and all(bits_equal(a, b) for a, b in zip(params, serial_params)))
    check(all(bool(torch.allclose(tree_flat(a), tree_flat(b), rtol=FOLD_RTOL, atol=FOLD_ATOL))
              for a, b in zip(aggs, serial_aggs)),
          f"(b) the streamed trimmed mean is off the serial round by {worst}")
    out["serial_vs_overlapped"] = {
        "barrier_prefetch_bitwise": True, "stream_prefetch_bitwise": bitwise,
        "stream_prefetch_max_abs_aggregate": worst, "stream_prefetch_max_abs_params": worst_p,
        "host_ms_per_round": {k: out[k]["host_ms_per_round"] for k in (
            "trimmed_serial", "trimmed_barrier_prefetch", "trimmed_stream_prefetch")}}
    log(f"  (b) serial vs overlapped (trimmed mean): host ms/round "
        f"{json.dumps(out['serial_vs_overlapped']['host_ms_per_round'])}; barrier + prefetch bit "
        f"for bit; stream + prefetch bitwise {bitwise}, max |diff| aggregate {worst:.3g}, params "
        f"{worst_p:.3g} [{smi}]")
    return out


async def orch_elastic(counts: dict, smi: str) -> dict:
    """(c) ``ElasticPolicy`` over ``cuda`` node actors (mnist_mlp, 6 + 2,
    the trimmed mean): honest node 1 raises in round 2, node 2 outlives
    the call timeout in round 3 (its abandoned result is NaN), both are
    probed, resynced and re-admitted; every aggregate is the direct call
    over the survivors; then the quorum is lost."""
    import torch

    from byzpy_tpu_torch.aggregators import CoordinateWiseTrimmedMean
    from byzpy_tpu_torch.engine.parameter_server import ElasticPolicy, ParameterServer, QuorumLostError
    from byzpy_tpu_torch.models import ShardedDataset, mnist_mlp, synthetic_classification
    from byzpy_tpu_torch.ops import kernels

    x, y = synthetic_classification(n_samples=4096, seed=1, device=ORCH_DEVICE)
    data = ShardedDataset(x, y, 6)
    torch.cuda.synchronize()
    honest, byz = await spawn_model_nodes(
        lambda: mnist_mlp(seed=0, hidden=128, device=ORCH_DEVICE), data, 6, 2, "cuda")
    # one call each outside the policy's clock: a node's first gradient
    # builds its autograd and library state
    for h in honest:
        await h.honest_gradient_for_next_batch()
    await honest[1].configure(fail_after=1)
    await honest[2].configure(hang_after=2)
    shadow = {"params": dict(mnist_mlp(seed=0, hidden=128, device=ORCH_DEVICE).params)}
    policy = ElasticPolicy(min_quorum=4, call_timeout=ELASTIC_TIMEOUT_S,
                           resync=lambda: shadow["params"])
    agg = record_aggregate(CoordinateWiseTrimmedMean(f=2, device=ORCH_DEVICE))
    ps = ParameterServer(honest, byz, aggregator=agg, elastic=policy)
    ms = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for r in range(ORCH_ROUNDS):
        t0 = time.perf_counter()
        a = await ps.round()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        shadow["params"] = {k: p - ORCH_LR * a[k] for k, p in shadow["params"].items()}
        if r == 2:
            # the abandoned call ends before its node is probed again
            await asyncio.sleep(ELASTIC_HANG_S)
    got = orch_counts(counts, "(c) elastic", {"sorted_reduce:trimmed": ORCH_ROUNDS})
    sizes = [len(g) for g, _ in agg.calls]
    check(sizes == [8, 7, 7, 8, 8], f"(c) gathered {sizes} gradients a round, not [8, 7, 7, 8, 8]")
    for r, (grads, res) in enumerate(agg.calls):
        check(all(bool(torch.isfinite(tree_flat(g)).all()) for g in grads),
              f"(c) round {r}: a non-finite gradient (the abandoned call's) was gathered")
        check(tree_bits_equal(agg.plain_aggregate(grads), res),
              f"(c) round {r}: the aggregate differs from the direct call over the survivors")
    events = list(ps.elastic_state.events)
    for nid, r_fail, r_back in (("honest:1", 1, 2), ("honest:2", 2, 3)):
        for kind, r in (("suspected", r_fail), ("failed", r_fail), ("resync", r_back),
                        ("readmitted", r_back)):
            check((r, nid, kind) in events, f"(c) no {(r, nid, kind)} in the events {events}")
    check(not ps.elastic_state.suspects, f"(c) suspects left: {ps.elastic_state.suspects}")
    # the quorum lost: six honest nodes required, node 1 raises again
    await honest[1].configure(fail_after=0)
    strict = ParameterServer(honest, byz, aggregator=CoordinateWiseTrimmedMean(f=2, device=ORCH_DEVICE),
                             elastic=ElasticPolicy(min_quorum=6, call_timeout=ELASTIC_TIMEOUT_S))
    lost = None
    try:
        await strict.round()
    except QuorumLostError as exc:
        lost = str(exc)
    check(lost is not None and "min_quorum=6" in lost, f"(c) the quorum was not lost: {lost}")
    await close_all(honest + byz)
    out = {"host_ms_per_round": ms, "gathered_per_round": sizes,
           "launches_per_round": {k: v / ORCH_ROUNDS for k, v in got.items()},
           "events": [list(e) for e in events], "quorum_lost": lost}
    log(f"  (c) elastic: host ms per round {[round(v, 3) for v in ms]} (round 3 waits out the "
        f"{ELASTIC_TIMEOUT_S} s timeout), gathered {sizes}, every aggregate = the direct call over "
        f"the survivors, both suspects resynced and re-admitted, then {lost!r} [{smi}]")
    return out


def gossip_worker(make_bundle, sx, sy, seed: int):
    """An ``SGDModelWorker`` drawing batches of its shard with a numpy
    generator, as examples/p2p/gossip_mnist.py does."""
    import numpy as np
    import torch

    from byzpy_tpu_torch.engine.peer_to_peer import SGDModelWorker

    rng = np.random.default_rng(seed)

    def batch_fn():
        idx = torch.from_numpy(rng.integers(0, sx.shape[0], size=ORCH_BATCH)).to(sx.device)
        return sx.index_select(0, idx), sy.index_select(0, idx)

    return SGDModelWorker(make_bundle(), batch_fn)


async def timed_rounds(round_fn, rounds: int) -> tuple:
    """``(outputs, host ms of each round)`` of ``rounds`` awaited calls."""
    import torch

    outs, ms = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(await round_fn())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


async def orch_p2p(counts: dict, smi: str) -> dict:
    """(d) examples/p2p/gossip_mnist.py's shape through ``PeerToPeer``, then
    SmallCNN on ``ring(8, 2)`` with the geometric median, barrier against
    streaming. The P2P nodes run where the runner runs them, on the event
    loop's thread (the reference's runner hosts no node in an actor; its
    ``context_factory`` is where process and remote contexts plug in)."""
    import torch

    from byzpy_tpu_torch.aggregators import CoordinateWiseTrimmedMean, GeometricMedian
    from byzpy_tpu_torch.attacks import EmpireAttack
    from byzpy_tpu_torch.engine.overlap import OverlapConfig
    from byzpy_tpu_torch.engine.peer_to_peer import (AttackP2PWorker, DecentralizedPeerToPeer,
                                                     PeerToPeer, Topology)
    from byzpy_tpu_torch.models import (SmallCNN, ShardedDataset, make_bundle, mnist_mlp,
                                        synthetic_classification)
    from byzpy_tpu_torch.ops import kernels

    out = {}
    x, y = synthetic_classification(n_samples=4096, seed=0, device=ORCH_DEVICE)
    data = ShardedDataset(x, y, 4)
    workers = [gossip_worker(lambda: mnist_mlp(seed=0, device=ORCH_DEVICE), *data.node_slice(i), i)
               for i in range(4)]
    p2p = PeerToPeer(workers, [AttackP2PWorker(EmpireAttack(scale=-3.0, device=ORCH_DEVICE))],
                     aggregator=CoordinateWiseTrimmedMean(f=1, device=ORCH_DEVICE),
                     topology=Topology.complete(5), learning_rate=0.1)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    _, ms = await timed_rounds(p2p.round, P2P_MNIST_ROUNDS)
    await p2p.shutdown_async()
    got = orch_counts(counts, "(d) gossip_mnist", {"sorted_reduce:trimmed": 4 * P2P_MNIST_ROUNDS})
    bundle = mnist_mlp(seed=0, device=ORCH_DEVICE)
    acc = float((bundle.apply(workers[0].params, x).argmax(-1) == y).float().mean())
    check(acc > 0.5, f"(d) worker 0's accuracy {acc} after {P2P_MNIST_ROUNDS} rounds")
    out["gossip_mnist"] = {"host_ms_per_round": median_ms(ms), "first_round_ms": ms[0],
                           "accuracy": acc,
                           "launches_per_round": {k: v / P2P_MNIST_ROUNDS for k, v in got.items()}}
    log(f"  (d) gossip_mnist: complete(5), 4 SGDModelWorkers + Empire (-3), trimmed mean f = 1, "
        f"{P2P_MNIST_ROUNDS} rounds: host ms/round {median_ms(ms):.3f}, worker 0 accuracy {acc:.4f}, "
        f"launches/round {out['gossip_mnist']['launches_per_round']} [{smi}]")

    x, y = synthetic_classification(n_samples=6 * 512, seed=5, device=ORCH_DEVICE)
    data = ShardedDataset(x, y, 6)
    runs = {}
    for mode, overlap in (("barrier", None), ("stream", OverlapConfig(stream=True, prefetch_depth=0))):
        workers = [gossip_worker(lambda: make_bundle(SmallCNN(), seed=0, device=ORCH_DEVICE),
                                 *data.node_slice(i), 100 + i) for i in range(6)]
        agg = record_aggregate(GeometricMedian(device=ORCH_DEVICE))
        runner = DecentralizedPeerToPeer(
            workers, [AttackP2PWorker(EmpireAttack(scale=-3.0, device=ORCH_DEVICE)) for _ in range(2)],
            aggregator=agg, topology=Topology.ring(8, 2), learning_rate=0.1, overlap=overlap)
        await runner.setup()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        outs, ms = await timed_rounds(runner.run_round_async, ORCH_ROUNDS)
        got = orch_counts(counts, f"(d) ring(8, 2) {mode}",
                          {"sorted_reduce:median": 6 * ORCH_ROUNDS,
                           "center_loop:weiszfeld": 6 * ORCH_ROUNDS})
        await runner.shutdown()
        calls = agg.calls if mode == "barrier" else agg.folds
        check(len(calls) == 6 * ORCH_ROUNDS, f"(d) {mode}: {len(calls)} aggregations")
        for vectors, res in calls:
            # own half step first, then its two frames in arrival order
            check(len(vectors) == 3 and bits_equal(agg.plain_aggregate(vectors), res),
                  f"(d) {mode}: an aggregate differs from the direct call on its vectors")
        runs[mode] = (outs, [w.parameters() for w in workers])
        out[f"ring_{mode}"] = {"host_ms_per_round": median_ms(ms), "first_round_ms": ms[0],
                               "launches_per_round": {k: v / ORCH_ROUNDS for k, v in got.items()}}
        log(f"  (d) SmallCNN ring(8, 2), 6 + 2 Empire, geometric median, {mode}: host ms/round "
            f"{median_ms(ms):.3f}, launches/round {out[f'ring_{mode}']['launches_per_round']} [{smi}]")
    (b_outs, b_params), (s_outs, s_params) = runs["barrier"], runs["stream"]
    check(all(bits_equal(o1[i], o2[i]) for o1, o2 in zip(b_outs, s_outs) for i in o1)
          and all(bits_equal(a, b) for a, b in zip(b_params, s_params)),
          "(d) the streaming gossip rounds differ from the barrier rounds")
    out["ring_barrier_equals_stream_bitwise"] = True
    return out


async def orch_autonomous(counts: dict, smi: str) -> dict:
    """(e) examples/p2p/decentralized_autonomous.py: 4 nodes on
    ``complete(4)`` drive themselves (half step, gossip, coordinate median)
    for 15 rounds and reach consensus."""
    import numpy as np
    import torch

    from byzpy_tpu_torch.aggregators import CoordinateWiseMedian
    from byzpy_tpu_torch.engine.node import DecentralizedCluster, DecentralizedNode, InProcessContext
    from byzpy_tpu_torch.engine.peer_to_peer import Topology
    from byzpy_tpu_torch.ops import kernels

    cluster = DecentralizedCluster(Topology.complete(4))
    nodes, events, finals = [], [], {}
    targets = np.linspace(0.0, 2.0, 4)

    def loop(target, done):
        async def run(node):
            agg = CoordinateWiseMedian(device=ORCH_DEVICE)
            w = torch.zeros((32,), device=ORCH_DEVICE)
            n_in = len(node.router.in_neighbor_ids())
            for _ in range(AUTO_ROUNDS):
                w = w - 0.3 * 2.0 * (w - target)
                await node.broadcast_message("gossip", w)
                received = [(await node.wait_for_message("gossip", timeout=60)).payload
                            for _ in range(n_in)]
                w = agg.aggregate([w] + received)
            finals[node.node_id] = w
            done.set()
        return run

    for i in range(4):
        node = DecentralizedNode(f"auto-{i}", InProcessContext(f"auto-{i}"))
        cluster.add_node(node)
        nodes.append(node)
        events.append(asyncio.Event())
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    async with cluster:
        for node, target, event in zip(nodes, targets, events):
            node.start_autonomous_task(loop(float(target), event))
        await asyncio.gather(*(e.wait() for e in events))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / AUTO_ROUNDS
    got = orch_counts(counts, "(e) autonomous", {"sorted_reduce:median": 4 * AUTO_ROUNDS})
    w0 = [float(finals[n.node_id][0]) for n in nodes]
    spread = max(w0) - min(w0)
    check(spread < 0.15, f"(e) consensus spread {spread}")
    log(f"  (e) decentralized_autonomous: 4 nodes, median, {AUTO_ROUNDS} rounds: {ms:.3f} host ms a "
        f"round of the cluster, spread {spread:.4g}, launches/round "
        f"{ {k: v / AUTO_ROUNDS for k, v in got.items()} } [{smi}]")
    return {"host_ms_per_round": ms, "spread": spread, "final_w0": w0,
            "launches_per_round": {k: v / AUTO_ROUNDS for k, v in got.items()}}


async def orch_heartbeat(counts: dict, smi: str) -> dict:
    """(f) ``HeartbeatPolicy``: of five gossip peers on ``complete(5)``
    (mnist_mlp workers, the coordinate median) one stops answering before
    the first round and is removed; the five rounds after it are the bits
    of a run that starts on ``complete(4)`` without it."""
    import torch

    from byzpy_tpu_torch.aggregators import CoordinateWiseMedian
    from byzpy_tpu_torch.engine.peer_to_peer import DecentralizedPeerToPeer, HeartbeatPolicy, Topology
    from byzpy_tpu_torch.models import ShardedDataset, mnist_mlp, synthetic_classification
    from byzpy_tpu_torch.ops import kernels

    x, y = synthetic_classification(n_samples=4096, seed=2, device=ORCH_DEVICE)
    data = ShardedDataset(x, y, 5)
    runs, out = {}, {}
    for name, n in (("policy", 5), ("without", 4)):
        workers = [gossip_worker(lambda: mnist_mlp(seed=0, device=ORCH_DEVICE), *data.node_slice(i),
                                 200 + i) for i in range(n)]
        policy = HeartbeatPolicy(interval=0.05, max_missed=3, startup_grace=0.0) if n == 5 else None
        runner = DecentralizedPeerToPeer(workers, [], aggregator=CoordinateWiseMedian(device=ORCH_DEVICE),
                                         topology=Topology.complete(n), learning_rate=0.1,
                                         gossip_timeout=30.0, elastic=policy)
        await runner.setup()
        t_removed = None
        if policy is not None:
            t0 = time.perf_counter()
            await runner.nodes[4].shutdown()   # stops answering, no goodbye
            while ("node-4", "removed") not in runner.elastic_events:
                check(time.perf_counter() - t0 < 30.0,
                      f"(f) node-4 not removed: {runner.elastic_events}")
                await asyncio.sleep(0.01)
            t_removed = (time.perf_counter() - t0) * 1e3
            check(runner.honest_indices == [0, 1, 2, 3], f"(f) live {runner.honest_indices}")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        outs, ms = await timed_rounds(runner.run_round_async, ORCH_ROUNDS)
        got = orch_counts(counts, f"(f) {name}", {"sorted_reduce:median": 4 * ORCH_ROUNDS})
        await runner.shutdown()
        runs[name] = (outs, [w.parameters() for w in workers[:4]])
        out[name] = {"host_ms_per_round": median_ms(ms), "ms_to_removal": t_removed,
                     "launches_per_round": {k: v / ORCH_ROUNDS for k, v in got.items()}}
    (p_outs, p_params), (w_outs, w_params) = runs["policy"], runs["without"]
    check(all(sorted(a) == sorted(b) and all(bits_equal(a[i], b[i]) for i in a)
              for a, b in zip(p_outs, w_outs))
          and all(bits_equal(a, b) for a, b in zip(p_params, w_params)),
          "(f) the rounds after the removal differ from a run without the peer")
    out["bitwise_equal_to_run_without_peer"] = True
    log(f"  (f) HeartbeatPolicy(interval 0.05 s, 3 misses): node-4 removed after "
        f"{out['policy']['ms_to_removal']:.1f} ms; then {ORCH_ROUNDS} rounds at host ms/round "
        f"{out['policy']['host_ms_per_round']:.3f} (without it from the start "
        f"{out['without']['host_ms_per_round']:.3f}), bit for bit [{smi}]")
    return out


def orchestrator_path(counts: dict) -> dict:
    """Phase 4g: (a)-(f), every await bounded, with cuDNN's deterministic
    algorithms (SmallCNN's convolutions: runs compared bit for bit)."""
    import torch

    smi = nvidia_smi_line()

    async def phase():
        return {"a_config3": await orch_config3(counts, smi),
                "b_smallcnn_ps": await orch_smallcnn(counts, smi),
                "c_elastic": await orch_elastic(counts, smi),
                "d_p2p": await orch_p2p(counts, smi),
                "e_autonomous": await orch_autonomous(counts, smi),
                "f_heartbeat": await orch_heartbeat(counts, smi)}

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        return asyncio.run(asyncio.wait_for(phase(), ORCH_WAIT_S))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


# ---------------------------------------------------------------------------
# phase 4i: more than 128 rows, and the out-of-process actor tier
# ---------------------------------------------------------------------------

# (a): the row counts above the networks' 128, at ByzPy's grid width
# 129 (the first above the networks) and 512; 196 and 256 were run before and are left
# out to keep the script's time
WIDE_ROWS = (129, 512)
WIDE_D = 65_536
# the network kernels: at 128 rows some launch, above 128 none may
NETWORK_KEYS = ("sorted_reduce:median", "sorted_reduce:trimmed", "gram", "meamed",
                "selection_weights:krum", "selection_weights:cge", "selection_weights:monna",
                "weighted_rows", "nnm_weights", "mix_rows", "nnm_selection_weights:krum",
                "clip_selection_weights:clip", "clip_selection_weights:arc",
                "center_loop:weiszfeld", "center_loop:clip", "sort_columns")
# the card's result against the CPU's: "exact" where both take the same
# sort keys, ranks and row chains (B11 and row_sq_dists bit for bit their
# plain versions); "gram" where a torch.matmul Gram (cuBLAS against the
# CPU's BLAS) or a torch.sum norm re-associates; "loop" for the iterative
# aggregators, their distances summed in another order each step
WIDE_RTOL = {"exact": 0.0, "gram": 1e-5, "loop": 1e-4}
WIDE_ATOL = {"exact": 0.0, "gram": 1e-5, "loop": 1e-4}
# ByzPy's rows phase 4f's (c) does not run (BASELINE.md, benchmarks/README.md:12-29)
BYZPY_POOL_MORE = {
    "mda_30x2048_f10": (353.0, 218.0, 184.0, 166.0),
    "smea_16x4096_f5": (82.0, 71.6, 48.3, 48.0),
    "arc_256x65536_f8": (20.77, 50.87, 51.38, 95.90),
    "caf_64x65536_f8": (54.51, 58.03, 54.94, 62.21),
    "ps_multi_krum_10h_3b_50_rounds": (71.0, 54.0, 43.0, 42.0),
    "gaussian_64x65536": (12.6, 13.5, 13.3, 12.3),
    "nnm_196x4096_f32": (12.0, 142.0, 163.0, 137.0),
    "bucketing_512x16384_b32": (13.4, 21.7, 24.2, 23.4),
    "clipping_256x65536_tau2": (46.0, 61.0, 78.0, 81.0),
}
# every await of phase 4i is bounded by this
PROCESS_WAIT_S = 420
# (d) process_mnist's configuration: 3 nodes, 10 rounds, batch 64, lr 0.1
PMNIST_NODES, PMNIST_ROUNDS, PMNIST_BATCH, PMNIST_LR = 3, 10, 64, 0.1
# (e) remote_tcp's manifest (examples/ps/remote_tcp/nodes.yaml), built in code
REMOTE_MANIFEST = [("honest-0", "honest", 0), ("honest-1", "honest", 1), ("honest-2", "honest", 2),
                   ("honest-3", "honest", 0), ("byz-0", "byzantine", 1)]
REMOTE_ROUNDS = 5
REMOTE_KEY = "chip-smoke-remote-secret"

try:  # phase 4i's node classes subclass the port's ABCs; a child process imports them from here
    from byzpy_tpu_torch.engine.node.base import ByzantineNode as _ByzantineNode
    from byzpy_tpu_torch.engine.node.base import HonestNode as _HonestNode
except ImportError:  # no port beside this script: main() stops before phase 4i
    _HonestNode = _ByzantineNode = object


def wide_families():
    """(a)'s families above 128 rows: name -> (function, tolerance rule)."""
    from byzpy_tpu_torch.ops import preagg, robust

    P = functools.partial
    return {
        "median": (robust.coordinate_median, "exact"),
        "trimmed_f20": (P(robust.trimmed_mean, f=20), "exact"),
        "meamed_f20": (P(robust.mean_of_medians, f=20), "exact"),
        "cge_f20": (P(robust.cge, f=20), "exact"),
        "monna_f20": (P(robust.monna, f=20), "exact"),
        "multi_krum_f20_q40": (P(robust.multi_krum, f=20, q=40), "gram"),
        "clipped_multi_krum": (P(robust.clipped_multi_krum, tau=250.0, f=20, q=40), "gram"),
        "arc_multi_krum": (P(robust.arc_multi_krum, f_arc=20, f=20, q=40), "gram"),
        "nnm_f20": (P(preagg.nnm, f=20), "gram"),
        "nnm_multi_krum": (P(robust.nnm_multi_krum, f_nnm=20, f=20, q=40), "gram"),
        "geometric_median_it8": (P(robust.geometric_median, max_iter=8), "loop"),
        "centered_clipping_M3": (P(robust.centered_clipping, c_tau=250.0, M=3), "loop"),
    }


def wide_rows(n: int, seed: int):
    """``(n, 65,536)`` f32 on the card, every tenth row x4 (norms ~256 and
    ~1,024), so the selections and clips have rows to drop."""
    x = random_rounds((1, n, WIDE_D), seed=seed)[0]
    x[::10] *= 4.0
    return x


def wide_direct(counts: dict) -> dict:
    """(a) every family at 128 rows (the networks launch) and at 129 and 512
    (none launches), each against the same call on the CPU;
    the masked programs at a 512-row bucket; a captured step above 128
    rows for each family (a CUDA graph, or a GraphCaptureError that names
    the cause); the ragged executor at a capacity of 256 with a 200-row
    slot."""
    import torch

    from byzpy_tpu_torch.ops import kernels, robust
    from byzpy_tpu_torch.utils.cuda_graph import CapturedStep, GraphCaptureError

    out = {}
    for name, (fn, rule) in wide_families().items():
        row = {"rule": rule}
        for n in (128,) + WIDE_ROWS:
            x = wide_rows(n, seed=600 + n)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            got = fn(x)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launched = {k: v for k, v in kernels.launch_counts.items() if v}
            nets = {k: v for k, v in launched.items() if k in NETWORK_KEYS}
            if n <= kernels.MAX_NETWORK_ROWS:
                check(bool(nets), f"(a) {name} at {n} rows launched no network kernel: {launched}")
            else:
                check(not nets, f"(a) {name} at {n} rows launched network kernels {nets}")
            for k, v in launched.items():
                if k in counts:
                    counts[k] += v
            ref = fn(x.cpu())
            err = max_abs_err(got.cpu(), ref)
            if n <= kernels.MAX_NETWORK_ROWS:
                ok = bool(torch.allclose(got.cpu(), ref, rtol=1e-4, atol=1e-4, equal_nan=True))
            elif rule == "exact":
                ok = bits_equal(got.cpu(), ref)
            else:
                ok = bool(torch.allclose(got.cpu(), ref, rtol=WIDE_RTOL[rule],
                                         atol=WIDE_ATOL[rule] * float(ref.abs().max()),
                                         equal_nan=True))
            check(ok and bool(torch.isfinite(got).all()),
                  f"(a) {name} at {n} rows: the card is {err} off the CPU ({rule})")
            row[str(n)] = {"host_ms": ms, "max_abs_err": err, "launches": launched}
            del x
        out[name] = row
        log(f"  (a) {name}: " + ", ".join(
            f"{n} rows {row[str(n)]['host_ms']:.3f} ms (err {row[str(n)]['max_abs_err']:.3g})"
            for n in (128,) + WIDE_ROWS) + f"; held {rule} against the CPU")
    # the masked programs at a bucket of 512 rows holding 400
    x = wide_rows(512, seed=690)
    valid = torch.zeros(512, dtype=torch.bool, device="cuda")
    valid[torch.randperm(512, generator=torch.Generator().manual_seed(3))[:400].cuda()] = True
    x[~valid] = 0.0
    masked = {"masked_trimmed_f10": (functools.partial(robust.masked_trimmed_mean, f=10), "exact"),
              "masked_median": (robust.masked_coordinate_median, "exact"),
              "masked_multi_krum": (functools.partial(robust.masked_multi_krum, f=10, q=30), "gram"),
              "masked_geometric_median_it8": (functools.partial(robust.masked_geometric_median,
                                                                max_iter=8), "loop")}
    for name, (fn, rule) in masked.items():
        kernels.reset_launch_counts()
        got = fn(x, valid)
        torch.cuda.synchronize()
        nets = {k: v for k, v in kernels.launch_counts.items() if v and k in NETWORK_KEYS}
        check(not nets, f"(a) {name} at a 512-row bucket launched {nets}")
        ref = fn(x.cpu(), valid.cpu())
        ok = bits_equal(got.cpu(), ref) if rule == "exact" else bool(torch.allclose(
            got.cpu(), ref, rtol=WIDE_RTOL[rule], atol=WIDE_ATOL[rule] * float(ref.abs().max())))
        check(ok, f"(a) {name}: the card is {max_abs_err(got.cpu(), ref)} off the CPU ({rule})")
        out[name] = {"rule": rule, "max_abs_err": max_abs_err(got.cpu(), ref)}
    log(f"  (a) masked programs at a 512-row bucket of 400: "
        + ", ".join(f"{k} err {out[k]['max_abs_err']:.3g}" for k in masked))
    # a captured step above 128 rows: a CUDA graph replayed bit for bit, or
    # a GraphCaptureError that names the cause
    x = wide_rows(196, seed=691)
    captures = {}
    for name, (fn, _) in wide_families().items():
        step = CapturedStep(lambda s, m, fn=fn: (s, {"agg": fn(m)}), name="ps_train_step",
                            donate=False, state_args=1)
        try:
            first = step(torch.zeros(1, device="cuda"), x)[1]["agg"]
            again = step(torch.zeros(1, device="cuda"), x)[1]["agg"]
            torch.cuda.synchronize()
            check(bits_equal(first, again) and bits_equal(first, fn(x)),
                  f"(a) {name}'s captured step differs from the eager call at 196 rows")
            captures[name] = "captured"
        except GraphCaptureError as exc:
            check("host" in str(exc), f"(a) {name}'s refusal does not name a host read: {exc}")
            captures[name] = f"refused: {exc}"
    check(captures["geometric_median_it8"].startswith("refused"),
          "(a) the geometric median above 128 rows captured (it reads its stop on the host)")
    out["captured_step_196"] = captures
    log("  (a) captured steps at 196 rows: " + json.dumps(
        {k: v.split(":")[0] for k, v in captures.items()}))
    out["ragged_executor_256"] = wide_ragged(counts)
    del x
    torch.cuda.empty_cache()
    return out


def wide_ragged(counts: dict) -> dict:
    """The ragged executor at a capacity of 256: cohorts of 100 and 128
    rows run one segmented sort-reduce over the whole batch (R = 256);
    cohorts of 200 and 40 take the torch segmented program (a slot the
    network cannot hold). Each equals the CPU's masked door, never NaN."""
    import torch

    from byzpy_tpu_torch.aggregators import CoordinateWiseMedian, CoordinateWiseTrimmedMean
    from byzpy_tpu_torch.ops import kernels
    from byzpy_tpu_torch.serving import RaggedExecutor
    from byzpy_tpu_torch.serving.cohort import StalenessPolicy, build_cohort
    from byzpy_tpu_torch.serving.queue import Submission

    out = {}
    gen = torch.Generator().manual_seed(7)
    for label, make in (("median", lambda dev: CoordinateWiseMedian(device=dev)),
                        ("trimmed_f3", lambda dev: CoordinateWiseTrimmedMean(3, device=dev))):
        for sizes in ((100, 128), (200, 40)):
            rows = [torch.randn((m, WIDE_D), generator=gen) for m in sizes]
            views = {}
            for dev in ("cuda", "cpu"):
                ex = RaggedExecutor(make(dev), WIDE_D, 256, 2, with_evidence=False)
                cohorts = [build_cohort([Submission(f"c{i}", 0, r.to(dev), float(i))
                                         for i, r in enumerate(rs)], 0, None, StalenessPolicy(),
                                        device=dev) for rs in rows]
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                views[dev] = [v.vector.cpu() for v in ex.aggregate(cohorts, ["t", "t"])]
                ms = (time.perf_counter() - t0) * 1e3
                if dev == "cuda":
                    seg = kernels.launch_counts["segmented_sort_reduce"]
                    want = 1 if max(sizes) <= 128 else 0
                    check(seg == want, f"(a) ragged {label} {sizes}: {seg} segmented launches, "
                          f"not {want}")
                    counts["segmented_sort_reduce"] += seg
                    out[f"{label}_{sizes[0]}_{sizes[1]}_host_ms"] = ms
            for a, b in zip(views["cuda"], views["cpu"]):
                check(bool(torch.isfinite(a).all()), f"(a) ragged {label} {sizes}: NaN in a slot")
                check(bool(torch.allclose(a, b, rtol=1e-6, atol=1e-6)),
                      f"(a) ragged {label} {sizes}: {max_abs_err(a, b)} off the CPU")
    log(f"  (a) ragged executor, capacity 256: {json.dumps(out)}")
    return out


def process_pool_cases():
    """(b)'s workloads: phase 4f's ten at ByzPy's shapes and the nine it
    leaves out, name -> (operator, inputs, how the pooled result is held
    to the direct one)."""
    from byzpy_tpu_torch import aggregators as P
    from byzpy_tpu_torch import attacks as A
    from byzpy_tpu_torch import pre_aggregators as PRE

    def rows(n, d, seed):
        return list(random_rounds((1, n, d), seed=seed)[0])

    cases = pool_table_cases()
    cases.update({
        "mda_30x2048_f10": (P.MinimumDiameterAveraging(10), {"gradients": rows(30, 2048, 61)},
                            "bitwise"),
        "smea_16x4096_f5": (P.SMEA(5), {"gradients": rows(16, 4096, 62)}, "bitwise"),
        "arc_256x65536_f8": (PRE.ARC(8), {"vectors": rows(256, GRID[1], 63)}, "bitwise"),
        "caf_64x65536_f8": (P.CAF(8), {"gradients": rows(64, GRID[1], 64)}, "bitwise"),
        "gaussian_64x65536": (A.GaussianAttack(seed=5), {"honest_grads": rows(64, GRID[1], 65)},
                              "shape"),
        "nnm_196x4096_f32": (PRE.NearestNeighborMixing(32), {"vectors": rows(196, 4096, 66)},
                             "bitwise"),
        "bucketing_512x16384_b32": (PRE.Bucketing(32, perm=list(range(511, -1, -1))),
                                    {"vectors": rows(512, 16384, 67)}, "bitwise"),
        "clipping_256x65536_tau2": (PRE.Clipping(2.0), {"vectors": rows(256, GRID[1], 68)},
                                    "bitwise"),
    })
    return cases


def held(rule: str, res, direct) -> tuple:
    """``(ok, max |diff|)`` of a pooled result against the direct one."""
    import torch

    if isinstance(res, (list, tuple)):
        pairs = list(zip(res, direct))
        if len(res) != len(direct):
            return False, float("inf")
        oks = [held(rule, a, b) for a, b in pairs]
        return all(o for o, _ in oks), max((e for _, e in oks), default=0.0)
    res, direct = res.cpu(), direct.cpu()
    err = max_abs_err(res, direct)
    if rule == "bitwise":
        return bits_equal(res, direct), err
    if rule == "shape":
        return res.shape == direct.shape and bool(torch.isfinite(res).all()), err
    rtol, atol = (LITTLE_RTOL, LITTLE_ATOL) if rule == "little" else (LOOP_RTOL, LOOP_ATOL)
    return bool(torch.allclose(res, direct, rtol=rtol, atol=atol)), err


class PsNode:
    """(b)'s PS row: an honest node sending its fixed gradient plus a round
    term (``d`` = 65,536), in the parent process."""

    def __init__(self, i: int) -> None:
        import torch

        self.g = torch.randn(GRID[1], generator=torch.Generator().manual_seed(i)).cuda()
        self.r = 0

    def honest_gradient_for_next_batch(self):
        self.r += 1
        return [self.g * (1.0 + 0.01 * self.r)]

    def apply_server_gradient(self, g) -> None:
        pass


class PsFlip:
    """(b)'s byzantine node: -3 x the honest mean."""

    def byzantine_gradient_for_next_batch(self, honest):
        return [-3.0 * sum(h[0] for h in honest) / len(honest)]

    def apply_server_gradient(self, g) -> None:
        pass


async def process_pool_table(counts: dict, pools: dict) -> dict:
    """(b) ByzPy's whole pool table on ``process`` pools of 2 and 4 (one
    pool of each, started once and warmed by one median call; each child
    on the card): every row at ByzPy's shapes, host ms of one call beside
    ByzPy's; each pooled result held to the direct call."""
    import torch

    from byzpy_tpu_torch.aggregators import CoordinateWiseMedian, MultiKrum
    from byzpy_tpu_torch.engine.graph import run_operator
    from byzpy_tpu_torch.engine.parameter_server import ParameterServer

    table = {**BYZPY_POOL, **BYZPY_POOL_MORE}
    cases = process_pool_cases()
    out = {}
    t0 = time.perf_counter()
    warm = {"gradients": list(random_rounds((1, 8, 4096), seed=60)[0])}
    await asyncio.gather(*(run_operator(CoordinateWiseMedian(), warm, pool=p)
                           for p in pools.values()))
    out["pools_warm_s"] = time.perf_counter() - t0
    for name, (op, inputs, rule) in cases.items():
        reps = 1
        direct_ms, direct = await host_ms(lambda: run_operator(op, inputs), reps)
        row = {"direct_ms": direct_ms, "byzpy_direct_ms": table[name][0], "rule": rule}
        for k in PROCESS_POOLS:
            ms, res = await host_ms(lambda: run_operator(op, inputs, pool=pools[k]), reps)
            ok, err = held(rule, res, direct)
            check(ok, f"(b) {name}: the process pool of {k} is {err} off the direct call "
                  f"({rule})")
            row[f"pool{k}_ms"] = ms
            row[f"byzpy_pool{k}_ms"] = table[name][ENGINE_POOLS.index(k) + 1]
            row[f"pool{k}_max_abs_err"] = err
        out[name] = row
        log(f"  (b) {name}: host ms direct {direct_ms:.3f} (ByzPy {table[name][0]}), "
            + ", ".join(f"process x{k} {row[f'pool{k}_ms']:.3f} (ByzPy "
                        f"{row[f'byzpy_pool{k}_ms']})" for k in PROCESS_POOLS) + f"; held {rule}")
    # ByzPy's PS row: 10 honest + 3 byzantine nodes, Multi-Krum, 50 rounds
    name = "ps_multi_krum_10h_3b_50_rounds"
    row = {"byzpy_direct_ms": table[name][0]}
    finals = {}
    for k in (None,) + PROCESS_POOLS:
        ps = ParameterServer([PsNode(i) for i in range(10)], [PsFlip() for _ in range(3)],
                             aggregator=MultiKrum(3, 4),
                             pool=None if k is None else pools[k])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(50):
            agg = await ps.round()
        torch.cuda.synchronize()
        key = "direct_ms" if k is None else f"pool{k}_ms"
        row[key] = (time.perf_counter() - t1) * 1e3
        finals[k] = agg[0].cpu()
        if k is not None:
            row[f"byzpy_pool{k}_ms"] = table[name][ENGINE_POOLS.index(k) + 1]
            check(bits_equal(finals[k], finals[None]),
                  f"(b) {name}: the process pool of {k}'s last aggregate differs")
    out[name] = row
    log(f"  (b) {name}: host ms for 50 rounds direct {row['direct_ms']:.3f} (ByzPy "
        f"{table[name][0]}), " + ", ".join(f"process x{k} {row[f'pool{k}_ms']:.3f}"
                                           for k in PROCESS_POOLS))
    del cases
    torch.cuda.empty_cache()
    return out


async def process_configs(counts: dict, pools: dict) -> dict:
    """(c) BASELINE config #1 (the median of 10 x 100,000 under
    NodeScheduler) and config #2 (Multi-Krum f = 8, q = 12 on 64 x
    1,048,576) on (b)'s process pool of 4, one timed call each, bit for bit
    the direct call."""
    import torch

    from byzpy_tpu_torch.aggregators import CoordinateWiseMedian, MultiKrum
    from byzpy_tpu_torch.engine.graph import NodeScheduler, make_single_operator_graph

    out = {}
    x1 = list(random_rounds((1, 10, 100_000), seed=41)[0])
    x2 = random_rounds((1,) + HEADLINE, seed=42)[0]
    pool = pools[4]
    for label, agg, inputs in (("config1", CoordinateWiseMedian(), x1),
                               ("config2", MultiKrum(8, 12), x2)):
        graph = make_single_operator_graph(agg)
        direct = agg.aggregate(inputs)
        sched = NodeScheduler(graph, pool=pool)
        ms, res = await host_ms(lambda: sched.run({"gradients": inputs}), 1)
        check(bits_equal(res["op"].cpu(), direct.cpu()),
              f"(c) {label} on a process pool of 4 differs from the direct call "
              f"({max_abs_err(res['op'].cpu(), direct.cpu())})")
        dms, _ = await host_ms(lambda: NodeScheduler(graph).run({"gradients": inputs}), 1)
        out[label] = {"direct_ms": dms, "process_pool4_ms": ms}
    log(f"  (c) configs #1 and #2 on a process pool of 4: {json.dumps(out)}")
    del x1, x2
    torch.cuda.empty_cache()
    return out


class CardMnistNode(_HonestNode):
    """(d) and (e)'s honest node, the examples' ``MnistNode`` on the port:
    ``mnist_mlp`` on the card, its shard, a seeded torch generator for the
    batches, SGD at lr 0.1."""

    def __init__(self, shard_x, shard_y, seed: int) -> None:
        import torch

        from byzpy_tpu_torch.models import nets

        self.bundle = nets.mnist_mlp(seed=0, device="cuda")
        self.x, self.y = shard_x.cuda(), shard_y.cuda()
        self.gen = torch.Generator(device="cuda").manual_seed(seed)
        self._grad = torch.func.grad(self.bundle.loss_fn)

    def next_batch(self):
        from byzpy_tpu_torch.models.data import sample_batch

        return sample_batch(self.x, self.y, self.gen, PMNIST_BATCH)

    def honest_gradient(self, x, y):
        return self._grad(self.bundle.params, x, y)

    def apply_server_gradient(self, gradient) -> None:
        self.bundle.params = {k: p - PMNIST_LR * gradient[k].to(p.device)
                              for k, p in self.bundle.params.items()}

    def accuracy(self, x, y) -> float:
        import torch

        logits = self.bundle.apply(self.bundle.params, x.cuda())
        return float(torch.mean((torch.argmax(logits, -1) == y.cuda()).float()))


class CardEmpireNode(_ByzantineNode):
    """(e)'s byzantine node: the negated honest mean."""

    def next_batch(self):
        return None, None

    def byzantine_gradient(self, honest):
        return {k: -1.0 * sum(g[k].cuda() for g in honest) / len(honest) for k in honest[0]}

    def apply_server_gradient(self, gradient) -> None:
        pass


async def mnist_rounds(backend: str, rounds: int, n_nodes: int, spawn_kw=None) -> tuple:
    """``(aggregates, ms a round, accuracy)`` of process_mnist's run on
    ``backend`` actors: median, synthetic data sharded over the nodes."""
    import torch

    from byzpy_tpu_torch.aggregators import CoordinateWiseMedian
    from byzpy_tpu_torch.engine.node.actors import HonestNodeActor
    from byzpy_tpu_torch.engine.parameter_server import ParameterServer
    from byzpy_tpu_torch.models.data import ShardedDataset, synthetic_classification

    x, y = synthetic_classification(n_samples=1024, seed=0, device="cpu")
    data = ShardedDataset(x, y, n_nodes)
    actors = await asyncio.gather(*(HonestNodeActor.spawn(CardMnistNode, *data.node_slice(i), i,
                                                          backend=backend)
                                    for i in range(n_nodes)))
    try:
        ps = ParameterServer(actors, aggregator=CoordinateWiseMedian())
        aggs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            aggs.append({k: v.cpu() for k, v in (await ps.round()).items()})
        ms = (time.perf_counter() - t0) * 1e3 / rounds
        acc = await actors[0].accuracy(x, y)
        return aggs, ms, acc
    finally:
        for a in actors:
            await a.close()


async def process_mnist(counts: dict) -> dict:
    """(d) examples/ps/process_mnist.py's configuration on the card: 3
    process-actor nodes (mnist_mlp, synthetic shards), the coordinate
    median, 10 rounds; every aggregate equals the thread actors' bit for
    bit."""
    proc, pms, pacc = await mnist_rounds("process", PMNIST_ROUNDS, PMNIST_NODES)
    thread, tms, tacc = await mnist_rounds("thread", PMNIST_ROUNDS, PMNIST_NODES)
    for r, (a, b) in enumerate(zip(proc, thread)):
        check(all(bits_equal(a[k], b[k]) for k in b),
              f"(d) round {r + 1}: the process nodes' aggregate differs from the thread nodes'")
    out = {"process_ms_per_round": pms, "thread_ms_per_round": tms, "accuracy": pacc}
    check(pacc == tacc, f"(d) accuracy {pacc} on process nodes, {tacc} on thread nodes")
    log(f"  (d) process_mnist: {PMNIST_NODES} process nodes x {PMNIST_ROUNDS} rounds bit for bit "
        f"the thread nodes; host ms a round {pms:.3f} (thread {tms:.3f}); accuracy {pacc:.3f}")
    return out


async def remote_tcp(counts: dict) -> dict:
    """(e) examples/ps/remote_tcp/'s configuration: three loopback
    RemoteActorServers behind a wire key host the manifest's four honest
    nodes and one Empire node (two actors on one server), trimmed mean
    (f = 1), 5 rounds; the aggregates equal the same nodes on thread
    actors bit for bit; a frame under another key is refused."""
    import torch

    from byzpy_tpu_torch.aggregators import CoordinateWiseTrimmedMean
    from byzpy_tpu_torch.engine.actor import wire
    from byzpy_tpu_torch.engine.actor.backends.remote import RemoteActorServer
    from byzpy_tpu_torch.engine.node.actors import ByzantineNodeActor, HonestNodeActor
    from byzpy_tpu_torch.engine.parameter_server import ParameterServer
    from byzpy_tpu_torch.models.data import ShardedDataset, synthetic_classification

    os.environ["BYZPY_TPU_TORCH_WIRE_KEY"] = REMOTE_KEY
    servers = [RemoteActorServer("127.0.0.1", 0) for _ in range(3)]
    out = {}
    try:
        for s in servers:
            await s.start()
        x, y = synthetic_classification(n_samples=1024, seed=1, device="cpu")
        honest = [e for e in REMOTE_MANIFEST if e[1] == "honest"]
        data = ShardedDataset(x, y, len(honest))
        runs = {}
        for mode in ("tcp", "thread"):
            actors = []
            byz = []
            try:
                for i, (name, role, srv) in enumerate(REMOTE_MANIFEST):
                    backend = (f"tcp://127.0.0.1:{servers[srv].port}" if mode == "tcp"
                               else "thread")
                    if role == "honest":
                        actors.append(await HonestNodeActor.spawn(
                            CardMnistNode, *data.node_slice(i), i, backend=backend))
                    else:
                        byz.append(await ByzantineNodeActor.spawn(CardEmpireNode, backend=backend))
                ps = ParameterServer(actors, byz, aggregator=CoordinateWiseTrimmedMean(1))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[mode] = [{k: v.cpu() for k, v in (await ps.round()).items()}
                              for _ in range(REMOTE_ROUNDS)]
                out[f"{mode}_ms_per_round"] = (time.perf_counter() - t0) * 1e3 / REMOTE_ROUNDS
            finally:
                for a in actors + byz:
                    await a.close()
        for r, (a, b) in enumerate(zip(runs["tcp"], runs["thread"])):
            check(all(bits_equal(a[k], b[k]) for k in b),
                  f"(e) round {r + 1}: the remote nodes' aggregate differs from the thread nodes'")
        # a frame signed under another key: the server drops the peer
        os.environ["BYZPY_TPU_TORCH_WIRE_KEY"] = "another-key"
        forged = wire.encode({"op": "construct", "actor_id": "forged", "req_id": 0,
                              "payload": (CardEmpireNode, (), {})})
        os.environ["BYZPY_TPU_TORCH_WIRE_KEY"] = REMOTE_KEY
        reader, writer = await asyncio.open_connection("127.0.0.1", servers[0].port)
        writer.write(forged)
        await writer.drain()
        answer = await asyncio.wait_for(reader.read(), 30)
        writer.close()
        check(answer == b"" and "forged" not in servers[0]._actors,
              "(e) a frame under another key was not refused")
        out["wrong_key"] = "refused: connection dropped, no reply"
    finally:
        for s in servers:
            await s.close()
        os.environ.pop("BYZPY_TPU_TORCH_WIRE_KEY", None)
    log(f"  (e) remote_tcp: 3 loopback servers, 4 honest + 1 Empire, {REMOTE_ROUNDS} rounds bit "
        f"for bit the thread nodes; host ms a round tcp {out['tcp_ms_per_round']:.3f} (thread "
        f"{out['thread_ms_per_round']:.3f}); wrong key refused")
    return out


class P2pBatches:
    """(f)'s picklable batch source: node ``i``'s fixed batches on the card."""

    def __init__(self, node: int) -> None:
        self.node, self.step = node, 0

    def __call__(self):
        import torch

        gen = torch.Generator().manual_seed(1000 * self.node + self.step)
        self.step += 1
        x = torch.randn((32, 28, 28, 1), generator=gen)
        y = torch.randint(0, 10, (32,), generator=gen)
        return x.cuda(), y.cuda()


async def p2p_rounds(context_factory, rounds: int = 2) -> tuple:
    import torch

    from byzpy_tpu_torch.aggregators import CoordinateWiseTrimmedMean
    from byzpy_tpu_torch.engine.peer_to_peer import Topology
    from byzpy_tpu_torch.engine.peer_to_peer.nodes import SGDModelWorker
    from byzpy_tpu_torch.engine.peer_to_peer.runner import DecentralizedPeerToPeer
    from byzpy_tpu_torch.models import nets

    workers = [SGDModelWorker(nets.mnist_mlp(seed=0, device="cuda"), P2pBatches(i))
               for i in range(3)]
    p2p = DecentralizedPeerToPeer(workers, [], aggregator=CoordinateWiseTrimmedMean(0),
                                  topology=Topology.complete(3), learning_rate=0.1,
                                  context_factory=context_factory)
    outs = []
    async with p2p:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            outs.append({i: torch.as_tensor(v).cpu() for i, v in
                         (await p2p.run_round_async()).items()})
        ms = (time.perf_counter() - t0) * 1e3 / rounds
    return outs, ms


async def p2p_process_context(counts: dict) -> dict:
    """(f) the P2P runner on ProcessContext nodes (children on the card):
    3 honest mnist_mlp SGD workers on complete(3), trimmed mean (f = 0), 2
    rounds, each node's aggregate bit for bit the InProcessContext run's."""
    from byzpy_tpu_torch.engine.node import InProcessContext, ProcessContext

    proc, pms = await p2p_rounds(ProcessContext)
    ProcessContext.clear_registry()
    local, lms = await p2p_rounds(InProcessContext)
    InProcessContext.clear_registry()
    for r, (a, b) in enumerate(zip(proc, local)):
        check(sorted(a) == sorted(b) and all(bits_equal(a[i], b[i]) for i in b),
              f"(f) round {r + 1}: ProcessContext differs from InProcessContext")
    log(f"  (f) P2P on ProcessContext: 3 nodes x 2 rounds bit for bit InProcessContext; host ms "
        f"a round {pms:.3f} (in process {lms:.3f})")
    return {"process_ms_per_round": pms, "in_process_ms_per_round": lms}


def wide_process_path(counts: dict) -> dict:
    """Phase 4i: (a) above 128 rows, (b)-(f) the out-of-process tier, every
    await bounded."""
    from byzpy_tpu_torch.engine.storage import native_store

    check(native_store.available(), "(b) the shm store's C library did not build on this host")
    out = {"a_rows_above_128": wide_direct(counts)}

    async def tier():
        from byzpy_tpu_torch.engine.graph import ActorPool, ActorPoolConfig

        res = {}
        t0 = time.perf_counter()
        pools = {k: ActorPool(ActorPoolConfig(backend="process", count=k)) for k in PROCESS_POOLS}
        try:
            await asyncio.gather(*(p.start() for p in pools.values()))
            res["pools_start_s"] = time.perf_counter() - t0
            log(f"  (b) process pools of {PROCESS_POOLS} started in {res['pools_start_s']:.1f} s "
                f"({sum(PROCESS_POOLS)} children on the card)")
            for key, fn in (("b_process_pool_table", process_pool_table),
                            ("c_configs_1_2_process_pool4", process_configs)):
                t0 = time.perf_counter()
                res[key] = await fn(counts, pools)
                res[key]["phase_s"] = time.perf_counter() - t0
        finally:
            await asyncio.gather(*(p.close() for p in pools.values()), return_exceptions=True)
        for key, fn in (("d_process_mnist", process_mnist), ("e_remote_tcp", remote_tcp),
                        ("f_p2p_process_context", p2p_process_context)):
            t0 = time.perf_counter()
            res[key] = await fn(counts)
            res[key]["phase_s"] = time.perf_counter() - t0
        return res

    out.update(asyncio.run(asyncio.wait_for(tier(), PROCESS_WAIT_S)))
    return out


# ---------------------------------------------------------------------------
# phase 4j: the rest of the engine (the legacy runtime, MeshRemoteContext,
# the CLI) and the device mesh (the mesh PS round on one NCCL rank)
# ---------------------------------------------------------------------------

LEGACY_NODES, LEGACY_ROUNDS, LEGACY_BATCH, LEGACY_LR = 3, 5, 64, 0.1
MESH_TCP_NODES = 3
MESH_NODES, MESH_BYZ, MESH_BATCH, MESH_STEPS = 8, 2, 32, 5
# the mesh round's static clip: ResNet-18's per-node gradient norms at step
# 1 (CIFAR shapes, random labels) are read from this run and printed; the
# threshold is their median, so some rows clip and some do not
MESH_WAIT_S = 600
# the kernels each (d) configuration's aggregation launches on the rank's
# columns, every step
MESH_KERNELS = {
    "trimmed": ("sorted_reduce:trimmed",),
    "multi_krum": ("gram", "selection_mean_from_gram:krum"),
    "geomed": ("sorted_reduce:median", "row_sq_dists", "segment_sum"),
    "clip+trimmed": ("row_sq_dists", "sorted_reduce:trimmed"),
}
CLI_TIMEOUT_S = 240


class LegacyCnnNode:
    """(a)'s step-protocol node: SmallCNN on the card, its own synthetic
    batches, ``step()`` the flat gradient of the next batch,
    ``apply_update(u)`` SGD at ``LEGACY_LR``. cuDNN's deterministic
    algorithms, so a child and the parent compute the same bits."""

    def __init__(self, seed: int) -> None:
        import torch

        from byzpy_tpu_torch.models import nets, synthetic_classification

        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.bundle = nets.mnist_cnn(seed=0, device="cuda")
        self.x, self.y = synthetic_classification(n_samples=LEGACY_BATCH * LEGACY_ROUNDS,
                                                  seed=100 + seed, device="cuda")
        self._grad = torch.func.grad(self.bundle.loss_fn)
        self.rounds = 0

    def step(self, payload=None):
        import torch

        sl = slice(self.rounds * LEGACY_BATCH, (self.rounds + 1) * LEGACY_BATCH)
        self.rounds += 1
        g = self._grad(self.bundle.params, self.x[sl], self.y[sl])
        return torch.cat([v.reshape(-1) for v in g.values()])

    def apply_update(self, update) -> None:
        flat = update.to("cuda")
        out, at = {}, 0
        for k, p in self.bundle.params.items():
            out[k] = p - LEGACY_LR * flat[at:at + p.numel()].reshape(p.shape)
            at += p.numel()
        self.bundle.params = out

    def flat_params(self):
        import torch

        return torch.cat([v.reshape(-1) for v in self.bundle.params.values()]).cpu()


def legacy_runtime(counts: dict, smi: str) -> dict:
    """(a) three ``NodeRunner`` children on the card step SmallCNN workers;
    ``StepParameterServer`` with the port's trimmed mean (f = 1) for 5
    rounds; every update and every node's weights equal the same rounds
    computed in process bit for bit; a ``TcpMailbox`` loopback round trip
    carries a tensor."""
    import torch

    from byzpy_tpu_torch.engine.legacy import NodeCluster, NodeRunner, StepParameterServer, TcpMailbox
    from byzpy_tpu_torch.ops import kernels, robust

    def aggregate(grads):
        return robust.trimmed_mean(torch.stack([g.to("cuda") for g in grads]), f=1)

    in_process = [LegacyCnnNode(i) for i in range(LEGACY_NODES)]
    want = []
    for _ in range(LEGACY_ROUNDS):
        update = aggregate([node.step() for node in in_process])
        for node in in_process:
            node.apply_update(update)
        want.append(update.cpu())
    cluster = NodeCluster()
    for i in range(LEGACY_NODES):
        cluster.add(f"n{i}", NodeRunner(functools.partial(LegacyCnnNode, i)))
    t0 = time.perf_counter()
    with cluster:
        # the first call of each child waits out its start (spawn, CUDA,
        # the model): out of the rounds' time
        for name in cluster.names:
            cluster.runner(name).call("flat_params")
        start_s = time.perf_counter() - t0
        check(all(cluster.runner(n).child_device == "cuda" for n in cluster.names),
              "(a) a runner's child is not on the card")
        ps = StepParameterServer(cluster, aggregate)
        kernels.reset_launch_counts()
        got, rounds_ms = [], []
        for _ in range(LEGACY_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got.append(ps.round().cpu())
            rounds_ms.append((time.perf_counter() - t0) * 1e3)
        round_ms = sum(rounds_ms) / LEGACY_ROUNDS
        run = {k: v for k, v in kernels.launch_counts.items() if v}
        weights = [cluster.runner(n).call("flat_params") for n in cluster.names]
    for r, (g, w) in enumerate(zip(got, want)):
        check(bits_equal(g, w), f"(a) round {r + 1}: the runners' update differs from the in-process one")
    for i, w in enumerate(weights):
        check(bits_equal(w, in_process[i].flat_params()), f"(a) node {i}'s weights differ")
    check(run == {"sorted_reduce:trimmed": LEGACY_ROUNDS},
          f"(a) launches {run}, not one B1 trimmed mean a round")
    for k, v in run.items():
        counts[k] += v
    a, b = TcpMailbox("a"), TcpMailbox("b")
    try:
        a.add_peer("b", (b.host, b.port))
        sent = want[-1]
        t0 = time.perf_counter()
        a.send("b", {"update": sent})
        sender, payload = b.recv(timeout=30)
        tcp_ms = (time.perf_counter() - t0) * 1e3
    finally:
        a.close()
        b.close()
    check(sender == "a" and bits_equal(payload["update"], sent), "(a) the TcpMailbox round trip")
    d = int(want[0].numel())
    log(f"  (a) legacy: {LEGACY_NODES} NodeRunner children on the card (up in {start_s:.1f} s), "
        f"StepParameterServer x {LEGACY_ROUNDS} rounds of SmallCNN (d = {d:,}) bit for bit the "
        f"in-process rounds; host ms a round {[round(t, 1) for t in rounds_ms]}; TcpMailbox round "
        f"trip of {d:,} f32 "
        f"{tcp_ms:.3f} host ms; launches {run}; {smi}")
    return {"d": d, "children_start_s": start_s, "host_ms_per_round": round_ms, "rounds_ms": rounds_ms,
            "tcp_mailbox_round_trip_ms": tcp_ms, "launches": run}


async def mesh_tcp_round(context_factory, vectors, node_ids) -> dict:
    """examples/p2p/mesh_tcp.py's shape: every node broadcasts its vector
    over the complete topology; each then aggregates its own and the
    received vectors (in sender order) with the trimmed mean (f = 1) on
    the card. Returns ``{node: aggregate}``, the contexts and the nodes."""
    import torch

    from byzpy_tpu_torch.engine.node import DecentralizedNode
    from byzpy_tpu_torch.engine.peer_to_peer import Topology
    from byzpy_tpu_torch.ops import robust

    n = len(node_ids)
    ctxs = [context_factory(nid) for nid in node_ids]
    received = {nid: {} for nid in node_ids}
    done = asyncio.Event()
    nodes = []
    for i, ctx in enumerate(ctxs):
        node = DecentralizedNode(node_ids[i], ctx)
        node.bind_topology(Topology.complete(n), dict(enumerate(node_ids)))

        async def keep(message, store=received[node_ids[i]]):
            store[message.sender] = message.payload
            if all(len(v) == n - 1 for v in received.values()):
                done.set()

        node.register_handler("gradient", keep)
        await node.start()
        nodes.append(node)
    if hasattr(ctxs[0], "add_peer"):
        book = {c.node_id: (c.host, c.port) for c in ctxs}
        for ctx in ctxs:
            for pid, addr in book.items():
                if pid != ctx.node_id:
                    ctx.add_peer(pid, addr)
    for node, vec in zip(nodes, vectors):
        await node.broadcast_message("gradient", vec)
    await asyncio.wait_for(done.wait(), 60)
    aggs = {}
    for nid, vec in zip(node_ids, vectors):
        rows = [vec] + [received[nid][s].to("cuda") for s in sorted(received[nid])]
        aggs[nid] = robust.trimmed_mean(torch.stack(rows), f=1)
    return aggs, ctxs, nodes


def mesh_remote_context(counts: dict, smi: str) -> dict:
    """(b) ``MeshRemoteContext`` at examples/p2p/mesh_tcp.py's shape on
    loopback: three nodes gossip SmallCNN-sized vectors, each aggregates
    with the trimmed mean on the card, bit for bit an ``InProcessContext``
    run; then one peer's outbound connections are killed and the reconnect
    monitor re-dials them, and a send over the re-dialled path arrives."""
    import torch

    from byzpy_tpu_torch.engine.node import InProcessContext, MeshRemoteContext
    from byzpy_tpu_torch.ops import kernels

    g = torch.Generator(device="cuda").manual_seed(7)
    vectors = [torch.randn(421_642, generator=g, device="cuda") for _ in range(MESH_TCP_NODES)]
    ids = [f"mesh-{i}" for i in range(MESH_TCP_NODES)]

    async def run():
        InProcessContext.clear_registry()
        ref, _, ref_nodes = await mesh_tcp_round(InProcessContext, vectors, ids)
        for node in ref_nodes:
            await node.shutdown()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got, ctxs, nodes = await mesh_tcp_round(
            lambda nid: MeshRemoteContext(nid, reconnect_interval=0.2), vectors, ids)
        torch.cuda.synchronize()
        round_ms = (time.perf_counter() - t0) * 1e3
        run_counts = {k: v for k, v in kernels.launch_counts.items() if v}
        try:
            for nid in ids:
                check(bits_equal(got[nid], ref[nid]),
                      f"(b) {nid}'s aggregate differs from the InProcessContext run")
            victim = ctxs[2]
            for _, writer, _lock in list(victim._out.values()):
                writer.close()
            victim._out.clear()
            t0 = time.perf_counter()
            for _ in range(300):
                if "mesh-0" in victim._out:
                    break
                await asyncio.sleep(0.02)
            redial_ms = (time.perf_counter() - t0) * 1e3
            check("mesh-0" in victim._out, "(b) the monitor did not re-dial mesh-0")
            arrived = asyncio.Event()
            nodes[0].register_handler("after", lambda message: arrived.set() or asyncio.sleep(0))
            await nodes[2].send_message("mesh-0", "after", vectors[2])
            await asyncio.wait_for(arrived.wait(), 30)
        finally:
            for node in nodes:
                await node.shutdown()
        check(all(not c._inbound_writers and c._server is None for c in ctxs),
              "(b) a shutdown left an inbound writer or its server open")
        return round_ms, redial_ms, run_counts

    round_ms, redial_ms, run_counts = asyncio.run(asyncio.wait_for(run(), MESH_WAIT_S))
    check(run_counts == {"sorted_reduce:trimmed": MESH_TCP_NODES},
          f"(b) launches {run_counts}, not one B1 trimmed mean a node")
    for k, v in run_counts.items():
        counts[k] += v
    log(f"  (b) MeshRemoteContext: {MESH_TCP_NODES} nodes gossip 421,642 f32 on loopback, the "
        f"aggregates bit for bit an InProcessContext run; round {round_ms:.3f} host ms; a killed "
        f"peer re-dialled by the monitor in {redial_ms:.1f} ms; {smi}")
    return {"host_ms_per_round": round_ms, "redial_ms": redial_ms, "launches": run_counts}


def cli_start(*args: str):
    """Start ``python -m byzpy_tpu_torch.cli ARGS`` from the checkout;
    :func:`cli_wait` collects it."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "byzpy_tpu_torch.cli", *args], cwd=HERE, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return args, proc, time.perf_counter()


def cli_wait(started) -> tuple:
    """(stdout, host seconds) of a command :func:`cli_start` started."""
    args, proc, t0 = started
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    s = time.perf_counter() - t0
    check(proc.returncode == 0, f"(c) cli {' '.join(args)} exited {proc.returncode}: {err[-2000:]}")
    return out, s


def cli_phase(smi: str) -> dict:
    """(c) the CLI on the card: ``doctor`` names the card and builds every
    source; ``bench`` times the four ops at 16 x 65,536 with CUDA events
    (an ``error`` row fails the phase); ``list`` and a short ``study``."""
    import torch

    from byzpy_tpu_torch.ops import _build

    # doctor, list and study run side by side (the study on the card); bench
    # runs alone after them, so its times are its own. The card's host has
    # no scikit-learn: the study runs on synthetic blobs of the digits' shape
    started = [cli_start("doctor", "--format", "json"), cli_start("list", "aggregators"),
               cli_start("study", "--rounds", "3", "--aggregator", "trimmed_mean", "--data",
                         "synthetic")]
    (out, doctor_s), (listing, _), (study_out, study_s) = [cli_wait(p) for p in started]
    report = json.loads(out)
    names = [dev["name"] for dev in report.get("devices", [])]
    check(names and names[0] == torch.cuda.get_device_name(0), f"(c) doctor's devices: {names}")
    check(report["kernels"]["ok"] and sorted(report["kernels"]["sources"]) == sorted(_build.SOURCES),
          f"(c) doctor's build: {report['kernels']}")
    check(report.get("nvidia_smi") and report["nvcc"].get("version"),
          f"(c) doctor's nvidia-smi or nvcc: {report.get('nvidia_smi')} {report['nvcc']}")
    out, bench_s = cli_wait(cli_start("bench"))
    bench = json.loads(out)
    ops = ("coordinate_median", "trimmed_mean", "multi_krum", "geometric_median")
    errors = {op: bench.get(op) for op in ops if "ms" not in bench.get(op, {})}
    check(not errors and "error" not in bench, f"(c) bench rows with an error: {errors} {bench.get('error')}")
    check(bench["clock"] == "cuda_events" and bench["shape"] == [16, 65_536],
          f"(c) bench: {bench}")
    listed = {"aggregators": len(listing.splitlines())}
    check(listed["aggregators"] >= 12, f"(c) list: {listing}")
    check("| aggregator | sign_flip |" in study_out and "trimmed_mean" in study_out,
          f"(c) study: {study_out[-500:]}")
    bench_ms = {op: bench[op]["ms"] for op in ops}
    log(f"  (c) cli: doctor {doctor_s:.1f} s ({names[0]}; {report['nvidia_smi']}; "
        f"{report['nvcc']['version']}; {len(report['kernels']['sources'])} sources built or found); "
        f"bench at 16 x 65,536 f32 (ms a call, CUDA events) {json.dumps(bench_ms)}; list "
        f"{listed}; study (3 rounds, mean vs trimmed mean under sign flip) {study_s:.1f} s; {smi}")
    return {"doctor_s": doctor_s, "bench_s": bench_s, "bench_ms": bench_ms, "listed": listed,
            "study_s": study_s, "device": names[0], "nvidia_smi": report["nvidia_smi"]}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_configs(tau: float) -> list:
    """(d)'s configurations: (name, aggregate, pre_aggregate, sharded
    update, comm precision, gather precision with error feedback)."""
    from byzpy_tpu_torch.ops import preagg, robust

    aggs = {
        "trimmed": (functools.partial(robust.trimmed_mean, f=MESH_BYZ), None),
        "multi_krum": (functools.partial(robust.multi_krum, f=MESH_BYZ, q=4), None),
        "geomed": (robust.geometric_median, None),
        "clip+trimmed": (functools.partial(robust.trimmed_mean, f=MESH_BYZ),
                         functools.partial(preagg.clip_rows, threshold=tau)),
    }
    out = []
    for name, (agg, pre) in aggs.items():
        grid = ([(su, c, g) for su in ("on", "off") for c in (None, "int8") for g in (None, "int8")]
                if name == "trimmed" else
                [("on", None, None), ("off", None, None), ("on", "int8", "int8")])
        for su, comm, gather in grid:
            if su == "off" and gather is not None:
                continue  # the replicated update gathers the exact aggregate
            out.append((name, agg, pre, su, comm, gather))
    return out


def mesh_round_path(counts: dict, smi: str) -> dict:
    """(d) the mesh PS round on one NCCL rank at full width: a ``nodes``
    mesh of 1 runs ResNet-18 for CIFAR (d = 11,173,962), 8 nodes (2
    sign-flipping) x 32 images, 5 steps, for the trimmed mean, Multi-Krum,
    the geometric median and static clip + trimmed mean, the sharded update
    on and off, the transpose and the params gather off and int8 (the
    gather with error feedback). With both precisions off the parameters
    equal the ``mesh=None`` round's bit for bit for the trimmed mean, and
    within f32 rounding otherwise; the traffic record equals
    ``comms.ps_round_wire_bytes``; each configuration's launches a step and
    peak memory are printed."""
    import torch
    import torch.distributed as dist
    from torch.func import grad, vmap

    from byzpy_tpu_torch.models import ShardedDataset, cifar_resnet18, synthetic_classification
    from byzpy_tpu_torch.ops import attack_ops, kernels
    from byzpy_tpu_torch.parallel import CommPrecision, PSStepConfig, ShardedUpdateConfig, build_ps_train_step
    from byzpy_tpu_torch.parallel import comms
    from byzpy_tpu_torch.parallel.mesh import init_process_group, node_mesh

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    check(init_process_group(f"tcp://127.0.0.1:{free_port()}", 1, 0, backend="nccl"),
          "(d) the NCCL process group was already initialized")
    try:
        mesh = node_mesh(device="cuda")
        x, y = synthetic_classification(n_samples=MESH_NODES * MESH_BATCH * MESH_STEPS,
                                        input_shape=(32, 32, 3), seed=0, device="cuda")
        xs_all, ys_all = ShardedDataset(x, y, n_nodes=MESH_NODES).stacked_shards()
        batches = [(xs_all[:, s * MESH_BATCH:(s + 1) * MESH_BATCH],
                    ys_all[:, s * MESH_BATCH:(s + 1) * MESH_BATCH]) for s in range(MESH_STEPS)]
        bundle0 = cifar_resnet18(seed=0, device="cuda")
        d = sum(int(v.numel()) for v in bundle0.params.values())
        check(d == 11_173_962, f"(d) ResNet-18 for CIFAR has d={d}")
        g1 = vmap(grad(bundle0.loss_fn), in_dims=(None, 0, 0))(bundle0.params, *batches[0])
        norms = torch.sqrt(sum(torch.sum(v.reshape(MESH_NODES, -1) ** 2, dim=1) for v in g1.values()))
        tau = float(torch.median(norms[:MESH_NODES - MESH_BYZ]))
        gmax = float(max(v.abs().max() for v in g1.values()))
        del g1
        cfg = PSStepConfig(n_nodes=MESH_NODES, n_byzantine=MESH_BYZ)

        def attack(honest, generator):
            return attack_ops.sign_flip(honest.mean(dim=0))

        def run(agg, pre, *, mesh_, su=None, comm=None, gather=None):
            bundle = cifar_resnet18(seed=0, device="cuda")
            kw = {}
            if mesh_ is not None:
                kw = dict(mesh=mesh_, comm_precision=comm, sharded_update=ShardedUpdateConfig(
                    su, param_gather_precision=None if gather is None else CommPrecision(
                        gather, error_feedback=True)))
            step, opt = build_ps_train_step(bundle, agg, cfg, attack=attack, pre_aggregate=pre, **kw)
            params = bundle.params
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            ms = []
            for xs, ys in batches:
                t0 = time.perf_counter()
                params, opt, metrics = step(params, opt, xs, ys)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            launches = {k: v for k, v in kernels.launch_counts.items() if v}
            flat = torch.cat([v.reshape(-1) for v in params.values()])
            record = None
            if mesh_ is not None:
                rec = comms.collective_traffic(step, params, opt, *batches[0])
                record = {"per_opcode_bytes": rec["per_opcode_bytes"],
                          "result_bytes": sorted({(op.opcode, op.dtype): op.result_bytes
                                                  for op in rec["ops"]}.items())}
                law = comms.ps_round_wire_bytes(d, 1, update_sharded=su == "on",
                                                grad_precision=comm or "off",
                                                param_precision=gather or "off")
                check(rec["wire_bytes_per_device"] == law == 0.0 and set(rec["per_opcode_bytes"])
                      >= {"all-to-all", "all-reduce"}, f"(d) the traffic record {record} against "
                      f"the law {law}")
            return flat, metrics, ms, launches, torch.cuda.max_memory_allocated(), record

        out = {"d": d, "clip_tau": tau, "configs": {}}
        refs = {}
        for name, agg, pre, su, comm, gather in mesh_configs(tau):
            if name not in refs:
                refs[name] = run(agg, pre, mesh_=None)
                rflat = refs[name][0]
                check(bool(torch.isfinite(rflat).all()), f"(d) {name}: mesh=None params not finite")
                log(f"  (d) {name}/mesh=None: host ms a step {[round(t, 1) for t in refs[name][2]]}, "
                    f"peak {refs[name][4] / 2**30:.2f} GiB, launches a step "
                    f"{ {k: v / MESH_STEPS for k, v in refs[name][3].items()} }; {smi}")
                out["configs"][f"{name}/mesh=None"] = {
                    "ms_per_step": refs[name][2], "peak_gib": refs[name][4] / 2**30,
                    "launches_per_step": {k: v / MESH_STEPS for k, v in refs[name][3].items()}}
            flat, metrics, ms, launches, peak, record = run(agg, pre, mesh_=mesh, su=su, comm=comm,
                                                            gather=gather)
            check(bool(torch.isfinite(flat).all()), f"(d) {name} {su} {comm} {gather}: not finite")
            diff = float((flat - refs[name][0]).abs().max())
            scale = float(refs[name][0].abs().max())
            if comm is None and gather is None:
                if name == "trimmed":
                    check(bits_equal(flat, refs[name][0]),
                          f"(d) {name} su={su}: the mesh round differs from mesh=None ({diff})")
                else:
                    # the forms sum over d in another order (row_sq_dists, the
                    # all-reduce) and 5 steps of training carry the last bits
                    # on; the sharded geometric median runs the B11 /
                    # row_sq_dists loop and mesh=None B7's, each stopping at
                    # tol = 1e-6 on its own sums, so they can end a step apart
                    rel = 1e-3 if name == "geomed" else 1e-4
                    check(diff <= rel * scale, f"(d) {name} su={su}: {diff} from mesh=None "
                          f"(|p| max {scale})")
            else:
                # one code step of the largest block a step, through SGD's
                # momentum (lr / (1 - momentum)), on the transpose and the gather
                bound = MESH_STEPS * (cfg.learning_rate / (1 - cfg.momentum) * gmax / 127
                                      + scale / 127)
                check(diff <= bound, f"(d) {name} {comm} {gather}: {diff} from the f32 round "
                      f"(bound {bound})")
            want = set(MESH_KERNELS[name])
            if comm is not None:
                want |= {"quantize:int8", "dequantize:int8"}
            if gather is not None:
                want |= {"quantize:int8", "dequantize:int8"}
            check(want <= set(launches) and all(launches[k] >= MESH_STEPS for k in want),
                  f"(d) {name} {su} {comm} {gather}: launches {launches}, want {sorted(want)} "
                  "every step")
            for k, v in launches.items():
                counts[k] += v
            key = f"{name}/su={su}/comm={comm or 'off'}/gather={gather or 'off'}"
            out["configs"][key] = {
                "ms_per_step": ms, "peak_gib": peak / 2**30, "max_abs_diff_to_mesh_none": diff,
                "agg_grad_norm": float(metrics["agg_grad_norm"]),
                "launches_per_step": {k: v / MESH_STEPS for k, v in launches.items()},
                "traffic": record}
            log(f"  (d) {key}: host ms a step {[round(t, 1) for t in ms]}, peak "
                f"{peak / 2**30:.2f} GiB, max |p - p(mesh=None)| {diff:.3e}, launches a step "
                f"{ {k: v / MESH_STEPS for k, v in launches.items()} }; {smi}")
        return out
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


GLOO_WORLDS = (2, 4)
GLOO_WAIT_S = 300


def gloo_smallcnn_round(mesh, device: str = "cuda") -> tuple:
    """(e)'s round: SmallCNN, 8 nodes (2 sign-flipping the honest mean) x
    32 images, the trimmed mean (f = 2), the sharded update on, precisions
    off, 5 steps on ``mesh`` (``None``: the single-device round). Returns
    the flat parameters (numpy) and the host ms of each step."""
    import torch

    from byzpy_tpu_torch.models import mnist_cnn, synthetic_classification
    from byzpy_tpu_torch.ops import attack_ops, robust
    from byzpy_tpu_torch.parallel import PSStepConfig, build_ps_train_step

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bundle = mnist_cnn(seed=0, device=device)
    x, y = synthetic_classification(n_samples=MESH_NODES * MESH_BATCH * MESH_STEPS, seed=3,
                                    device=device)
    step, opt = build_ps_train_step(
        bundle, functools.partial(robust.trimmed_mean, f=MESH_BYZ),
        PSStepConfig(n_nodes=MESH_NODES, n_byzantine=MESH_BYZ), mesh=mesh, sharded_update="on",
        attack=lambda honest, generator: attack_ops.sign_flip(honest.mean(dim=0)))
    params, ms = bundle.params, []
    per = MESH_NODES * MESH_BATCH
    for s in range(MESH_STEPS):
        xs = x[s * per:(s + 1) * per].reshape(MESH_NODES, MESH_BATCH, 28, 28, 1)
        ys = y[s * per:(s + 1) * per].reshape(MESH_NODES, MESH_BATCH)
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, xs, ys)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return torch.cat([v.reshape(-1) for v in params.values()]).cpu().numpy(), ms


def gloo_rank_main(rank: int, size: int, init: str, out_q) -> None:  # pragma: no cover - a rank
    """(e)'s rank: one of ``size`` processes sharing card 0 over a gloo
    group, running :func:`gloo_smallcnn_round` on a ``nodes`` mesh."""
    import traceback

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, world_size=size, rank=rank,
                            timeout=__import__("datetime").timedelta(seconds=GLOO_WAIT_S))
    try:
        from byzpy_tpu_torch.parallel.mesh import node_mesh

        out_q.put((rank, True, gloo_smallcnn_round(node_mesh(device="cuda"))))
    except Exception:  # noqa: BLE001 - sent to the parent, which fails the phase
        out_q.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def gloo_worlds(counts: dict, smi: str) -> dict:
    """(e) 2 and 4 ranks sharing the card over gloo at SmallCNN width: every
    rank's parameters equal bit for bit, and within f32 rounding of the
    single-device round (which (d)'s one-rank NCCL round equals bit for
    bit); whether they are bit for bit is printed."""
    import multiprocessing as mp
    import queue
    import tempfile

    import numpy as np

    want, single_ms = gloo_smallcnn_round(None)
    out = {"single_device_ms_per_step": single_ms}
    ctx = mp.get_context("spawn")
    # the worlds run side by side (6 processes on the card), each its own group
    worlds = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for size in GLOO_WORLDS:
            q = ctx.Queue()
            procs = [ctx.Process(target=gloo_rank_main,
                                 args=(r, size, f"file://{tmp}/rendezvous{size}", q), daemon=True)
                     for r in range(size)]
            for p in procs:
                p.start()
            worlds[size] = (q, procs)
        collected = {}
        try:
            for size, (q, procs) in worlds.items():
                results, errors = {}, []
                while len(results) + len(errors) < size:
                    try:
                        rank, ok, value = q.get(timeout=GLOO_WAIT_S)
                    except queue.Empty:
                        errors.append("no answer in time")
                        break
                    (results.__setitem__(rank, value) if ok else errors.append(value))
                collected[size] = (results, errors)
        finally:
            for q, procs in worlds.values():
                for p in procs:
                    p.join(timeout=60)
                    if p.is_alive():
                        p.terminate()
                        p.join(timeout=30)
        wall_s = time.perf_counter() - t0
    for size in GLOO_WORLDS:
        results, errors = collected.get(size, ({}, ["not collected"]))
        check(not errors, f"(e) the {size}-rank gloo world failed: {errors[:1]}")
        flats = [results[r][0] for r in range(size)]
        check(all(np.array_equal(f.view(np.int32), flats[0].view(np.int32)) for f in flats),
              f"(e) the {size} ranks' parameters differ")
        diff = float(np.abs(flats[0] - want).max())
        scale = float(np.abs(want).max())
        bitwise = bool(np.array_equal(flats[0].view(np.int32), want.view(np.int32)))
        # a rank's vmap holds n / ranks nodes: the per-node gradients of a
        # conv net round apart in their last bits from those of a vmap over
        # all n (cuDNN picks by batch), and 5 steps carry that on
        check(diff <= 1e-4 * scale, f"(e) {size} ranks: {diff} from the single-device round "
              f"(|p| max {scale})")
        ms = [results[r][1] for r in range(size)]
        out[f"ranks_{size}"] = {"ms_per_step_rank0": ms[0], "wall_s": wall_s,
                                "max_abs_diff_to_single_device": diff, "bitwise": bitwise}
        log(f"  (e) {size} ranks on one card over gloo: SmallCNN trimmed mean, sharded update, "
            f"{MESH_STEPS} steps, every rank's parameters equal; max |p - p(single device)| "
            f"{diff:.3e} (bit for bit: {bitwise}); rank 0's host ms a step "
            f"{[round(t, 1) for t in ms[0]]}; both worlds {wall_s:.1f} s with the spawn, side by "
            f"side; {smi}")
    return out


def engine_mesh_path(counts: dict, smi: str) -> dict:
    """Phase 4j: (a) the legacy runtime, (b) MeshRemoteContext, (c) the
    CLI, (d) the mesh PS round on one NCCL rank, (e) 2 and 4 gloo ranks
    sharing the card."""
    out = {}
    for key, fn in (("a_legacy_runtime", legacy_runtime), ("b_mesh_remote_context", mesh_remote_context),
                    ("c_cli", cli_phase), ("d_mesh_round_nccl", mesh_round_path),
                    ("e_gloo_ranks_on_one_card", gloo_worlds)):
        t0 = time.perf_counter()
        out[key] = fn(smi) if fn is cli_phase else fn(counts, smi)
        out[key]["phase_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 4k: the training mesh's rest (the compiled mesh step, the gossip
# round over a mesh, the ring and its shard split, the 2-D grid round,
# ParameterServer(update_sharding=))
# ---------------------------------------------------------------------------

MESHK_STEPS = 3
# (b)'s gossip round: config #4's ring(8, 2), 8 nodes (2 mimicking node 0)
# x 32 images of CIFAR, ResNet-18 at full width
MESHK_NODES, MESHK_BYZ, MESHK_BATCH, MESHK_LR = 8, 2, 32, 0.05
# (b) NNM + Multi-Krum with the sharded update on against off: the on form
# is B3's partial Gram and B5 on the columns, the off form B9's fused NNM
# -> Multi-Krum weights and B4's sweep; both sum over d in their own orders
MESHK_NNM_MK_REL = 1e-4
# (c) the ring: 4 gloo ranks sharing the card, one ResNet-18 node each
RING_RANKS, RING_K, RING_BATCH = 4, 2, 32
# (d) the grid: SmallCNN on a (2, 2) grid of gloo ranks sharing the card
GRID_SHAPE = (2, 2)
# (e) the actor PS: SmallCNN's 8 per-node gradients, 3 rounds
PS_ROUNDS = 3


def meshk_compiled(counts: dict, smi: str, mesh) -> dict:
    """(a) ``jit_ps_train_step(mesh=)`` on one NCCL rank: ResNet-18 for CIFAR
    at full width, 8 nodes (2 sign-flipping the honest mean) x 64 images,
    the trimmed mean and Multi-Krum, the sharded update on: the compiled
    steps replay the eager mesh steps bit for bit (``compiled_vs_eager``);
    the geometric median's sharded form refuses the capture."""
    import torch

    from byzpy_tpu_torch.models import cifar_resnet18, synthetic_classification
    from byzpy_tpu_torch.ops import attack_ops, robust
    from byzpy_tpu_torch.parallel import PSStepConfig, comms, jit_ps_train_step
    from byzpy_tpu_torch.utils.cuda_graph import GraphCaptureError

    x, y = synthetic_classification(n_samples=MAIN_N * V_BATCH, input_shape=(32, 32, 3), seed=3,
                                    device="cuda")
    xs, ys = x.reshape(MAIN_N, V_BATCH, 32, 32, 3), y.reshape(MAIN_N, V_BATCH)
    cfg = PSStepConfig(n_nodes=MAIN_N, n_byzantine=MAIN_BYZ)
    attack = lambda honest, g: attack_ops.sign_flip(honest.mean(dim=0))  # noqa: E731
    out = {}
    for name, agg, keys in (
            ("trimmed", functools.partial(robust.trimmed_mean, f=MAIN_BYZ), ["sorted_reduce:trimmed"]),
            ("multi_krum", functools.partial(robust.multi_krum, f=MAIN_BYZ, q=4),
             ["gram", "selection_mean_from_gram:krum"])):
        bundle = cifar_resnet18(seed=0, device="cuda")
        d = sum(int(v.numel()) for v in bundle.params.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eager, compiled, state0 = ps_twins(bundle, agg, cfg, attack=attack, mesh=mesh,
                                           sharded_update="on")
        res = compiled_vs_eager(f"(a) ResNet-18 mesh round, {name}", eager, compiled, state0,
                                lambda s: (xs, ys), keys, counts)
        res.pop("first_eager_state")
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec = comms.collective_traffic(eager, *state0, xs, ys)
        law = comms.ps_round_wire_bytes(d, 1, update_sharded=True)
        check(rec["wire_bytes_per_device"] == law == 0.0
              and {"all-to-all", "all-gather", "all-reduce"} <= set(rec["per_opcode_bytes"]),
              f"(a) {name}: the traffic record {rec['per_opcode_bytes']} against the law {law}")
        res["traffic"] = {"per_opcode_bytes": rec["per_opcode_bytes"], "law": law,
                          "result_bytes": sorted({(op.opcode, op.dtype): op.result_bytes
                                                  for op in rec["ops"]}.items())}
        log(f"  (a) {name}: peak {res['peak_gib']:.2f} GiB, traffic {rec['per_opcode_bytes']} "
            f"(wire bytes a device {rec['wire_bytes_per_device']}, law {law}); {smi}")
        out[name] = res
        del bundle, eager, compiled, state0
        torch.cuda.empty_cache()
    bundle = cifar_resnet18(seed=0, device="cuda")
    step, opt = jit_ps_train_step(bundle, robust.geometric_median, cfg, attack=attack, mesh=mesh)
    try:
        step(bundle.params, opt, xs, ys)
        refused = None
    except GraphCaptureError as exc:
        refused = str(exc)
    check(refused is not None and "host" in refused,
          f"(a) the sharded geometric median's capture did not refuse: {refused}")
    out["geomed_refusal"] = refused[:200]
    log(f"  (a) the geometric median's sharded form refuses the capture: {refused[:160]}")
    del bundle, step, opt
    torch.cuda.empty_cache()
    return out


def meshk_gossip(counts: dict, smi: str, mesh) -> dict:
    """(b) the gossip round over a one-rank NCCL mesh at ResNet-18's full
    width on ring(8, 2): the median and NNM + Multi-Krum with the sharded
    update off (the encoded rows all-gathered) and on (node -> feature ->
    node all-to-alls around the sharded forms), 3 steps each; on equals
    off bit for bit for the median and within ``MESHK_NNM_MK_REL`` of the
    largest weight for NNM + Multi-Krum; then the median's round compiled
    (``jit_gossip_train_step(mesh=)``), 3 replays bit for bit the eager
    steps."""
    import torch

    from byzpy_tpu_torch.engine.peer_to_peer import Topology
    from byzpy_tpu_torch.models import ShardedDataset, cifar_resnet18, synthetic_classification
    from byzpy_tpu_torch.ops import attack_ops, kernels, robust
    from byzpy_tpu_torch.parallel import GossipStepConfig, build_gossip_train_step, jit_gossip_train_step

    x, y = synthetic_classification(n_samples=MESHK_NODES * MESHK_BATCH, input_shape=(32, 32, 3),
                                    seed=5, device="cuda")
    xs, ys = ShardedDataset(x, y, n_nodes=MESHK_NODES).stacked_shards()
    cfg = GossipStepConfig(MESHK_NODES, MESHK_BYZ, MESHK_LR)
    topo = Topology.ring(MESHK_NODES, 2)
    attack = lambda honest, g: attack_ops.mimic(honest, epsilon=0)  # noqa: E731
    aggs = {"median": (robust.coordinate_median, ("sorted_reduce:median",)),
            "nnm_multi_krum": (functools.partial(robust.nnm_multi_krum, f_nnm=1, f=1, q=2), ())}
    out = {}
    for name, (agg, keys) in aggs.items():
        thetas = {}
        for su in ("off", "on"):
            bundle = cifar_resnet18(seed=0, device="cuda")
            step, init = build_gossip_train_step(bundle, agg, topo, cfg, attack=attack, mesh=mesh,
                                                 update_sharding=su)
            theta = init()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            ms = []
            for _ in range(MESHK_STEPS):
                t0 = time.perf_counter()
                theta, metrics = step(theta, xs, ys)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            launches = {k: v for k, v in kernels.launch_counts.items() if v}
            for k, v in launches.items():
                counts[k] += v
            check(all(launches.get(k, 0) >= MESHK_STEPS for k in keys),
                  f"(b) {name} {su}: launches {launches}, want {keys} every step")
            check(bool(torch.isfinite(theta).all()), f"(b) {name} {su}: theta not finite")
            thetas[su] = theta
            peak = torch.cuda.max_memory_allocated() / 2**30
            out[f"{name}/su={su}"] = {"ms_per_step": ms, "peak_gib": peak,
                                      "honest_loss": float(metrics["honest_loss"]),
                                      "launches_per_step": {k: v / MESHK_STEPS
                                                            for k, v in launches.items()}}
            log(f"  (b) {name}, update_sharding {su}: host ms a step {[round(t, 1) for t in ms]}, "
                f"peak {peak:.2f} GiB, launches a step "
                f"{ {k: v / MESHK_STEPS for k, v in launches.items()} }; {smi}")
            del bundle, step
        diff = float((thetas["on"] - thetas["off"]).abs().max())
        scale = float(thetas["off"].abs().max())
        if name == "median":
            check(bits_equal(thetas["on"], thetas["off"]),
                  f"(b) the median's sharded exchange differs from the gathered one ({diff})")
        else:
            check(diff <= MESHK_NNM_MK_REL * scale, f"(b) NNM + Multi-Krum: on is {diff} from off "
                  f"(|theta| max {scale}, bound {MESHK_NNM_MK_REL} of it)")
        out[f"{name}/on_vs_off_max_abs"] = diff
        log(f"  (b) {name}: max |theta(on) - theta(off)| {diff:.3e} (|theta| max {scale:.4f})")
        del thetas
        torch.cuda.empty_cache()
    bundle = cifar_resnet18(seed=0, device="cuda")
    eager, init = build_gossip_train_step(bundle, robust.coordinate_median, topo, cfg, attack=attack,
                                          mesh=mesh, update_sharding="on")
    compiled, _ = jit_gossip_train_step(bundle, robust.coordinate_median, topo, cfg, attack=attack,
                                        mesh=mesh, update_sharding="on", donate=False)
    te, tc, e_ms, c_ms = init(), init(), [], []
    for _ in range(MESHK_STEPS):
        t0 = time.perf_counter()
        te, me_ = eager(te, xs, ys)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tc, mc = compiled(tc, xs, ys)
        torch.cuda.synchronize()
        e_ms.append((t1 - t0) * 1e3)
        c_ms.append((time.perf_counter() - t1) * 1e3)
        check(bits_equal(te, tc) and bits_equal(me_["honest_loss"], mc["honest_loss"]),
              "(b) the compiled gossip mesh step differs from the eager one")
    check(len(compiled.graphs) == 1, f"(b) {len(compiled.graphs)} gossip graphs captured")
    replay = span_ms(lambda: compiled(tc, xs, ys))
    out["compiled_median"] = {"eager_ms": e_ms, "compiled_ms": c_ms, "graph_span_ms": replay,
                              "capture": compiled.last_capture["launches"]}
    log(f"  (b) the median's gossip mesh step compiled: {MESHK_STEPS} replays == eager bitwise; host "
        f"ms eager {[round(t, 1) for t in e_ms]} / compiled {[round(t, 1) for t in c_ms]}; graph "
        f"span {replay:.3f} ms; {smi}")
    del bundle, eager, compiled
    torch.cuda.empty_cache()
    return out


def meshk_ps_actor(counts: dict, smi: str, mesh) -> dict:
    """(e) ``ParameterServer(update_sharding="on")`` against ``None`` on one
    NCCL rank: 6 honest nodes feeding SmallCNN's per-node gradients of 3
    batches and 2 sign-flipping nodes, the trimmed mean (bit for bit) and
    NNM -> Multi-Krum (the fused pipeline; within f32 rounding, its sharded
    form on B3 + B5 and the unsharded one on B9 + B4)."""
    import torch
    from torch.func import grad, vmap

    from byzpy_tpu_torch.aggregators import CoordinateWiseTrimmedMean, MultiKrum
    from byzpy_tpu_torch.configs import use_mesh
    from byzpy_tpu_torch.engine.parameter_server import ParameterServer
    from byzpy_tpu_torch.models import mnist_cnn, synthetic_classification
    from byzpy_tpu_torch.ops import kernels
    from byzpy_tpu_torch.pre_aggregators import NearestNeighborMixing

    bundle = mnist_cnn(seed=0, device="cuda")
    x, y = synthetic_classification(n_samples=MAIN_N * MAIN_BATCH * PS_ROUNDS, seed=9, device="cuda")
    xs = x.reshape(PS_ROUNDS, MAIN_N, MAIN_BATCH, 28, 28, 1)
    ys = y.reshape(PS_ROUNDS, MAIN_N, MAIN_BATCH)
    per_node = vmap(grad(bundle.loss_fn), in_dims=(None, 0, 0))
    grads = [per_node(bundle.params, xs[r], ys[r]) for r in range(PS_ROUNDS)]
    h = MAIN_N - MAIN_BYZ

    class Honest:
        def __init__(self, i):
            self.i, self.r = i, 0

        def honest_gradient_for_next_batch(self):
            g = {k: v[self.i] for k, v in grads[self.r].items()}
            self.r += 1
            return g

        def apply_server_gradient(self, g):
            pass

    class Flip:
        def byzantine_gradient_for_next_batch(self, honest):
            return {k: -3.0 * sum(g[k] for g in honest) / len(honest) for k in honest[0]}

        def apply_server_gradient(self, g):
            pass

    async def rounds(agg, pre, su):
        ps = ParameterServer([Honest(i) for i in range(h)], [Flip() for _ in range(MAIN_BYZ)],
                             aggregator=agg, pre_aggregator=pre, update_sharding=su)
        outs, ms = [], []
        for _ in range(PS_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = await ps.round()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(torch.cat([v.reshape(-1) for v in g.values()]))
        return outs, ms

    out = {}
    for name, make in (("trimmed", lambda: (CoordinateWiseTrimmedMean(f=MAIN_BYZ), None)),
                       ("nnm_multi_krum", lambda: (MultiKrum(f=MAIN_BYZ, q=4),
                                                   NearestNeighborMixing(f=MAIN_BYZ)))):
        runs = {}
        for su in (None, "on"):
            kernels.reset_launch_counts()
            with use_mesh(mesh):
                runs[su] = asyncio.run(rounds(*make(), su))
            launches = {k: v for k, v in kernels.launch_counts.items() if v}
            for k, v in launches.items():
                counts[k] += v
            out[f"{name}/update_sharding={su}"] = {
                "ms_per_round": runs[su][1],
                "launches_per_round": {k: v / PS_ROUNDS for k, v in launches.items()}}
            log(f"  (e) {name}, update_sharding={su}: host ms a round "
                f"{[round(t, 2) for t in runs[su][1]]}, launches a round "
                f"{ {k: v / PS_ROUNDS for k, v in launches.items()} }; {smi}")
        diffs = [float((a - b).abs().max()) for a, b in zip(runs["on"][0], runs[None][0])]
        scale = max(float(b.abs().max()) for b in runs[None][0])
        if name == "trimmed":
            check(all(bits_equal(a, b) for a, b in zip(runs["on"][0], runs[None][0])),
                  f"(e) trimmed: the sharded aggregate differs from the unsharded one {diffs}")
        else:
            check(max(diffs) <= 1e-6 * scale + 1e-7, f"(e) NNM + Multi-Krum: {diffs} from the "
                  f"unsharded aggregate (|g| max {scale})")
        out[f"{name}/max_abs_diff"] = diffs
        log(f"  (e) {name}: max |agg(on) - agg(None)| by round {diffs} (|agg| max {scale:.4f})")
    return out


def meshk_gloo_rank(rank: int, size: int, init: str, out_q) -> None:  # pragma: no cover - a rank
    """(c) and (d)'s rank: one of 4 processes sharing card 0 over a gloo
    group. (d) the SmallCNN round on a (2, 2) grid, and one step's traffic
    record; (c) the ring round at ResNet-18's width, the shard split off
    and on and the int8 payload."""
    import traceback

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, world_size=size, rank=rank,
                            timeout=__import__("datetime").timedelta(seconds=GLOO_WAIT_S))
    try:
        from byzpy_tpu_torch.models import cifar_resnet18, synthetic_classification
        from byzpy_tpu_torch.ops import kernels, robust
        from byzpy_tpu_torch.parallel import GossipStepConfig, build_ring_gossip_train_step
        from byzpy_tpu_torch.parallel.mesh import grid_mesh, node_mesh

        out = {}
        grid = grid_mesh(*GRID_SHAPE, device="cuda")
        flat, ms = gloo_smallcnn_round(grid)
        out["grid"] = {"flat": flat, "ms": ms, "traffic": grid_traffic(grid)}
        mesh = node_mesh(device="cuda")
        x, y = synthetic_classification(n_samples=RING_RANKS * RING_BATCH, input_shape=(32, 32, 3),
                                        seed=11, device="cuda")
        xs, ys = x.reshape(RING_RANKS, RING_BATCH, 32, 32, 3), y.reshape(RING_RANKS, RING_BATCH)
        rows = {}
        for key, su, comm in (("off", "off", None), ("on", "on", None), ("int8", "off", "int8")):
            bundle = cifar_resnet18(seed=0, device="cuda")
            step, init_row = build_ring_gossip_train_step(
                bundle, robust.coordinate_median, GossipStepConfig(RING_RANKS, 1, MESHK_LR), mesh,
                k=RING_K, comm_precision=comm, update_sharding=su)
            theta, times = init_row(), []
            kernels.reset_launch_counts()
            for _ in range(MESHK_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                theta, loss = step(theta, xs, ys)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            rows[key] = theta
            out[f"ring_{key}"] = {"ms": times, "honest_loss": float(loss),
                                  "finite": bool(torch.isfinite(theta).all()),
                                  "launches": {k: v for k, v in kernels.launch_counts.items() if v}}
        out["ring_on_equals_off"] = bool(torch.equal(rows["on"].view(torch.int32),
                                                     rows["off"].view(torch.int32)))
        out["ring_int8_max_abs"] = float((rows["int8"] - rows["off"]).abs().max())
        out["ring_scale"] = float(rows["off"].abs().max())
        out_q.put((rank, True, out))
    except Exception:  # noqa: BLE001 - sent to the parent, which fails the phase
        out_q.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def grid_traffic(grid) -> dict:
    """One SmallCNN grid step's traffic record on this rank, beside
    ``comms.ps_round_wire_bytes`` for ``nodes x data`` feature shards."""
    import torch

    from byzpy_tpu_torch.models import mnist_cnn, synthetic_classification
    from byzpy_tpu_torch.ops import robust
    from byzpy_tpu_torch.parallel import PSStepConfig, build_ps_train_step, comms

    bundle = mnist_cnn(seed=0, device="cuda")
    d = sum(int(v.numel()) for v in bundle.params.values())
    x, y = synthetic_classification(n_samples=MESH_NODES * MESH_BATCH, seed=3, device="cuda")
    step, opt = build_ps_train_step(bundle, functools.partial(robust.trimmed_mean, f=MESH_BYZ),
                                    PSStepConfig(n_nodes=MESH_NODES, n_byzantine=MESH_BYZ),
                                    mesh=grid, sharded_update="on")
    rec = comms.collective_traffic(step, bundle.params, opt,
                                   x.reshape(MESH_NODES, MESH_BATCH, 28, 28, 1),
                                   y.reshape(MESH_NODES, MESH_BATCH))
    shards = GRID_SHAPE[0] * GRID_SHAPE[1]
    # the flat vector pads to the shards: the law at the padded length
    d_pad = -(-d // shards) * shards
    law = comms.ps_round_wire_bytes(d_pad, shards, update_sharded=True)
    torch.cuda.synchronize()
    return {"per_opcode_bytes": rec["per_opcode_bytes"], "law": law, "d": d, "d_pad": d_pad}


def meshk_gloo(counts: dict, smi: str) -> dict:
    """(c) the ring (4 ranks on ring(4, 2), one ResNet-18 node each, the
    last byzantine sending ``-half``, the coordinate median, 3 steps): the
    shard split equals the unsplit round bit for bit on every rank, the
    int8 payload printed beside it; (d) the grid (SmallCNN, 8 nodes of
    which 2 sign-flip, the trimmed mean, the sharded update on, 5 steps on a
    (2, 2) grid): every rank's parameters equal, within 1e-4 of the largest
    weight from the single-device round (the grid's per-node gradients are
    the means of two half-batch vmaps, whose cuDNN paths round apart from
    one whole-batch vmap's), and the update's all-gather equal to the law's
    term for 4 feature shards."""
    import multiprocessing as mp
    import queue
    import tempfile

    import numpy as np

    want, single_ms = gloo_smallcnn_round(None)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        q = ctx.Queue()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=meshk_gloo_rank, args=(r, RING_RANKS, f"file://{tmp}/rdzv", q),
                             daemon=True) for r in range(RING_RANKS)]
        for p in procs:
            p.start()
        results, errors = {}, []
        try:
            while len(results) + len(errors) < RING_RANKS:
                try:
                    rank, ok, value = q.get(timeout=GLOO_WAIT_S)
                except queue.Empty:
                    errors.append("no answer in time")
                    break
                (results.__setitem__(rank, value) if ok else errors.append(value))
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=30)
        wall_s = time.perf_counter() - t0
    check(not errors, f"(c)/(d) the 4-rank gloo world failed: {errors[:1]}")
    flats = [results[r]["grid"]["flat"] for r in range(RING_RANKS)]
    check(all(np.array_equal(f.view(np.int32), flats[0].view(np.int32)) for f in flats),
          "(d) the grid ranks' parameters differ")
    diff = float(np.abs(flats[0] - want).max())
    scale = float(np.abs(want).max())
    check(diff <= 1e-4 * scale, f"(d) the (2, 2) grid is {diff} from the single-device round "
          f"(|p| max {scale})")
    traffic = results[0]["grid"]["traffic"]
    check(traffic["per_opcode_bytes"].get("all-gather") == traffic["law"] / 2,
          f"(d) the grid's all-gather {traffic['per_opcode_bytes']} against the law's gather term "
          f"{traffic['law'] / 2}")
    out = {"wall_s": wall_s, "single_device_ms_per_step": single_ms,
           "grid": {"max_abs_diff_to_single_device": diff, "scale": scale,
                    "bitwise": bool(np.array_equal(flats[0].view(np.int32), want.view(np.int32))),
                    "ms_per_step_rank0": results[0]["grid"]["ms"], "traffic": traffic}}
    log(f"  (d) (2, 2) grid of gloo ranks on one card: SmallCNN trimmed mean, {MESH_STEPS} steps, "
        f"every rank's parameters equal; max |p - p(single device)| {diff:.3e} (bit for bit: "
        f"{out['grid']['bitwise']}); rank 0's host ms a step "
        f"{[round(t, 1) for t in results[0]['grid']['ms']]}; traffic {traffic['per_opcode_bytes']} "
        f"against the law {traffic['law']} for d = {traffic['d']} over 4 shards; {smi}")
    for r in range(RING_RANKS):
        res = results[r]
        check(res["ring_on_equals_off"], f"(c) rank {r}: the ring's shard split differs from the "
              "unsplit round")
        check(all(res[f"ring_{k}"]["finite"] for k in ("off", "on", "int8")),
              f"(c) rank {r}: a ring row is not finite")
        check(res["ring_int8_max_abs"] <= MESHK_STEPS * (res["ring_scale"] / 127 + 1e-6),
              f"(c) rank {r}: the int8 ring is {res['ring_int8_max_abs']} from the f32 ring")
    out["ring"] = {str(r): {k: results[r][k] for k in results[r] if k != "grid"}
                   for r in range(RING_RANKS)}
    r0 = results[0]
    log(f"  (c) ring({RING_RANKS}, {RING_K}) of gloo ranks on one card at ResNet-18's width: the "
        f"shard split == the unsplit round bitwise on every rank; int8 payload max |theta - "
        f"theta(off)| by rank {[round(results[r]['ring_int8_max_abs'], 7) for r in range(RING_RANKS)]}; "
        f"rank 0's host ms a step off {[round(t, 1) for t in r0['ring_off']['ms']]}, split "
        f"{[round(t, 1) for t in r0['ring_on']['ms']]}, int8 {[round(t, 1) for t in r0['ring_int8']['ms']]}; "
        f"launches rank 0 off {r0['ring_off']['launches']}; the world {wall_s:.1f} s with the "
        f"spawn; {smi}")
    return out


def training_mesh_path(counts: dict, smi: str) -> dict:
    """Phase 4k: (a) the compiled mesh PS step, (b) the gossip mesh round,
    (e) the actor PS's sharded update, on one NCCL rank; then (c) the ring
    and (d) the grid on 4 gloo ranks sharing the card."""
    import torch
    import torch.distributed as dist

    from byzpy_tpu_torch.parallel.mesh import init_process_group, node_mesh

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out = {}
    check(init_process_group(f"tcp://127.0.0.1:{free_port()}", 1, 0, backend="nccl"),
          "4k: the NCCL process group was already initialized")
    try:
        mesh = node_mesh(device="cuda")
        for key, fn in (("a_compiled_mesh_step", meshk_compiled), ("b_gossip_mesh", meshk_gossip),
                        ("e_actor_ps_update_sharding", meshk_ps_actor)):
            t0 = time.perf_counter()
            out[key] = fn(counts, smi, mesh)
            out[key]["phase_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    t0 = time.perf_counter()
    out["cd_ring_and_grid_gloo"] = meshk_gloo(counts, smi)
    out["cd_ring_and_grid_gloo"]["phase_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 4l: the serving frontend
# ---------------------------------------------------------------------------

# four tenants at SmallCNN's width, cohorts of these sizes, FRONT_ROUNDS
# rounds each, FRONT_BYZ sign-flipped clients a cohort
FRONT_COHORTS = (6, 13, 29, 64)
FRONT_ROUNDS = 5
FRONT_BYZ = 2
FRONT_CAP = 64
# (c): clients over loopback TCP, on this many connections
TCP_CLIENTS, TCP_CONNS = 16, 4
TCP_MODES = ("off", "int8", "s4")
# (e): ResNet-18 for CIFAR's width
WIDE_FRONT_D, WIDE_FRONT_CLIENTS, WIDE_FRONT_ROUNDS = 11_173_962, 8, 2


def front_tenants(forensics: bool = True) -> dict:
    """(a)/(b)'s tenants: name -> (class factory of ``device``, the kernels a
    round must launch with the ragged door on, and with it off)."""
    from byzpy_tpu_torch.aggregators import (
        CoordinateWiseMedian, CoordinateWiseTrimmedMean, GeometricMedian, MultiKrum,
    )

    b = FRONT_BYZ
    return {
        # the segmented sort-reduce (door on); B2 and B11 (door off)
        "trimmed_mean": (lambda dev: CoordinateWiseTrimmedMean(b, device=dev),
                         ("segmented_sort_reduce",), ("sort_columns", "segment_sum")),
        "median": (lambda dev: CoordinateWiseMedian(device=dev),
                   ("segmented_sort_reduce",), ("sort_columns",)),
        # B3's Gram and B11; with forensics on, the door's fused scores
        # (door on) or the Krum evidence view's Gram (door off)
        "multi_krum": (lambda dev: MultiKrum(b, 4, device=dev),
                       ("gram", "segment_sum"), ("gram", "segment_sum")),
        # the masked median start (B2) and B7's masked Weiszfeld loop
        "geometric_median": (lambda dev: GeometricMedian(device=dev),
                             ("sort_columns", "center_loop:masked_weiszfeld"),
                             ("sort_columns", "center_loop:masked_weiszfeld")),
    }


class PlainCalls:
    """Counts the kernel wrappers' plain-version calls (``_on_cpu`` answering
    True) while active: on the card's path there must be none."""

    def __init__(self):
        from byzpy_tpu_torch.ops import codec_kernels, kernels

        self.mods = (kernels, codec_kernels)
        self.real = kernels._on_cpu
        self.calls = 0

    def __enter__(self):
        def counting(*tensors):
            plain = self.real(*tensors)
            self.calls += int(plain)
            return plain

        for mod in self.mods:
            mod._on_cpu = counting
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod._on_cpu = self.real
        return False


def smallcnn_client_rows(n: int, seed: int):
    """``(n, 421,642)`` SmallCNN per-client gradients on the card, each
    client its own batch of 64 at the initial parameters."""
    import torch
    from torch.func import grad_and_value, vmap

    from byzpy_tpu_torch.models import SmallCNN, make_bundle, synthetic_classification

    bundle = make_bundle(SmallCNN(), seed=0, device="cuda")
    per_node = vmap(grad_and_value(bundle.loss_fn), in_dims=(None, 0, 0))
    x, y = synthetic_classification(n_samples=n * MAIN_BATCH, seed=seed, device="cuda")
    grads, _ = per_node(bundle.params, x.reshape(n, MAIN_BATCH, 28, 28, 1), y.reshape(n, MAIN_BATCH))
    return torch.cat([grads[k].reshape(n, -1) for k in bundle.params], dim=1)


def front_round_rows(honest, m: int, rnd: int):
    """Round ``rnd``'s cohort of ``m`` host rows: the first ``m - FRONT_BYZ``
    honest gradients moved by a seeded round perturbation, the last
    ``FRONT_BYZ`` the sign-flipped honest mean (client i's round stamp is
    one round behind for i % 4 == 1)."""
    import torch

    from byzpy_tpu_torch.ops import attack_ops

    g = torch.Generator(device="cuda").manual_seed(1000 + rnd)
    rows = honest[:m].clone()
    rows += 1e-3 * torch.randn(rows.shape, generator=g, device="cuda")
    rows[m - FRONT_BYZ:] = attack_ops.sign_flip(rows[:m - FRONT_BYZ].mean(dim=0))
    return rows.cpu().numpy()


def front_stats(values) -> dict:
    vals = sorted(values)
    return {"median": vals[len(vals) // 2], "min": vals[0], "max": vals[-1], "n": len(vals)}


def front_door(counts: dict, honest, door: str) -> dict:
    """(a) / (b): the four tenants through ``ServingFrontend`` with the
    ragged door on or off: per cohort size, FRONT_ROUNDS rounds of in-process
    ``submit`` and ``close_round_nowait``. Every round's aggregate is bit for
    bit the port's executor called directly on the same submissions (the
    tenant group's ``RaggedExecutor`` with the door on, ``CohortAggregator``
    on the ladder's bucket with it off); the round launched every expected
    kernel and no plain version; on the last cohort size one round per
    tenant is profiled and one counts its host reads."""
    import torch

    from byzpy_tpu_torch.forensics import ForensicsConfig
    from byzpy_tpu_torch.ops import kernels
    from byzpy_tpu_torch.serving import (
        BucketLadder, CohortAggregator, CreditPolicy, RaggedExecutor, ServingFrontend,
        StalenessPolicy, Submission, TenantConfig, build_cohort,
    )

    os.environ["BYZPY_TPU_TORCH_RAGGED"] = "1" if door == "ragged" else "0"
    policy = StalenessPolicy("exponential", gamma=0.5)
    d = int(honest.shape[1])
    specs = front_tenants()
    aggs = {name: make(None) for name, (make, _, _) in specs.items()}
    fe = ServingFrontend([
        TenantConfig(name, aggs[name], dim=d, cohort_cap=FRONT_CAP, min_bucket=2, staleness=policy,
                     credit=CreditPolicy(rate_per_s=0.0),
                     forensics=ForensicsConfig() if name == "multi_krum" else None)
        for name in specs], clock=time.monotonic)
    check(all(fe.stats()[n]["ragged_served"] == (door == "ragged") for n in specs),
          f"(a/b) {door}: ragged_served")
    direct = {name: RaggedExecutor(aggs[name], d, FRONT_CAP, 1, with_evidence=False)
              for name in specs}
    ladder = BucketLadder(FRONT_CAP, min_bucket=2)
    submit_ms, close_ms, launches = [], {}, {}
    plain = PlainCalls()
    rid = 0
    for m in FRONT_COHORTS:
        for rnd in range(FRONT_ROUNDS):
            rows = front_round_rows(honest, m, rid)
            for name, (_, want_on, want_off) in specs.items():
                subs = []
                for i in range(m):
                    stamp = rid - (i % 4 == 1)
                    t0 = time.perf_counter()
                    ok = fe.submit(name, f"{name}/c{i}", stamp, rows[i], seq=rid)
                    submit_ms.append((time.perf_counter() - t0) * 1e3)
                    check(ok == (True, "accepted"), f"(a/b) {door} {name}: submit {ok}")
                    subs.append(Submission(f"{name}/c{i}", stamp, rows[i], 0.0))
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                with plain:
                    closed = fe.close_round_nowait(name)
                    torch.cuda.synchronize()
                close_ms.setdefault(f"{name}:{m}", []).append((time.perf_counter() - t0) * 1e3)
                run_counts = dict(kernels.launch_counts)
                for k, v in run_counts.items():
                    counts[k] += v
                want = want_on if door == "ragged" else want_off
                check(closed is not None and closed[0] == rid and closed[1].m == m,
                      f"(a/b) {door} {name}: round {rid} of {m} did not close")
                check(all(run_counts[k] > 0 for k in want),
                      f"(a/b) {door} {name} m={m}: {want} not all launched: {run_counts}")
                launches[f"{name}:{m}"] = {k: v for k, v in run_counts.items() if v}
                vec = closed[2]
                check(vec.is_cuda, f"(a/b) {door} {name}: the aggregate left the card")
                if door == "ragged":
                    cohort = build_cohort(subs, rid, None, policy, quantized=True)
                    ref = direct[name].aggregate([cohort], [name])[0].vector
                else:
                    ref = CohortAggregator(aggs[name]).aggregate(build_cohort(subs, rid, ladder, policy))
                check(bits_equal(vec, ref),
                      f"(a/b) {door} {name} m={m} round {rid}: differs from the executor called directly")
            rid += 1
    check(plain.calls == 0, f"(a/b) {door}: {plain.calls} plain-version calls on the card's path")
    # one profiled round and one counted round per tenant at the largest cohort
    profiles, reads = {}, {}
    m = FRONT_COHORTS[-1]
    rows = front_round_rows(honest, m, rid)
    for name in specs:
        def one_round(name=name):
            for i in range(m):
                fe.submit(name, f"{name}/c{i}", fe.round_of(name), rows[i], seq=10_000 + fe.round_of(name))
            return fe.close_round_nowait(name)

        profiles[name] = profile_steps(one_round, steps=2)
        for i in range(m):
            fe.submit(name, f"{name}/c{i}", fe.round_of(name), rows[i], seq=20_000 + fe.round_of(name))
        _, reads[name] = count_syncs(lambda name=name: fe.close_round_nowait(name))
    forensics = fe.stats()["multi_krum"]["forensics"]
    check(forensics["rounds_observed"] >= len(FRONT_COHORTS) * FRONT_ROUNDS,
          f"(a/b) {door}: forensics observed {forensics['rounds_observed']} rounds")
    out = {
        "submit_host_ms": front_stats(submit_ms),
        "close_to_aggregate_ms": {k: front_stats(v) for k, v in close_ms.items()},
        "launches_per_round": launches,
        "profile_at_64": profiles,
        "host_reads_per_round_at_64": reads,
        "plain_calls": plain.calls,
        "forensics_excluded_byzantine": forensics["trust"]["lowest_trust_clients"][:FRONT_BYZ],
        "ragged": fe.stats()["median"]["frontend"]["ragged"],
        "executor_bitwise": True,
    }
    log(f"  ({'a' if door == 'ragged' else 'b'}) door {door}: every round of "
        f"{len(FRONT_COHORTS) * FRONT_ROUNDS * len(specs)} == the executor called directly bitwise, "
        f"no plain call; submit {out['submit_host_ms']['median']:.4f} ms; close-to-aggregate "
        + ", ".join(f"{k} {v['median']:.2f}" for k, v in out["close_to_aggregate_ms"].items())
        + f"; host reads at 64 {reads}")
    return out


async def front_tcp(honest, mode: str) -> dict:
    """(c) one mode: ``serve()`` and TCP_CLIENTS clients on TCP_CONNS
    ``ServingClient`` connections over loopback, the async scheduler closing
    the round on its size trigger (a Multi-Krum tenant, door on). The
    aggregate is bit for bit the executor called directly on the rows the
    wire delivered (the clients' host encode, replayed here)."""
    import asyncio

    import torch

    from byzpy_tpu_torch.aggregators import MultiKrum
    from byzpy_tpu_torch.engine.actor import wire
    from byzpy_tpu_torch.ops import kernels
    from byzpy_tpu_torch.serving import (
        CreditPolicy, RaggedExecutor, ServingClient, ServingFrontend, StalenessPolicy, Submission,
        TenantConfig, build_cohort,
    )

    os.environ["BYZPY_TPU_TORCH_RAGGED"] = "1"
    if mode == "off":
        os.environ.pop("BYZPY_TPU_TORCH_WIRE_PRECISION", None)
    else:
        os.environ["BYZPY_TPU_TORCH_WIRE_PRECISION"] = mode
    try:
        rows = front_round_rows(honest, TCP_CLIENTS, 77)
        d = rows.shape[1]
        agg = MultiKrum(FRONT_BYZ, 4)
        policy = StalenessPolicy()
        fe = ServingFrontend([TenantConfig("mk", agg, dim=d, cohort_cap=TCP_CLIENTS, window_s=120.0,
                                           credit=CreditPolicy(rate_per_s=0.0), staleness=policy)])
        await fe.start()
        acks, ack_ms = [], []
        try:
            host, port = await fe.serve()
            clients = [ServingClient() for _ in range(TCP_CONNS)]
            for c in clients:
                await c.connect(host, port)

            async def send(k):
                for i in range(k, TCP_CLIENTS, TCP_CONNS):
                    t0 = time.perf_counter()
                    acks.append(await clients[k].submit("mk", f"c{i}", 0, rows[i]))
                    ack_ms.append((time.perf_counter() - t0) * 1e3)

            t0 = time.perf_counter()
            await asyncio.gather(*(send(k) for k in range(TCP_CONNS)))
            rid = await asyncio.wait_for(fe.drain("mk"), 300)
            torch.cuda.synchronize()
            round_s = time.perf_counter() - t0
            # the round's launches, before the check's own
            launches = dict(kernels.launch_counts)
            vec = fe.last_aggregate("mk")
            for c in clients:
                await c.close()
            stats = fe.stats()["mk"]
        finally:
            await fe.close()
        check(all(a["accepted"] for a in acks) and rid == 1, f"(c) {mode}: acks {acks[:2]}, round {rid}")
        sent = [wire.compress_payload({"g": torch.from_numpy(rows[i])}, mode)["g"] for i in range(TCP_CLIENTS)]
        subs = [Submission(f"c{i}", 0, sent[i], 0.0) for i in range(TCP_CLIENTS)]
        cohort = build_cohort(subs, 0, None, policy, quantized=True)
        check(cohort.quantized == (mode != "off"), f"(c) {mode}: cohort layout")
        ref = RaggedExecutor(agg, d, TCP_CLIENTS, 1, with_evidence=False).aggregate([cohort], ["mk"])[0].vector
        check(bits_equal(vec, ref), f"(c) {mode}: differs from the executor on the delivered rows")
        return {"ack_host_ms": front_stats(ack_ms), "round_s": round_s, "launch_counts": launches,
                "ingress_bytes": stats["ingress_bytes"],
                "quantized_dispatches": stats["frontend"]["ragged"]["quantized_dispatches"]}
    finally:
        os.environ.pop("BYZPY_TPU_TORCH_WIRE_PRECISION", None)


def front_recover(honest) -> dict:
    """(d) WAL and snapshots in a temporary directory: three rounds, a fourth
    cohort admitted (write-ahead logged) but not folded, the frontend
    dropped; ``ServingFrontend.recover`` resumes at round 3 with the cohort
    pending, and the round it closes has the digest of an uninterrupted
    run's round 3."""
    import tempfile

    from byzpy_tpu_torch.aggregators import CoordinateWiseTrimmedMean
    from byzpy_tpu_torch.forensics.evidence import evidence_digest
    from byzpy_tpu_torch.serving import (
        CreditPolicy, DurabilityConfig, ServingFrontend, TenantConfig,
    )

    os.environ["BYZPY_TPU_TORCH_RAGGED"] = "1"
    d = int(honest.shape[1])
    m = 13

    def cfg():
        return [TenantConfig("tm", CoordinateWiseTrimmedMean(FRONT_BYZ), dim=d, cohort_cap=FRONT_CAP,
                             credit=CreditPolicy(rate_per_s=0.0))]

    def feed(fe, rnd):
        rows = front_round_rows(honest, m, 500 + rnd)
        for i in range(m):
            check(fe.submit("tm", f"c{i}", rnd, rows[i], seq=rnd) == (True, "accepted"), "(d) submit")

    straight = ServingFrontend(cfg())
    digests = []
    for rnd in range(4):
        feed(straight, rnd)
        digests.append(evidence_digest(straight.close_round_nowait("tm")[2]))
    with tempfile.TemporaryDirectory() as tmp:
        dur = DurabilityConfig(directory=tmp, snapshot_every=2)
        first = ServingFrontend(cfg(), durability=dur)
        for rnd in range(3):
            feed(first, rnd)
            first.close_round_nowait("tm")
        feed(first, 3)
        for t in first._tenants.values():
            t.durability.close()
        del first
        t0 = time.perf_counter()
        again = ServingFrontend.recover(cfg(), dur)
        recover_ms = (time.perf_counter() - t0) * 1e3
        rec = again.stats()["tm"]["recovered_from"]
        check(again.round_of("tm") == 3 and rec["replayed_pending"] == m, f"(d) recovered {rec}")
        closed = again.close_round_nowait("tm")
        for t in again._tenants.values():
            t.durability.close()
    digest = evidence_digest(closed[2])
    check(closed[0] == 3 and digest == digests[3], f"(d) recovered round 3 digest {digest} != {digests[3]}")
    return {"recovered_from": rec, "recover_ms": recover_ms, "digest": digest,
            "uninterrupted_digest": digests[3]}


def front_wide(counts: dict) -> dict:
    """(e) one trimmed-mean tenant at ResNet-18's width, WIDE_FRONT_CLIENTS
    clients (random rows from a seed, two sign-flipped), WIDE_FRONT_ROUNDS
    rounds through in-process ``submit``: each aggregate bit for bit the
    executor called directly; peak GiB."""
    import torch

    from byzpy_tpu_torch.aggregators import CoordinateWiseTrimmedMean
    from byzpy_tpu_torch.ops import attack_ops, kernels
    from byzpy_tpu_torch.serving import (
        CreditPolicy, RaggedExecutor, ServingFrontend, StalenessPolicy, Submission, TenantConfig,
        build_cohort,
    )

    os.environ["BYZPY_TPU_TORCH_RAGGED"] = "1"
    d, m = WIDE_FRONT_D, WIDE_FRONT_CLIENTS
    agg = CoordinateWiseTrimmedMean(FRONT_BYZ)
    policy = StalenessPolicy()
    fe = ServingFrontend([TenantConfig("tm", agg, dim=d, cohort_cap=m,
                                       credit=CreditPolicy(rate_per_s=0.0))])
    direct = RaggedExecutor(agg, d, m, 1, with_evidence=False)
    submit_ms, close_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    plain = PlainCalls()
    for rnd in range(WIDE_FRONT_ROUNDS):
        g = torch.Generator(device="cuda").manual_seed(4000 + rnd)
        dev_rows = torch.randn((m, d), generator=g, device="cuda")
        dev_rows[m - FRONT_BYZ:] = attack_ops.sign_flip(dev_rows[:m - FRONT_BYZ].mean(dim=0))
        rows = dev_rows.cpu().numpy()
        del dev_rows
        for i in range(m):
            t0 = time.perf_counter()
            check(fe.submit("tm", f"c{i}", rnd, rows[i]) == (True, "accepted"), "(e) submit")
            submit_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with plain:
            rid, cohort, vec = fe.close_round_nowait("tm")
            torch.cuda.synchronize()
        close_ms.append((time.perf_counter() - t0) * 1e3)
        run_counts = dict(kernels.launch_counts)
        for k, v in run_counts.items():
            counts[k] += v
        check(run_counts["segmented_sort_reduce"] > 0, f"(e) launches {run_counts}")
        subs = [Submission(f"c{i}", rnd, rows[i], 0.0) for i in range(m)]
        ref = direct.aggregate([build_cohort(subs, rnd, None, policy, quantized=True)], ["tm"])[0].vector
        check(rid == rnd and bits_equal(vec, ref), f"(e) round {rnd} differs from the executor")
    check(plain.calls == 0, f"(e) {plain.calls} plain-version calls")
    peak = torch.cuda.max_memory_allocated() / 2**30
    return {"d": d, "clients": m, "submit_host_ms": front_stats(submit_ms),
            "close_to_aggregate_ms": close_ms, "peak_gib": peak, "executor_bitwise": True}


def frontend_path(counts: dict, smi: str) -> dict:
    """Phase 4l: ``ServingFrontend`` on the card, (a)-(e) (their docstrings),
    with the launches of the card's path counted into ``counts``."""
    import asyncio

    import torch

    from byzpy_tpu_torch.ops import kernels

    saved = {k: os.environ.get(k) for k in ("BYZPY_TPU_TORCH_RAGGED", "BYZPY_TPU_TORCH_WIRE_PRECISION")}
    out = {"card": smi}
    try:
        t0 = time.perf_counter()
        honest = smallcnn_client_rows(FRONT_CAP, seed=41)
        torch.cuda.synchronize()
        out["client_gradients_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        for key, door in (("a_ragged", "ragged"), ("b_bucketed", "bucketed")):
            t0 = time.perf_counter()
            out[key] = front_door(counts, honest, door)
            out[key]["phase_s"] = time.perf_counter() - t0
        out["ab_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["c_tcp"] = {}
        for mode in TCP_MODES:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = asyncio.run(front_tcp(honest, mode))
            run_counts = res.pop("launch_counts")
            for k, v in run_counts.items():
                counts[k] += v
            if mode != "off":
                for key in (DECODE_KEY[mode], b12_key(mode)):
                    check(run_counts[key] > 0, f"(c) {mode}: {key} never launched: {run_counts}")
            res["launches"] = {k: v for k, v in run_counts.items() if v}
            res["phase_s"] = time.perf_counter() - t0
            out["c_tcp"][mode] = res
            log(f"  (c) {mode}: {TCP_CLIENTS} clients over TCP, == the executor on the delivered rows "
                f"bitwise; ack {res['ack_host_ms']['median']:.3f} ms; launches {res['launches']}")
        t0 = time.perf_counter()
        out["d_recover"] = front_recover(honest)
        out["d_recover"]["phase_s"] = time.perf_counter() - t0
        log(f"  (d) recovered {out['d_recover']['recovered_from']}: round 3 digest == uninterrupted")
        del honest
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["e_resnet18_width"] = front_wide(counts)
        out["e_resnet18_width"]["phase_s"] = time.perf_counter() - t0
        log(f"  (e) d = {WIDE_FRONT_D:,}: close-to-aggregate {out['e_resnet18_width']['close_to_aggregate_ms']} ms, "
            f"peak {out['e_resnet18_width']['peak_gib']:.2f} GiB")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


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
    # B7's masked modes: LOOP_STEPS forced steps on the rows with 3 in 4
    # valid, the Weiszfeld loop from their masked median, the centred
    # clipping from their masked mean. Bound: one read of x a step (and z
    # read and the centre written once); a step's distances (sub, mul, add)
    # and FMA chain (2 flops; clipping's differences 1 more) on every
    # entry. The kernel reads x once a step and once for the first
    # distances (reads_bound_ms). Device time: torch.profiler over the
    # whole call (the start, then the loop; "call"), the loop kernel's
    # time read from it. (A profile of the loop's launch alone recorded
    # none of 36 launches after the earlier phases in one H100 run, while
    # the whole call's profile recorded each.)
    from byzpy_tpu_torch.ops import robust

    valid = torch.arange(n, device="cuda") % 4 != 3
    reads_ms = (LOOP_STEPS + 1) * n * d * isz / PEAK_BYTES_PER_S * 1e3
    c_tau = MASKED_CLIP_CTAU * d ** 0.5
    for mode, z0, ops, kw, call in (
            ("masked_weiszfeld", robust._masked_median_rows(x, valid), 5, dict(tol=-1.0),
             lambda: robust.masked_geometric_median(x, valid, tol=-1.0, max_iter=LOOP_STEPS)),
            ("masked_clip", robust.masked_mean(x, valid), 6, dict(c_tau=c_tau),
             lambda: robust.masked_centered_clipping(x, valid, c_tau=c_tau, M=LOOP_STEPS))):
        loop = dict(mode=mode, valid=valid, max_iter=LOOP_STEPS, **kw)
        b_ms, b_by = bound_ms(LOOP_STEPS * n * d * isz + 2 * d * isz, ops * n * d * LOOP_STEPS)
        for _ in range(3):  # a profile that recorded no loop launch is taken again
            prof = profile_host_device(call)
            if "masked_loop_kernel" in prof["port_kernels"]:
                break
        per_call = {p: ms / count for p, (ms, count) in prof["port_kernels"].items() if count}
        out[f"center_loop:{mode}"] = {
            "ms": cuda_time_ms(lambda: kernels.center_loop(x, z0, **loop), iters=5, warmup=1),
            "plain_ms": cuda_time_ms(lambda: kernels.center_loop_plain(x, z0, **loop), iters=1,
                                     warmup=1),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "shape": [n, d],
            "valid_rows": int(valid.sum()), "steps": LOOP_STEPS, "reads_bound_ms": reads_ms,
            "device_ms": {k: v for k, v in per_call.items() if k == "masked_loop_kernel"},
            "call": {"device_ms": prof["device_ms_per_step"],
                     "device_launches": prof["device_launches_per_step"],
                     "port_kernels": prof["port_kernels"]},
        }
    # the loop the masked centred clipping replaced (the PyTorch loop it
    # still runs above 128 rows: a row reduction, B11 and PyTorch's
    # elementwise kernels a step): device time and launches a call by
    # torch.profiler
    clip = out["center_loop:masked_clip"]
    v0 = robust.masked_mean(x, valid)
    loop_v = kernels.center_loop(x, v0, mode="masked_clip", valid=valid, c_tau=c_tau,
                                 max_iter=LOOP_STEPS)[0]

    def python_loop():
        return robust._masked_clip_steps(x, valid, v0, c_tau=c_tau, M=LOOP_STEPS, eps=1e-12)

    check(bits_equal(python_loop(), loop_v),
          f"the masked clipping loop differs from the Python loop it replaced at {(n, d)}")
    old = profile_host_device(python_loop)
    clip["python_loop"] = {
        "ms": cuda_time_ms(python_loop, iters=5, warmup=1),
        "device_ms": old["device_ms_per_step"], "device_launches": old["device_launches_per_step"],
        "port_kernels": old["port_kernels"]}
    for key, v in out.items():
        log(f"  {key} {v['shape']}: {v['ms']:.4f} ms (device {json.dumps(v['device_ms'])}), bound "
            f"{v['bound_ms']:.4f} ms ({v['bound_by']}), plain {v['plain_ms']:.4f} ms, library "
            f"{v['library_ms']}" + (f", cdist {v['cdist_ms']:.4f} ms, no centre "
                                    f"{v['no_centre_ms']:.4f} ms" if "cdist_ms" in v else "")
            + (f", {v['steps']} steps (a read of x a step and one more: {v['reads_bound_ms']:.4f} "
               f"ms)" if "steps" in v else "")
            + (f"; the whole call {json.dumps(v['call'])}" if "call" in v else "")
            + (f"; the Python loop it replaced {json.dumps(v['python_loop'])}"
               if "python_loop" in v else ""))
    del x, w, z, v0, loop_v, valid
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
            out[name]["iterations"] = int(robust.last_iterations[loop])
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
            "sweep_library_ms", "device_ms", "fold_round", "valid_rows")
    for k, v in out.items():
        v["main_path_shape"] = {key: main[k][key] for key in keys if key in main[k]}
    # B2, B11 and the row reduction: the serving path's largest bucket,
    # 64 x 421,642, is their main-path shape
    masked = masked_kernel_times(*HEADLINE, seed=41)
    serve = masked_kernel_times(SERVE_CAP, 421_642, seed=43)
    for k, v in masked.items():
        v["main_path_shape"] = {key: serve[k][key]
                                for key in keys + ("cdist_ms", "no_centre_ms", "call", "python_loop")
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
    # B7's masked modes: the serving path's masked geometric median and
    # masked centred clipping (phase 4c) and their compiled serving steps
    # (phase 4e (y))
    ("center_loop:masked_weiszfeld", "byzpy_tpu_torch/csrc/center_step.cu",
     "byzpy_tpu/ops/robust.py:1581 (masked_geometric_median's while_loop, plain XLA, around "
     "the step of pallas_kernels.py:470; no Pallas kernel of its own)"),
    ("center_loop:masked_clip", "byzpy_tpu_torch/csrc/center_step.cu",
     "byzpy_tpu/ops/robust.py:1623 (masked_centered_clipping's fori_loop, plain XLA; no Pallas "
     "kernel of its own)"),
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
               "center_loop:weiszfeld", "center_loop:clip", "center_loop:masked_weiszfeld",
               "center_loop:masked_clip",
               "graph_replay:gossip_train_step")
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


PHASES = ("3", "4", "4b", "4c", "4d", "4e", "4f", "4g", "4h", "5", "4i", "4j", "4k", "4l")
MAIN_PATH_PHASES = ("4", "4b", "4c", "4d", "4e", "4f", "4g", "4h")


def selected_phases(argv) -> set:
    """``--phases 4j,4k`` picks phases (1 and 2, the device and the build,
    always run); no argument runs every phase."""
    import argparse

    parser = argparse.ArgumentParser(description="Drive the port on one NVIDIA GPU.")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated phases of {', '.join(PHASES)} (default: all)")
    chosen = {p.strip() for p in parser.parse_args(argv).phases.split(",") if p.strip()}
    unknown = chosen - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")
    return chosen


def main(argv=None) -> int:
    phases = selected_phases(sys.argv[1:] if argv is None else argv)
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
                                                   ("center_loop_kernel", "masked_loop_kernel"))))
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

    errs = {key: 0.0 for key, _, _ in KERNELS}
    if "3" in phases:
        log("== 3. kernels against their plain versions")
        for fn in (check_sorted_reduce, check_gram_and_selection, check_gram_order,
                   check_selection_from_gram, check_pre_aggregation, check_b9_ties,
                   check_selection_ties, check_meamed, check_center_step, check_codecs,
                   check_masked_kernels, check_masked_center_loop, check_s4_codec,
                   check_segment_sum_dequant, check_segmented_sort):
            fn(errs)

    counts = {k: 0 for k in kernels.launch_counts}
    main_path_phases = (
        ("4", "main path: SmallCNN PS round, plain, pre-aggregated, centre-seeking and class-API "
              "configurations", "MAIN_PATH", lambda: main_path(counts)),
        ("4b", "main path: the gossip round (SmallCNN)", "GOSSIP_PATH", lambda: gossip_path(counts)),
        ("4c", "main path: the serving round (SmallCNN, bucketed cohorts, masked aggregators)",
         "SERVING_PATH", lambda: serving_path(counts)),
        ("4d", "main path: the ragged door (SmallCNN: (m) the ragged serving step, (n) the ragged "
               "executor with quantized ingress)", "RAGGED_PATH",
         lambda: {"m_ragged_serving_step": ragged_step_path(counts),
                  "n_ragged_executor": ragged_executor_path(counts)}),
        ("4e", "main path: the compiled step (CUDA-graph twins against the eager steps: (u) "
               "ResNet-50 config #5, (v) ResNet-18, (w) SmallCNN, (x) serving; (y) refusals)",
         "COMPILED_PATH", lambda: compiled_path(counts)),
        ("4f", "main path: the engine (actor pools: (a) config #1, (b) config #2, (c) ByzPy's pool "
               "table, (d) the schedulers, (e) many streams and the capture guard)", "ENGINE_PATH",
         lambda: engine_path(counts)),
        ("4g", "main path: the orchestrators (node actors: (a) config #3, (b) the ParameterServer "
               "on SmallCNN, (c) elastic rounds; the P2P runner: (d) gossip, (e) the autonomous "
               "cluster, (f) heartbeat removal)", "ORCHESTRATOR_PATH",
         lambda: orchestrator_path(counts)),
        ("4h", "main path: BASELINE config #4 (P2P ResNet-18 on ring(8, 2), NNM + geometric "
               "median) through the compiled gossip step", "CONFIG4_PATH",
         lambda: config4_path(counts, smi)),
    )
    for phase, title, tag, run in main_path_phases:
        if phase in phases:
            log(f"== {phase}. {title}")
            log(f"{tag} " + json.dumps(run()))
    if set(MAIN_PATH_PHASES) <= phases:
        for key in NEW_KERNELS:
            check(counts[key] > 0, f"{key} never launched on the main path")
    for key, parts in CODEC_COUNTERS.items():
        counts[key] = sum(counts[p] for p in parts)

    times = None
    if "5" in phases:
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
    # phase 4i runs after the timing: its child processes and threads stay
    # out of phase 5's profiles; its launches count with the main path's
    if "4i" in phases:
        log("== 4i. more than 128 rows ((a) every family at 129-512 x 65,536 against the CPU, the "
            "captured step, the ragged executor at 256) and the out-of-process tier ((b) ByzPy's "
            "pool table on process pools of 2 and 4; (c) configs #1, #2 on the pool of 4; (d) "
            "process_mnist; (e) remote_tcp behind a wire key; (f) P2P on ProcessContext); " + smi)
        log("WIDE_PROCESS_PATH " + json.dumps(wide_process_path(counts)))
    # phases 4j and 4k last: their children and process groups stay out of
    # the earlier phases; their launches count with the main path's
    if "4j" in phases:
        log("== 4j. the rest of the engine and the device mesh ((a) the legacy runtime: "
            "NodeRunner children and StepParameterServer; (b) MeshRemoteContext; (c) the CLI; (d) "
            "the mesh PS round on one NCCL rank, ResNet-18 for CIFAR; (e) 2 and 4 gloo ranks on "
            "the card); " + smi)
        log("ENGINE_MESH_PATH " + json.dumps(engine_mesh_path(counts, smi)))
    if "4k" in phases:
        log("== 4k. the training mesh ((a) jit_ps_train_step(mesh=) on one NCCL rank, ResNet-18; "
            "(b) the gossip round over the mesh, update_sharding off and on, and compiled; (e) "
            "ParameterServer(update_sharding='on'); (c) the ring and its shard split on 4 gloo "
            "ranks, ResNet-18; (d) the (2, 2) grid round on 4 gloo ranks, SmallCNN); " + smi)
        log("TRAINING_MESH_PATH " + json.dumps(training_mesh_path(counts, smi)))
    if "4l" in phases:
        log("== 4l. the serving frontend (ServingFrontend at SmallCNN's width: (a) four tenants, "
            "trimmed mean, median, Multi-Krum with forensics and the geometric median, cohorts of "
            "6, 13, 29 and 64 with 2 sign-flipped clients, 5 rounds each, the ragged door on; (b) "
            "the same, bucketed; (c) serve() and ServingClient over loopback TCP, 16 clients, wire "
            "off, int8 and s4; (d) WAL, snapshots and recover; (e) ResNet-18's width, 8 clients); "
            + smi)
        log("FRONTEND_PATH " + json.dumps(frontend_path(counts, smi)))

    if times is None or "3" not in phases:
        # a partial run prints no kernels line: its numbers would be partial
        print(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count},
                          "phases": sorted(phases)}))
        return 0
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
