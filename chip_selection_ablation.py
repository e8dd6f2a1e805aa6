#!/usr/bin/env python3
"""Take the selection family's weights blocks and B6 apart on one NVIDIA
GPU: B4's weights (Multi-Krum, CGE, MoNNA; ``byzpy_tpu_torch/csrc/selection.cu``),
B10's (clip and ARC in front of them; ``csrc/clip_selection.cu``) and B9's
(NNM in front of them; ``csrc/nnm.cu``), all block-wide on
``csrc/selection_block.cuh``, and MeaMed on the column-sort engine
(``csrc/meamed.cu`` on ``csrc/column_sort.cuh``).

Run from the repository root on a machine with a card and ``nvcc``:

    python3 chip_selection_ablation.py [--before DIR] [--kinds b4,b10,b9,b6,b8,b5]

It builds each kernel as it is and variants of the same sources (text
patches), each into its own library under
``byzpy_tpu_torch/_build/selection_ablation/``. B4's and B10's:

* ``threads_256`` / ``threads_1024``: at most 256 / 1,024 threads a block
  in place of 512;
* ``launch_only``: every block returns at once (the launch of the block
  shape with its shared memory: the floor of a call);
* ``narrow``: at 8 and 16 rows (NPAD <= 16) the per-thread instance, one
  thread a node that sorts its column in registers and counts its rank in
  an n-long loop (the design the block-wide kernel replaced);
* ``unpadded_keys``: Krum's keys in rows of NPAD + 1 words with a warp's
  columns consecutive, in place of KeySort's padded layout (from 64 rows
  on, a warp's loads and stores of its columns then share banks);
* B10's ``formed_on_staging``: each thread's tile of the Gram loaded once
  the clip factors are known, each entry (c_i c_j) G_ij formed as it
  lands, in place of loaded first and clipped in registers.

B9's:

* ``threads_256`` / ``threads_512``: at most 256 / 512 threads a block in
  place of 1,024 (a thread takes a larger tile of each phase);
* ``rank_select``: NNM's selection by stable ranks, in place of a warp's
  sort of each mixer's column: every thread counts, for its tile of (row,
  mixer) pairs, the keys of the mixer's column below the row's key (or
  equal and in an earlier row) and takes the row when fewer than k are;
* ``launch_only``: as B4's;

B6's (f32 instances only):

* ``min_blocks_4``: registers for four blocks an SM (96 a thread, B1's)
  in place of three (128);
* ``cut_rotation``: up to 64 rows, the sorted keys stay in registers, the
  median is picked by compile-time selects and the cut read through a
  copy of the keys rotated by k - 1 (a barrel shifter of log2 N stages);
  the stage is released once the keys are in registers, as B1 releases it,
  and the column is read again from device memory;
* ``column_from_stage``: ``cut_rotation``'s cut, and the column read in
  node order from the stage, which is held until the select is done;
* ``two_buffers``: the engine's ring of two stage buffers, as B1's, in
  place of B6's one;
* ``waves_2``: the kernel as it is, runs half as long;
* ``evict_last``: the producer's bulk copies with an L2 evict-last policy,
  so the column is still in L2 when the select reads it again;

B8's selection state (``nnm_weights_kernel``, ``csrc/nnm.cu``):

* ``threads_256`` / ``threads_1024``: at most 256 / 1,024 threads a block
  in place of 512;
* ``warp_sort``: from 16 rows on, a warp's bitonic sort of each mixer's
  column across its lanes (``WarpSort``, keys in rows of NPAD + 1 words)
  and ballots, as B9's selection, in place of KeySort's runs in a padded
  buffer;
* ``no_mask``: the sort and the bits only, the mask not written;
* ``launch_only``: as B4's;

B5, the Multi-Krum fold's finalize in one launch
(``selection_mean_from_gram_kernel``, ``csrc/selection.cu``):

* ``rows_2`` / ``rows_8``: 2 / 8 rows' loads in flight a thread in place
  of 4;
* ``slots_1`` / ``slots_2``: 1 / 2 slots of 16 bytes a thread at once at
  every width, in place of 2 where every block computes the weights (up
  to 8 rows) and 1 above;
* ``one_replica``: one copy of the published selection in place of 8 (every
  waiting block polls one line);
* ``ticket_at_8``: at 8 rows the ticket and the published selection, in
  place of every block computing the weights itself;
* ``bounds_no_min``: the launch bounds without a block count (ptxas then
  holds some 16-bit instances to 40 registers and spills);
* ``scalar_loads``: every row read an element at a time, in place of the
  widest load its start allows;
* ``prefetch_wait``: every block first asks L2 for its first slot of every
  row, before it waits for the weights;
* ``no_sweep``: the weights, their publication and the wait only;
* ``pdl``: B4's two kernels (weights, then the row sweep) joined by
  Hopper's programmatic dependent launch, in place of one kernel (how
  much of the gain is the launch gap alone);
* ``two_launches``: B4's two kernels as they are, launched one after the
  other (B5 before this design);

and, with ``--before DIR`` (a ``csrc`` directory of an older tree), that
tree's ``selection.cu``, ``clip_selection.cu``, ``nnm.cu`` and ``meamed.cu``
as ``before`` (B5's ``before``: that tree's two launches). It prints ptxas's registers and spills of every build, then
times each with CUDA events and torch.profiler's device time (the main
path's calls are shorter than a launch gap): B4's and B10's weights in
every mode on B3's Gram of one round of n = 8 (f = 2, q = 4: the main
path's), 16, 64 and 128 rows (f = n / 8, q = 3 n / 16; cge and monna at f
= 0, q = n - n / 8, as ``robust.cge`` and ``robust.monna`` call them;
tau the median norm, ARC's f = n / 8); B9's weights on a Gram of n = 8, 64
and 128 rows (f_nnm = f = n / 8, q = 3 n / 16; the main path's 8 rows at f
= 2, q = 4); B6 on f32 rounds of 64 x 1,048,576 (f = 8), 8 x 421,642 (f
= 2) and 128 x 421,642 (f = 40), beside a copy of the rows; B8's selection
state on the Gram of 8, 64 and 128 rows (k = n - 2 at 8 rows, n - n / 8
above); and B5 (krum) at 8 x 421,642 (f = 2, q = 4), 64 x 1,048,576 (f =
8, q = 12) in f32 and bf16, and 128 x 421,642 (f = 16, q = 24), beside its
bound (the Gram and the q rows read once, the output written once). Every
variant that computes the result is checked bit for bit against the plain
version. One JSON object a line; the card's name and power limit first.
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
NNM, BLOCK, MEAMED, ENGINE = "nnm.cu", "selection_block.cuh", "meamed.cu", "column_sort.cuh"
SEL, CLIP = "selection.cu", "clip_selection.cu"
# each kind's source, C entry point and kernels (ptxas lines, profiler rows)
SOURCE = {"b4": SEL, "b10": CLIP, "b9": NNM, "b6": MEAMED, "b8": NNM, "b5": SEL}
ENTRY = {"b4": "byz_selection_weights", "b10": "byz_clip_selection_weights",
         "b9": "byz_nnm_selection_weights", "b6": "byz_meamed", "b8": "byz_nnm_weights",
         "b5": "byz_selection_mean_from_gram"}
KERNEL = {"b4": ("selection_weights_kernel", "narrow_weights_kernel"),
          "b10": ("clip_selection_weights_kernel", "narrow_clip_kernel"),
          "b9": ("nnm_selection_weights_kernel",), "b6": ("meamed_kernel",),
          "b8": ("nnm_weights_kernel", "nnm_selection_weights_kernel"),
          "b5": ("selection_mean_from_gram_kernel", "selection_weights_kernel", "weighted_rows_kernel")}

# The per-thread instance (the design the block-wide weights replaced): one
# block of NPAD threads a round, thread j owning node j, its column's keys
# sorted in registers, its rank counted in an n-long loop.
NARROW_WEIGHT = """// (narrow) node j = threadIdx.x's weight, one thread a node
template <int NPAD, typename Gram>
__device__ float narrow_weight(const Gram& gat, int n, int f, int q, int mode, int ref) {
  __shared__ float norms[NPAD];
  __shared__ float score_s[NPAD];
  __shared__ int bad_s[NPAD];
  const int j = threadIdx.x;
  norms[j] = (j < n) ? gat(j, j) : 0.0f;
  __syncthreads();
  float score = 0.0f;
  if (j < n) {
    if (mode == kCge) {
      score = norms[j];
    } else if (mode == kMonna) {
      score = sq_dist(norms[ref], norms[j], gat(ref, j));
    } else {
      int32_t keys[NPAD];
#pragma unroll
      for (int i = 0; i < NPAD; ++i) {
        keys[i] = PAD_KEY;
        if (i < n) keys[i] = float_sort_key(sq_dist(norms[i], norms[j], gat(i, j)));
      }
      batcher_sort<NPAD>(keys);
#pragma unroll
      for (int i = 0; i < NPAD; ++i)
        if (i >= 1 && i < n - f) score = __fadd_rn(score, key_to_float(keys[i]));
    }
  }
  const int bad = (j >= n || isnan(score)) ? 1 : 0;
  score_s[j] = bad ? 0.0f : score;
  bad_s[j] = bad;
  __syncthreads();
  if (j >= n) return 0.0f;
  const float sj = score_s[j];
  int rank = 0;
  for (int c = 0; c < NPAD; ++c) {
    const int bc = bad_s[c];
    const float sc = score_s[c];
    rank += ((!bc && bad) || (bc == bad && (sc < sj || (sc == sj && c < j)))) ? 1 : 0;
  }
  return (rank < q) ? 1.0f / (float)q : 0.0f;
}

"""
NARROW_B4 = NARROW_WEIGHT + """template <int NPAD>
__global__ void __launch_bounds__(NPAD)
narrow_weights_kernel(const float* __restrict__ gram, float* __restrict__ w, int n, int f, int q,
                      int mode, int ref) {
  const float wj = narrow_weight<NPAD>(DenseGram{gram + (long long)blockIdx.x * n * n, n}, n, f, q,
                                       mode, ref);
  if (threadIdx.x < n) w[(long long)blockIdx.x * n + threadIdx.x] = wj;
}

"""
NARROW_B10 = NARROW_WEIGHT + """struct NarrowClipped {
  const float* g;
  const float* c;
  int n;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return __fmul_rn(__fmul_rn(c[i], c[j]), g[i * n + j]);
  }
};

template <int NPAD>
__global__ void __launch_bounds__(NPAD)
narrow_clip_kernel(const float* __restrict__ gram, float* __restrict__ w, int n, int pre,
                   float tau, int cut_off, int f, int q, int mode, int ref) {
  __shared__ int32_t key_s[NPAD];
  __shared__ float cfac[NPAD];
  __shared__ float threshold;
  __shared__ int picked_bad;
  const int r = blockIdx.x, i = threadIdx.x;
  const float* g = gram + (long long)r * n * n;
  float norm = 0.0f;
  if (i < n) {
    const float sq = g[i * n + i];
    norm = __fsqrt_rn(sq < 0.0f ? 0.0f : sq);
  }
  key_s[i] = (i < n) ? float_sort_key(norm) : PAD_KEY;
  if (i == 0) {
    threshold = tau;
    picked_bad = 0;
  }
  __syncthreads();
  if (pre == kArc && i < n) {
    const int32_t ki = key_s[i];
    int rank = 0;
    for (int l = 0; l < n; ++l) {
      const int32_t kl = key_s[l];
      rank += (kl < ki || (kl == ki && l < i)) ? 1 : 0;
    }
    if (rank == cut_off - 1) threshold = key_to_float(ki);
  }
  __syncthreads();
  float c = 0.0f;
  if (i < n) {
    const float den = isnan(norm) ? norm : fmaxf(norm, 1e-12f);
    const float ratio = __fdiv_rn(threshold, den);
    c = isnan(ratio) ? ratio : fminf(1.0f, ratio);
  }
  cfac[i] = c;
  __syncthreads();
  const float ws = narrow_weight<NPAD>(NarrowClipped{g, cfac, n}, n, f, q, mode, ref);
  const bool bad = i < n && !isfinite(norm);
  if (ws > 0.0f && bad) atomicOr(&picked_bad, 1);
  __syncthreads();
  if (i >= n) return;
  w[(long long)r * n + i] = picked_bad ? __int_as_float(0x7FC00000) : (bad ? 0.0f : __fmul_rn(ws, c));
}

"""
B4_LAUNCH_ANCHOR = "// One launch of B4's weights at width NPAD"
B10_LAUNCH_ANCHOR = "// One launch of B10's weights at width NPAD"
B4_NARROW_CASES = (
    "    case 8: return launch_weights<8>(gram, w, K, n, f, q, mode, ref, s);\n"
    "    case 16: return launch_weights<16>(gram, w, K, n, f, q, mode, ref, s);\n",
    "    case 8: narrow_weights_kernel<8><<<K, 8, 0, s>>>(gram, w, n, f, q, mode, ref); return cudaGetLastError();\n"
    "    case 16: narrow_weights_kernel<16><<<K, 16, 0, s>>>(gram, w, n, f, q, mode, ref); return cudaGetLastError();\n")
B10_NARROW_CASES = (
    "    case 8: return launch_weights<8>(gram, w, K, n, pre, tau, cut_off, f, q, mode, ref, s);\n"
    "    case 16: return launch_weights<16>(gram, w, K, n, pre, tau, cut_off, f, q, mode, ref, s);\n",
    "    case 8: narrow_clip_kernel<8><<<K, 8, 0, s>>>(gram, w, n, pre, tau, cut_off, f, q, mode, ref); "
    "return cudaGetLastError();\n"
    "    case 16: narrow_clip_kernel<16><<<K, 16, 0, s>>>(gram, w, n, pre, tau, cut_off, f, q, mode, ref); "
    "return cudaGetLastError();\n")
# B10's tile loaded once the clip factors are known, each entry (c_i c_j)
# G_ij formed as it lands, in place of loaded first and clipped in
# registers as the scores read it
EARLY_TILE = "  if constexpr (KRUM && NPAD > 8) selblock::load_tile<S>(DenseGram{g, n}, n, tile);\n"
CLIP_IN_REGISTERS = """  if constexpr (KRUM && NPAD > 8) {
    const int a = t / S::TB, b = t % S::TB;
#pragma unroll
    for (int rr = 0; rr < S::RA; ++rr)
#pragma unroll
      for (int cc = 0; cc < S::RB; ++cc)
        tile[rr][cc] = __fmul_rn(__fmul_rn(cfac[a + S::TA * rr], cfac[b + S::TB * cc]), tile[rr][cc]);
  }
"""
CLIP_ON_STAGING = "  if constexpr (KRUM && NPAD > 8) selblock::load_tile<S>(clipped, n, tile);  // (formed_on_staging)\n"
# Krum's keys in square rows of NPAD + 1 words, a warp's columns consecutive
UNPADDED = [(BLOCK, "  static constexpr int SP = (NPAD + NPAD / R) | 1;", "  static constexpr int SP = NPAD + 1;"),
            (BLOCK, "return j * SP + e + e / R;", "return j * SP + e;"),
            (BLOCK, "return j * SP + le * (R + 1);", "return j * SP + le * R;"),
            (BLOCK, "return G == 1 ? c : (c & ~31) | ((c % CPW) * (32 / CPW)) | ((c / CPW) % (32 / CPW));",
             "return c;")]
RANK_BLOCK_START = "  // mixer i takes row j iff fewer than k keys of column i come before it"
RANK_BLOCK_END = "  // GA[j][i] = sum over the clean rows l mixer i took"
# NNM's selection by stable ranks: thread (a, b) counts, for its rows j = a +
# TA r of mixers i = b + TB c, the keys of column i below key j (<= before
# row j, < from it on) over a loop of l, and sets the bit when the count is
# below k
RANK_SELECT = """  // (rank_select) row j is taken by mixer i iff its stable rank in column i is below k
  {
    int32_t th[S::RA][S::RB];
    int rank[S::RA][S::RB];
#pragma unroll
    for (int r = 0; r < S::RA; ++r)
#pragma unroll
      for (int c = 0; c < S::RB; ++c) {
        th[r][c] = keys[(b + S::TB * c) * SP + a + S::TA * r] + 1;
        rank[r][c] = 0;
      }
    int l = 0;
#pragma unroll
    for (int r = 0; r <= S::RA; ++r) {
      const int end = r < S::RA ? min(a + S::TA * r, n) : n;
#pragma unroll 4
      for (; l < end; ++l) {
        int32_t v[S::RB];
#pragma unroll
        for (int c = 0; c < S::RB; ++c) v[c] = keys[(b + S::TB * c) * SP + l];
#pragma unroll
        for (int r2 = 0; r2 < S::RA; ++r2)
#pragma unroll
          for (int c = 0; c < S::RB; ++c) rank[r2][c] += v[c] < th[r2][c] ? 1 : 0;
      }
      if (r < S::RA) {
#pragma unroll
        for (int c = 0; c < S::RB; ++c) th[r][c] -= 1;
      }
    }
#pragma unroll
    for (int r = 0; r < S::RA; ++r)
#pragma unroll
      for (int c = 0; c < S::RB; ++c) {
        const int j = a + S::TA * r, i = b + S::TB * c;
        if (j < n && i < n && rank[r][c] < k) atomicOr(&sel[i * W + (j >> 5)], 1u << (j & 31));
      }
  }
  __syncthreads();

"""
# the rotation cut, as a MeaMed method: the median by compile-time selects
# and the cut through a copy of the keys rotated by k - 1
ROTATION_METHOD = """  template <int N>
  __device__ __forceinline__ void sorted_in_registers(const int32_t (&key)[N]) {
    const float qnan = __int_as_float(0x7FC00000), inf = __int_as_float(0x7F800000);
    const int k = n - f, lo = (n - 1) / 2, hi = n / 2;
    int32_t klo = key[0], khi = key[0], klast = key[0];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (r == lo) klo = key[r];
      if (r == hi) khi = key[r];
      if (r == n - 1) klast = key[r];
    }
    med = K::value(klo);
    if (lo != hi) med = __fadd_rn(__fmul_rn(med, 0.5f), __fmul_rn(K::value(khi), 0.5f));
    if (isnan(K::value(klast))) med = qnan;
    if (isfinite(med)) {
      int32_t rot[N];
#pragma unroll
      for (int r = 0; r < N; ++r) rot[r] = key[r];
#pragma unroll
      for (int lb = 0; lb < ilog2(N); ++lb) {
        if (((k - 1) >> lb) & 1) {
#pragma unroll
          for (int r = 0; r < N; ++r)
            if (r + (1 << lb) < N) rot[r] = rot[r + (1 << lb)];
        }
      }
      cut = inf;
#pragma unroll
      for (int s = 0; s < N; ++s) {
        if (s <= f) {
          const float below = __fsub_rn(med, K::value(key[s]));
          const float above = __fsub_rn(K::value(rot[s]), med);
          cut = nan_min(cut, nan_max(below, above));
        }
      }
    } else {
      int finite_devs = 0;
#pragma unroll
      for (int r = 0; r < N; ++r)
        if (r < n) finite_devs += isnan(fabsf(__fsub_rn(K::value(key[r]), med))) ? 0 : 1;
      cut = (finite_devs >= k) ? inf : qnan;
    }
    int below = 0;
#pragma unroll
    for (int r = 0; r < N; ++r)
      below += r < n && fabsf(__fsub_rn(K::value(key[r]), med)) < cut ? 1 : 0;
    quota = k - below;
  }

  // x_col: row 0 of this column in x, rows d apart."""
NARROW_COLUMN = """    if constexpr (Red::kColumn) {
      // the stage holds the sorted keys until the reduce has read them
      Red red = red0;
      if (c < c1) {
        batcher_sort<N>(k);
        store_staged<K, N, RS>(k, base, m);
        const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(x + row0 * d + c0)) & 15u;
        red.sorted(StagedKeys<K, RS>{ring.stage(j) + tid * (unsigned)sizeof(T), a,
                                     static_cast<unsigned>(d * (long long)sizeof(T)) & 15u},
                   k);
      }
      fence_proxy_async();  // the keys written back, before the next bulk copy lands
      consume_release(ring, j, steps);
      if (c < c1) out[c] = red.value(x + row0 * d + c, d);
    }"""
NARROW_ROTATION = """    if constexpr (Red::kColumn) {
      consume_release(ring, j, steps);
      if (c < c1) {
        batcher_sort<N>(k);
        Red red = red0;
        red.template sorted_in_registers<N>(k);
        out[c] = red.value(x + row0 * d + c, d);
      }
    }"""
NARROW_FROM_STAGE = """    if constexpr (Red::kColumn) {
      if (c < c1) {
        batcher_sort<N>(k);
        Red red = red0;
        red.template sorted_in_registers<N>(k);
        const unsigned col = ring.stage(j) + tid * (unsigned)sizeof(T);
        const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(x + row0 * d + c0)) & 15u;
        const unsigned e = static_cast<unsigned>(d * (long long)sizeof(T)) & 15u;
        out[c] = red.select([=](int i) {
          return __int_as_float(lds<int32_t>(col + ((a + i * e) & 15u) + i * RS));
        });
      }
      consume_release(ring, j, steps);
    }"""
BULK_COPY = """  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(mbar) : "memory");"""
BULK_COPY_EVICT_LAST = """  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\\n" : "=l"(policy));
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;\\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(mbar), "l"(policy) : "memory");"""
MEAMED_F32_ONLY = [
    (MEAMED, "    case kBF16: return launch<__nv_bfloat16>(x, out, K, n, d, f, run_tiles, s);\n", ""),
    (MEAMED, "    case kF16: return launch<__half>(x, out, K, n, d, f, run_tiles, s);\n", ""),
    (MEAMED, "    case kBF16: return launch<__nv_bfloat16>(x, out, K, n, d, f, s);\n", ""),
    (MEAMED, "    case kF16: return launch<__half>(x, out, K, n, d, f, s);\n", ""),
]
ROTATION = [(MEAMED, "  // x_col: row 0 of this column in x, rows d apart.", ROTATION_METHOD)]
# B8 by a warp's sort of each mixer's column (B9's selection), keys in rows
# of NPAD + 1 words
B8_SORT_START = "  // the lanes of a column group sort mixer i's column, then take its rows\n"
B8_SORT_END = "  // mask[j][i] from the bits: lane l of a warp takes mixer i = 32 ib + l and\n"
B8_WARP_SORT = """    // (warp_sort) a warp sorts mixer i's column across its lanes; ballots take the rows
    const int lane = t & 31;
    {
      using WS = selblock::WarpSort<NPAD>;
      const int le = lane % WS::G, grp = lane / WS::G;
      const unsigned mine = WS::G == 32 ? 0xFFFFFFFFu : ((1u << WS::G) - 1u) << (grp * WS::G);
      for (int i0 = (t >> 5) * WS::CPW; i0 < n; i0 += (S::T / 32) * WS::CPW) {
        const int i = i0 + grp;
        int32_t v[WS::R], o[WS::R];
#pragma unroll
        for (int r = 0; r < WS::R; ++r) {
          o[r] = keys[i * (NPAD + 1) + r * WS::G + le];
          v[r] = o[r];
        }
        WS::sort(v, lane);
        int32_t at = v[0];
#pragma unroll
        for (int r = 1; r < WS::R; ++r)
          if (r == (k - 1) / WS::G) at = v[r];
        const int32_t cut = __shfl_sync(0xFFFFFFFFu, at, grp * WS::G + (k - 1) % WS::G);
        int quota = k;
#pragma unroll
        for (int r = 0; r < WS::R; ++r) quota -= __popc(__ballot_sync(0xFFFFFFFFu, o[r] < cut) & mine);
#pragma unroll
        for (int r = 0; r < WS::R; ++r) {
          const unsigned eq = __ballot_sync(0xFFFFFFFFu, o[r] == cut) & mine;
          const bool take = o[r] < cut || (o[r] == cut && __popc(eq & ((1u << lane) - 1u)) < quota);
          quota -= __popc(eq);
          const unsigned bits = __ballot_sync(0xFFFFFFFFu, take) & mine;
          if (le == 0 && i < n) sel[i * WP + r] = bits >> (grp * WS::G);
        }
      }
    }
    __syncthreads();
"""
B8_WARP_SORT_KEYS = [
    (NNM, "return NPAD * selblock::KeySort<NPAD>::SP * (int)sizeof(int32_t);",
     "return NPAD * (NPAD + 1) * (int)sizeof(int32_t);"),
    (NNM, "      keys[KS::addr(i, j)] =", "      keys[i * (NPAD + 1) + j] ="),
    (NNM, (B8_SORT_START, B8_SORT_END), B8_WARP_SORT),
]
# B8 without the mask's stores (the sort and the bits only)
B8_LAUNCH = "// One launch of B8's selection state at width NPAD"
B8_NO_MASK = """  // (no_mask) the bits kept alive, the mask not written
  if (t == 0 && n < 0) m[0] = (float)sel[0];
}

"""
# B5 as B4's two kernels joined by programmatic dependent launch: the
# weights kernel lets the sweep start at once, and the sweep waits for the
# weights before it reads them
B5_PDL_ENTRY = """
template <typename T, int NPAD>
cudaError_t launch_pdl(const T* x, const float* gram, T* out, float* w, int n, long long d, int f,
                       int q, int mode, int ref, cudaStream_t s) {
  cudaError_t err = launch_weights<NPAD>(gram, w, 1, n, f, q, mode, ref, s);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((d + kRowThreads - 1) / kRowThreads), 1);
  cfg.blockDim = dim3(kRowThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, weighted_rows_kernel<T>, x, (const float*)w, out, n, d);
}

template <typename T>
cudaError_t launch_pdl_dtype(const void* x, const float* gram, void* out, float* w, int n, long long d,
                             int f, int q, int mode, int ref, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  switch (network_width(n)) {
    case 8: return launch_pdl<T, 8>(xt, gram, ot, w, n, d, f, q, mode, ref, s);
    case 16: return launch_pdl<T, 16>(xt, gram, ot, w, n, d, f, q, mode, ref, s);
    case 32: return launch_pdl<T, 32>(xt, gram, ot, w, n, d, f, q, mode, ref, s);
    case 64: return launch_pdl<T, 64>(xt, gram, ot, w, n, d, f, q, mode, ref, s);
    case 128: return launch_pdl<T, 128>(xt, gram, ot, w, n, d, f, q, mode, ref, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int byz_selection_mean_from_gram_pdl(const void* x, const float* gram, void* out,
                                                void* scratch, int n, long long d, int f, int q,
                                                int mode, int ref, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = reinterpret_cast<float*>(static_cast<char*>(scratch) + 2048);  // past B5's scratch
  switch (dtype) {
    case kF32: return launch_pdl_dtype<float>(x, gram, out, w, n, d, f, q, mode, ref, s);
    case kBF16: return launch_pdl_dtype<__nv_bfloat16>(x, gram, out, w, n, d, f, q, mode, ref, s);
    case kF16: return launch_pdl_dtype<__half>(x, gram, out, w, n, d, f, q, mode, ref, s);
    default: return cudaErrorInvalidValue;
  }
}
"""
B5_PDL = [
    (SEL, "  const float* g = gram + (long long)blockIdx.x * n * n;\n",
     "  const float* g = gram + (long long)blockIdx.x * n * n;\n"
     "  asm volatile(\"griddepcontrol.launch_dependents;\" ::: \"memory\");\n"),
    (SEL, "  __shared__ float ws[128];\n  const int k = blockIdx.y;\n",
     "  __shared__ float ws[128];\n  const int k = blockIdx.y;\n"
     "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"),
    (SEL, "}  // namespace\n\n// gram: (K, n, n) f32; w: (K, n) f32 out.",
     "}  // namespace\n" + B5_PDL_ENTRY + "\n// gram: (K, n, n) f32; w: (K, n) f32 out."),
]
# the waiting blocks ask L2 for their first slot of every row
B5_WAIT = "  unsigned exits = 0;  // thread 0: the blocks counted out before this one\n"
B5_PREFETCH = B5_WAIT + """  {
    const long long c = ((long long)blockIdx.x * S::T + t) * (16 / (int)sizeof(T));
    if (c < d)
      for (int j = 0; j < n; ++j) asm volatile("prefetch.global.L2 [%0];" ::"l"(x + (long long)j * d + c));
  }
"""
B5_SWEEP = "  sweep_selected<T, S::T, kSweepSlots<NPAD>>(x, out, row_s, weight_s, cnt, d);\n"
# (file, anchor, replacement) for each variant, an anchor a string or a
# (start, end) pair whose text between is replaced; a kind's variants build its SOURCE
SEL_LAUNCH_ONLY = ("  const float* g = gram + (long long)blockIdx.x * n * n;\n",
                   "  const float* g = gram + (long long)blockIdx.x * n * n;\n  if (n > 0) return;\n")
VARIANTS = {
    "b4": {
        "kernel": [],
        "threads_256": [(SEL, "constexpr int kSelThreads = 512;", "constexpr int kSelThreads = 256;")],
        "threads_1024": [(SEL, "constexpr int kSelThreads = 512;", "constexpr int kSelThreads = 1024;")],
        "launch_only": [(SEL, *SEL_LAUNCH_ONLY)],
        "narrow": [(SEL, B4_LAUNCH_ANCHOR, NARROW_B4 + B4_LAUNCH_ANCHOR), (SEL, *B4_NARROW_CASES)],
        "unpadded_keys": UNPADDED,
    },
    "b10": {
        "kernel": [],
        "threads_256": [(CLIP, "constexpr int kSelThreads = 512;", "constexpr int kSelThreads = 256;")],
        "threads_1024": [(CLIP, "constexpr int kSelThreads = 512;", "constexpr int kSelThreads = 1024;")],
        "launch_only": [(CLIP, *SEL_LAUNCH_ONLY)],
        "narrow": [(CLIP, B10_LAUNCH_ANCHOR, NARROW_B10 + B10_LAUNCH_ANCHOR), (CLIP, *B10_NARROW_CASES)],
        "unpadded_keys": UNPADDED,
        "formed_on_staging": [(CLIP, EARLY_TILE, ""), (CLIP, CLIP_IN_REGISTERS, CLIP_ON_STAGING)],
    },
    "b9": {
        "kernel": [],
        "threads_256": [(NNM, "constexpr int kSelThreads = 1024;", "constexpr int kSelThreads = 256;")],
        "threads_512": [(NNM, "constexpr int kSelThreads = 1024;", "constexpr int kSelThreads = 512;")],
        "rank_select": [(NNM, (RANK_BLOCK_START, RANK_BLOCK_END), RANK_SELECT)],
        "launch_only": [(NNM, *SEL_LAUNCH_ONLY)],
    },
    "b6": {
        "kernel": [],
        "min_blocks_4": [(MEAMED, "constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 4;")],
        "cut_rotation": ROTATION + [(ENGINE, NARROW_COLUMN, NARROW_ROTATION)],
        "column_from_stage": ROTATION + [(ENGINE, NARROW_COLUMN, NARROW_FROM_STAGE)],
        "two_buffers": [(MEAMED, "  static constexpr int kRingStages = 1;", "  static constexpr int kRingStages = 2;")],
        "waves_2": [],
        "evict_last": [(ENGINE, BULK_COPY, BULK_COPY_EVICT_LAST)],
    },
    "b8": {
        "kernel": [],
        "threads_256": [(NNM, "constexpr int kNnmThreads = 512;", "constexpr int kNnmThreads = 256;")],
        "threads_1024": [(NNM, "constexpr int kNnmThreads = 512;", "constexpr int kNnmThreads = 1024;")],
        "warp_sort": B8_WARP_SORT_KEYS,
        "no_mask": [(NNM, (B8_SORT_END, B8_LAUNCH), B8_NO_MASK)],
        "launch_only": [(NNM, "  float* m = mask + (long long)blockIdx.x * n * n;\n",
                         "  float* m = mask + (long long)blockIdx.x * n * n;\n  if (n > 0) return;\n")],
    },
    "b5": {
        "kernel": [],
        "rows_2": [(SEL, "constexpr int kSweepRows = 4;", "constexpr int kSweepRows = 2;")],
        "rows_8": [(SEL, "constexpr int kSweepRows = 4;", "constexpr int kSweepRows = 8;")],
        "slots_1": [(SEL, "constexpr int kSweepSlots = NPAD <= kSelfWeightsRows ? 2 : 1;",
                     "constexpr int kSweepSlots = 1;")],
        "slots_2": [(SEL, "constexpr int kSweepSlots = NPAD <= kSelfWeightsRows ? 2 : 1;",
                     "constexpr int kSweepSlots = 2;")],
        "one_replica": [(SEL, "constexpr int kReplicas = 8;", "constexpr int kReplicas = 1;")],
        "ticket_at_8": [(SEL, "constexpr int kSelfWeightsRows = 8;", "constexpr int kSelfWeightsRows = 4;")],
        "bounds_no_min": [(SEL, "__global__ void __launch_bounds__(SelShape<NPAD>::T, 2)\nselection_mean_from_gram_kernel",
                           "__global__ void __launch_bounds__(SelShape<NPAD>::T)\nselection_mean_from_gram_kernel")],
        "scalar_loads": [(SEL, "  return (low & 15u) == 0 ? 16 : (low & 7u) == 0 ? 8 : (low & 3u) == 0 ? 4 : (int)sizeof(T);",
                          "  return (int)sizeof(T);")],
        "prefetch_wait": [(SEL, B5_WAIT, B5_PREFETCH)],
        "no_sweep": [(SEL, B5_SWEEP, "  if (d < 0) " + B5_SWEEP.lstrip())],
        "pdl": B5_PDL,
    },
}
# B5's variants with another entry point
B5_ENTRY = {"pdl": "byz_selection_mean_from_gram_pdl"}
# B6 variants run at runs this many times shorter (kernels.column_runs as if
# the card had this many times its SMs)
RUN_WAVES = {"waves_2": 2}
UNCHECKED = ("launch_only", "no_sweep", "no_mask")
# (label, n, f_nnm, f, q) of B9's Gram
B9_SHAPES = [("main_path", 8, 2, 2, 4), ("n8", 8, 1, 1, 1), ("n64", 64, 8, 8, 12), ("n128", 128, 16, 16, 24)]
# (label, n, f, q) of B4's and B10's Krum (ARC's f = f)
SEL_SHAPES = [("main_path", 8, 2, 4), ("n16", 16, 2, 3), ("n64", 64, 8, 12), ("n128", 128, 16, 24)]
# (label, n, d, f) of B6's single round
B6_SHAPES = [("headline", 64, 1_048_576, 8), ("main_path", 8, 421_642, 2), ("n128", 128, 421_642, 40)]
# (label, n, k) of B8's Gram
B8_SHAPES = [("main_path", 8, 6), ("n64", 64, 56), ("n128", 128, 112)]
# (label, n, d, f, q, dtype) of B5's round
B5_SHAPES = [("main_path", 8, 421_642, 2, 4, "float32"), ("headline", 64, 1_048_576, 8, 12, "float32"),
             ("n128", 128, 421_642, 16, 24, "float32"), ("headline_bf16", 64, 1_048_576, 8, 12, "bfloat16")]


def sources(kind: str, name: str, before: str | None) -> dict:
    """The variant's patched file texts, by file name."""
    src_dir = before if name == "before" else CSRC
    texts = {}
    for fn in os.listdir(src_dir):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(src_dir, fn)) as fh:
                texts[fn] = fh.read()
    for fn, anchor, repl in VARIANTS[kind].get(name, []):
        text = texts.get(fn, "")
        if isinstance(anchor, tuple):  # replace the text from one anchor up to another
            i, j = text.find(anchor[0]), text.find(anchor[1])
            if i < 0 or j < 0:
                raise SystemExit(f"{fn} no longer holds {anchor[0]!r} ... {anchor[1]!r}: update {name!r}")
            texts[fn] = text[:i] + repl + text[j:]
            continue
        if anchor not in text:
            raise SystemExit(f"{fn} no longer holds {anchor!r}: update VARIANTS[{kind!r}][{name!r}]")
        texts[fn] = text.replace(anchor, repl)
    if kind == "b6":
        for fn, anchor, repl in MEAMED_F32_ONLY:
            texts[fn] = texts[fn].replace(anchor, repl)
    return texts


def build(nvcc: str, flags, out_dir: str, before: str | None, kinds) -> dict:
    """Every variant's library of the given kinds, built in parallel:
    (kind, variant) -> (ctypes function, whether it takes the run
    length)."""
    from byzpy_tpu_torch.ops import _build

    procs = {}
    for kind, variants in VARIANTS.items():
        if kind not in kinds:
            continue
        for name in list(variants) + (["before"] if before else []):
            vdir = os.path.join(out_dir, kind, name)
            shutil.rmtree(vdir, ignore_errors=True)
            os.makedirs(vdir)
            texts = sources(kind, name, before)
            for fn, t in texts.items():
                with open(os.path.join(vdir, fn), "w") as fh:
                    fh.write(t)
            src = SOURCE[kind]
            lib = os.path.join(vdir, f"lib{kind}.so")
            cmd = [nvcc, *flags, "-o", lib, os.path.join(vdir, src)]
            procs[(kind, name)] = (lib, "int run_tiles, void* stream" in texts[src],
                                   subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (kind, name), (lib, takes_runs, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:  # a variant that does not build is reported and left out
            print(json.dumps({"kernel": kind, "variant": name, "build_failed": log[-2000:]}), flush=True)
            continue
        regs, fn = [], None
        for line in log.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                fn = line
            if fn and any(k in fn for k in KERNEL[kind]) and ("registers" in line or "spill" in line):
                # the instance's mangled name (cu++filt demangles it), then its line
                regs.append(fn.replace("'", " ").split()[-3 if "entry" in fn else -1] + ": " + line.strip())
        print(json.dumps({"kernel": kind, "variant": name, "ptxas": regs}), flush=True)
        if kind == "b5":  # its entry points are looked up by b5_rows
            fns[(kind, name)] = (ctypes.CDLL(lib), False)
            continue
        entry = ENTRY[kind]
        f = getattr(ctypes.CDLL(lib), entry)
        argtypes = list(_build.SIGNATURES[entry][1])
        if kind == "b6" and not takes_runs:
            del argtypes[-2]  # an older entry point: no run length before the stream
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        fns[(kind, name)] = (f, takes_runs)
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


def device_ms(fn, kernel, calls: int = 20, *, each: bool = False) -> float | None:
    """Device time a launch of ``kernel`` (a name, or a tuple of names: any
    of them) by torch.profiler, or None when the profile recorded none;
    with ``each``, the sum over the names of each one's time a launch (a
    call that launches each of them once)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    us, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for ev in prof.key_averages():
        hit = [k for k in names if k in ev.key] if ev.device_type == DeviceType.CUDA else []
        if hit:
            us[hit[0]] += getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0.0)
            count[hit[0]] += ev.count
    if each:
        if not all(count.values()):
            return None
        return sum(us[k] / count[k] for k in names) / 1e3
    total = sum(count.values())
    return sum(us.values()) / 1e3 / total if total else None


def bits_equal(a, b) -> bool:
    import torch

    ints = torch.int32 if a.element_size() == 4 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


def selection_rows(fns, kind: str) -> None:
    """B4's (``kind`` b4) or B10's (b10) weights in every mode (and B10's
    two clips) on B3's Gram of one round, each variant bit for bit against
    the plain version, timed."""
    import torch

    from byzpy_tpu_torch.ops import kernels
    from byzpy_tpu_torch.ops.preagg import arc_cut_off

    stream = torch.cuda.current_stream().cuda_stream
    codes = {"krum": 0, "cge": 1, "monna": 2}
    for label, n, f, q in SEL_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn((1, n, 421_642), generator=gen, device="cuda")
        x[:, ::3] *= 3.0
        g = kernels.gram(x)
        tau = float(torch.linalg.vector_norm(x, dim=2).median())
        del x
        w = torch.empty((1, n), device="cuda")
        pres = [None] if kind == "b4" else ["clip", "arc"]
        for pre, mode in [(p, m) for p in pres for m in codes]:
            fm, qm = (f, q) if mode == "krum" else (0, n - f)
            sel = dict(f=fm, q=qm, mode=mode, reference_index=0)
            row = {"kernel": kind, "shape": label, "n": n, "f": fm, "q": qm, "mode": mode}
            if pre is None:
                ref = kernels.selection_weights_plain(g, **sel)
                args = (fm, qm, codes[mode], 0)
            else:
                cut_off = arc_cut_off(n, f)
                kw = dict(pre=pre, tau=tau) if pre == "clip" else dict(pre=pre, cut_off=cut_off)
                ref = kernels.clip_selection_weights_plain(g, **kw, **sel)
                args = (int(pre == "arc"), tau, cut_off, fm, qm, codes[mode], 0)
                row.update(pre=pre, tau=tau, cut_off=cut_off)
            for (k, name), (fn, _) in fns.items():
                if k != kind:
                    continue

                def run(fn=fn, name=name):
                    rc = fn(g.data_ptr(), w.data_ptr(), 1, n, *args, stream)
                    if rc:
                        raise RuntimeError(f"{name} returned {rc}")

                run()
                torch.cuda.synchronize()
                if name not in UNCHECKED and not bits_equal(w, ref):
                    raise SystemExit(f"{kind} {name} differs from the plain version at {label} {pre} {mode}")
                row[f"{name}_ms"] = cuda_time_ms(run)
                row[f"{name}_device_ms"] = device_ms(run, KERNEL[kind])
            print(json.dumps(row), flush=True)
        del g
        torch.cuda.empty_cache()


def b9_rows(fns) -> None:
    import torch

    from byzpy_tpu_torch.ops import kernels

    stream = torch.cuda.current_stream().cuda_stream
    for label, n, f_nnm, f, q in B9_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn((1, n, 421_642), generator=gen, device="cuda")
        x[:, ::3] *= 3.0
        g = kernels.gram(x)
        del x
        w = torch.empty((1, n), device="cuda")
        for mode in ("krum", "cge"):
            code = {"krum": 0, "cge": 1}[mode]
            kw = dict(k=n - f_nnm, f=f, q=q, mode=mode, reference_index=0)
            ref = kernels.nnm_selection_weights_plain(g, **kw)
            row = {"kernel": "b9", "shape": label, "n": n, "f_nnm": f_nnm, "f": f, "q": q, "mode": mode}
            for (kind, name), (fn, _) in fns.items():
                if kind != "b9":
                    continue

                def run(fn=fn):
                    rc = fn(g.data_ptr(), w.data_ptr(), 1, n, n - f_nnm, f, q, code, 0, stream)
                    if rc:
                        raise RuntimeError(f"{name} returned {rc}")

                run()
                torch.cuda.synchronize()
                if name not in UNCHECKED and not bits_equal(w, ref):
                    raise SystemExit(f"B9 {name} differs from the plain version at {label} {mode}")
                row[f"{name}_ms"] = cuda_time_ms(run)
                row[f"{name}_device_ms"] = device_ms(run, "nnm_selection_weights_kernel")
            print(json.dumps(row), flush=True)


def b6_rows(fns) -> None:
    import torch

    from byzpy_tpu_torch.ops import kernels

    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, n, d, f in B6_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n + f)
        x = torch.randn((1, n, d), generator=gen, device="cuda")
        x[:, :, ::5] = torch.round(x[:, :, ::5] * 2.0) / 2.0  # ties at the cut
        out = torch.empty((1, d), device="cuda")
        ref = kernels.meamed_stream_plain(x, f=f)
        row = {"kernel": "b6", "shape": [1, n, d], "f": f, "label": label,
               "bytes_bound_ms": (n + 1) * d * 4 / 3.35e9}
        for (kind, name), (fn, takes_runs) in fns.items():
            if kind != "b6":
                continue
            runs = (kernels.column_runs(d, sms * RUN_WAVES.get(name, 1))[0],) if takes_runs else ()

            def run(fn=fn, runs=runs):
                rc = fn(x.data_ptr(), out.data_ptr(), 1, n, d, f, 0, *runs, stream)
                if rc:
                    raise RuntimeError(f"{name} returned {rc}")

            run()
            torch.cuda.synchronize()
            if not bits_equal(out, ref):
                raise SystemExit(f"B6 {name} differs from the plain version at {label}")
            row[f"{name}_ms"] = cuda_time_ms(run)
            row[f"{name}_device_ms"] = device_ms(run, "meamed_kernel")
        y = torch.empty_like(x)
        row["copy_ms"] = cuda_time_ms(lambda: y.copy_(x))
        print(json.dumps(row), flush=True)
        del x, y, out, ref
        torch.cuda.empty_cache()


def gram_of_rows(n: int):
    """B3's Gram of one (1, n, 421,642) f32 round, every third row x3."""
    import torch

    from byzpy_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn((1, n, 421_642), generator=gen, device="cuda")
    x[:, ::3] *= 3.0
    return kernels.gram(x)


def b8_rows(fns) -> None:
    import torch

    from byzpy_tpu_torch.ops import kernels

    stream = torch.cuda.current_stream().cuda_stream
    for label, n, k in B8_SHAPES:
        g = gram_of_rows(n)
        mask, st = torch.empty((1, n, n), device="cuda"), torch.empty((1, n), device="cuda")
        ref_mask, ref_st = kernels.nnm_weights_plain(g, k=k)
        row = {"kernel": "b8", "shape": label, "n": n, "k": k}
        for (kind, name), (fn, _) in fns.items():
            if kind != "b8":
                continue

            def run(fn=fn, name=name):
                rc = fn(g.data_ptr(), mask.data_ptr(), st.data_ptr(), 1, n, k, stream)
                if rc:
                    raise RuntimeError(f"{name} returned {rc}")

            run()
            torch.cuda.synchronize()
            if name not in UNCHECKED and not (torch.equal(mask, ref_mask) and torch.equal(st, ref_st)):
                raise SystemExit(f"B8 {name} differs from the plain version at {label}")
            row[f"{name}_ms"] = cuda_time_ms(run)
            row[f"{name}_device_ms"] = device_ms(run, "nnm_weights_kernel")
        print(json.dumps(row), flush=True)


def b5_rows(fns) -> None:
    """B5 (krum) by each variant on one round and its B3 Gram, bit for bit
    against the plain version; ``two_launches`` (and ``before``) call B4's
    two entry points of that library, weights then sweep."""
    import torch

    from byzpy_tpu_torch.ops import _build, kernels

    stream = torch.cuda.current_stream().cuda_stream
    codes = {"float32": 0, "bfloat16": 1, "float16": 2}
    scratch = torch.zeros((4096,), dtype=torch.uint8, device="cuda")
    variants = [(name, lib) for (kind, name), (lib, _) in fns.items() if kind == "b5"]
    if ("b5", "kernel") in fns:
        variants.append(("two_launches", fns[("b5", "kernel")][0]))
    for label, n, d, f, q, dt in B5_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n + d)
        x = torch.randn((n, d), generator=gen, device="cuda").to(getattr(torch, dt))
        x[::3] *= 3.0
        g = kernels.gram(x[None])[0]
        isz = x.element_size()
        out = torch.empty((d,), dtype=x.dtype, device="cuda")
        w = torch.empty((1, n), device="cuda")
        ref = kernels.selection_mean_from_gram_plain(x, g, f=f, q=q)
        row = {"kernel": "b5", "shape": label, "n": n, "d": d, "f": f, "q": q, "dtype": dt,
               "bytes_bound_ms": (n * n * 4 + q * d * isz + d * isz) / 3.35e9 * 1e3}
        for name, lib in variants:
            if name in ("two_launches", "before"):
                weights, rows = lib.byz_selection_weights, lib.byz_weighted_rows
                weights.argtypes = _build.SIGNATURES["byz_selection_weights"][1]
                rows.argtypes = _build.SIGNATURES["byz_weighted_rows"][1]

                def run(weights=weights, rows=rows, name=name):
                    rc = weights(g.data_ptr(), w.data_ptr(), 1, n, f, q, 0, 0, stream) or rows(
                        x.data_ptr(), w.data_ptr(), out.data_ptr(), 1, n, d, codes[dt], stream)
                    if rc:
                        raise RuntimeError(f"{name} returned {rc}")
                names = ("selection_weights_kernel", "weighted_rows_kernel")
            else:
                fn = getattr(lib, B5_ENTRY.get(name, ENTRY["b5"]))
                fn.argtypes = _build.SIGNATURES[ENTRY["b5"]][1]

                def run(fn=fn, name=name):
                    rc = fn(x.data_ptr(), g.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, d, f, q, 0, 0,
                            codes[dt], stream)
                    if rc:
                        raise RuntimeError(f"{name} returned {rc}")
                names = ("selection_weights_kernel", "weighted_rows_kernel") if name == "pdl" else (
                    "selection_mean_from_gram_kernel",)
            run()
            torch.cuda.synchronize()
            if name not in UNCHECKED and not bits_equal(out, ref):
                raise SystemExit(f"B5 {name} differs from the plain version at {label}")
            row[f"{name}_ms"] = cuda_time_ms(run)
            row[f"{name}_device_ms"] = device_ms(run, names, each=True)
        print(json.dumps(row), flush=True)
        del x, g, out, ref
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--before", help="csrc directory of an older tree, built as 'before'")
    parser.add_argument("--kinds", default="b4,b10,b9,b6,b8,b5",
                        help="kernels to take apart: any of b4, b10, b9, b6, b8, b5, comma-separated")
    args = parser.parse_args()
    kinds = args.kinds.split(",")
    if not set(kinds) <= set(VARIANTS):
        parser.error(f"--kinds takes {', '.join(VARIANTS)}")
    if not torch.cuda.is_available():
        print("chip_selection_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from byzpy_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    if nvcc is None:
        print("chip_selection_ablation: nvcc not found", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    out_dir = str(_build.BUILD_ROOT / "selection_ablation")
    os.makedirs(out_dir, exist_ok=True)
    fns = build(nvcc, _build.NVCC_FLAGS, out_dir, args.before and os.path.abspath(args.before), kinds)
    for kind in ("b4", "b10"):
        if kind in kinds:
            selection_rows(fns, kind)
    if "b9" in kinds:
        b9_rows(fns)
    if "b6" in kinds:
        b6_rows(fns)
    if "b8" in kinds:
        b8_rows(fns)
    if "b5" in kinds:
        b5_rows(fns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
