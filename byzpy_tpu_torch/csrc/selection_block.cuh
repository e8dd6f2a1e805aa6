// Block-wide pieces of the selection family: one block per round works on
// the round's (n, n) problem in shared memory, every thread taking a tile
// of it, where selection.cuh gives each thread one node and its own serial
// loops (sorts in registers, walks over a row of the Gram).
//
// B9's weights (nnm.cu) are built from them. The layout:
//   - a square buffer holds NPAD rows of SP = NPAD + 1 values: the odd row
//     stride puts a row's values and a column's values in distinct banks,
//     so each phase reads whichever way it needs without conflicts;
//   - thread (a, b) of the block's TA x TB grid owns rows a + TA r (r < RA)
//     and columns b + TB c (c < RB); a warp's lanes differ in b, so a loop
//     over l reads one row value for all lanes (a broadcast) or a lane's
//     own column value (consecutive banks);
//   - a selection is a bit mask over rows, W 32-bit words a column;
//   - a column to sort (NNM's selection, Krum's scores) goes to one warp,
//     which sorts it across its lanes (WarpSort).
// What bounds them is one SM's instruction rate: the products are n^3
// predicated adds, spread over up to 1,024 threads, each loaded value
// serving RA or RB of a thread's outputs; the sorts n bitonic networks.
#pragma once

#include "selection.cuh"

namespace selblock {

// The block for an (NPAD, NPAD) problem with at most MAXT threads.
template <int NPAD, int MAXT>
struct Shape {
  static constexpr int T = MAXT < NPAD * NPAD ? MAXT : NPAD * NPAD;
  static constexpr int TB = NPAD < 32 ? NPAD : 32;  // lanes along a row
  static constexpr int TA = T / TB;
  static constexpr int RA = NPAD / TA;  // rows a thread owns
  static constexpr int RB = NPAD / TB;  // columns a thread owns
  static constexpr int SP = NPAD + 1;   // a square buffer's row stride
  static constexpr int W = NPAD < 32 ? 1 : NPAD / 32;  // words of a row mask
  static constexpr int U = NPAD < 32 ? NPAD : 32;      // bits used of a word
  static_assert(TA * TB == T && RA * TA == NPAD && RB * TB == NPAD, "the grid must tile the problem");
  static_assert(T % 32 == 0, "whole warps");
};

// A column of an (n, n) problem sorted across the lanes of one warp:
// Batcher's bitonic network over NPAD keys, element e of the column at
// register e / G of lane e % G of the column's lane group (G = 32 lanes,
// or NPAD of them below 32, 32 / NPAD columns a warp). Compare-exchanges
// between lanes go through shuffles, those within a lane through
// registers. A warp sorts CPW columns at once; a block's warps walk the n
// columns. Loops count by exponents, so they unroll (a loop that shifts
// its counter does not, and moves the registers to local memory).
template <int NPAD>
struct WarpSort {
  static constexpr int R = NPAD < 32 ? 1 : NPAD / 32;  // keys a lane
  static constexpr int G = NPAD < 32 ? NPAD : 32;      // lanes a column
  static constexpr int CPW = 32 / G;                   // columns a warp
  static constexpr int LOG = ilog2(NPAD);

  __device__ static __forceinline__ void sort(int32_t (&v)[R], int lane) {
    const int le = lane % G;
#pragma unroll
    for (int ls = 1; ls <= LOG; ++ls) {
#pragma unroll
      for (int lt = ls - 1; lt >= 0; --lt) {
        const int size = 1 << ls, stride = 1 << lt;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool asc = ((r * G + le) & size) == 0;
          if (stride >= G) {  // the partner is register r ^ (stride / G) of this lane
            const int o = r ^ (stride / G);
            if (o > r) {
              const int32_t lo = v[r], hi = v[o];
              const bool swap = asc ? lo > hi : lo < hi;
              v[r] = swap ? hi : lo;
              v[o] = swap ? lo : hi;
            }
          } else {
            const int32_t o = __shfl_xor_sync(0xFFFFFFFFu, v[r], stride);
            v[r] = ((le & stride) == 0) == asc ? min(v[r], o) : max(v[r], o);
          }
        }
      }
    }
  }
};

// The selection weights of scores held in shared memory (score[j], bad[j]
// for j < n: NaN scores flagged): 1/q for the q lowest, NaN last, ties by
// index (selection.cuh:selection_weight's ranks), into w_sel[j]. rank_s
// (NPAD ints) must be zero on entry. Every thread of the block calls it;
// it synchronizes the block and returns with w_sel written.
template <class S, int NPAD>
__device__ __forceinline__ void weights_of_scores(const float* score, const int* bad, int* rank_s,
                                                  float* w_sel, int n, int q) {
  constexpr int PARTS = S::T / NPAD, CHUNK = NPAD / PARTS;
  const int j = threadIdx.x % NPAD, part = threadIdx.x / NPAD;
  if (j < n) {
    const float sj = score[j];
    const int bj = bad[j];
    int cnt = 0;
    for (int c = part * CHUNK; c < min(n, part * CHUNK + CHUNK); ++c) {
      const int bc = bad[c];
      const float sc = score[c];
      cnt += ((!bc && bj) || (bc == bj && (sc < sj || (sc == sj && c < j)))) ? 1 : 0;
    }
    if (cnt) atomicAdd(&rank_s[j], cnt);
  }
  __syncthreads();
  if (threadIdx.x < n) w_sel[threadIdx.x] = rank_s[threadIdx.x] < q ? 1.0f / (float)q : 0.0f;
  __syncthreads();
}

// Krum scores of the (n, n) Gram gm (row stride SP; NaN entries allowed):
// score[j] = the sum, ascending, of sorted positions [1, n - f) of column
// j's squared distances (selection.cuh:selection_weight's krum: the sort
// drops the diagonal). keys is a square buffer for the distances' keys; gm
// is overwritten with the sorted keys, a warp sorting a column
// (WarpSort). Every thread calls it; it synchronizes the block and returns
// with score[j] written by thread j < n.
template <class S, int NPAD>
__device__ __forceinline__ void krum_scores(float* gm, int32_t* keys, const float* nrm, int n,
                                            int f, float* score) {
  using WS = WarpSort<NPAD>;
  const int t = threadIdx.x, a = t / S::TB, b = t % S::TB;
#pragma unroll
  for (int r = 0; r < S::RA; ++r)
#pragma unroll
    for (int c = 0; c < S::RB; ++c) {
      const int i = a + S::TA * r, j = b + S::TB * c;
      if (i < n && j < n) keys[j * S::SP + i] = float_sort_key(sq_dist(nrm[i], nrm[j], gm[i * S::SP + j]));
    }
  __syncthreads();
  int32_t* sorted = reinterpret_cast<int32_t*>(gm);
  const int lane = t & 31, le = lane % WS::G;
  for (int j0 = (t >> 5) * WS::CPW; j0 < n; j0 += (S::T / 32) * WS::CPW) {
    const int j = j0 + lane / WS::G;
    int32_t v[WS::R];
#pragma unroll
    for (int r = 0; r < WS::R; ++r) {
      const int e = r * WS::G + le;
      v[r] = j < n && e < n ? keys[j * S::SP + e] : PAD_KEY;
    }
    WS::sort(v, lane);
#pragma unroll
    for (int r = 0; r < WS::R; ++r) {
      const int e = r * WS::G + le;
      if (j < n && e < n) sorted[j * S::SP + e] = v[r];
    }
  }
  __syncthreads();
  if (t < n) {
    float acc = 0.0f;
    for (int p = 1; p < n - f; ++p) acc = __fadd_rn(acc, key_to_float(sorted[t * S::SP + p]));
    score[t] = acc;
  }
}

}  // namespace selblock
