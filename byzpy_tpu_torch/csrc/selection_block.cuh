// Block-wide pieces of the selection family's weights: one block per round
// works on the round's (n, n) problem in shared memory, every thread taking
// a tile of it.
//
// B4's weights (selection.cu), B9's (nnm.cu) and B10's (clip_selection.cu)
// are built from them. B4 and B10 end in one finish, select_weights: the
// scores by mode, then 1/q on the q lowest (B9 keeps its own, nnm.cu). All
// three raise their shared-memory limit through raise_smem_once. The
// layout:
//   - a square buffer holds NPAD rows of SP = NPAD + 1 values: the odd row
//     stride puts a row's values and a column's values in distinct banks,
//     so each phase reads whichever way it needs without conflicts;
//   - B4 and B10 read the Gram once, into registers a tile a thread, the
//     loads in flight at once (load_tile);
//   - thread (a, b) of the block's TA x TB grid owns rows a + TA r (r < RA)
//     and columns b + TB c (c < RB); a warp's lanes differ in b, so a loop
//     over l reads one row value for all lanes (a broadcast) or a lane's
//     own column value (consecutive banks);
//   - a selection is a bit mask over rows, W 32-bit words a column;
//   - a column to sort goes to the lanes of one warp: NNM's selection
//     (WarpSort, element e at lane e % 32) or Krum's scores (KeySort, up
//     to 16 consecutive elements a lane, so most of the network's steps
//     stay in registers and no comparator needs a direction);
//   - a stable rank (the weights' ranks, ARC's threshold) is counted by
//     parts of the block, each part a slice of the rows (stable_ranks).
// What bounds them is one SM's instruction rate and the latency of the
// block's barriers: the sorts are n bitonic networks, the ranks n^2
// compares, B9's products n^3 predicated adds, spread over up to 1,024
// threads.
#pragma once

#include <atomic>

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
  static_assert(T >= NPAD, "a thread a node");
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

// A column of an (n, n) problem sorted by G lanes of a warp, R consecutive
// keys a lane (element e at register e % R of lane e / R of the column's
// lane group; 32 / G columns a warp): each lane sorts its R keys with
// Batcher's merge-exchange network in registers (common.cuh), then
// bitonic merges, in the form whose comparators all put the smaller key at
// the lower index, join the lanes' runs (a merge of blocks of 2^ls keys
// starts by comparing e with its mirror e ^ (2^ls - 1), then halves with
// strides 2^(ls-2) ... 1). A pair within a lane is one min and one max;
// across lanes each lane shuffles in its partner's key and keeps the min
// or the max, two instructions, so a pair costs twice. Up to 16 rows a
// lane holds a column; from 32 rows on, 8 lanes do (R = NPAD / 8). What
// bounds it is the SM's rate of int32 min/max (64 a clock).
// Columns go through a buffer: element e of column j at addr(j, e), a
// padding word after each lane's R keys and an odd row stride SP, and a
// warp's CPW columns 32 / CPW apart mod 32 (column()), so that the warp's
// loads and stores of its columns, a row of keys formed across 32
// columns, and 32 columns read by one thread each all hit 32 distinct
// banks.
template <int NPAD>
struct KeySort {
  static constexpr int R = NPAD <= 16 ? NPAD : NPAD / 8;  // keys a lane
  static constexpr int G = NPAD / R;                      // lanes a column
  static constexpr int CPW = 32 / G;                      // columns a warp
  static constexpr int LOG = ilog2(NPAD), LR = ilog2(R);
  static constexpr int SP = (NPAD + NPAD / R) | 1;

  __device__ static __forceinline__ int addr(int j, int e) { return j * SP + e + e / R; }
  // element r of lane le's run of column j
  __device__ static __forceinline__ int run(int j, int le) { return j * SP + le * (R + 1); }
  __device__ static __forceinline__ int column(int c) {
    return G == 1 ? c : (c & ~31) | ((c % CPW) * (32 / CPW)) | ((c / CPW) % (32 / CPW));
  }

  __device__ static __forceinline__ void sort(int32_t (&v)[R], int lane) {
    const int le = lane % G;
    batcher_sort<R>(v);
#pragma unroll
    for (int ls = LR + 1; ls <= LOG; ++ls) {
      // the mirror e ^ (2^ls - 1): register R - 1 - r of lane le ^ (2^(ls - LR) - 1)
      const bool low = ((le >> (ls - 1 - LR)) & 1) == 0;
      int32_t o[R];
#pragma unroll
      for (int r = 0; r < R; ++r) o[r] = __shfl_xor_sync(0xFFFFFFFFu, v[R - 1 - r], ((1 << ls) - 1) >> LR);
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = low ? min(v[r], o[r]) : max(v[r], o[r]);
#pragma unroll
      for (int lt = ls - 2; lt >= 0; --lt) {
        const int s = 1 << lt;
        if (s < R) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if ((r & s) == 0) {
              const int32_t lo = min(v[r], v[r | s]), hi = max(v[r], v[r | s]);
              v[r] = lo;
              v[r | s] = hi;
            }
          }
        } else {  // register r of lane le ^ (s / R)
          const bool low = (le & (s >> LR)) == 0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int32_t o = __shfl_xor_sync(0xFFFFFFFFu, v[r], s >> LR);
            v[r] = low ? min(v[r], o) : max(v[r], o);
          }
        }
      }
    }
  }
};

// Gram entry at(i, j) for each (i, j) = (a + TA r, b + TB c) of thread
// (a, b)'s tile (0 off the problem), into registers: from device memory,
// RA x RB loads in flight at once.
template <class S, class Entry>
__device__ __forceinline__ void load_tile(const Entry& at, int n, float (&v)[S::RA][S::RB]) {
  const int a = threadIdx.x / S::TB, b = threadIdx.x % S::TB;
#pragma unroll
  for (int r = 0; r < S::RA; ++r)
#pragma unroll
    for (int c = 0; c < S::RB; ++c) {
      const int i = a + S::TA * r, j = b + S::TB * c;
      v[r][c] = i < n && j < n ? at(i, j) : 0.0f;
    }
}

// rank[j] += the number of rows c < n whose key comes before key[j]: below
// it, or equal to it in an earlier row (j's place in a stable sort), for j
// < n. key[c] must be PAD_KEY for n <= c < NPAD (such a row comes before
// no j < n). Each part of the block counts a slice of the rows for every j
// and adds its count with one shared atomic (integers: the order of the
// adds does not matter). rank must hold zeros or counts to add to. Every
// thread calls it; it synchronizes the block.
template <class S, int NPAD>
__device__ __forceinline__ void stable_ranks(const int32_t* key, int* rank, int n) {
  constexpr int PARTS = S::T / NPAD, CHUNK = NPAD / PARTS;
  const int j = threadIdx.x % NPAD, c0 = threadIdx.x / NPAD * CHUNK;
  if (j < n) {
    const int32_t kj = key[j];
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      const int c = c0 + u;
      const int32_t kc = key[c];
      cnt += (kc < kj || (kc == kj && c < j)) ? 1 : 0;
    }
    if (cnt) atomicAdd(&rank[j], cnt);
  }
  __syncthreads();
}

// A score's rank key: NaN after every number, -0.0 tied with +0.0 (scores
// compare as floats), so that stable ranks of the keys order the scores as
// the reference's selection does (NaN last, ties by index).
__device__ __forceinline__ int32_t score_key(float s) {
  return isnan(s) ? PAD_KEY : float_sort_key(s == 0.0f ? 0.0f : s);
}

// The finish's shared scratch.
template <int NPAD>
struct Ranked {
  int32_t key[NPAD];  // the scores' rank keys
  int rank[NPAD];
  float w[NPAD];      // the selection weights w_sel
};

// Krum score of node j = threadIdx.x < n (0 for the other threads): the
// sum, ascending, of sorted positions [1, n - f) of the squared distances
// d2(i, j) = sq_dist(nrm[i], nrm[j], at(i, j)) over i < n (the sort drops
// the diagonal). Up to 8 rows thread j forms, sorts and adds column j in
// registers, reading at(i, j). From 16 rows on, every thread forms the keys
// of its tile (tile(r, c, i, j) = G_ij for element (r, c) of the thread's
// tile, (i, j) = (a + TA r, b + TB c)) into keys (NPAD rows of
// KeySort<NPAD>::SP words), the lanes of a warp sort each column in place,
// and thread j adds column j; the block synchronizes twice, and nrm[i]
// must be NaN for n <= i < NPAD. Every thread calls it.
template <class S, int NPAD, class Entry, class Tile>
__device__ __forceinline__ float krum_score(const Entry& at, const Tile& tile, int32_t* keys,
                                            const float* nrm, int n, int f) {
  using KS = KeySort<NPAD>;
  const int t = threadIdx.x;
  float acc = 0.0f;
  if constexpr (NPAD <= 8) {
    if (t < n) {
      int32_t v[NPAD];
#pragma unroll
      for (int i = 0; i < NPAD; ++i)
        v[i] = i < n ? float_sort_key(sq_dist(nrm[i], nrm[t], at(i, t))) : PAD_KEY;
      KS::sort(v, 0);
#pragma unroll
      for (int p = 1; p < NPAD; ++p)
        if (p < n - f) acc = __fadd_rn(acc, key_to_float(v[p]));
    }
  } else {
    // rows i >= n have NaN norms, so their distances' keys are NaN's: past
    // every finite key and equal to a real NaN's, the summed values are
    // the reference's (whose pads sort after NaN), and no entry needs a test
    const int a = t / S::TB, b = t % S::TB;
#pragma unroll
    for (int r = 0; r < S::RA; ++r)
#pragma unroll
      for (int c = 0; c < S::RB; ++c) {
        const int i = a + S::TA * r, j = b + S::TB * c;
        keys[KS::addr(j, i)] = float_sort_key(sq_dist(nrm[i], nrm[j], tile(r, c, i, j)));
      }
    __syncthreads();
    const int lane = t & 31, le = lane % KS::G;
    for (int c0 = (t >> 5) * KS::CPW; c0 < NPAD; c0 += (S::T / 32) * KS::CPW) {
      const int j = KS::column(c0 + lane / KS::G);
      if constexpr (KS::CPW > NPAD) if (j >= NPAD) continue;  // a lane a column: lanes past NPAD idle
      int32_t* run = keys + KS::run(j, le);
      int32_t v[KS::R];
#pragma unroll
      for (int r = 0; r < KS::R; ++r) v[r] = run[r];
      KS::sort(v, lane);
#pragma unroll
      for (int r = 0; r < KS::R; ++r) run[r] = v[r];
    }
    __syncthreads();
    if (t < n)
      for (int p = 1; p < n - f; ++p) acc = __fadd_rn(acc, key_to_float(keys[KS::addr(t, p)]));
  }
  return acc;
}

// The finish of every selection-weights block (pallas_kernels.py:843-883
// _selection_scores, _selection_weights): node j's score by mode (KRUM:
// krum_score; else cge, the squared norm nrm[j], or monna, d2(ref, j)),
// then w_sel = 1/q if the score ranks among the q lowest (NaN last, ties
// by index), else 0 (0 for j >= n). at(i, j) is the Gram entry the scores
// read, nrm its diagonal (NaN past n for krum); tile and keys are
// krum_score's. Every thread
// calls it; it synchronizes the block and returns thread j < n's weight,
// with r.w written for the block after the caller's next barrier.
template <class S, int NPAD, bool KRUM, class Entry, class Tile>
__device__ __forceinline__ float select_weights(const Entry& at, const Tile& tile, int32_t* keys,
                                                const float* nrm, int n, int f, int q, int mode,
                                                int ref, Ranked<NPAD>& r) {
  const int t = threadIdx.x;
  if (t < NPAD) r.rank[t] = 0;
  float s = 0.0f;
  if constexpr (KRUM) {
    s = krum_score<S, NPAD>(at, tile, keys, nrm, n, f);
  } else if (t < n) {
    s = mode == kCge ? nrm[t] : sq_dist(nrm[ref], nrm[t], at(ref, t));
  }
  if (t < NPAD) r.key[t] = t < n ? score_key(s) : PAD_KEY;
  __syncthreads();
  stable_ranks<S, NPAD>(r.key, r.rank, n);
  const float wt = t < n && r.rank[t] < q ? 1.0f / (float)q : 0.0f;
  if (t < NPAD) r.w[t] = wt;
  return wt;
}

// Dynamic shared memory of a Krum weights block: krum_score's keys (none
// up to 8 rows, where a thread keeps its column in registers).
template <int NPAD>
constexpr int krum_smem_bytes() {
  return NPAD <= 8 ? 0 : NPAD * KeySort<NPAD>::SP * (int)sizeof(int32_t);
}

// Raise kernel's limit of dynamic shared memory to bytes on the current
// device, once a device: ready holds a bit for each device already raised
// (the launcher's static, one a kernel instance). Raising it on every call
// costs more than a weights block at 64 rows.
inline cudaError_t raise_smem_once(const void* kernel, int bytes,
                                   std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (ready.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

}  // namespace selblock
