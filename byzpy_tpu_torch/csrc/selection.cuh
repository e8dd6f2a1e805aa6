// Device pieces shared by the selection-family kernels (B4 selection.cu,
// B8/B9 nnm.cu, B10 clip_selection.cu), each run by one block of NPAD
// threads per round, thread j owning node j:
//   - sq_dist: the Gram trick's squared distance
//     (byzpy_tpu/ops/pallas_kernels.py:763 _gram_norms_d2);
//   - selection_weight: scores -> ranks -> 1/q weights
//     (_selection_scores :843, _selection_weights :862);
//   - nnm_select_column: NNM's stable k-select of one mixing row
//     (_nnm_weights :1216, _stable_k_select_mask :808).
// The Gram is read through an accessor gat(i, j), so one scoring routine
// serves a Gram in device memory (B4), a clipped Gram formed on the fly
// (B10) and a derived Gram in shared memory (B9).
#pragma once

#include "common.cuh"

enum SelectionMode { kKrum = 0, kCge = 1, kMonna = 2 };

// max(n_i + n_j - 2 g, 0), NaN kept (jnp.maximum propagates NaN).
__device__ __forceinline__ float sq_dist(float ni, float nj, float g) {
  const float v = __fsub_rn(__fadd_rn(ni, nj), __fmul_rn(2.0f, g));
  return (v < 0.0f) ? 0.0f : v;
}

// An (n, n) row-major f32 Gram, in device or shared memory.
struct DenseGram {
  const float* g;
  int n;
  __device__ __forceinline__ float operator()(int i, int j) const { return g[i * n + j]; }
};

// Weight of node j = threadIdx.x: 1/q if its score ranks among the q lowest,
// else 0 (0 for the pads j >= n). Scores: krum, the sum of sorted-key rows
// [1, n - f) of d2 column j with pads at the max key (the sort drops the
// diagonal); cge, the squared norm; monna, d2[ref][j]. Ranks put NaN
// last, pads after NaN, ties by index. Every thread of the block calls it:
// it synchronizes the block.
template <int NPAD, typename Gram>
__device__ float selection_weight(const Gram& gat, int n, int f, int q, int mode, int ref) {
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
      score = sum_sorted_range(keys, 1, n - f);
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
    const bool before = (!bc && bad) || (bc == bad && (sc < sj || (sc == sj && c < j)));
    rank += before ? 1 : 0;
  }
  return (rank < q) ? 1.0f / (float)q : 0.0f;
}

// NNM's selection for mixing row i < n: rows j ordered by the key of
// d2[j][i] (pads at PAD_KEY, after NaN), cut at the k-th smallest key;
// every row below the cut is taken, then rows AT the cut in row order until
// k are taken (the stable-argsort tie rule of _stable_threshold_select
// :784). Writes out[j * stride + i] = 1 for the selected rows whose squared
// norm is finite, 0 otherwise (j < n), and returns 1 iff a tainted row
// (taint[j] != 0) was selected. The keys are computed again in the fill
// pass rather than kept: a second NPAD-register array would not fit.
template <int NPAD, typename Gram, typename Out>
__device__ int nnm_select_column(const Gram& gat, int n, int k, int i, const float* norms,
                                 const int* taint, Out* out, int stride) {
  int32_t keys[NPAD];
#pragma unroll
  for (int j = 0; j < NPAD; ++j) {
    keys[j] = PAD_KEY;
    if (j < n) keys[j] = float_sort_key(sq_dist(norms[j], norms[i], gat(j, i)));
  }
  batcher_sort<NPAD>(keys);
  const int32_t cut = select_key(keys, k - 1);
  int quota = k;  // places left for keys equal to the cut
#pragma unroll
  for (int t = 0; t < NPAD; ++t) quota -= (keys[t] < cut) ? 1 : 0;
  int sel_taint = 0;
  for (int j = 0; j < n; ++j) {
    const int32_t key = float_sort_key(sq_dist(norms[j], norms[i], gat(j, i)));
    int sel = (key < cut) ? 1 : 0;
    if (key == cut && quota > 0) {
      sel = 1;
      --quota;
    }
    sel_taint |= sel & taint[j];
    out[j * stride + i] = (Out)((sel && !taint[j]) ? 1 : 0);
  }
  return sel_taint;
}
