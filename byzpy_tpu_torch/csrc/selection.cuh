// Device pieces shared by the selection-family kernels (B4 selection.cu,
// B8/B9 nnm.cu, B10 clip_selection.cu):
//   - the selection modes;
//   - sq_dist: the Gram trick's squared distance
//     (byzpy_tpu/ops/pallas_kernels.py:763 _gram_norms_d2);
//   - nnm_select_column: NNM's stable k-select of one mixing row
//     (_nnm_weights :1216, _stable_k_select_mask :808), B8's selection
//     state, one thread a mixing row.
// The Gram is read through an accessor gat(i, j) (DenseGram: an (n, n)
// row-major Gram in device memory). The weights blocks of B4, B9 and B10
// are block-wide (selection_block.cuh).
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
