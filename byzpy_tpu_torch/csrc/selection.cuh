// Device pieces shared by the selection-family kernels (B4 selection.cu,
// B8/B9 nnm.cu, B10 clip_selection.cu):
//   - the selection modes;
//   - sq_dist: the Gram trick's squared distance
//     (byzpy_tpu/ops/pallas_kernels.py:763 _gram_norms_d2);
//   - DenseGram: an (n, n) row-major Gram read through gat(i, j).
// The weights blocks of B4, B9 and B10, B5 and B8's selection state are
// block-wide (selection_block.cuh).
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
