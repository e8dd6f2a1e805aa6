// B4: fused score -> select -> weighted mean (Multi-Krum, CGE, MoNNA) over K
// stacked (n, d) rounds, phases 2 and 3.
//
// Replaces byzpy_tpu/ops/pallas_kernels.py:928 _selection_mean_stream_kernel
// (pallas_call at :1036). The TPU kernel keeps the Gram and the weights in
// VMEM scratch across a (K, 2, C) grid. Here the same work is a sequence of
// launches; phase 1 (the Gram) is B3 (gram.cu), and the two launches below
// take the Gram as an argument, so the Gram-given variant
// (_selection_from_gram_kernel, :1094) needs only a new wrapper:
//   2. byz_selection_weights: one block per round, one thread per node.
//      norms = diag(G), d2 = max(n_i + n_j - 2 G_ij, 0) (:763-769); krum
//      scores are the sum of sorted-key rows [1, n - f) of each d2 column
//      with pads at the max key (:772-781, :843-859) -- the diagonal is
//      not special-cased, the sort drops it; cge scores are the norms,
//      monna scores d2[ref]. Ranks put NaN last, pads after NaN, ties by
//      index; the q lowest get weight 1/q in f32 (:862-883).
//   3. byz_weighted_rows: out = sum_i (w_i > 0 ? x_i : 0) * w_i in f32,
//      rows ascending, cast to the input dtype (:967-971).
//
// Bound: memory. The Gram reads x once and the sweep reads the q selected
// rows once; phase 2 touches only (n, n) data. Design: the sweep is one
// thread per column with coalesced row loads and rows of weight 0 skipped,
// so it reads q / n of x instead of all of it.

#include "common.cuh"

namespace {

enum SelectionMode { kKrum = 0, kCge = 1, kMonna = 2 };

constexpr int kRowThreads = 256;

// max(n_i + n_j - 2 g, 0), NaN kept (jnp.maximum propagates NaN).
__device__ __forceinline__ float sq_dist(float ni, float nj, float g) {
  const float v = __fsub_rn(__fadd_rn(ni, nj), __fmul_rn(2.0f, g));
  return (v < 0.0f) ? 0.0f : v;
}

template <int NPAD>
__global__ void __launch_bounds__(NPAD)
selection_weights_kernel(const float* __restrict__ gram, float* __restrict__ w,
                         int n, int f, int q, int mode, int ref) {
  __shared__ float norms[NPAD];
  __shared__ float score_s[NPAD];
  __shared__ int bad_s[NPAD];
  const int k = blockIdx.x, j = threadIdx.x;
  const float* g = gram + (long long)k * n * n;
  norms[j] = (j < n) ? g[j * n + j] : 0.0f;
  __syncthreads();
  float score = 0.0f;
  if (j < n) {
    if (mode == kCge) {
      score = norms[j];
    } else if (mode == kMonna) {
      score = sq_dist(norms[ref], norms[j], g[ref * n + j]);
    } else {
      int32_t keys[NPAD];
#pragma unroll
      for (int i = 0; i < NPAD; ++i) {
        keys[i] = PAD_KEY;
        if (i < n) keys[i] = float_sort_key(sq_dist(norms[i], norms[j], g[i * n + j]));
      }
      batcher_sort<NPAD>(keys);
      score = sum_sorted_range(keys, 1, n - f);
    }
  }
  const int bad = (j >= n || isnan(score)) ? 1 : 0;
  score_s[j] = bad ? 0.0f : score;
  bad_s[j] = bad;
  __syncthreads();
  if (j >= n) return;
  const float sj = score_s[j];
  int rank = 0;
  for (int c = 0; c < NPAD; ++c) {
    const int bc = bad_s[c];
    const float sc = score_s[c];
    const bool before = (!bc && bad) || (bc == bad && (sc < sj || (sc == sj && c < j)));
    rank += before ? 1 : 0;
  }
  w[(long long)k * n + j] = (rank < q) ? 1.0f / (float)q : 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
weighted_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     T* __restrict__ out, int n, long long d) {
  __shared__ float ws[128];
  const int k = blockIdx.y;
  if (threadIdx.x < n) ws[threadIdx.x] = w[(long long)k * n + threadIdx.x];
  __syncthreads();
  const long long c = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (c >= d) return;
  const T* xk = x + (long long)k * n * d + c;
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float wi = ws[i];
    // a weight-0 row adds exactly +0 in the reference: skip its read
    if (wi > 0.0f) acc = __fadd_rn(acc, __fmul_rn(to_f32(xk[(long long)i * d]), wi));
  }
  out[(long long)k * d + c] = from_f32<T>(acc);
}

template <typename T>
void launch_rows(const void* x, const float* w, void* out, int K, int n,
                 long long d, cudaStream_t s) {
  const dim3 grid((unsigned)((d + kRowThreads - 1) / kRowThreads), (unsigned)K);
  weighted_rows_kernel<T><<<grid, kRowThreads, 0, s>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), n, d);
}

}  // namespace

// gram: (K, n, n) f32; w: (K, n) f32 out. Returns the launch's cudaError_t.
extern "C" int byz_selection_weights(const float* gram, float* w, int K, int n,
                                     int f, int q, int mode, int ref,
                                     void* stream) {
  if (K <= 0) return cudaSuccess;
  if (mode < kKrum || mode > kMonna || ref < 0 || ref >= n) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (network_width(n)) {
    case 8: selection_weights_kernel<8><<<K, 8, 0, s>>>(gram, w, n, f, q, mode, ref); break;
    case 16: selection_weights_kernel<16><<<K, 16, 0, s>>>(gram, w, n, f, q, mode, ref); break;
    case 32: selection_weights_kernel<32><<<K, 32, 0, s>>>(gram, w, n, f, q, mode, ref); break;
    case 64: selection_weights_kernel<64><<<K, 64, 0, s>>>(gram, w, n, f, q, mode, ref); break;
    case 128: selection_weights_kernel<128><<<K, 128, 0, s>>>(gram, w, n, f, q, mode, ref); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x: (K, n, d) contiguous; w: (K, n) f32; out: (K, d) of x's dtype.
extern "C" int byz_weighted_rows(const void* x, const float* w, void* out, int K,
                                 int n, long long d, int dtype, void* stream) {
  if (K <= 0 || d <= 0) return cudaSuccess;
  if (n < 1 || n > 128) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: launch_rows<float>(x, w, out, K, n, d, s); break;
    case kBF16: launch_rows<__nv_bfloat16>(x, w, out, K, n, d, s); break;
    case kF16: launch_rows<__half>(x, w, out, K, n, d, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
