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
//   3. byz_weighted_rows: out = sum_i (w_i != 0 ? x_i : 0) * w_i in f32,
//      rows ascending, cast to the input dtype (:967-971).
//
// Bound: memory. The Gram reads x once and the sweep reads the q selected
// rows once; phase 2 touches only (n, n) data. Design: the sweep is one
// thread per column with coalesced row loads and rows of weight 0 skipped,
// so it reads q / n of x instead of all of it.
//
// The sweep also serves B9 and B10 (nnm.cu, clip_selection.cu), whose
// weights are NaN everywhere when the selection took a non-finite row
// (pallas_kernels.py:1454, :1543). It therefore reads every row whose
// weight is not 0, NaN included, so such a weight poisons every column as
// the reference's sum does. B4's weights are 1/q or 0, so its output is
// the one the w > 0 rule gave. Rows the reference zeroes as tainted carry
// weight 0 or sit in an all-NaN weight vector, so the sweep needs no taint
// argument: skipping a weight-0 row drops a term that is exactly +-0.

#include "selection.cuh"

namespace {

constexpr int kRowThreads = 256;

template <int NPAD>
__global__ void __launch_bounds__(NPAD)
selection_weights_kernel(const float* __restrict__ gram, float* __restrict__ w,
                         int n, int f, int q, int mode, int ref) {
  const int k = blockIdx.x, j = threadIdx.x;
  const float wj = selection_weight<NPAD>(DenseGram{gram + (long long)k * n * n, n}, n, f, q,
                                          mode, ref);
  if (j < n) w[(long long)k * n + j] = wj;
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
    // a weight-0 row adds exactly +-0 in the reference: skip its read
    if (wi != 0.0f) acc = __fadd_rn(acc, __fmul_rn(to_f32(xk[(long long)i * d]), wi));
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
