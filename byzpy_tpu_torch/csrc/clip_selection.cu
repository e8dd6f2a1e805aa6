// B10: static L2 clipping (pre = clip) or Adaptive Robust Clipping (pre =
// arc) feeding a selection mean (Multi-Krum, CGE, MoNNA) over K stacked
// (n, d) rounds, through the clipped Gram.
//
// Replaces byzpy_tpu/ops/pallas_kernels.py:1466 _clip_selection_stream_kernel,
// launched for pre="clip" at :1616 (clip_selection_mean_stream_pallas) and
// for pre="arc" at :1710 (arc_selection_mean_stream_pallas). Clipping is the
// row scaling diag(c) x, so the clipped rows' Gram is c_i c_j G_ij and
// their selected mean is sum_j w_sel_j c_j x_j. After B3's Gram (gram.cu):
//   byz_clip_selection_weights: one block per round, one thread per node
//     (:1497-1544). norm_j = sqrt(max(G_jj, 0)); the threshold is tau, or
//     for arc the norm at rank cut_off - 1 under a stable rank count in int32
//     key space (NaN after every finite norm, ties by index; cut_off from
//     ops/preagg.py:arc_cut_off); c_j = min(1, threshold / max(norm_j,
//     1e-12)), NaN kept; the selection weights w_sel of (c_i c_j) G_ij
//     (selection.cuh), formed as they are read; w_eff_j = 0 for a non-finite
//     norm, else w_sel_j c_j, and all NaN when such a row was selected.
//   then selection.cu's weighted-row sweep, which reads the rows whose w_eff
//     is not 0 (NaN included).
// The reference's documented deviation stays: an inf norm clips to factor 0
// and its row is excluded, also when the row is finite and only its squared
// norm overflows f32 (:1477-1489).
//
// Bound: the weights block touches only (n, n) data and is set by launch
// latency; the sweep reads the q selected rows (selection.cu). Design: the
// clipped Gram is never stored, so the block needs no more shared memory than
// B4's.

#include "selection.cuh"

namespace {

enum ClipMode { kClip = 0, kArc = 1 };

// (c_i c_j) G_ij, as the reference's cfac[:, None] * cfac[None, :] * g.
struct ClippedGram {
  const float* g;
  const float* c;
  int n;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return __fmul_rn(__fmul_rn(c[i], c[j]), g[i * n + j]);
  }
};

template <int NPAD>
__global__ void __launch_bounds__(NPAD)
clip_selection_weights_kernel(const float* __restrict__ gram, float* __restrict__ w, int n,
                              int pre, float tau, int cut_off, int f, int q, int mode,
                              int ref) {
  __shared__ int32_t key_s[NPAD];
  __shared__ float cfac[NPAD];
  __shared__ float threshold;
  __shared__ int picked_bad;
  const int r = blockIdx.x, i = threadIdx.x;
  const float* g = gram + (long long)r * n * n;
  float norm = 0.0f;
  if (i < n) {
    const float sq = g[i * n + i];
    norm = __fsqrt_rn(sq < 0.0f ? 0.0f : sq);  // NaN stays NaN
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
    // jnp.maximum / jnp.minimum propagate NaN; fmaxf / fminf would drop it
    const float den = isnan(norm) ? norm : fmaxf(norm, 1e-12f);
    const float ratio = __fdiv_rn(threshold, den);
    c = isnan(ratio) ? ratio : fminf(1.0f, ratio);
  }
  cfac[i] = c;
  __syncthreads();
  const float ws = selection_weight<NPAD>(ClippedGram{g, cfac, n}, n, f, q, mode, ref);
  const bool bad = i < n && !isfinite(norm);
  if (ws > 0.0f && bad) atomicOr(&picked_bad, 1);
  __syncthreads();
  if (i >= n) return;
  w[(long long)r * n + i] =
      picked_bad ? __int_as_float(0x7FC00000) : (bad ? 0.0f : __fmul_rn(ws, c));
}

}  // namespace

// gram: (K, n, n) f32; w: (K, n) f32 out, the source-row weights w_eff.
// pre: 0 clip (threshold tau), 1 arc (threshold at rank cut_off - 1, cut_off
// in [1, n]). Returns the launch's cudaError_t.
extern "C" int byz_clip_selection_weights(const float* gram, float* w, int K, int n, int pre,
                                          float tau, int cut_off, int f, int q, int mode,
                                          int ref, void* stream) {
  if (K <= 0) return cudaSuccess;
  if (pre < kClip || pre > kArc || (pre == kArc && (cut_off < 1 || cut_off > n)) ||
      mode < kKrum || mode > kMonna || ref < 0 || ref >= n)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (network_width(n)) {
    case 8: clip_selection_weights_kernel<8><<<K, 8, 0, s>>>(gram, w, n, pre, tau, cut_off, f, q, mode, ref); break;
    case 16: clip_selection_weights_kernel<16><<<K, 16, 0, s>>>(gram, w, n, pre, tau, cut_off, f, q, mode, ref); break;
    case 32: clip_selection_weights_kernel<32><<<K, 32, 0, s>>>(gram, w, n, pre, tau, cut_off, f, q, mode, ref); break;
    case 64: clip_selection_weights_kernel<64><<<K, 64, 0, s>>>(gram, w, n, pre, tau, cut_off, f, q, mode, ref); break;
    case 128: clip_selection_weights_kernel<128><<<K, 128, 0, s>>>(gram, w, n, pre, tau, cut_off, f, q, mode, ref); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
