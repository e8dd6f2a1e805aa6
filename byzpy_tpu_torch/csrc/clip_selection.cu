// B10: static L2 clipping (pre = clip) or Adaptive Robust Clipping (pre =
// arc) feeding a selection mean (Multi-Krum, CGE, MoNNA) over K stacked
// (n, d) rounds, through the clipped Gram.
//
// Replaces byzpy_tpu/ops/pallas_kernels.py:1466 _clip_selection_stream_kernel,
// launched for pre="clip" at :1616 (clip_selection_mean_stream_pallas) and
// for pre="arc" at :1710 (arc_selection_mean_stream_pallas). Clipping is the
// row scaling diag(c) x, so the clipped rows' Gram is c_i c_j G_ij and
// their selected mean is sum_j w_sel_j c_j x_j. After B3's Gram (gram.cu):
//   byz_clip_selection_weights: one block per round (:1497-1544). norm_j =
//     sqrt(max(G_jj, 0)); the threshold is tau, or for arc the norm at rank
//     cut_off - 1 under a stable rank count in int32 key space (NaN after
//     every finite norm, ties by index; cut_off from
//     ops/preagg.py:arc_cut_off); c_j = min(1, threshold / max(norm_j,
//     1e-12)), NaN kept; the selection weights w_sel of (c_i c_j) G_ij;
//     w_eff_j = 0 for a non-finite norm, else w_sel_j c_j, and all NaN when
//     such a row was selected.
//   then selection.cu's weighted-row sweep, which reads the rows whose w_eff
//     is not 0 (NaN included).
// The reference's documented deviation stays: an inf norm clips to factor 0
// and its row is excluded, also when the row is finite and only its squared
// norm overflows f32 (:1477-1489).
//
// Bound: the weights block touches only (n, n) data; what bounds it is one
// SM's instructions and the latency of the block's barriers. The sweep
// reads the q selected rows (selection.cu).
// Design: B4's weights block (selection_block.cuh) with the clip in front
// of its finish, an instance for krum and one for cge and monna. krum
// loads each thread's tile of the raw Gram into registers while thread j
// reads G_jj (from 16 rows on; up to 8 a thread reads its column where the
// scores need it); ARC's rank is counted by parts of the block, a slice of
// the rows each; the clipped entries (c_i c_j) G_ij are formed as the
// scores read them (each entry once, by the thread that forms its key).
// cge and monna read the diagonal and row ref from device memory.
// chip_selection_ablation.py --kinds b10 takes it apart (the tile loaded
// after the clip factors, each entry formed as it lands).

#include "selection_block.cuh"

namespace {

enum ClipMode { kClip = 0, kArc = 1 };

constexpr int kSelThreads = 512;  // as B4's (selection.cu)

template <int NPAD>
using SelShape = selblock::Shape<NPAD, kSelThreads>;

template <int NPAD, bool KRUM>
__global__ void __launch_bounds__(SelShape<NPAD>::T, 1)
clip_selection_weights_kernel(const float* __restrict__ gram, float* __restrict__ w, int n,
                              int pre, float tau, int cut_off, int f, int q, int mode,
                              int ref) {
  using S = SelShape<NPAD>;
  extern __shared__ __align__(16) unsigned char dyn[];  // krum_score's keys
  __shared__ int32_t norm_key[NPAD];
  __shared__ float cfac[NPAD];
  __shared__ float nrm[NPAD];  // the clipped Gram's diagonal
  __shared__ selblock::Ranked<NPAD> r;
  __shared__ float threshold;
  const int t = threadIdx.x;
  const float* g = gram + (long long)blockIdx.x * n * n;
  // krum: this thread's tile of the raw Gram, its loads in flight with G_tt's
  float tile[S::RA][S::RB];
  if constexpr (KRUM && NPAD > 8) selblock::load_tile<S>(DenseGram{g, n}, n, tile);
  float sq = 0.0f, norm = 0.0f;
  if (t < n) {
    sq = g[t * n + t];
    norm = __fsqrt_rn(sq < 0.0f ? 0.0f : sq);  // NaN stays NaN
  }
  if (t < NPAD) {
    norm_key[t] = t < n ? float_sort_key(norm) : PAD_KEY;
    r.rank[t] = 0;
  }
  if (t == 0) threshold = tau;
  __syncthreads();
  if (pre == kArc) {  // the norm at stable rank cut_off - 1
    selblock::stable_ranks<S, NPAD>(norm_key, r.rank, n);
    if (t < n && r.rank[t] == cut_off - 1) threshold = key_to_float(norm_key[t]);
    __syncthreads();
  }
  float c = 0.0f;
  if (t < n) {
    // jnp.maximum / jnp.minimum propagate NaN; fmaxf / fminf would drop it
    const float den = isnan(norm) ? norm : fmaxf(norm, 1e-12f);
    const float ratio = __fdiv_rn(threshold, den);
    c = isnan(ratio) ? ratio : fminf(1.0f, ratio);
  }
  if (t < NPAD) {
    cfac[t] = c;
    nrm[t] = t < n ? __fmul_rn(__fmul_rn(c, c), sq) : __int_as_float(0x7FC00000);
  }
  __syncthreads();
  // the clipped Gram's entries (c_i c_j) G_ij, formed as the scores read them
  const auto clipped = [&](int i, int j) { return __fmul_rn(__fmul_rn(cfac[i], cfac[j]), g[i * n + j]); };
  if constexpr (KRUM && NPAD > 8) {
    const int a = t / S::TB, b = t % S::TB;
#pragma unroll
    for (int rr = 0; rr < S::RA; ++rr)
#pragma unroll
      for (int cc = 0; cc < S::RB; ++cc)
        tile[rr][cc] = __fmul_rn(__fmul_rn(cfac[a + S::TA * rr], cfac[b + S::TB * cc]), tile[rr][cc]);
  }
  const float ws = selblock::select_weights<S, NPAD, KRUM>(
      clipped, [&](int rr, int cc, int, int) { return tile[rr][cc]; }, reinterpret_cast<int32_t*>(dyn),
      nrm, n, f, q, mode, ref, r);
  const bool bad = t < n && !isfinite(norm);
  const int picked_bad = __syncthreads_or(ws > 0.0f && bad);
  if (t < n)
    w[(long long)blockIdx.x * n + t] =
        picked_bad ? __int_as_float(0x7FC00000) : (bad ? 0.0f : __fmul_rn(ws, c));
}

// One launch of B10's weights at width NPAD: a block a round, an instance
// for krum and one for cge and monna; krum's keys in dynamic shared
// memory, opted in above 48 KB once a device.
template <int NPAD>
cudaError_t launch_weights(const float* gram, float* w, int K, int n, int pre, float tau,
                           int cut_off, int f, int q, int mode, int ref, cudaStream_t s) {
  constexpr int T = SelShape<NPAD>::T;
  if (mode != kKrum) {
    clip_selection_weights_kernel<NPAD, false><<<K, T, 0, s>>>(gram, w, n, pre, tau, cut_off, f,
                                                               q, mode, ref);
    return cudaGetLastError();
  }
  static std::atomic<unsigned long long> ready{0};
  constexpr int dyn = selblock::krum_smem_bytes<NPAD>();
  const cudaError_t err = selblock::raise_smem_once(
      reinterpret_cast<const void*>(&clip_selection_weights_kernel<NPAD, true>), dyn, ready);
  if (err != cudaSuccess) return err;
  clip_selection_weights_kernel<NPAD, true><<<K, T, dyn, s>>>(gram, w, n, pre, tau, cut_off, f,
                                                              q, mode, ref);
  return cudaGetLastError();
}

}  // namespace

// gram: (K, n, n) f32; w: (K, n) f32 out, the source-row weights w_eff.
// pre: 0 clip (threshold tau), 1 arc (threshold at rank cut_off - 1, cut_off
// in [1, n]). Returns the launch's cudaError_t (a refused shared-memory
// opt-in included).
extern "C" int byz_clip_selection_weights(const float* gram, float* w, int K, int n, int pre,
                                          float tau, int cut_off, int f, int q, int mode,
                                          int ref, void* stream) {
  if (K <= 0) return cudaSuccess;
  if (pre < kClip || pre > kArc || (pre == kArc && (cut_off < 1 || cut_off > n)) ||
      mode < kKrum || mode > kMonna || ref < 0 || ref >= n)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (network_width(n)) {
    case 8: return launch_weights<8>(gram, w, K, n, pre, tau, cut_off, f, q, mode, ref, s);
    case 16: return launch_weights<16>(gram, w, K, n, pre, tau, cut_off, f, q, mode, ref, s);
    case 32: return launch_weights<32>(gram, w, K, n, pre, tau, cut_off, f, q, mode, ref, s);
    case 64: return launch_weights<64>(gram, w, K, n, pre, tau, cut_off, f, q, mode, ref, s);
    case 128: return launch_weights<128>(gram, w, K, n, pre, tau, cut_off, f, q, mode, ref, s);
    default: return cudaErrorInvalidValue;
  }
}
