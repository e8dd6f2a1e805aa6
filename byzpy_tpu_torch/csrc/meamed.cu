// B6: fused MeaMed (mean around the median) over K stacked (n, d) rounds.
//
// Replaces byzpy_tpu/ops/pallas_kernels.py:619 _meamed_stream_kernel
// (pallas_call at :740). What it computes, per round k and column c, in f32
// from the input dtype:
//   1. the column's int32 total-order keys, sorted with Batcher's network;
//   2. the median: the middle key (odd n) or 0.5 a + 0.5 b of the two
//      middle keys (even n; summing first overflows near FLT_MAX), NaN iff
//      the column holds a NaN (:645-655);
//   3. the cut, the k-th smallest |x - med| for k = n - f, as the minimum
//      over window starts s in [0, f] of max(med - xs[s], xs[s+k-1] - med)
//      (:657-665); with a non-finite median, inf if at least k deviations
//      are not NaN and NaN otherwise (:666-677);
//   4. a threshold select on the ORIGINAL column: every row whose deviation
//      is below the cut, then rows at the cut in node order until k are
//      taken (_stable_threshold_select :784); the selected values summed in
//      node order, times the f32 reciprocal of k, NaN where the cut or the
//      median is NaN.
//
// Bound: memory. One read of the (K, n, d) input and a (K, d) write; the
// network is ~n/2 log^2 n integer min/max per column and the select two
// passes over n values, under the card's ALU rate at n <= 128. Design: one
// thread per column and a block of C neighbouring columns, so each row load
// is coalesced across the block. The keys sort in registers (common.cuh's
// template-expanded network); steps 2-4 index rows by run-time values (the
// middle rows, s + k - 1, node order), which would move a register array to
// local memory, so each thread writes its sorted keys and its original
// column to shared memory, column-major by thread (conflict-free), and
// reads them back there: 2 * NPAD * C * 4 bytes, 32 KB at NPAD = 128, C =
// 32. Every thread touches only its own column, so no barrier is needed.

#include "common.cuh"

namespace {

// NaN-propagating max / min (jnp.maximum / jnp.minimum; fmaxf and fminf
// drop a NaN operand).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7FC00000) : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7FC00000) : fminf(a, b);
}

template <typename T, int NPAD, int C>
__global__ void __launch_bounds__(C)
meamed_kernel(const T* __restrict__ x, T* __restrict__ out, int n, long long d, int f) {
  __shared__ int32_t srt[NPAD][C];  // sorted keys of each thread's column
  __shared__ float col[NPAD][C];    // the column in node order, as f32
  const int t = threadIdx.x;
  const long long c = (long long)blockIdx.x * C + t;
  const int kr = blockIdx.y;
  if (c >= d) return;
  const T* xk = x + (long long)kr * n * d + c;
  int32_t keys[NPAD];
#pragma unroll
  for (int i = 0; i < NPAD; ++i) {
    keys[i] = PAD_KEY;
    if (i < n) {
      const float v = to_f32(xk[(long long)i * d]);
      col[i][t] = v;
      keys[i] = float_sort_key(v);
    }
  }
  batcher_sort<NPAD>(keys);
#pragma unroll
  for (int i = 0; i < NPAD; ++i) srt[i][t] = keys[i];

  const float qnan = __int_as_float(0x7FC00000);
  const int k = n - f;
  const int lo = (n - 1) / 2, hi = n / 2;
  float med = key_to_float(srt[lo][t]);
  if (lo != hi) med = __fadd_rn(__fmul_rn(med, 0.5f), __fmul_rn(key_to_float(srt[hi][t]), 0.5f));
  if (srt[n - 1][t] > INF_KEY) med = qnan;

  float cut;
  if (isfinite(med)) {
    // window starts past f are +inf in the reference: start the min there
    cut = __int_as_float(0x7F800000);
    for (int s = 0; s <= f; ++s) {
      const float below = __fsub_rn(med, key_to_float(srt[s][t]));
      const float above = __fsub_rn(key_to_float(srt[s + k - 1][t]), med);
      cut = nan_min(cut, nan_max(below, above));
    }
  } else {
    int finite_devs = 0;
    for (int i = 0; i < n; ++i) finite_devs += isnan(fabsf(__fsub_rn(col[i][t], med))) ? 0 : 1;
    cut = (finite_devs >= k) ? __int_as_float(0x7F800000) : qnan;
  }

  // threshold select in node order: the rows below the cut, then the first
  // `quota` rows at the cut (a NaN cut selects nothing)
  int quota = k;
  for (int i = 0; i < n; ++i) quota -= (fabsf(__fsub_rn(col[i][t], med)) < cut) ? 1 : 0;
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float v = col[i][t];
    const float dev = fabsf(__fsub_rn(v, med));
    bool take = dev < cut;
    if (dev == cut) take = (quota-- > 0);
    if (take) acc = __fadd_rn(acc, v);
  }
  // the reference's `/ k` by a constant compiles to a multiply by the f32
  // reciprocal of k
  const float res = (isnan(cut) || isnan(med)) ? qnan : __fmul_rn(acc, __frcp_rn((float)k));
  out[(long long)kr * d + c] = from_f32<T>(res);
}

template <typename T, int NPAD>
void launch_width(const void* x, void* out, int K, int n, long long d, int f, cudaStream_t s) {
  // 32 KB of shared memory a block at every width
  constexpr int C = NPAD >= 128 ? 32 : 64;
  const dim3 grid((unsigned)((d + C - 1) / C), (unsigned)K);
  meamed_kernel<T, NPAD, C><<<grid, C, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(out), n, d, f);
}

template <typename T>
cudaError_t launch(const void* x, void* out, int K, int n, long long d, int f, cudaStream_t s) {
  switch (network_width(n)) {
    case 8: launch_width<T, 8>(x, out, K, n, d, f, s); break;
    case 16: launch_width<T, 16>(x, out, K, n, d, f, s); break;
    case 32: launch_width<T, 32>(x, out, K, n, d, f, s); break;
    case 64: launch_width<T, 64>(x, out, K, n, d, f, s); break;
    case 128: launch_width<T, 128>(x, out, K, n, d, f, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x: (K, n, d) contiguous; out: (K, d) of the same dtype; 0 <= f < n <= 128.
// Returns the launch's cudaError_t.
extern "C" int byz_meamed(const void* x, void* out, int K, int n, long long d, int f,
                          int dtype, void* stream) {
  if (n < 1 || f < 0 || f >= n) return cudaErrorInvalidValue;
  if (K <= 0 || d <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, out, K, n, d, f, s);
    case kBF16: return launch<__nv_bfloat16>(x, out, K, n, d, f, s);
    case kF16: return launch<__half>(x, out, K, n, d, f, s);
    default: return cudaErrorInvalidValue;
  }
}
