// B7: one step of a centre-seeking aggregator (a Weiszfeld iteration of the
// geometric median, or an iteration of centred clipping) on an (n, d)
// matrix x and a centre z.
//
// Replaces byzpy_tpu/ops/pallas_kernels.py:470 _weighted_center_step_kernel
// (pallas_call at :582). The TPU kernel walks a sequential (2, C) grid:
// phase 0 adds each row's squared distance to z into scratch, the first
// step of phase 1 derives the weights, phase 1 sweeps the new centre. CUDA
// blocks run in no order, so the same work is three kernels in two C calls,
// with no float atomics (the same input gives the same bits on every run):
//   byz_center_weights
//     1. center_dist_partial_kernel: block b sums (x_ic - z_c)^2 over its
//        chunk of columns for every row, a fixed-order block tree, into
//        partial[b][i];
//     2. center_weights_kernel: one block; a warp per row sums the partials
//        (lanes strided over the chunks, then a butterfly), dist = sqrt;
//        then one thread forms the weights in row order (:505-521):
//        weiszfeld: w = (1/max(dist, eps)) / sum_j(...), alpha = 0;
//        clip: w = min(1, c_tau/max(dist, eps)) * (1/n), alpha = 1 - sum_j w_j
//        (the reference's `/ n` by a constant compiles to a multiply by
//        the f32 reciprocal);
//        max and min keep NaN, as jnp.maximum / jnp.minimum do.
//   byz_center_sweep
//     3. center_sweep_kernel: z_new = alpha z + sum_i w_i x_i in f32, rows
//        ascending, EVERY row read: a w = 0 row (an inf row's) still adds
//        0 * x_i, so 0 * inf = NaN reaches the output as in the reference
//        (:527-529); cast to x's dtype, NaN canonical.
//
// Bound: memory. Each C call reads x once (and z; the sweep also writes the
// (d,) centre); the weights touch n values. Design: the partial kernel
// streams one row at a time over its chunk with coalesced loads and a
// fixed-order reduce per row; the chunks are few (4 blocks per SM, at least
// 1024 columns each), so the second stage, a warp per row, sums at most a
// few dozen values a lane (gram.cu's one-thread-per-entry reduce over 528
// partials measured as long as its products). The sweep is one thread per
// column, weights in shared memory.

#include "common.cuh"

namespace {

constexpr int kDistThreads = 256;
constexpr int kWeightThreads = 1024;
constexpr int kSweepThreads = 256;
enum CenterMode { kWeiszfeld = 0, kClip = 1 };

__device__ __forceinline__ float qnan() { return __int_as_float(0x7FC00000); }
// NaN-propagating max / min (jnp.maximum / jnp.minimum; fmaxf and fminf
// drop a NaN operand).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fminf(a, b);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kDistThreads)
center_dist_partial_kernel(const T* __restrict__ x, const T* __restrict__ z,
                           float* __restrict__ partial, int n, long long d, long long chunk) {
  __shared__ float warp_part[kDistThreads / 32];
  const int b = blockIdx.x, t = threadIdx.x;
  const long long c0 = (long long)b * chunk;
  const long long c1 = (c0 + chunk < d) ? c0 + chunk : d;
  for (int i = 0; i < n; ++i) {
    const T* xi = x + (long long)i * d;
    float acc = 0.0f;
#pragma unroll 4
    for (long long c = c0 + t; c < c1; c += kDistThreads) {
      const float diff = __fsub_rn(to_f32(xi[c]), to_f32(z[c]));
      acc = __fadd_rn(acc, __fmul_rn(diff, diff));
    }
    acc = warp_sum(acc);
    if ((t & 31) == 0) warp_part[t >> 5] = acc;
    __syncthreads();
    if (t == 0) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kDistThreads / 32; ++w) s = __fadd_rn(s, warp_part[w]);
      partial[(long long)b * n + i] = s;
    }
    __syncthreads();
  }
}

// wa: n weights, then alpha at wa[n].
__global__ void __launch_bounds__(kWeightThreads)
center_weights_kernel(const float* __restrict__ partial, float* __restrict__ wa, int n,
                      int nchunks, int mode, float eps, float c_tau) {
  __shared__ float raw[128];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = warp; i < n; i += kWeightThreads / 32) {
    float s = 0.0f;
    for (int b = lane; b < nchunks; b += 32) s = __fadd_rn(s, partial[(long long)b * n + i]);
    s = warp_sum(s);
    if (lane == 0) {
      const float den = nan_max(__fsqrt_rn(s), eps);
      raw[i] = (mode == kWeiszfeld)
                   ? __fdiv_rn(1.0f, den)
                   : __fmul_rn(nan_min(1.0f, __fdiv_rn(c_tau, den)), __frcp_rn((float)n));
    }
  }
  __syncthreads();
  if (t == 0) {
    float total = 0.0f;
    for (int i = 0; i < n; ++i) total = __fadd_rn(total, raw[i]);
    for (int i = 0; i < n; ++i) wa[i] = (mode == kWeiszfeld) ? __fdiv_rn(raw[i], total) : raw[i];
    wa[n] = (mode == kWeiszfeld) ? 0.0f : __fsub_rn(1.0f, total);
  }
}

template <typename T>
__global__ void __launch_bounds__(kSweepThreads)
center_sweep_kernel(const T* __restrict__ x, const T* __restrict__ z, const float* __restrict__ w,
                    const float* __restrict__ alpha, T* __restrict__ out, int n, long long d) {
  __shared__ float ws[128];
  if (threadIdx.x < n) ws[threadIdx.x] = w[threadIdx.x];
  __syncthreads();
  const long long c = (long long)blockIdx.x * kSweepThreads + threadIdx.x;
  if (c >= d) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, __fmul_rn(to_f32(x[(long long)i * d + c]), ws[i]));
  out[c] = from_f32<T>(__fadd_rn(__fmul_rn(*alpha, to_f32(z[c])), acc));
}

template <typename T>
void launch_partial(const void* x, const void* z, float* partial, int n, long long d,
                    long long chunk, int nchunks, cudaStream_t s) {
  center_dist_partial_kernel<T><<<nchunks, kDistThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(z), partial, n, d, chunk);
}

template <typename T>
void launch_sweep(const void* x, const void* z, const float* w, const float* alpha, void* out,
                  int n, long long d, cudaStream_t s) {
  const unsigned blocks = (unsigned)((d + kSweepThreads - 1) / kSweepThreads);
  center_sweep_kernel<T><<<blocks, kSweepThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(z), w, alpha, static_cast<T*>(out), n, d);
}

}  // namespace

// x: (n, d) contiguous; z: (d,) of x's dtype; partial: nchunks * n f32
// scratch with nchunks * chunk >= d; wa: n + 1 f32 out (the weights, then
// alpha). mode 0 = weiszfeld, 1 = clip. Returns the launches' cudaError_t.
extern "C" int byz_center_weights(const void* x, const void* z, float* partial, float* wa,
                                  int n, long long d, long long chunk, int nchunks, int mode,
                                  float eps, float c_tau, int dtype, void* stream) {
  if (n < 1 || n > 128 || d < 1 || chunk < 1 || nchunks < 1 || (long long)nchunks * chunk < d ||
      (mode != kWeiszfeld && mode != kClip))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: launch_partial<float>(x, z, partial, n, d, chunk, nchunks, s); break;
    case kBF16: launch_partial<__nv_bfloat16>(x, z, partial, n, d, chunk, nchunks, s); break;
    case kF16: launch_partial<__half>(x, z, partial, n, d, chunk, nchunks, s); break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  center_weights_kernel<<<1, kWeightThreads, 0, s>>>(partial, wa, n, nchunks, mode, eps, c_tau);
  return cudaGetLastError();
}

// x: (n, d) contiguous; z, out: (d,) of x's dtype; w: n f32; alpha: 1 f32.
extern "C" int byz_center_sweep(const void* x, const void* z, const float* w, const float* alpha,
                                void* out, int n, long long d, int dtype, void* stream) {
  if (n < 1 || n > 128) return cudaErrorInvalidValue;
  if (d <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: launch_sweep<float>(x, z, w, alpha, out, n, d, s); break;
    case kBF16: launch_sweep<__nv_bfloat16>(x, z, w, alpha, out, n, d, s); break;
    case kF16: launch_sweep<__half>(x, z, w, alpha, out, n, d, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
