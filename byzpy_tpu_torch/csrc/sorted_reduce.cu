// B1: fused column sort + reduce (coordinate median or f-trimmed mean)
// over K stacked rounds.
//
// Replaces byzpy_tpu/ops/pallas_kernels.py:363 _sorted_reduce_stream_kernel
// (pallas_call at :440). What it computes: for each round k and column c,
// the n values x[k, :, c] are mapped to int32 total-order keys (from the
// f32 up-cast) and sorted with Batcher's network; the kernel emits only
// the median (midpoint in the output dtype, NaN iff the column holds a
// NaN) or the f32 mean of sorted rows [f, n - f).
//
// Bound: memory. One read of the (K, n, d) input and a (K, d) write; the
// network is ~n/2 log^2 n integer min/max per column, well under the
// card's ALU rate at n <= 128. Design: one thread per column, a block of
// 256 neighbouring columns, so every row load is one coalesced 1 KB (f32)
// transaction across the block; the whole column stays in registers and
// nothing but the reduction goes back to memory. The network width NPAD
// is a template parameter (8..128) and the network is expanded at compile
// time, so the keys stay in registers: ptxas reports no spills, but
// NPAD = 128 takes ~210 registers a thread, one 256-thread block per SM
// (a shared-memory or warp-cooperative sort is not done yet).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int NPAD>
__global__ void __launch_bounds__(kThreads)
sorted_reduce_kernel(const T* __restrict__ x, T* __restrict__ out, int n,
                     long long d, int mode, int f) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int k = blockIdx.y;
  if (c >= d) return;
  const T* xk = x + (long long)k * n * d + c;
  int32_t keys[NPAD];
#pragma unroll
  for (int i = 0; i < NPAD; ++i)
    keys[i] = (i < n) ? float_sort_key(to_f32(xk[(long long)i * d])) : PAD_KEY;
  batcher_sort<NPAD>(keys);
  T res;
  if (mode == 0) {
    // median: midpoint computed in the output dtype (each op rounds once,
    // as jnp.median does on 16-bit floats)
    const T vlo = from_f32<T>(key_to_float(select_key(keys, (n - 1) / 2)));
    const T vhi = from_f32<T>(key_to_float(select_key(keys, n / 2)));
    const T sum = from_f32<T>(__fadd_rn(to_f32(vlo), to_f32(vhi)));
    res = from_f32<T>(__fmul_rn(to_f32(sum), 0.5f));  // NaN if -inf and +inf meet
    if (select_key(keys, n - 1) > INF_KEY) res = from_f32<T>(__int_as_float(0x7FC00000));
  } else {
    const float acc = sum_sorted_range(keys, f, n - f);
    res = from_f32<T>(__fdiv_rn(acc, (float)(n - 2 * f)));
  }
  out[(long long)k * d + c] = res;
}

template <typename T>
cudaError_t launch(const void* x, void* out, int K, int n, long long d,
                   int mode, int f, cudaStream_t stream) {
  const dim3 grid((unsigned)((d + kThreads - 1) / kThreads), (unsigned)K);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  switch (network_width(n)) {
    case 8: sorted_reduce_kernel<T, 8><<<grid, kThreads, 0, stream>>>(xp, op, n, d, mode, f); break;
    case 16: sorted_reduce_kernel<T, 16><<<grid, kThreads, 0, stream>>>(xp, op, n, d, mode, f); break;
    case 32: sorted_reduce_kernel<T, 32><<<grid, kThreads, 0, stream>>>(xp, op, n, d, mode, f); break;
    case 64: sorted_reduce_kernel<T, 64><<<grid, kThreads, 0, stream>>>(xp, op, n, d, mode, f); break;
    case 128: sorted_reduce_kernel<T, 128><<<grid, kThreads, 0, stream>>>(xp, op, n, d, mode, f); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x: (K, n, d) contiguous; out: (K, d) of the same dtype.
// mode 0 = median, 1 = trimmed mean. Returns the launch's cudaError_t.
extern "C" int byz_sorted_reduce(const void* x, void* out, int K, int n,
                                 long long d, int mode, int f, int dtype,
                                 void* stream) {
  if (K <= 0 || d <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, out, K, n, d, mode, f, s);
    case kBF16: return launch<__nv_bfloat16>(x, out, K, n, d, mode, f, s);
    case kF16: return launch<__half>(x, out, K, n, d, mode, f, s);
    default: return cudaErrorInvalidValue;
  }
}
