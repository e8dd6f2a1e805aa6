// B2: every column of an (n, d) matrix sorted ascending, the whole sorted
// matrix written back.
//
// Replaces byzpy_tpu/ops/pallas_kernels.py:155 _sort_columns_kernel
// (pallas_call at :235). What it computes: the n values of each column are
// mapped to int32 total-order keys (from the f32 up-cast: -inf < finite <
// +inf < NaN, -0.0 before +0.0, NaN canonical) and sorted with Batcher's
// merge-exchange network; every sorted key goes back as a value of x's
// dtype. The key sort is a permutation, so no value bit changes but the
// documented ones (NaN canonicalized). 16-bit floats take the exact f32
// round trip.
//
// Bound: memory. One read and one write of the (n, d) matrix; the network
// is ~n/2 log^2 n integer min/max per column, well under the card's ALU
// rate at n <= 128. Design: B1's (sorted_reduce.cu): one thread per
// column, a block of 256 neighbouring columns, so every row load and every
// row store is one coalesced transaction across the block; the network
// width NPAD (8..128) is a template parameter and the network is expanded
// at compile time (common.cuh:batcher_sort), so the keys stay in registers
// and every store reads a register by a compile-time index. Rows n..NPAD-1
// are padding keys above every real key (PAD_KEY); they sink to the bottom
// and are never stored.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int NPAD>
__global__ void __launch_bounds__(kThreads)
sort_columns_kernel(const T* __restrict__ x, T* __restrict__ out, int n, long long d) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  int32_t keys[NPAD];
#pragma unroll
  for (int i = 0; i < NPAD; ++i)
    keys[i] = (i < n) ? float_sort_key(to_f32(x[(long long)i * d + c])) : PAD_KEY;
  batcher_sort<NPAD>(keys);
#pragma unroll
  for (int i = 0; i < NPAD; ++i)
    if (i < n) out[(long long)i * d + c] = from_f32<T>(key_to_float(keys[i]));
}

template <typename T>
cudaError_t launch(const void* x, void* out, int n, long long d, cudaStream_t stream) {
  const unsigned grid = (unsigned)((d + kThreads - 1) / kThreads);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  switch (network_width(n)) {
    case 8: sort_columns_kernel<T, 8><<<grid, kThreads, 0, stream>>>(xp, op, n, d); break;
    case 16: sort_columns_kernel<T, 16><<<grid, kThreads, 0, stream>>>(xp, op, n, d); break;
    case 32: sort_columns_kernel<T, 32><<<grid, kThreads, 0, stream>>>(xp, op, n, d); break;
    case 64: sort_columns_kernel<T, 64><<<grid, kThreads, 0, stream>>>(xp, op, n, d); break;
    case 128: sort_columns_kernel<T, 128><<<grid, kThreads, 0, stream>>>(xp, op, n, d); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x, out: (n, d) contiguous, of one dtype. Returns the launch's cudaError_t.
extern "C" int byz_sort_columns(const void* x, void* out, int n, long long d, int dtype,
                                void* stream) {
  if (n < 1 || n > 128) return cudaErrorInvalidValue;
  if (d <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, out, n, d, s);
    case kBF16: return launch<__nv_bfloat16>(x, out, n, d, s);
    case kF16: return launch<__half>(x, out, n, d, s);
    default: return cudaErrorInvalidValue;
  }
}
