// B1: fused column sort + reduce (coordinate median or f-trimmed mean)
// over K stacked rounds.
//
// Replaces byzpy_tpu/ops/pallas_kernels.py:363 _sorted_reduce_stream_kernel
// (pallas_call at :440). What it computes: for each round k and column c,
// the n values x[k, :, c] are mapped to total-order keys and sorted (f32:
// the int32 key of common.cuh:float_sort_key; bf16 and f16: the 16-bit
// key of column_sort.cuh:Keys16, which orders as the f32 key of the
// up-cast does); the kernel emits only the median (midpoint in the output
// dtype, NaN iff the column holds a NaN) or the f32 mean of sorted rows
// [f, n - f).
//
// Bound: memory, one read of the (K, n, d) input and a (K, d) write; at n =
// 64 the network's int32 min/max cost ~0.84 of the read at the card's
// integer rate. It is the column-sort engine (column_sort.cuh) with a round
// as its slot: row k n of the (K n, d) matrix, n rows, n checked on the
// host. One instance a network width and dtype (the mode is a runtime
// argument), so a narrow round is not sized for 64 keys; n of 65-128 takes the engine's two runs of 64 and a merge,
// never a 128-key network in registers.

#include "column_sort.cuh"

namespace {

enum Mode { kMedian = 0, kTrimmed = 1 };

// median: the midpoint computed in the output dtype (each op rounds once,
// as jnp.median does on 16-bit floats), NaN iff the last key is a NaN;
// trimmed: the window [f, n - f) over n - 2f.
template <typename T>
struct Reduce : colsort::Window<colsort::Keys<T>, true> {
  using K = colsort::Keys<T>;
  using W = colsort::Window<K, true>;
  __device__ __forceinline__ Reduce(int mode, int n, int f)
      : W(mode == kTrimmed, mode == kTrimmed ? f : (n - 1) / 2, mode == kTrimmed ? n - f : n / 2, n - 1) {}

  __device__ __forceinline__ T value() const {
    if (this->sum) return from_f32<T>(__fdiv_rn(this->acc, (float)(this->hi - this->lo)));
    const T vlo = from_f32<T>(K::value(this->klo));
    const T vhi = from_f32<T>(K::value(this->khi));
    const T sum = from_f32<T>(__fadd_rn(to_f32(vlo), to_f32(vhi)));
    const T res = from_f32<T>(__fmul_rn(to_f32(sum), 0.5f));  // NaN if -inf and +inf meet
    return isnan(K::value(this->klast)) ? from_f32<T>(__int_as_float(0x7FC00000)) : res;
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(colsort::kBlockThreads, colsort::kMinBlocks)
sorted_reduce_kernel(const T* __restrict__ x, T* __restrict__ out, int n, long long d, int mode,
                     int f, int run_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long k = blockIdx.y;
  colsort::sort_run<T, N, N>(x, smem, k * n, n, d, run_tiles, out + k * d, Reduce<T>(mode, n, f));
}

template <typename T>
cudaError_t launch(const void* x, void* out, int K, int n, long long d, int mode, int f,
                   int run_tiles, cudaStream_t s) {
  if (mode != kMedian && mode != kTrimmed) return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  switch (network_width(n)) {
    case 8: return colsort::launch<&sorted_reduce_kernel<T, 8>>(K, d, run_tiles, s, xp, op, n, d, mode, f);
    case 16: return colsort::launch<&sorted_reduce_kernel<T, 16>>(K, d, run_tiles, s, xp, op, n, d, mode, f);
    case 32: return colsort::launch<&sorted_reduce_kernel<T, 32>>(K, d, run_tiles, s, xp, op, n, d, mode, f);
    case 64: return colsort::launch<&sorted_reduce_kernel<T, 64>>(K, d, run_tiles, s, xp, op, n, d, mode, f);
    case 128: return colsort::launch<&sorted_reduce_kernel<T, 128>>(K, d, run_tiles, s, xp, op, n, d, mode, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (K, n, d) contiguous; out: (K, d) of the same dtype.
// mode 0 = median, 1 = trimmed mean; run_tiles: the column tiles a block
// takes (ops/kernels.py:column_runs). Returns the launch's cudaError_t.
extern "C" int byz_sorted_reduce(const void* x, void* out, int K, int n,
                                 long long d, int mode, int f, int dtype,
                                 int run_tiles, void* stream) {
  if (K <= 0 || d <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, out, K, n, d, mode, f, run_tiles, s);
    case kBF16: return launch<__nv_bfloat16>(x, out, K, n, d, mode, f, run_tiles, s);
    case kF16: return launch<__half>(x, out, K, n, d, mode, f, run_tiles, s);
    default: return cudaErrorInvalidValue;
  }
}
