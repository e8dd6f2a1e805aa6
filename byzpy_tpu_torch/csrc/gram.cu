// B3: Gram matrix x @ x^T of K stacked (n, d) rounds, f32 accumulation.
//
// Replaces byzpy_tpu/ops/pallas_kernels.py:289 _gram_kernel (pallas_call at
// :329) and the Gram phase of the fused selection kernel
// (_accumulate_gram, :820). The TPU kernel adds every feature tile into one
// (n, n) output block over a sequential grid. CUDA blocks run in no order,
// so the sum is split in two launches:
//   1. split-K: block b takes columns [b * chunk, (b + 1) * chunk) and
//      writes its partial (NPAD, NPAD) Gram, upper triangle only, in exact
//      f32 FFMA (no TF32, no tensor cores);
//   2. one thread per upper-triangle entry sums the partials in chunk order
//      and mirrors the entry. The wrapper sizes the chunks from the card's
//      SM count (ops/kernels.py:gram), with a floor of 512 columns. No float atomics: the same input gives the
//      same bits on every run.
//
// Bound: memory at n = 64 (one read of x: 268 MB at 64 x 1,048,576 f32,
// ~80 us at 3.35 TB/s; the symmetric half is 4.4 GFLOP, ~66 us at 67 TFLOP/s
// f32). Design: each block stages a 32-column tile of all NPAD rows in
// shared memory with coalesced row loads; 136 threads each own one TM x TM
// register tile of the upper triangle of the 16 x 16 tile grid
// (TM = NPAD / 16), so every shared-memory read feeds TM FMAs.

#include "common.cuh"

namespace {

constexpr int kTK = 32;            // columns per shared-memory tile
constexpr int kTiles = 16;         // the output is a kTiles x kTiles grid of TM x TM tiles
constexpr int kUpper = kTiles * (kTiles + 1) / 2;  // 136 upper-triangle tiles
constexpr int kGramThreads = 160;  // 5 warps: 136 compute threads, all load
constexpr int kReduceThreads = 256;

template <typename T, int NPAD>
__global__ void __launch_bounds__(kGramThreads)
gram_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, int n,
                    long long d, long long chunk, int nchunks) {
  constexpr int TM = NPAD / kTiles;
  __shared__ float tile[kTK][NPAD + 1];
  const int b = blockIdx.x, k = blockIdx.y, tid = threadIdx.x;
  const bool active = tid < kUpper;
  int ti = 0, tj = 0;
  if (active) {  // row-major walk of the upper triangle
    int t = tid;
    while (t >= kTiles - ti) {
      t -= kTiles - ti;
      ++ti;
    }
    tj = ti + t;
  }
  float acc[TM][TM];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TM; ++v) acc[u][v] = 0.0f;

  const T* xk = x + (long long)k * n * d;
  const long long c0 = (long long)b * chunk;
  const long long c1 = (c0 + chunk < d) ? c0 + chunk : d;
  for (long long base = c0; base < c1; base += kTK) {
    for (int e = tid; e < NPAD * kTK; e += kGramThreads) {
      const int r = e / kTK, kk = e % kTK;
      const long long col = base + kk;
      tile[kk][r] = (r < n && col < c1) ? to_f32(xk[(long long)r * d + col]) : 0.0f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int kk = 0; kk < kTK; ++kk) {
        float a[TM], bv[TM];
#pragma unroll
        for (int u = 0; u < TM; ++u) {
          a[u] = tile[kk][ti * TM + u];
          bv[u] = tile[kk][tj * TM + u];
        }
#pragma unroll
        for (int u = 0; u < TM; ++u)
#pragma unroll
          for (int v = 0; v < TM; ++v) acc[u][v] = fmaf(a[u], bv[v], acc[u][v]);
      }
    }
    __syncthreads();
  }
  if (active) {
    float* pk = partial + ((long long)k * nchunks + b) * NPAD * NPAD;
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TM; ++v) pk[(ti * TM + u) * NPAD + tj * TM + v] = acc[u][v];
  }
}

// Entry (i, j), i <= j, lies in an upper-triangle tile (i / TM <= j / TM),
// so every partial holds it.
__global__ void __launch_bounds__(kReduceThreads)
gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                   int n, int npad, int nchunks) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  const int k = blockIdx.y;
  if (e >= npad * npad) return;
  const int i = e / npad, j = e % npad;
  if (i >= n || j >= n || i > j) return;
  const long long plane = (long long)npad * npad;
  const float* pk = partial + (long long)k * nchunks * plane + e;
  float s = 0.0f;
  for (int b = 0; b < nchunks; ++b) s = __fadd_rn(s, pk[b * plane]);
  float* ok = out + (long long)k * n * n;
  ok[i * n + j] = s;
  ok[j * n + i] = s;
}

template <typename T, int NPAD>
void launch_partial(const void* x, float* partial, int K, int n, long long d,
                    long long chunk, int nchunks, cudaStream_t s) {
  const dim3 grid((unsigned)nchunks, (unsigned)K);
  gram_partial_kernel<T, NPAD><<<grid, kGramThreads, 0, s>>>(
      static_cast<const T*>(x), partial, n, d, chunk, nchunks);
}

template <typename T>
bool launch_typed(const void* x, float* partial, int K, int n, long long d,
                  long long chunk, int nchunks, int npad, cudaStream_t s) {
  switch (npad) {
    case 16: launch_partial<T, 16>(x, partial, K, n, d, chunk, nchunks, s); return true;
    case 32: launch_partial<T, 32>(x, partial, K, n, d, chunk, nchunks, s); return true;
    case 64: launch_partial<T, 64>(x, partial, K, n, d, chunk, nchunks, s); return true;
    case 128: launch_partial<T, 128>(x, partial, K, n, d, chunk, nchunks, s); return true;
    default: return false;
  }
}

}  // namespace

// x: (K, n, d) contiguous; partial: K * nchunks * npad * npad f32 scratch;
// out: (K, n, n) f32. npad is max(16, network_width(n)); chunk a multiple
// of 32 with nchunks * chunk >= d. Returns the launches' cudaError_t.
extern "C" int byz_gram(const void* x, float* partial, float* out, int K, int n,
                        long long d, long long chunk, int nchunks, int npad,
                        int dtype, void* stream) {
  const int want = network_width(n) < 16 ? 16 : network_width(n);
  if (n < 1 || n > 128 || npad != want || chunk % kTK != 0 || nchunks < 1 ||
      (long long)nchunks * chunk < d)
    return cudaErrorInvalidValue;
  if (K <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (dtype) {
    case kF32: ok = launch_typed<float>(x, partial, K, n, d, chunk, nchunks, npad, s); break;
    case kBF16: ok = launch_typed<__nv_bfloat16>(x, partial, K, n, d, chunk, nchunks, npad, s); break;
    case kF16: ok = launch_typed<__half>(x, partial, K, n, d, chunk, nchunks, npad, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 rgrid((unsigned)((npad * npad + kReduceThreads - 1) / kReduceThreads), (unsigned)K);
  gram_reduce_kernel<<<rgrid, kReduceThreads, 0, s>>>(partial, out, n, npad, nchunks);
  return cudaGetLastError();
}
