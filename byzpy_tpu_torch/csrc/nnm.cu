// B8: Nearest-Neighbour Mixing over K stacked (n, d) rounds, and B9: NNM
// feeding a selection mean (Multi-Krum, CGE, MoNNA) through the collapsed
// Gram, the mixed matrix never built.
//
// B8 replaces byzpy_tpu/ops/pallas_kernels.py:1245 _nnm_stream_kernel
// (pallas_call at :1332). The TPU kernel keeps the Gram and the selection
// state in VMEM across a (K, 2, C) grid and forms the mixed rows with an
// MXU dot at HIGHEST precision (:1282-1287). Here, after B3's Gram
// (gram.cu):
//   byz_nnm_weights: one block per round, one thread per mixing row i.
//     taint_j = the squared norm G_jj is not finite; row i's k = n - f
//     nearest rows by the stable k-select of selection.cuh give column i of
//     mask_clean (0/1 f32, tainted rows cleared) and sel_taint_i = a tainted
//     row was selected (_nnm_weights :1216-1242).
//   byz_mix_rows: out[i] = (sum_j mask_clean[j][i] * x_j) / k in f32, rows j
//     ascending, NaN where sel_taint_i, cast to x's dtype (:1272-1290).
//     mask_clean is 0/1 and clear on tainted rows, so each term is x_j or
//     an exact +-0, and the sweep adds the selected rows only.
// B9 replaces :1380 _nnm_selection_stream_kernel (pallas_call at :1806):
//   byz_nnm_selection_weights: one block per round. The same selection A
//     (= mask_clean, kept as bytes); G~ = G with tainted rows and columns
//     zeroed; GA = G~ A and Gm = A^T GA / k^2 in f32, sums ascending;
//     rows and columns of Gm whose mixer selected a tainted row set to NaN;
//     the selection weights w_sel of Gm (selection.cuh); w_eff = A w_sel / k,
//     all NaN when a tainted mixer was selected (:1415-1455).
//   then selection.cu's weighted-row sweep, which reads the rows whose
//     w_eff is not 0 (NaN included).
// The (n, n) products multiply by 0/1 entries of A only, so each FFMA of
// the reference is an exact add of a selected term (or of +-0), and the
// kernels add the selected terms in index order.
//
// Bound: memory. The mixing sweep must read x (n x d) and write the mixed
// (n, d) matrix once: 2 n d bytes of its dtype. Design: a block stages a
// 32-column tile of all n rows in shared memory with coalesced row loads;
// each warp forms output rows i = warp, warp + 8, ... for the 32 columns
// from the tile, walking the list of row i's selected rows (built once per
// block and round from mask_clean), so x is read from device memory once.
// Blocks stride over the tiles. The weights blocks touch only (n, n) data;
// B9's GA and Gm take 2 n^2 f32 of dynamic shared memory (128 KB at n =
// 128), above the 48 KB a block gets without opting in, so the launcher
// raises the block's limit with cudaFuncSetAttribute before the launch.

#include "selection.cuh"

namespace {

constexpr int kMixCols = 32;
constexpr int kMixThreads = 256;
constexpr int kMixWarps = kMixThreads / 32;

__device__ __forceinline__ float canonical_nan() { return __int_as_float(0x7FC00000); }

template <int NPAD>
__global__ void __launch_bounds__(NPAD)
nnm_weights_kernel(const float* __restrict__ gram, float* __restrict__ mask,
                   float* __restrict__ sel_taint, int n, int k) {
  __shared__ float norms[NPAD];
  __shared__ int taint[NPAD];
  const int r = blockIdx.x, i = threadIdx.x;
  const DenseGram gat{gram + (long long)r * n * n, n};
  norms[i] = (i < n) ? gat(i, i) : 0.0f;
  taint[i] = (i < n && !isfinite(norms[i])) ? 1 : 0;
  __syncthreads();
  if (i >= n) return;
  const int st = nnm_select_column<NPAD>(gat, n, k, i, norms, taint,
                                         mask + (long long)r * n * n, n);
  sel_taint[(long long)r * n + i] = st ? 1.0f : 0.0f;
}

template <typename T, int NPAD>
__global__ void __launch_bounds__(kMixThreads)
mix_rows_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                const float* __restrict__ sel_taint, T* __restrict__ out, int n, int k,
                long long d, long long tiles_per_round, long long total_tiles) {
  __shared__ float tile[NPAD][kMixCols];
  __shared__ unsigned char src[NPAD][NPAD];  // src[i][s]: row i's s-th selected row
  __shared__ int count[NPAD];
  __shared__ int poisoned[NPAD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int cur_round = -1;
  for (long long t = blockIdx.x; t < total_tiles; t += gridDim.x) {
    const int kr = (int)(t / tiles_per_round);
    const long long c0 = (t % tiles_per_round) * kMixCols;
    if (kr != cur_round) {  // the same for the whole block
      __syncthreads();  // the last round's lists are no longer read
      if (tid < n) {
        const float* m = mask + (long long)kr * n * n;
        int c = 0;
        for (int j = 0; j < n; ++j)
          if (m[j * n + tid] != 0.0f) src[tid][c++] = (unsigned char)j;
        count[tid] = c;
        poisoned[tid] = sel_taint[(long long)kr * n + tid] != 0.0f;
      }
      cur_round = kr;
    }
    __syncthreads();  // lists ready; the last tile is no longer read
    const T* xk = x + (long long)kr * n * d;
    for (int e = tid; e < n * kMixCols; e += kMixThreads) {
      const int row = e / kMixCols, cc = e % kMixCols;
      const long long col = c0 + cc;
      tile[row][cc] = (col < d) ? to_f32(xk[(long long)row * d + col]) : 0.0f;
    }
    __syncthreads();
    const long long col = c0 + lane;
    if (col < d) {
      T* ok = out + (long long)kr * n * d + col;
      for (int i = warp; i < n; i += kMixWarps) {
        float acc = 0.0f;
        const int ci = count[i];
        for (int s = 0; s < ci; ++s) acc = __fadd_rn(acc, tile[src[i][s]][lane]);
        const float v = poisoned[i] ? canonical_nan() : __fdiv_rn(acc, (float)k);
        ok[(long long)i * d] = from_f32<T>(v);
      }
    }
  }
}

template <int NPAD>
__global__ void __launch_bounds__(NPAD)
nnm_selection_weights_kernel(const float* __restrict__ gram, float* __restrict__ w, int n,
                             int k, int f, int q, int mode, int ref) {
  extern __shared__ float dyn[];  // GA (n x n), then Gm (n x n)
  float* ga = dyn;
  float* gm = dyn + n * n;
  __shared__ unsigned char A[NPAD * NPAD];  // A[j * NPAD + i]: mixer i took row j
  __shared__ float norms[NPAD];
  __shared__ int taint[NPAD];
  __shared__ int sel_taint[NPAD];
  __shared__ float w_sel[NPAD];
  __shared__ int picked_tainted;
  const int r = blockIdx.x, i = threadIdx.x;
  const float* g = gram + (long long)r * n * n;
  const DenseGram gat{g, n};
  norms[i] = (i < n) ? gat(i, i) : 0.0f;
  taint[i] = (i < n && !isfinite(norms[i])) ? 1 : 0;
  if (i == 0) picked_tainted = 0;
  __syncthreads();
  sel_taint[i] = (i < n) ? nnm_select_column<NPAD>(gat, n, k, i, norms, taint, A, NPAD) : 0;
  __syncthreads();
  if (i < n) {  // column i of GA = G~ A; a tainted row of G~ is all 0
    for (int j = 0; j < n; ++j) {
      float acc = 0.0f;
      if (!taint[j])
        for (int l = 0; l < n; ++l)
          if (A[l * NPAD + i]) acc = __fadd_rn(acc, g[j * n + l]);
      ga[j * n + i] = acc;
    }
  }
  __syncthreads();
  if (i < n) {  // column i of Gm = A^T GA / k^2
    const float kk = (float)(k * k);
    for (int m = 0; m < n; ++m) {
      float acc = 0.0f;
      for (int l = 0; l < n; ++l)
        if (A[l * NPAD + m]) acc = __fadd_rn(acc, ga[l * n + i]);
      gm[m * n + i] = (sel_taint[m] || sel_taint[i]) ? canonical_nan() : __fdiv_rn(acc, kk);
    }
  }
  __syncthreads();
  const float ws = selection_weight<NPAD>(DenseGram{gm, n}, n, f, q, mode, ref);
  w_sel[i] = ws;
  if (ws > 0.0f && sel_taint[i]) atomicOr(&picked_tainted, 1);
  __syncthreads();
  if (i >= n) return;
  float acc = 0.0f;  // row i of A w_sel
  for (int m = 0; m < n; ++m)
    if (A[i * NPAD + m]) acc = __fadd_rn(acc, w_sel[m]);
  w[(long long)r * n + i] = picked_tainted ? canonical_nan() : __fdiv_rn(acc, (float)k);
}

template <typename T>
bool launch_mix(const void* x, const float* mask, const float* sel_taint, void* out, int K,
                int n, int k, long long d, int blocks, cudaStream_t s) {
  const long long tiles = (d + kMixCols - 1) / kMixCols;
  const long long total = tiles * K;
  const unsigned grid = (unsigned)(total < blocks ? total : blocks);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  switch (network_width(n)) {
    case 8: mix_rows_kernel<T, 8><<<grid, kMixThreads, 0, s>>>(xt, mask, sel_taint, ot, n, k, d, tiles, total); return true;
    case 16: mix_rows_kernel<T, 16><<<grid, kMixThreads, 0, s>>>(xt, mask, sel_taint, ot, n, k, d, tiles, total); return true;
    case 32: mix_rows_kernel<T, 32><<<grid, kMixThreads, 0, s>>>(xt, mask, sel_taint, ot, n, k, d, tiles, total); return true;
    case 64: mix_rows_kernel<T, 64><<<grid, kMixThreads, 0, s>>>(xt, mask, sel_taint, ot, n, k, d, tiles, total); return true;
    case 128: mix_rows_kernel<T, 128><<<grid, kMixThreads, 0, s>>>(xt, mask, sel_taint, ot, n, k, d, tiles, total); return true;
    default: return false;
  }
}

template <int NPAD>
cudaError_t launch_nnm_selection(const float* gram, float* w, int K, int n, int k, int f,
                                 int q, int mode, int ref, cudaStream_t s) {
  const int dyn = 2 * n * n * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&nnm_selection_weights_kernel<NPAD>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  nnm_selection_weights_kernel<NPAD><<<K, NPAD, dyn, s>>>(gram, w, n, k, f, q, mode, ref);
  return cudaGetLastError();
}

}  // namespace

// gram: (K, n, n) f32; mask: (K, n, n) f32 out (mask[j][i]: row i mixes row
// j); sel_taint: (K, n) f32 out. k = n - f in [1, n]. Returns the launch's
// cudaError_t.
extern "C" int byz_nnm_weights(const float* gram, float* mask, float* sel_taint, int K, int n,
                               int k, void* stream) {
  if (K <= 0) return cudaSuccess;
  if (k < 1 || k > n) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (network_width(n)) {
    case 8: nnm_weights_kernel<8><<<K, 8, 0, s>>>(gram, mask, sel_taint, n, k); break;
    case 16: nnm_weights_kernel<16><<<K, 16, 0, s>>>(gram, mask, sel_taint, n, k); break;
    case 32: nnm_weights_kernel<32><<<K, 32, 0, s>>>(gram, mask, sel_taint, n, k); break;
    case 64: nnm_weights_kernel<64><<<K, 64, 0, s>>>(gram, mask, sel_taint, n, k); break;
    case 128: nnm_weights_kernel<128><<<K, 128, 0, s>>>(gram, mask, sel_taint, n, k); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x: (K, n, d) contiguous; mask: (K, n, n) f32; sel_taint: (K, n) f32; out:
// (K, n, d) of x's dtype. blocks: how many blocks stride over the tiles.
extern "C" int byz_mix_rows(const void* x, const float* mask, const float* sel_taint, void* out,
                            int K, int n, int k, long long d, int blocks, int dtype,
                            void* stream) {
  if (K <= 0 || d <= 0) return cudaSuccess;
  if (k < 1 || k > n || blocks < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (dtype) {
    case kF32: ok = launch_mix<float>(x, mask, sel_taint, out, K, n, k, d, blocks, s); break;
    case kBF16: ok = launch_mix<__nv_bfloat16>(x, mask, sel_taint, out, K, n, k, d, blocks, s); break;
    case kF16: ok = launch_mix<__half>(x, mask, sel_taint, out, K, n, k, d, blocks, s); break;
    default: break;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// gram: (K, n, n) f32; w: (K, n) f32 out, the source-row weights w_eff.
// k = n - f_nnm. Returns the launch's cudaError_t (a refused shared-memory
// opt-in included).
extern "C" int byz_nnm_selection_weights(const float* gram, float* w, int K, int n, int k,
                                         int f, int q, int mode, int ref, void* stream) {
  if (K <= 0) return cudaSuccess;
  if (k < 1 || k > n || mode < kKrum || mode > kMonna || ref < 0 || ref >= n)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (network_width(n)) {
    case 8: return launch_nnm_selection<8>(gram, w, K, n, k, f, q, mode, ref, s);
    case 16: return launch_nnm_selection<16>(gram, w, K, n, k, f, q, mode, ref, s);
    case 32: return launch_nnm_selection<32>(gram, w, K, n, k, f, q, mode, ref, s);
    case 64: return launch_nnm_selection<64>(gram, w, K, n, k, f, q, mode, ref, s);
    case 128: return launch_nnm_selection<128>(gram, w, K, n, k, f, q, mode, ref, s);
    default: return cudaErrorInvalidValue;
  }
}
