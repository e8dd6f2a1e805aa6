// B4: fused score -> select -> weighted mean (Multi-Krum, CGE, MoNNA) over K
// stacked (n, d) rounds, phases 2 and 3.
//
// Replaces byzpy_tpu/ops/pallas_kernels.py:928 _selection_mean_stream_kernel
// (pallas_call at :1036). The TPU kernel keeps the Gram and the weights in
// VMEM scratch across a (K, 2, C) grid. Here the same work is a sequence of
// launches; phase 1 (the Gram) is B3 (gram.cu), and the two launches below
// take the Gram as an argument, so the Gram-given variant
// (_selection_from_gram_kernel, :1094; B5) needs only a new wrapper:
//   2. byz_selection_weights: one block per round. norms = diag(G), d2 =
//      max(n_i + n_j - 2 G_ij, 0) (:763-769); krum scores are the sum of
//      sorted-key rows [1, n - f) of each d2 column with pads at the max
//      key (:772-781, :843-859) -- the diagonal is not special-cased, the
//      sort drops it; cge scores are the norms, monna scores d2[ref]. Ranks
//      put NaN last, pads after NaN, ties by index; the q lowest get weight
//      1/q in f32 (:862-883).
//   3. byz_weighted_rows: out = sum_i (w_i != 0 ? x_i : 0) * w_i in f32,
//      rows ascending, cast to the input dtype (:967-971).
//
// Bound: memory for the sweep, which reads the q selected rows once; the
// weights touch only (n, n) data, and what bounds them is one SM's
// instructions and the latency of the block's barriers.
// Design of the weights: one block of up to 512 threads a round over
// the (n, n) problem (selection_block.cuh), where each thread used to own
// a node and run its own serial loops (a sort of its column in registers,
// n-long walks), with an instance for krum and one for cge and monna,
// picked on the host by mode. krum: up to 8 rows thread j forms, sorts and
// adds column j in registers; from 16 rows on every thread loads its tile
// of the Gram into registers while the block reads the diagonal, forms
// the distances' keys into a padded square buffer, the lanes of a warp
// sort each column, up to 16 consecutive keys a lane in registers
// (KeySort), and thread j adds its column's sorted positions in order.
// cge and monna read the diagonal (and monna row ref) from device memory
// and take no dynamic shared memory. The ranks are counted by parts of the
// block, a slice of the rows each. The finish (select_weights) is B9's and
// B10's. chip_selection_ablation.py --kinds b4 takes it apart.
// Design of the sweep: one thread per column with coalesced row loads and
// rows of weight 0 skipped, so it reads q / n of x instead of all of it.
//
// The sweep also serves B9 and B10 (nnm.cu, clip_selection.cu), whose
// weights are NaN everywhere when the selection took a non-finite row
// (pallas_kernels.py:1454, :1543). It therefore reads every row whose
// weight is not 0, NaN included, so such a weight poisons every column as
// the reference's sum does. B4's weights are 1/q or 0, so its output is
// the one the w > 0 rule gave. Rows the reference zeroes as tainted carry
// weight 0 or sit in an all-NaN weight vector, so the sweep needs no taint
// argument: skipping a weight-0 row drops a term that is exactly +-0.

#include "selection_block.cuh"

namespace {

constexpr int kRowThreads = 256;

// B4's weights block: NPAD x NPAD problem, at most kSelThreads threads
// (512 ran every mode faster than 1,024 at 64 and 128 rows on the H100,
// chip_selection_ablation.py).
constexpr int kSelThreads = 512;

template <int NPAD>
using SelShape = selblock::Shape<NPAD, kSelThreads>;

template <int NPAD, bool KRUM>
__global__ void __launch_bounds__(SelShape<NPAD>::T, 1)
selection_weights_kernel(const float* __restrict__ gram, float* __restrict__ w, int n, int f,
                         int q, int mode, int ref) {
  using S = SelShape<NPAD>;
  extern __shared__ __align__(16) unsigned char dyn[];  // krum_score's keys
  __shared__ float nrm[NPAD];
  __shared__ selblock::Ranked<NPAD> r;
  const int t = threadIdx.x;
  const float* g = gram + (long long)blockIdx.x * n * n;
  // krum: this thread's tile of the Gram, its loads in flight with the diagonal's
  float tile[S::RA][S::RB];
  if constexpr (KRUM && NPAD > 8) selblock::load_tile<S>(DenseGram{g, n}, n, tile);
  if (t < NPAD) nrm[t] = t < n ? g[t * n + t] : __int_as_float(0x7FC00000);
  __syncthreads();
  const float wt = selblock::select_weights<S, NPAD, KRUM>(
      DenseGram{g, n}, [&](int rr, int cc, int, int) { return tile[rr][cc]; },
      reinterpret_cast<int32_t*>(dyn), nrm, n, f, q, mode, ref, r);
  if (t < n) w[(long long)blockIdx.x * n + t] = wt;
}

// One launch of B4's weights at width NPAD: a block a round, an instance
// for krum and one for cge and monna; krum's keys in dynamic shared
// memory, opted in above 48 KB once a device.
template <int NPAD>
cudaError_t launch_weights(const float* gram, float* w, int K, int n, int f, int q, int mode,
                           int ref, cudaStream_t s) {
  constexpr int T = SelShape<NPAD>::T;
  if (mode != kKrum) {
    selection_weights_kernel<NPAD, false><<<K, T, 0, s>>>(gram, w, n, f, q, mode, ref);
    return cudaGetLastError();
  }
  static std::atomic<unsigned long long> ready{0};
  constexpr int dyn = selblock::krum_smem_bytes<NPAD>();
  const cudaError_t err = selblock::raise_smem_once(
      reinterpret_cast<const void*>(&selection_weights_kernel<NPAD, true>), dyn, ready);
  if (err != cudaSuccess) return err;
  selection_weights_kernel<NPAD, true><<<K, T, dyn, s>>>(gram, w, n, f, q, mode, ref);
  return cudaGetLastError();
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

// gram: (K, n, n) f32; w: (K, n) f32 out. Returns the launch's cudaError_t
// (a refused shared-memory opt-in included).
extern "C" int byz_selection_weights(const float* gram, float* w, int K, int n,
                                     int f, int q, int mode, int ref,
                                     void* stream) {
  if (K <= 0) return cudaSuccess;
  if (mode < kKrum || mode > kMonna || ref < 0 || ref >= n) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (network_width(n)) {
    case 8: return launch_weights<8>(gram, w, K, n, f, q, mode, ref, s);
    case 16: return launch_weights<16>(gram, w, K, n, f, q, mode, ref, s);
    case 32: return launch_weights<32>(gram, w, K, n, f, q, mode, ref, s);
    case 64: return launch_weights<64>(gram, w, K, n, f, q, mode, ref, s);
    case 128: return launch_weights<128>(gram, w, K, n, f, q, mode, ref, s);
    default: return cudaErrorInvalidValue;
  }
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
