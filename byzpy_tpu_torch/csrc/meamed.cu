// B6: fused MeaMed (mean around the median) over K stacked (n, d) rounds.
//
// Replaces byzpy_tpu/ops/pallas_kernels.py:619 _meamed_stream_kernel
// (pallas_call at :740). What it computes, per round k and column c, in f32
// from the input dtype:
//   1. the column's total-order keys, sorted (f32: common.cuh's int32 key;
//      bf16 and f16: the 16-bit key of column_sort.cuh:Keys16, which orders
//      as the f32 key of the up-cast does);
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
// Bound: memory, one read of the (K, n, d) input and a (K, d) write; the
// network's int32 min/max (543 a 64-row column) come close to it at the
// card's integer rate, as in B1. Design: the column-sort engine
// (column_sort.cuh) with a round as its slot, as B1 is, and a column
// reduce as its finish. The engine keeps the next tiles' copies in flight
// while a block sorts, then writes the sorted keys back over the column in
// the stage, where steps 2-3 read them at run-time positions (the middle
// rows, s and s + k - 1; a run-time index into a register array would move
// it to local memory); the rows below the cut are counted on the sorted
// keys in registers (up to 64 rows) or by binary searches over the stage
// (65-128). Then the stage is released, and step 4 reads the column again
// from device memory in node order (the producer's bulk copy has just
// passed it through L2). Every step is one IEEE f32 operation of the plain
// version's, so the result is its bits.

#include "column_sort.cuh"

namespace {

// NaN-propagating max / min (jnp.maximum / jnp.minimum; fmaxf and fminf
// drop a NaN operand).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7FC00000) : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7FC00000) : fminf(a, b);
}

// The first p in [lo, hi) where pred(p) holds, pred false and then true.
template <class Pred>
__device__ __forceinline__ int first_true(int lo, int hi, const Pred& pred) {
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (pred(m)) {
      hi = m;
    } else {
      lo = m + 1;
    }
  }
  return lo;
}

// The engine's column reduce for MeaMed: sorted() takes the median, the
// cut and the rows below the cut from the sorted keys (the column's values,
// permuted), value() the select over the column in node order.
template <typename T>
struct MeaMed {
  using K = colsort::Keys<T>;
  static constexpr bool kColumn = true;
  // one stage buffer: B6 ran 10% faster at 64 and 128 rows on it than on
  // the engine's two, and as fast at 8 (chip_selection_ablation.py's
  // one_buffer)
  static constexpr int kRingStages = 1;
  int n, f;
  float med = 0.0f, cut = 0.0f;
  int quota = 0;  // rows at the cut the select takes

  __device__ __forceinline__ MeaMed(int n_, int f_) : n(n_), f(f_) {}

  // The median and the cut, key(p) the sorted key at position p.
  template <class Sorted>
  __device__ __forceinline__ void median_and_cut(const Sorted& key) {
    const float qnan = __int_as_float(0x7FC00000), inf = __int_as_float(0x7F800000);
    const int k = n - f, lo = (n - 1) / 2, hi = n / 2;
    med = K::value(key(lo));
    if (lo != hi) med = __fadd_rn(__fmul_rn(med, 0.5f), __fmul_rn(K::value(key(hi)), 0.5f));
    if (isnan(K::value(key(n - 1)))) med = qnan;
    if (isfinite(med)) {
      // window starts past f are +inf in the reference: start the min there
      cut = inf;
#pragma unroll 4
      for (int s = 0; s <= f; ++s) {
        const float below = __fsub_rn(med, K::value(key(s)));
        const float above = __fsub_rn(K::value(key(s + k - 1)), med);
        cut = nan_min(cut, nan_max(below, above));
      }
    } else {
      int finite_devs = 0;
#pragma unroll 4
      for (int p = 0; p < n; ++p) finite_devs += isnan(fabsf(__fsub_rn(K::value(key(p)), med))) ? 0 : 1;
      cut = (finite_devs >= k) ? inf : qnan;
    }
  }

  // Up to 64 rows (the engine's narrow path): the sorted keys are also in
  // registers, where the rows below the cut are counted.
  template <class Sorted, int N>
  __device__ __forceinline__ void sorted(const Sorted& key, const int32_t (&keys)[N]) {
    median_and_cut(key);
    int below = 0;
#pragma unroll
    for (int p = 0; p < N; ++p)
      below += p < n && fabsf(__fsub_rn(K::value(keys[p]), med)) < cut ? 1 : 0;
    quota = n - f - below;
  }

  // 65-128 rows: |x - med| falls, then rises along the sorted column (its
  // rounding is monotone on each side of med), so the rows below the cut
  // are a run of positions, found by three binary searches.
  template <class Sorted>
  __device__ __forceinline__ void sorted(const Sorted& key) {
    median_and_cut(key);
    const auto dev = [&](int p) { return fabsf(__fsub_rn(K::value(key(p)), med)); };
    int below = 0;
    if (isfinite(med)) {
      const int mid = first_true(0, n, [&](int p) { return K::value(key(p)) >= med; });
      below = first_true(mid, n, [&](int p) { return !(dev(p) < cut); }) -
              first_true(0, mid, [&](int p) { return dev(p) < cut; });
    } else {
#pragma unroll 4
      for (int p = 0; p < n; ++p) below += dev(p) < cut ? 1 : 0;
    }
    quota = n - f - below;
  }

  // The select over the column in node order, col(i) its row i as f32:
  // every row below the cut, then the first `quota` rows at the cut.
  template <class Col>
  __device__ __forceinline__ T select(const Col& col) const {
    if (isnan(cut) || isnan(med)) return from_f32<T>(__int_as_float(0x7FC00000));
    int left = quota;
    float acc = 0.0f;
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const float v = col(i);
      const float dev = fabsf(__fsub_rn(v, med));
      bool take = dev < cut;
      if (dev == cut) take = (left-- > 0);
      if (take) acc = __fadd_rn(acc, v);
    }
    // the reference's `/ k` by a constant compiles to a multiply by the f32
    // reciprocal of k
    return from_f32<T>(__fmul_rn(acc, __frcp_rn((float)(n - f))));
  }

  // x_col: row 0 of this column in x, rows d apart.
  __device__ __forceinline__ T value(const T* __restrict__ x_col, long long d) const {
    return select([=](int i) { return to_f32(x_col[i * d]); });
  }
};

// Registers for three blocks an SM (128 a thread): the ring's shared
// memory holds three blocks an SM, and the finish's state beside the keys
// spilled at B1's 96 (chip_selection_ablation.py's min_blocks_4).
constexpr int kMinBlocks = 3;

template <typename T, int N>
__global__ void __launch_bounds__(colsort::kBlockThreads, kMinBlocks)
meamed_kernel(const T* __restrict__ x, T* __restrict__ out, int n, long long d, int f,
              int run_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long r = blockIdx.y;
  colsort::sort_run<T, N, N>(x, smem, r * n, n, d, run_tiles, out + r * d, MeaMed<T>(n, f));
}

template <typename T>
cudaError_t launch(const void* x, void* out, int K, int n, long long d, int f, int run_tiles,
                   cudaStream_t s) {
  constexpr int Stages = MeaMed<T>::kRingStages;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  switch (network_width(n)) {
    case 8: return colsort::launch<&meamed_kernel<T, 8>, Stages>(K, d, run_tiles, s, xp, op, n, d, f);
    case 16: return colsort::launch<&meamed_kernel<T, 16>, Stages>(K, d, run_tiles, s, xp, op, n, d, f);
    case 32: return colsort::launch<&meamed_kernel<T, 32>, Stages>(K, d, run_tiles, s, xp, op, n, d, f);
    case 64: return colsort::launch<&meamed_kernel<T, 64>, Stages>(K, d, run_tiles, s, xp, op, n, d, f);
    case 128: return colsort::launch<&meamed_kernel<T, 128>, Stages>(K, d, run_tiles, s, xp, op, n, d, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (K, n, d) contiguous; out: (K, d) of the same dtype; 0 <= f < n <= 128;
// run_tiles: the column tiles a block takes (ops/kernels.py:column_runs).
// Returns the launch's cudaError_t.
extern "C" int byz_meamed(const void* x, void* out, int K, int n, long long d, int f,
                          int dtype, int run_tiles, void* stream) {
  if (n < 1 || f < 0 || f >= n) return cudaErrorInvalidValue;
  if (K <= 0 || d <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, out, K, n, d, f, run_tiles, s);
    case kBF16: return launch<__nv_bfloat16>(x, out, K, n, d, f, run_tiles, s);
    case kF16: return launch<__half>(x, out, K, n, d, f, run_tiles, s);
    default: return cudaErrorInvalidValue;
  }
}
