// Segmented sort-reduce: the f-trimmed coordinate mean or the coordinate
// median of every cohort of a ragged batch, in one launch.
//
// Replaces, on the ragged door's sort family, the generic masked door's B2
// launches (csrc/sort_columns.cu over the whole row capacity, once per
// cohort slot) and its B11 window sums. It has no Pallas counterpart: it is
// the port's form of the reference's segmented programs, one two-key
// lax.sort over (segment, value key) followed by the windowed einsum or the
// midpoint gathers (byzpy_tpu/ops/ragged.py:96-192, ragged_trimmed_mean /
// ragged_median).
//
// What it computes. Cohort slot c holds rows [offsets[c], offsets[c] + m)
// of the (R, d) f32 matrix, m = lengths[c]. For each column, the m values
// are mapped to int32 total-order keys (common.cuh:float_sort_key) and
// sorted; then
//   trimmed: key_to_float of sorted positions [f, m - f) summed with
//     __fadd_rn in ascending order from +0.0, times __fdiv_rn(1, m - 2f)
//     (__fmul_rn). That is the reference's zero-masked window chain:
//     fma(1, x, acc) = RN(acc + x), and a zero outside the window leaves
//     acc as it is (a chain from +0.0 never holds -0.0);
//   median: s[(m - 1) / 2] for odd m, else __fmul_rn(__fadd_rn(s_lo, s_hi),
//     0.5f), as ragged_median's (s_lo + s_hi) * 0.5.
// A slot of length 0 (a batch's padding) writes zeros; a slot whose rows
// leave [0, R), or that holds more than 128 rows (the network's width),
// reads nothing and writes NaN. NaN leaves canonical. R itself is free.
//
// Bound: memory, one read of the cohorts' rows and a (C, d) write (0.0589
// ms for cohorts of 6, 13, 29 and 64 rows at d = 421,642 on an H100); the
// compare-exchanges (19 + 63 + 191 + 543 a column there) cost as much time
// at the card's int32 min/max rate. The engine (column_sort.cuh) keeps the
// next tiles' loads in flight while a block sorts: a block walks a run of
// column tiles of one cohort slot, reading the slot's offset and length
// from device memory (no host read; rows outside every cohort are never
// touched). chip_segmented_ablation.py takes the kernel apart.

#include "column_sort.cuh"

namespace {

enum Mode { kMedian = 0, kTrimmed = 1 };

using K = colsort::Keys<float>;

// trimmed: the window [f, m - f) times the rounded reciprocal of m - 2f;
// median: the middle key, or the midpoint of the two.
struct Reduce : colsort::Window<K> {
  __device__ __forceinline__ Reduce(int mode, int m, int f)
      : colsort::Window<K>(mode == kTrimmed, mode == kTrimmed ? f : (m - 1) / 2,
                           mode == kTrimmed ? m - f : m / 2, m - 1) {}

  __device__ __forceinline__ float value() const {
    float v;
    if (this->sum) {
      v = __fmul_rn(this->acc, __fdiv_rn(1.0f, (float)(this->hi - this->lo)));
    } else {
      const float a = K::value(this->klo);
      v = this->lo == this->hi ? a : __fmul_rn(__fadd_rn(a, K::value(this->khi)), 0.5f);
    }
    return from_f32<float>(v);
  }
};

__global__ void __launch_bounds__(colsort::kBlockThreads, colsort::kMinBlocks)
segmented_sort_reduce_kernel(const float* __restrict__ x, const int* __restrict__ offsets,
                             const int* __restrict__ lengths, float* __restrict__ out, int R,
                             long long d, int mode, int f, int run_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = blockIdx.y;
  const int o = offsets[c], m = lengths[c];
  float* oc = out + (long long)c * d;
  if (m <= 0 || m > 128 || o < 0 || (long long)o + m > R) {
    colsort::fill_run(oc, d, run_tiles, m == 0 ? 0.0f : __int_as_float(0x7FC00000));
    return;
  }
  colsort::sort_run<float, 8, 128>(x, smem, o, m, d, run_tiles, oc, Reduce(mode, m, f));
}

}  // namespace

// x: (R, d) f32 contiguous, any R; offsets, lengths: (C,) int32 on x's
// device; out: (C, d) f32. mode 0 = median, 1 = trimmed mean (f trimmed at
// each end); run_tiles: the column tiles a block takes
// (ops/kernels.py:column_runs). Returns the launch's cudaError_t.
extern "C" int byz_segmented_sort_reduce(const void* x, const void* offsets, const void* lengths,
                                         void* out, int R, int C, long long d, int mode, int f,
                                         int run_tiles, void* stream) {
  if (R < 0 || C < 0 || C > 65535 || f < 0) return cudaErrorInvalidValue;
  if (mode != kMedian && mode != kTrimmed) return cudaErrorInvalidValue;
  if (C == 0 || d <= 0) return cudaSuccess;
  return colsort::launch<&segmented_sort_reduce_kernel>(
      C, d, run_tiles, static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
      static_cast<const int*>(offsets), static_cast<const int*>(lengths), static_cast<float*>(out), R,
      d, mode, f);
}
