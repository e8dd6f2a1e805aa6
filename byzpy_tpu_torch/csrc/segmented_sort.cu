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
// leave [0, R) reads nothing and writes NaN. NaN leaves canonical.
//
// Bound: memory. One read of the cohorts' rows and a (C, d) write: 0.0589
// ms for cohorts of 6, 13, 29 and 64 rows at d = 421,642 on an H100. The
// compare-exchanges (19 + 63 + 191 + 543 a column there) stay under it at
// the card's integer rate, but they cost as much time as the read:
// chip_segmented_ablation.py takes the kernel apart. Design:
//   - grid (tile of 128 columns, cohort slot). A block reads its slot's
//     offset and length from device memory: no host read, a launch whose
//     shape does not depend on the data, and only the slot's own rows are
//     read; rows outside every cohort are never touched;
//   - the rows are staged in shared memory by cp.async, each row by one
//     warp in the widest 16, 8 or 4-byte pieces that its start allows (at
//     d = 421,642 odd f32 rows are only 8-byte aligned). A tile holds 64
//     rows of 128 columns, 32 KB: the register file, not shared memory,
//     sets how many blocks share an SM;
//   - up to 64 rows, one thread sorts one column in registers with
//     Batcher's network at the smallest width that holds m (8, 16, 32 or
//     64: a 6-row cohort pays 19 compare-exchanges, not the 1,471 of 128).
//     The column sits in one bank of the tile, so the loads never conflict;
//   - above 64 rows the block takes its 128 columns in two halves of 64,
//     128 rows each: two threads sort a column's two runs of 64 in
//     registers and write them back, then one merges them by a bitonic
//     network whose first stage compares position i with its mirror 127 -
//     i, so every comparator puts the smaller key first; a stage holds two
//     16-key chunks in registers. No thread ever holds more than 64 keys,
//     so the 128-wide network does not set the registers;
//   - positions at and past m hold PAD_KEY from start to end (a comparator
//     whose upper slot holds PAD_KEY leaves both slots), so they are never
//     stored or loaded;
//   - the reduce is fused: the keys reach the window sum or the midpoint in
//     rank order, and only the (C, d) result goes back to memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // columns a block, one thread each up to 64 rows
constexpr int kWide = 64;      // rows a thread sorts in registers at most
constexpr int kChunk = 16;     // keys of each operand of a merge stage

enum Mode { kMedian = 0, kTrimmed = 1 };

__device__ __forceinline__ void cx(int32_t& a, int32_t& b) {
  const int32_t x = a, y = b;
  a = min(x, y);
  b = max(x, y);
}

// Bitonic half-cleaners at distances J, J / 2, ..., 1 within N registers.
template <int N, int J>
__device__ __forceinline__ void clean(int32_t (&k)[N]) {
  if constexpr (J >= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if ((i & J) == 0) cx(k[i], k[i | J]);
    clean<N, J / 2>(k);
  }
}

// Keys of sorted positions [base, base + N) of this thread's column
// (element p at col[p * STRIDE]), PAD_KEY at and past m. RAW: the slots
// still hold the staged values, not keys.
template <int N, int STRIDE, bool RAW>
__device__ __forceinline__ void load(int32_t (&k)[N], const int32_t* col, int base, int m) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    if (base + r < m) {
      const int32_t v = col[(base + r) * STRIDE];
      k[r] = RAW ? float_sort_key(__int_as_float(v)) : v;
    } else {
      k[r] = PAD_KEY;
    }
  }
}

template <int N, int STRIDE>
__device__ __forceinline__ void store(const int32_t (&k)[N], int32_t* col, int base, int m) {
#pragma unroll
  for (int r = 0; r < N; ++r)
    if (base + r < m) col[(base + r) * STRIDE] = k[r];
}

// The reduce over sorted positions handed to it in ascending order:
// trimmed, the window [lo, hi) summed; median, the keys at lo and hi.
template <int MODE>
struct Reduce {
  int lo, hi;
  float acc = 0.0f;
  int32_t klo = 0, khi = 0;

  template <int N>
  __device__ __forceinline__ void take(const int32_t (&k)[N], int base) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const int p = base + r;
      if constexpr (MODE == kTrimmed) {
        if (p >= lo && p < hi) acc = __fadd_rn(acc, key_to_float(k[r]));
      } else {
        if (p == lo) klo = k[r];
        if (p == hi) khi = k[r];
      }
    }
  }

  __device__ __forceinline__ float value(int m, int f) const {
    if constexpr (MODE == kTrimmed) {
      return __fmul_rn(acc, __fdiv_rn(1.0f, (float)(m - 2 * f)));
    } else {
      const float a = key_to_float(klo);
      return lo == hi ? a : __fmul_rn(__fadd_rn(a, key_to_float(khi)), 0.5f);
    }
  }
};

// Sort m <= 64 keys of one column held in shared memory (row stride
// kThreads) in registers, at the smallest network width that holds them.
template <int MODE>
__device__ __forceinline__ void sort_narrow(const int32_t* col, int m, Reduce<MODE>& red) {
  if (m <= 8) {
    int32_t k[8];
    load<8, kThreads, true>(k, col, 0, m);
    batcher_sort<8>(k);
    red.take(k, 0);
  } else if (m <= 16) {
    int32_t k[16];
    load<16, kThreads, true>(k, col, 0, m);
    batcher_sort<16>(k);
    red.take(k, 0);
  } else if (m <= 32) {
    int32_t k[32];
    load<32, kThreads, true>(k, col, 0, m);
    batcher_sort<32>(k);
    red.take(k, 0);
  } else {
    int32_t k[kWide];
    load<kWide, kThreads, true>(k, col, 0, m);
    batcher_sort<kWide>(k);
    red.take(k, 0);
  }
}

// Sort each run of 64 rows of a 64-column tile held in shared memory (row
// stride kThreads / 2; 64 < m <= 128) in registers and write it back:
// thread t takes run t / 64 of column t % 64. Out of line: inlined, this
// second 64-key network makes ptxas give the whole kernel 168 registers
// and spills, where it takes 96 (this function 80) and none, and the
// narrow path that every cohort of up to 64 rows takes runs slower
// (chip_segmented_ablation.py's runs_inline variant).
__device__ __noinline__ void sort_runs(int32_t* tile, int m) {
  constexpr int S = kThreads / 2;
  int32_t k[kWide];
  int32_t* col = tile + threadIdx.x % S;
  const int base = threadIdx.x < S ? 0 : kWide;
  load<kWide, S, true>(k, col, base, m);
  batcher_sort<kWide>(k);
  store<kWide, S>(k, col, base, m);
}

// Merge the two sorted runs of one column (row stride kThreads / 2) and hand
// the keys to the reduce: one bitonic merge of 128 whose first stage
// compares position i with its mirror 127 - i, two 16-key chunks in
// registers at a time; its last stage hands the chunks to the reduce in
// rank order.
template <int MODE>
__device__ __forceinline__ void merge_wide(int32_t* col, int m, Reduce<MODE>& red) {
  constexpr int S = kThreads / 2, W = 2 * kWide;
  for (int pa = 0; pa < kWide; pa += kChunk) {
    const int pb = W - kChunk - pa;
    int32_t a[kChunk], z[kChunk];
    load<kChunk, S, false>(a, col, pa, m);
    load<kChunk, S, false>(z, col, pb, m);
#pragma unroll
    for (int r = 0; r < kChunk; ++r) cx(a[r], z[kChunk - 1 - r]);
    store<kChunk, S>(a, col, pa, m);
    store<kChunk, S>(z, col, pb, m);
  }
  for (int j = W / 4; j >= 2 * kChunk; j /= 2) {
    for (int p = 0; p < m; p += kChunk) {
      if (p & j) continue;
      int32_t a[kChunk], z[kChunk];
      load<kChunk, S, false>(a, col, p, m);
      load<kChunk, S, false>(z, col, p + j, m);
#pragma unroll
      for (int r = 0; r < kChunk; ++r) cx(a[r], z[r]);
      store<kChunk, S>(a, col, p, m);
      store<kChunk, S>(z, col, p + j, m);
    }
  }
  for (int p = 0; p < m; p += 2 * kChunk) {
    int32_t a[kChunk], z[kChunk];
    load<kChunk, S, false>(a, col, p, m);
    load<kChunk, S, false>(z, col, p + kChunk, m);
#pragma unroll
    for (int r = 0; r < kChunk; ++r) cx(a[r], z[r]);
    clean<kChunk, kChunk / 2>(a);
    clean<kChunk, kChunk / 2>(z);
    red.take(a, p);
    red.take(z, p + kChunk);
  }
}

// Stage rows [o, o + m) of columns [cs, cs + width) into tile (row stride
// width), each row by one warp in the widest pieces its start allows.
__device__ __forceinline__ void stage(const float* __restrict__ x, int32_t* tile, int o, int m,
                                      long long d, long long cs, int width) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bytes = (int)min((long long)width, d - cs) * (int)sizeof(float);
  for (int r = warp; r < m; r += kThreads / 32) {
    const char* src = reinterpret_cast<const char*>(x + (long long)(o + r) * d + cs);
    char* dst = reinterpret_cast<char*>(tile + r * width);
    const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src));
    if ((a & 15u) == 0) {
      copy_row<16>(dst, src, bytes, lane);
    } else if ((a & 7u) == 0) {
      copy_row<8>(dst, src, bytes, lane);
    } else {
      copy_row<4>(dst, src, bytes, lane);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
segmented_sort_reduce_kernel(const float* __restrict__ x, const int* __restrict__ offsets,
                             const int* __restrict__ lengths, float* __restrict__ out, int R,
                             long long d, int f) {
  extern __shared__ __align__(16) int32_t tile[];  // 64 rows x 128 columns, or 128 x 64
  const int c = blockIdx.y, tid = threadIdx.x;
  const long long c0 = (long long)blockIdx.x * kThreads;
  const int o = offsets[c], m = lengths[c];
  float* oc = out + (long long)c * d;
  if (m == 0 || m < 0 || o < 0 || (long long)o + m > R) {
    if (c0 + tid < d) oc[c0 + tid] = m == 0 ? 0.0f : __int_as_float(0x7FC00000);
    return;
  }
  Reduce<MODE> red;
  red.lo = MODE == kTrimmed ? f : (m - 1) / 2;
  red.hi = MODE == kTrimmed ? m - f : m / 2;
  if (m <= kWide) {
    stage(x, tile, o, m, d, c0, kThreads);
    if (c0 + tid >= d) return;
    sort_narrow(tile + tid, m, red);
    oc[c0 + tid] = from_f32<float>(red.value(m, f));
    return;
  }
  // more than 64 rows: the tile's two halves in turn; two threads sort a
  // column's runs, one merges them
  for (long long cs = c0; cs < c0 + kThreads && cs < d; cs += kThreads / 2) {
    stage(x, tile, o, m, d, cs, kThreads / 2);
    sort_runs(tile, m);
    __syncthreads();
    if (tid < kThreads / 2 && cs + tid < d) {
      Reduce<MODE> r = red;
      merge_wide(tile + tid, m, r);
      oc[cs + tid] = from_f32<float>(r.value(m, f));
    }
    __syncthreads();  // the next half overwrites the tile
  }
}

template <int MODE>
cudaError_t launch(const float* x, const int* offsets, const int* lengths, float* out, int R,
                   int C, long long d, int f, cudaStream_t stream) {
  // 64 rows of 128 columns or 128 rows of 64: 32 KB at R > 64
  const int smem = (R < kWide ? R : kWide) * kThreads * (int)sizeof(int32_t);
  const void* fn = reinterpret_cast<const void*>(&segmented_sort_reduce_kernel<MODE>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((d + kThreads - 1) / kThreads), (unsigned)C);
  segmented_sort_reduce_kernel<MODE><<<grid, kThreads, smem, stream>>>(x, offsets, lengths, out,
                                                                      R, d, f);
  return cudaGetLastError();
}

}  // namespace

// x: (R, d) f32 contiguous, R <= 128; offsets, lengths: (C,) int32 on x's
// device; out: (C, d) f32. mode 0 = median, 1 = trimmed mean (f trimmed at
// each end). Returns the launch's cudaError_t.
extern "C" int byz_segmented_sort_reduce(const void* x, const void* offsets, const void* lengths,
                                         void* out, int R, int C, long long d, int mode, int f,
                                         void* stream) {
  if (R < 0 || R > 128 || C < 0 || C > 65535 || f < 0) return cudaErrorInvalidValue;
  if (C == 0 || d <= 0) return cudaSuccess;
  const float* xp = static_cast<const float*>(x);
  const int* op = static_cast<const int*>(offsets);
  const int* lp = static_cast<const int*>(lengths);
  float* outp = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kMedian: return launch<kMedian>(xp, op, lp, outp, R, C, d, f, s);
    case kTrimmed: return launch<kTrimmed>(xp, op, lp, outp, R, C, d, f, s);
    default: return cudaErrorInvalidValue;
  }
}
