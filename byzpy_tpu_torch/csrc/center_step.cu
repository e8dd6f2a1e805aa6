// B7: the centre-seeking loops on an (n, d) matrix x from a start z0 — the
// Weiszfeld iterations of the geometric median and the steps of centred
// clipping — each whole loop in ONE launch, its stopping test on the device.
//
// Replaces byzpy_tpu/ops/pallas_kernels.py:470 _weighted_center_step_kernel
// (pallas_call at :582) and the lax loops the reference runs it in
// (byzpy_tpu/ops/robust.py:727-754 while_loop, :814 fori_loop).
//
// One step (pallas_kernels.py:505-529), z the centre in x's dtype:
//   dist_i = sqrt(sum_c (x_ic - z_c)^2), den_i = max(dist_i, eps);
//   weiszfeld: w_i = (1/den_i) / sum_j (1/den_j), alpha = 0;
//   clip:      w_i = min(1, c_tau/den_i) * f32(1/n), alpha = 1 - sum_j w_j
//              (the reference's `/ n` by a constant is a multiply by the
//              f32 reciprocal);
//   z_new = alpha z + sum_i w_i x_i, rows ascending, __fmul_rn then
//   __fadd_rn, EVERY row read (a w = 0 inf row adds 0 * inf = NaN), rounded
//   to x's dtype (NaN canonical) before anything reads it: the next
//   distances, the step length and the output.
// max and min keep NaN, as jnp.maximum / jnp.minimum do. One IEEE
// operation a step; no --use_fast_math.
//
// The loop (robust.py:727-754): weiszfeld steps while (it == 0 or delta >
// tol) and it < max_iter, delta = sqrt(sum_c e_c^2) with e = rnd(z_new -
// z) and each e^2 rounded to x's dtype (rnd), the sum rounded to x's dtype
// before the root and the root after it, compared with tol rounded to x's
// dtype (by the caller); iteration 1 is forced by it == 0. clip runs
// exactly max_iter (= M) steps. The launch writes the final centre and the
// iteration count.
//
// The order of every sum over columns is fixed by d alone (the plain
// version, ops/kernels.py:center_sq_dists_plain, reproduces it):
//   1. chunks of 1024 columns; in chunk b, thread t of 256 adds the columns
//      b * 1024 + t + 256 k, k = 0..3 ascending, from +0.0;
//   2. a warp butterfly (__shfl_xor 16, 8, 4, 2, 1) of its 32 threads;
//   3. the 8 warp sums added in warp order from +0.0: the chunk's partial;
//   4. across chunks: lane l of a warp adds chunks l, l + 32, ... in order
//      from +0.0, then a butterfly of the 32 lanes.
// The distances and the step length both take it.
//
// Bound: memory. K steps read x K + 1 times: a first pass takes the
// distances to z0; step t then reads each column of x once, forms z_{t+1}
// on it and, from the same values, the distances to z_{t+1} and the
// column's part of delta. Design: a persistent cooperative kernel
// (a cooperative launch at the co-resident grid; block g walks
// chunks g, g + G, ...). A pass stages each tile of n rows x 512 (n <= 16)
// or 256 columns in shared memory with cp.async, each warp
// copying whole row segments in the widest piece the row's start allows;
// thread t then reads its own columns there, for the sweep and again for
// the distances. No float atomics, so the same input gives the same bits
// on every run. Each step makes two grid barriers: after the chunk
// partials (blocks then reduce disjoint rows, a warp a row, to raw_i and
// delta), and after that reduce (every block then forms the same weights,
// alpha and stop decision from the same values). The barrier is an int
// counter (cooperative_groups' algorithm), so the single-file build needs
// no -rdc; data another block wrote is read with __ldcg, past the SM's
// incoherent L1. What bounds it (chip_center_ablation.py on an H100): at
// 8 x 421,642 (x in L2) the two barriers, ~2.3 us each a step; at 64 rows
// the blocks of a pass copy, then compute, in step with each other, so
// memory idles while they compute (a second buffer, which would overlap
// the two, halves the blocks an SM and is slower).
//
// Two phases of the same kernel serve the one-step wrappers: `wa_out`
// stops after the first weights and writes them (n weights, then alpha);
// `w_in` / `alpha_in` skip to one sweep under given weights.
//
// masked_weiszfeld (mode 2): the Weiszfeld loop of the masked family's
// geometric median (byzpy_tpu/ops/robust.py:1581-1620
// masked_geometric_median, a lax.while_loop of plain XLA, no Pallas
// kernel), on a padded matrix whose `valid` rows (one byte each) are the
// cohort. It takes that family's arithmetic, so the padded loop steps
// exactly as the compacted one and the plain version is
// ops/robust.py's masked loop:
//   sq_i in row_sq_dists' order (csrc/segment_sum.cu): lane l of 4096 adds
//     (x_ic - z_c)^2 at c = l, l + 4096, ... in order, then a warp adds
//     lane partials j, j + 32, ... in order and a butterfly adds the 32;
//   w_i = rnd(1 / max(sqrt(sq_i), eps)) on a valid row, +0 on the others
//     (rnd: rounded to x's dtype);
//   num_c = __fmaf_rn(w_i, x_ic, acc) over rows i ascending from +0.0, EVERY
//     row read (B11's chain, segment_sum.cu), den = rnd(sum_i w_i) in row
//     order from +0.0 (B11's chain of w against ones);
//   z_new = rnd(rnd(num) / den);
//   the stop test as in weiszfeld mode (delta in the column order above).
// The sweep is the unmasked pass with the FMA chain and the divide (x read
// once); the distances are a pass of their own over the (row, lane)
// chains, a thread a chain, because row_sq_dists' lane order runs down
// the columns a stride of 4096 at a time, across every block's chunks. So
// a step reads x twice where weiszfeld reads it once. Each step makes
// three grid barriers: after the sweep (the distances read the new
// centre), after the distances, after the row reduce.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;
constexpr int kSteps = kChunk / kThreads;  // columns a thread takes in a chunk
enum CenterMode { kWeiszfeld = 0, kClip = 1, kMaskedWeiszfeld = 2 };
constexpr int kLanes = 4096;  // the masked mode's lanes a row (row_sq_dists' kLanes)

__device__ __forceinline__ float qnan() { return __int_as_float(0x7FC00000); }
// NaN-propagating max / min (jnp.maximum / jnp.minimum; fmaxf and fminf
// drop a NaN operand).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fminf(a, b);
}

// An element another block of this launch wrote: read past the SM's
// incoherent L1.
template <typename T> __device__ __forceinline__ T ldcg_elem(const T* p);
template <> __device__ __forceinline__ float ldcg_elem<float>(const float* p) { return __ldcg(p); }
template <> __device__ __forceinline__ __nv_bfloat16 ldcg_elem<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}
template <> __device__ __forceinline__ __half ldcg_elem<__half>(const __half* p) {
  return __ushort_as_half(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// v rounded to T and back (the identity in f32 but for NaN's payload)
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f32(from_f32<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Grid-wide barrier of a cooperative launch (cooperative_groups' sync_grids):
// block 0 adds 2^31 - (G - 1), the others 1 each, so the counter's top bit
// flips once all G blocks have arrived; the counter starts at 0.
__device__ __forceinline__ void grid_sync(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int inc = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(counter, inc);
    while (((old ^ *static_cast<volatile unsigned int*>(counter)) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

struct LoopArgs {
  const void* x;
  const void* z0;
  void* out;
  const float* w_in;      // sweep phase: given weights (n) ...
  const float* alpha_in;  // ... and alpha; else null
  float* wa_out;          // weights phase: n weights, then alpha; else null
  float* partial;         // (n + 1) rows x nchunks: chunk partials, row n delta's
  float* raw;             // n: the rows' unnormalized weights
  float* delta;           // 1: the last step length
  const unsigned char* valid;  // masked: n row flags; else null
  float* lanes;                // masked: n x kLanes lane partials; else null
  unsigned int* counter;  // 1: the grid barrier, 0 at launch
  int* iters;             // 1: the steps taken
  long long d;
  int n, nchunks, mode, max_iter;
  float eps, c_tau, tol;
};

struct Shared {
  float w[128];
  float raw[128];
  float warp_part[kWarps][129];
  float alpha, total, delta;  // masked: total is den, rounded to x's dtype
};

// One row's `bytes` of x into shared memory by the lanes of a warp, in the
// widest piece (16, 8 or 4 bytes) that the row's start allows; a 16-bit
// row that starts off a 4-byte boundary is copied an element at a time.
template <typename T>
__device__ __forceinline__ void stage_row(T* dst, const T* src, int bytes, int lane) {
  const unsigned misalign = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src) & 15);
  char* d = reinterpret_cast<char*>(dst);
  const char* s = reinterpret_cast<const char*>(src);
  if (misalign == 0) {
    copy_row<16>(d, s, bytes, lane);
  } else if ((misalign & 7) == 0) {
    copy_row<8>(d, s, bytes, lane);
  } else if ((misalign & 3) == 0) {
    copy_row<4>(d, s, bytes, lane);
  } else {
    for (int e = lane; e < bytes / (int)sizeof(T); e += 32) dst[e] = src[e];
  }
}

// The first column of the block's step q of a pass: step q % kPerChunk of
// chunk blockIdx.x + (q / kPerChunk) G.
template <int kPerChunk, int kWidth>
__device__ __forceinline__ long long step_start(int q) {
  return (blockIdx.x + (long long)(q / kPerChunk) * gridDim.x) * kChunk +
         (long long)(q % kPerChunk) * kWidth;
}

// The columns of a step from cs that x has (a step never crosses its
// chunk's end, so only d cuts it); at most 0 past the last column.
template <int kWidth>
__device__ __forceinline__ int step_columns(long long d, long long cs) {
  return (int)(d - cs < kWidth ? d - cs : kWidth);
}

// The block's copies of its step q's tile (n rows of a step's columns of
// chunk blockIdx.x + (q / kPerChunk) G) into xs + offset: a warp a row.
template <typename T, int kPerChunk, int kWidth>
__device__ __forceinline__ void stage_tile(const LoopArgs& a, const T* x, T* xs, int q, int offset) {
  const long long cs = step_start<kPerChunk, kWidth>(q);
  const int bytes = step_columns<kWidth>(a.d, cs) * (int)sizeof(T);
  if (bytes > 0)
    for (int i = threadIdx.x >> 5; i < a.n; i += kWarps)
      stage_row(xs + offset + i * kWidth, x + i * a.d + cs, bytes, threadIdx.x & 31);
  cp_async_commit();
}

// One pass over the block's chunks. sweep: z_new = alpha z + sum_i w_i x_i
// on each column, written to out; dist: the rows' partials of
// (x_ic - zd_c)^2, zd the new centre after a sweep, else zin; step: the
// columns' part of delta (row n). x is read once: a step of the pass takes
// KC * 256 of a chunk's columns, thread t the columns t + 256 k; the block
// stages the step's tile of n rows in shared memory (cp.async, each warp
// whole row segments), and the sweep and the distances read it there.
template <typename T, int NR, int KC, int NBUF, bool MASKED = false>
__device__ void pass(const LoopArgs& a, const T* zin, bool sweep, bool dist, bool step,
                     T* xs, Shared& sh) {
  constexpr int kPerChunk = kSteps / KC;  // steps of a chunk
  constexpr int kWidth = KC * kThreads;   // a step's columns
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = a.n;
  const long long d = a.d;
  const float alpha = sh.alpha;
  const int tile = n * kWidth;  // one buffer's elements
  // the block's steps, q = 0 .. nq - 1 (step_start)
  const int nq = (int)blockIdx.x < a.nchunks
                     ? ((a.nchunks - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * kPerChunk : 0;
  if (nq > 0) stage_tile<T, kPerChunk, kWidth>(a, x, xs, 0, 0);
  float part[NR];
  float dpart = 0.0f;
#pragma unroll 1
  for (int q = 0; q < nq; ++q) {
    if (q % kPerChunk == 0) {
#pragma unroll
      for (int i = 0; i < NR; ++i) part[i] = 0.0f;
      dpart = 0.0f;
    }
    const long long cs = step_start<kPerChunk, kWidth>(q);
    const int valid = step_columns<kWidth>(d, cs) - t;  // column k * 256 is this thread's if below
    const T* zs = zin + cs + t;
    T* os = out + cs + t;
    float acc[KC], zf[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      acc[k] = 0.0f;
      zf[k] = k * kThreads < valid ? to_f32(zs[k * kThreads]) : 0.0f;
    }
    if (NBUF == 1 && q > 0) stage_tile<T, kPerChunk, kWidth>(a, x, xs, q, 0);
    if (NBUF > 1 && q + 1 < nq) {
      stage_tile<T, kPerChunk, kWidth>(a, x, xs, q + 1, ((q + 1) % NBUF) * tile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the step's tile is in
    const T* buf = xs + (q % NBUF) * tile + t;
    if (sweep) {
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          if (k * kThreads >= valid) continue;
          const float xv = to_f32(buf[i * kWidth + k * kThreads]);
          acc[k] = MASKED ? __fmaf_rn(sh.w[i], xv, acc[k]) : __fadd_rn(acc[k], __fmul_rn(xv, sh.w[i]));
        }
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k * kThreads >= valid) continue;
        const T zn = MASKED ? from_f32<T>(__fdiv_rn(rnd<T>(acc[k]), sh.total))
                            : from_f32<T>(__fadd_rn(__fmul_rn(alpha, zf[k]), acc[k]));
        os[k * kThreads] = zn;
        const float znf = to_f32(zn);
        if (step) {
          const float e = rnd<T>(__fsub_rn(znf, zf[k]));
          dpart = __fadd_rn(dpart, rnd<T>(__fmul_rn(e, e)));
        }
        zf[k] = znf;
      }
    }
    if (dist) {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (i >= n) break;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          if (k * kThreads >= valid) continue;
          const float diff = __fsub_rn(to_f32(buf[i * kWidth + k * kThreads]), zf[k]);
          part[i] = __fadd_rn(part[i], __fmul_rn(diff, diff));
        }
      }
    }
    __syncthreads();  // every thread is done with the tile before it is refilled
    if (q % kPerChunk != kPerChunk - 1 || (!dist && !step)) continue;
    // the chunk's partials: a butterfly a warp, then the warps in order
    if (dist) {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (i >= n) break;
        const float v = warp_sum(part[i]);
        if (lane == 0) sh.warp_part[warp][i] = v;
      }
    }
    if (step) {
      const float v = warp_sum(dpart);
      if (lane == 0) sh.warp_part[warp][n] = v;
    }
    __syncthreads();
    if ((dist && t < n) || (step && t == n)) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum = __fadd_rn(sum, sh.warp_part[w][t]);
      a.partial[(long long)t * a.nchunks + cs / kChunk] = sum;
    }
    __syncthreads();
  }
}

// Rows 0..n-1 of the partials to raw_i, and (with_step) row n to delta: a
// warp a row, over all the grid's warps.
template <typename T>
__device__ void reduce_rows(const LoopArgs& a, bool with_step) {
  const int lane = threadIdx.x & 31;
  const int rows = a.n + (with_step ? 1 : 0);
  const int stride = gridDim.x * kWarps;
  for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < rows; r += stride) {
    const float* p = a.partial + (long long)r * a.nchunks;
    float s = 0.0f;
    for (int b = lane; b < a.nchunks; b += 32) s = __fadd_rn(s, __ldcg(p + b));
    s = warp_sum(s);
    if (lane != 0) continue;
    if (r < a.n) {
      const float den = nan_max(__fsqrt_rn(s), a.eps);
      a.raw[r] = (a.mode == kWeiszfeld)
                     ? __fdiv_rn(1.0f, den)
                     : __fmul_rn(nan_min(1.0f, __fdiv_rn(a.c_tau, den)), __frcp_rn((float)a.n));
    } else {
      *a.delta = rnd<T>(__fsqrt_rn(rnd<T>(s)));
    }
  }
}

// Every block forms the same weights and alpha from raw (and reads delta).
__device__ void form_weights(const LoopArgs& a, Shared& sh, bool read_delta) {
  const int t = threadIdx.x;
  if (t < a.n) sh.raw[t] = __ldcg(a.raw + t);
  __syncthreads();
  if (t == 0) {
    float total = 0.0f;
#pragma unroll 8
    for (int i = 0; i < a.n; ++i) total = __fadd_rn(total, sh.raw[i]);
    sh.total = total;
    sh.alpha = (a.mode == kWeiszfeld) ? 0.0f : __fsub_rn(1.0f, total);
    sh.delta = read_delta ? __ldcg(a.delta) : 0.0f;
  }
  __syncthreads();
  if (t < a.n) sh.w[t] = (a.mode == kWeiszfeld) ? __fdiv_rn(sh.raw[t], sh.total) : sh.raw[t];
  __syncthreads();
}

// masked_weiszfeld's distances to zc: the (row, lane) chains of
// row_sq_dists, a thread a chain, the grid's threads striding over the n x
// kLanes of them. zc may be the centre other blocks just wrote (__ldcg).
template <typename T>
__device__ void masked_dist_pass(const LoopArgs& a, const T* zc) {
  const T* x = static_cast<const T*>(a.x);
  const long long chains = (long long)a.n * kLanes;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < chains; p += stride) {
    const int i = (int)(p / kLanes), lane = (int)(p % kLanes);
    const T* xi = x + (long long)i * a.d;
    float acc = 0.0f;
#pragma unroll 4
    for (long long c = lane; c < a.d; c += kLanes) {
      const float v = __fsub_rn(to_f32(xi[c]), to_f32(ldcg_elem(zc + c)));
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    }
    a.lanes[p] = acc;
  }
}

// masked_weiszfeld's row reduce: rows 0..n-1 of the lane partials to the
// rounded weights (0 on an invalid row) and, with_step, the chunk partials'
// row n to delta; a warp a row over all the grid's warps.
template <typename T>
__device__ void masked_reduce_rows(const LoopArgs& a, bool with_step) {
  const int lane = threadIdx.x & 31;
  const int rows = a.n + (with_step ? 1 : 0);
  const int stride = gridDim.x * kWarps;
  for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < rows; r += stride) {
    float s = 0.0f;
    if (r < a.n) {
      const float* p = a.lanes + (long long)r * kLanes;
      for (int k = lane; k < kLanes; k += 32) s = __fadd_rn(s, __ldcg(p + k));
    } else {
      const float* p = a.partial + (long long)r * a.nchunks;
      for (int b = lane; b < a.nchunks; b += 32) s = __fadd_rn(s, __ldcg(p + b));
    }
    s = warp_sum(s);
    if (lane != 0) continue;
    if (r < a.n) {
      const float w = rnd<T>(__fdiv_rn(1.0f, nan_max(__fsqrt_rn(from_f32<float>(s)), a.eps)));
      a.raw[r] = a.valid[r] ? w : 0.0f;
    } else {
      *a.delta = rnd<T>(__fsqrt_rn(rnd<T>(s)));
    }
  }
}

// Every block takes the same weights and den = rnd(sum_i w_i), rows in
// order from +0.0 (and reads delta).
template <typename T>
__device__ void masked_form_weights(const LoopArgs& a, Shared& sh, bool read_delta) {
  const int t = threadIdx.x;
  if (t < a.n) sh.w[t] = __ldcg(a.raw + t);
  __syncthreads();
  if (t == 0) {
    float total = 0.0f;
#pragma unroll 8
    for (int i = 0; i < a.n; ++i) total = __fadd_rn(total, sh.w[i]);
    sh.total = rnd<T>(total);
    sh.delta = read_delta ? __ldcg(a.delta) : 0.0f;
  }
  __syncthreads();
}

// The weiszfeld and clip loops and their one-step phases.
template <typename T, int NR, int KC, int NBUF>
__device__ __forceinline__ void center_loop_unmasked(const LoopArgs& a, T* xs, Shared& sh) {
  const T* z0 = static_cast<const T*>(a.z0);
  const T* zcur = static_cast<const T*>(a.out);
  if (a.w_in != nullptr) {  // sweep phase: one step under the given weights
    if (threadIdx.x < a.n) sh.w[threadIdx.x] = a.w_in[threadIdx.x];
    if (threadIdx.x == 0) sh.alpha = *a.alpha_in;
    __syncthreads();
    pass<T, NR, KC, NBUF>(a, z0, true, false, false, xs, sh);
    return;
  }
  const bool weiszfeld = a.mode == kWeiszfeld;
  pass<T, NR, KC, NBUF>(a, z0, false, true, false, xs, sh);
  int it = 0;
  for (;;) {
    const bool with_step = weiszfeld && it > 0;
    grid_sync(a.counter);
    reduce_rows<T>(a, with_step);
    grid_sync(a.counter);
    form_weights(a, sh, with_step);
    if (with_step && !(sh.delta > a.tol)) break;
    if (a.wa_out != nullptr) {  // weights phase
      if (blockIdx.x == 0 && threadIdx.x <= a.n)
        a.wa_out[threadIdx.x] = threadIdx.x < a.n ? sh.w[threadIdx.x] : sh.alpha;
      break;
    }
    const bool last = it + 1 == a.max_iter;
    pass<T, NR, KC, NBUF>(a, it == 0 ? z0 : zcur, true, !last, weiszfeld && !last, xs, sh);
    ++it;
    if (last) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.iters = it;
}

// Registers capped for four blocks an SM at 16 rows and below (the main
// path's 412 chunks then take one co-resident wave) and two below 128 rows
// (chip_center_ablation.py: a cap for one block took the 64-row instance
// 1.47x longer at the same register count).
template <typename T, int NR, int KC, int NBUF, bool MASKED>
__global__ void __launch_bounds__(kThreads, NR <= 16 ? 4 : (NR < 128 ? 2 : 1))
    center_loop_kernel(LoopArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];  // NBUF tiles of n x KC * kThreads
  T* xs = reinterpret_cast<T*>(smem);
  __shared__ Shared sh;
  if constexpr (MASKED) {
    const T* z0 = static_cast<const T*>(a.z0);
    const T* zcur = static_cast<const T*>(a.out);
    // the sweep's pass keeps no distance partials: NR = 1
    masked_dist_pass<T>(a, z0);
    int it = 0;
    for (;;) {
      const bool with_step = it > 0;
      grid_sync(a.counter);
      masked_reduce_rows<T>(a, with_step);
      grid_sync(a.counter);
      masked_form_weights<T>(a, sh, with_step);
      if (with_step && !(sh.delta > a.tol)) break;
      const bool last = it + 1 == a.max_iter;
      pass<T, 1, KC, NBUF, true>(a, it == 0 ? z0 : zcur, true, false, !last, xs, sh);
      ++it;
      if (last) break;
      grid_sync(a.counter);
      masked_dist_pass<T>(a, zcur);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) *a.iters = it;
  } else {
    center_loop_unmasked<T, NR, KC, NBUF>(a, xs, sh);
  }
}

// Rows per instance; a step's columns (KC * 256: 512 at 16 rows and below,
// where 1024 spilled and was slower at 8 rows); one staging buffer
// (occupancy beat a second buffer's overlap; chip_center_ablation.py).
template <typename T, int NR, bool MASKED>
int launch_rows(LoopArgs& a, int sms, cudaStream_t s) {
  constexpr int KC = NR <= 16 ? 2 : 1;
  constexpr int NBUF = 1;
  auto kernel = center_loop_kernel<T, NR, KC, NBUF, MASKED>;
  const size_t smem = (size_t)NBUF * a.n * KC * kThreads * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * sms;
  const int grid = (int)(a.nchunks < fit ? a.nchunks : fit);
  // a cooperative launch through cudaLaunchKernelEx, which a stream capture
  // records as a cooperative kernel node (the compiled steps' CUDA graphs)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename T, bool MASKED>
int launch_width(LoopArgs& a, int sms, cudaStream_t s) {
  if (a.n <= 8) return launch_rows<T, 8, MASKED>(a, sms, s);
  if (a.n <= 16) return launch_rows<T, 16, MASKED>(a, sms, s);
  if (a.n <= 32) return launch_rows<T, 32, MASKED>(a, sms, s);
  if (a.n <= 64) return launch_rows<T, 64, MASKED>(a, sms, s);
  return launch_rows<T, 128, MASKED>(a, sms, s);
}

template <typename T>
int launch_loop(LoopArgs& a, int sms, cudaStream_t s) {
  return a.mode == kMaskedWeiszfeld ? launch_width<T, true>(a, sms, s)
                                    : launch_width<T, false>(a, sms, s);
}

}  // namespace

// x: (n, d) contiguous, 1 <= n <= 128, d >= 1; z0, out: (d,) of x's dtype
// (out may not alias z0); scratch: (n + 1) * ceil(d / 1024) + n + 1 f32,
// and n * 4096 more in mode 2; ints: 2 int32, [0] receives the steps
// taken. mode 0 = weiszfeld, 1 = clip, 2 = masked_weiszfeld (valid: n
// bytes, nonzero on a cohort row; null in the other modes); tol is
// compared as given (round it to x's dtype first). Phases (modes 0 and 1):
// w_in and alpha_in non-null: one sweep under them; wa_out non-null: stop
// after the first weights and write n weights, then alpha. Otherwise
// max_iter >= 1 steps at most. Returns the launch's cudaError_t.
extern "C" int byz_center_loop(const void* x, const void* z0, void* out, const float* w_in,
                               const float* alpha_in, float* wa_out, float* scratch, int* ints,
                               const unsigned char* valid, int n, long long d, int mode,
                               float eps, float c_tau, float tol, int max_iter, int dtype,
                               void* stream) {
  const bool masked = mode == kMaskedWeiszfeld;
  if (n < 1 || n > 128 || d < 1 || max_iter < 1 ||
      (mode != kWeiszfeld && mode != kClip && !masked) ||
      ((w_in == nullptr) != (alpha_in == nullptr)) || masked != (valid != nullptr) ||
      (masked && (w_in != nullptr || wa_out != nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nchunks = (d + kChunk - 1) / kChunk;
  if (nchunks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaMemsetAsync(ints, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return err;
  LoopArgs a;
  a.x = x;
  a.z0 = z0;
  a.out = out;
  a.w_in = w_in;
  a.alpha_in = alpha_in;
  a.wa_out = wa_out;
  a.partial = scratch;
  a.raw = scratch + (n + 1) * nchunks;
  a.delta = a.raw + n;
  a.valid = valid;
  a.lanes = masked ? a.delta + 1 : nullptr;
  a.counter = reinterpret_cast<unsigned int*>(ints + 1);
  a.iters = ints;
  a.d = d;
  a.n = n;
  a.nchunks = (int)nchunks;
  a.mode = mode;
  a.max_iter = max_iter;
  a.eps = eps;
  a.c_tau = c_tau;
  a.tol = tol;
  switch (dtype) {
    case kF32: err = (cudaError_t)launch_loop<float>(a, sms, s); break;
    case kBF16: err = (cudaError_t)launch_loop<__nv_bfloat16>(a, sms, s); break;
    case kF16: err = (cudaError_t)launch_loop<__half>(a, sms, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
