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
// The masked modes run on a padded matrix whose `valid` rows (one byte
// each) are the cohort, in the masked family's arithmetic, so the padded
// loop steps exactly as the compacted one (the plain versions are
// ops/kernels.py's masked steps):
// masked_weiszfeld (mode 2): the masked geometric median's loop
// (byzpy_tpu/ops/robust.py:1581-1620, a lax.while_loop of plain XLA, no
// Pallas kernel):
//   sq_i in row_sq_dists' order (csrc/segment_sum.cu): lane l of 4096 adds
//     (x_ic - z_c)^2 at c = l, l + 4096, ... in order, then a warp adds
//     lane partials j, j + 32, ... in order and a butterfly adds the 32;
//   w_i = rnd(1 / max(sqrt(sq_i), eps)) on a valid row, +0 on the others;
//   num_c = __fmaf_rn(w_i, x_ic, acc) over rows i ascending from +0.0, EVERY
//     row read (B11's chain, segment_sum.cu), den = rnd(sum_i w_i) in row
//     order from +0.0 (B11's chain of w against ones);
//   z_new = rnd(rnd(num) / den);
//   the stop test as in weiszfeld mode (delta in the column order above).
// masked_clip (mode 3): the masked centred clipping (robust.py:1623-1654,
// a fori_loop of plain XLA), exactly max_iter steps:
//   sq_i as above; w_i = rnd(min(1, c_tau / max(sqrt(sq_i), eps))) on a
//     valid row, +0 on the others;
//   step_c = rnd(B11's chain of w_i against rnd(x_ic - v_c));
//   v_new = rnd(v + rnd(step * inv)), inv = rnd(1 / the valid rows' count).
// A masked step reads x once. Its two halves are local: the chain to a
// column, a distance chain (i, l) to the columns c = l (mod 4096), which
// need the new centre there alone. So block g owns lane groups of 32
// adjacent lanes (g, g + G, ...; G = 128 on an H100: 4096 lanes over 132
// SMs leave some SM 32 lanes however finely they are split, and 32 f32
// columns are one 128-byte row segment) and walks a group's tiles (its n
// rows x 32 columns at 4096 k + lane) with k rising. Two producer warps
// copy the tile rows into a ring in shared memory in 16-byte cp.async
// pieces from each row's 16-byte-aligned start, completing on the slot's
// mbarrier; the 8 consumer warps take the tiles 8 at a time: warp j runs
// tile j's 32 column chains (a lane a column, so 8 tiles' chains run at
// once), writes the new centre, and then every thread adds the group's
// tiles' terms of
// the next distances from the same staged values, in tile order, to its
// lane accumulators (thread (w, l): rows w, w + 8, ... of lane g * 32 + l,
// in registers across the group's tiles), which go to a lane scratch at
// the group's end. The step length keeps B7's chunk order: the pass writes
// each column's rnd(e^2) to a (d,) scratch; the row reduce also forms the
// chunk partials from it (a warp emulating a chunk's 256 threads), which
// every block sums after the second barrier. Two grid barriers a step:
// after the pass, after the row reduce. x does not change, so where another
// pass may follow, the producer copies that pass's first ring-full before
// the barriers. What bounds it (chip_center_ablation.py --masked on an
// H100): at 64 x 1,048,576 f32 a step takes ~0.115 ms against 0.080 for
// one read of x; the copies alone take ~0.105 and the consumers alone
// ~0.115, so neither side reaches the card's rate with these 128-byte row
// segments, and the barriers, row reduce and weights take ~0.007.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;
constexpr int kSteps = kChunk / kThreads;  // columns a thread takes in a chunk
enum CenterMode { kWeiszfeld = 0, kClip = 1, kMaskedWeiszfeld = 2, kMaskedClip = 3 };
constexpr int kLanes = 4096;  // the masked modes' lanes a row (row_sq_dists' kLanes)

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
  float* e2;                   // masked: d rounded squares of the step; else null
  unsigned int* counter;  // 1: the grid barrier, 0 at launch
  int* iters;             // 1: the steps taken
  long long d;
  int n, nchunks, mode, max_iter;
  int depth;  // masked: ring slots
  float eps, c_tau, tol;
};

struct Shared {
  float w[128];
  float raw[128];
  float warp_part[kWarps][129];
  float alpha, total, delta;
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
template <typename T, int NR, int KC, int NBUF>
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
          acc[k] = __fadd_rn(acc[k], __fmul_rn(xv, sh.w[i]));
        }
      }
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k * kThreads >= valid) continue;
        const T zn = from_f32<T>(__fadd_rn(__fmul_rn(alpha, zf[k]), acc[k]));
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
template <typename T, int NR, int KC, int NBUF>
__global__ void __launch_bounds__(kThreads, NR <= 16 ? 4 : (NR < 128 ? 2 : 1))
    center_loop_kernel(LoopArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];  // NBUF tiles of n x KC * kThreads
  __shared__ Shared sh;
  center_loop_unmasked<T, NR, KC, NBUF>(a, reinterpret_cast<T*>(smem), sh);
}

// ---------------------------------------------------------------------------
// The masked modes
// ---------------------------------------------------------------------------

constexpr int kGroupLanes = 32;                    // a lane group's lanes: a tile's columns
constexpr int kLaneGroups = kLanes / kGroupLanes;  // 128, the grid at most
constexpr int kProducers = 2;                      // producer warps: tiles s = w (mod 2)
constexpr int kMaskedThreads = kThreads + 32 * kProducers;  // and the 8 consumer warps
constexpr int kMaxRing = 32;                       // ring slots at most
constexpr int kRingBytes = 200 * 1024;             // the ring's bytes at most: one block an SM
constexpr int kMbarBytes = 2 * kMaxRing * 8;       // each slot's full and empty mbarrier
constexpr int kBarConsumers = 1;                   // named barrier of the consumer warps
constexpr int kGroupTiles = kWarps;                // a tile group: a tile a consumer warp

// A ring row: a tile row's 32 columns at its start's byte shift (< 16).
template <typename T>
__host__ __device__ constexpr int ring_row() { return kGroupLanes * (int)sizeof(T) + 16; }

// Tiles of lane group g: columns g * 32 + 4096 k + (0..31), k = 0, 1, ...
__device__ __forceinline__ int group_tiles(long long d, int g) {
  const long long c0 = (long long)g * kGroupLanes;
  return c0 < d ? (int)((d - 1 - c0) / kLanes + 1) : 0;
}

// The tiles of a block's pass, in order: its lane groups g = blockIdx.x,
// + G, ..., each one's tiles k = 0, 1, ...; every pass takes the same
// sequence, so tile s of the launch is tile s % per_pass of a pass.
__device__ __forceinline__ int block_tiles(long long d) {
  int t = 0;
  for (int g = blockIdx.x; g < kLaneGroups; g += gridDim.x) t += group_tiles(d, g);
  return t;
}

// Tile s of the launch goes to slot s % depth, its (s / depth)-th use:
// a place in the ring. Places advance by additions (no integer division
// in the loops).
struct RingPos {
  int k;           // slot
  unsigned phase;  // parity of the slot's use
};

struct MaskedRing {
  unsigned char* slots;  // depth slots of NR ring rows
  unsigned mbars;        // full[kMaxRing], then empty[kMaxRing]
  int depth, tile;       // slots, bytes a slot
  __device__ __forceinline__ RingPos at(int s) const {
    return {s % depth, (unsigned)(s / depth) & 1u};
  }
  // j places on (j <= depth)
  __device__ __forceinline__ RingPos next(RingPos p, int j) const {
    const int k = p.k + j;
    return k >= depth ? RingPos{k - depth, p.phase ^ 1u} : RingPos{k, p.phase};
  }
  __device__ __forceinline__ unsigned char* slot(RingPos p) const { return slots + p.k * tile; }
  __device__ __forceinline__ unsigned full(RingPos p) const { return mbars + p.k * 8; }
  __device__ __forceinline__ unsigned empty(RingPos p) const {
    return mbars + (kMaxRing + p.k) * 8;
  }
  __device__ __forceinline__ void wait_full(RingPos p) const {
    while (!mbar_try_wait(full(p), p.phase)) {
    }
  }
};

struct __align__(16) MaskedShared {
  float w[128];  // the step's weights (0 on an invalid row and past n)
  float zs[2][kGroupTiles][kGroupLanes];  // a tile group's new centre, by group parity
  float total, inv, delta;  // den (weiszfeld) / 1 / count (clip), both rounded; the step length
};

// The producer warps: tiles [from, to) of the launch into the ring (warp
// w the tiles s = w mod kProducers), each once the consumers have
// released the slot's tile before it. A tile row is copied from its
// 16-byte-aligned start (a row of d = 421,642 f32 is 8-byte aligned, a
// 16-bit row may start at an odd element) in 16-byte cp.async pieces, a
// lane a piece; each lane then arrives on the slot's full mbarrier once
// its copies have landed. (One bulk copy a row, cp.async.bulk, issued
// these 64- and 128-byte rows several times slower than a step's bytes
// allow.)
template <typename T>
__device__ __forceinline__ void produce(const LoopArgs& a, const MaskedRing& ring, int from, int to,
                                        int per_pass) {
  constexpr int kPieces = ring_row<T>() / 16;  // 16-byte pieces a ring row
  constexpr int kRowsAt = 32 / kPieces;        // rows a warp copies at once
  const char* x = static_cast<const char*>(a.x);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x - kThreads) >> 5;
  // the lane's piece of rows ro, ro + kRowsAt, ...
  const int ro = lane / kPieces, piece = lane - ro * kPieces;
  const unsigned a16 = static_cast<unsigned>(reinterpret_cast<uintptr_t>(a.x)) & 15u;
  const unsigned e16 = static_cast<unsigned>(a.d * (long long)sizeof(T)) & 15u;
  const long long row_bytes = a.d * (long long)sizeof(T);
  int s = from + ((warp - from) % kProducers + kProducers) % kProducers;
  if (s >= to) return;
  RingPos pos = ring.at(s);
  int k = s % per_pass, g = blockIdx.x;  // tile k of lane group g
#pragma unroll 1
  for (;;) {
    for (int nt = group_tiles(a.d, g); k >= nt; nt = group_tiles(a.d, g)) {
      k -= nt;
      // past the block's last lane group: on into the next pass
      g = g + (int)gridDim.x < kLaneGroups ? g + (int)gridDim.x : blockIdx.x;
    }
    const long long c0 = (long long)g * kGroupLanes + (long long)k * kLanes;
    const unsigned bytes =
        (unsigned)(a.d - c0 < kGroupLanes ? a.d - c0 : kGroupLanes) * (unsigned)sizeof(T);
    if (s >= ring.depth) {
      while (!mbar_try_wait(ring.empty(pos), pos.phase ^ 1u)) {
      }
    }
    unsigned char* dst = ring.slot(pos) + ro * ring_row<T>() + piece * 16;
    const char* src = x + c0 * (long long)sizeof(T) + ro * row_bytes + piece * 16;
    if (ro < kRowsAt) {
      for (int r = ro; r < a.n; r += kRowsAt) {
        const unsigned sh = (a16 + (unsigned)r * e16) & 15u;
        if (piece * 16u < sh + bytes) cp_async<16>(dst, src - sh, 16);
        dst += kRowsAt * ring_row<T>();
        src += kRowsAt * row_bytes;
      }
    }
    cp_async_mbar_arrive(ring.full(pos));
    s += kProducers;
    if (s >= to) return;
    pos = ring.next(pos, kProducers);
    k += kProducers;
  }
}

// A column's step (lane l of a warp: column l of its tile, row i at col +
// i ring rows + its byte shift sh8[i % 8]) from its centre zc: B11's FMA
// chain over every row in order from +0.0, of x (weiszfeld) or of rnd(x -
// zc) (clip); then weiszfeld rnd(rnd(num) / den), clip rnd(zc +
// rnd(rnd(num) * inv)). The rows n..NR-1 of a slot are zeros of weight 0:
// each adds +-0 to a sum that is never -0 (or NaN where zc is not finite,
// where every row's weight is 0 or NaN and the column is NaN anyway), so
// the chain runs NR rows without a branch, its loads issued ahead, and the
// weights load 4 at a time.
template <typename T, int NR, bool CLIP>
__device__ __forceinline__ float column_step(const unsigned char* col, const unsigned (&sh8)[8],
                                             float zc, const MaskedShared& sh) {
  float acc = 0.0f;
#pragma unroll
  for (int i0 = 0; i0 < NR; i0 += 4) {
    const float4 w4 = *reinterpret_cast<const float4*>(sh.w + i0);
    const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r;
      const float xv = to_f32(*reinterpret_cast<const T*>(col + i * ring_row<T>() + sh8[i % 8]));
      acc = __fmaf_rn(w[r], CLIP ? rnd<T>(__fsub_rn(xv, zc)) : xv, acc);
    }
  }
  return CLIP ? rnd<T>(__fadd_rn(zc, rnd<T>(__fmul_rn(rnd<T>(acc), sh.inv))))
              : rnd<T>(__fdiv_rn(rnd<T>(acc), sh.total));
}

// One pass of a masked loop over the block's tiles; x is read once. The
// consumers take the tiles 8 at a time (a tile group; fewer at a lane
// group's end). Phase A: warp w forms the new centre of the group's tile
// w (sweep: column_step on its lane's column, from zin, written to out,
// with rnd(e^2), e = rnd(z_new - zin), to the e2 scratch where step; else
// zin's values), zin's values loaded a group ahead. Phase B (dist):
// thread (w, l) adds (x_ic - z_c)^2 of rows w, w + 8, ... at its column of
// each of the group's tiles in order to its lane accumulators,
// row_sq_dists' chains (i, g * 32 + l) over k ascending, which go to the
// lane scratch at the lane group's end.
template <typename T, int NR>
__device__ __forceinline__ void masked_pass(const LoopArgs& a, const MaskedRing& ring, int& seq,
                                            const T* zin, bool sweep, bool dist, bool step,
                                            MaskedShared& sh) {
  constexpr int kRows = NR / kWarps;  // a consumer's rows
  T* out = static_cast<T*>(a.out);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool clip = a.mode == kMaskedClip;
  // a row's byte shift repeats every 8 rows (8 row strides are a multiple of 16 bytes)
  unsigned sh8[8];
  const unsigned a16 = static_cast<unsigned>(reinterpret_cast<uintptr_t>(a.x)) & 15u;
  const unsigned e16 = static_cast<unsigned>(a.d * (long long)sizeof(T)) & 15u;
#pragma unroll
  for (int u = 0; u < 8; ++u) sh8[u] = (a16 + u * e16) & 15u;
  const int mine = (int)((a16 + warp * e16) & 15u) + lane * (int)sizeof(T);  // rows warp + 8 m
  RingPos pos = ring.at(seq);  // the tile group's first tile
  int grp = 0;
#pragma unroll 1
  for (int g = blockIdx.x; g < kLaneGroups; g += gridDim.x) {
    const int nt = group_tiles(a.d, g);
    const long long c0 = (long long)g * kGroupLanes + lane;  // this lane's column of tile 0
    float acc[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m) acc[m] = 0.0f;
    const long long cw = c0 + (long long)warp * kLanes;  // ... of the warp's tile in group 0
    float zpre = cw < a.d ? to_f32(zin[cw]) : 0.0f;       // zin there, loaded a group ahead
#pragma unroll 1
    for (int t0 = 0; t0 < nt; t0 += kGroupTiles, ++grp) {
      const int tiles = nt - t0 < kGroupTiles ? nt - t0 : kGroupTiles;
      float* zs = &sh.zs[grp & 1][0][0];
      const float zc = zpre;
      const long long c = cw + (long long)t0 * kLanes;  // this lane's column of the warp's tile
      const long long cn = c + (long long)kGroupTiles * kLanes;
      if (cn < a.d) zpre = to_f32(zin[cn]);
      if (warp < tiles) {
        const RingPos pw = ring.next(pos, warp);
        ring.wait_full(pw);
        float zn = zc;
        if (sweep) {
          const unsigned char* col = ring.slot(pw) + lane * sizeof(T);
          zn = clip ? column_step<T, NR, true>(col, sh8, zc, sh)
                    : column_step<T, NR, false>(col, sh8, zc, sh);
          if (c < a.d) {
            out[c] = from_f32<T>(zn);
            if (step) {
              const float e = rnd<T>(__fsub_rn(zn, zc));
              a.e2[c] = rnd<T>(__fmul_rn(e, e));
            }
          }
        }
        zs[warp * kGroupLanes + lane] = zn;
      }
      bar_sync(kBarConsumers, kThreads);  // the group's centre is in zs
      if (dist) {
        for (int j = 0; j < tiles; ++j) ring.wait_full(ring.next(pos, j));
#pragma unroll
        for (int j = 0; j < kGroupTiles; ++j) {
          const bool in = j < tiles && c0 + (long long)(t0 + j) * kLanes < a.d;
          const float zc_j = zs[j * kGroupLanes + lane];
          const unsigned char* base = ring.slot(ring.next(pos, j)) + mine;
#pragma unroll
          for (int m = 0; m < kRows; ++m) {  // rows n..NR-1: zeros, never stored
            const T xv = *reinterpret_cast<const T*>(base + (warp + kWarps * m) * ring_row<T>());
            const float v = __fsub_rn(to_f32(xv), zc_j);
            if (in) acc[m] = __fadd_rn(acc[m], __fmul_rn(v, v));
          }
        }
      }
      __syncwarp();
      if (lane == 0)
        for (int j = 0; j < tiles; ++j) mbar_arrive(ring.empty(ring.next(pos, j)));
      seq += tiles;
      pos = ring.next(pos, tiles);
    }
    if (dist) {
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int i = warp + kWarps * m;
        if (i < a.n) a.lanes[(long long)i * kLanes + g * kGroupLanes + lane] = acc[m];
      }
    }
  }
}

// After a pass: rows 0..n-1 of the lane partials to the rounded weights
// (0 on an invalid row), and (with_step) the step length's chunk partials
// from e2, in B7's chunk order (a warp emulates the chunk's 256 threads:
// lane l holds thread 32 w + l's sum of columns 32 w + l + 256 k, then
// warp w's butterfly, lane 0's value, the 8 warps in order); a consumer
// warp an item over the grid's consumer warps.
template <typename T>
__device__ void masked_reduce(const LoopArgs& a, bool with_step) {
  const int lane = threadIdx.x & 31;
  const int items = a.n + (with_step ? a.nchunks : 0);
  const int stride = gridDim.x * kWarps;
  for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < items; r += stride) {
    if (r < a.n) {  // lane partials lane, lane + 32, ... in order, 32 loads in flight
      const float* p = a.lanes + (long long)r * kLanes + lane;
      float s = 0.0f;
#pragma unroll 1
      for (int k0 = 0; k0 < kLanes / 32; k0 += 32) {
        float v[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) v[k] = __ldcg(p + (k0 + k) * 32);
#pragma unroll
        for (int k = 0; k < 32; ++k) s = __fadd_rn(s, v[k]);
      }
      s = warp_sum(s);
      if (lane != 0) continue;
      const float den = nan_max(__fsqrt_rn(from_f32<float>(s)), a.eps);
      const float w = a.mode == kMaskedClip ? nan_min(1.0f, __fdiv_rn(a.c_tau, den))
                                            : __fdiv_rn(1.0f, den);
      a.raw[r] = a.valid[r] ? rnd<T>(w) : 0.0f;
    } else {
      // (a column past d adds +0.0 where the chunk's thread skips it: the
      // same bits, as every partial is >= +0 or NaN)
      const long long c0 = (long long)(r - a.n) * kChunk;
      float v[kWarps][kSteps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
#pragma unroll
        for (int k = 0; k < kSteps; ++k) {
          const long long c = c0 + w * 32 + lane + k * kThreads;
          v[w][k] = c < a.d ? __ldcg(a.e2 + c) : 0.0f;
        }
      float part = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        float t = 0.0f;
#pragma unroll
        for (int k = 0; k < kSteps; ++k) t = __fadd_rn(t, v[w][k]);
        part = __fadd_rn(part, __shfl_sync(0xFFFFFFFFu, warp_sum(t), 0));
      }
      if (lane == 0) a.partial[(long long)a.n * a.nchunks + (r - a.n)] = part;
    }
  }
}

// Every block takes the same weights, den = rnd(sum_i w_i) in row order
// from +0.0 (B11's chain of w against ones), the clip step's 1 / count
// rounded, and (with_step) the step length from the chunk partials.
template <typename T>
__device__ void masked_form_weights(const LoopArgs& a, MaskedShared& sh, bool with_step) {
  const int t = threadIdx.x;
  if (t < 128) sh.w[t] = t < a.n ? __ldcg(a.raw + t) : 0.0f;  // the zero rows' weight 0
  if (with_step && t < 32) {  // chunk partials t, t + 32, ... in order (+0.0 past the last)
    const float* p = a.partial + (long long)a.n * a.nchunks + t;
    float s = 0.0f;
#pragma unroll 1
    for (int b0 = 0; b0 < a.nchunks; b0 += 32 * 32) {
      float v[32];
#pragma unroll
      for (int k = 0; k < 32; ++k)
        v[k] = b0 + 32 * k + t < a.nchunks ? __ldcg(p + b0 + 32 * k) : 0.0f;
#pragma unroll
      for (int k = 0; k < 32; ++k) s = __fadd_rn(s, v[k]);
    }
    s = warp_sum(s);
    if (t == 0) sh.delta = rnd<T>(__fsqrt_rn(rnd<T>(s)));
  }
  const int count = __syncthreads_count(t < a.n && a.valid[t] != 0);
  if (t == 0) {
    float total = 0.0f;
#pragma unroll 8
    for (int i = 0; i < a.n; ++i) total = __fadd_rn(total, sh.w[i]);
    sh.total = rnd<T>(total);
    sh.inv = rnd<T>(__fdiv_rn(1.0f, (float)count));
  }
  __syncthreads();
}

// The masked loops: a first pass to z0, then each step a pass, a grid
// barrier, the row reduce, a grid barrier and the weights (and the stop
// test). The producer warp copies a pass's tiles and, where another pass
// may follow, the next pass's first ring-full (x does not change), so the
// next pass starts with its copies landed; a launch that stops without
// that pass waits for them before it ends.
template <typename T, int NR>
__global__ void __launch_bounds__(kMaskedThreads, 1) masked_loop_kernel(LoopArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];  // the mbarriers, then the ring
  __shared__ MaskedShared sh;
  const MaskedRing ring{smem + kMbarBytes, smem_addr(smem), a.depth, NR * ring_row<T>()};
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.depth; ++s) {
      mbar_init(ring.full(ring.at(s)), 32);  // a producer warp's lanes
      mbar_init(ring.empty(ring.at(s)), kWarps);
    }
    mbar_fence_init();
  }
  // a slot's rows n..NR-1 hold zeros for good (the producers copy rows < n)
  const int pad = (NR - a.n) * ring_row<T>() / 4;
  for (int e = threadIdx.x; e < a.depth * pad; e += blockDim.x)
    reinterpret_cast<float*>(ring.slot(ring.at(e / pad)) + a.n * ring_row<T>())[e % pad] = 0.0f;
  __syncthreads();
  const bool producer = threadIdx.x >= kThreads;
  const bool weiszfeld = a.mode == kMaskedWeiszfeld;
  const int per_pass = block_tiles(a.d);
  const int ahead = per_pass < a.depth ? per_pass : a.depth;  // a next pass's first copies
  const T* zin = static_cast<const T*>(a.z0);
  int seq = 0, issued = 0, passes = 0, it = 0;
  bool sweep = false, last = false;  // the first pass: the distances to z0
  for (;;) {
    ++passes;
    if (producer) {
      const int to = passes * per_pass + (last ? 0 : ahead);
      produce<T>(a, ring, issued, to, per_pass);
      issued = to;
    } else {
      masked_pass<T, NR>(a, ring, seq, zin, sweep, !last, sweep && weiszfeld && !last, sh);
    }
    if (sweep) {
      ++it;
      zin = static_cast<const T*>(a.out);
    }
    if (last) break;
    const bool with_step = weiszfeld && it > 0;
    grid_sync(a.counter);
    if (!producer) masked_reduce<T>(a, with_step);
    grid_sync(a.counter);
    masked_form_weights<T>(a, sh, with_step);
    if (with_step && !(sh.delta > a.tol)) break;
    sweep = true;
    last = it + 1 == a.max_iter;
  }
  if (producer)  // copies of a pass that did not run
    for (int s = passes * per_pass; s < issued; ++s) ring.wait_full(ring.at(s));
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.iters = it;
}

// A cooperative launch through cudaLaunchKernelEx, which a stream capture
// records as a cooperative kernel node (the compiled steps' CUDA graphs).
template <typename K>
int cooperative_launch(K kernel, int grid, int threads, size_t smem, LoopArgs& a, cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// Blocks of `kernel` an SM at `threads` and `smem` (opted in above 48 KB).
template <typename K>
int blocks_per_sm(K kernel, int threads, size_t smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (err == cudaSuccess && *per_sm < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

// Rows per instance; a step's columns (KC * 256: 512 at 16 rows and below,
// where 1024 spilled and was slower at 8 rows); one staging buffer
// (occupancy beat a second buffer's overlap; chip_center_ablation.py).
template <typename T, int NR>
int launch_rows(LoopArgs& a, int sms, cudaStream_t s) {
  constexpr int KC = NR <= 16 ? 2 : 1;
  constexpr int NBUF = 1;
  auto kernel = center_loop_kernel<T, NR, KC, NBUF>;
  const size_t smem = (size_t)NBUF * a.n * KC * kThreads * sizeof(T);
  int per_sm = 0;
  const int err = blocks_per_sm(kernel, kThreads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const long long fit = (long long)per_sm * sms;
  const int grid = (int)(a.nchunks < fit ? a.nchunks : fit);
  return cooperative_launch(kernel, grid, kThreads, smem, a, s);
}

// The masked modes: as many ring slots of NR rows as kRingBytes holds (at
// least 11 at 128 f32 rows, so a tile group of 8 always fits beside copies
// in flight);
// the grid one block a lane group, or every co-resident block.
template <typename T, int NR>
int launch_masked_rows(LoopArgs& a, int sms, cudaStream_t s) {
  auto kernel = masked_loop_kernel<T, NR>;
  const int tile = NR * ring_row<T>();
  a.depth = kRingBytes / tile < kMaxRing ? kRingBytes / tile : kMaxRing;
  const size_t smem = kMbarBytes + (size_t)a.depth * tile;
  int per_sm = 0;
  const int err = blocks_per_sm(kernel, kMaskedThreads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const int grid = per_sm * sms < kLaneGroups ? per_sm * sms : kLaneGroups;
  return cooperative_launch(kernel, grid, kMaskedThreads, smem, a, s);
}

template <typename T, int NR>
int launch_instance(LoopArgs& a, int sms, cudaStream_t s) {
  return a.mode >= kMaskedWeiszfeld ? launch_masked_rows<T, NR>(a, sms, s)
                                    : launch_rows<T, NR>(a, sms, s);
}

template <typename T>
int launch_loop(LoopArgs& a, int sms, cudaStream_t s) {
  if (a.n <= 8) return launch_instance<T, 8>(a, sms, s);
  if (a.n <= 16) return launch_instance<T, 16>(a, sms, s);
  if (a.n <= 32) return launch_instance<T, 32>(a, sms, s);
  if (a.n <= 64) return launch_instance<T, 64>(a, sms, s);
  return launch_instance<T, 128>(a, sms, s);
}

}  // namespace

// x: (n, d) contiguous, 1 <= n <= 128, d >= 1; z0, out: (d,) of x's dtype
// (out may not alias z0); scratch: (n + 1) * ceil(d / 1024) + n + 1 f32,
// and n * 4096 + d more in modes 2 and 3; ints: 2 int32, [0] receives the
// steps taken. mode 0 = weiszfeld, 1 = clip, 2 = masked_weiszfeld, 3 =
// masked_clip (valid: n bytes, nonzero on a cohort row; null in modes 0
// and 1); tol is compared as given (round it to x's dtype first). Phases
// (modes 0 and 1): w_in and alpha_in non-null: one sweep under them;
// wa_out non-null: stop after the first weights and write n weights, then
// alpha. Otherwise max_iter >= 1 steps at most. Returns the launch's
// cudaError_t.
extern "C" int byz_center_loop(const void* x, const void* z0, void* out, const float* w_in,
                               const float* alpha_in, float* wa_out, float* scratch, int* ints,
                               const unsigned char* valid, int n, long long d, int mode,
                               float eps, float c_tau, float tol, int max_iter, int dtype,
                               void* stream) {
  const bool masked = mode == kMaskedWeiszfeld || mode == kMaskedClip;
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
  a.e2 = masked ? a.lanes + (long long)n * kLanes : nullptr;
  a.depth = 0;
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
