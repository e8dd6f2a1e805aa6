// B3: Gram matrix x @ x^T of K stacked (n, d) rounds, f32 accumulation.
//
// Replaces byzpy_tpu/ops/pallas_kernels.py:289 _gram_kernel (pallas_call at
// :329) and the Gram phase of the fused selection kernel
// (_accumulate_gram, :820). The TPU kernel adds every feature tile into one
// (n, n) output block over a sequential grid. CUDA blocks run in no order,
// so the sum is split in two launches:
//   1. split-K: block (b, k) takes columns [b * chunk, (b + 1) * chunk) of
//      round k and writes its partial Gram, the entries i <= j < n packed
//      row by row, in exact f32 FFMA (no TF32, no tensor cores);
//   2. the fixed-order reduce: each entry's partials summed in chunk order,
//      then mirrored to (j, i). The wrapper sizes the chunks from the
//      card's SM count (ops/kernels.py:gram_chunks), with a floor of 512
//      columns. No float atomics: the same input gives the same bits on
//      every run.
// The order, which gram_split_k_plain (ops/kernels.py) repeats bit for bit:
// partial (b, k)[i][j] = fmaf(x[i][c], x[j][c], acc) from +0.0 for c
// ascending over the chunk's columns, the last chunk's zero-padded past d
// to a multiple of 32; entry (i, j) = the partials added by __fadd_rn from
// +0.0 in chunk order.
//
// Bound: f32 FMAs at 128 rows (128 * 129 / 2 * 421,642 FMAs, ~0.104 ms at
// 67 TFLOP/s), bytes at 64 rows and fewer (one read of x), latency at the
// main path's 8 rows (25 tiles a chunk, ~0.004 ms of bytes).
// Design of gram_partial_kernel:
//   - a ring of STAGES shared buffers, each SUB 32-column sub-tiles of the
//     n real rows, fed by cp.async with STAGES - 1 stages in flight and one
//     barrier a stage. Every thread copies: the block's threads take the
//     rows' pieces in turn, every lane busy, at the widest of 16, 8 or 4
//     bytes that divides the round's start and row stride (2: a 16-bit
//     round at odd elements, by plain loads); the pieces past d are
//     zero-filled whole. 16-bit rows are staged as they are and widened to
//     f32 behind a second barrier. (A row a warp left half the lanes idle
//     at the 8-byte pieces that odd rows take when d * 4 is 8 mod 16, and
//     producer warps that took every copy could not issue them fast enough.)
//   - register tiles: a thread owns TM x TN entries (8 x 8 at 128 rows, 4 x
//     4 at 64, 4 x 8, 2 x 4 and 1 x 2 below), rows and columns contiguous,
//     and the threads take the tiles that hold an entry i <= j in row-major
//     order (136 threads at 128 and 64 rows: 1.05x the symmetric half's
//     FMAs). Per 4 columns a thread loads TM + TN 16-byte fragments, then
//     runs its TM x TN chains one column at a time;
//   - bank-conflict-free without padding: a staged f32 row is 128 bytes a
//     sub-tile, its 16-byte piece c stored at c ^ s(r), s(r) = (r ^ r >> 3)
//     & 7, so the rows that a quarter-warp reads at one column lie in
//     distinct banks (at 128 rows 1.18x the ideal wavefronts, where a
//     quarter holds tiles 8 rows-of-8 apart). A thread keeps one register a
//     side: row r0 + u's piece q is at (X ^ (q ^ u) << 4) + 128 u.
// Design of gram_reduce_kernel: a block takes 8 neighbouring packed entries
// of one round and stages their partials entry-major with 4-byte cp.async,
// in two halves so that the first half's chains run while the second half
// lands; 8 threads then add 4 partials a shared load, in chunk order.

#include "common.cuh"

namespace {

constexpr int kTK = 32;             // columns a sub-tile; chunks are multiples of it
constexpr int kRowBytes = kTK * 4;  // a sub-tile's row as f32: 8 pieces of 16 bytes
constexpr int kReduceEntries = 8;   // packed entries a reduce block
constexpr int kReduceThreads = 256;
constexpr int kReduceBatch = 1504;  // chunks staged at once (48,256 bytes)

// Thread tiles (ti, tj) of TM rows x TN columns that hold an entry i <= j.
__host__ __device__ constexpr int live_tiles(int npad, int tm, int tn) {
  int c = 0;
  for (int ti = 0; ti < npad / tm; ++ti) c += npad / tn - ti * tm / tn;
  return c;
}

// The partial's shape at network width NPAD (8 serves n <= 8): thread tiles
// of TM x TN entries, their column loop unrolled QU of 8 steps; stages of
// SUB sub-tiles, STAGES of them in the ring; at least BLOCKS blocks an SM.
template <int NPAD>
struct GramShape {
  static constexpr int TM = NPAD == 128 ? 8 : NPAD == 64 ? 4 : NPAD / 8;
  static constexpr int TN = NPAD == 128 ? 8 : NPAD == 64 ? 4 : NPAD / 4;
  static constexpr int QU = NPAD == 128 ? 1 : NPAD == 64 ? 4 : 8;  // no spill at 64
  static constexpr int GJ = NPAD / TN;
  static constexpr int LIVE = live_tiles(NPAD, TM, TN);
  static constexpr int THREADS = LIVE <= 128 ? 128 : (LIVE + 31) / 32 * 32;  // all of them copy
  static constexpr int SUB = NPAD >= 64 ? 2 : 4;
  static constexpr int STAGES = NPAD >= 64 ? 3 : NPAD == 32 ? 4 : NPAD == 16 ? 6 : 8;
  static constexpr int BLOCKS = NPAD == 128 ? 2 : 4;
};

template <typename T, int NPAD>
struct Staging {
  using S = GramShape<NPAD>;
  static constexpr bool kNative = sizeof(T) == 2;  // staged as is, widened to f32 a stage
  static constexpr int kSubBytes = NPAD * kRowBytes;  // an f32 sub-tile
  static constexpr int kPitch = S::SUB * kTK * (int)sizeof(T) + 16;  // a staged 16-bit row
  static constexpr int kSlot = kNative ? NPAD * kPitch : S::SUB * kSubBytes;
  static constexpr int kRing = kNative ? S::SUB * kSubBytes : 0;  // the ring's offset
  static constexpr int kBytes = kRing + S::STAGES * kSlot;  // dynamic shared memory
};

__device__ __forceinline__ int swizzle(int r) { return (r ^ (r >> 3)) & 7; }

// The copy width of every row of a round: the widest of 16, 8 and 4 bytes
// that divides both the round's start and its row stride (a stage's
// columns start a multiple of 64 bytes into a row), or 2 for a 16-bit
// round whose rows start at odd elements.
__device__ __forceinline__ int copy_width(const void* xk, long long row_bytes, int n) {
  const unsigned long long a =
      reinterpret_cast<uintptr_t>(xk) | (n > 1 ? (unsigned long long)row_bytes : 0ull);
  return (a & 15u) == 0 ? 16 : (a & 7u) == 0 ? 8 : (a & 3u) == 0 ? 4 : 2;
}

// Stage the n rows' `span` bytes from `base` (row j at base + j row_bytes)
// into ring buffer `slot`, `bytes` of each row valid and the rest zeros.
// The block's threads take the rows' W-byte pieces in turn, every lane
// busy. f32 pieces land in the stage's sub-tiles, the 16-byte piece c of
// row r at c ^ s(r); 16-bit rows as they are (W = 2: by plain loads).
template <int W, typename T, int NPAD>
__device__ __forceinline__ void stage_pieces(const char* base, long long row_bytes, char* slot,
                                             int n, int bytes) {
  using G = Staging<T, NPAD>;
  constexpr int PPR = GramShape<NPAD>::SUB * kTK * (int)sizeof(T) / W;  // pieces a row
  for (int idx = threadIdx.x; idx < n * PPR; idx += GramShape<NPAD>::THREADS) {
    const int j = idx / PPR, p = idx % PPR * W, left = bytes - p;
    const char* src = base + j * row_bytes + (left > 0 ? p : 0);
    if constexpr (W == 2) {
      *reinterpret_cast<unsigned short*>(slot + j * G::kPitch + p) =
          left > 0 ? *reinterpret_cast<const unsigned short*>(src) : (unsigned short)0;
    } else {
      const int size = left >= W ? W : (left > 0 ? left : 0);
      if constexpr (G::kNative) {
        cp_async<W>(slot + j * G::kPitch + p, src, size);
      } else {
        cp_async<W>(slot + j * kRowBytes + (p >> 7) * G::kSubBytes +
                        ((((p >> 4) & 7) ^ swizzle(j)) << 4) + (p & 15),
                    src, size);
      }
    }
  }
}

// Stage columns [col0, col0 + 32 SUB) of round xk's n rows, `valid` of them
// before the chunk's end, at copy width w.
template <typename T, int NPAD>
__device__ __forceinline__ void stage_tile(const T* __restrict__ xk, int w, char* slot, int n,
                                           long long d, long long col0, int valid) {
  const char* base = reinterpret_cast<const char*>(xk + col0);
  const long long rb = d * (long long)sizeof(T);
  const int bytes = valid * (int)sizeof(T);
  if (w == 16) {
    stage_pieces<16, T, NPAD>(base, rb, slot, n, bytes);
  } else if (w == 8) {
    stage_pieces<8, T, NPAD>(base, rb, slot, n, bytes);
  } else if (w == 4) {
    stage_pieces<4, T, NPAD>(base, rb, slot, n, bytes);
  } else if constexpr (sizeof(T) == 2) {
    stage_pieces<2, T, NPAD>(base, rb, slot, n, bytes);
  }
}

__device__ __forceinline__ void widen(unsigned w, __nv_bfloat16, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ void widen(unsigned w, __half, float& lo, float& hi) {
  lo = __half2float(__ushort_as_half((unsigned short)(w & 0xFFFFu)));
  hi = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}

// The n rows of a staged 16-bit stage into the f32 sub-tiles at `f32`,
// swizzled as f32 rows are staged: 8 values a thread at a time.
template <typename T, int NPAD>
__device__ __forceinline__ void widen_stage(const char* native, char* f32, int n) {
  using G = Staging<T, NPAD>;
  constexpr int PIECES = GramShape<NPAD>::SUB * 4;  // 16-byte pieces of a staged row
  for (int e = threadIdx.x; e < n * PIECES; e += GramShape<NPAD>::THREADS) {
    const int j = e / PIECES, h = e % PIECES, s = swizzle(j);
    const uint4 w = *reinterpret_cast<const uint4*>(native + j * G::kPitch + h * 16);
    float v[8];
    widen(w.x, T(), v[0], v[1]);
    widen(w.y, T(), v[2], v[3]);
    widen(w.z, T(), v[4], v[5]);
    widen(w.w, T(), v[6], v[7]);
    char* row = f32 + (h >> 2) * G::kSubBytes + j * kRowBytes;
    const int c = 2 * (h & 3);
    *reinterpret_cast<float4*>(row + ((c ^ s) << 4)) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(row + (((c + 1) ^ s) << 4)) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Index of entry (i, j), i <= j < n, in a packed partial plane.
__device__ __forceinline__ int packed_index(int i, int j, int n) {
  return i * n - i * (i - 1) / 2 + (j - i);
}

// A thread's operand register for the TM (or TN) rows from r0 (a multiple
// of TM, TM | 8) in a sub-tile at byte `tile` (a multiple of 128): row r0 +
// u's piece q lies at (X ^ (q ^ u) << 4) + 128 u, since s(r0 + u) = s(r0) ^ u.
__device__ __forceinline__ int operand_base(int tile, int r0) {
  return tile + r0 * kRowBytes + (swizzle(r0) << 4);
}

// acc[u][v] += x[ri + u][c] x[rj + v][c] over the sub-tile's 32 columns c
// in order, one fmaf each.
template <int TM, int TN, int QU>
__device__ __forceinline__ void multiply_subtile(const char* smem, int tile, int ri, int rj,
                                                 float (&acc)[TM][TN]) {
  const int xa = operand_base(tile, ri), xb = operand_base(tile, rj);
#pragma unroll 1
  for (int q0 = 0; q0 < kTK / 4; q0 += QU) {  // QU | 8, so q0 + qq = q0 ^ qq
    const int ya = xa ^ (q0 << 4), yb = xb ^ (q0 << 4);
#pragma unroll
    for (int qq = 0; qq < QU; ++qq) {  // columns 4 (q0 + qq) .. + 3
      float4 a[TM], bv[TN];
#pragma unroll
      for (int u = 0; u < TM; ++u)
        a[u] = *reinterpret_cast<const float4*>(smem + (ya ^ ((qq ^ u) << 4)) + u * kRowBytes);
#pragma unroll
      for (int v = 0; v < TN; ++v)
        bv[v] = *reinterpret_cast<const float4*>(smem + (yb ^ ((qq ^ v) << 4)) + v * kRowBytes);
      // columns ascending: each entry's chain in order
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) acc[u][v] = __fmaf_rn(a[u].x, bv[v].x, acc[u][v]);
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) acc[u][v] = __fmaf_rn(a[u].y, bv[v].y, acc[u][v]);
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) acc[u][v] = __fmaf_rn(a[u].z, bv[v].z, acc[u][v]);
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) acc[u][v] = __fmaf_rn(a[u].w, bv[v].w, acc[u][v]);
    }
  }
}

template <typename T, int NPAD>
__global__ void __launch_bounds__(GramShape<NPAD>::THREADS, GramShape<NPAD>::BLOCKS)
gram_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, int n, long long d,
                    long long chunk, int nchunks) {
  using S = GramShape<NPAD>;
  using G = Staging<T, NPAD>;
  constexpr int TM = S::TM, TN = S::TN, STAGES = S::STAGES, WIDTH = S::SUB * kTK;
  extern __shared__ __align__(128) char smem[];
  const int b = blockIdx.x, k = blockIdx.y;
  const T* xk = x + (long long)k * n * d;
  const long long c0 = (long long)b * chunk;
  const long long c1 = (c0 + chunk < d) ? c0 + chunk : d;
  const int ntiles = c0 < c1 ? (int)((c1 - c0 + kTK - 1) / kTK) : 0;  // 32-column sub-tiles
  const int nstages = (ntiles + S::SUB - 1) / S::SUB;

  int ti = 0, t = threadIdx.x;  // this thread's tile: a row-major walk of the live tiles
  while (ti < NPAD / TM && t >= S::GJ - ti * TM / TN) {
    t -= S::GJ - ti * TM / TN;
    ++ti;
  }
  const int ri = ti * TM, rj = (ti * TM / TN + t) * TN;
  const bool live = threadIdx.x < S::LIVE && rj < n;  // holds an entry i <= j < n
  float acc[TM][TN];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[u][v] = 0.0f;

  // prologue: the first STAGES - 1 stages in flight, one group each
  const int w = copy_width(xk, d * (long long)sizeof(T), n);
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nstages) {
      const long long col0 = c0 + (long long)s * WIDTH;
      stage_tile<T, NPAD>(xk, w, smem + G::kRing + s * G::kSlot, n, d, col0,
                          (int)min((long long)WIDTH, c1 - col0));
    }
    cp_async_commit();
  }
  int buf = 0;
  for (int it = 0; it < nstages; ++it) {
    cp_async_wait<STAGES - 2>();  // this thread's pieces of stage `it` have landed
    __syncthreads();  // everyone's have; the buffer of stage it - 1 is free
    {
      const int sn = it + STAGES - 1;
      if (sn < nstages) {
        const int nb = buf == 0 ? STAGES - 1 : buf - 1;
        const long long col0 = c0 + (long long)sn * WIDTH;
        stage_tile<T, NPAD>(xk, w, smem + G::kRing + nb * G::kSlot, n, d, col0,
                            (int)min((long long)WIDTH, c1 - col0));
      }
      cp_async_commit();
    }
    int tiles = 0;  // byte offset of the stage's f32 sub-tiles
    if constexpr (G::kNative) {
      widen_stage<T, NPAD>(smem + G::kRing + buf * G::kSlot, smem, n);
      __syncthreads();
    } else {
      tiles = buf * G::kSlot;
    }
    if (live) {
      const int nsub = min(S::SUB, ntiles - it * S::SUB);
      for (int st = 0; st < nsub; ++st)
        multiply_subtile<TM, TN, S::QU>(smem, tiles + st * G::kSubBytes, ri, rj, acc);
    }
    buf = buf == STAGES - 1 ? 0 : buf + 1;
  }
  cp_async_wait<0>();  // no copy outlives the block
  if (!live) return;
  float* pk = partial + ((long long)k * nchunks + b) * (n * (n + 1) / 2);
#pragma unroll
  for (int u = 0; u < TM; ++u) {
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      const int i = ri + u, j = rj + v;
      if (i <= j && j < n) pk[packed_index(i, j, n)] = acc[u][v];
    }
  }
}

// Partials [lo, hi) of the block's entries into `staged` (entry e's at
// e * pitch + b), one 4-byte copy each; a warp reads 32 bytes of 4 planes.
__device__ __forceinline__ void stage_partials(float* staged, const float* pk, int plane, int ne,
                                               int pitch, int lo, int hi) {
  for (int idx = lo * kReduceEntries + threadIdx.x; idx < hi * kReduceEntries;
       idx += kReduceThreads) {
    const int bb = idx / kReduceEntries, e = idx % kReduceEntries;
    if (e < ne) cp_async<4>(&staged[e * pitch + bb], pk + (long long)bb * plane + e, 4);
  }
  cp_async_commit();
}

// s + partials [lo, hi) of one entry, in order; lo a multiple of 4.
__device__ __forceinline__ float add_partials(float s, const float* mine, int lo, int hi) {
  int bb = lo;
#pragma unroll 4
  for (; bb + 4 <= hi; bb += 4) {
    const float4 v = *reinterpret_cast<const float4*>(mine + bb);
    s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, v.x), v.y), v.z), v.w);
  }
  for (; bb < hi; ++bb) s = __fadd_rn(s, mine[bb]);
  return s;
}

// Block (e, k): packed entries [8 e, 8 e + 8) of round k. Thread t adds
// entry 8 e + t's partials in chunk order and writes the entry and its
// mirror.
__global__ void __launch_bounds__(kReduceThreads)
gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int n,
                   int nchunks) {
  extern __shared__ __align__(16) float staged[];  // kReduceEntries x pitch
  const int plane = n * (n + 1) / 2;
  const int e0 = blockIdx.x * kReduceEntries, k = blockIdx.y, tid = threadIdx.x;
  const int ne = min(kReduceEntries, plane - e0);
  const int pitch = (min(nchunks, kReduceBatch) + 31) / 32 * 32 + 4;  // conflict-free copies
  const float* pk = partial + (long long)k * nchunks * plane + e0;
  float s = 0.0f;
  for (int b0 = 0; b0 < nchunks; b0 += kReduceBatch) {
    const int nb = min(kReduceBatch, nchunks - b0);
    const int half = min(nb, (nb / 2 + 3) & ~3);  // a multiple of 4, or all of them
    stage_partials(staged, pk + (long long)b0 * plane, plane, ne, pitch, 0, half);
    stage_partials(staged, pk + (long long)b0 * plane, plane, ne, pitch, half, nb);
    cp_async_wait<1>();
    __syncthreads();
    if (tid < ne) s = add_partials(s, staged + tid * pitch, 0, half);
    cp_async_wait<0>();
    __syncthreads();
    if (tid < ne) s = add_partials(s, staged + tid * pitch, half, nb);
    __syncthreads();
  }
  if (tid >= ne) return;
  int i = 0, e = e0 + tid;  // row i of the packed plane holds n - i entries
  while (e >= n - i) {
    e -= n - i;
    ++i;
  }
  const int j = i + e;
  float* ok = out + (long long)k * n * n;
  ok[i * n + j] = s;
  ok[j * n + i] = s;
}

template <typename T, int NPAD>
cudaError_t launch_partial(const void* x, float* partial, int K, int n, long long d,
                           long long chunk, int nchunks, cudaStream_t s) {
  constexpr int dyn = Staging<T, NPAD>::kBytes;
  if (dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&gram_partial_kernel<T, NPAD>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)nchunks, (unsigned)K);
  gram_partial_kernel<T, NPAD><<<grid, GramShape<NPAD>::THREADS, dyn, s>>>(
      static_cast<const T*>(x), partial, n, d, chunk, nchunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* x, float* partial, int K, int n, long long d,
                         long long chunk, int nchunks, cudaStream_t s) {
  switch (n <= 8 ? 8 : network_width(n)) {
    case 8: return launch_partial<T, 8>(x, partial, K, n, d, chunk, nchunks, s);
    case 16: return launch_partial<T, 16>(x, partial, K, n, d, chunk, nchunks, s);
    case 32: return launch_partial<T, 32>(x, partial, K, n, d, chunk, nchunks, s);
    case 64: return launch_partial<T, 64>(x, partial, K, n, d, chunk, nchunks, s);
    case 128: return launch_partial<T, 128>(x, partial, K, n, d, chunk, nchunks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (K, n, d) contiguous; partial: K * nchunks * n (n + 1) / 2 f32 scratch
// (each chunk's packed upper triangle); out: (K, n, n) f32. npad is
// max(16, network_width(n)); chunk a multiple of 32 with nchunks * chunk >=
// d. Returns the launches' cudaError_t.
extern "C" int byz_gram(const void* x, float* partial, float* out, int K, int n,
                        long long d, long long chunk, int nchunks, int npad,
                        int dtype, void* stream) {
  const int want = network_width(n) < 16 ? 16 : network_width(n);
  if (n < 1 || n > 128 || npad != want || chunk % kTK != 0 || nchunks < 1 ||
      (long long)nchunks * chunk < d)
    return cudaErrorInvalidValue;
  if (K <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: err = launch_typed<float>(x, partial, K, n, d, chunk, nchunks, s); break;
    case kBF16: err = launch_typed<__nv_bfloat16>(x, partial, K, n, d, chunk, nchunks, s); break;
    case kF16: err = launch_typed<__half>(x, partial, K, n, d, chunk, nchunks, s); break;
    default: break;
  }
  if (err != cudaSuccess) return err;
  const int plane = n * (n + 1) / 2;
  const dim3 rgrid((unsigned)((plane + kReduceEntries - 1) / kReduceEntries), (unsigned)K);
  const int pitch = ((nchunks < kReduceBatch ? nchunks : kReduceBatch) + 31) / 32 * 32 + 4;
  gram_reduce_kernel<<<rgrid, kReduceThreads, kReduceEntries * pitch * (int)sizeof(float), s>>>(
      partial, out, n, nchunks);
  return cudaGetLastError();
}
