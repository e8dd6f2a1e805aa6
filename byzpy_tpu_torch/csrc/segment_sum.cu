// B11: the row-ordered segment sum out[c] = sum_r W[c, r] x[r], its twin
// over wire codes B12, and the masked family's per-row reduction
// sum_c (x[i, c] - z[c])^2 beside them.
//
// segment_sum replaces byzpy_tpu/ops/pallas_kernels.py:1840
// _ragged_segment_sum_kernel (pallas_call at :1964): x (R, d) in f32, bf16
// or f16, W (C, R) f32, out (C, d) in x's dtype, accumulated in f32; rows
// at or past the batch's fill are not read. Each grid step of the TPU
// kernel contracts all of W's cohorts against one (rows, tile) block of x,
// so it reads each row once for every cohort. Here the contract is the
// order: the masked aggregators of byzpy_tpu/ops/robust.py (:1344-1656)
// rest their padded == compacted bit identity on XLA:CPU's row einsum,
// which is one fused multiply-add chain over the rows in index order from
// +0.0 (appended zero rows keep every partial sum). So every output
// out[c, col] is acc = __fmaf_rn(W[c, r], x[r, col], acc) over rows 0 ..
// fill-1 in index order from +0.0, in one thread: no split over rows, no
// atomics, no reduction tree. __fmaf_rn says which rounding is meant (nvcc
// would contract a * b + c on its own; the plain version reproduces the
// single rounding). Every row is read and every term added, whatever its
// weight: 0 * inf is NaN, and a chain that starts at -0.0 keeps its sign
// only if every later zero term is added, so skipping zero weights, or
// walking only a cohort's own rows, would change bits for any W.
//
// Bound: memory. One read of the fill rows of x and a (C, d) write; at up
// to 16 cohorts the FMAs (2 C flops per value read) stay far under the
// card's f32 rate. Design (segment_sum_kernel):
//   - a block owns a strip of kThreads * V columns and a tile of CT
//     cohorts, CT the smallest of {1, 2, 4, 8, 16} that holds C; above 16
//     the grid's second dimension tiles C in 16s, so x is read ceil(C / 16)
//     times. A thread owns V neighbouring columns (16 bytes of a row while
//     CT x V stays small, 8 above: b11_columns) and CT x V accumulators: it
//     loads a row's values once and applies one FMA per cohort to each,
//     every accumulator's chain the one above;
//   - the block's (CT, rows) weight tile is staged in shared memory in
//     chunks of kChunk rows (any R), cohorts innermost, so one row's CT
//     weights arrive in one vector read that the whole block shares;
//   - row r starts at byte r d sizeof(T), so its alignment changes from row
//     to row (at d = 421,642 f32 rows are 8-byte aligned: d is even but d / 2
//     is odd). Each row is read with the widest load its start allows (16,
//     8 or 4 bytes; element by element below that), a choice that is the
//     same for every thread of the row;
//   - a thread issues the loads of kRowBatch rows before their FMAs, so
//     that many row loads are in flight;
//   - fill is a device-side early exit: read from device memory when the
//     caller passes a device tensor, never copied to the host.
//
// segment_sum_dequant (B12) replaces pallas_kernels.py:1973
// _ragged_segment_sum_dequant_kernel (pallas_call at :2147): B11 over rows
// that arrive as wire codes (int8 codes, fp8 e4m3fn / e5m2 bit patterns, or
// packed s4 nibbles) with one f32 scale per `block` coordinates. The same
// chains: acc = __fmaf_rn(W[c, r], x_r, acc) over rows 0 .. fill-1 in index
// order from +0.0, with x_r = code * scale[r, col / block] rounded once
// (codec.cuh's decode, B14's and B17's), so the (R, d) f32 matrix never
// exists and the result is B11's on the decoded rows bit for bit. An
// optional per-row factor omega (the staleness discount) is applied as
// (code * scale) * omega_r, each product rounded once, before the FMA: the
// order of decoding, then scaling the rows, then contracting them. Output
// f32. Bound: memory, one read of the fill rows' codes (1 byte a value, s4
// half a byte) and scales, and a (C, d) f32 write. Design
// (segment_sum_dequant_kernel): B11's cohort tile and weight staging, the
// row factors staged beside the weights. A thread owns the V columns of one
// 32-bit word of codes (4 int8 / fp8 codes, 8 s4 nibbles), decodes the
// word once a row (codec.cuh's decode_word: no int-to-float conversion an
// int8 or s4 code, two fp8 codes a conversion) and applies the CT FMAs to
// each value. int8 / fp8 rows are d bytes wide, so their starts are only
// byte-aligned (2-byte at d = 421,642): the word is joined by a funnel
// shift from the two aligned words that hold it (the second is a
// neighbour's, an L1 hit, not another read of device memory). A thread's
// rows go in batches of U whose loads are all issued before their FMAs.
// Every thread takes this word path, a row's last too (its bytes past d
// are decoded and never stored), and one whose columns cross a scale
// block reads a second scale a row in an instantiation of its own: a
// kernel lasts as long as its slowest thread, and a thread walking its
// rows a column at a time, one load latency a row, made the whole kernel
// 2x slower. Only a block narrower than a word takes a per-column path.
//
// row_sq_dists: out[i] = sum_c (x[i, c] - z[c])^2 (z may be absent: the
// squared norms), in f32. It stands in for the plain XLA row reduce
// jnp.sum(diff * diff, axis=1) of the masked family (robust.py:1542,
// :1562, :1612, :1647). XLA reduces each row alone, so its bits do not
// depend on the number of rows; PyTorch's CUDA reduction picks its tree
// from the number of rows, which would break the padded == compacted
// contract. Here
// the order is fixed by d alone: lane l of a row (kLanes lanes) adds
// (x - z)^2 at columns l, l + kLanes, ... in order, each product and sum
// rounded once; then one warp per row adds its lanes' partials, lane j
// taking partials j, j + 32, ... in order, and a butterfly of
// __shfl_xor_sync adds the 32 lane sums. The plain version repeats these
// steps. Bound: memory, one read of x and z.

#include "codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4096;  // stage-1 lanes per row (ops/kernels.py: _ROW_LANES)
constexpr int kMaxTile = 16;  // cohorts a block accumulates
constexpr int kChunk = 128;   // rows of the weight tile staged at a time
constexpr int kRowBatch = 8;  // rows whose loads a B11 thread issues before their FMAs

// Smallest cohort tile in {1, 2, 4, 8, 16} that holds C; 16 above it.
inline int cohort_tile(int C) {
  int t = 1;
  while (t < C && t < kMaxTile) t *= 2;
  return t;
}

// The raw bits of an element of T, their f32 value, and the bits of an f32
// result rounded to T (with from_f32's canonical NaN).
template <typename T> struct Elem { using Bits = unsigned short; };
template <> struct Elem<float> { using Bits = unsigned int; };

template <typename T> __device__ __forceinline__ float bits_to_f32(unsigned int b);
template <> __device__ __forceinline__ float bits_to_f32<float>(unsigned int b) {
  return __uint_as_float(b);
}
template <> __device__ __forceinline__ float bits_to_f32<__nv_bfloat16>(unsigned int b) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)b));
}
template <> __device__ __forceinline__ float bits_to_f32<__half>(unsigned int b) {
  return __half2float(__ushort_as_half((unsigned short)b));
}

template <typename T> __device__ __forceinline__ unsigned int f32_to_bits(float v);
template <> __device__ __forceinline__ unsigned int f32_to_bits<float>(float v) {
  return __float_as_uint(from_f32<float>(v));
}
template <> __device__ __forceinline__ unsigned int f32_to_bits<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(from_f32<__nv_bfloat16>(v));
}
template <> __device__ __forceinline__ unsigned int f32_to_bits<__half>(float v) {
  return __half_as_ushort(from_f32<__half>(v));
}

// The raw bits of the V elements of a row at p, as NW 32-bit words, read
// with the widest loads p's alignment allows (16, 8 or 4 bytes; element by
// element below 4). n < V (a row's last thread): elements k < n only, the
// rest 0. No instruction here uses a loaded value, so the loads of a batch
// of rows are all in flight before the first one is unpacked.
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int n,
                                         unsigned int (&wd)[V * sizeof(T) / 4]) {
  using B = typename Elem<T>::Bits;
  constexpr int E = sizeof(T), VB = V * E, NW = VB / 4;
  static_assert(VB % 4 == 0, "a thread's columns fill whole 32-bit words");
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (n < V || (a & 3) != 0) {
    B e[V];
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = k < n ? __ldg(reinterpret_cast<const B*>(p) + k) : (B)0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if constexpr (E == 4) {
        wd[i] = e[i];
      } else {
        wd[i] = (unsigned int)e[2 * i] | ((unsigned int)e[2 * i + 1] << 16);
      }
    }
  } else if (VB % 16 == 0 && (a & 15) == 0) {
#pragma unroll
    for (int i = 0; i < VB / 16; ++i) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
      wd[4 * i] = q.x, wd[4 * i + 1] = q.y, wd[4 * i + 2] = q.z, wd[4 * i + 3] = q.w;
    }
  } else if (VB % 8 == 0 && (a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < VB / 8; ++i) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p) + i);
      wd[2 * i] = q.x, wd[2 * i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) wd[i] = __ldg(reinterpret_cast<const unsigned int*>(p) + i);
  }
}

// The f32 values of the V elements load_row read.
template <typename T, int V>
__device__ __forceinline__ void unpack_row(const unsigned int (&wd)[V * sizeof(T) / 4],
                                           float (&v)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if constexpr (sizeof(T) == 4) {
      v[k] = bits_to_f32<T>(wd[k]);
    } else {
      v[k] = bits_to_f32<T>((wd[k / 2] >> (16 * (k & 1))) & 0xFFFFu);
    }
  }
}

// The n <= V values v rounded to T and stored at p, with the widest stores
// p's alignment allows.
template <typename T, int V>
__device__ __forceinline__ void store_row(T* __restrict__ p, int n, const float (&v)[V]) {
  using B = typename Elem<T>::Bits;
  constexpr int E = sizeof(T), VB = V * E, NW = VB / 4;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (n < V || (a & 3) != 0) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k < n) reinterpret_cast<B*>(p)[k] = (B)f32_to_bits<T>(v[k]);
    return;
  }
  unsigned int wd[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if constexpr (E == 4) {
      wd[i] = f32_to_bits<T>(v[i]);
    } else {
      wd[i] = f32_to_bits<T>(v[2 * i]) | (f32_to_bits<T>(v[2 * i + 1]) << 16);
    }
  }
  if (VB % 16 == 0 && (a & 15) == 0) {
#pragma unroll
    for (int i = 0; i < VB / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] = make_uint4(wd[4 * i], wd[4 * i + 1], wd[4 * i + 2], wd[4 * i + 3]);
  } else if (VB % 8 == 0 && (a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < VB / 8; ++i) reinterpret_cast<uint2*>(p)[i] = make_uint2(wd[2 * i], wd[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) reinterpret_cast<unsigned int*>(p)[i] = wd[i];
  }
}

// The 32-bit word of code bytes at byte offset off of a row, which may sit
// off a word boundary by sh = off & 3 bytes: the aligned word that holds
// its first byte and, where the thread's bytes run past it (need_hi), the
// next one; neither reaches past the last byte the thread needs by a
// whole word. join_code_word makes the word of them where the codes are
// used, so that no load waits for another.
__device__ __forceinline__ void load_code_word(const uint8_t* __restrict__ base, long long off,
                                               unsigned int sh, bool need_hi, unsigned int& lo,
                                               unsigned int& hi) {
  const unsigned int* q = reinterpret_cast<const unsigned int*>(base + (off - sh));
  lo = __ldg(q);
  hi = need_hi ? __ldg(q + 1) : 0u;
}

__device__ __forceinline__ unsigned int join_code_word(unsigned int lo, unsigned int hi,
                                                       unsigned int sh) {
  return __funnelshift_r(lo, hi, 8 * sh);
}

__device__ __forceinline__ int row_fill(const int* __restrict__ fill_dev, int fill_host, int R) {
  const int fill = fill_dev != nullptr ? __ldg(fill_dev) : fill_host;
  return fill < 0 ? 0 : (fill > R ? R : fill);
}

// Rows r0 .. r0 + n - 1 of cohorts c0 .. c0 + CT - 1 of w (C, R) into
// ws[r * CT + c]; 0 for the cohorts past C (their sums are never stored).
template <int CT>
__device__ __forceinline__ void stage_weights(float* ws, const float* __restrict__ w, int C, int R,
                                              int c0, int r0, int n) {
  for (int i = threadIdx.x; i < CT * n; i += kThreads) {
    const int c = i / n, r = i - c * n;
    ws[r * CT + c] = c0 + c < C ? __ldg(w + (long long)(c0 + c) * R + r0 + r) : 0.0f;
  }
}

// acc[c][k] = fma(w[c], v[k], acc[c][k]) for the CT cohorts of one row, its
// weights read from shared memory in one vector read.
template <int CT, int V>
__device__ __forceinline__ void fma_row(const float* ws, const float (&v)[V], float (&acc)[CT][V]) {
  float wv[CT];
  if constexpr (CT == 1) {
    wv[0] = ws[0];
  } else if constexpr (CT == 2) {
    const float2 q = *reinterpret_cast<const float2*>(ws);
    wv[0] = q.x, wv[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < CT / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(ws)[i];
      wv[4 * i] = q.x, wv[4 * i + 1] = q.y, wv[4 * i + 2] = q.z, wv[4 * i + 3] = q.w;
    }
  }
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[c][k] = __fmaf_rn(wv[c], v[k], acc[c][k]);
}

// B11's columns a thread: 16 bytes of a row (4 f32, 8 bf16 / f16) while
// the accumulators are few (f32 up to 2 cohorts, 16-bit up to 4), 8 bytes
// above that; on the H100 the wider strip ran C = 1 and 2 faster, the
// narrower one C = 4 in f32 (twice the threads to hide the loads).
template <typename T, int CT>
__host__ __device__ constexpr int b11_columns() {
  return (CT <= 2 || (sizeof(T) == 2 && CT <= 4) ? 16 : 8) / (int)sizeof(T);
}

template <typename T, int CT>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ fill_dev, int fill_host, T* __restrict__ out,
                   int C, int R, long long d) {
  constexpr int V = b11_columns<T, CT>(), NW = V * sizeof(T) / 4;
  __shared__ __align__(16) float ws[kChunk * CT];
  const long long col = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  const int c0 = blockIdx.y * CT;
  const int nv = col < d ? (int)min((long long)V, d - col) : 0;
  const int fill = row_fill(fill_dev, fill_host, R);
  float acc[CT][V];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[c][k] = 0.0f;
  for (int r0 = 0; r0 < fill; r0 += kChunk) {
    const int n = min(kChunk, fill - r0);
    __syncthreads();
    stage_weights<CT>(ws, w, C, R, c0, r0, n);
    __syncthreads();
    if (nv == 0) continue;
    const T* xr = x + (long long)r0 * d + col;
    int r = 0;
    for (; r + kRowBatch <= n; r += kRowBatch) {
      unsigned int wd[kRowBatch][NW];
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) load_row<T, V>(xr + (long long)(r + u) * d, nv, wd[u]);
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) {
        float v[V];
        unpack_row<T, V>(wd[u], v);
        fma_row<CT, V>(ws + (r + u) * CT, v, acc);
      }
    }
    for (; r < n; ++r) {
      unsigned int wd[NW];
      float v[V];
      load_row<T, V>(xr + (long long)r * d, nv, wd);
      unpack_row<T, V>(wd, v);
      fma_row<CT, V>(ws + r * CT, v, acc);
    }
  }
  if (nv == 0) return;
#pragma unroll
  for (int c = 0; c < CT; ++c)
    if (c0 + c < C) store_row<T, V>(out + (long long)(c0 + c) * d + col, nv, acc[c]);
}

// The scaled and discounted value of code q under scale sc and row factor
// om (1.0 without omega: v * 1.0 is v, -0.0 and inf included, and a NaN
// stays a NaN that the output canonicalizes, so the bits are the plain
// version's either way).
__device__ __forceinline__ float scale_code(float q, float sc, float om) {
  return __fmul_rn(__fmul_rn(q, sc), om);
}

// Row row's code word at a thread's V columns, decoded, scaled (columns k
// < split by sa, the rest by sz), discounted by om, then the CT FMAs.
template <int CODE, int CT, int V>
__device__ __forceinline__ void sum_word_row(unsigned int lo, unsigned int hi, unsigned int sh,
                                             float sa, float sz, int split, float om,
                                             const float* ws, float (&acc)[CT][V]) {
  float v[V];
  decode_word<CODE>(join_code_word(lo, hi, sh), v);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = scale_code(v[k], k < split ? sa : sz, om);
  fma_row<CT, V>(ws, v, acc);
}

// Rows r0 .. r0 + n - 1 by words, in batches of U rows whose loads are all
// issued before their FMAs. TWO: the thread's columns cross a scale block
// boundary, so each row reads a second scale; a separate instantiation, so
// that the threads that do not (all of them where V divides the block)
// carry one scale load a row.
template <int CODE, int CT, int V, int U, bool TWO>
__device__ __forceinline__ void sum_rows_by_word(const uint8_t* __restrict__ codes,
                                                 const float* __restrict__ scales, int nb,
                                                 long long ncodes, long long byte0, int sb,
                                                 int split, int nbytes, unsigned int sh0,
                                                 unsigned int shr, int r0, int n, bool has_omega,
                                                 const float* os, const float* ws,
                                                 float (&acc)[CT][V]) {
  int r = 0;
  for (; r + U <= n; r += U) {
    unsigned int lo[U], hi[U];
    float sa[U], sz[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = r0 + r + u;
      const unsigned int sh = (sh0 + row * shr) & 3;
      load_code_word(codes, row * ncodes + byte0, sh, sh + nbytes > 4, lo[u], hi[u]);
      const float* sr = scales + (long long)row * nb + sb;
      sa[u] = __ldg(sr);
      sz[u] = TWO ? __ldg(sr + 1) : sa[u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      sum_word_row<CODE, CT, V>(lo[u], hi[u], (sh0 + (r0 + r + u) * shr) & 3, sa[u], sz[u],
                                TWO ? split : V, has_omega ? os[r + u] : 1.0f, ws + (r + u) * CT,
                                acc);
  }
  for (; r < n; ++r) {
    const int row = r0 + r;
    const unsigned int sh = (sh0 + row * shr) & 3;
    unsigned int lo, hi;
    load_code_word(codes, row * ncodes + byte0, sh, sh + nbytes > 4, lo, hi);
    const float* sr = scales + (long long)row * nb + sb;
    const float sa = __ldg(sr);
    sum_word_row<CODE, CT, V>(lo, hi, sh, sa, TWO ? __ldg(sr + 1) : sa, TWO ? split : V,
                              has_omega ? os[r] : 1.0f, ws + r * CT, acc);
  }
}

template <int CODE, int CT>
__global__ void __launch_bounds__(kThreads)
segment_sum_dequant_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ scales,
                           const float* __restrict__ w, const float* __restrict__ omega,
                           const int* __restrict__ fill_dev, int fill_host,
                           float* __restrict__ out, int C, int R, long long d, long long ncodes,
                           int nb, int block) {
  constexpr int V = CODE == kS4 ? 8 : 4;  // the columns of one 32-bit word of codes
  constexpr int U = 8;                    // rows a batch of sum_rows_by_word
  __shared__ __align__(16) float ws[kChunk * CT];
  __shared__ float os[kChunk];
  const long long col = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  const int c0 = blockIdx.y * CT;
  const int nv = col < d ? (int)min((long long)V, d - col) : 0;
  const int fill = row_fill(fill_dev, fill_host, R);
  const bool has_omega = omega != nullptr;
  // column col + k's scale is scales[r, sb + (sm + k) / block]. With block
  // >= V a thread's columns lie in at most two scale blocks: sb for k <
  // split, sb + 1 from there (two: a column < d is in sb + 1). Every thread
  // then reads its word, the row's last one too (its bytes past d are
  // decoded and never stored), so no thread walks its rows a column at a
  // time: a kernel lasts as long as its slowest thread. A narrower block
  // takes the per-column path.
  const int sb = (int)(col / block), sm = (int)(col % block);
  const bool by_word = block >= V;
  const int split = block - sm;
  const bool two = split < nv;
  const long long byte0 = CODE == kS4 ? col / 2 : col;
  const int nbytes = CODE == kS4 ? (nv + 1) / 2 : nv;
  // row r's word sits off a word boundary by (sh0 + r * shr) & 3 bytes
  const unsigned int sh0 = (unsigned int)(reinterpret_cast<uintptr_t>(codes + byte0) & 3);
  const unsigned int shr = (unsigned int)(ncodes & 3);
  float acc[CT][V];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[c][k] = 0.0f;
  for (int r0 = 0; r0 < fill; r0 += kChunk) {
    const int n = min(kChunk, fill - r0);
    __syncthreads();
    stage_weights<CT>(ws, w, C, R, c0, r0, n);
    if (has_omega)
      for (int i = threadIdx.x; i < n; i += kThreads) os[i] = __ldg(omega + r0 + i);
    __syncthreads();
    if (nv == 0) continue;
    if (by_word) {
      if (two)
        sum_rows_by_word<CODE, CT, V, U, true>(codes, scales, nb, ncodes, byte0, sb, split, nbytes,
                                               sh0, shr, r0, n, has_omega, os, ws, acc);
      else
        sum_rows_by_word<CODE, CT, V, U, false>(codes, scales, nb, ncodes, byte0, sb, split, nbytes,
                                                sh0, shr, r0, n, has_omega, os, ws, acc);
    } else {
      for (int r = 0; r < n; ++r) {
        const long long row = r0 + r;
        const uint8_t* cr = codes + row * ncodes;
        const float* sr = scales + row * nb;
        const float om = has_omega ? os[r] : 1.0f;
        float v[V];
#pragma unroll
        for (int k = 0; k < V; ++k)
          v[k] = k < nv ? scale_code(wire_code<CODE>(cr, col + k), __ldg(sr + sb + (sm + k) / block), om)
                        : 0.0f;
        fma_row<CT, V>(ws + r * CT, v, acc);
      }
    }
  }
  if (nv == 0) return;
#pragma unroll
  for (int c = 0; c < CT; ++c)
    if (c0 + c < C) store_row<float, V>(out + (long long)(c0 + c) * d + col, nv, acc[c]);
}

template <int CODE, int CT>
cudaError_t launch_segment_sum_dequant_tile(const uint8_t* codes, const float* scales,
                                            const float* w, const float* omega,
                                            const int* fill_dev, int fill_host, float* out, int C,
                                            int R, long long d, long long ncodes, int nb,
                                            int block, cudaStream_t s) {
  constexpr int V = CODE == kS4 ? 8 : 4;
  const long long threads = (d + V - 1) / V;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), (unsigned)((C + CT - 1) / CT));
  segment_sum_dequant_kernel<CODE, CT><<<grid, kThreads, 0, s>>>(
      codes, scales, w, omega, fill_dev, fill_host, out, C, R, d, ncodes, nb, block);
  return cudaGetLastError();
}

template <int CODE>
cudaError_t launch_segment_sum_dequant(const void* codes, const float* scales, const float* w,
                                       const float* omega, const int* fill_dev, int fill_host,
                                       float* out, int C, int R, long long d, long long ncodes,
                                       int nb, int block, cudaStream_t s) {
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
#define BYZ_DEQUANT_TILE(CT)                                                                  \
  launch_segment_sum_dequant_tile<CODE, CT>(cp, scales, w, omega, fill_dev, fill_host, out, C, \
                                            R, d, ncodes, nb, block, s)
  switch (cohort_tile(C)) {
    case 1: return BYZ_DEQUANT_TILE(1);
    case 2: return BYZ_DEQUANT_TILE(2);
    case 4: return BYZ_DEQUANT_TILE(4);
    case 8: return BYZ_DEQUANT_TILE(8);
    default: return BYZ_DEQUANT_TILE(16);
  }
#undef BYZ_DEQUANT_TILE
}

template <typename T, bool HasZ>
__global__ void __launch_bounds__(kThreads)
row_sq_partial_kernel(const T* __restrict__ x, const T* __restrict__ z,
                      float* __restrict__ partial, long long d) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const int i = blockIdx.y;
  const T* xi = x + (long long)i * d;
  float acc = 0.0f;
#pragma unroll 4
  for (long long c = lane; c < d; c += kLanes) {
    float v = to_f32(xi[c]);
    if constexpr (HasZ) v = __fsub_rn(v, to_f32(z[c]));
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  partial[(long long)i * kLanes + lane] = acc;
}

// One warp per row.
__global__ void __launch_bounds__(kThreads)
row_sq_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int n) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* p = partial + (long long)row * kLanes;
  float s = 0.0f;
  for (int k = lane; k < kLanes; k += 32) s = __fadd_rn(s, p[k]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  if (lane == 0) out[row] = from_f32<float>(s);
}

template <typename T, int CT>
cudaError_t launch_segment_sum_tile(const void* x, const float* w, const int* fill_dev,
                                    int fill_host, void* out, int C, int R, long long d,
                                    cudaStream_t s) {
  constexpr int V = b11_columns<T, CT>();
  const long long threads = (d + V - 1) / V;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), (unsigned)((C + CT - 1) / CT));
  segment_sum_kernel<T, CT><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), w, fill_dev, fill_host, static_cast<T*>(out), C, R, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_segment_sum(const void* x, const float* w, const int* fill_dev, int fill_host,
                               void* out, int C, int R, long long d, cudaStream_t s) {
  switch (cohort_tile(C)) {
    case 1: return launch_segment_sum_tile<T, 1>(x, w, fill_dev, fill_host, out, C, R, d, s);
    case 2: return launch_segment_sum_tile<T, 2>(x, w, fill_dev, fill_host, out, C, R, d, s);
    case 4: return launch_segment_sum_tile<T, 4>(x, w, fill_dev, fill_host, out, C, R, d, s);
    case 8: return launch_segment_sum_tile<T, 8>(x, w, fill_dev, fill_host, out, C, R, d, s);
    default: return launch_segment_sum_tile<T, 16>(x, w, fill_dev, fill_host, out, C, R, d, s);
  }
}

template <typename T>
cudaError_t launch_row_sq(const void* x, const void* z, float* partial, float* out, int n,
                          long long d, cudaStream_t s) {
  const dim3 grid(kLanes / kThreads, (unsigned)n);
  const T* xp = static_cast<const T*>(x);
  const T* zp = static_cast<const T*>(z);
  if (zp != nullptr)
    row_sq_partial_kernel<T, true><<<grid, kThreads, 0, s>>>(xp, zp, partial, d);
  else
    row_sq_partial_kernel<T, false><<<grid, kThreads, 0, s>>>(xp, zp, partial, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((n * 32 + kThreads - 1) / kThreads);
  row_sq_reduce_kernel<<<blocks, kThreads, 0, s>>>(partial, out, n);
  return cudaGetLastError();
}

}  // namespace

// x: (R, d) contiguous; w: (C, R) f32; out: (C, d) of x's dtype. fill_dev:
// a device int32 holding the fill, or null to take fill_host. Returns the
// launch's cudaError_t.
extern "C" int byz_segment_sum(const void* x, const float* w, const int* fill_dev, int fill_host,
                               void* out, int C, int R, long long d, int dtype, void* stream) {
  if (C < 1 || C > 65535 || R < 0) return cudaErrorInvalidValue;
  if (d <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_segment_sum<float>(x, w, fill_dev, fill_host, out, C, R, d, s);
    case kBF16: return launch_segment_sum<__nv_bfloat16>(x, w, fill_dev, fill_host, out, C, R, d, s);
    case kF16: return launch_segment_sum<__half>(x, w, fill_dev, fill_host, out, C, R, d, s);
    default: return cudaErrorInvalidValue;
  }
}

// x: (n, d) contiguous; z: (d,) of x's dtype, or null; partial: n * 4096 f32
// scratch; out: n f32. Returns the launches' cudaError_t.
extern "C" int byz_row_sq_dists(const void* x, const void* z, float* partial, float* out, int n,
                                long long d, int dtype, void* stream) {
  if (n < 1 || n > 65535 || d < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_row_sq<float>(x, z, partial, out, n, d, s);
    case kBF16: return launch_row_sq<__nv_bfloat16>(x, z, partial, out, n, d, s);
    case kF16: return launch_row_sq<__half>(x, z, partial, out, n, d, s);
    default: return cudaErrorInvalidValue;
  }
}

// B12. codes: (R, ncodes) bytes (int8 codes or fp8 bit patterns, ncodes >= d;
// packed s4 nibbles, 2 * ncodes >= d; code 0 = int8, 1 = e4m3fn, 2 = e5m2,
// 3 = s4); scales: (R, nb) f32, nb * block >= d; w: (C, R) f32; omega: (R,)
// f32 or null; fill as in byz_segment_sum; out: (C, d) f32. Returns the
// launch's cudaError_t.
extern "C" int byz_segment_sum_dequant(const void* codes, const float* scales, const float* w,
                                       const float* omega, const int* fill_dev, int fill_host,
                                       void* out, int C, int R, long long d, long long ncodes,
                                       int nb, int block, int code, void* stream) {
  if (C < 1 || C > 65535 || R < 0 || block <= 0) return cudaErrorInvalidValue;
  if (d <= 0) return cudaSuccess;
  if ((long long)nb * block < d || (code == kS4 ? 2 * ncodes : ncodes) < d)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(out);
  switch (code) {
    case kInt8: return launch_segment_sum_dequant<kInt8>(codes, scales, w, omega, fill_dev, fill_host, op, C, R, d, ncodes, nb, block, s);
    case kE4M3: return launch_segment_sum_dequant<kE4M3>(codes, scales, w, omega, fill_dev, fill_host, op, C, R, d, ncodes, nb, block, s);
    case kE5M2: return launch_segment_sum_dequant<kE5M2>(codes, scales, w, omega, fill_dev, fill_host, op, C, R, d, ncodes, nb, block, s);
    case kS4: return launch_segment_sum_dequant<kS4>(codes, scales, w, omega, fill_dev, fill_host, op, C, R, d, ncodes, nb, block, s);
    default: return cudaErrorInvalidValue;
  }
}
