// Shared device helpers for the port's kernels: dtype conversion, the
// int32 total-order sort key of byzpy_tpu/ops/pallas_kernels.py:130-141
// (_float_sort_keys / _keys_to_float), Batcher's merge-exchange network
// (pallas_kernels.py:106 batcher_pairs) unrolled into registers, and the
// cp.async row copy that stages tiles in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

// dtype codes shared with byzpy_tpu_torch/ops/kernels.py (_DTYPE_CODES)
enum DTypeCode { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
// Every NaN leaves a kernel as the positive quiet NaN (0x7FC00000 f32,
// 0x7FC0 bf16, 0x7E00 f16): the value jnp.nan has and the plain versions
// write, where the card's arithmetic and its conversion intrinsics would
// give 0x7FFFFFFF / 0x7FFF.
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return isnan(v) ? __int_as_float(0x7FC00000) : v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return isnan(v) ? __ushort_as_bfloat16((unsigned short)0x7FC0) : __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return isnan(v) ? __ushort_as_half((unsigned short)0x7E00) : __float2half_rn(v);
}

// Sort key above every real key, canonical NaN included: padding rows.
#define PAD_KEY INT32_MAX
// Key of +inf; a key above it is a NaN.
#define INF_KEY 0x7F800000

// Canonicalize NaN to the quiet +NaN, bitcast, flip the magnitude bits of
// negatives: -inf < finite < +inf < NaN, -0.0 before +0.0.
__device__ __forceinline__ int32_t float_sort_key(float v) {
  int32_t k = isnan(v) ? 0x7FC00000 : __float_as_int(v);
  return k < 0 ? (k ^ 0x7FFFFFFF) : k;
}

__device__ __forceinline__ float key_to_float(int32_t k) {
  return __int_as_float(k < 0 ? (k ^ 0x7FFFFFFF) : k);
}

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

// One compare-exchange of Batcher's network, keys I and I + D, if row I is
// in this pass (I & P == R). Every index is a template argument, so the
// whole network is straight-line code on registers.
template <int N, int P, int D, int R, int I>
__device__ __forceinline__ void batcher_cx(int32_t (&k)[N]) {
  if constexpr (I + D < N && (I & P) == R) {
    const int32_t a = k[I], b = k[I + D];
    k[I] = min(a, b);
    k[I + D] = max(a, b);
  }
}

template <int N, int P, int D, int R, int... I>
__device__ __forceinline__ void batcher_pass(int32_t (&k)[N], std::integer_sequence<int, I...>) {
  (batcher_cx<N, P, D, R, I>(k), ...);
}

// The passes with d = 2^LQ - p, r = p, for LQ = log2(N) - 1 down to LP + 1.
template <int N, int LP, int LQ>
__device__ __forceinline__ void batcher_q_passes(int32_t (&k)[N]) {
  if constexpr (LQ > LP) {
    batcher_pass<N, (1 << LP), (1 << LQ) - (1 << LP), (1 << LP)>(
        k, std::make_integer_sequence<int, N>{});
    batcher_q_passes<N, LP, LQ - 1>(k);
  }
}

template <int N, int LP>
__device__ __forceinline__ void batcher_p_passes(int32_t (&k)[N]) {
  if constexpr (LP >= 0) {
    batcher_pass<N, (1 << LP), (1 << LP), 0>(k, std::make_integer_sequence<int, N>{});
    batcher_q_passes<N, LP, ilog2(N) - 1>(k);
    batcher_p_passes<N, LP - 1>(k);
  }
}

// Sort N int32 keys ascending in registers with Batcher's merge-exchange
// network. N is a power of two, so batcher_pairs(N) is: for p = N/2 .. 1,
// one pass with d = p, r = 0, then passes with d = q - p, r = p for
// q = N/2 .. 2p. The network is expanded at compile time (no loops), so
// the keys never leave registers.
template <int N>
__device__ __forceinline__ void batcher_sort(int32_t (&k)[N]) {
  static_assert((N & (N - 1)) == 0 && N >= 2, "N must be a power of two");
  batcher_p_passes<N, ilog2(N) - 1>(k);
}

// k[idx] for a run-time idx without dynamic register indexing (which would
// move the array to local memory).
template <int N>
__device__ __forceinline__ int32_t select_key(const int32_t (&k)[N], int idx) {
  int32_t out = k[0];
#pragma unroll
  for (int i = 1; i < N; ++i) out = (i == idx) ? k[i] : out;
  return out;
}

// cp.async copies from global to shared memory (sm_80 and later), and the
// row copy B8's sweep and the segmented sort-reduce stage their tiles with.
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(W),
                 "r"(src_bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One row's valid bytes of a tile into shared memory, in W-byte pieces by
// the lanes of one warp; the last piece zero-fills past the row's end.
template <int W>
__device__ __forceinline__ void copy_row(char* dst, const char* src, int bytes, int lane) {
  for (int p = lane * W; p < bytes; p += 32 * W) cp_async<W>(dst + p, src + p, min(W, bytes - p));
}

// Shared memory addresses, named barriers (ids 1..; 0 is __syncthreads),
// mbarriers and bulk copies (sm_90): the producer-consumer rings of the
// column sort engine (column_sort.cuh) and of B7's masked modes.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned a, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned a, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned a) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(a) : "memory");
}

// An arrival on the mbarrier once this thread's earlier cp.async copies
// have landed (the mbarrier's count includes it).
__device__ __forceinline__ void cp_async_mbar_arrive(unsigned a) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(a) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned a, unsigned parity) {
  unsigned ok;
  asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               " selp.u32 %0, 1, 0, p;\n}\n" : "=r"(ok) : "r"(a), "r"(parity) : "memory");
  return ok != 0;
}

// `bytes` (a multiple of 16) from global src (16-byte aligned) to shared
// dst, completing on the mbarrier at mbar.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes, unsigned mbar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(mbar) : "memory");
}

// Smallest network width in {8, ..., 128} that holds n rows; 0 if none.
inline int network_width(int n) {
  for (int w = 8; w <= 128; w *= 2)
    if (n <= w) return w;
  return 0;
}
