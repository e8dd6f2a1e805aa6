// B11: the row-ordered segment sum out[c] = sum_r W[c, r] x[r], its twin
// over wire codes B12, and the masked family's per-row reduction
// sum_c (x[i, c] - z[c])^2 beside them.
//
// segment_sum replaces byzpy_tpu/ops/pallas_kernels.py:1840
// _ragged_segment_sum_kernel (pallas_call at :1964): x (R, d) in f32, bf16
// or f16, W (C, R) f32, out (C, d) in x's dtype, accumulated in f32; rows
// at or past the batch's fill are not read. The TPU kernel adds each row
// tile's W^T x into one output block over a sequential grid. Here the
// contract is the order: the masked aggregators of byzpy_tpu/ops/robust.py
// (:1344-1656) rest their padded == compacted bit identity on XLA:CPU's
// row einsum, which is one fused multiply-add chain over the rows in index
// order from +0.0 (appended zero rows keep every partial sum). So one
// thread owns one (cohort, column) output and walks rows 0 .. fill-1 with
// acc = __fmaf_rn(W[c, r], x[r, col], acc): no split over rows, no atomics,
// no reduction tree. __fmaf_rn says which rounding is meant (nvcc would
// contract a * b + c on its own; the plain version reproduces the single
// rounding).
//
// Bound: memory. One read of the fill rows of x and a (C, d) write; one FMA
// per 4 bytes (f32) is far under the card's f32 rate. Design: a block of
// 256 neighbouring columns, so every row load is one coalesced 1 KB (f32)
// transaction; W[c, r] is the same for every thread of the block and comes
// through the read-only cache; the loop is unrolled 8 deep so that eight
// row loads are in flight per thread. fill is a device-side early exit:
// read from device memory when the caller passes a device tensor, never
// copied to the host.
//
// segment_sum_dequant (B12) replaces pallas_kernels.py:1973
// _ragged_segment_sum_dequant_kernel (pallas_call at :2147): B11 over rows
// that arrive as wire codes (int8 codes, fp8 e4m3fn / e5m2 bit patterns, or
// packed s4 nibbles) with one f32 scale per `block` coordinates. The same
// thread-per-output chain: acc = __fmaf_rn(W[c, r], x_r, acc) over rows
// 0 .. fill-1 in index order from +0.0, with x_r = code * scale[r, col /
// block] rounded once (codec.cuh's decode, B14's and B17's), so the (R, d)
// f32 matrix never exists and the result is B11's on the decoded rows bit
// for bit. An optional per-row factor omega (the staleness discount) is
// applied as (code * scale) * omega_r, each product rounded once, before
// the FMA: the order of decoding, then scaling the rows, then contracting
// them. Output f32. Bound: memory, one read of the fill rows' codes (1 byte
// a value, s4 half a byte) and scales, and a (C, d) f32 write.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ fill_dev, int fill_host, T* __restrict__ out,
                   int R, long long d) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y;
  if (col >= d) return;
  int fill = fill_dev != nullptr ? __ldg(fill_dev) : fill_host;
  fill = fill < 0 ? 0 : (fill > R ? R : fill);
  const float* wc = w + (long long)c * R;
  const T* xc = x + col;
  float acc = 0.0f;
#pragma unroll 8
  for (int r = 0; r < fill; ++r) acc = __fmaf_rn(__ldg(wc + r), to_f32(xc[(long long)r * d]), acc);
  out[(long long)c * d + col] = from_f32<T>(acc);
}

template <int CODE, bool HasOmega>
__global__ void __launch_bounds__(kThreads)
segment_sum_dequant_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ scales,
                           const float* __restrict__ w, const float* __restrict__ omega,
                           const int* __restrict__ fill_dev, int fill_host,
                           float* __restrict__ out, int R, long long d, long long ncodes,
                           int nb, int block) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y;
  if (col >= d) return;
  int fill = fill_dev != nullptr ? __ldg(fill_dev) : fill_host;
  fill = fill < 0 ? 0 : (fill > R ? R : fill);
  const float* wc = w + (long long)c * R;
  const float* sc = scales + col / block;
  float acc = 0.0f;
#pragma unroll 4
  for (int r = 0; r < fill; ++r) {
    float v = __fmul_rn(wire_code<CODE>(codes + (long long)r * ncodes, col),
                        __ldg(sc + (long long)r * nb));
    if constexpr (HasOmega) v = __fmul_rn(v, __ldg(omega + r));
    acc = __fmaf_rn(__ldg(wc + r), v, acc);
  }
  out[(long long)c * d + col] = from_f32<float>(acc);
}

template <int CODE>
cudaError_t launch_segment_sum_dequant(const void* codes, const float* scales, const float* w,
                                       const float* omega, const int* fill_dev, int fill_host,
                                       float* out, int C, int R, long long d, long long ncodes,
                                       int nb, int block, cudaStream_t s) {
  const dim3 grid((unsigned)((d + kThreads - 1) / kThreads), (unsigned)C);
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
  if (omega != nullptr)
    segment_sum_dequant_kernel<CODE, true><<<grid, kThreads, 0, s>>>(
        cp, scales, w, omega, fill_dev, fill_host, out, R, d, ncodes, nb, block);
  else
    segment_sum_dequant_kernel<CODE, false><<<grid, kThreads, 0, s>>>(
        cp, scales, w, omega, fill_dev, fill_host, out, R, d, ncodes, nb, block);
  return cudaGetLastError();
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

template <typename T>
cudaError_t launch_segment_sum(const void* x, const float* w, const int* fill_dev, int fill_host,
                               void* out, int C, int R, long long d, cudaStream_t s) {
  const dim3 grid((unsigned)((d + kThreads - 1) / kThreads), (unsigned)C);
  segment_sum_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), w, fill_dev,
                                                  fill_host, static_cast<T*>(out), R, d);
  return cudaGetLastError();
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
