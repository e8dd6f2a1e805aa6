// B13, B14, B15: the blockwise codecs of the compressed wire fabric.
//
// B13 replaces byzpy_tpu/parallel/quantization.py:256 _quantize_kernel
// (pallas_call at :299): blockwise symmetric int8. B15 replaces :479
// _quantize_fp8_kernel (pallas_call at :550): blockwise-scaled fp8 e4m3fn /
// e5m2, emitted as bit patterns. B14 replaces :279 _dequantize_kernel
// (pallas_call at :335): codes (int8, or fp8 bit patterns) times the block
// scale, written in the requested dtype.
//
// What the encoders compute, per (row, block of `block` trailing values):
// absmax of the finite values (the padding of a partial last block adds
// nothing), scale = absmax > 0 ? absmax * (1/qmax) : 1, y = x * (1/scale),
// then NaN -> 0 and y clipped to +-qmax (int8: rint first, round half to
// even; fp8: one direct round-to-nearest-even cast, __NV_SATFINITE). Every
// step is one IEEE operation in f32, so the codes and scales are the plain
// versions' bit for bit; 1/scale must stay an IEEE division, so this file
// must never be built with --use_fast_math.
//
// Bound: device-memory bytes. An encode reads each input value once and
// writes one byte of code and 4/block bytes of scale per value; a decode is
// the reverse. Design: one warp per (row, block), lanes striding the block
// (coalesced loads). The encoders take absmax by __shfl_xor_sync, lane 0
// writes the scale, and a second pass over the block (from L1) writes the
// codes; the decoder reads its block's scale once and unrolls the stride
// loop, so each lane has several code loads in flight and no per-value
// division finds the scale.

#include <cuda_fp8.h>

#include "common.cuh"

namespace {

constexpr int kWarpsPerCta = 8;

// code modes shared with byzpy_tpu_torch/ops/codec_kernels.py (_CODES)
enum CodeMode { kInt8 = 0, kE4M3 = 1, kE5M2 = 2 };

template <int MODE> struct Code;
template <> struct Code<kInt8> {
  static constexpr float qmax = 127.0f;
  static __device__ __forceinline__ uint8_t encode(float y) {
    if (isnan(y)) return 0;
    const float q = fminf(fmaxf(rintf(y), -qmax), qmax);
    return (uint8_t)(int8_t)(int)q;
  }
};
template <> struct Code<kE4M3> {
  static constexpr float qmax = 448.0f;
  static __device__ __forceinline__ uint8_t encode(float y) {
    const float c = isnan(y) ? 0.0f : fminf(fmaxf(y, -qmax), qmax);
    return (uint8_t)__nv_cvt_float_to_fp8(c, __NV_SATFINITE, __NV_E4M3);
  }
};
template <> struct Code<kE5M2> {
  static constexpr float qmax = 57344.0f;
  static __device__ __forceinline__ uint8_t encode(float y) {
    const float c = isnan(y) ? 0.0f : fminf(fmaxf(y, -qmax), qmax);
    return (uint8_t)__nv_cvt_float_to_fp8(c, __NV_SATFINITE, __NV_E5M2);
  }
};

template <typename T, int MODE>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
quantize_kernel(const T* __restrict__ x, uint8_t* __restrict__ codes,
                float* __restrict__ scales, long long rows, long long d,
                int block, int nb) {
  const long long warp = (long long)blockIdx.x * kWarpsPerCta + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= rows * nb) return;
  const long long row = warp / nb;
  const int blk = (int)(warp % nb);
  const long long c0 = (long long)blk * block;
  const long long rem = d - c0;
  const int len = rem < block ? (int)rem : block;
  const T* xb = x + row * d + c0;
  float amax = 0.0f;
  for (int i = lane; i < len; i += 32) {
    const float v = to_f32(xb[i]);
    amax = fmaxf(amax, isfinite(v) ? fabsf(v) : 0.0f);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, off));
  const float scale = amax > 0.0f ? __fmul_rn(amax, 1.0f / Code<MODE>::qmax) : 1.0f;
  if (lane == 0) scales[row * nb + blk] = scale;
  const float inv = __fdiv_rn(1.0f, scale);
  uint8_t* cb = codes + row * d + c0;
  for (int i = lane; i < len; i += 32)
    cb[i] = Code<MODE>::encode(__fmul_rn(to_f32(xb[i]), inv));
}

template <int CODE> __device__ __forceinline__ float decode_code(uint8_t c);
template <> __device__ __forceinline__ float decode_code<kInt8>(uint8_t c) {
  return (float)(int8_t)c;
}
template <> __device__ __forceinline__ float decode_code<kE4M3>(uint8_t c) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(c, __NV_E4M3)));
}
template <> __device__ __forceinline__ float decode_code<kE5M2>(uint8_t c) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(c, __NV_E5M2)));
}

template <typename T, int CODE>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
dequantize_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ scales,
                  T* __restrict__ out, long long rows, long long d, int block, int nb,
                  long long scale_stride) {
  const long long warp = (long long)blockIdx.x * kWarpsPerCta + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= rows * nb) return;
  const long long row = warp / nb;
  const int blk = (int)(warp % nb);
  const long long c0 = (long long)blk * block;
  const long long rem = d - c0;
  const int len = rem < block ? (int)rem : block;
  const float scale = scales[row * scale_stride + blk];
  const uint8_t* cb = codes + row * d + c0;
  T* ob = out + row * d + c0;
#pragma unroll 8
  for (int i = lane; i < len; i += 32)
    ob[i] = from_f32<T>(__fmul_rn(decode_code<CODE>(cb[i]), scale));
}

template <typename T>
cudaError_t launch_quantize(const void* x, void* codes, float* scales, long long rows,
                            long long d, int block, int nb, int mode, cudaStream_t s) {
  const long long warps = rows * nb;
  const dim3 grid((unsigned)((warps + kWarpsPerCta - 1) / kWarpsPerCta));
  const T* xp = static_cast<const T*>(x);
  uint8_t* cp = static_cast<uint8_t*>(codes);
  switch (mode) {
    case kInt8: quantize_kernel<T, kInt8><<<grid, kWarpsPerCta * 32, 0, s>>>(xp, cp, scales, rows, d, block, nb); break;
    case kE4M3: quantize_kernel<T, kE4M3><<<grid, kWarpsPerCta * 32, 0, s>>>(xp, cp, scales, rows, d, block, nb); break;
    case kE5M2: quantize_kernel<T, kE5M2><<<grid, kWarpsPerCta * 32, 0, s>>>(xp, cp, scales, rows, d, block, nb); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dequantize(const void* codes, const float* scales, void* out,
                              long long rows, long long d, int block,
                              long long scale_stride, int code, cudaStream_t s) {
  const int nb = (int)((d + block - 1) / block);
  const long long warps = rows * nb;
  const dim3 grid((unsigned)((warps + kWarpsPerCta - 1) / kWarpsPerCta));
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
  T* op = static_cast<T*>(out);
  switch (code) {
    case kInt8: dequantize_kernel<T, kInt8><<<grid, kWarpsPerCta * 32, 0, s>>>(cp, scales, op, rows, d, block, nb, scale_stride); break;
    case kE4M3: dequantize_kernel<T, kE4M3><<<grid, kWarpsPerCta * 32, 0, s>>>(cp, scales, op, rows, d, block, nb, scale_stride); break;
    case kE5M2: dequantize_kernel<T, kE5M2><<<grid, kWarpsPerCta * 32, 0, s>>>(cp, scales, op, rows, d, block, nb, scale_stride); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x: (rows, d) contiguous, f32 / bf16 / f16 (dtype code); codes: (rows, d)
// bytes (int8 codes or fp8 bit patterns); scales: (rows, nb) f32 with
// nb = ceil(d / block). mode 0 = int8, 1 = fp8 e4m3fn, 2 = fp8 e5m2.
// Returns the launch's cudaError_t.
extern "C" int byz_quantize(const void* x, void* codes, void* scales, long long rows,
                            long long d, int block, int nb, int mode, int dtype,
                            void* stream) {
  if (rows <= 0 || d <= 0) return cudaSuccess;
  if (block <= 0 || (long long)nb * block < d) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(scales);
  switch (dtype) {
    case kF32: return launch_quantize<float>(x, codes, sp, rows, d, block, nb, mode, s);
    case kBF16: return launch_quantize<__nv_bfloat16>(x, codes, sp, rows, d, block, nb, mode, s);
    case kF16: return launch_quantize<__half>(x, codes, sp, rows, d, block, nb, mode, s);
    default: return cudaErrorInvalidValue;
  }
}

// codes: (rows, d) bytes as above (code 0 = int8, 1 = e4m3fn, 2 = e5m2);
// scales: rows of scale_stride f32, the first ceil(d / block) used; out:
// (rows, d) in the dtype code. Returns the launch's cudaError_t.
extern "C" int byz_dequantize(const void* codes, const void* scales, void* out,
                              long long rows, long long d, int block,
                              long long scale_stride, int code, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return cudaSuccess;
  if (block <= 0 || scale_stride * block < d) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scales);
  switch (dtype) {
    case kF32: return launch_dequantize<float>(codes, sp, out, rows, d, block, scale_stride, code, s);
    case kBF16: return launch_dequantize<__nv_bfloat16>(codes, sp, out, rows, d, block, scale_stride, code, s);
    case kF16: return launch_dequantize<__half>(codes, sp, out, rows, d, block, scale_stride, code, s);
    default: return cudaErrorInvalidValue;
  }
}
