// B13, B14, B15, B16, B17: the blockwise codecs of the compressed wire fabric.
//
// B13 replaces byzpy_tpu/parallel/quantization.py:256 _quantize_kernel
// (pallas_call at :299): blockwise symmetric int8. B15 replaces :479
// _quantize_fp8_kernel (pallas_call at :550): blockwise-scaled fp8 e4m3fn /
// e5m2, emitted as bit patterns. B14 replaces :279 _dequantize_kernel
// (pallas_call at :335): codes (int8, or fp8 bit patterns) times the block
// scale, written in the requested dtype. B16 replaces :504
// _quantize_s4_kernel (pallas_call at :588): 4-bit codes, two a byte. B17
// replaces :525 _dequantize_s4_kernel (pallas_call at :628).
//
// What the encoders compute, per (row, block of `block` trailing values):
// absmax of the finite values (the padding of a partial last block adds
// nothing), scale = absmax > 0 ? absmax * (1/qmax) : 1, y = x * (1/scale),
// then NaN -> 0 and y clipped to +-qmax (int8 and s4: rint first, round half
// to even; fp8: one direct round-to-nearest-even cast, __NV_SATFINITE).
// 1/qmax is the f32 constant (for s4 0x1.24924ap-3f, the f32 nearest 1/7:
// the reference multiplies by it, it does not divide by 7). Every step is
// one IEEE operation in f32, so the codes and scales are the plain
// versions' bit for bit; 1/scale must stay an IEEE division, so this file
// must never be built with --use_fast_math. s4 stores q + 8 as a nibble,
// the even coordinate in the low nibble; a partial last block's padding
// encodes as nibble 8, and the packed row holds nb * block / 2 bytes.
//
// Bound: device-memory bytes. An encode reads each input value once and
// writes one byte (s4: half a byte) of code and 4/block bytes of scale per
// value; a decode is the reverse. Design: one warp per (row, block), lanes
// striding the block (coalesced loads). The encoders take absmax by
// __shfl_xor_sync, lane 0 writes the scale, and a second pass over the
// block (from L1) writes the codes; B16's lanes each encode 8 consecutive
// values into one 32-bit word of 4 packed bytes (bytes, two values a lane,
// where the block is not a multiple of 8). The decoders read their block's
// scale once and unroll the stride loop, so each lane has several code
// loads in flight and no per-value division finds the scale; they read
// codes through codec.cuh, which B12 shares.

#include "codec.cuh"

namespace {

constexpr int kWarpsPerCta = 8;

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

// s4 code of y = x * (1/scale): NaN -> 0, rint (half to even), clip to +-7,
// stored as the nibble q + 8.
__device__ __forceinline__ uint32_t s4_nibble(float y) {
  const float q = isnan(y) ? 0.0f : fminf(fmaxf(rintf(y), -7.0f), 7.0f);
  return (uint32_t)((int)q + 8);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
quantize_s4_kernel(const T* __restrict__ x, uint8_t* __restrict__ packed,
                   float* __restrict__ scales, long long rows, long long d, int block, int nb) {
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
  // 0x1.24924ap-3f: the f32 constant 1/7 (the reference's absmax * (1.0 / 7.0))
  const float scale = amax > 0.0f ? __fmul_rn(amax, 0x1.24924ap-3f) : 1.0f;
  if (lane == 0) scales[row * nb + blk] = scale;
  const float inv = __fdiv_rn(1.0f, scale);
  uint8_t* pb = packed + (row * nb + blk) * (long long)(block / 2);
  if (block % 8 == 0) {
    // 8 values a lane, one aligned 32-bit store of 4 packed bytes
    for (int i = lane * 8; i < block; i += 256) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float v = i + k < len ? to_f32(xb[i + k]) : 0.0f;
        word |= s4_nibble(__fmul_rn(v, inv)) << (4 * k);
      }
      *reinterpret_cast<uint32_t*>(pb + i / 2) = word;
    }
  } else {
    for (int i = lane * 2; i < block; i += 64) {
      const float v0 = i < len ? to_f32(xb[i]) : 0.0f;
      const float v1 = i + 1 < len ? to_f32(xb[i + 1]) : 0.0f;
      pb[i / 2] = (uint8_t)(s4_nibble(__fmul_rn(v0, inv)) | (s4_nibble(__fmul_rn(v1, inv)) << 4));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
dequantize_s4_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ scales,
                     T* __restrict__ out, long long rows, long long d, long long ncodes,
                     int block, int nb, long long scale_stride) {
  const long long warp = (long long)blockIdx.x * kWarpsPerCta + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= rows * nb) return;
  const long long row = warp / nb;
  const int blk = (int)(warp % nb);
  const long long c0 = (long long)blk * block;
  const long long rem = d - c0;
  const int len = rem < block ? (int)rem : block;
  const float scale = scales[row * scale_stride + blk];
  const uint8_t* pr = packed + row * ncodes;
  T* ob = out + row * d + c0;
#pragma unroll 8
  for (int i = lane; i < len; i += 32)
    ob[i] = from_f32<T>(__fmul_rn(s4_code(pr, c0 + i), scale));
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

template <typename T>
cudaError_t launch_quantize_s4(const void* x, void* packed, float* scales, long long rows,
                               long long d, int block, int nb, cudaStream_t s) {
  const long long warps = rows * nb;
  const dim3 grid((unsigned)((warps + kWarpsPerCta - 1) / kWarpsPerCta));
  quantize_s4_kernel<T><<<grid, kWarpsPerCta * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<uint8_t*>(packed), scales, rows, d, block, nb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dequantize_s4(const void* packed, const float* scales, void* out,
                                 long long rows, long long d, long long ncodes, int block,
                                 long long scale_stride, cudaStream_t s) {
  const int nb = (int)((d + block - 1) / block);
  const long long warps = rows * nb;
  const dim3 grid((unsigned)((warps + kWarpsPerCta - 1) / kWarpsPerCta));
  dequantize_s4_kernel<T><<<grid, kWarpsPerCta * 32, 0, s>>>(
      static_cast<const uint8_t*>(packed), scales, static_cast<T*>(out), rows, d, ncodes, block,
      nb, scale_stride);
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

// B16. x: (rows, d) contiguous, f32 / bf16 / f16 (dtype code); packed: (rows,
// nb * block / 2) bytes; scales: (rows, nb) f32 with nb = ceil(d / block);
// block even. Returns the launch's cudaError_t.
extern "C" int byz_quantize_s4(const void* x, void* packed, void* scales, long long rows,
                               long long d, int block, int nb, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return cudaSuccess;
  if (block <= 0 || block % 2 || (long long)nb * block < d) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(scales);
  switch (dtype) {
    case kF32: return launch_quantize_s4<float>(x, packed, sp, rows, d, block, nb, s);
    case kBF16: return launch_quantize_s4<__nv_bfloat16>(x, packed, sp, rows, d, block, nb, s);
    case kF16: return launch_quantize_s4<__half>(x, packed, sp, rows, d, block, nb, s);
    default: return cudaErrorInvalidValue;
  }
}

// B17. packed: rows of ncodes bytes (2 * ncodes >= d); scales: rows of
// scale_stride f32, the first ceil(d / block) used; out: (rows, d) in the
// dtype code. Returns the launch's cudaError_t.
extern "C" int byz_dequantize_s4(const void* packed, const void* scales, void* out,
                                 long long rows, long long d, long long ncodes, int block,
                                 long long scale_stride, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return cudaSuccess;
  if (block <= 0 || scale_stride * block < d || 2 * ncodes < d) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scales);
  switch (dtype) {
    case kF32: return launch_dequantize_s4<float>(packed, sp, out, rows, d, ncodes, block, scale_stride, s);
    case kBF16: return launch_dequantize_s4<__nv_bfloat16>(packed, sp, out, rows, d, ncodes, block, scale_stride, s);
    case kF16: return launch_dequantize_s4<__half>(packed, sp, out, rows, d, ncodes, block, scale_stride, s);
    default: return cudaErrorInvalidValue;
  }
}
