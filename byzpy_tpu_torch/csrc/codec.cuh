// Shared decode of the wire's blockwise codes: the code value at one
// position of a coded row, before its block scale. Used by the decoders
// B14 and B17 (quantize.cu) and by the fused-dequant segment sum B12
// (segment_sum.cu), so all three read codes with the same arithmetic.
//
// Every decode is exact in f32: an int8 code by a cast, an fp8 bit pattern
// through the exact fp8 -> f16 conversion (every e4m3fn and e5m2 value is
// an f16 value), an s4 nibble n (0..15) as n - 8. Multiplying by the f32
// block scale is then one IEEE rounding, as in the reference's
// byzpy_tpu/parallel/quantization.py (_dequantize_xla :942,
// _dequantize_s4_xla :461).
#pragma once

#include <cuda_fp8.h>

#include "common.cuh"

// code modes shared with byzpy_tpu_torch/ops/codec_kernels.py (_CODES)
enum CodeMode { kInt8 = 0, kE4M3 = 1, kE5M2 = 2, kS4 = 3 };

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

// Code value at position j of a packed s4 row: two offset-binary nibbles a
// byte, the even position in the low nibble; q = nibble - 8 in [-8, 7] (an
// honest encoder writes 1..15; nibble 0 is -8, which a zero scale turns
// into -0.0).
__device__ __forceinline__ float s4_code(const uint8_t* __restrict__ packed, long long j) {
  const uint8_t b = packed[j >> 1];
  return (float)(int)((j & 1) ? (b >> 4) : (b & 0xF)) - 8.0f;
}

// Code value at position j of a wire row in any mode: one byte a position
// for int8 / fp8, half a byte for s4.
template <int CODE>
__device__ __forceinline__ float wire_code(const uint8_t* __restrict__ row, long long j) {
  if constexpr (CODE == kS4) {
    return s4_code(row, j);
  } else {
    return decode_code<CODE>(row[j]);
  }
}
