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

// The codes of one 32-bit word of a wire row, read little endian (byte k
// of an int8 / fp8 word is q[k], nibble k of an s4 word is q[k]): the
// values decode_code and s4_code give, exactly, with fewer instructions
// than a conversion a code. An int8 code c is the float with bits
// 0x4B400000 | (c + 128) (= 1.5 * 2^23 + c + 128) less 12583040 (= 1.5 *
// 2^23 + 128), both exact; an s4 nibble n the float 0x4B400000 | n less
// 12582920 (= 1.5 * 2^23 + 8); two fp8 codes convert to two f16 values in
// one instruction, each exact.
template <int CODE>
__device__ __forceinline__ void decode_word(unsigned int word, float (&q)[CODE == kS4 ? 8 : 4]) {
  if constexpr (CODE == kS4) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      q[k] = __fadd_rn(__uint_as_float(0x4B400000u | ((word >> (4 * k)) & 0xFu)), -12582920.0f);
  } else if constexpr (CODE == kInt8) {
    const unsigned int biased = word ^ 0x80808080u;  // c + 128 in each byte
#pragma unroll
    for (int k = 0; k < 4; ++k)
      q[k] = __fadd_rn(__uint_as_float(__byte_perm(biased, 0x4B400000u, 0x7650u | k)), -12583040.0f);
  } else {
    constexpr __nv_fp8_interpretation_t kind = CODE == kE4M3 ? __NV_E4M3 : __NV_E5M2;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(word >> (16 * k)), kind);
      q[2 * k] = __half2float(__half(__half_raw{h.x}));
      q[2 * k + 1] = __half2float(__half(__half_raw{h.y}));
    }
  }
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
