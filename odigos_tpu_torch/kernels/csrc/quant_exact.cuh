// The int8 activation quantize of odigos_tpu/models/quantized.py _qdense
// (:63-71), shared by K9 (quant.cu) and K10's fused FFN1 epilogue
// (qgemm.cu) — for Hopper (sm_90a).
//
// a_s = absmax * f32(1/127) (XLA compiles the reference's a_max / 127.0
// into that product; 1 for a zero row), code = clamp(rint(v / a_s), ±127)
// with a true division, rounded half to even.
//
// The division is taken off the critical path: t = v * fl(1 / a_s), then
// rint(t) by the 1.5 * 2^23 addition (exact for |t| < 2^22; the code is
// the low byte of the sum's bits). That is rint(fl(v / a_s)) unless a
// half-integer lies between t and the quotient: |t - fl(v / a_s)| <= 3 *
// 2^-24 * |v / a_s| < 2^-15 for |v / a_s| < 128, so such a t lies within
// 2^-15 of the half-integer, |t - rint(t)| > 0.5 - 2^-14, and the caller is
// told (`near`) to divide truly. Every v of the row has |v| <= absmax, so
// |v / a_s| < 127 (1 + 2^-22) and |t| < 127.5: rint(t) is a code, no clamp
// needed (an inf or NaN t fails the comparison and divides truly). So the
// codes are the true division's, bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInv127 = 1.0f / 127.0f;  // f32(1/127), folded exactly
constexpr float kRoundMagic = 12582912.0f;  // 1.5 * 2^23
constexpr int kRoundMagicBits = 0x4B400000;
constexpr float kTieBand = 0.5f - 0x1p-14f;

__device__ __forceinline__ float quant_scale(float amax) {
  return amax > 0.f ? __fmul_rn(amax, kInv127) : 1.0f;
}

// clamp(rint(v / a), ±127) by the true division
__device__ __forceinline__ int quant_code_exact(float v, float a) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(v, a))));
}

// rint(v * inv) + kRoundMagicBits: the code is its low byte, or the whole
// less kRoundMagicBits; `near` is set when the caller must take
// quant_code_exact instead
__device__ __forceinline__ int quant_code_bits(float v, float inv,
                                               bool& near) {
  const float t = __fmul_rn(v, inv);
  const float m = __fadd_rn(t, kRoundMagic);
  const float d = __fsub_rn(t, __fsub_rn(m, kRoundMagic));
  near |= !(fabsf(d) < kTieBand);
  return __float_as_int(m);
}

}  // namespace
