// The port's exact LayerNorm, shared by K9 (quant.cu), K11 (recon_ce.cu)
// and K12 (ae_pool.cu) — for Hopper (sm_90a).
//
// One warp normalises one row of n values; each lane holds its share in
// registers. The rounding contract, which makes every kernel here give the
// same bits as quant.layer_norm_plain (torch's f64 row sums):
//   * mean and the mean square of the deviations are f32 sums of the row
//     taken exactly in f64 and rounded once, so the summation order does
//     not matter (each lane adds its values in f64, warp_sum adds the
//     lanes in f64: exact for rows of these widths);
//   * var + eps, a correctly rounded sqrt and a true division for the
//     reciprocal (not rsqrtf, which is approximate);
//   * (x - mean) * rstd * gamma + beta as separate IEEE-rounded steps (no
//     contraction into FMAs, which torch's separate ops do not have);
//   * the result rounded to the working type (Flax's LayerNorm(dtype=bf16)
//     returns bf16).
// Everything sits in an anonymous namespace: each source that includes it
// is compiled into a library of its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// v rounded to the type T points to (the pointer only selects the type)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the row's mean from the lanes' f64 sums of its n values
__device__ __forceinline__ float ln_mean(double lane_sum, int n) {
  return __fdiv_rn((float)warp_sum(lane_sum), (float)n);
}

// one value's squared deviation, for the lane's f64 sum
__device__ __forceinline__ double ln_sq_dev(float v, float mean) {
  const float t = __fsub_rn(v, mean);
  return (double)__fmul_rn(t, t);
}

// 1 / sqrt(var + eps) from the lanes' f64 sums of squared deviations
__device__ __forceinline__ float ln_rstd(double lane_sq_sum, int n,
                                         float eps) {
  const float var = __fdiv_rn((float)warp_sum(lane_sq_sum), (float)n);
  return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// one normalised value, rounded to T's type
template <typename T>
__device__ __forceinline__ float ln_out(float v, float mean, float rstd,
                                        float g, float b, const T* tag) {
  const float y = __fmul_rn(__fsub_rn(v, mean), rstd);
  return round_to(__fadd_rn(__fmul_rn(y, g), b), tag);
}

// A row of d = 32 * PER values of T at xr, lane k holding [k * PER,
// (k + 1) * PER): xr, g and b are the lane's share. y gets the normalised
// values, rounded to T's type.
template <typename T, int PER>
__device__ __forceinline__ void warp_ln_row(const T* xr, const float* g,
                                            const float* b, float eps,
                                            float (&y)[PER]) {
  constexpr int d = 32 * PER;
  float v[PER];
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    v[j] = load_f(xr + j);
    s += (double)v[j];
  }
  const float mean = ln_mean(s, d);
  double q = 0.0;
#pragma unroll
  for (int j = 0; j < PER; ++j) q += ln_sq_dev(v[j], mean);
  const float rstd = ln_rstd(q, d, eps);
#pragma unroll
  for (int j = 0; j < PER; ++j)
    y[j] = ln_out(v[j], mean, rstd, g[j], b[j], xr);
}

// A row of d <= 32 * PER values of T at xr, lane k holding the values k,
// k + 32, ... (those at or past d idle): any d, the same bits as
// warp_ln_row (the sums are exact, so the layout does not matter). g and
// b are the whole (d,) parameters; y[j] gets value k + 32 j, 0 past d.
template <typename T, int PER>
__device__ __forceinline__ void warp_ln_row_strided(const T* xr, int d,
                                                    const float* g,
                                                    const float* b,
                                                    float eps,
                                                    float (&y)[PER]) {
  const int lane = threadIdx.x & 31;
  float v[PER];
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int f = j * 32 + lane;
    v[j] = f < d ? load_f(xr + f) : 0.f;
    s += (double)v[j];
  }
  const float mean = ln_mean(s, d);
  double q = 0.0;
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (j * 32 + lane < d) q += ln_sq_dev(v[j], mean);
  const float rstd = ln_rstd(q, d, eps);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int f = j * 32 + lane;
    y[j] = f < d ? ln_out(v[j], mean, rstd, g[f], b[f], xr) : 0.f;
  }
}

}  // namespace
