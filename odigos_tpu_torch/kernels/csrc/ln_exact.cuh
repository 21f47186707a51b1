// The port's exact LayerNorm and the row layout it runs on, shared by K8
// (span_head.cu), K9 (quant.cu), K11 (recon_ce.cu), K12 (ae_pool.cu) and
// K14 (dense.cu) — for Hopper (sm_90a).
//
// A row of n values is spread over lanes, each holding its share in
// registers. The rounding contract, which makes every kernel here give the
// same bits as quant.layer_norm_plain (torch's f64 row sums):
//   * mean and the mean square of the deviations are f32 sums of the row
//     taken exactly in f64 and rounded once, so the summation order does
//     not matter (each lane adds its values in f64, the shuffle trees add
//     the lanes in f64: exact for rows of these widths);
//   * var + eps, a correctly rounded sqrt and a true division for the
//     reciprocal (not rsqrtf, which is approximate);
//   * (x - mean) * rstd * gamma + beta as separate IEEE-rounded steps (no
//     contraction into FMAs, which torch's separate ops do not have);
//   * the result rounded to the working type (Flax's LayerNorm(dtype=bf16)
//     returns bf16).
// The row layout (K14's, K8's and K12's): 16-byte vectors of EPV values
// (8 bf16, 4 f32), a row on a group of G lanes (a power of two), lane sub
// of the group holding the vectors sub, sub + G, ... (NV of them; those at
// or past the row's end idle), so a warp holds 32 / G rows at once and a
// row's shuffle trees are log2 G deep.
// Everything sits in an anonymous namespace: each source that includes it
// is compiled into a library of its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// f64 sum over the G lanes of an aligned group (xor offsets below G)
template <int G>
__device__ __forceinline__ double group_sum(double v) {
#pragma unroll
  for (int o = G / 2; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

// A row of d <= 32 * PER values of T at xr, lane k holding the values k,
// k + 32, ... (those at or past d idle): any d (the sums are exact, so the
// layout does not matter). g and b are the whole (d,) parameters; y[j]
// gets value k + 32 j, 0 past d.
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

// ------------------------------------------------ the 16-byte row layout
// 16-byte vectors of T: EPV values each
template <typename T>
struct Vec {
  static constexpr int EPV = 16 / (int)sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// y already rounded to T's type: packing keeps its bits
__device__ __forceinline__ uint4 pack(const float (&y)[4]) {
  return make_uint4(__float_as_uint(y[0]), __float_as_uint(y[1]),
                    __float_as_uint(y[2]), __float_as_uint(y[3]));
}
__device__ __forceinline__ uint4 pack(const float (&y)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (__float_as_uint(y[2 * i]) >> 16) |
           (__float_as_uint(y[2 * i + 1]) & 0xffff0000u);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// x / d, correctly rounded: a product by inv_d (1 / d, exact) where d is a
// power of two (the same real number, so the same rounding), else a true
// division; inv_d is 0 for other d
__device__ __forceinline__ float div_d(float x, int d, float inv_d) {
  return inv_d != 0.f ? __fmul_rn(x, inv_d) : __fdiv_rn(x, (float)d);
}
__host__ __device__ inline float inv_pow2(int d) {
  return d > 0 && (d & (d - 1)) == 0 ? 1.0f / (float)d : 0.f;
}

// f64 sum of a vector's values, pairwise (exact, so any order)
__device__ __forceinline__ double vec_sum(const float (&v)[4]) {
  return ((double)v[0] + (double)v[1]) + ((double)v[2] + (double)v[3]);
}
__device__ __forceinline__ double vec_sum(const float (&v)[8]) {
  return (((double)v[0] + (double)v[1]) + ((double)v[2] + (double)v[3])) +
         (((double)v[4] + (double)v[5]) + ((double)v[6] + (double)v[7]));
}
__device__ __forceinline__ double vec_sq_dev(const float (&v)[4], float m) {
  return (ln_sq_dev(v[0], m) + ln_sq_dev(v[1], m)) +
         (ln_sq_dev(v[2], m) + ln_sq_dev(v[3], m));
}
__device__ __forceinline__ double vec_sq_dev(const float (&v)[8], float m) {
  return ((ln_sq_dev(v[0], m) + ln_sq_dev(v[1], m)) +
          (ln_sq_dev(v[2], m) + ln_sq_dev(v[3], m))) +
         ((ln_sq_dev(v[4], m) + ln_sq_dev(v[5], m)) +
          (ln_sq_dev(v[6], m) + ln_sq_dev(v[7], m)));
}

// The mean and 1 / sqrt(var + eps) of a row of d values on the G lanes of
// a group, this lane's NV vectors in v (vector j is the row's j * G + sub;
// those at or past nvec are not the row's). Every lane of the warp calls
// it (the shuffles); a group whose lanes hold no row computes garbage of
// its own.
template <int G, int NV, int EPV>
__device__ __forceinline__ void group_ln_stats(const float (&v)[NV][EPV],
                                               int sub, int nvec, int d,
                                               float inv_d, float eps,
                                               float* mean, float* rstd) {
  double s = 0.0, q = 0.0;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (j * G + sub < nvec) s += vec_sum(v[j]);
  const float m = div_d((float)group_sum<G>(s), d, inv_d);
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (j * G + sub < nvec) q += vec_sq_dev(v[j], m);
  const float var = div_d((float)group_sum<G>(q), d, inv_d);
  *mean = m;
  *rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// cp.async of one 16-byte vector into this thread's own ring slot; the
// groups are counted per thread, so a thread waits on its own copies only
__device__ __forceinline__ void copy16_async(uint4* dst, const uint4* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the rows a kernel may touch: all of them, or live[0] * per (a device
// count, read on the card so that the host never waits for it)
__device__ __forceinline__ long long ln_row_limit(long long rows,
                                                  const int* live, int per) {
  if (live == nullptr) return rows;
  const long long n = (long long)__ldg(live) * per;
  return n < rows ? (n < 0 ? 0 : n) : rows;
}

constexpr int kMaxDevices = 64;

// the persistent grid of kernel k at `threads` a CTA: SMs x the CTAs an SM
// holds, looked up once a device (a static cache per instantiation)
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, int (&cache)[kMaxDevices],
                            int* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && cache[dev] > 0) {
    *grid = cache[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (e != cudaSuccess) return e;
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cache[dev] = *grid;
  return cudaSuccess;
}

}  // namespace
