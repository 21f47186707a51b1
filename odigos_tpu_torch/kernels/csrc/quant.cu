// K9: per-token int8 quantize, with an optional LayerNorm in front — for
// Hopper (sm_90a).
//
// Replaces the activation half of odigos_tpu/models/quantized.py _qdense
// (:63-71: per-token a_s = absmax / 127, x_q = clip(round(x / a_s), ±127))
// and, in LN mode, the _layernorm before it (:81-88). The int8 block runs
// it four times a layer: LN1 and LN2 (LN mode, K = d), the attention
// context before the out-projection and the GELU output before FFN2
// (plain mode, K = d and K = d_ff).
//
// One warp per row of K values (bf16 or f32), read with 16-byte loads and
// held in registers. LN mode: the LayerNorm of ln_exact.cuh, shared with
// K11 and K12 (the mean and the mean square of the deviations in two
// passes over the registers, as :84-85, from exact f64 sums, so the plain
// version's torch f64 sums give the same bits; IEEE steps), the result
// rounded to the working type, because _layernorm returns that type and
// _qdense reads it back. Then absmax over the row and quant_exact.cuh's
// codes: a_s = absmax * f32(1/127) (XLA compiles the reference's
// a_max / 127.0 into that product; 1 for a zero row), codes = rint(y / a_s)
// rounded half to even and clipped to ±127, taken from a product with the
// row's reciprocal and by the true division only for a 16-byte vector
// whose product lies near a rounding boundary (the true division's bits).
// Outputs: x_q (M, K) int8, a_s (M,) f32.
//
// Past K = 1024 a warp's registers would spill: one CTA takes a row
// (ln_quantize_row_kernel), its sums and absmax through shared memory, the
// same arithmetic and codes (d_ff up to 4096).
//
// Bound on the card: bytes. In K * (elt + 1) bytes per row (plus 4), out
// at M = 131072 rows: 100.7 MB at K = 256 in bf16 (0.030 ms at 3.35 TB/s),
// 402.7 MB at K = 1024 (0.120 ms); ~10 flops per element, far below any
// compute limit. Each lane moves 16 contiguous bytes per load and 8 (bf16)
// or 4 (f32) contiguous code bytes per store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ln_exact.cuh"
#include "quant_exact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 bytes of T as floats
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack4(const int* q) {
  return (uint32_t)(q[0] & 0xff) | ((uint32_t)(q[1] & 0xff) << 8) |
         ((uint32_t)(q[2] & 0xff) << 16) | ((uint32_t)(q[3] & 0xff) << 24);
}

// NV 16-byte vectors per lane cover K <= NV * 32 * (16 / sizeof(T)).
template <typename T, int NV, bool LN>
__global__ void __launch_bounds__(kThreads) ln_quantize_kernel(
    const T* __restrict__ x, long long M, int K,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float eps, int8_t* __restrict__ xq, float* __restrict__ as) {
  constexpr int EPV = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < M; row += warps) {
    const T* xr = x + row * K;
    float v[NV][EPV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k0 = (i * 32 + lane) * EPV;
      if (k0 < K) {
        load_vec(xr + k0, v[i]);
      } else {
#pragma unroll
        for (int j = 0; j < EPV; ++j) v[i][j] = 0.f;
      }
    }
    if constexpr (LN) {
      double s = 0.0;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int j = 0; j < EPV; ++j) s += (double)v[i][j];  // 0 past K
      const float mean = ln_mean(s, K);
      double q = 0.0;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if ((i * 32 + lane) * EPV >= K) continue;
#pragma unroll
        for (int j = 0; j < EPV; ++j) q += ln_sq_dev(v[i][j], mean);
      }
      const float rstd = ln_rstd(q, K, eps);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int k0 = (i * 32 + lane) * EPV;
        if (k0 >= K) continue;
        float gv[EPV], bv[EPV];
#pragma unroll
        for (int j = 0; j < EPV; j += 4) {
          load_vec(gamma + k0 + j, gv + j);
          load_vec(beta + k0 + j, bv + j);
        }
#pragma unroll
        for (int j = 0; j < EPV; ++j)
          v[i][j] = ln_out(v[i][j], mean, rstd, gv[j], bv[j], xr);
      }
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if ((i * 32 + lane) * EPV >= K) continue;
#pragma unroll
      for (int j = 0; j < EPV; ++j) amax = fmaxf(amax, fabsf(v[i][j]));
    }
    const float a = quant_scale(warp_max(amax));
    const float inv = __fdiv_rn(1.0f, a);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k0 = (i * 32 + lane) * EPV;
      if (k0 >= K) continue;
      int c[EPV];  // the code is each one's low byte
      bool near = false;
#pragma unroll
      for (int j = 0; j < EPV; ++j) c[j] = quant_code_bits(v[i][j], inv, near);
      if (near) {  // rare: a product near a rounding boundary
#pragma unroll
        for (int j = 0; j < EPV; ++j) c[j] = quant_code_exact(v[i][j], a);
      }
      int8_t* dst = xq + row * K + k0;
      if constexpr (EPV == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(pack4(c), pack4(c + 4));
      else
        *reinterpret_cast<uint32_t*>(dst) = pack4(c);
    }
    if (lane == 0) as[row] = a;
  }
}

// A row wider than a warp's registers hold (K > 1024 bf16 or f32 values,
// up to 4096): one CTA a row, thread t holding the 16-byte vectors t, t +
// 256, ... (NV of them), the sums and the absmax through shared memory;
// the same arithmetic as above.
template <typename T, int NV, bool LN>
__global__ void __launch_bounds__(kThreads) ln_quantize_row_kernel(
    const T* __restrict__ x, long long M, int K,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float eps, int8_t* __restrict__ xq, float* __restrict__ as) {
  constexpr int EPV = 16 / sizeof(T);
  __shared__ double s_sum[2][kWarps];
  __shared__ float s_max[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  for (long long row = blockIdx.x; row < M; row += gridDim.x) {
    const T* xr = x + row * K;
    float v[NV][EPV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k0 = (i * kThreads + tid) * EPV;
      if (k0 < K) {
        load_vec(xr + k0, v[i]);
      } else {
#pragma unroll
        for (int j = 0; j < EPV; ++j) v[i][j] = 0.f;
      }
    }
    if constexpr (LN) {
      double s = 0.0;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int j = 0; j < EPV; ++j) s += (double)v[i][j];  // 0 past K
      s = warp_sum(s);
      if (lane == 0) s_sum[0][wid] = s;
      __syncthreads();
      s = 0.0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_sum[0][w];
      const float mean = __fdiv_rn((float)s, (float)K);
      double q = 0.0;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if ((i * kThreads + tid) * EPV >= K) continue;
#pragma unroll
        for (int j = 0; j < EPV; ++j) q += ln_sq_dev(v[i][j], mean);
      }
      q = warp_sum(q);
      if (lane == 0) s_sum[1][wid] = q;
      __syncthreads();
      q = 0.0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) q += s_sum[1][w];
      const float var = __fdiv_rn((float)q, (float)K);
      const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int k0 = (i * kThreads + tid) * EPV;
        if (k0 >= K) continue;
        float gv[EPV], bv[EPV];
#pragma unroll
        for (int j = 0; j < EPV; j += 4) {
          load_vec(gamma + k0 + j, gv + j);
          load_vec(beta + k0 + j, bv + j);
        }
#pragma unroll
        for (int j = 0; j < EPV; ++j)
          v[i][j] = ln_out(v[i][j], mean, rstd, gv[j], bv[j], xr);
      }
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if ((i * kThreads + tid) * EPV >= K) continue;
#pragma unroll
      for (int j = 0; j < EPV; ++j) amax = fmaxf(amax, fabsf(v[i][j]));
    }
    amax = warp_max(amax);
    if (lane == 0) s_max[wid] = amax;
    __syncthreads();
    amax = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) amax = fmaxf(amax, s_max[w]);
    const float a = quant_scale(amax);
    const float inv = __fdiv_rn(1.0f, a);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k0 = (i * kThreads + tid) * EPV;
      if (k0 >= K) continue;
      int c[EPV];
      bool near = false;
#pragma unroll
      for (int j = 0; j < EPV; ++j) c[j] = quant_code_bits(v[i][j], inv, near);
      if (near) {
#pragma unroll
        for (int j = 0; j < EPV; ++j) c[j] = quant_code_exact(v[i][j], a);
      }
      int8_t* dst = xq + row * K + k0;
      if constexpr (EPV == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(pack4(c), pack4(c + 4));
      else
        *reinterpret_cast<uint32_t*>(dst) = pack4(c);
    }
    if (tid == 0) as[row] = a;
    __syncthreads();  // the shared sums are rewritten by the next row
  }
}

template <typename T, bool LN>
cudaError_t launch_t(const T* x, long long M, int K, const float* g,
                     const float* b, float eps, int8_t* xq, float* as,
                     cudaStream_t st) {
  constexpr int EPV = 16 / sizeof(T);
  const int need = (K + 32 * EPV - 1) / (32 * EPV);
  long long blocks = (M + kWarps - 1) / kWarps;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  const dim3 grid((unsigned)blocks);
  if (need <= 1)
    ln_quantize_kernel<T, 1, LN><<<grid, kThreads, 0, st>>>(x, M, K, g, b,
                                                            eps, xq, as);
  else if (need <= 2)
    ln_quantize_kernel<T, 2, LN><<<grid, kThreads, 0, st>>>(x, M, K, g, b,
                                                            eps, xq, as);
  else if (need <= 4)
    ln_quantize_kernel<T, 4, LN><<<grid, kThreads, 0, st>>>(x, M, K, g, b,
                                                            eps, xq, as);
  else if (need <= 8 && sizeof(T) == 4)
    ln_quantize_kernel<T, 8, LN><<<grid, kThreads, 0, st>>>(x, M, K, g, b,
                                                            eps, xq, as);
  else {  // past a warp's registers: a CTA a row
    const int per = (K / EPV + kThreads - 1) / kThreads;
    const dim3 rgrid((unsigned)(M < (1LL << 20) ? M : (1LL << 20)));
    if (per <= 1)
      ln_quantize_row_kernel<T, 1, LN><<<rgrid, kThreads, 0, st>>>(
          x, M, K, g, b, eps, xq, as);
    else if (per <= 2)
      ln_quantize_row_kernel<T, 2, LN><<<rgrid, kThreads, 0, st>>>(
          x, M, K, g, b, eps, xq, as);
    else if (per <= 4)
      ln_quantize_row_kernel<T, 4, LN><<<rgrid, kThreads, 0, st>>>(
          x, M, K, g, b, eps, xq, as);
    else
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ln(const void* x, long long M, int K, const void* g,
                      const void* b, float eps, void* xq, void* as,
                      cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  int8_t* q = static_cast<int8_t*>(xq);
  float* a = static_cast<float*>(as);
  if (g != nullptr)
    return launch_t<T, true>(xt, M, K, static_cast<const float*>(g),
                             static_cast<const float*>(b), eps, q, a, st);
  return launch_t<T, false>(xt, M, K, nullptr, nullptr, eps, q, a, st);
}

}  // namespace

// K9. x: (M, K) bf16 (dtype 1) or f32 (dtype 0), rows 16-byte aligned,
// K % 8 == 0 and K <= 4096; gamma, beta: (K,) f32, 16-byte aligned, for LN
// mode (read as float4), both null for plain mode; xq: (M, K) int8; as: (M,) f32.
extern "C" int ln_quantize_launch(const void* x, int dtype, long long M,
                                  int K, const void* gamma, const void* beta,
                                  float eps, void* xq, void* as,
                                  void* stream) {
  if (M < 0 || K < 8 || K % 8 != 0 || K > 4096 ||
      (dtype != 0 && dtype != 1) || ((gamma == nullptr) != (beta == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_ln<__nv_bfloat16>(x, M, K, gamma, beta, eps, xq, as,
                                         st);
  return (int)launch_ln<float>(x, M, K, gamma, beta, eps, xq, as, st);
}
