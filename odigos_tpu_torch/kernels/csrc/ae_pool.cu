// K12: the span autoencoder's final LayerNorm and masked mean-pool — for
// Hopper (sm_90a).
//
// Replaces the bottleneck's input in odigos_tpu/models/autoencoder.py
// _AutoencoderModule (:69-70): the encoder's final LayerNorm (its last op,
// odigos_tpu/models/layers.py Encoder), then
//   denom  = max(mask.sum(-1), 1).astype(h.dtype)
//   pooled = (h * mask).sum(-2) / denom
// over one trace per row. The encoder's output is read by nothing else, so
// the port never writes it: this kernel takes the hidden state BEFORE the
// final LayerNorm and applies it at the real positions only.
//
// One warp per trace (row of L positions), d = 32 * PER features, lane k
// holding features [k * PER, (k + 1) * PER) (d in 32, 64, 128, 256; any
// other d % 8 == 0 up to 1024: lane k holds k, k + 32, ..., gamma and
// beta in shared memory). For each real position (the
// mask byte is warp-uniform; padding is skipped, which is exact: the LN of
// a finite row is finite, and the reference multiplies it by 0):
//   * the LayerNorm of ln_exact.cuh, shared with K9 and K11: exact f64
//     sums for the statistics, IEEE steps, the result rounded to the
//     working type (Flax's LayerNorm(dtype=bf16) returns bf16), so the
//     plain version (torch's f64 sums) gives the same bits;
//   * added to the lane's f64 running sums (exact for these sums, so again
//     order-free).
// Then the sum is rounded to f32 (jnp.sum accumulates bf16 in f32) and to
// the working type, divided by max(count, 1) with a true division, and the
// quotient rounded to the working type: (T, d) out.
//
// Bound on the card: bytes. The (T, L, d) input is read at the real
// positions only (2 d bytes each in bf16), plus the (T, L) mask and the
// (T, d) output; at T = 2048 traces of L = 64 in bf16, d = 128: 33.6 MB if
// every position were read (10 us at 3.35 TB/s), ~5.4 MB at the otel mix's
// ~10 real spans a trace. ~12 flops per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ln_exact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int PER>
__global__ void __launch_bounds__(kThreads) ln_masked_pool_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float eps, long long n_rows, int L, T* __restrict__ out) {
  constexpr int d = 32 * PER;
  const int lane = threadIdx.x & 31;
  const int k0 = lane * PER;
  float g[PER], b[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    g[j] = gamma[k0 + j];
    b[j] = beta[k0 + j];
  }
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < n_rows; t += warps) {
    double acc[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) acc[j] = 0.0;
    int count = 0;
    for (int l = 0; l < L; ++l) {
      if (!mask[t * L + l]) continue;  // warp-uniform
      ++count;
      float y[PER];
      warp_ln_row<T, PER>(x + (t * L + l) * d + k0, g, b, eps, y);
#pragma unroll
      for (int j = 0; j < PER; ++j) acc[j] += (double)y[j];
    }
    const float denom = (float)(count > 0 ? count : 1);
    T* o = out + t * d + k0;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      store(o + j, __fdiv_rn(round_to((float)acc[j], o), denom));
  }
}

// Any other d % 8 == 0 up to 1024: lane k holds features k, k + 32, ...
// (PER of them, those at or past d idle), gamma and beta in shared
// memory; the same arithmetic (the f64 sums are exact, so the layout does
// not change a bit).
template <typename T, int PER>
__global__ void __launch_bounds__(kThreads) ln_masked_pool_any_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float eps, long long n_rows, int L, int d, T* __restrict__ out) {
  __shared__ float s_g[32 * PER], s_b[32 * PER];
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < d; e += kThreads) {
    s_g[e] = gamma[e];
    s_b[e] = beta[e];
  }
  __syncthreads();
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < n_rows; t += warps) {
    double acc[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) acc[j] = 0.0;
    int count = 0;
    for (int l = 0; l < L; ++l) {
      if (!mask[t * L + l]) continue;  // warp-uniform
      ++count;
      const T* xr = x + (t * L + l) * d;
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
        if (f < d)
          acc[j] += (double)ln_out(v[j], mean, rstd, s_g[f], s_b[f], xr);
      }
    }
    const float denom = (float)(count > 0 ? count : 1);
    T* o = out + t * d;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int f = j * 32 + lane;
      if (f < d) store(o + f, __fdiv_rn(round_to((float)acc[j], o), denom));
    }
  }
}

template <typename T>
int launch(const T* x, const uint8_t* mask, const float* gamma,
           const float* beta, float eps, long long n_rows, int L, int d,
           T* out, cudaStream_t st) {
  long long blocks = (n_rows + kWarps - 1) / kWarps;
  if (blocks > 8192) blocks = 8192;
  if (blocks < 1) blocks = 1;
  const unsigned g = (unsigned)blocks;
  switch (d) {
    case 32:
      ln_masked_pool_kernel<T, 1><<<g, kThreads, 0, st>>>(
          x, mask, gamma, beta, eps, n_rows, L, out);
      break;
    case 64:
      ln_masked_pool_kernel<T, 2><<<g, kThreads, 0, st>>>(
          x, mask, gamma, beta, eps, n_rows, L, out);
      break;
    case 128:
      ln_masked_pool_kernel<T, 4><<<g, kThreads, 0, st>>>(
          x, mask, gamma, beta, eps, n_rows, L, out);
      break;
    case 256:
      ln_masked_pool_kernel<T, 8><<<g, kThreads, 0, st>>>(
          x, mask, gamma, beta, eps, n_rows, L, out);
      break;
    default:
      if (d % 8 != 0 || d > 1024) return (int)cudaErrorInvalidValue;
      if (d <= 256)
        ln_masked_pool_any_kernel<T, 8><<<g, kThreads, 0, st>>>(
            x, mask, gamma, beta, eps, n_rows, L, d, out);
      else if (d <= 512)
        ln_masked_pool_any_kernel<T, 16><<<g, kThreads, 0, st>>>(
            x, mask, gamma, beta, eps, n_rows, L, d, out);
      else
        ln_masked_pool_any_kernel<T, 32><<<g, kThreads, 0, st>>>(
            x, mask, gamma, beta, eps, n_rows, L, d, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K12. x: (n_rows, L, d) bf16 (dtype 1) or f32 (dtype 0), the encoder's
// hidden state before its final LayerNorm; mask: (n_rows, L) bytes (0 =
// padding); gamma, beta: (d,) f32; out: (n_rows, d) in x's type. d % 8
// == 0 up to 1024 (32, 64, 128 and 256 on the register-resident kernel).
extern "C" int ln_masked_pool_launch(const void* x, int dtype,
                                     const void* mask, const void* gamma,
                                     const void* beta, float eps,
                                     long long n_rows, int L, int d,
                                     void* out, void* stream) {
  if (n_rows < 0 || L < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(x), m, g, b, eps, n_rows,
                  L, d, static_cast<__nv_bfloat16*>(out), st);
  return launch(static_cast<const float*>(x), m, g, b, eps, n_rows, L, d,
                static_cast<float*>(out), st);
}
