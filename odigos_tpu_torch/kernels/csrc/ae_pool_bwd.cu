// K21: the backward pass of K12 (the autoencoder's final LayerNorm +
// masked mean-pool) — for Hopper (sm_90a), f32 (the trainer's working type).
//
// Replaces: the gradient XLA derives for the encoder's final_ln
// (odigos_tpu/models/layers.py :125) and the masked mean-pool of
// odigos_tpu/models/autoencoder.py :67-70, inside the jitted value_and_grad
// of odigos_tpu/training/trainer.py:171. The JAX package has no Pallas
// kernel here; the trainer's step on the card needs a hand-written one.
//
// For each trace t with count_t real positions and upstream gradient
// dpool_t (d values):
//   g = dpool_t / max(count_t, 1)          (a true division, as the pool's)
// and at each real position, x the encoder's row before final_ln:
//   mean, rstd   recomputed exactly as K12 computes them (ln_exact.cuh: f64
//                row sums rounded once, a correctly rounded sqrt and a true
//                division), so they carry K12's own bits (K12 stores none);
//   xh = (x - mean) * rstd,  gy = g * gamma,
//   c1 = sum(gy) / d,  c2 = sum(gy * xh) / d   (f64 row sums rounded once),
//   dx = ((gy - c1) - xh * c2) * rstd           (separate IEEE steps),
// which is K17's arithmetic on a dy of g at the real positions and 0 at
// padding; dx is 0 at padding. dgamma = sum of g * xh and dbeta = sum of g
// over every real position of every trace.
//
// Two launches, no atomics (a step is reproducible):
// * pool_bwd_rows_kernel: a warp a trace, lane k holding the values k,
//   k + 32, ... of a row in registers (K17's layout); the warp counts the
//   trace's real positions by ballots over its mask row and forms g once,
//   then walks its positions 32 at a time: the padding ones are written as
//   zeros, the real ones taken up to 4 at a time in order, their rows'
//   loads issued together; each lane keeps its columns' f64 sums of g * xh
//   and g over the trace and writes them as the warp's partial (a (P, 2,
//   d) f64 scratch, P = warps);
// * pool_bwd_cols_kernel: a thread a column adds the P partials in a fixed
//   order in f64 and rounds once: dgamma and dbeta.
// The f64 sums of f32 terms are exact while the terms' binade spread plus
// log2(count) plus 24 stays within 53 bits, so the plain version (K17's
// plain version on that dy: torch's f64 sums) gives the same bits there.
//
// Bound on the card: bytes. At the trainer's step (64 traces of L 32, d
// 128, ~611 real positions) x at the real positions, the mask and dpool
// read, dx written at every position: ~1.4 MB, 0.0004 ms at 3.35 TB/s;
// ~20 flops a value. The measured times are in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ln_exact.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;  // a trace a warp

// One real position's row: dx from x (this lane's PER values in v) by
// K17's arithmetic, and the lane's f64 column sums of g * xh and g.
template <int PER>
__device__ __forceinline__ void pool_bwd_row(float (&v)[PER],
                                             const float (&g)[PER],
                                             const float (&gm)[PER], int d,
                                             float eps, float* out,
                                             double (&cg)[PER],
                                             double (&cb)[PER]) {
  const int lane = threadIdx.x & 31;
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < PER; ++j) s += (double)v[j];
  const float mean = ln_mean(s, d);
  double q = 0.0;
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (j * 32 + lane < d) q += ln_sq_dev(v[j], mean);
  const float rstd = ln_rstd(q, d, eps);
  double s1 = 0.0, s2 = 0.0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    v[j] = __fmul_rn(__fsub_rn(v[j], mean), rstd);  // xh
    const float gy = __fmul_rn(g[j], gm[j]);
    s1 += (double)gy;
    s2 += (double)__fmul_rn(gy, v[j]);
  }
  const float c1 = ln_mean(s1, d);
  const float c2 = ln_mean(s2, d);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int f = j * 32 + lane;
    if (f >= d) continue;
    const float gy = __fmul_rn(g[j], gm[j]);
    out[f] = __fmul_rn(__fsub_rn(__fsub_rn(gy, c1), __fmul_rn(v[j], c2)),
                       rstd);
    cg[j] += (double)__fmul_rn(g[j], v[j]);
    cb[j] += (double)g[j];
  }
}

// d <= 32 * PER
template <int PER>
__global__ void __launch_bounds__(kThreads)
pool_bwd_rows_kernel(const float* __restrict__ x,
                     const float* __restrict__ gamma,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ dpool, float eps, long long T,
                     int L, int d, float* __restrict__ dx,
                     double* __restrict__ part) {
  // real positions taken kGroup at a time, their rows' loads issued
  // together (the registers allow it at d <= 256)
  constexpr int kGroup = PER <= 4 ? 4 : PER <= 8 ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t = (long long)blockIdx.x * kWarps + warp;
  double cg[PER], cb[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) cg[j] = cb[j] = 0.0;
  if (t < T) {  // warp-uniform
    float gm[PER], g[PER];
    int count = 0;
    const uint8_t* mrow = mask + t * L;
    for (int l0 = 0; l0 < L; l0 += 32)
      count += __popc(__ballot_sync(0xffffffffu,
                                    l0 + lane < L && mrow[l0 + lane] != 0));
    const float denom = (float)(count > 1 ? count : 1);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int f = j * 32 + lane;
      gm[j] = f < d ? __ldg(gamma + f) : 0.f;
      g[j] = f < d ? __fdiv_rn(dpool[t * d + f], denom) : 0.f;
    }
    const float* xt = x + t * L * d;
    float* dt = dx + t * L * d;
    for (int l0 = 0; l0 < L; l0 += 32) {  // the positions 32 at a time
      const int len = min(32, L - l0);
      const unsigned live = len == 32 ? 0xffffffffu : (1u << len) - 1u;
      const unsigned real = __ballot_sync(
          0xffffffffu, lane < len && mrow[l0 + lane] != 0);
      for (unsigned pad = live & ~real; pad; pad &= pad - 1) {
        float* out = dt + (long long)(l0 + __ffs(pad) - 1) * d;
#pragma unroll
        for (int j = 0; j < PER; ++j) {  // padding gets no gradient
          const int f = j * 32 + lane;
          if (f < d) out[f] = 0.f;
        }
      }
      for (unsigned rem = real; rem;) {  // warp-uniform
        int rows[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          rows[k] = rem ? l0 + __ffs(rem) - 1 : -1;
          rem &= rem - 1;
        }
        float v[kGroup][PER];
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
#pragma unroll
          for (int j = 0; j < PER; ++j) {
            const int f = j * 32 + lane;
            v[k][j] = rows[k] >= 0 && f < d
                          ? xt[(long long)rows[k] * d + f]
                          : 0.f;
          }
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          if (rows[k] >= 0)
            pool_bwd_row<PER>(v[k], g, gm, d, eps,
                              dt + (long long)rows[k] * d, cg, cb);
      }
    }
  }
  double* p = part + ((long long)blockIdx.x * kWarps + warp) * 2 * d;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int f = j * 32 + lane;
    if (f < d) {
      p[f] = cg[j];
      p[d + f] = cb[j];
    }
  }
}

// out[c] (c < 2 d: dgamma then dbeta) = the P partials summed in order
__global__ void __launch_bounds__(256)
pool_bwd_cols_kernel(const double* __restrict__ part, long long P, int d,
                     float* __restrict__ dgamma, float* __restrict__ dbeta) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= 2 * d) return;
  double s = 0.0;
  for (long long p = 0; p < P; ++p) s += part[p * 2 * d + c];
  if (c < d)
    dgamma[c] = (float)s;
  else
    dbeta[c - d] = (float)s;
}

template <int PER>
cudaError_t launch_rows(const float* x, const float* g, const uint8_t* m,
                        const float* dp, float eps, long long T, int L, int d,
                        float* dx, double* part, long long ctas,
                        cudaStream_t st) {
  pool_bwd_rows_kernel<PER><<<(unsigned)ctas, kThreads, 0, st>>>(
      x, g, m, dp, eps, T, L, d, dx, part);
  return cudaGetLastError();
}

}  // namespace

// The f64 partial rows a launch over T traces needs.
extern "C" long long ln_masked_pool_bwd_partials(long long T) {
  return (T + kWarps - 1) / kWarps * kWarps;
}

// K21. x, dx: (T, L, d) f32 (x the encoder's output before final_ln); gamma:
// (d,) f32; mask: (T, L) bytes; dpool: (T, d) f32; dgamma, dbeta: (d,) f32
// out; part: a scratch of ln_masked_pool_bwd_partials(T) * 2 * d f64.
// 1 <= d <= 1024, L >= 1.
extern "C" int ln_masked_pool_bwd_launch(const void* x, const void* gamma,
                                         const void* mask, const void* dpool,
                                         float eps, long long T, int L, int d,
                                         void* dx, void* dgamma, void* dbeta,
                                         void* part, void* stream) {
  if (T <= 0 || L <= 0 || d <= 0 || d > 1024)
    return (int)cudaErrorInvalidValue;
  const long long ctas = (T + kWarps - 1) / kWarps;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const float*>(x);
  const auto* gg = static_cast<const float*>(gamma);
  const auto* mm = static_cast<const uint8_t*>(mask);
  const auto* dp = static_cast<const float*>(dpool);
  auto* oo = static_cast<float*>(dx);
  auto* pp = static_cast<double*>(part);
  cudaError_t e;
  if (d <= 32)
    e = launch_rows<1>(xx, gg, mm, dp, eps, T, L, d, oo, pp, ctas, st);
  else if (d <= 64)
    e = launch_rows<2>(xx, gg, mm, dp, eps, T, L, d, oo, pp, ctas, st);
  else if (d <= 128)
    e = launch_rows<4>(xx, gg, mm, dp, eps, T, L, d, oo, pp, ctas, st);
  else if (d <= 256)
    e = launch_rows<8>(xx, gg, mm, dp, eps, T, L, d, oo, pp, ctas, st);
  else if (d <= 512)
    e = launch_rows<16>(xx, gg, mm, dp, eps, T, L, d, oo, pp, ctas, st);
  else
    e = launch_rows<32>(xx, gg, mm, dp, eps, T, L, d, oo, pp, ctas, st);
  if (e != cudaSuccess) return (int)e;
  pool_bwd_cols_kernel<<<(2 * d + 255) / 256, 256, 0, st>>>(
      pp, ctas * kWarps, d, static_cast<float*>(dgamma),
      static_cast<float*>(dbeta));
  return (int)cudaGetLastError();
}
