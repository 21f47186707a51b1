// K17: the backward pass of the float encoder's LayerNorm (K14) — for
// Hopper (sm_90a), f32 (the trainer's working type).
//
// Replaces: the gradient XLA derives for flax.linen.LayerNorm (eps 1e-6)
// at odigos_tpu/models/layers.py :71, :77 and the encoder's final_ln
// (:125), inside the jitted value_and_grad of
// odigos_tpu/training/trainer.py:171. The JAX package has no Pallas kernel
// here; the trainer's step on the card needs a hand-written one.
//
// For each row x of d values with upstream gradient dy and scale gamma:
//   mean, rstd   recomputed exactly as K14 computes them (ln_exact.cuh: f64
//                row sums rounded once, a correctly rounded sqrt and a true
//                division), so they carry K14's own bits (K14 stores none);
//   xh = (x - mean) * rstd,  g = dy * gamma,
//   c1 = sum(g) / d,  c2 = sum(g * xh) / d   (f64 row sums rounded once),
//   dx = ((g - c1) - xh * c2) * rstd         (separate IEEE steps),
//   dgamma = sum over rows of dy * xh,  dbeta = sum over rows of dy.
// A padding row of zeros has var 0 and rstd = 1 / sqrt(eps): finite, and
// its dy is 0 on the trainer's path, so it adds exactly 0 everywhere.
//
// Two launches, no atomics (a step is reproducible):
// * ln_bwd_rows_kernel: a warp a row at a time, 8 rows a warp, lane k
//   holding the values k, k + 32, ... of the row in registers (x, dy, then
//   xh and g); the row's four sums are f64 warp shuffles; each lane keeps
//   its columns' f64 sums of dy * xh and dy over the warp's rows and writes
//   them as the warp's partial (a (P, 2, d) f64 scratch, P = warps);
// * ln_bwd_cols_kernel: a thread a column adds the P partials in a fixed
//   order in f64 and rounds once: dgamma and dbeta.
// The f64 sums of f32 terms are exact when the terms' binade spread plus
// log2(count) plus 24 stays within 53 bits, so the plain version (torch's
// f64 sums) gives the same bits there whatever the order; past that they
// may differ by one f32 step.
//
// Bound on the card: bytes. At the trainer's (2048, 256) f32 rows the pass
// reads x and dy (4.2 MB) and writes dx (2.1 MB): 1.9 us at 3.35 TB/s,
// against ~20 flops a value (0.01 GFLOP). The measured times are in
// PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ln_exact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;

// d <= 32 * PER
template <int PER>
__global__ void __launch_bounds__(kThreads)
ln_bwd_rows_kernel(const float* __restrict__ x,
                   const float* __restrict__ gamma,
                   const float* __restrict__ dy, float eps, long long rows,
                   int d, float* __restrict__ dx, double* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float g[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int f = j * 32 + lane;
    g[j] = f < d ? __ldg(gamma + f) : 0.f;
  }
  double cg[PER], cb[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) cg[j] = cb[j] = 0.0;
  const long long r0 =
      (long long)blockIdx.x * kRowsPerCta + (long long)warp * kRowsPerWarp;
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const long long r = r0 + t;
    if (r >= rows) break;  // warp-uniform
    const float* xr = x + r * d;
    const float* er = dy + r * d;
    float v[PER], e[PER];
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int f = j * 32 + lane;
      v[j] = f < d ? xr[f] : 0.f;
      e[j] = f < d ? er[f] : 0.f;
      s += (double)v[j];
    }
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
      const float gy = __fmul_rn(e[j], g[j]);
      s1 += (double)gy;
      s2 += (double)__fmul_rn(gy, v[j]);
    }
    const float c1 = ln_mean(s1, d);
    const float c2 = ln_mean(s2, d);
    float* out = dx + r * d;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int f = j * 32 + lane;
      if (f >= d) continue;
      const float gy = __fmul_rn(e[j], g[j]);
      out[f] = __fmul_rn(__fsub_rn(__fsub_rn(gy, c1), __fmul_rn(v[j], c2)),
                         rstd);
      cg[j] += (double)__fmul_rn(e[j], v[j]);
      cb[j] += (double)e[j];
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
__global__ void __launch_bounds__(kThreads)
ln_bwd_cols_kernel(const double* __restrict__ part, long long P, int d,
                   float* __restrict__ dgamma, float* __restrict__ dbeta) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= 2 * d) return;
  double s = 0.0;
  for (long long p = 0; p < P; ++p) s += part[p * 2 * d + c];
  if (c < d)
    dgamma[c] = (float)s;
  else
    dbeta[c - d] = (float)s;
}

template <int PER>
cudaError_t launch_rows(const float* x, const float* g, const float* dy,
                        float eps, long long rows, int d, float* dx,
                        double* part, long long ctas, cudaStream_t st) {
  ln_bwd_rows_kernel<PER><<<(unsigned)ctas, kThreads, 0, st>>>(
      x, g, dy, eps, rows, d, dx, part);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx: (rows, d) f32; gamma: (d,) f32; dgamma, dbeta: (d,) f32;
// part: a scratch of ln_bwd_partials(rows) * 2 * d f64. 1 <= d <= 1024.
extern "C" long long ln_bwd_partials(long long rows) {
  return (rows + kRowsPerCta - 1) / kRowsPerCta * kWarps;
}

extern "C" int ln_bwd_launch(const void* x, const void* gamma,
                             const void* dy, float eps, long long rows, int d,
                             void* dx, void* dgamma, void* dbeta, void* part,
                             void* stream) {
  if (rows <= 0 || d <= 0 || d > 1024) return (int)cudaErrorInvalidValue;
  const long long ctas = (rows + kRowsPerCta - 1) / kRowsPerCta;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const float*>(x);
  const auto* gg = static_cast<const float*>(gamma);
  const auto* ee = static_cast<const float*>(dy);
  auto* oo = static_cast<float*>(dx);
  auto* pp = static_cast<double*>(part);
  cudaError_t e;
  if (d <= 32)
    e = launch_rows<1>(xx, gg, ee, eps, rows, d, oo, pp, ctas, st);
  else if (d <= 64)
    e = launch_rows<2>(xx, gg, ee, eps, rows, d, oo, pp, ctas, st);
  else if (d <= 128)
    e = launch_rows<4>(xx, gg, ee, eps, rows, d, oo, pp, ctas, st);
  else if (d <= 256)
    e = launch_rows<8>(xx, gg, ee, eps, rows, d, oo, pp, ctas, st);
  else if (d <= 512)
    e = launch_rows<16>(xx, gg, ee, eps, rows, d, oo, pp, ctas, st);
  else
    e = launch_rows<32>(xx, gg, ee, eps, rows, d, oo, pp, ctas, st);
  if (e != cudaSuccess) return (int)e;
  ln_bwd_cols_kernel<<<(2 * d + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      pp, ctas * kWarps, d, static_cast<float*>(dgamma),
      static_cast<float*>(dbeta));
  return (int)cudaGetLastError();
}
