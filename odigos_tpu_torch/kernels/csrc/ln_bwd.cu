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
// The f64 sums of f32 terms are exact when the terms' binade spread plus
// log2(count) plus 24 stays within 53 bits, so any summation order gives
// the same bits there (the plain version's torch f64 sums, the parent
// design's order, this one's); past that they may differ by one f32 step.
//
// Bound on the card: bytes. At the trainer's (2048, 256) f32 rows the pass
// reads x and dy (4.2 MB) and writes dx (2.1 MB): 1.9 us at 3.35 TB/s,
// against ~20 flops a value (0.01 GFLOP). At that size the time is the
// latency of a row's loads and its four dependent f64 warp reductions, and
// of the column sums, so the design spreads both over the card.
//
// One launch, no float atomics (a step is reproducible):
// * a grid of min(rows / 8, 4 x SMs) CTAs of 4 warps (256 at the trainers'
//   2048 rows: two rows a warp, every SM busy); warps walk the rows
//   grid-strided, a row on a warp: lane k holds the 16-byte vectors k,
//   k + 32, ... of the row where d % 4 == 0 (else the values k, k + 32,
//   ...); the next row's loads are issued before this row's sums (at
//   d <= 512; past that the registers it takes spill);
// * each lane keeps its columns' f64 sums of dy * xh and dy; the CTA's
//   warps add theirs into shared memory in warp order and the CTA writes
//   one f64 partial row pair;
// * the column sums finish in the same launch, by tickets (atomicAdd on
//   counters, not on floats): the last CTA of each group of 16 adds the
//   group's partials in CTA order (a thread a column, the 16 loads issued
//   together), and the last group to finish adds the groups' sums in group
//   order and rounds once: dgamma and dbeta. Each
//   counter is reset by the CTA that read it last, so the scratch needs
//   no clearing between calls.
// The scratch (ln_bwd_partials(rows) rows of 2 d doubles) starts with the
// counters (zero before the first call, left zero by every call), then the
// CTAs' partials, then the groups' sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ln_exact.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;  // the grid's aim before the cap
constexpr int kCtasPerSm = 4;    // the cap: SMs x this
constexpr int kGroup = 16;       // CTAs whose partials one CTA adds
constexpr int kMaxD = 1024;

// the column of lane's value t: 16-byte vectors (VEC) or single values
template <bool VEC>
__device__ __forceinline__ int col_of(int lane, int t) {
  return VEC ? 4 * lane + 128 * (t >> 2) + (t & 3) : lane + 32 * t;
}

// this lane's NV = 4 PER values of the row at p, zero past d
template <int PER, bool VEC>
__device__ __forceinline__ void load_row(const float* p, int d, int lane,
                                         float (&v)[4 * PER]) {
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = 4 * lane + 128 * j;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < d) t = __ldg(reinterpret_cast<const float4*>(p + c));
      v[4 * j] = t.x;
      v[4 * j + 1] = t.y;
      v[4 * j + 2] = t.z;
      v[4 * j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4 * PER; ++t) {
      const int c = lane + 32 * t;
      v[t] = c < d ? __ldg(p + c) : 0.f;
    }
  }
}

// the in-order sum of n <= kGroup partial rows at src (pitch row2) at
// column c, their loads issued together
__device__ __forceinline__ double sum_rows(const double* src, size_t row2,
                                           int n, int c) {
  double v[kGroup];
#pragma unroll
  for (int p = 0; p < kGroup; ++p)
    v[p] = p < n ? __ldcg(src + p * row2 + c) : 0.0;
  double a = 0.0;
#pragma unroll
  for (int p = 0; p < kGroup; ++p) a += v[p];  // + 0.0 past n: exact
  return a;
}

__device__ __forceinline__ void put_col(float* dgamma, float* dbeta, int d,
                                        int c, double a) {
  if (c < d)
    dgamma[c] = (float)a;
  else
    dbeta[c - d] = (float)a;
}

// The in-order sums, over n rows of 2 d partials at src (pitch row2, in
// chunks of kGroup rows), of this thread's columns; each to gsum when it
// is given, else rounded into dgamma / dbeta
__device__ __forceinline__ void sum_columns(const double* src, size_t row2,
                                            int n, int d, double* gsum,
                                            float* dgamma, float* dbeta,
                                            int tid, int threads) {
  for (int c = tid; c < 2 * d; c += threads) {
    double a = 0.0;
    for (int p0 = 0; p0 < n; p0 += kGroup)
      a += sum_rows(src + p0 * row2, row2, min(kGroup, n - p0), c);
    if (gsum != nullptr)
      gsum[c] = a;
    else
      put_col(dgamma, dbeta, d, c, a);
  }
}

// d <= 128 PER; PF: the next row's loads issued before this row's sums
template <int PER, bool VEC, bool PF>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ dy, float eps, long long rows, int d,
              float* __restrict__ dx, float* __restrict__ dgamma,
              float* __restrict__ dbeta, double* __restrict__ part,
              int lead) {
  constexpr int NV = 4 * PER;
  __shared__ double red[2 * kMaxD];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float g[NV];
  double cg[NV], cb[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int c = col_of<VEC>(lane, t);
    g[t] = c < d ? __ldg(gamma + c) : 0.f;
    cg[t] = cb[t] = 0.0;
  }

  const long long W = (long long)gridDim.x * kWarps;
  long long r = (long long)blockIdx.x * kWarps + warp;
  float xv[NV], ev[NV];
  if (r < rows) {
    load_row<PER, VEC>(x + r * d, d, lane, xv);
    load_row<PER, VEC>(dy + r * d, d, lane, ev);
  }
  for (; r < rows; r += W) {  // warp-uniform
    const bool more = r + W < rows;
    float xn[NV], en[NV];
    if (PF && more) {
      load_row<PER, VEC>(x + (r + W) * d, d, lane, xn);
      load_row<PER, VEC>(dy + (r + W) * d, d, lane, en);
    }
    double s = 0.0;
#pragma unroll
    for (int t = 0; t < NV; ++t) s += (double)xv[t];
    const float mean = ln_mean(s, d);
    double q = 0.0;
#pragma unroll
    for (int t = 0; t < NV; ++t)
      if (col_of<VEC>(lane, t) < d) q += ln_sq_dev(xv[t], mean);
    const float rstd = ln_rstd(q, d, eps);
    double s1 = 0.0, s2 = 0.0;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      xv[t] = __fmul_rn(__fsub_rn(xv[t], mean), rstd);  // xh
      const float gy = __fmul_rn(ev[t], g[t]);
      s1 += (double)gy;
      s2 += (double)__fmul_rn(gy, xv[t]);
    }
    const float c1 = ln_mean(s1, d);
    const float c2 = ln_mean(s2, d);
    float out[NV];
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const float gy = __fmul_rn(ev[t], g[t]);
      out[t] = __fmul_rn(__fsub_rn(__fsub_rn(gy, c1), __fmul_rn(xv[t], c2)),
                         rstd);
      cg[t] += (double)__fmul_rn(ev[t], xv[t]);
      cb[t] += (double)ev[t];
    }
    float* o = dx + r * d;
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int c = 4 * lane + 128 * j;
        if (c < d)
          *reinterpret_cast<float4*>(o + c) = make_float4(
              out[4 * j], out[4 * j + 1], out[4 * j + 2], out[4 * j + 3]);
      }
    } else {
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const int c = lane + 32 * t;
        if (c < d) o[c] = out[t];
      }
    }
    if (more) {
      if constexpr (PF) {
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          xv[t] = xn[t];
          ev[t] = en[t];
        }
      } else {
        load_row<PER, VEC>(x + (r + W) * d, d, lane, xv);
        load_row<PER, VEC>(dy + (r + W) * d, d, lane, ev);
      }
    }
  }

  // ---- the CTA's partial: its warps' column sums added in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const int c = col_of<VEC>(lane, t);
        if (c < d) {
          red[c] = (w ? red[c] : 0.0) + cg[t];
          red[d + c] = (w ? red[d + c] : 0.0) + cb[t];
        }
      }
    }
    __syncthreads();
  }
  const int G = gridDim.x;
  const size_t row2 = (size_t)2 * d;
  double* mine = part + (size_t)(lead + blockIdx.x) * row2;
  for (int c = tid; c < 2 * d; c += kThreads) mine[c] = red[c];

  // ---- the column sums: the last CTA of each group adds the group's
  // partials in CTA order, the last group the groups' sums in group order
  unsigned* cnt = reinterpret_cast<unsigned*>(part);
  const int grp = blockIdx.x / kGroup;
  const int gsize = min(kGroup, G - grp * kGroup);
  const int ngroups = (G + kGroup - 1) / kGroup;
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(cnt + 1 + grp, 1u) == (unsigned)(gsize - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_columns(part + (size_t)(lead + grp * kGroup) * row2, row2, gsize, d,
              ngroups > 1 ? part + (size_t)(lead + G + grp) * row2 : nullptr,
              dgamma, dbeta, tid, kThreads);
  if (tid == 0) cnt[1 + grp] = 0u;
  if (ngroups == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(cnt, 1u) == (unsigned)(ngroups - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_columns(part + (size_t)(lead + G) * row2, row2, ngroups, d, nullptr,
              dgamma, dbeta, tid, kThreads);
  if (tid == 0) cnt[0] = 0u;
}

int g_sms[kMaxDevices];  // SMs a device, looked up once

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && g_sms[dev] > 0) {
    *sms = g_sms[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < kMaxDevices) g_sms[dev] = *sms;
  return e;
}

long long ctas_for(long long rows, int sms) {
  const long long want =
      (rows + kWarps * kRowsPerWarp - 1) / (kWarps * kRowsPerWarp);
  const long long cap = (long long)sms * kCtasPerSm;
  return want < cap ? want : cap;
}

long long groups_of(long long ctas) { return (ctas + kGroup - 1) / kGroup; }

// the scratch rows before the partials, holding the counters (a row of
// 2 d doubles holds 4 d >= 4 of them, whatever d)
int lead_rows(int sms) {
  return (int)((1 + groups_of((long long)sms * kCtasPerSm) + 3) / 4);
}

template <int PER, bool VEC>
void launch_per(const float* x, const float* g, const float* dy, float eps,
                long long rows, int d, float* dx, float* dgamma,
                float* dbeta, double* part, int lead, long long ctas,
                cudaStream_t st) {
  ln_bwd_kernel<PER, VEC, (PER <= 4)><<<(unsigned)ctas, kThreads, 0, st>>>(
      x, g, dy, eps, rows, d, dx, dgamma, dbeta, part, lead);
}

template <bool VEC>
void launch_vec(const float* x, const float* g, const float* dy, float eps,
                long long rows, int d, float* dx, float* dgamma,
                float* dbeta, double* part, int lead, long long ctas,
                cudaStream_t st) {
  if (d <= 128)
    launch_per<1, VEC>(x, g, dy, eps, rows, d, dx, dgamma, dbeta, part, lead,
                       ctas, st);
  else if (d <= 256)
    launch_per<2, VEC>(x, g, dy, eps, rows, d, dx, dgamma, dbeta, part, lead,
                       ctas, st);
  else if (d <= 512)
    launch_per<4, VEC>(x, g, dy, eps, rows, d, dx, dgamma, dbeta, part, lead,
                       ctas, st);
  else
    launch_per<8, VEC>(x, g, dy, eps, rows, d, dx, dgamma, dbeta, part, lead,
                       ctas, st);
}

}  // namespace

// The scratch a launch over `rows` rows needs, in rows of 2 d doubles (the
// counters, each CTA's partial, each group's sum) on the current device;
// -1 if the device cannot be queried.
extern "C" long long ln_bwd_partials(long long rows) {
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess || sms <= 0) return -1;
  const long long ctas = ctas_for(rows, sms);
  return lead_rows(sms) + ctas + groups_of(ctas);
}

// x, dy, dx: (rows, d) f32; gamma: (d,) f32; dgamma, dbeta: (d,) f32;
// part: a scratch of ln_bwd_partials(rows) * 2 * d f64, zero before its
// first use and reused as each call leaves it. 1 <= d <= 1024.
extern "C" int ln_bwd_launch(const void* x, const void* gamma,
                             const void* dy, float eps, long long rows, int d,
                             void* dx, void* dgamma, void* dbeta, void* part,
                             void* stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const long long ctas = ctas_for(rows, sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const float*>(x);
  const auto* gg = static_cast<const float*>(gamma);
  const auto* ee = static_cast<const float*>(dy);
  auto* oo = static_cast<float*>(dx);
  auto* dg = static_cast<float*>(dgamma);
  auto* db = static_cast<float*>(dbeta);
  auto* pp = static_cast<double*>(part);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  if (vec)
    launch_vec<true>(xx, gg, ee, eps, rows, d, oo, dg, db, pp, lead_rows(sms),
                     ctas, st);
  else
    launch_vec<false>(xx, gg, ee, eps, rows, d, oo, dg, db, pp,
                      lead_rows(sms), ctas, st);
  return (int)cudaGetLastError();
}
