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
// The summation order is the first design's, kept to the bit: each trace's
// f64 column sums of the f32 terms g * xh and g taken over its real
// positions in order from 0, those sums then added over the traces in
// order from 0 and rounded once. (A trace's sum of g is count x g: every
// partial sum of count copies of an f32 value is exact in f64.)
//
// Bound on the card: bytes. At the trainer's step (64 traces of L 32, d
// 128, ~619 real positions) x at the real positions, the mask and dpool
// read, dx written at every position: ~1.4 MB, 0.0004 ms at 3.35 TB/s;
// ~20 flops a value. So the time is latency: the first design gave a warp
// a trace (16 CTAs at the step, each warp walking its trace's rows in
// order) and a second launch a thread a column; this one is one launch of
// a CTA of 8 warps a trace, rows spread over the warps:
// * the trace's count by __syncthreads_count over its mask row, g formed
//   once a warp (and once a column thread);
// * its positions taken a window of W at a time (W = 32 at d <= 256,
//   W * d = 8192 past that): a ballot gives the window's real positions in
//   order; the k-th goes to warp k mod 8, which issues the loads of all its
//   rows of the window before it reduces any, writes dx and puts the row's
//   terms g * xh (f32) in shared memory at row k; padding rows are zeroed
//   by the warps in turn; a thread a column then adds the window's rows in
//   order to its f64 sum, so the trace's sums come out in position order;
// * each trace's pair of column sums goes out as an f64 partial row; the
//   last CTA to finish (a ticket: atomicAdd on a counter, not on floats)
//   adds the partials in trace order, a thread a column with 16 loads in
//   flight, rounds once and resets the counter, so the scratch needs no
//   clearing between calls.
// Traces are grid-strided over min(T, 4 x SMs) CTAs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ln_exact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 4;  // the grid's cap: SMs x this
constexpr int kTermCells = 8192;  // W x d f32 terms a window in smem
constexpr int kFoldBatch = 16;    // partials a column thread loads at once
constexpr int kMaxD = 1024;
constexpr int kColsPerThread = (kMaxD + kThreads - 1) / kThreads;

// the positions a window (d <= 32 PER)
template <int PER>
__host__ __device__ constexpr int window() {
  return PER <= 8 ? 32 : kTermCells / (32 * PER);
}

// One real position's row: dx from x (this lane's PER values in v) by
// K17's arithmetic, and its terms g * xh into term (a shared-memory row).
template <int PER>
__device__ __forceinline__ void pool_bwd_row(float (&v)[PER],
                                             const float (&g)[PER],
                                             const float (&gm)[PER], int d,
                                             float eps, float* out,
                                             float* term) {
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
    term[f] = __fmul_rn(g[j], v[j]);
  }
}

// d <= 32 * PER
template <int PER>
__global__ void __launch_bounds__(kThreads)
pool_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                const uint8_t* __restrict__ mask,
                const float* __restrict__ dpool, float eps, long long T,
                int L, int d, float* __restrict__ dx,
                float* __restrict__ dgamma, float* __restrict__ dbeta,
                unsigned* __restrict__ cnt, double* __restrict__ part) {
  constexpr int W = window<PER>();
  constexpr int R = W / kWarps;  // real rows a warp a window, at most
  __shared__ float s_term[kTermCells];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float gm[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int f = j * 32 + lane;
    gm[j] = f < d ? __ldg(gamma + f) : 0.f;
  }

  for (long long t = blockIdx.x; t < T; t += gridDim.x) {  // CTA-uniform
    const uint8_t* mrow = mask + t * L;
    int count = 0;
    for (int l0 = 0; l0 < L; l0 += kThreads)
      count += __syncthreads_count(l0 + tid < L && mrow[l0 + tid] != 0);
    const float denom = (float)(count > 1 ? count : 1);
    float g[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int f = j * 32 + lane;
      g[j] = f < d ? __fdiv_rn(dpool[t * d + f], denom) : 0.f;
    }
    double acc[kColsPerThread];
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) acc[i] = 0.0;
    const float* xt = x + t * L * d;
    float* dt = dx + t * L * d;

    for (int l0 = 0; l0 < L; l0 += W) {
      const int len = min(W, L - l0);
      const unsigned live = len == 32 ? 0xffffffffu : (1u << len) - 1u;
      const unsigned real = __ballot_sync(
          0xffffffffu, lane < len && mrow[l0 + lane] != 0);
      const int nreal = __popc(real);
      // this warp's real rows of the window: the k-th, k = warp mod 8
      int rows[R];
      {
        unsigned rem = real;
        for (int i = 0; i < warp; ++i) rem &= rem - 1;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          rows[r] = rem ? __ffs(rem) - 1 : -1;
          for (int i = 0; i < kWarps; ++i) rem &= rem - 1;
        }
      }
      float v[R][PER];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int f = j * 32 + lane;
          v[r][j] = rows[r] >= 0 && f < d
                        ? xt[(long long)(l0 + rows[r]) * d + f]
                        : 0.f;
        }
      // padding rows get no gradient: the k-th to warp k mod 8
      {
        int k = 0;
        for (unsigned pad = live & ~real; pad; pad &= pad - 1, ++k) {
          if (k % kWarps != warp) continue;
          float* out = dt + (long long)(l0 + __ffs(pad) - 1) * d;
#pragma unroll
          for (int j = 0; j < PER; ++j) {
            const int f = j * 32 + lane;
            if (f < d) out[f] = 0.f;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (rows[r] >= 0)  // warp-uniform
          pool_bwd_row<PER>(v[r], g, gm, d, eps,
                            dt + (long long)(l0 + rows[r]) * d,
                            s_term + (r * kWarps + warp) * d);
      __syncthreads();
      // the window's rows in position order into each column's sum
#pragma unroll
      for (int i = 0; i < kColsPerThread; ++i) {
        const int c = tid + i * kThreads;
        if (c < d)
          for (int k = 0; k < nreal; ++k)
            acc[i] += (double)s_term[k * d + c];
      }
      __syncthreads();  // s_term read before the next window writes it
    }
    double* mine = part + (size_t)t * 2 * d;
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) {
      const int c = tid + i * kThreads;
      if (c < d) {
        const float gc = __fdiv_rn(dpool[t * d + c], denom);
        mine[c] = acc[i];
        mine[d + c] = count > 0 ? (double)gc * (double)count : 0.0;
      }
    }
  }

  // ---- the last CTA adds the traces' partials in trace order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(cnt, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int c = tid; c < 2 * d; c += kThreads) {
    double a = 0.0;
    for (long long t0 = 0; t0 < T; t0 += kFoldBatch) {
      double v[kFoldBatch];
#pragma unroll
      for (int p = 0; p < kFoldBatch; ++p)
        v[p] = t0 + p < T ? __ldcg(part + (t0 + p) * 2 * d + c) : 0.0;
#pragma unroll
      for (int p = 0; p < kFoldBatch; ++p)
        if (t0 + p < T) a += v[p];
    }
    if (c < d)
      dgamma[c] = (float)a;
    else
      dbeta[c - d] = (float)a;
  }
  if (tid == 0) *cnt = 0u;
}

template <int PER>
cudaError_t launch_per(const float* x, const float* g, const uint8_t* m,
                       const float* dp, float eps, long long T, int L, int d,
                       float* dx, float* dg, float* db, unsigned* cnt,
                       double* part, unsigned ctas, cudaStream_t st) {
  pool_bwd_kernel<PER><<<ctas, kThreads, 0, st>>>(x, g, m, dp, eps, T, L, d,
                                                  dx, dg, db, cnt, part);
  return cudaGetLastError();
}

}  // namespace

// The int32 counters a launch needs (zero before the first call, left
// zero by every call).
extern "C" long long ln_masked_pool_bwd_counters(long long T) {
  (void)T;
  return 1;
}

// The f64 scratch a launch over T traces needs: a partial row pair a trace.
extern "C" long long ln_masked_pool_bwd_scratch(long long T, int d) {
  return T * 2 * (long long)d;
}

// K21. x, dx: (T, L, d) f32 (x the encoder's output before final_ln); gamma:
// (d,) f32; mask: (T, L) bytes; dpool: (T, d) f32; dgamma, dbeta: (d,) f32
// out, written whole; cnt: ln_masked_pool_bwd_counters(T) int32, zero before
// the first call and reused as each call leaves it; part:
// ln_masked_pool_bwd_scratch(T, d) f64; sms: the card's multiprocessors;
// *launched: the kernels launched. 1 <= d <= 1024, L >= 1.
extern "C" int ln_masked_pool_bwd_launch(const void* x, const void* gamma,
                                         const void* mask, const void* dpool,
                                         float eps, long long T, int L, int d,
                                         void* dx, void* dgamma, void* dbeta,
                                         void* cnt, void* part, int sms,
                                         int* launched, void* stream) {
  *launched = 0;
  if (T <= 0 || L <= 0 || d <= 0 || d > kMaxD || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const long long cap = (long long)sms * kCtasPerSm;
  const unsigned ctas = (unsigned)(T < cap ? T : cap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const float*>(x);
  const auto* gg = static_cast<const float*>(gamma);
  const auto* mm = static_cast<const uint8_t*>(mask);
  const auto* dp = static_cast<const float*>(dpool);
  auto* oo = static_cast<float*>(dx);
  auto* dg = static_cast<float*>(dgamma);
  auto* db = static_cast<float*>(dbeta);
  auto* cc = static_cast<unsigned*>(cnt);
  auto* pp = static_cast<double*>(part);
  cudaError_t e;
  if (d <= 32)
    e = launch_per<1>(xx, gg, mm, dp, eps, T, L, d, oo, dg, db, cc, pp, ctas,
                      st);
  else if (d <= 64)
    e = launch_per<2>(xx, gg, mm, dp, eps, T, L, d, oo, dg, db, cc, pp, ctas,
                      st);
  else if (d <= 128)
    e = launch_per<4>(xx, gg, mm, dp, eps, T, L, d, oo, dg, db, cc, pp, ctas,
                      st);
  else if (d <= 256)
    e = launch_per<8>(xx, gg, mm, dp, eps, T, L, d, oo, dg, db, cc, pp, ctas,
                      st);
  else if (d <= 512)
    e = launch_per<16>(xx, gg, mm, dp, eps, T, L, d, oo, dg, db, cc, pp,
                       ctas, st);
  else
    e = launch_per<32>(xx, gg, mm, dp, eps, T, L, d, oo, dg, db, cc, pp,
                       ctas, st);
  if (e == cudaSuccess) *launched = 1;
  return (int)e;
}
