// K8: the transformer's final LayerNorm, span head and sigmoid at each real
// span, written straight to the span's original index — for Hopper
// (sm_90a).
//
// Replaces odigos_tpu/models/transformer.py _TraceTransformerModule's
// span_head (:83-88; the encoder's final LayerNorm before it,
// odigos_tpu/models/layers.py Encoder) together with the inverse scatter
// of odigos_tpu/serving/fused.py _build_forward_packed._forward
// (:577-597): mat[row, col] gathered per sorted span, then
// zeros(N).at[perm].set(val).
//
// Per sorted index j < n whose row is < R: the hidden state h[row, col, :]
// (d values, bf16 or f32) through the LayerNorm of ln_exact.cuh (exact f64
// sums for the statistics, IEEE steps, the result rounded to the working
// type as Flax's LayerNorm(dtype=bf16) does: the bits of K14 and of the
// plain version), then the f32 d -> 1 dot with the head's weight plus its
// bias, the sigmoid, written to out[perm[j]]. A span whose row is R
// (dropped) gets 0 there; sorted indices j >= n are padding (perm[j] = j)
// and get 0 by coalesced stores, so the host fetches the (N,) scores in
// span order with no scatter. Padding rows cost nothing: only real spans
// are read.
//
// Layout (ln_exact.cuh's, K14's): a span's d values are 16-byte vectors on
// a group of G = d / 8 lanes (bf16; d / 4 for f32) rounded up to a power
// of two, 32 / G spans a warp at once (1 at d 256 in bf16, 2 at d 128),
// each read once and kept in registers; each lane keeps its slices of
// gamma, beta and the head's weight in registers for the whole launch (in
// shared memory past one vector a lane). The grid is persistent (SMs x the
// CTAs an SM holds); a warp's next spans' row_eff, span_col and perm
// entries are loaded two steps ahead and their h vectors one step ahead
// of the reduction.
//
// Kernel and plain version then differ only in the summation order of the
// f32 head dot (and the sigmoid's last bits): chip_smoke.py's HEAD_ATOL.
//
// Bound on the card: bytes — n * d * 2 B of h (33.5 MB at 65536 spans, d =
// 256, bf16: 10 us at 3.35 TB/s) plus 12 B of indices and 4 B of score per
// span; the arithmetic is ~10 d flops per span.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ln_exact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// G lanes a span, NV vectors a lane. Step k of a warp takes the sorted
// indices (warp + k warps) 32 / G + grp; a step's row_eff, span_col and
// perm entries are loaded two steps ahead of its reduction and its h
// vectors one step ahead.
template <typename T, int G, int NV>
__global__ void __launch_bounds__(kThreads) span_head_kernel(
    const T* __restrict__ h, int d, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ w,
    const float* __restrict__ bias, float eps,
    const int32_t* __restrict__ perm, const int32_t* __restrict__ row_eff,
    const int32_t* __restrict__ span_col, long long n, long long N, int R,
    int L, float* __restrict__ out) {
  constexpr int EPV = Vec<T>::EPV;
  constexpr int P = 32 / G;      // spans a warp at once
  constexpr bool REG = NV == 1;  // gamma, beta, w in registers
  constexpr int SP = REG ? 1 : G * NV * EPV;
  __shared__ float s_g[SP], s_b[SP], s_w[SP];
  const int lane = threadIdx.x & 31;
  const int sub = lane % G, grp = lane / G;
  const int nvec = d / EPV;
  float g[EPV], b[EPV], wr[EPV];
  if constexpr (REG) {
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      const bool in = sub < nvec;
      g[e] = in ? __ldg(gamma + sub * EPV + e) : 0.f;
      b[e] = in ? __ldg(beta + sub * EPV + e) : 0.f;
      wr[e] = in ? __ldg(w + sub * EPV + e) : 0.f;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      s_g[i] = __ldg(gamma + i);
      s_b[i] = __ldg(beta + i);
      s_w[i] = __ldg(w + i);
    }
    __syncthreads();
  }
  const float hb = __ldg(bias);
  const float inv_d = inv_pow2(d);
  const uint4* hv = reinterpret_cast<const uint4*>(h);
  const long long warp =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps * P;
  // a step's indices (its span's row, first vector and perm), then the
  // row, perm and vectors of the step being reduced and of the next one
  int row_i, prm_i, row_c, prm_c, row_n, prm_n;
  long long at_i;
  uint4 cur[NV] = {}, nxt[NV] = {};
  auto load_idx = [&](long long j) {
    row_i = R;
    prm_i = 0;
    at_i = 0;
    if (j < n) {
      row_i = __ldg(row_eff + j);
      prm_i = __ldg(perm + j);
      at_i = ((long long)row_i * L + __ldg(span_col + j)) * nvec;
    }
  };
  auto load_vec = [&](uint4 (&buf)[NV], int& row, int& prm) {
    row = row_i;
    prm = prm_i;
    if (row_i < R) {
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (k * G + sub < nvec) buf[k] = __ldg(hv + at_i + k * G + sub);
    }
  };
  long long j = warp * P + grp;
  load_idx(j);
  load_vec(cur, row_c, prm_c);
  load_idx(j + stride);
  for (; j - grp < n; j += stride) {  // warp-uniform
    load_vec(nxt, row_n, prm_n);    // the next step's vectors,
    load_idx(j + 2 * stride);       // the one after's indices, first
    float v[NV][EPV], mean, rstd;
#pragma unroll
    for (int k = 0; k < NV; ++k) unpack(cur[k], v[k]);
    group_ln_stats<G>(v, sub, nvec, d, inv_d, eps, &mean, &rstd);
    float z = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int vi = k * G + sub;
      if (vi >= nvec) continue;
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        const float gg = REG ? g[e] : s_g[vi * EPV + e];
        const float bb = REG ? b[e] : s_b[vi * EPV + e];
        const float ww = REG ? wr[e] : s_w[vi * EPV + e];
        z = fmaf(ln_out(v[k][e], mean, rstd, gg, bb, h), ww, z);
      }
    }
#pragma unroll
    for (int o = G / 2; o; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
    if (sub == 0 && j < n)  // a dropped span (row R) scores 0
      out[prm_c] = row_c < R ? 1.f / (1.f + expf(-(z + hb))) : 0.f;
    row_c = row_n;
    prm_c = prm_n;
#pragma unroll
    for (int k = 0; k < NV; ++k) cur[k] = nxt[k];
  }
  // padding (j >= n, perm[j] = j): zeros, coalesced
  for (long long i = n + (long long)blockIdx.x * kThreads + threadIdx.x;
       i < N; i += (long long)gridDim.x * kThreads)
    out[i] = 0.f;
}

template <typename K, typename T>
cudaError_t head_go(K kernel, int (&cache)[kMaxDevices], const T* h, int d,
                    const float* g, const float* b, const float* w,
                    const float* bias, float eps, const int32_t* perm,
                    const int32_t* row_eff, const int32_t* span_col,
                    long long n, long long N, int R, int L, float* out,
                    int spans_a_warp, cudaStream_t st) {
  int grid = 0;
  cudaError_t e = persistent_grid(kernel, kThreads, cache, &grid);
  if (e != cudaSuccess) return e;
  const long long units = (N + kWarps * spans_a_warp - 1) /
                          (kWarps * spans_a_warp);
  if (units < grid) grid = (int)(units > 0 ? units : 1);
  kernel<<<grid, kThreads, 0, st>>>(h, d, g, b, w, bias, eps, perm, row_eff,
                                    span_col, n, N, R, L, out);
  return cudaGetLastError();
}

#define HEAD(G_, NV_)                                                       \
  {                                                                         \
    static int cache[kMaxDevices];                                          \
    return head_go(span_head_kernel<T, G_, NV_>, cache, h, d, g, b, w,      \
                   bias, eps, perm, row_eff, span_col, n, N, R, L, out,     \
                   32 / (G_), st);                                          \
  }

// d % 8 == 0 up to 1024: the group of lanes a span and the vectors a lane
template <typename T>
cudaError_t launch(const T* h, int d, const float* g, const float* b,
                   const float* w, const float* bias, float eps,
                   const int32_t* perm, const int32_t* row_eff,
                   const int32_t* span_col, long long n, long long N, int R,
                   int L, float* out, cudaStream_t st) {
  const int nvec = d / Vec<T>::EPV;
  if (nvec <= 1) HEAD(1, 1)
  if (nvec <= 2) HEAD(2, 1)
  if (nvec <= 4) HEAD(4, 1)
  if (nvec <= 8) HEAD(8, 1)
  if (nvec <= 16) HEAD(16, 1)
  if (nvec <= 32) HEAD(32, 1)
  if (nvec <= 64) HEAD(32, 2)
  if (nvec <= 128) HEAD(32, 4)
  if constexpr (Vec<T>::EPV == 4) {  // f32 past d 512
    if (nvec <= 256) HEAD(32, 8)
  }
  return cudaErrorInvalidValue;
}
#undef HEAD

}  // namespace

// K8. h: (R, L, d) bf16 (dtype 1) or f32 (dtype 0), 16-byte aligned, the
// encoder's output before its final LayerNorm; gamma, beta, w: (d,) f32;
// bias: one f32; perm, row_eff, span_col: (N,) int32 by sorted index
// (perm[j] = j for j >= n); out: (N,) f32 by original span index. d % 8
// == 0 up to 1024.
extern "C" int span_head_launch(const void* h, int dtype, int R, int L,
                                int d, const void* gamma, const void* beta,
                                const void* w, const void* bias, float eps,
                                const void* perm, const void* row_eff,
                                const void* span_col, long long n,
                                long long N, void* out, void* stream) {
  if (n < 0 || N < n || d < 8 || d % 8 != 0 || d > 1024 || R < 0 || L < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* wf = static_cast<const float*>(w);
  const float* bs = static_cast<const float*>(bias);
  const int32_t* p = static_cast<const int32_t*>(perm);
  const int32_t* re = static_cast<const int32_t*>(row_eff);
  const int32_t* sc = static_cast<const int32_t*>(span_col);
  float* o = static_cast<float*>(out);
  if (dtype == 1)
    return (int)launch(static_cast<const __nv_bfloat16*>(h), d, g, b, wf, bs,
                       eps, p, re, sc, n, N, R, L, o, st);
  return (int)launch(static_cast<const float*>(h), d, g, b, wf, bs, eps, p,
                     re, sc, n, N, R, L, o, st);
}
