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
// A warp takes a trace (a row of L positions) at a time, persistently (the
// grid is SMs x the CTAs an SM holds). It reads the trace's mask row as
// 4-byte words (128 positions a warp load) and lists the real positions in
// shared memory by ballots and popcounts: a mask with holes is read like a
// prefix, and padding positions cost nothing (exact: the LN of a finite
// row is finite and the reference multiplies it by 0). The positions then
// take ln_exact.cuh's row layout, K14's: a position's d values are 16-byte
// vectors on a group of G = d / 8 lanes (bf16; d / 4 for f32), rounded up
// to a power of two, 32 / G positions a warp at once. Each thread copies
// its vectors into a ring of its own in shared memory by cp.async, a few
// steps ahead of the reduction (the bytes in flight hold no registers).
// Per position:
//   * the LayerNorm of ln_exact.cuh, shared with K9, K11 and K14: exact f64
//     sums for the statistics over the group (log2 G shuffles), IEEE steps,
//     the result rounded to the working type (Flax's LayerNorm(dtype=bf16)
//     returns bf16), so the plain version (torch's f64 sums) gives the same
//     bits;
//   * added to the lane's f64 running sums (exact for these sums, so again
//     order-free); the groups' sums are added by shuffles once the trace is
//     done.
// Then the sum is rounded to f32 (jnp.sum accumulates bf16 in f32) and to
// the working type, divided by max(count, 1) with a true division, and the
// quotient rounded to the working type: (T, d) out. gamma and beta stay in
// registers up to one vector a lane, past that in shared memory.
//
// With a device row count (live: the fused route's trace count, written
// by K13) the rows at or past live[0] are neither read (mask or h) nor
// normalised: they are written as zeros (what the plain version gives a
// row of padding), because the bottleneck's product reads every row.
//
// Bound on the card: bytes. The (T, L, d) input is read at the real
// positions only (2 d bytes each in bf16), plus the live rows' mask and
// the (T, d) output; an engine call of 4096 traces (T = 43008 rows, d =
// 128, bf16): 10.8 MB of real positions + 0.26 MB of mask + 11.0 MB of
// output, 6.6 us at 3.35 TB/s. ~12 flops per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ln_exact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 1024;  // the longest rows served
constexpr int kPass = 128;   // mask bytes a warp lists at once

// The real positions among mask bytes p0 .. p0 + 127 of one trace's row
// (L bytes at m), listed in ascending order at `list`; returns their count
// (warp-uniform). A lane reads 4 mask bytes (one aligned word when
// `words`); ballots place each real position after the lower lanes' ones.
__device__ __forceinline__ int list_real_positions(const uint8_t* m, int L,
                                                   int p0, bool words,
                                                   uint16_t* list) {
  const int lane = threadIdx.x & 31;
  const int p = p0 + 4 * lane;
  uint32_t w = 0;
  if (words) {
    if (p < L) w = __ldg(reinterpret_cast<const unsigned int*>(m + p));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (p + e < L) w |= (uint32_t)__ldg(m + p + e) << (8 * e);
  }
  const unsigned lower = (1u << lane) - 1u;
  int k = 0, n = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned bal = __ballot_sync(0xffffffffu, (w >> (8 * e)) & 0xffu);
    k += __popc(bal & lower);
    n += __popc(bal);
  }
  __syncwarp();  // the previous list is read out
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if ((w >> (8 * e)) & 0xffu) list[k++] = (uint16_t)(p + e);
  __syncwarp();
  return n;
}

// G lanes a position, NV vectors a lane, S ring stages: each thread copies
// its vectors of step s + S - 1 into its own ring slot by cp.async before
// reducing step s, so a trace's loads are in flight together without
// holding registers
template <typename T, int G, int NV, int S>
__global__ void __launch_bounds__(kThreads) ln_masked_pool_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float eps, long long rows, int L, int d, bool words,
    const int* __restrict__ live, T* __restrict__ out) {
  constexpr int EPV = Vec<T>::EPV;
  constexpr int P = 32 / G;      // positions a warp at once
  constexpr bool REG = NV == 1;  // gamma and beta in registers
  constexpr int SP = REG ? 1 : G * NV * EPV;
  __shared__ uint16_t s_list[kWarps][kPass];
  __shared__ float s_g[SP], s_b[SP];
  __shared__ uint4 s_ring[S][NV][kThreads];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int sub = lane % G, grp = lane / G;
  const int nvec = d / EPV;
  const long long lim = ln_row_limit(rows, live, 1);
  const float inv_d = inv_pow2(d);
  float g[EPV], b[EPV];
  if constexpr (REG) {
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      const bool in = sub < nvec;
      g[e] = in ? __ldg(gamma + sub * EPV + e) : 0.f;
      b[e] = in ? __ldg(beta + sub * EPV + e) : 0.f;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      s_g[i] = __ldg(gamma + i);
      s_b[i] = __ldg(beta + i);
    }
    __syncthreads();
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  uint16_t* list = s_list[wid];
  uint4* ring = &s_ring[0][0][threadIdx.x];
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long t = (long long)blockIdx.x * kWarps + wid; t < lim;
       t += warps) {  // warp-uniform
    const uint4* xt = xv + t * L * nvec;
    double acc[NV][EPV];
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < EPV; ++e) acc[j][e] = 0.0;
    int count = 0;
    for (int p0 = 0; p0 < L; p0 += kPass) {  // warp-uniform
      const int n = list_real_positions(mask + t * L, L, p0, words, list);
      count += n;
      // copy this group's vectors of step s into ring stage s % S (a
      // group of copies, maybe empty)
      auto issue = [&](int s) {
        const int i = s * P + grp;
        if (i < n) {
          const uint4* xr = xt + (long long)list[i] * nvec + sub;
#pragma unroll
          for (int j = 0; j < NV; ++j)
            if (j * G + sub < nvec)
              copy16_async(ring + ((s % S) * NV + j) * kThreads, xr + j * G);
        }
        copy_commit();
      };
      const int steps = (n + P - 1) / P;
#pragma unroll
      for (int s = 0; s < S - 1; ++s) issue(s);
      for (int s = 0; s < steps; ++s) {  // warp-uniform
        issue(s + S - 1);
        copy_wait<S - 1>();  // step s's copies have landed
        float v[NV][EPV], mean, rstd;
#pragma unroll
        for (int j = 0; j < NV; ++j)
          unpack(ring[((s % S) * NV + j) * kThreads], v[j]);
        group_ln_stats<G>(v, sub, nvec, d, inv_d, eps, &mean, &rstd);
        if (s * P + grp >= n) continue;  // not a position of ours
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int vi = j * G + sub;
          if (vi >= nvec) continue;
#pragma unroll
          for (int e = 0; e < EPV; ++e) {
            const float gg = REG ? g[e] : s_g[vi * EPV + e];
            const float bb = REG ? b[e] : s_b[vi * EPV + e];
            acc[j][e] += (double)ln_out(v[j][e], mean, rstd, gg, bb, x);
          }
        }
      }
    }
    // the groups' sums, then group 0 writes the pooled row
#pragma unroll
    for (int o = G; o < 32; o <<= 1)
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < EPV; ++e)
          acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
    if (grp == 0) {
      const float denom = (float)(count > 0 ? count : 1);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int vi = j * G + sub;
        if (vi >= nvec) continue;
        float y[EPV];
#pragma unroll
        for (int e = 0; e < EPV; ++e)
          y[e] = round_to(__fdiv_rn(round_to((float)acc[j][e], x), denom), x);
        ov[t * nvec + vi] = pack(y);
      }
    }
  }
  // the rows past the count: zeros, nothing read
  const long long end = rows * nvec;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = lim * nvec + (long long)blockIdx.x * kThreads +
                     threadIdx.x;
       i < end; i += (long long)gridDim.x * kThreads)
    ov[i] = zero;
}

template <typename K, typename T>
cudaError_t pool_go(K kernel, int (&cache)[kMaxDevices], const T* x,
                    const uint8_t* mask, const float* g, const float* b,
                    float eps, long long rows, int L, int d, bool words,
                    const int* live, T* out, cudaStream_t st) {
  int grid = 0;
  cudaError_t e = persistent_grid(kernel, kThreads, cache, &grid);
  if (e != cudaSuccess) return e;
  const long long units = (rows + kWarps - 1) / kWarps;
  if (units < grid) grid = (int)(units > 0 ? units : 1);
  kernel<<<grid, kThreads, 0, st>>>(x, mask, g, b, eps, rows, L, d, words,
                                    live, out);
  return cudaGetLastError();
}

#define POOL(G_, NV_, S_)                                                  \
  {                                                                        \
    static int cache[kMaxDevices];                                         \
    return pool_go(ln_masked_pool_kernel<T, G_, NV_, S_>, cache, x, mask, \
                   g, b, eps, rows, L, d, words, live, out, st);           \
  }

// d % 8 == 0 up to 1024: the group of lanes a position, the vectors a
// lane, and the ring's stages (16 KB of ring a CTA)
template <typename T>
cudaError_t launch(const T* x, const uint8_t* mask, const float* g,
                   const float* b, float eps, long long rows, int L, int d,
                   bool words, const int* live, T* out, cudaStream_t st) {
  const int nvec = d / Vec<T>::EPV;
  if (nvec <= 1) POOL(1, 1, 4)
  if (nvec <= 2) POOL(2, 1, 4)
  if (nvec <= 4) POOL(4, 1, 4)
  if (nvec <= 8) POOL(8, 1, 4)
  if (nvec <= 16) POOL(16, 1, 4)
  if (nvec <= 32) POOL(32, 1, 4)
  if (nvec <= 64) POOL(32, 2, 2)
  if (nvec <= 128) POOL(32, 4, 1)
  if constexpr (Vec<T>::EPV == 4) {  // f32 past d 512
    if (nvec <= 256) POOL(32, 8, 1)
  }
  return cudaErrorInvalidValue;
}
#undef POOL

}  // namespace

// K12. x: (n_rows, L, d) bf16 (dtype 1) or f32 (dtype 0), 16-byte
// aligned, the encoder's hidden state before its final LayerNorm; mask:
// (n_rows, L) bytes (0 = padding); gamma, beta: (d,) f32; live: null or a
// (1,) int32 row count on the device (rows at or past it written as
// zeros, unread); out: (n_rows, d) in x's type, 16-byte aligned. d % 8 ==
// 0 up to 1024, 1 <= L <= 1024.
extern "C" int ln_masked_pool_launch(const void* x, int dtype,
                                     const void* mask, const void* gamma,
                                     const void* beta, float eps,
                                     long long n_rows, int L, int d,
                                     const void* live, void* out,
                                     void* stream) {
  if (n_rows < 0 || L < 1 || L > kMaxL || d < 8 || d % 8 != 0 || d > 1024 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const bool words = L % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 4 == 0;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const int* lv = static_cast<const int*>(live);
  if (dtype == 1)
    return (int)launch(static_cast<const __nv_bfloat16*>(x), m, g, b, eps,
                       n_rows, L, d, words, lv,
                       static_cast<__nv_bfloat16*>(out), st);
  return (int)launch(static_cast<const float*>(x), m, g, b, eps, n_rows, L,
                     d, words, lv, static_cast<float*>(out), st);
}
