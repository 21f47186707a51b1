// K16: the backward pass of packed segment-masked attention (K1) — for
// Hopper (sm_90a), f32 (the trainer's working type).
//
// Replaces: the gradient XLA derives for odigos_tpu/models/layers.py
// EncoderBlock's attention (flax dot_product_attention under the packed
// mask of :72-75 and :116-119) inside the jitted value_and_grad of
// odigos_tpu/training/trainer.py:171. The JAX package has no Pallas kernel
// here; the trainer's step on the card needs a hand-written one.
//
// For each (row r, head h), over the pairs the forward allows (key j for
// query i iff seg[i] == seg[j] > 0), with q_s = q / round(sqrt(hd)) as the
// forward scales it (a true f32 division) and the forward's per-query
// log-sum-exp (K1's f32 routes write it):
//   S = q_s . k^T,  P = exp(S - LSE),  Delta_i = sum_d dO_id * O_id,
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Delta),
//   dQ = dS . k / round(sqrt(hd)),  dK = dS^T . q_s.
// A padding query (seg 0) has no allowed key: the forward's finite fill
// gives it the uniform average of the row's L values, so here its P is
// 1 / L over every key below L and its dS is 0 (the filled scores depend on
// neither q nor k). Its dO is 0 on the trainer's path (the loss masks its
// slot), so it adds exactly 0 to dV there, and nothing reads its LSE.
// The masked pairs of a live query have P = 0 and dS = 0; keys and
// queries past L (the last tile's tail) are zero in shared memory.
//
// Three launches, no atomics (a step is reproducible):
// * delta_kernel: a warp a (row, slot, head), Delta as an f64 sum of the
//   f32 products dO * O (the plain version takes the same sum);
// * dq_kernel: a CTA a (row, head, query tile); q_s and dO of the tile
//   resident, the key tiles streamed; S and dP on CUDA cores with a block of
//   TA x TA (query, key) pairs a thread, dS staged in shared memory, then
//   dQ += dS . K with TA x DB (query, dim) outputs a thread in registers;
// * dkdv_kernel: a CTA a (row, head, key tile); K and V of the tile
//   resident, the query tiles streamed; P and dS staged, then dV += P^T dO
//   and dK += dS^T q_s with TA x DB (key, dim) outputs of each a thread.
// Tiles are B = 64 slots (B = 32 where L <= 32, so the default L = 32 wastes
// no half tile, and past hd = 128, so that four tiles of hd + 1 floats fit
// shared memory); DB 16-dim blocks a thread cover hd (4, 8 or 16).
//
// Bound on the card: bytes at the trainer's shapes (R 64, L 32, H 4, hd
// 64). The function needs q, k, v, O and the LSE at the live slots only (a
// padding query's dS is 0 and no live query reads a padding key), dO at
// every slot (a padding query adds dO / L to each dV), and writes dq, dk,
// dv in full: 10.9 MB with a step's 611 live slots of 2048 (3.3 us at
// 3.35 TB/s; the kernels read all eight arrays, 16.8 MB), while the work is
// 10 hd flops an allowed (query, key) pair (S and dP, dV, dQ, dK): at most
// 0.17 GFLOP over all L x L pairs of every (row, head), 2.5 us at 67
// TFLOP/s in f32 on CUDA cores (a tensor-core route would not be exact in
// f32, the plain version's arithmetic). The kernels recompute S and dP in
// both the dQ and the dK/dV pass and walk every pair of a tile; the measured
// times are in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 1024;
constexpr int kMaxHd = 256;
constexpr int kDynLimit = 232448;  // dynamic shared memory a block may use

// ---------------------------------------------------------------- Delta
// One warp a (r, i, h): Delta[r, h, i] = sum over d of dO * O, the f32
// products summed in f64 and rounded once.
__global__ void __launch_bounds__(kThreads)
delta_kernel(const float* __restrict__ dO, const float* __restrict__ O,
             float* __restrict__ delta, long long n, int L, int H, int hd) {
  const long long t =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (t >= n) return;
  const int lane = threadIdx.x & 31;
  const float* a = dO + t * hd;
  const float* b = O + t * hd;
  double s = 0.0;
  for (int d = lane; d < hd; d += 32) s += (double)__fmul_rn(a[d], b[d]);
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) {
    const int h = (int)(t % H);
    const long long ri = t / H;
    const int i = (int)(ri % L);
    const long long r = ri / L;
    delta[(r * H + h) * L + i] = (float)s;
  }
}

// shared floats of one CTA: four tiles of B x (hd + 1), `pt` B x (B + 1)
// tiles, the tile's LSE and Delta, then the row's L segment ids
__host__ __device__ constexpr size_t smem_bytes(int B, int hd, int L,
                                                int pt) {
  return ((size_t)4 * B * (hd + 1) + (size_t)pt * B * (B + 1) + 2 * B) * 4 +
         (size_t)L * 4;
}

// Stage rows [t0, t0 + B) of (r, h) of a (R, L, H, hd) tensor as f32 tiles
// of stride hd + 1; rows past L are zero. scale: divide by it (q_s).
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int r, int h, int t0, int B, int L,
                                      int H, int hd, float scale) {
  const int ld = hd + 1;
  for (int e = threadIdx.x; e < B * hd; e += kThreads) {
    const int l = e / hd, d = e - l * hd;
    float x = 0.f;
    if (t0 + l < L) {
      x = src[((size_t)(r * L + t0 + l) * H + h) * hd + d];
      if (scale != 0.f) x = x / scale;  // the forward's true division
    }
    dst[l * ld + d] = x;
  }
}

// The scores S and dP of queries (ty + 16 a) and keys (tx + 16 b) of two
// tiles, from q_s and dO (query tiles) and K and V (key tiles).
template <int TA>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       int hd, int tx, int ty,
                                       float (&s)[TA][TA],
                                       float (&dp)[TA][TA]) {
  const int ld = hd + 1;
#pragma unroll
  for (int a = 0; a < TA; ++a)
#pragma unroll
    for (int b = 0; b < TA; ++b) s[a][b] = dp[a][b] = 0.f;
  for (int d = 0; d < hd; ++d) {
    float qa[TA], da[TA], kb[TA], vb[TA];
#pragma unroll
    for (int a = 0; a < TA; ++a) {
      qa[a] = qs[(ty + 16 * a) * ld + d];
      da[a] = dos[(ty + 16 * a) * ld + d];
    }
#pragma unroll
    for (int b = 0; b < TA; ++b) {
      kb[b] = ks[(tx + 16 * b) * ld + d];
      vb[b] = vs[(tx + 16 * b) * ld + d];
    }
#pragma unroll
    for (int a = 0; a < TA; ++a)
#pragma unroll
      for (int b = 0; b < TA; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        dp[a][b] = fmaf(da[a], vb[b], dp[a][b]);
      }
  }
}

// ------------------------------------------------------------------- dQ
template <int B, int DB>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const int32_t* __restrict__ seg,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const float* __restrict__ dO, float* __restrict__ dq, int L, int H,
          int hd, float scale_div) {
  constexpr int TA = B / 16;
  constexpr int SLD = B + 1;
  extern __shared__ float dq_smem[];
  const int ld = hd + 1;
  float* qs = dq_smem;
  float* dos = qs + B * ld;
  float* ks = dos + B * ld;
  float* vs = ks + B * ld;
  float* dss = vs + B * ld;
  float* lse_s = dss + B * SLD;
  float* dl_s = lse_s + B;
  int* segs = reinterpret_cast<int*>(dl_s + B);

  const int nqb = (L + B - 1) / B;
  const int r = blockIdx.x / (H * nqb);
  const int rem = blockIdx.x - r * H * nqb;
  const int h = rem / nqb;
  const int q0 = (rem - h * nqb) * B;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int l = tid; l < L; l += kThreads) segs[l] = seg[(size_t)r * L + l];
  stage(qs, q, r, h, q0, B, L, H, hd, scale_div);
  stage(dos, dO, r, h, q0, B, L, H, hd, 0.f);
  for (int l = tid; l < B; l += kThreads) {
    const bool in = q0 + l < L;
    lse_s[l] = in ? lse[((size_t)r * H + h) * L + q0 + l] : 0.f;
    dl_s[l] = in ? delta[((size_t)r * H + h) * L + q0 + l] : 0.f;
  }

  float acc[TA][DB];
#pragma unroll
  for (int a = 0; a < TA; ++a)
#pragma unroll
    for (int c = 0; c < DB; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < L; k0 += B) {
    __syncthreads();  // the previous key tile and dS are consumed
    stage(ks, k, r, h, k0, B, L, H, hd, 0.f);
    stage(vs, v, r, h, k0, B, L, H, hd, 0.f);
    __syncthreads();
    float s[TA][TA], dp[TA][TA];
    scores<TA>(qs, dos, ks, vs, hd, tx, ty, s, dp);
#pragma unroll
    for (int a = 0; a < TA; ++a) {
      const int li = ty + 16 * a;
      const int i = q0 + li;
      const int si = i < L ? segs[i] : 0;
#pragma unroll
      for (int b = 0; b < TA; ++b) {
        const int j = k0 + tx + 16 * b;
        float ds = 0.f;
        if (si > 0 && j < L && segs[j] == si) {
          const float p = expf(s[a][b] - lse_s[li]);
          ds = p * (dp[a][b] - dl_s[li]);
        }
        dss[li * SLD + tx + 16 * b] = ds;
      }
    }
    __syncthreads();
    // dQ += dS . K for queries ty + 16 a, dims tx + 16 c
    for (int j = 0; j < B; ++j) {
      float da[TA], kc[DB];
#pragma unroll
      for (int a = 0; a < TA; ++a) da[a] = dss[(ty + 16 * a) * SLD + j];
#pragma unroll
      for (int c = 0; c < DB; ++c) {
        const int d = tx + 16 * c;
        kc[c] = d < hd ? ks[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < TA; ++a)
#pragma unroll
        for (int c = 0; c < DB; ++c) acc[a][c] = fmaf(da[a], kc[c], acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < TA; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= L) continue;
#pragma unroll
    for (int c = 0; c < DB; ++c) {
      const int d = tx + 16 * c;
      if (d < hd)
        dq[((size_t)(r * L + i) * H + h) * hd + d] = acc[a][c] / scale_div;
    }
  }
}

// --------------------------------------------------------------- dK, dV
template <int B, int DB>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const int32_t* __restrict__ seg,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const float* __restrict__ dO, float* __restrict__ dk,
            float* __restrict__ dv, int L, int H, int hd, float scale_div,
            float inv_L) {
  constexpr int TA = B / 16;
  constexpr int SLD = B + 1;
  extern __shared__ float kv_smem[];
  const int ld = hd + 1;
  float* ks = kv_smem;
  float* vs = ks + B * ld;
  float* qs = vs + B * ld;
  float* dos = qs + B * ld;
  float* ps = dos + B * ld;
  float* dss = ps + B * SLD;
  float* lse_s = dss + B * SLD;
  float* dl_s = lse_s + B;
  int* segs = reinterpret_cast<int*>(dl_s + B);

  const int nkb = (L + B - 1) / B;
  const int r = blockIdx.x / (H * nkb);
  const int rem = blockIdx.x - r * H * nkb;
  const int h = rem / nkb;
  const int k0 = (rem - h * nkb) * B;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int l = tid; l < L; l += kThreads) segs[l] = seg[(size_t)r * L + l];
  stage(ks, k, r, h, k0, B, L, H, hd, 0.f);
  stage(vs, v, r, h, k0, B, L, H, hd, 0.f);

  float gk[TA][DB], gv[TA][DB];
#pragma unroll
  for (int a = 0; a < TA; ++a)
#pragma unroll
    for (int c = 0; c < DB; ++c) gk[a][c] = gv[a][c] = 0.f;

  for (int q0 = 0; q0 < L; q0 += B) {
    __syncthreads();  // the previous query tile, P and dS are consumed
    stage(qs, q, r, h, q0, B, L, H, hd, scale_div);
    stage(dos, dO, r, h, q0, B, L, H, hd, 0.f);
    for (int l = tid; l < B; l += kThreads) {
      const bool in = q0 + l < L;
      lse_s[l] = in ? lse[((size_t)r * H + h) * L + q0 + l] : 0.f;
      dl_s[l] = in ? delta[((size_t)r * H + h) * L + q0 + l] : 0.f;
    }
    __syncthreads();
    // queries ty + 16 a of the tile, keys tx + 16 b of this CTA's tile
    float s[TA][TA], dp[TA][TA];
    scores<TA>(qs, dos, ks, vs, hd, tx, ty, s, dp);
#pragma unroll
    for (int a = 0; a < TA; ++a) {
      const int li = ty + 16 * a;
      const int i = q0 + li;
#pragma unroll
      for (int b = 0; b < TA; ++b) {
        const int j = k0 + tx + 16 * b;
        float p = 0.f, ds = 0.f;
        if (i < L && j < L) {
          const int si = segs[i];
          if (si == 0) {
            p = inv_L;  // the finite fill's uniform weights; dS = 0
          } else if (segs[j] == si) {
            p = expf(s[a][b] - lse_s[li]);
            ds = p * (dp[a][b] - dl_s[li]);
          }
        }
        ps[li * SLD + tx + 16 * b] = p;
        dss[li * SLD + tx + 16 * b] = ds;
      }
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T q_s for keys ty + 16 a, dims tx + 16 c
    for (int i = 0; i < B; ++i) {
      float pa[TA], da[TA], oc[DB], qc[DB];
#pragma unroll
      for (int a = 0; a < TA; ++a) {
        pa[a] = ps[i * SLD + ty + 16 * a];
        da[a] = dss[i * SLD + ty + 16 * a];
      }
#pragma unroll
      for (int c = 0; c < DB; ++c) {
        const int d = tx + 16 * c;
        oc[c] = d < hd ? dos[i * ld + d] : 0.f;
        qc[c] = d < hd ? qs[i * ld + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < TA; ++a)
#pragma unroll
        for (int c = 0; c < DB; ++c) {
          gv[a][c] = fmaf(pa[a], oc[c], gv[a][c]);
          gk[a][c] = fmaf(da[a], qc[c], gk[a][c]);
        }
    }
  }
#pragma unroll
  for (int a = 0; a < TA; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= L) continue;
#pragma unroll
    for (int c = 0; c < DB; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) {
        const size_t g = ((size_t)(r * L + j) * H + h) * hd + d;
        dk[g] = gk[a][c];
        dv[g] = gv[a][c];
      }
    }
  }
}

template <int B, int DB>
cudaError_t launch_tiles(const float* q, const float* k, const float* v,
                         const int32_t* seg, const float* lse,
                         const float* delta, const float* dO, float* dq,
                         float* dk, float* dv, int R, int L, int H, int hd,
                         float scale_div, cudaStream_t st) {
  const size_t dq_bytes = smem_bytes(B, hd, L, 1);
  const size_t kv_bytes = smem_bytes(B, hd, L, 2);
  if (kv_bytes > (size_t)kDynLimit) return cudaErrorInvalidValue;
  // the attribute is cheap to set; set it every launch (no device cache)
  cudaError_t e = cudaFuncSetAttribute(
      dq_kernel<B, DB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dkdv_kernel<B, DB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_bytes);
  if (e != cudaSuccess) return e;
  const long long grid = (long long)R * H * ((L + B - 1) / B);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  dq_kernel<B, DB><<<(unsigned)grid, kThreads, dq_bytes, st>>>(
      q, k, v, seg, lse, delta, dO, dq, L, H, hd, scale_div);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv_kernel<B, DB><<<(unsigned)grid, kThreads, kv_bytes, st>>>(
      q, k, v, seg, lse, delta, dO, dk, dv, L, H, hd, scale_div,
      1.0f / (float)L);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, dO, dq, dk, dv: contiguous (R, L, H, hd) f32; seg: (R, L)
// int32; lse: (R, H, L) f32 from K1's f32 routes; delta: an (R, H, L) f32
// scratch. L <= 1024, hd <= 256. Checked by the Python wrapper too.
extern "C" int segment_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* seg,
    const void* o, const void* lse, const void* dO, void* delta, void* dq,
    void* dk, void* dv, int R, int L, int H, int hd, float scale_div,
    void* stream) {
  if (R <= 0 || L <= 0 || H <= 0 || hd <= 0 || L > kMaxL || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)R * L * H;
  const long long blocks = (n + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(v);
  const auto* ss = static_cast<const int32_t*>(seg);
  const auto* ll = static_cast<const float*>(lse);
  const auto* gg = static_cast<const float*>(dO);
  auto* dl = static_cast<float*>(delta);
  delta_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      gg, static_cast<const float*>(o), dl, n, L, H, hd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto* a = static_cast<float*>(dq);
  auto* b = static_cast<float*>(dk);
  auto* c = static_cast<float*>(dv);
  if (hd <= 64) {
    if (L <= 32)
      return (int)launch_tiles<32, 4>(qq, kk, vv, ss, ll, dl, gg, a, b, c, R,
                                      L, H, hd, scale_div, st);
    return (int)launch_tiles<64, 4>(qq, kk, vv, ss, ll, dl, gg, a, b, c, R, L,
                                    H, hd, scale_div, st);
  }
  if (hd <= 128) {
    if (L <= 32)
      return (int)launch_tiles<32, 8>(qq, kk, vv, ss, ll, dl, gg, a, b, c, R,
                                      L, H, hd, scale_div, st);
    return (int)launch_tiles<64, 8>(qq, kk, vv, ss, ll, dl, gg, a, b, c, R, L,
                                    H, hd, scale_div, st);
  }
  return (int)launch_tiles<32, 16>(qq, kk, vv, ss, ll, dl, gg, a, b, c, R, L,
                                   H, hd, scale_div, st);
}
