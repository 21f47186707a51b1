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
//
// Every output is one f32 chain in a fixed order, the same on both routes:
// S and dP fmaf over d ascending from 0; dQ over keys ascending, then the
// division; dK and dV over queries ascending; Delta the f32 products dO * O
// summed in f64, lane-strided over a warp (lane k holds d = k, k + 32, ...)
// then a butterfly, rounded once. Only terms that are exactly zero are left
// out: the masked pairs (P = dS = 0), and padding queries whose dO row is
// all zero (1/L * 0). An accumulator that starts at +0 never becomes -0
// (a zero sum rounds to +0), so fmaf(0, x, acc) == acc and leaving such a
// term out keeps the bits. No atomics: a step is reproducible.
//
// One launch a call, on one of two routes:
// * one_cta_kernel (L <= kOneMaxL, hd <= kOneMaxHd, hd % 4 == 0, 16-byte
//   aligned tensors; both trainers' L 32, hd 64): a CTA a (row, head). Warp
//   0 reads the row's segments and lists its live slots by ballots; q_s, k,
//   v and O at the live slots and dO at every slot are staged once as
//   16-byte vectors; Delta a warp a live query; S and dP once, a thread a
//   pair of the live list's same-segment pairs, P and dS kept in shared
//   memory; then dQ, dK and dV, a thread 4 dims of a live slot, each over
//   the live list's same-segment entries. Padding rows are written as zero
//   vectors, or, where some padding query's dO is not zero, dV walks every
//   query of the row. The limit keeps the five staged (L, hd + 4) tiles, P
//   and dS of the largest shape in one CTA's shared memory (204 KB of 227 at
//   L 64, hd 128; 52 KB at the trainers' shape, four CTAs an SM).
// * tiled_kernel (past that, L <= 1024, hd <= 256): dQ CTAs, a (row, head,
//   query tile) each, and dK/dV CTAs, a (row, head, key tile) each, in one
//   grid. A CTA computes Delta for the query tiles it reads (a warp a live
//   query), walks only the tile pairs whose live segment ranges overlap
//   (and, for dV, the query tiles holding a padding query with a nonzero
//   dO), and recomputes S and dP there on CUDA cores: a thread TA x TA
//   (query, key) pairs, reading its rows as 16-byte vectors from tiles of
//   pitch hd + 4 (an odd count of vectors: conflict-free); dQ, dK and dV
//   with TA x 4G (slot, dim) outputs a thread in registers, dims 4 tx + 64 g.
//   Tiles are B = 64 slots at hd <= 64 past L 32, else 32 (two CTAs an SM
//   at hd 128).
//
// Bound on the card: bytes at the trainer's shapes (R 64, L 32, H 4, hd
// 64). The function needs q, k, v, O and the LSE at the live slots only (a
// padding query's dS is 0 and no live query reads a padding key), dO at
// every slot (a padding query adds dO / L to each dV), and writes dq, dk,
// dv in full: 10.9 MB with a step's 611 live slots of 2048 (3.3 us at
// 3.35 TB/s), while the work is 10 hd flops an allowed (query, key) pair
// (S and dP, dV, dQ, dK): at most 0.17 GFLOP over all L x L pairs of every
// (row, head), 2.5 us at 67 TFLOP/s in f32 on CUDA cores. The one-CTA route
// reads what the function needs and computes each allowed pair once; the
// measured times are in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"  // DeviceOnce, max_smem_once

namespace {

constexpr int kMaxL = 1024;
constexpr int kMaxHd = 256;
constexpr int kDynLimit = 232448;  // dynamic shared memory a block may use
constexpr unsigned kFull = 0xffffffffu;

// The pitch of a staged row in floats: hd rounded up to 4, then an odd
// count of 16-byte vectors, so the 8 rows a quarter-warp reads as vectors
// start in 8 distinct groups of 4 banks.
__host__ __device__ inline int row_pitch(int hd) {
  const int hp = (hd + 3) & ~3;
  return (hp % 8 == 4) ? hp : hp + 4;
}

// Delta of one query, a warp: sum over d of dO * O, the f32 products added
// in f64 lane-strided then by a butterfly, rounded once. `dos` is the
// query's staged dO row, `orow` its O row (shared or global).
__device__ __forceinline__ float delta_warp(const float* dos,
                                            const float* orow, int hd,
                                            int lane) {
  double s = 0.0;
  for (int d = lane; d < hd; d += 32) s += (double)__fmul_rn(dos[d], orow[d]);
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return (float)s;
}

__device__ __forceinline__ float4 fma4(float a, float4 b, float4 c) {
  c.x = fmaf(a, b.x, c.x);
  c.y = fmaf(a, b.y, c.y);
  c.z = fmaf(a, b.z, c.z);
  c.w = fmaf(a, b.w, c.w);
  return c;
}

// s + a . b over 4 dims, in order
__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ float4 div4(float4 x, float s) {
  x.x = x.x / s;  // the forward's true division
  x.y = x.y / s;
  x.z = x.z / s;
  x.w = x.w / s;
  return x;
}

// ============================================================ one CTA
constexpr int kOneThreads = 256;
constexpr int kOneMaxL = 64;
constexpr int kOneMaxHd = 128;

// shared bytes: q_s, k, v, O, dO as (L, pitch) tiles; P and dS (L, L + 1);
// the live queries' LSE and Delta; ints: segments, live list, slot ->
// live index, live segments
__host__ __device__ constexpr size_t one_smem_bytes(int L, int ld) {
  return ((size_t)5 * L * ld + (size_t)2 * L * (L + 1) + 2 * (size_t)L) * 4 +
         (size_t)4 * L * 4;
}

__global__ void __launch_bounds__(kOneThreads)
one_cta_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int32_t* __restrict__ seg,
               const float* __restrict__ o, const float* __restrict__ lse,
               const float* __restrict__ dO, float* __restrict__ dq,
               float* __restrict__ dk, float* __restrict__ dv, int L, int H,
               int hd, float scale_div, float inv_L) {
  extern __shared__ float4 one_smem[];
  const int ld = row_pitch(hd);
  const int h4 = hd >> 2;
  const int PL = L + 1;  // P and dS row pitch
  float* qs = reinterpret_cast<float*>(one_smem);
  float* ks = qs + L * ld;
  float* vs = ks + L * ld;
  float* os = vs + L * ld;
  float* dos = os + L * ld;
  float* ps = dos + L * ld;
  float* dss = ps + L * PL;
  float* lse_s = dss + L * PL;
  float* dl_s = lse_s + L;
  int* segs = reinterpret_cast<int*>(dl_s + L);
  int* live = segs + L;   // live index -> slot, slots ascending
  int* cidx = live + L;   // slot -> live index, -1 at padding
  int* segc = cidx + L;   // live index -> segment
  __shared__ int n_live, pad_dO;

  const int r = blockIdx.x / H;
  const int h = blockIdx.x - r * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (size_t)r * L;

  auto gvec = [&](const float* base, int l) {
    return reinterpret_cast<const float4*>(base) +
           ((row0 + l) * H + h) * (size_t)h4;
  };
  // ---- dO at every slot (16-byte vectors) by warps 1.., while warp 0
  // reads the row's segments and lists its live slots (ballots in order)
  if (warp > 0) {
#pragma unroll 4
    for (int e = tid - 32; e < L * h4; e += kOneThreads - 32) {
      const int l = e / h4, c4 = e - l * h4;
      reinterpret_cast<float4*>(dos + l * ld)[c4] = gvec(dO, l)[c4];
    }
  } else {
    int nl = 0;
    for (int base = 0; base < L; base += 32) {
      const int l = base + lane;
      const int s = l < L ? seg[row0 + l] : 0;
      const unsigned m = __ballot_sync(kFull, s > 0);
      if (l < L) {
        segs[l] = s;
        const int c = nl + __popc(m & ((1u << lane) - 1u));
        cidx[l] = s > 0 ? c : -1;
        if (s > 0) {
          live[c] = l;
          segc[c] = s;
        }
      }
      nl += __popc(m);
    }
    if (lane == 0) {
      n_live = nl;
      pad_dO = 0;
    }
  }
  __syncthreads();
  const int nl = n_live;

  // ---- stage q_s, k, v, O at the live slots (16-byte vectors), and the
  // live queries' LSE
  for (int e = tid; e < nl * h4; e += kOneThreads) {
    const int c = e / h4, c4 = e - c * h4;
    const int l = live[c];
    const float4 xq = gvec(q, l)[c4];
    const float4 xk = gvec(k, l)[c4];
    const float4 xv = gvec(v, l)[c4];
    const float4 xo = gvec(o, l)[c4];
    reinterpret_cast<float4*>(qs + l * ld)[c4] = div4(xq, scale_div);
    reinterpret_cast<float4*>(ks + l * ld)[c4] = xk;
    reinterpret_cast<float4*>(vs + l * ld)[c4] = xv;
    reinterpret_cast<float4*>(os + l * ld)[c4] = xo;
  }
  for (int c = tid; c < nl; c += kOneThreads)
    lse_s[c] = lse[((size_t)r * H + h) * L + live[c]];
  __syncthreads();

  // ---- Delta a warp a live query; padding queries with a nonzero dO
  for (int c = warp; c < nl; c += kOneThreads / 32) {
    const int l = live[c];
    const float dl = delta_warp(dos + l * ld, os + l * ld, hd, lane);
    if (lane == 0) dl_s[c] = dl;
  }
  for (int l = warp; l < L; l += kOneThreads / 32) {
    if (segs[l] > 0) continue;  // warp-uniform
    bool nz = false;
    for (int d = lane; d < hd; d += 32) nz |= dos[l * ld + d] != 0.f;
    if (__any_sync(kFull, nz) && lane == 0) pad_dO = 1;
  }

  // ---- S and dP once for each same-segment pair of the live list (zero
  // for the other pairs), then, past the barrier that also ends Delta, P
  // and dS in their place
  for (int t = tid; t < nl * nl; t += kOneThreads) {
    const int a = t / nl, b = t - a * nl;
    float p = 0.f, ds = 0.f;
    if (segc[a] == segc[b]) {
      const float4* qa = reinterpret_cast<const float4*>(qs + live[a] * ld);
      const float4* da = reinterpret_cast<const float4*>(dos + live[a] * ld);
      const float4* kb = reinterpret_cast<const float4*>(ks + live[b] * ld);
      const float4* vb = reinterpret_cast<const float4*>(vs + live[b] * ld);
      float s = 0.f, dp = 0.f;
#pragma unroll 4
      for (int d4 = 0; d4 < h4; ++d4) {
        s = dot4(qa[d4], kb[d4], s);
        dp = dot4(da[d4], vb[d4], dp);
      }
      p = s;
      ds = dp;
    }
    ps[a * PL + b] = p;
    dss[a * PL + b] = ds;
  }
  __syncthreads();
  for (int t = tid; t < nl * nl; t += kOneThreads) {
    const int a = t / nl, b = t - a * nl;
    if (segc[a] != segc[b]) continue;
    const float p = expf(ps[a * PL + b] - lse_s[a]);
    ps[a * PL + b] = p;
    dss[a * PL + b] = p * (dss[a * PL + b] - dl_s[a]);
  }
  __syncthreads();

  // ---- dQ, dK, dV at the live slots, a thread 4 dims of a slot
  const bool walk_all = pad_dO != 0;
  for (int e = tid; e < nl * h4; e += kOneThreads) {
    const int c = e / h4, c4 = e - c * h4;
    const int sx = segc[c];
    float4 aq = make_float4(0.f, 0.f, 0.f, 0.f), ak = aq, av = aq;
    for (int b = 0; b < nl; ++b) {
      if (segc[b] != sx) continue;
      const int lb = live[b];
      aq = fma4(dss[c * PL + b], reinterpret_cast<const float4*>(
                                     ks + lb * ld)[c4], aq);
      ak = fma4(dss[b * PL + c], reinterpret_cast<const float4*>(
                                     qs + lb * ld)[c4], ak);
      if (!walk_all)
        av = fma4(ps[b * PL + c], reinterpret_cast<const float4*>(
                                      dos + lb * ld)[c4], av);
    }
    const int l = live[c];
    const size_t g = ((row0 + l) * H + h) * (size_t)h4 + c4;
    reinterpret_cast<float4*>(dq)[g] = div4(aq, scale_div);
    reinterpret_cast<float4*>(dk)[g] = ak;
    if (!walk_all) reinterpret_cast<float4*>(dv)[g] = av;
  }
  // padding slots: dQ and dK are 0; dV too unless a padding dO is not
  for (int e = tid; e < L * h4; e += kOneThreads) {
    const int l = e / h4, c4 = e - l * h4;
    if (segs[l] > 0) continue;
    const size_t g = ((row0 + l) * H + h) * (size_t)h4 + c4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(dq)[g] = z;
    reinterpret_cast<float4*>(dk)[g] = z;
    if (!walk_all) reinterpret_cast<float4*>(dv)[g] = z;
  }
  if (!walk_all) return;
  // dV of every slot over every query in order: P of a same-segment live
  // query, 1 / L of a padding query
  for (int e = tid; e < L * h4; e += kOneThreads) {
    const int x = e / h4, c4 = e - x * h4;
    const int sx = segs[x], cx = cidx[x];
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < L; ++i) {
      const int si = segs[i];
      float p;
      if (si <= 0)
        p = inv_L;
      else if (si == sx)
        p = ps[cidx[i] * PL + cx];
      else
        continue;
      av = fma4(p, reinterpret_cast<const float4*>(dos + i * ld)[c4], av);
    }
    reinterpret_cast<float4*>(dv)[((row0 + x) * H + h) * (size_t)h4 + c4] =
        av;
  }
}

// ============================================================== tiled
constexpr int kTileThreads = 256;
constexpr int kMaxTiles = 32;  // a row's tiles of the least size, 32
static_assert(kMaxTiles * 32 == kMaxL, "a row's tiles");

// shared bytes of one CTA: four (B, pitch) tiles, P and dS (B, B + 1), the
// tile's LSE and Delta, the row's segments, each tile's live segment range
// and padding-dO flag
__host__ __device__ constexpr size_t tile_smem_bytes(int B, int ld, int L) {
  return ((size_t)4 * B * ld + (size_t)2 * B * (B + 1) + 2 * (size_t)B) * 4 +
         (size_t)L * 4 + (size_t)3 * kMaxTiles * 4;
}

// Rows [t0, t0 + B) of (r, h) of an (R, L, H, hd) tensor as f32 rows of
// pitch ld: zero past L and past hd. scale: divide by it (q_s), or 0.
__device__ __forceinline__ void stage_tile(float* dst,
                                           const float* __restrict__ src,
                                           int r, int h, int t0, int B, int L,
                                           int H, int hd, int ld, float scale,
                                           bool vec) {
  if (vec) {  // hd % 4 == 0, 16-byte aligned
    const int ld4 = ld >> 2, h4 = hd >> 2;
    for (int e = threadIdx.x; e < B * ld4; e += kTileThreads) {
      const int l = e / ld4, c4 = e - l * ld4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t0 + l < L && c4 < h4) {
        x = reinterpret_cast<const float4*>(src)
            [((size_t)(r * L + t0 + l) * H + h) * h4 + c4];
        if (scale != 0.f) x = div4(x, scale);
      }
      reinterpret_cast<float4*>(dst)[e] = x;
    }
    return;
  }
  for (int e = threadIdx.x; e < B * ld; e += kTileThreads) {
    const int l = e / ld, d = e - l * ld;
    float x = 0.f;
    if (t0 + l < L && d < hd) {
      x = src[((size_t)(r * L + t0 + l) * H + h) * hd + d];
      if (scale != 0.f) x = x / scale;
    }
    dst[e] = x;
  }
}

// S and dP of queries (ty + 16 a) and keys (tx + 16 b) of two staged tiles
template <int TA>
__device__ __forceinline__ void tile_scores(const float* qs, const float* dos,
                                            const float* ks, const float* vs,
                                            int ld, int hp4, int tx, int ty,
                                            float (&s)[TA][TA],
                                            float (&dp)[TA][TA]) {
#pragma unroll
  for (int a = 0; a < TA; ++a)
#pragma unroll
    for (int b = 0; b < TA; ++b) s[a][b] = dp[a][b] = 0.f;
  for (int d4 = 0; d4 < hp4; ++d4) {
    float4 qa[TA], da[TA];
#pragma unroll
    for (int a = 0; a < TA; ++a) {
      qa[a] = reinterpret_cast<const float4*>(qs + (ty + 16 * a) * ld)[d4];
      da[a] = reinterpret_cast<const float4*>(dos + (ty + 16 * a) * ld)[d4];
    }
#pragma unroll
    for (int b = 0; b < TA; ++b) {
      const float4 kb =
          reinterpret_cast<const float4*>(ks + (tx + 16 * b) * ld)[d4];
      const float4 vb =
          reinterpret_cast<const float4*>(vs + (tx + 16 * b) * ld)[d4];
#pragma unroll
      for (int a = 0; a < TA; ++a) {
        s[a][b] = dot4(qa[a], kb, s[a][b]);
        dp[a][b] = dot4(da[a], vb, dp[a][b]);
      }
    }
  }
}

// the 4 dims 4 tx + 64 g of a staged row (zero past the padded width)
__device__ __forceinline__ float4 dims4(const float* row, int g, int tx,
                                        int hp) {
  const int d = 64 * g + 4 * tx;
  return d < hp ? *reinterpret_cast<const float4*>(row + d)
                : make_float4(0.f, 0.f, 0.f, 0.f);
}

// store the 4 dims 4 tx + 64 g of slot row `grow` (global element offset
// of the row), those below hd
__device__ __forceinline__ void store4(float* dst, size_t grow, int g, int tx,
                                       int hd, float4 x, bool vec) {
  const int d = 64 * g + 4 * tx;
  if (vec) {
    if (d < hd) *reinterpret_cast<float4*>(dst + grow + d) = x;
    return;
  }
  const float w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (d + c < hd) dst[grow + d + c] = w[c];
}

template <int B, int G>
__global__ void __launch_bounds__(kTileThreads, 2)
tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int32_t* __restrict__ seg,
             const float* __restrict__ o, const float* __restrict__ lse,
             const float* __restrict__ dO, float* __restrict__ dq,
             float* __restrict__ dk, float* __restrict__ dv, int L, int H,
             int hd, float scale_div, float inv_L, int n_kv, bool vec) {
  constexpr int TA = B / 16;
  constexpr int SLD = B + 1;
  extern __shared__ float4 tile_smem[];
  const int ld = row_pitch(hd);
  const int hp = (hd + 3) & ~3;
  const int hp4 = hp >> 2;
  const int nt = (L + B - 1) / B;
  float* t0s = reinterpret_cast<float*>(tile_smem);
  float* t1s = t0s + B * ld;
  float* t2s = t1s + B * ld;
  float* t3s = t2s + B * ld;
  float* ps = t3s + B * ld;
  float* dss = ps + B * SLD;
  float* lse_s = dss + B * SLD;
  float* dl_s = lse_s + B;
  int* segs = reinterpret_cast<int*>(dl_s + B);
  int* tlo = segs + L;        // each tile's least live segment
  int* thi = tlo + kMaxTiles;  // ... and greatest (thi < tlo: none)
  int* tpad = thi + kMaxTiles;  // a padding query with a nonzero dO

  const bool kv_role = (int)blockIdx.x < n_kv;
  const int idx = kv_role ? blockIdx.x : blockIdx.x - n_kv;
  const int r = idx / (H * nt);
  const int rem = idx - r * H * nt;
  const int h = rem / nt;
  const int own = (rem - h * nt) * B;  // this CTA's query or key tile
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (size_t)r * L;

  for (int l = tid; l < L; l += kTileThreads) segs[l] = seg[row0 + l];
  for (int t = tid; t < nt; t += kTileThreads) tpad[t] = 0;
  __syncthreads();
  for (int t = warp; t < nt; t += kTileThreads / 32) {
    int lo = 0x7fffffff, hi = 0;
    for (int l = t * B + lane; l < min(L, t * B + B); l += 32) {
      const int s = segs[l];
      if (s > 0) {
        lo = min(lo, s);
        hi = max(hi, s);
      }
    }
    for (int x = 16; x; x >>= 1) {
      lo = min(lo, __shfl_xor_sync(kFull, lo, x));
      hi = max(hi, __shfl_xor_sync(kFull, hi, x));
    }
    if (lane == 0) {
      tlo[t] = lo;
      thi[t] = hi;
    }
  }
  if (kv_role) {  // padding queries whose dO is not all zero, a warp each
    for (int l = warp; l < L; l += kTileThreads / 32) {
      if (segs[l] > 0) continue;  // warp-uniform
      const float* row = dO + ((row0 + l) * H + h) * hd;
      bool nz = false;
      for (int d = lane; d < hd; d += 32) nz |= row[d] != 0.f;
      if (__any_sync(kFull, nz) && lane == 0)
        tpad[l / B] = 1;  // the same value from every writer
    }
  }
  __syncthreads();
  const int my_t = own / B;
  auto overlap = [&](int a, int b) {
    return tlo[a] <= thi[a] && tlo[b] <= thi[b] && tlo[a] <= thi[b] &&
           tlo[b] <= thi[a];
  };

  // LSE and Delta of the live queries of query tile q0 (staged dO in t1s)
  auto tile_delta = [&](int q0) {
    for (int l = warp; l < B; l += kTileThreads / 32) {
      const int i = q0 + l;
      if (i >= L || segs[i] <= 0) continue;
      const float dl = delta_warp(t1s + l * ld, o + ((row0 + i) * H + h) * hd,
                                  hd, lane);
      if (lane == 0) {
        dl_s[l] = dl;
        lse_s[l] = lse[((size_t)r * H + h) * L + i];
      }
    }
  };

  float4 acc0[TA][G], acc1[TA][G];
#pragma unroll
  for (int a = 0; a < TA; ++a)
#pragma unroll
    for (int g = 0; g < G; ++g)
      acc0[a][g] = acc1[a][g] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (!kv_role) {
    // ---------------------------------------------------------- dQ
    // t0s q_s, t1s dO of the own query tile; t2s k, t3s v streamed
    const int q0 = own;
    if (tlo[my_t] <= thi[my_t]) {
      stage_tile(t0s, q, r, h, q0, B, L, H, hd, ld, scale_div, vec);
      stage_tile(t1s, dO, r, h, q0, B, L, H, hd, ld, 0.f, vec);
      __syncthreads();
      tile_delta(q0);
      for (int kt = 0; kt < nt; ++kt) {
        if (!overlap(my_t, kt)) continue;
        const int k0 = kt * B;
        __syncthreads();  // the previous key tile and dS are consumed
        stage_tile(t2s, k, r, h, k0, B, L, H, hd, ld, 0.f, vec);
        stage_tile(t3s, v, r, h, k0, B, L, H, hd, ld, 0.f, vec);
        __syncthreads();
        float s[TA][TA], dp[TA][TA];
        tile_scores<TA>(t0s, t1s, t2s, t3s, ld, hp4, tx, ty, s, dp);
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
        for (int j = 0; j < B; ++j) {
          float da[TA];
#pragma unroll
          for (int a = 0; a < TA; ++a) da[a] = dss[(ty + 16 * a) * SLD + j];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 kc = dims4(t2s + j * ld, g, tx, hp);
#pragma unroll
            for (int a = 0; a < TA; ++a)
              acc0[a][g] = fma4(da[a], kc, acc0[a][g]);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < TA; ++a) {
      const int i = q0 + ty + 16 * a;
      if (i >= L) continue;
#pragma unroll
      for (int g = 0; g < G; ++g)
        store4(dq, ((row0 + i) * H + h) * hd, g, tx, hd,
               div4(acc0[a][g], scale_div), vec);
    }
    return;
  }

  // ------------------------------------------------------------ dK, dV
  // t2s k, t3s v of the own key tile; t0s q_s, t1s dO streamed
  const int k0 = own;
  stage_tile(t2s, k, r, h, k0, B, L, H, hd, ld, 0.f, vec);
  stage_tile(t3s, v, r, h, k0, B, L, H, hd, ld, 0.f, vec);
  for (int qt = 0; qt < nt; ++qt) {
    if (!overlap(qt, my_t) && !tpad[qt]) continue;
    const int q0 = qt * B;
    __syncthreads();  // the previous query tile, P and dS are consumed
    stage_tile(t0s, q, r, h, q0, B, L, H, hd, ld, scale_div, vec);
    stage_tile(t1s, dO, r, h, q0, B, L, H, hd, ld, 0.f, vec);
    __syncthreads();
    tile_delta(q0);
    __syncthreads();
    float s[TA][TA], dp[TA][TA];
    tile_scores<TA>(t0s, t1s, t2s, t3s, ld, hp4, tx, ty, s, dp);
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
          if (si <= 0) {
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
    for (int i = 0; i < B; ++i) {
      float pa[TA], da[TA];
#pragma unroll
      for (int a = 0; a < TA; ++a) {
        pa[a] = ps[i * SLD + ty + 16 * a];
        da[a] = dss[i * SLD + ty + 16 * a];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 oc = dims4(t1s + i * ld, g, tx, hp);
        const float4 qc = dims4(t0s + i * ld, g, tx, hp);
#pragma unroll
        for (int a = 0; a < TA; ++a) {
          acc1[a][g] = fma4(pa[a], oc, acc1[a][g]);  // dV
          acc0[a][g] = fma4(da[a], qc, acc0[a][g]);  // dK
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < TA; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= L) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const size_t grow = ((row0 + j) * H + h) * hd;
      store4(dk, grow, g, tx, hd, acc0[a][g], vec);
      store4(dv, grow, g, tx, hd, acc1[a][g], vec);
    }
  }
}

DeviceOnce g_one_once;

template <int B, int G>
cudaError_t launch_tiled(const float* q, const float* k, const float* v,
                         const int32_t* seg, const float* o, const float* lse,
                         const float* dO, float* dq, float* dk, float* dv,
                         int R, int L, int H, int hd, float scale_div,
                         bool vec, cudaStream_t st) {
  static DeviceOnce once;
  const int ld = row_pitch(hd);
  const size_t bytes = tile_smem_bytes(B, ld, L);
  if (bytes > (size_t)kDynLimit) return cudaErrorInvalidValue;
  // the largest this instance takes (hd 64 G, L 1024), set once a device
  cudaError_t e = max_smem_once(
      once, tiled_kernel<B, G>,
      (int)tile_smem_bytes(B, row_pitch(64 * G), kMaxL));
  if (e != cudaSuccess) return e;
  const long long n_kv = (long long)R * H * ((L + B - 1) / B);
  if (2 * n_kv > 0x7fffffffLL) return cudaErrorInvalidValue;
  tiled_kernel<B, G><<<(unsigned)(2 * n_kv), kTileThreads, bytes, st>>>(
      q, k, v, seg, o, lse, dO, dq, dk, dv, L, H, hd, scale_div,
      1.0f / (float)L, (int)n_kv, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// 0: the one-CTA route takes (L, hd) with 16-byte aligned tensors, else 1
extern "C" int segment_attention_bwd_route(int L, int hd, int aligned) {
  return (L <= kOneMaxL && hd <= kOneMaxHd && hd % 4 == 0 && aligned) ? 0
                                                                         : 1;
}

// q, k, v, o, dO, dq, dk, dv: contiguous (R, L, H, hd) f32; seg: (R, L)
// int32; lse: (R, H, L) f32 from K1's f32 routes. L <= 1024, hd <= 256.
// Checked by the Python wrapper too. One launch.
extern "C" int segment_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* seg,
    const void* o, const void* lse, const void* dO, void* dq, void* dk,
    void* dv, int R, int L, int H, int hd, float scale_div, void* stream) {
  if (R <= 0 || L <= 0 || H <= 0 || hd <= 0 || L > kMaxL || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(v);
  const auto* ss = static_cast<const int32_t*>(seg);
  const auto* oo = static_cast<const float*>(o);
  const auto* ll = static_cast<const float*>(lse);
  const auto* gg = static_cast<const float*>(dO);
  auto* a = static_cast<float*>(dq);
  auto* b = static_cast<float*>(dk);
  auto* c = static_cast<float*>(dv);
  const bool vec = hd % 4 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(o) && aligned16(dO) &&
                   aligned16(dq) && aligned16(dk) && aligned16(dv);
  if (segment_attention_bwd_route(L, hd, vec) == 0) {
    const long long grid = (long long)R * H;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaError_t e = max_smem_once(
        g_one_once, one_cta_kernel,
        (int)one_smem_bytes(kOneMaxL, row_pitch(kOneMaxHd)));
    if (e != cudaSuccess) return (int)e;
    one_cta_kernel<<<(unsigned)grid, kOneThreads,
                     one_smem_bytes(L, row_pitch(hd)), st>>>(
        qq, kk, vv, ss, oo, ll, gg, a, b, c, L, H, hd, scale_div,
        1.0f / (float)L);
    return (int)cudaGetLastError();
  }
  if (hd <= 64) {
    if (L <= 32)
      return (int)launch_tiled<32, 1>(qq, kk, vv, ss, oo, ll, gg, a, b, c, R,
                                      L, H, hd, scale_div, vec, st);
    return (int)launch_tiled<64, 1>(qq, kk, vv, ss, oo, ll, gg, a, b, c, R,
                                    L, H, hd, scale_div, vec, st);
  }
  if (hd <= 128)
    return (int)launch_tiled<32, 2>(qq, kk, vv, ss, oo, ll, gg, a, b, c, R, L,
                                    H, hd, scale_div, vec, st);
  return (int)launch_tiled<32, 4>(qq, kk, vv, ss, oo, ll, gg, a, b, c, R, L,
                                  H, hd, scale_div, vec, st);
}
