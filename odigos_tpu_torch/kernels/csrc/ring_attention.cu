// K22: one q-block x kv-block step of ring attention for Hopper (sm_90a).
//
// Replaces: odigos_tpu/parallel/ring_attention.py `_block_attention`
// (:41-55) followed by the streaming merge of `_ring_body` (:75-84), and
// on the last step its final division (:97). The JAX package left this to
// XLA under shard_map; it has no Pallas kernel.
//
// Semantics (the reference's, in f32): for each (b, h, query i)
//   logit_ij = (q_i . k_j) * scale, with q read as f32 (f32 or bf16 in)
//   and k, v f32 (the reference casts them before the ring loop);
//   a masked key's logit is the FINITE -1e30 (NEG_INF), and its weight
//   is zeroed explicitly: a block whose keys are all masked has a row max
//   of -1e30 and exp(-1e30 - -1e30) = 1, so the exponential cannot be
//   trusted to zero it. The incoming accumulators (o, m, s) merge with
//   the block as the reference's alpha / beta rescale does:
//     m' = max(m, max_j logit_ij), s' = s e^(m - m') + sum_j p_ij,
//     o' = o e^(m - m') + sum_j p_ij v_j,  p_ij = e^(logit_ij - m').
//   With `finalize` the output is o' / max(s', 1e-30), written over o in
//   the (B, Lq, H, D) layout: a query whose every key was masked gives 0.
// The merge runs as an online softmax over key tiles from the incoming
// state, which is the reference's block max then merge up to f32
// rounding (each tile rescales by exp(m_old - m_new), exact at 1).
//
// Bound on the card: operations. 4 B H Lq Lk D flops (the two products)
// against q, k, v and o each read once: at the ring's block shapes (Lq =
// Lk = 4096 or 8192, D = 64) ~1,000 flops a byte. The reference computes
// in f32 and its tests hold 1e-5, which a plain TF32 or bf16 product
// (10 or 8 mantissa bits) does not reach. A split-operand product does:
// each f32 operand x is hi + lo with hi = tf32(x) and lo = tf32(x - hi)
// (x - hi - lo is below 2^-21 |x|), and a.b is taken as
//   a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
// (the lo.lo term is below 2^-22 |a||b|), three TF32 tensor-core products
// summed in f32: 3 x 4 B H Lq Lk D flops at 495 TFLOP/s (a bf16 q is exact
// in TF32, so its lo term and one product of the score drop).
//
// Design: a CTA of W warps (4; 8 past D 128) a (b, h, tile of 16 MT W
// queries); a warp owns 16 MT query rows and runs `mma.sync.m16n8k8` TF32
// on them:
//   * q is staged once as f32 in shared memory; a warp splits its A
//     fragments as it loads them (8 values a 8-dim step, reused across
//     the tile's keys);
//   * K and V tiles of KT keys are staged split, as (hi, lo) float2 pairs,
//     so each B fragment is one 8-byte load a lane and no warp splits
//     them again; pitches of D + 4 (K) and D + 2 (V) pairs keep the
//     fragment loads free of bank conflicts; with 16-byte aligned k, v and
//     D % 4 == 0 they are read as float4 (loading the next tile into
//     registers during this one measured slower: the registers it takes);
//   * the score fragments stay in registers through the online softmax:
//     a thread holds two query rows' partial max and sum, combined over
//     the four lanes of a row by two shuffles; masked keys weigh 0;
//   * P.V takes the score accumulators as its A fragments with the keys
//     of each 8-key step permuted (k index t <-> key 2t, t + 4 <-> key
//     2t + 1), so no shuffle moves P; the output accumulator stays in
//     registers, loaded from o at the start and stored at the end. In
//     place: o, m and s are read once and written once;
//   * the tensor cores' f32 accumulate truncates (it does not round to
//     nearest), and a chain of ~1,500 products into the output measured
//     5.6e-5 off plain at Lk 4096. So no chain is longer than 24 products:
//     each tile's P.V and each 64-dim chunk of the score start from zero,
//     and are added to the running sums by f32 FMAs and adds.
// Head dims 1-256 pad to a multiple of 8 with zeros: D <= 64 takes 64-key
// tiles and 32 queries a warp (two CTAs an SM), D <= 128 32-key tiles and
// 16 queries a warp (two CTAs), D <= 256 16-key tiles, 16 queries a warp
// and one CTA of 8 warps an SM (199 KB of shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

using tiles::to_f32;

constexpr int kWarps = 4;  // a CTA's warps at D <= 128 (8 past it)
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kSumFloor = 1e-30f;
constexpr float kLog2e = 1.4426950408889634f;
// 16-query MMA tiles a warp and keys a tile at D <= 64
constexpr int kMTiles64 = 2;
constexpr int kKeyTile64 = 64;
// 8-dim output steps of a tile's P.V accumulated at once
constexpr int kPVSteps = 8;

// shared bytes at head dim D: q (16 MT W rows of dp + 4 floats), K and V
// (KT rows of dp + 4 and dp + 2 (hi, lo) pairs), the tile's key flags
__host__ __device__ constexpr size_t smem_bytes(int D, int KT, int MT,
                                                int W) {
  return (size_t)16 * MT * W * ((D + 7) / 8 * 8 + 4) * 4 +
         (size_t)KT * ((D + 7) / 8 * 8 + 4) * 8 +
         (size_t)KT * ((D + 7) / 8 * 8 + 2) * 8 + (size_t)KT * 4;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + r, hi and lo TF32, |r| < 2^-21 |x|
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ float2 split2(float x) {
  uint32_t hi, lo;
  split(x, hi, lo);
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

// c += a.b, one m16n8k8 TF32 product (f32 accumulate)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four values split into (hi, lo) pairs at dst (16-byte aligned)
__device__ __forceinline__ void store_split4(float2* dst, const float4& x) {
  const float2 a = split2(x.x), b = split2(x.y), c = split2(x.z),
               d = split2(x.w);
  float4* p = reinterpret_cast<float4*>(dst);
  p[0] = make_float4(a.x, a.y, b.x, b.y);
  p[1] = make_float4(c.x, c.y, d.x, d.y);
}

// NT: 8-dim steps held (D <= 8 NT); KT: keys a tile; MT: 16-query tiles a
// warp; W: warps a CTA; VEC: float4 loads of K and V (D % 4 == 0, 16-byte
// aligned)
template <typename T, int NT, int KT, int MT, int W, bool VEC, int MINB>
__global__ void __launch_bounds__(32 * W, MINB)
ring_block_attention_kernel(const T* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const uint8_t* __restrict__ kv_mask,
                            float* __restrict__ o, float* __restrict__ m,
                            float* __restrict__ s, int Lq, int Lk, int H,
                            int D, float scale, int finalize) {
  constexpr int kQ = 16 * MT * W;  // queries a CTA
  constexpr int kThreads = 32 * W;
  constexpr int kJ = KT / 8;            // 8-key steps a tile
  // a bf16 q is exact in TF32: no lo term
  constexpr bool kQSplit = sizeof(T) == 4;

  extern __shared__ __align__(16) float rb_smem[];
  const int dp = (D + 7) & ~7, nd8 = dp >> 3;
  const int ldq = dp + 4, ldk = dp + 4, ldv = dp + 2;
  float* qs = rb_smem;
  float2* khl = reinterpret_cast<float2*>(qs + kQ * ldq);
  float2* vhl = khl + KT * ldk;
  int* key_ok = reinterpret_cast<int*>(vhl + KT * ldv);

  const int nqb = (Lq + kQ - 1) / kQ;
  const int bh = blockIdx.x / nqb;  // b * H + h
  const int b = bh / H, h = bh - b * H;
  const int q0 = (blockIdx.x - bh * nqb) * kQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const size_t pitch = (size_t)H * D;  // elements between positions
  const float* kb = k + ((size_t)b * Lk * H + h) * D;
  const float* vb = v + ((size_t)b * Lk * H + h) * D;
  const uint8_t* mb = kv_mask + (size_t)b * Lk;

  // the query tile as f32; rows past Lq and dims past D are zero
  for (int e = tid; e < kQ * dp; e += kThreads) {
    const int l = e / dp, c = e - l * dp;
    float x = 0.f;
    if (q0 + l < Lq && c < D)
      x = to_f32(q[((size_t)b * Lq + q0 + l) * pitch + (size_t)h * D + c]);
    qs[l * ldq + c] = x;
  }

  // this thread's rows: warp * 16 MT + 16 mt + g (+ 8 for hf = 1); its
  // accumulator columns 8 n + 2 tig (+ 1)
  float rm[MT][2], rl[MT][2];
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int iq = q0 + warp * 16 * MT + 16 * mt + g + 8 * hf;
      const bool in = iq < Lq;
      const size_t i = (size_t)bh * Lq + iq;
      rm[mt][hf] = in ? m[i] : kNegInf;
      rl[mt][hf] = in ? s[i] : 0.f;
      const float* orow = o + ((size_t)b * Lq + iq) * pitch + (size_t)h * D;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int dd = 8 * n + 2 * tig + c;
          acc[mt][n][2 * hf + c] = (in && dd < D) ? orow[dd] : 0.f;
        }
    }

  // ---- a K/V tile staged split into (hi, lo) pairs, with its key flags
  const int q4 = dp >> 2;  // float4s a padded key row
  auto stage = [&](int kt0) {
    if constexpr (VEC) {
      for (int e = tid; e < KT * q4; e += kThreads) {
        const int key = e / q4, c4 = e - key * q4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
        if (kt0 + key < Lk && 4 * c4 < D) {
          const size_t off = (size_t)(kt0 + key) * pitch + 4 * c4;
          x = __ldg(reinterpret_cast<const float4*>(kb + off));
          y = __ldg(reinterpret_cast<const float4*>(vb + off));
        }
        store_split4(khl + key * ldk + 4 * c4, x);
        store_split4(vhl + key * ldv + 4 * c4, y);
      }
    } else {
      for (int e = tid; e < KT * dp; e += kThreads) {
        const int key = e / dp, c = e - key * dp;
        float x = 0.f, y = 0.f;
        if (kt0 + key < Lk && c < D) {
          const size_t off = (size_t)(kt0 + key) * pitch + c;
          x = kb[off];
          y = vb[off];
        }
        khl[key * ldk + c] = split2(x);
        vhl[key * ldv + c] = split2(y);
      }
    }
    if (tid < KT)
      key_ok[tid] = kt0 + tid < Lk ? (mb[kt0 + tid] ? 1 : 0) : -1;
  };

  const float* qw = qs + (warp * 16 * MT + g) * ldq;
  const float sl = scale * kLog2e;
  for (int kt0 = 0; kt0 < Lk; kt0 += KT) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    stage(kt0);
    __syncthreads();

    // ---- S = Q K^T: rows g, g + 8 of each m-tile, keys 8 j + 2 tig (+1).
    // The tensor cores' f32 accumulate truncates, so no chain runs past
    // 24 products: each 64-dim chunk of the score starts from zero and the
    // chunks are added in f32 (round to nearest)
    float sc[MT][kJ][4];
    auto score_chunk = [&](int kc, float (&t)[MT][kJ][4]) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) t[mt][j][i] = 0.f;
#pragma unroll
      for (int k8 = 0; k8 < 8; ++k8) {
        const int kk = kc + k8;
        if (kk < nd8) {
          const int c = 8 * kk + tig;
          uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const float* qa = qw + 16 * mt * ldq + c;
            const float a[4] = {qa[0], qa[8 * ldq], qa[4], qa[8 * ldq + 4]};
#pragma unroll
            for (int i = 0; i < 4; ++i) split(a[i], ahi[mt][i], alo[mt][i]);
          }
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            const float2* kr = khl + (8 * j + g) * ldk + c;
            const float2 b0 = kr[0], b1 = kr[4];
            const uint32_t h0 = __float_as_uint(b0.x);
            const uint32_t l0 = __float_as_uint(b0.y);
            const uint32_t h1 = __float_as_uint(b1.x);
            const uint32_t l1 = __float_as_uint(b1.y);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              if constexpr (kQSplit) mma_tf32(t[mt][j], alo[mt], h0, h1);
              mma_tf32(t[mt][j], ahi[mt], l0, l1);
              mma_tf32(t[mt][j], ahi[mt], h0, h1);
            }
          }
        }
      }
    };
    score_chunk(0, sc);
    if constexpr (NT > 8)
    for (int kc = 8; kc < nd8; kc += 8) {  // D > 64
      float t[MT][kJ][4];
      score_chunk(kc, t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[mt][j][i] += t[mt][j][i];
    }

    // ---- the online softmax in registers: logits (past Lk: -inf, out of
    // the max; masked: the finite fill), the tile's max merged into the
    // running max, weights of keys not allowed zeroed, the running sum
    // rescale exp(m_old - m_new) kept for the accumulator. Each weight is
    // exp2(dot * scale log2(e) - m_new log2(e)): one FFMA into exp2f
    // this thread's 2 kJ keys (8 j + 2 tig + c): bit 2 j + c allowed, bit
    // 16 + 2 j + c within Lk
    static_assert(kJ <= 8, "a tile's key flags fit one word");
    unsigned okb = 0u;
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int f = key_ok[8 * j + 2 * tig + c];
        okb |= (unsigned)(f > 0) << (2 * j + c);
        okb |= (unsigned)(f >= 0) << (16 + 2 * j + c);
      }
    float alpha[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int bit = 2 * j + (i & 1);
          mx[i >> 1] = fmaxf(mx[i >> 1], !(okb >> (16 + bit) & 1u)
                                             ? -INFINITY
                                             : (okb >> bit & 1u)
                                                   ? sc[mt][j][i] * scale
                                                   : kNegInf);
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float t = mx[hf];
        t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 1));
        t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 2));
        const float mn = fmaxf(rm[mt][hf], t);
        const float mb = mn * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = (okb >> (2 * j + c) & 1u)
                                ? exp2f(fmaf(sc[mt][j][2 * hf + c], sl, -mb))
                                : 0.f;
            sc[mt][j][2 * hf + c] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float al = exp2f((rm[mt][hf] - mn) * kLog2e);
        rl[mt][hf] = rl[mt][hf] * al + sum;
        rm[mt][hf] = mn;
        alpha[mt][hf] = al;
      }
    }

    // ---- O = O * alpha + P.V: step j's k index t is key 8 j + 2 t, t + 4
    // is key 8 j + 2 t + 1, so the score accumulators are the A fragments.
    // The tile's P.V starts from zero (at most 24 products a chain) and is
    // added to O in f32; it runs over 8 kPVSteps output dims at a time (P
    // split again for each), so its accumulator takes 4 kPVSteps registers
    // an m-tile
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += kPVSteps) {
      if (n0 < nd8) {
        float pv[MT][kPVSteps][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < kPVSteps; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[mt][n][i] = 0.f;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          uint32_t phi[MT][4], plo[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const float pa[4] = {sc[mt][j][0], sc[mt][j][2], sc[mt][j][1],
                                 sc[mt][j][3]};
#pragma unroll
            for (int i = 0; i < 4; ++i) split(pa[i], phi[mt][i], plo[mt][i]);
          }
          const float2* vr = vhl + (8 * j + 2 * tig) * ldv + g;
#pragma unroll
          for (int n = 0; n < kPVSteps; ++n) {
            if (n0 + n < nd8) {
              const float2 b0 = vr[8 * (n0 + n)], b1 = vr[ldv + 8 * (n0 + n)];
              const uint32_t h0 = __float_as_uint(b0.x);
              const uint32_t l0 = __float_as_uint(b0.y);
              const uint32_t h1 = __float_as_uint(b1.x);
              const uint32_t l1 = __float_as_uint(b1.y);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                mma_tf32(pv[mt][n], plo[mt], h0, h1);
                mma_tf32(pv[mt][n], phi[mt], l0, l1);
                mma_tf32(pv[mt][n], phi[mt], h0, h1);
              }
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < kPVSteps; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[mt][n0 + n][i] = fmaf(acc[mt][n0 + n][i],
                                        alpha[mt][i >> 1], pv[mt][n][i]);
      }
    }
  }

  // ---- the state and the output, in place
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int iq = q0 + warp * 16 * MT + 16 * mt + g + 8 * hf;
      if (iq >= Lq) continue;
      const size_t i = (size_t)bh * Lq + iq;
      if (tig == 0) {
        m[i] = rm[mt][hf];
        s[i] = rl[mt][hf];
      }
      const float den = fmaxf(rl[mt][hf], kSumFloor);
      float* orow = o + ((size_t)b * Lq + iq) * pitch + (size_t)h * D;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int dd = 8 * n + 2 * tig + c;
          const float a = acc[mt][n][2 * hf + c];
          if (dd < D) orow[dd] = finalize ? a / den : a;
        }
    }
}

// the kernels' configurations: head-dim bucket x (vector or scalar route)
constexpr int kConfigs = 6;
DeviceOnce g_once[2][kConfigs];

template <typename T, int NT, int KT, int MT, int W, bool VEC, int MINB>
cudaError_t launch_cfg(DeviceOnce& once, const void* q, const void* k,
                       const void* v, const void* kv_mask, void* o, void* m,
                       void* s, int B, int Lq, int Lk, int H, int D,
                       float scale, int finalize, cudaStream_t stream) {
  cudaError_t err = max_smem_once(
      once, ring_block_attention_kernel<T, NT, KT, MT, W, VEC, MINB>,
      (int)smem_bytes(8 * NT, KT, MT, W));
  if (err != cudaSuccess) return err;
  constexpr int kQ = 16 * MT * W;
  const long long grid = (long long)B * H * ((Lq + kQ - 1) / kQ);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  ring_block_attention_kernel<T, NT, KT, MT, W, VEC, MINB>
      <<<(unsigned)grid, 32 * W, smem_bytes(D, KT, MT, W), stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(s),
      Lq, Lk, H, D, scale, finalize);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(DeviceOnce (&once)[kConfigs], const void* q,
                   const void* k, const void* v, const void* kv_mask,
                   void* o, void* m, void* s, int B, int Lq, int Lk, int H,
                   int D, float scale, int finalize, cudaStream_t stream) {
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
#define RB_ARGS q, k, v, kv_mask, o, m, s, B, Lq, Lk, H, D, scale, finalize, \
                stream
  if (D <= 64)
    return vec ? launch_cfg<T, 8, kKeyTile64, kMTiles64, kWarps, true, 2>(
                     once[0], RB_ARGS)
               : launch_cfg<T, 8, kKeyTile64, kMTiles64, kWarps, false, 2>(
                     once[1], RB_ARGS);
  if (D <= 128)
    return vec ? launch_cfg<T, 16, 32, 1, kWarps, true, 2>(once[2], RB_ARGS)
               : launch_cfg<T, 16, 32, 1, kWarps, false, 2>(once[3],
                                                            RB_ARGS);
  return vec ? launch_cfg<T, 32, 16, 1, 2 * kWarps, true, 1>(once[4],
                                                             RB_ARGS)
             : launch_cfg<T, 32, 16, 1, 2 * kWarps, false, 1>(once[5],
                                                              RB_ARGS);
#undef RB_ARGS
}

}  // namespace

// q: (B, Lq, H, D) f32 (dtype 0) or bf16 (dtype 1); k, v: (B, Lk, H, D)
// f32; kv_mask: (B, Lk) bytes (0 masked, else allowed); o: (B, Lq, H, D)
// f32, m and s: (B, H, Lq) f32, all updated in place; every tensor
// contiguous (checked by the Python wrapper). 1 <= D <= 256. finalize:
// also divide by max(s, 1e-30) into o. Returns a cudaError_t.
extern "C" int ring_block_attention_launch(const void* q, const void* k,
                                           const void* v, const void* kv_mask,
                                           void* o, void* m, void* s, int B,
                                           int Lq, int Lk, int H, int D,
                                           int dtype, float scale,
                                           int finalize, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk < 0 || H <= 0 || D <= 0 || D > kMaxD ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(g_once[0], q, k, v, kv_mask, o, m, s, B, Lq, Lk,
                              H, D, scale, finalize, st);
  return (int)launch<__nv_bfloat16>(g_once[1], q, k, v, kv_mask, o, m, s, B,
                                    Lq, Lk, H, D, scale, finalize, st);
}
