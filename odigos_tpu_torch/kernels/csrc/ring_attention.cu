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
// The merge runs as an online softmax over 64-key tiles from the incoming
// state, which is the reference's block max then merge up to f32
// rounding (each tile rescales by exp(m_old - m_new), exact at 1).
//
// Bound on the card: operations. 4 B H Lq Lk D f32 flops (the two
// products) against q, k, v and o each read once: at the ring's block
// shapes (Lq = Lk = 4096 or 8192, D = 64) that is ~1,000 flops a byte,
// far past the ~20 flop/byte where the f32 CUDA-core peak (67 TFLOP/s)
// and not HBM bounds. The reference computes in f32 and its tests hold
// 1e-5, which no tensor-core route reaches without splitting operands, so
// this first kernel runs on CUDA cores.
//
// Design: one CTA of 256 threads a (b, h, 64-query tile), on the tiles
// K1's tiled kernel uses (attention_tiles.cuh: shared-memory layout, K/V
// staging, the 4 x 4 score block, the warp-a-row online softmax and the
// P.V loop). The query tile is staged once as f32 in shared memory; key
// and value tiles of 64 stream through shared memory with the tile's mask
// bytes. Thread (ty, tx) keeps the accumulator of queries ty + 16 a (a <
// 4) at dims tx + 16 c in registers, loaded from o at the start and
// stored at the end. In place: o, m and s are read once and written once.
// What is K22's own: q read as f32 and not scaled (the scale multiplies
// the product), the mask read from kv_mask with the finite fill and the
// weights of masked keys zeroed, the incoming (o, m, s), and the final
// division.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

using tiles::kB;
using tiles::kSld;
using tiles::kThreads;
using tiles::to_f32;

constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kSumFloor = 1e-30f;

// the shared tiles, then the key tile's mask (ints: 1 allowed, 0 masked,
// -1 past Lk)
__host__ __device__ constexpr size_t smem_bytes(int D) {
  return tiles::smem_floats(D) * 4 + (size_t)kB * 4;
}

// One block an SM at least: without it ptxas holds DB 16 (D > 128) to 128
// registers and spills; with it, 167 and no spills.
template <typename T, int DB>
__global__ void __launch_bounds__(kThreads, 1)
ring_block_attention_kernel(const T* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const uint8_t* __restrict__ kv_mask,
                            float* __restrict__ o, float* __restrict__ m,
                            float* __restrict__ s, int Lq, int Lk, int H,
                            int D, float scale, int finalize) {
  extern __shared__ float rb_smem[];
  const int ld = D + 1;
  const tiles::Smem t = tiles::carve(rb_smem, ld);
  int* key_ok = t.tail;

  const int nqb = (Lq + kB - 1) / kB;
  const int bh = blockIdx.x / nqb;  // b * H + h
  const int b = bh / H, h = bh - b * H;
  const int q0 = (blockIdx.x - bh * nqb) * kB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t row_pitch = (size_t)H * D;  // elements between positions

  // the query tile as f32; rows past Lq are zero (never written back)
  for (int e = tid; e < kB * D; e += kThreads) {
    const int l = e / D, dd = e - l * D;
    float x = 0.f;
    if (q0 + l < Lq)
      x = to_f32(q[((size_t)b * Lq + q0 + l) * row_pitch + (size_t)h * D + dd]);
    t.qs[l * ld + dd] = x;
  }
  if (tid < kB) {
    const bool in = q0 + tid < Lq;
    const size_t i = (size_t)bh * Lq + q0 + tid;
    t.run_m[tid] = in ? m[i] : kNegInf;
    t.run_l[tid] = in ? s[i] : 0.f;
  }
  float acc[4][DB];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int iq = q0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < DB; ++c) {
      const int dd = tx + 16 * c;
      acc[a][c] = (iq < Lq && dd < D)
                      ? o[((size_t)b * Lq + iq) * row_pitch +
                          (size_t)h * D + dd]
                      : 0.f;
    }
  }

  for (int kt0 = 0; kt0 < Lk; kt0 += kB) {
    __syncthreads();  // the previous tile's K, V and scores are consumed
    tiles::stage_kv(t, k, v, (size_t)b * Lk + kt0, Lk - kt0, H, h, D, ld,
                    tid);
    if (tid < kB)
      key_ok[tid] = kt0 + tid < Lk
                        ? (kv_mask[(size_t)b * Lk + kt0 + tid] ? 1 : 0)
                        : -1;
    __syncthreads();
    // ---- logits of queries ty + 16 a and keys tx + 16 j
    float dot[4][4];
    tiles::score_block(t, ld, D, ty, tx, dot);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        const int ok = key_ok[key];
        // past Lk: out of the max (-inf) and weighted 0 below
        t.sc[(ty + 16 * a) * kSld + key] =
            ok < 0 ? -INFINITY : (ok ? dot[a][j] * scale : kNegInf);
      }
    __syncthreads();
    // ---- the merge, a warp a query row: the row max is >= -1e30 (finite)
    // and masked keys weigh 0 whatever the exponential gives (a block all
    // masked has exp(-1e30 - -1e30) = 1); the rescale is 1 while nothing
    // was allowed
    tiles::softmax_rows(t, warp, lane, key_ok[lane] > 0,
                        key_ok[lane + 32] > 0);
    __syncthreads();
    // ---- O = O * alpha + P.V
    tiles::pv_accumulate<DB>(t, ld, D, min(kB, Lk - kt0), ty, tx, acc);
  }
  __syncthreads();
  if (tid < kB && q0 + tid < Lq) {
    const size_t i = (size_t)bh * Lq + q0 + tid;
    m[i] = t.run_m[tid];
    s[i] = t.run_l[tid];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int iq = q0 + ty + 16 * a;
    if (iq >= Lq) continue;
    const float den = fmaxf(t.run_l[ty + 16 * a], kSumFloor);
#pragma unroll
    for (int c = 0; c < DB; ++c) {
      const int dd = tx + 16 * c;
      if (dd < D)
        o[((size_t)b * Lq + iq) * row_pitch + (size_t)h * D + dd] =
            finalize ? acc[a][c] / den : acc[a][c];
    }
  }
}

DeviceOnce g_once[2][3];

template <typename T, int DB>
cudaError_t launch_db(DeviceOnce& once, const void* q, const void* k,
                      const void* v, const void* kv_mask, void* o, void* m,
                      void* s, int B, int Lq, int Lk, int H, int D,
                      float scale, int finalize, cudaStream_t stream) {
  cudaError_t err = max_smem_once(once, ring_block_attention_kernel<T, DB>,
                                  (int)smem_bytes(kMaxD));
  if (err != cudaSuccess) return err;
  const long long grid = (long long)B * H * ((Lq + kB - 1) / kB);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  ring_block_attention_kernel<T, DB>
      <<<(unsigned)grid, kThreads, smem_bytes(D), stream>>>(
          static_cast<const T*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const uint8_t*>(kv_mask),
          static_cast<float*>(o), static_cast<float*>(m),
          static_cast<float*>(s), Lq, Lk, H, D, scale, finalize);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(DeviceOnce (&once)[3], const void* q, const void* k,
                   const void* v, const void* kv_mask, void* o, void* m,
                   void* s, int B, int Lq, int Lk, int H, int D, float scale,
                   int finalize, cudaStream_t stream) {
  if (D <= 64)
    return launch_db<T, 4>(once[0], q, k, v, kv_mask, o, m, s, B, Lq, Lk, H,
                           D, scale, finalize, stream);
  if (D <= 128)
    return launch_db<T, 8>(once[1], q, k, v, kv_mask, o, m, s, B, Lq, Lk, H,
                           D, scale, finalize, stream);
  return launch_db<T, 16>(once[2], q, k, v, kv_mask, o, m, s, B, Lq, Lk, H,
                          D, scale, finalize, stream);
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
