// K11: the span autoencoder's decoder LayerNorm, four f32 heads and weighted
// reconstruction error, fused, with an optional squash-and-scatter epilogue
// — for Hopper (sm_90a).
//
// Replaces odigos_tpu/models/autoencoder.py SpanAutoencoder._errors
// (:112-120) with the head half of _AutoencoderModule (:81-91: dec_ln, then
// Dense(service_vocab), Dense(name_vocab), Dense(8), Dense(1), all f32) and
// _ce (:93-95); in scatter mode also the squash and inverse scatter of
// odigos_tpu/serving/fused.py _build_forward_spans (:491-509):
//   err = w_s ce(service) + w_n ce(name) + w_k ce(kind)
//         + w_d (duration - continuous[..., 0])^2,   times the mask;
//   scores[span_index] = 1 - exp(-err).
//
// Per position (one row of the (M, d) decoder output, M = T * L):
//   1. dec_ln, the LayerNorm of ln_exact.cuh shared with K9 and K12: f32
//      statistics from exact f64 sums, IEEE steps, the output rounded to the
//      working type (Flax's LayerNorm(dtype=bf16)) before the f32 heads;
//   2. the logits of each head in f32, with an online log-sum-exp (running
//      max and rescaled sum) over the service, name and kind vocabularies:
//      the (M, 2569) logits never reach device memory (the plain version at
//      T = 8192 traces would hold 4.3 GB of them);
//   3. ce = lse - logit[label] (labels clamped into the vocabulary), mse =
//      (duration - continuous[..., 0])^2;
//   4. err accumulated in the reference's order (:116-120) with separate
//      IEEE steps.
// Masked positions are skipped and write 0 (the reference multiplies finite
// values by 0 there): on the host route ~84% of a row is padding on the
// otel mix (10.3 spans a trace in L = 64).
//
// Design: one CTA of 256 threads per chunk of 256 consecutive positions. A
// ballot compacts the chunk's real positions into shared memory; they are
// scored in tiles of P = 64: each warp normalises positions into a (P,
// d + 4) f32 tile in shared memory, then the CTA streams each head's
// weight rows in chunks of 64 (a (64, d + 4) tile, rows padded by 4 floats
// so the 16-byte reads of 8 rows hit distinct banks). Thread (tp, tv) =
// (tid / 16, tid % 16) computes the 4 x 4 logits of positions tp * 4 + i
// and vocabulary rows tv + 16 j with f32 FMAs (CUDA cores), and keeps a
// running (max, sum) per position; the 16 threads of a position group
// merge theirs with shuffles at the end of each head.
//
// Bound on the card: operations. 2 d (512 + 2048 + 8 + 1) = 657,664 f32
// flops a position at d = 128: at T = 2048 traces of L = 64, 86.2 GFLOP if
// every position were scored (1.29 ms at 67 TFLOP/s), 13.9 GFLOP at the
// otel mix's ~21,100 real positions (~0.21 ms); the bytes (the decoder
// rows, labels, mask, err, 1.3 MB of weights) are ~38 MB, 0.011 ms. This
// simple design reads the weights from L2 once per tile and is bound by
// shared-memory bandwidth (8 16-byte reads per 64 FMAs); a tensor-core
// design (bf16 x bf16 with the f32 weights split into bf16 hi + lo) is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ln_exact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;  // positions per CTA
constexpr int kTile = 64;    // positions scored together
constexpr int kVC = 64;      // vocabulary rows per weight tile

// merge a running (max, sum) with another; -inf marks an empty one
__device__ __forceinline__ void lse_merge(float& m, float& s, float mo,
                                          float so) {
  const float mn = fmaxf(m, mo);
  const float a = m == -INFINITY ? 0.f : s * expf(m - mn);
  const float b = mo == -INFINITY ? 0.f : so * expf(mo - mn);
  m = mn;
  s = a + b;
}

struct Heads {
  const float* w[4];  // (V_h, d) f32, torch Linear layout
  const float* b[4];  // (V_h,) f32
  int v[4];
};

template <typename T, int PER>
__global__ void __launch_bounds__(kThreads) recon_ce_kernel(
    const T* __restrict__ dec, long long M, const float* __restrict__ gamma,
    const float* __restrict__ beta, float eps, Heads heads,
    const int32_t* __restrict__ cat, int C, const float* __restrict__ cont,
    int D, const uint8_t* __restrict__ mask, float w_s, float w_n, float w_k,
    float w_d, float* __restrict__ err, const int32_t* __restrict__ span_map,
    float* __restrict__ scores) {
  constexpr int d = 32 * PER;
  constexpr int ld = d + 4;
  extern __shared__ float4 smem4[];
  float* s_y = reinterpret_cast<float*>(smem4);  // (kTile, ld)
  float* s_w = s_y + kTile * ld;                 // (kVC, ld)
  __shared__ int s_pos[kChunk];
  __shared__ int s_wcount[kWarps];
  __shared__ int s_lab[3][kTile];
  __shared__ float s_c0[kTile], s_dur[kTile], s_zl[3][kTile],
      s_lse[3][kTile];

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long base = (long long)blockIdx.x * kChunk;

  // ---- compact the chunk's real positions
  const long long pos = base + tid;
  const bool real = pos < M && mask[pos];
  if (pos < M && !real) err[pos] = 0.f;
  const unsigned bal = __ballot_sync(0xffffffffu, real);
  if (lane == 0) s_wcount[wid] = __popc(bal);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    off += w < wid ? s_wcount[w] : 0;
    total += s_wcount[w];
  }
  if (real) s_pos[off + __popc(bal & ((1u << lane) - 1u))] = tid;
  __syncthreads();

  const int tp = tid >> 4, tv = tid & 15;
  for (int t0 = 0; t0 < total; t0 += kTile) {
    const int np = min(kTile, total - t0);
    // ---- dec_ln of the tile's positions, one warp per position
    for (int p = wid; p < kTile; p += kWarps) {
      float* yr = s_y + p * ld + lane * PER;
      if (p < np) {
        const long long q = base + s_pos[t0 + p];
        float y[PER];
        warp_ln_row<T, PER>(dec + q * d + lane * PER, gamma + lane * PER,
                            beta + lane * PER, eps, y);
#pragma unroll
        for (int j = 0; j < PER; ++j) yr[j] = y[j];
        if (lane < 3) {
          const int lab = cat[q * C + lane];
          s_lab[lane][p] = min(max(lab, 0), heads.v[lane] - 1);
        }
        if (lane == 3) s_c0[p] = cont[q * D];
      } else {
#pragma unroll
        for (int j = 0; j < PER; ++j) yr[j] = 0.f;
        if (lane < 3) s_lab[lane][p] = 0;
        if (lane == 3) s_c0[p] = 0.f;
      }
    }
    // ---- the four heads over the tile
    for (int h = 0; h < 4; ++h) {
      const float* __restrict__ W = heads.w[h];
      const float* __restrict__ B = heads.b[h];
      const int V = heads.v[h];
      float m[4], s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        s[i] = 0.f;
      }
      for (int v0 = 0; v0 < V; v0 += kVC) {
        __syncthreads();  // s_y written / the previous weight tile read
        for (int e = tid; e < kVC * (d / 4); e += kThreads) {
          const int r = e / (d / 4), c4 = e % (d / 4);
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (v0 + r < V)
            val = __ldg(reinterpret_cast<const float4*>(
                W + (long long)(v0 + r) * d) + c4);
          reinterpret_cast<float4*>(s_w + r * ld)[c4] = val;
        }
        __syncthreads();
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int k = 0; k < d; k += 4) {
          float4 yv[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            yv[i] = *reinterpret_cast<const float4*>(s_y + (tp * 4 + i) * ld
                                                     + k);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wv[j] = *reinterpret_cast<const float4*>(s_w + (tv + 16 * j) * ld
                                                     + k);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float a = acc[i][j];
              a = fmaf(yv[i].x, wv[j].x, a);
              a = fmaf(yv[i].y, wv[j].y, a);
              a = fmaf(yv[i].z, wv[j].z, a);
              a = fmaf(yv[i].w, wv[j].w, a);
              acc[i][j] = a;
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int v = v0 + tv + 16 * j;
          if (v >= V) continue;
          const float bias = B[v];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int p = tp * 4 + i;
            const float z = __fadd_rn(acc[i][j], bias);
            if (h == 3) {
              s_dur[p] = z;  // the duration head: one logit, no lse
            } else {
              if (v == s_lab[h][p]) s_zl[h][p] = z;
              if (z > m[i]) {
                s[i] = s[i] * expf(m[i] - z) + 1.f;
                m[i] = z;
              } else {
                s[i] += expf(z - m[i]);
              }
            }
          }
        }
      }
      if (h < 3) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int o = 8; o; o >>= 1) {
            const float mo = __shfl_xor_sync(0xffffffffu, m[i], o);
            const float so = __shfl_xor_sync(0xffffffffu, s[i], o);
            lse_merge(m[i], s[i], mo, so);
          }
          if (tv == 0) s_lse[h][tp * 4 + i] = m[i] + logf(s[i]);
        }
      }
    }
    __syncthreads();
    // ---- the weighted error, in the reference's order
    if (tid < np) {
      const long long q = base + s_pos[t0 + tid];
      const float dd = __fsub_rn(s_dur[tid], s_c0[tid]);
      float e = __fmul_rn(w_s, __fsub_rn(s_lse[0][tid], s_zl[0][tid]));
      e = __fadd_rn(e, __fmul_rn(w_n, __fsub_rn(s_lse[1][tid],
                                                s_zl[1][tid])));
      e = __fadd_rn(e, __fmul_rn(w_k, __fsub_rn(s_lse[2][tid],
                                                s_zl[2][tid])));
      e = __fadd_rn(e, __fmul_rn(w_d, __fmul_rn(dd, dd)));
      err[q] = e;
      if (span_map != nullptr) {
        const int idx = span_map[q];
        if (idx >= 0) scores[idx] = 1.f - expf(-e);
      }
    }
    __syncthreads();  // the next tile overwrites the shared tiles
  }
}

template <typename T, int PER>
int launch_t(const T* dec, long long M, const float* gamma,
             const float* beta, float eps, const Heads& heads,
             const int32_t* cat, int C, const float* cont, int D,
             const uint8_t* mask, const float* wts, float* err,
             const int32_t* span_map, float* scores, cudaStream_t st) {
  constexpr int ld = 32 * PER + 4;
  const int smem = (kTile + kVC) * ld * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      recon_ce_kernel<T, PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (M + kChunk - 1) / kChunk;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  recon_ce_kernel<T, PER><<<(unsigned)blocks, kThreads, smem, st>>>(
      dec, M, gamma, beta, eps, heads, cat, C, cont, D, mask, wts[0], wts[1],
      wts[2], wts[3], err, span_map, scores);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* dec, long long M, int d, const float* gamma,
           const float* beta, float eps, const Heads& heads,
           const int32_t* cat, int C, const float* cont, int D,
           const uint8_t* mask, const float* wts, float* err,
           const int32_t* span_map, float* scores, cudaStream_t st) {
  switch (d) {
    case 32:
      return launch_t<T, 1>(dec, M, gamma, beta, eps, heads, cat, C, cont, D,
                            mask, wts, err, span_map, scores, st);
    case 64:
      return launch_t<T, 2>(dec, M, gamma, beta, eps, heads, cat, C, cont, D,
                            mask, wts, err, span_map, scores, st);
    case 128:
      return launch_t<T, 4>(dec, M, gamma, beta, eps, heads, cat, C, cont, D,
                            mask, wts, err, span_map, scores, st);
    case 256:
      return launch_t<T, 8>(dec, M, gamma, beta, eps, heads, cat, C, cont, D,
                            mask, wts, err, span_map, scores, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K11. dec: (M, d) bf16 (dtype 1) or f32 (dtype 0), the decoder's output
// before dec_ln; gamma, beta: (d,) f32; w0..w3: the service, name, kind and
// duration heads' (V_h, d) f32 weights, b0..b3 their (V_h,) biases (V_3 =
// 1); cat: (M, C) int32 (labels in columns 0-2), cont: (M, D) f32 (target
// in column 0); mask: (M,) bytes; the four loss weights; err: (M,) f32 out.
// span_map (nullable): (M,) int32 original span index, -1 at padding;
// scores: zero-filled f32, written at span_map[q] for each real q. d is
// 32, 64, 128 or 256.
extern "C" int recon_ce_launch(
    const void* dec, int dtype, long long M, int d, const void* gamma,
    const void* beta, float eps, const void* w0, const void* w1,
    const void* w2, const void* w3, const void* b0, const void* b1,
    const void* b2, const void* b3, int v0, int v1, int v2, int v3,
    const void* cat, int C, const void* cont, int D, const void* mask,
    float w_s, float w_n, float w_k, float w_d, void* err,
    const void* span_map, void* scores, void* stream) {
  if (M < 0 || (dtype != 0 && dtype != 1) || v0 < 1 || v1 < 1 || v2 < 1 ||
      v3 != 1 || C < 3 || D < 1 || (span_map != nullptr && scores == nullptr))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  Heads heads;
  heads.w[0] = static_cast<const float*>(w0);
  heads.w[1] = static_cast<const float*>(w1);
  heads.w[2] = static_cast<const float*>(w2);
  heads.w[3] = static_cast<const float*>(w3);
  heads.b[0] = static_cast<const float*>(b0);
  heads.b[1] = static_cast<const float*>(b1);
  heads.b[2] = static_cast<const float*>(b2);
  heads.b[3] = static_cast<const float*>(b3);
  heads.v[0] = v0;
  heads.v[1] = v1;
  heads.v[2] = v2;
  heads.v[3] = v3;
  const float wts[4] = {w_s, w_n, w_k, w_d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const int32_t* c = static_cast<const int32_t*>(cat);
  const float* x = static_cast<const float*>(cont);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* e = static_cast<float*>(err);
  const int32_t* sm = static_cast<const int32_t*>(span_map);
  float* sc = static_cast<float*>(scores);
  if (dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(dec), M, d, g, b, eps,
                  heads, c, C, x, D, m, wts, e, sm, sc, st);
  return launch(static_cast<const float*>(dec), M, d, g, b, eps, heads, c, C,
                x, D, m, wts, e, sm, sc, st);
}
