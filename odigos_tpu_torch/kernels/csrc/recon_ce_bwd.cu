// K20: the backward pass of K11 (the autoencoder's decoder LayerNorm, four
// f32 heads and weighted reconstruction error) — for Hopper (sm_90a), f32
// (the trainer's working type).
//
// Replaces: the gradient XLA derives for the heads and the loss of
// odigos_tpu/models/autoencoder.py :81-98 and :112-120 (dec_ln's output
// into Dense(service_vocab), Dense(name_vocab), Dense(8), Dense(1), _ce and
// the squared error), inside the jitted value_and_grad of
// odigos_tpu/training/trainer.py:171. The JAX package has no Pallas kernel
// here; the trainer's step on the card needs a hand-written one.
//
// At each real position p (derr_p the upstream gradient of its error, lse
// the three log-sum-exps K11's f32 kernel wrote in the forward):
//   y_p      = dec_ln(dec_p), recomputed with ln_exact.cuh (K11 writes
//              neither y nor the logits; the same bits as the forward);
//   z_h      = y_p W_h^T + b_h for the four heads (f32 FMAs);
//   dlogit_h = (w_h derr_p) (exp(z_h - lse_h) - onehot(label_h)), h < 3,
//              zero where the label takes no row of the head (embed_take.cuh
//              take_label: the reference's fill-mode gather drops it);
//   ddur     = (w_d derr_p) (2 (z_3 - cont_p[0]));
//   dy_p     = sum_h dlogit_h W_h   (the gradient at dec_ln's output);
// and over the real positions dW_h = dlogit_h^T y, db_h = sum dlogit_h.
// dy is 0 at padding (the caller zero-fills it; only real rows are
// written). K17 (ln_bwd.cu) then takes dy through dec_ln.
//
// Three launches, no atomics (a step is reproducible):
//   list  one CTA lists the real positions in ascending order (ballots, a
//         running base) and their count, on the card (no host sync);
//   rows  a CTA per (tile of 16 TS listed positions, vocabulary slice of at
//         most 128 rows of one head; 128 measured faster than 64 and 256:
//         two CTAs an SM, each streaming fewer rows): it normalises its
//         positions into shared memory (a warp a position), streams the
//         slice's weight rows in tiles of 16 TS (K11's f32 tiling: thread
//         (tp, tv) computes TS x TS logits), forms dlogit there, writes it
//         at the position's listed index (dl, (count, V) f32, V = the four
//         heads' rows) and into shared memory, and adds dlogit . W to the
//         same TS positions' dy in registers (each weight vector read from
//         shared memory feeds TS positions); the slice's dy goes out as a
//         partial (S, count, d), and the first slice also writes y at the
//         listed index;
//   cols  a CTA per (32 head rows, 64 columns of d) sums dlogit^T y over the
//         listed positions in order (64 at a time through shared memory,
//         the next 64's loads in flight meanwhile), the first column tile
//         also db; further CTAs sum each listed position's S dy partials
//         in order into dy.
// dlogit is kept (the 611 real positions of the trainer's step: 6.3 MB
// written and read, in L2) rather than recomputed in `cols`, which would
// redo the logits' product (0.4 GFLOP) and the LayerNorm there.
//
// Bound on the card: operations. Three products of 2 P V d flops (the
// logits, dy and dW) at P real positions, V = 2569 and d = 128: 1.2 GFLOP
// at P = 611, 0.018 ms at 67 TFLOP/s f32. The measured times are in
// PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "embed_take.cuh"
#include "ln_exact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kListThreads = 1024;
constexpr int kSlice = 128;   // vocabulary rows a slice of launch `rows`
constexpr int kBRows = 32;    // launch `cols`: head rows a tile
constexpr int kBCols = 64;    // ... columns of d a tile
constexpr int kBChunk = 64;   // ... listed positions staged at a time
constexpr int kRedRows = 32;  // ... listed positions a dy-reduction CTA

struct Heads {
  const float* w[4];  // (V_h, d) f32, torch Linear layout
  const float* b[4];  // (V_h,) f32
  int v[4];
  int off[4];  // first row of head h among the V = sum V_h rows
  float wt[4];  // the loss weights
};

__host__ __device__ inline int slices_of(int v) {
  return (v + kSlice - 1) / kSlice;
}

// ---------------------------------------------------------------- list
__global__ void __launch_bounds__(kListThreads)
list_kernel(const uint8_t* __restrict__ mask, long long M,
            int32_t* __restrict__ list, int32_t* __restrict__ count) {
  __shared__ int s_cnt[kListThreads / 32];
  __shared__ int s_base;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  if (tid == 0) s_base = 0;
  __syncthreads();
  for (long long b = 0; b < M; b += kListThreads) {
    const long long pos = b + tid;
    const bool real = pos < M && mask[pos] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, real);
    if (lane == 0) s_cnt[wid] = __popc(bal);
    __syncthreads();
    int off = s_base, total = 0;
#pragma unroll 8
    for (int w = 0; w < kListThreads / 32; ++w) {
      const int c = s_cnt[w];
      off += w < wid ? c : 0;
      total += c;
    }
    if (real) list[off + __popc(bal & ((1u << lane) - 1u))] = (int32_t)pos;
    __syncthreads();  // s_base and s_cnt read by every thread
    if (tid == 0) s_base += total;
    __syncthreads();
  }
  if (tid == 0) *count = s_base;
}

// ---------------------------------------------------------------- rows
// TS: positions a tile 16 TS, weight rows a tile 16 TS (thread (tp, tv)
// the TS x TS logits of positions tp * TS + i and rows tv + 16 j, and the
// dy of the same TS positions at the float4 columns tv + 16 k, k < NC4:
// a weight row's NC4 vectors then feed TS positions each); PER: each
// lane's share of a position's LayerNorm (d <= 32 PER).
template <int PER, int TS, int NC4>
__global__ void __launch_bounds__(kThreads) recon_bwd_rows_kernel(
    const float* __restrict__ dec, long long M, int d,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float eps, Heads heads, const float* __restrict__ lse,
    const int32_t* __restrict__ cat, int C, const float* __restrict__ cont,
    int D, const float* __restrict__ derr, const int32_t* __restrict__ list,
    const int32_t* __restrict__ count, int vtot, float* __restrict__ dl,
    float* __restrict__ ybuf, float* __restrict__ dy_part) {
  constexpr int kTP = 16 * TS;
  constexpr int kVR = 16 * TS;
  constexpr int kLdl = kVR + 1;
  const int ld = d + 4;
  extern __shared__ float4 smem4[];
  float* s_y = reinterpret_cast<float*>(smem4);  // (kTP, ld)
  float* s_w = s_y + kTP * ld;                   // (kVR, ld)
  float* s_dl = s_w + kVR * ld;                  // (kTP, kLdl)
  __shared__ int s_lab[kTP];
  __shared__ float s_lse[kTP], s_coef[kTP], s_c0[kTP];

  const int n = *count;
  const int t0 = blockIdx.x * kTP;
  if (t0 >= n) return;  // CTA-uniform
  const int np = min(kTP, n - t0);
  int s = blockIdx.y, h = 0;
  for (; h < 3; ++h) {
    const int ns = slices_of(heads.v[h]);
    if (s < ns) break;
    s -= ns;
  }
  const int V = heads.v[h];
  const int v_begin = s * kSlice, v_end = min(V, v_begin + kSlice);
  const float* __restrict__ W = heads.w[h];
  const float* __restrict__ B = heads.b[h];
  const float wh = heads.wt[h];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;

  // ---- dec_ln of the tile's positions, a warp a position
  for (int p = wid; p < kTP; p += kWarps) {
    float y[PER];
    if (p < np) {
      const long long q = list[t0 + p];
      warp_ln_row_strided<float, PER>(dec + q * d, d, gamma, beta, eps, y);
      if (lane == 0) {
        s_coef[p] = __fmul_rn(wh, derr[q]);
        if (h < 3) {
          // a label no row of the head holds (take_label -1): the head's
          // dlogit is zero at this position, as jax.grad gives through the
          // fill-mode gather
          const int lab = take_label(cat[q * C + h], V);
          s_lab[p] = lab;
          if (lab < 0) s_coef[p] = 0.f;
          s_lse[p] = lse[q * 3 + h];
          s_c0[p] = 0.f;
        } else {
          s_lab[p] = -1;
          s_lse[p] = 0.f;
          s_c0[p] = cont[q * D];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < PER; ++j) y[j] = 0.f;
      if (lane == 0) {
        s_coef[p] = 0.f;
        s_lab[p] = -1;
        s_lse[p] = 0.f;
        s_c0[p] = 0.f;
      }
    }
    float* yr = s_y + p * ld;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int f = j * 32 + lane;
      if (f < d) {
        yr[f] = y[j];
        if (p < np && blockIdx.y == 0)
          ybuf[(long long)(t0 + p) * d + f] = y[j];
      }
    }
  }

  const int tp = tid >> 4, tv = tid & 15;
  const int d4 = d / 4;
  float4 acc_dy[TS][NC4];
#pragma unroll
  for (int i = 0; i < TS; ++i)
#pragma unroll
    for (int k = 0; k < NC4; ++k)
      acc_dy[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int v0 = v_begin; v0 < v_end; v0 += kVR) {
    __syncthreads();  // s_y written / the previous tiles read
    for (int e = tid; e < kVR * d4; e += kThreads) {
      const int r = e / d4, c4 = e % d4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v0 + r < v_end)
        val = __ldg(reinterpret_cast<const float4*>(
            W + (long long)(v0 + r) * d) + c4);
      reinterpret_cast<float4*>(s_w + r * ld)[c4] = val;
    }
    __syncthreads();
    float acc[TS][TS];
#pragma unroll
    for (int i = 0; i < TS; ++i)
#pragma unroll
      for (int j = 0; j < TS; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < d; k += 4) {
      float4 yv[TS], wv[TS];
#pragma unroll
      for (int i = 0; i < TS; ++i)
        yv[i] = *reinterpret_cast<const float4*>(s_y + (tp * TS + i) * ld +
                                                 k);
#pragma unroll
      for (int j = 0; j < TS; ++j)
        wv[j] = *reinterpret_cast<const float4*>(s_w + (tv + 16 * j) * ld +
                                                 k);
#pragma unroll
      for (int i = 0; i < TS; ++i)
#pragma unroll
        for (int j = 0; j < TS; ++j) {
          float a = acc[i][j];
          a = fmaf(yv[i].x, wv[j].x, a);
          a = fmaf(yv[i].y, wv[j].y, a);
          a = fmaf(yv[i].z, wv[j].z, a);
          a = fmaf(yv[i].w, wv[j].w, a);
          acc[i][j] = a;
        }
    }
    // ---- dlogit, into shared memory and (real positions) device memory
#pragma unroll
    for (int j = 0; j < TS; ++j) {
      const int r = tv + 16 * j;
      const int v = v0 + r;
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        const int p = tp * TS + i;
        float g = 0.f;
        if (v < v_end) {
          const float z = __fadd_rn(acc[i][j], B[v]);
          if (h < 3) {
            float pr = expf(__fsub_rn(z, s_lse[p]));
            if (v == s_lab[p]) pr = __fsub_rn(pr, 1.f);
            g = __fmul_rn(pr, s_coef[p]);
          } else {
            g = __fmul_rn(s_coef[p], __fmul_rn(2.f, __fsub_rn(z, s_c0[p])));
          }
          if (p < np)
            dl[(long long)(t0 + p) * vtot + heads.off[h] + v] = g;
        }
        s_dl[p * kLdl + r] = g;
      }
    }
    __syncthreads();
    // ---- dy += dlogit . W over the tile's rows (0 past the slice)
#pragma unroll 2
    for (int r = 0; r < kVR; ++r) {
      float a[TS];
#pragma unroll
      for (int i = 0; i < TS; ++i) a[i] = s_dl[(tp * TS + i) * kLdl + r];
      const float4* wr = reinterpret_cast<const float4*>(s_w + r * ld);
#pragma unroll
      for (int k = 0; k < NC4; ++k) {
        const int c4 = tv + 16 * k;
        if (c4 < d4) {
          const float4 w = wr[c4];
#pragma unroll
          for (int i = 0; i < TS; ++i) {
            acc_dy[i][k].x = fmaf(a[i], w.x, acc_dy[i][k].x);
            acc_dy[i][k].y = fmaf(a[i], w.y, acc_dy[i][k].y);
            acc_dy[i][k].z = fmaf(a[i], w.z, acc_dy[i][k].z);
            acc_dy[i][k].w = fmaf(a[i], w.w, acc_dy[i][k].w);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TS; ++i) {
    const int p = tp * TS + i;
    if (p >= np) continue;
    float4* out = reinterpret_cast<float4*>(
        dy_part + ((long long)blockIdx.y * M + t0 + p) * d);
#pragma unroll
    for (int k = 0; k < NC4; ++k) {
      const int c4 = tv + 16 * k;
      if (c4 < d4) out[c4] = acc_dy[i][k];
    }
  }
}

// ---------------------------------------------------------------- cols
__global__ void __launch_bounds__(kThreads) recon_bwd_cols_kernel(
    const float* __restrict__ dl, const float* __restrict__ ybuf,
    const float* __restrict__ dy_part, const int32_t* __restrict__ list,
    const int32_t* __restrict__ count, int vtot, int d, long long M, int S,
    int nvt, int ndt, float* __restrict__ dw, float* __restrict__ db,
    float* __restrict__ dy) {
  const int n = *count;
  const int tid = threadIdx.x;
  int b = blockIdx.x;
  if (b >= nvt * ndt) {  // dy: each listed position's S partials in order
    const long long r0 = (long long)(b - nvt * ndt) * kRedRows;
    for (int e = tid; e < kRedRows * d; e += kThreads) {
      const long long i = r0 + e / d;
      const int k = e % d;
      if (i >= n) break;  // e only grows
      float s = 0.f;
      for (int sl = 0; sl < S; ++sl)
        s = __fadd_rn(s, dy_part[((long long)sl * M + i) * d + k]);
      dy[(long long)list[i] * d + k] = s;
    }
    return;
  }
  // a chunk of kBChunk positions: kBChunk x kBRows dlogit values and
  // kBChunk x kBCols / 4 y vectors, staged a thread kDl and kYv at a time;
  // the next chunk's loads are in flight while the current one is summed
  constexpr int kDl = kBChunk * kBRows / kThreads;
  constexpr int kYv = kBChunk * (kBCols / 4) / kThreads;
  __shared__ float s_dl[kBChunk][kBRows + 1];
  __shared__ float4 s_y4[kBChunk][kBCols / 4];
  const int vt = b / ndt, dt = b % ndt;
  const int v0 = vt * kBRows, k0 = dt * kBCols;
  const int tr = tid >> 4, tc = tid & 15;  // rows v0 + tr + 16 a, cols 4 tc
  float4 acc[kBRows / 16];
#pragma unroll
  for (int a = 0; a < kBRows / 16; ++a)
    acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
  float dbs = 0.f;
  float pre_dl[kDl];
  float4 pre_y[kYv];
  auto fetch = [&](int i0) {
    const int nc = min(kBChunk, n - i0);
#pragma unroll
    for (int j = 0; j < kDl; ++j) {
      const int e = tid + j * kThreads;
      const int ii = e / kBRows, vv = e % kBRows;
      pre_dl[j] = ii < nc && v0 + vv < vtot
                      ? dl[(long long)(i0 + ii) * vtot + v0 + vv]
                      : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kYv; ++j) {
      const int e = tid + j * kThreads;
      const int ii = e / (kBCols / 4), c4 = e % (kBCols / 4);
      const int k = k0 + 4 * c4;
      pre_y[j] = ii < nc && k < d
                     ? *reinterpret_cast<const float4*>(
                           ybuf + (long long)(i0 + ii) * d + k)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  if (n > 0) fetch(0);
  for (int i0 = 0; i0 < n; i0 += kBChunk) {
    const int nc = min(kBChunk, n - i0);
    __syncthreads();  // the previous chunk read
#pragma unroll
    for (int j = 0; j < kDl; ++j) {
      const int e = tid + j * kThreads;
      s_dl[e / kBRows][e % kBRows] = pre_dl[j];
    }
#pragma unroll
    for (int j = 0; j < kYv; ++j) {
      const int e = tid + j * kThreads;
      s_y4[e / (kBCols / 4)][e % (kBCols / 4)] = pre_y[j];
    }
    __syncthreads();
    if (i0 + kBChunk < n) fetch(i0 + kBChunk);
    for (int ii = 0; ii < nc; ++ii) {
      const float4 yv = s_y4[ii][tc];
#pragma unroll
      for (int a = 0; a < kBRows / 16; ++a) {
        const float g = s_dl[ii][tr + 16 * a];
        acc[a].x = fmaf(g, yv.x, acc[a].x);
        acc[a].y = fmaf(g, yv.y, acc[a].y);
        acc[a].z = fmaf(g, yv.z, acc[a].z);
        acc[a].w = fmaf(g, yv.w, acc[a].w);
      }
    }
    if (dt == 0 && tid < kBRows)
      for (int ii = 0; ii < nc; ++ii) dbs = __fadd_rn(dbs, s_dl[ii][tid]);
  }
#pragma unroll
  for (int a = 0; a < kBRows / 16; ++a) {
    const int v = v0 + tr + 16 * a;
    const int k = k0 + 4 * tc;
    if (v < vtot && k < d)
      *reinterpret_cast<float4*>(dw + (long long)v * d + k) = acc[a];
  }
  if (dt == 0 && tid < kBRows && v0 + tid < vtot) db[v0 + tid] = dbs;
}

template <int PER, int TS, int NC4>
int launch_rows(const float* dec, long long M, int d, const float* gamma,
                const float* beta, float eps, const Heads& heads,
                const float* lse, const int32_t* cat, int C,
                const float* cont, int D, const float* derr,
                const int32_t* list, const int32_t* count, int vtot,
                float* dl, float* ybuf, float* dy_part, int S,
                cudaStream_t st) {
  constexpr int kTP = 16 * TS;
  const int smem =
      (2 * kTP * (d + 4) + kTP * (kTP + 1)) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      recon_bwd_rows_kernel<PER, TS, NC4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (M + kTP - 1) / kTP;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  recon_bwd_rows_kernel<PER, TS, NC4>
      <<<dim3((unsigned)tiles, (unsigned)S), kThreads, smem, st>>>(
          dec, M, d, gamma, beta, eps, heads, lse, cat, C, cont, D, derr,
          list, count, vtot, dl, ybuf, dy_part);
  return (int)cudaGetLastError();
}

}  // namespace

// The vocabulary slices of launch `rows` (the dy partials' first axis).
extern "C" int recon_ce_bwd_slices(int v0, int v1, int v2, int v3) {
  return slices_of(v0) + slices_of(v1) + slices_of(v2) + slices_of(v3);
}

// K20. dec: (M, d) f32, the decoder's output before dec_ln, 16-byte
// aligned, d % 4 == 0 up to 1024; gamma, beta: (d,) f32; w0..w3 (16-byte
// aligned) and b0..b3: the service, name, kind and duration heads, (V_h, d)
// and (V_h,) f32 (V_3 = 1); lse: (M, 3) f32, K11's log-sum-exps; cat: (M,
// C) int32, cont: (M, D) f32, mask: (M,) bytes; derr: (M,) f32, the
// gradient of each position's error; the four loss weights. Scratch: list
// (M,) and count (1,) int32, dl (M, V) f32, ybuf (M, d) f32, dy_part
// (recon_ce_bwd_slices(...), M, d) f32 (V = sum V_h). Out: dy (M, d) f32,
// zero-filled by the caller (real rows written); dw (V, d) and db (V,) f32,
// the four heads' gradients stacked in order.
extern "C" int recon_ce_bwd_launch(
    const void* dec, long long M, int d, const void* gamma, const void* beta,
    float eps, const void* w0, const void* w1, const void* w2,
    const void* w3, const void* b0, const void* b1, const void* b2,
    const void* b3, int v0, int v1, int v2, int v3, const void* lse,
    const void* cat, int C, const void* cont, int D, const void* mask,
    const void* derr, float w_s, float w_n, float w_k, float w_d, void* list,
    void* count, void* dl, void* ybuf, void* dy_part, void* dy, void* dw,
    void* db, void* stream) {
  if (M <= 0 || M > 0x7fffffffLL || v0 < 1 || v1 < 1 || v2 < 1 || v3 != 1 ||
      C < 3 || D < 1 || d < 4 || d % 4 != 0 || d > 1024)
    return (int)cudaErrorInvalidValue;
  Heads heads;
  const void* ws[4] = {w0, w1, w2, w3};
  const void* bs[4] = {b0, b1, b2, b3};
  const int vs[4] = {v0, v1, v2, v3};
  const float wts[4] = {w_s, w_n, w_k, w_d};
  int vtot = 0;
  for (int h = 0; h < 4; ++h) {
    heads.w[h] = static_cast<const float*>(ws[h]);
    heads.b[h] = static_cast<const float*>(bs[h]);
    heads.v[h] = vs[h];
    heads.off[h] = vtot;
    heads.wt[h] = wts[h];
    vtot += vs[h];
  }
  const int S = recon_ce_bwd_slices(v0, v1, v2, v3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* li = static_cast<int32_t*>(list);
  auto* cn = static_cast<int32_t*>(count);
  list_kernel<<<1, kListThreads, 0, st>>>(static_cast<const uint8_t*>(mask),
                                          M, li, cn);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const auto* x = static_cast<const float*>(dec);
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* ls = static_cast<const float*>(lse);
  const auto* ct = static_cast<const int32_t*>(cat);
  const auto* cf = static_cast<const float*>(cont);
  const auto* de = static_cast<const float*>(derr);
  auto* dlp = static_cast<float*>(dl);
  auto* yb = static_cast<float*>(ybuf);
  auto* dp = static_cast<float*>(dy_part);
  int rc;
  // the tile by d: 64 positions up to d 128, 32 to 256, 16 past (dy's
  // registers: TS x 4 NC4 = 16 TS x d / 256 a thread)
  if (d <= 128)
    rc = launch_rows<4, 4, 2>(x, M, d, g, bt, eps, heads, ls, ct, C, cf, D,
                              de, li, cn, vtot, dlp, yb, dp, S, st);
  else if (d <= 256)
    rc = launch_rows<8, 2, 4>(x, M, d, g, bt, eps, heads, ls, ct, C, cf, D,
                              de, li, cn, vtot, dlp, yb, dp, S, st);
  else if (d <= 512)
    rc = launch_rows<16, 1, 8>(x, M, d, g, bt, eps, heads, ls, ct, C, cf, D,
                               de, li, cn, vtot, dlp, yb, dp, S, st);
  else
    rc = launch_rows<32, 1, 16>(x, M, d, g, bt, eps, heads, ls, ct, C, cf,
                                D, de, li, cn, vtot, dlp, yb, dp, S, st);
  if (rc != 0) return rc;
  const int nvt = (vtot + kBRows - 1) / kBRows;
  const int ndt = (d + kBCols - 1) / kBCols;
  const long long nred = (M + kRedRows - 1) / kRedRows;
  const long long blocks = (long long)nvt * ndt + nred;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  recon_bwd_cols_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      dlp, yb, dp, li, cn, vtot, d, M, S, nvt, ndt, static_cast<float*>(dw),
      static_cast<float*>(db), static_cast<float*>(dy));
  return (int)cudaGetLastError();
}
