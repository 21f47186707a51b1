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
// dy is 0 at padding. K17 (ln_bwd.cu) then takes dy through dec_ln.
//
// Slice mode (a shard of the "model" axis, K11's slice mode in the forward):
// the service and name heads are this shard's rows [lo, lo + v) of heads of
// vf rows and lse is the whole heads' (K24's merge). A label is read
// against the whole head: one no row of it holds zeroes the head's dlogit
// at the position, one in another shard's slice leaves it the softmax
// (embed_take.cuh take_slice_label: no onehot here). dy_heads names the
// heads whose dlogit . W enters this shard's dy: the sliced heads on every
// shard, a head every shard holds whole on one of them only, so that the
// sum of the shards' dy over the axis counts it once; dW and db are every
// head's. The mode is a template argument (SLICED) of both kernels: the
// launcher takes the unsliced instantiation, the first design's code,
// where vf = v, lo = 0 and every head is in dy_heads.
//
// The f32 chains are the first design's, kept to the bit whatever the
// grid: a logit is one fmaf chain over k ascending from 0, plus the bias;
// dy is, a vocabulary slice at a time (128 rows aligned to each head's
// start), one fmaf chain from 0 over the slice's rows in order, the
// slices' results added with __fadd_rn from 0 in slice order; dW[v, k] one
// fmaf chain from 0 and db[v] one __fadd_rn chain from 0 over the listed
// positions in order.
//
// Bound on the card: operations. Three products of 2 P V d flops (the
// logits, dy and dW) at P real positions, V = 2569 and d = 128: 1.22
// GFLOP at P = 619, 0.018 ms at 67 TFLOP/s f32. The first design took
// three launches and a fill: its row kernel's grid was sized from M, so
// most of its CTAs exited at once, each working CTA recomputed dec_ln for
// its positions (22 times over), loaded a weight tile, waited, then
// multiplied; dy's slice partials went out and came back through a third
// grid, and dW was a latency-bound pass of one CTA an SM. This one:
//
// Two launches, paired by programmatic dependent launch, no float atomics
// (a step is reproducible):
//   prep  a CTA per run of positions counts the real ones before its run
//         (so the list stays in position order with no grid-wide scan),
//         lists its own, normalises each listed position once (a warp a
//         position, the first design's warp_ln_row_strided bits) into y at
//         its listed index with the position's per-head coefficient,
//         label, log-sum-exp and target, and zeroes dy's padding rows;
//   main  persistent CTAs (one an SM) draw work items by ticket: first a
//         (tile of listed positions, vocabulary slice) item for each tile
//         the count needs, slice-major, then a (32 head rows, 64 columns)
//         dW item for each block of dW. A slice item stages its positions'
//         y once and the slice's biases, streams the slice's weight rows
//         through a two-stage cp.async ring (the next tile's loads in
//         flight during this one's products), forms the logits (thread
//         (tp, tv) TS x TS of them), dlogit into shared memory (then out,
//         coalesced, to a (count, V) scratch for dW) and adds dlogit . W
//         to the same positions' dy in registers (each weight vector read
//         from shared memory feeds TS positions); its dy partial goes to a
//         scratch, and the tile's last item (a ticket) adds the tile's S
//         partials in slice order and writes dy's real rows. A dW item
//         waits until every tile of the slices its rows lie in has written
//         dlogit, then runs the positions 64 at a time through a two-stage
//         cp.async ring on 4 warps, a thread 4 rows x 4 columns (16 fmaf
//         chains, two 16-byte shared-memory reads a position), 8 lanes of
//         warp 0 also carrying the rows' db chains.
// Co-residency: every slice item holds a lower ticket than every dW item
// and never waits, so a dW item waits only on items that CTAs already
// running hold, however few CTAs the card makes room for.
// The counters (tickets, each slice's finished tiles, each tile's
// finished slices) are left zero by every call: the folders reset their
// tile's, the last CTA out the rest.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "embed_take.cuh"
#include "ln_exact.cuh"

namespace {

constexpr int kThreads = 256;     // main: a CTA, one an SM
constexpr int kCtasPerSm = 1;      // ... the occupancy it is built for
constexpr int kPrepThreads = 256;  // prep: a CTA
constexpr int kWarps = kPrepThreads / 32;
constexpr int kSlice = 128;        // vocabulary rows a slice item
constexpr int kPrepPos = 32;       // prep: positions a CTA, at least
constexpr int kPrepMaxCtas = 1024; // ... and at most this many CTAs
constexpr int kBRows = 32;         // dW item: head rows
constexpr int kBCols = 64;         // ... columns of d (its warps: 4)
constexpr int kBChunk = 64;        // ... positions a ring stage
constexpr int kFoldBatch = 24;     // dy partials a folder loads at once
constexpr int kLead = 4;  // counters before the slices': the item ticket
                          // (64 bits), the CTAs out, a pad

struct Heads {
  const float* w[4];  // (V_h, d) f32, torch Linear layout
  const float* b[4];  // (V_h,) f32
  int v[4];
  int off[4];  // first row of head h among the V = sum V_h rows
  float wt[4];  // the loss weights
};

// slice mode: the service and name heads' whole widths and the first row
// of this shard's slice (the prep launch's label rule)
struct SliceOf {
  int vf[2], lo[2];
};

__host__ __device__ inline int slices_of(int v) {
  return (v + kSlice - 1) / kSlice;
}

__host__ __device__ inline long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// the tile geometry by d: positions a tile (kThreads / 16) TS, weight
// rows a ring stage 16 TS; dy's float4 columns a thread NC4 (d <= 64 NC4)
__host__ __device__ inline int tile_ts(int d) {
  return d <= 128 ? 4 : d <= 256 ? 2 : 1;
}

__host__ __device__ constexpr int tile_positions(int ts) {
  return kThreads / 16 * ts;
}

// The scratch's regions, in bytes from its start (each 256-byte aligned):
// the list and count; per listed position its coefficients, labels and
// (log-sum-exps, target) four each; y; dlogit (count, vp); dy partials.
struct Layout {
  long long list, count, coef, lab, aux, y, dl, part, total;
  int vp;  // dlogit's row pitch: V rounded up to 4
};

__host__ __device__ inline Layout layout_of(long long M, int d, int vtot,
                                            int S) {
  Layout o;
  const int kTP = tile_positions(tile_ts(d));
  const long long tiles = (M + kTP - 1) / kTP;
  o.vp = (int)round_up(vtot, 4);
  long long at = 0;
  auto take = [&](long long bytes) {
    const long long here = at;
    at = round_up(at + bytes, 256);
    return here;
  };
  o.list = take(M * 4);
  o.count = take(16);
  o.coef = take(M * 16);
  o.lab = take(M * 16);
  o.aux = take(M * 16);
  o.y = take(M * d * 4);
  o.dl = take(M * (long long)o.vp * 4);
  o.part = take(tiles * S * kTP * (long long)d * 4);
  o.total = at;
  return o;
}

__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// cp.async of 16 bytes, zero-filled where `on` is false (src unread)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool on) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(src), "r"(on ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- prep
// warp_ln_row_strided's arithmetic on a row already in registers (v: the
// values k, k + 32, ... of this lane, 0 past d): the same bits
template <int PER>
__device__ __forceinline__ void ln_row_in(const float (&v)[PER], int d,
                                          const float* __restrict__ g,
                                          const float* __restrict__ b,
                                          float eps, float (&y)[PER]) {
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
  const float* tag = nullptr;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int f = j * 32 + lane;
    y[j] = f < d ? ln_out(v[j], mean, rstd, g[f], b[f], tag) : 0.f;
  }
}

// positions [p0, p0 + P) a CTA, 32 at a time; d <= 32 PER; sl: the
// slice (read where SLICED)
template <int PER, bool SLICED>
__global__ void __launch_bounds__(kPrepThreads) recon_bwd_prep_kernel(
    const float* __restrict__ dec, long long M, int d,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float eps, Heads heads, const float* __restrict__ lse,
    const int32_t* __restrict__ cat, int C, const float* __restrict__ cont,
    int D, const uint8_t* __restrict__ mask,
    const float* __restrict__ derr, long long P,
    int32_t* __restrict__ list, int32_t* __restrict__ count,
    float* __restrict__ coef, int32_t* __restrict__ lab,
    float* __restrict__ aux, float* __restrict__ ybuf,
    float* __restrict__ dy, SliceOf sl) {
  // rows a warp has in flight (their loads issued together)
  constexpr int R = PER <= 4 ? 4 : PER <= 8 ? 2 : 1;
  launch_dependents();
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long p0 = (long long)blockIdx.x * P;
  const long long p1 = p0 + P < M ? p0 + P : M;
  const int d4 = d / 4;
  // the real positions before this CTA's run
  int base = 0;
  for (long long q0 = 0; q0 < p0; q0 += kPrepThreads)
    base += __syncthreads_count(q0 + tid < p0 && mask[q0 + tid] != 0);
  for (long long c0 = p0; c0 < p1; c0 += 32) {  // CTA-uniform
    // every warp reads the chunk's 32 mask bytes: the same ballot
    const bool in = c0 + lane < p1;
    const unsigned real =
        __ballot_sync(0xffffffffu, in && mask[c0 + lane] != 0);
    const unsigned pad =
        __ballot_sync(0xffffffffu, in) & ~real;
    const int nreal = __popc(real);
    // the chunk's real rows: the k-th to warp k mod 8, R at a time
    for (int k0 = wid; k0 < nreal; k0 += kWarps * R) {  // warp-uniform
      long long q[R];
      float v[R][PER];
      float a[R];
      int lb[R];
      float c[R];
      {
        unsigned rem = real;
        for (int i = 0; i < k0; ++i) rem &= rem - 1;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          q[r] = rem ? c0 + __ffs(rem) - 1 : -1;
          for (int i = 0; i < kWarps; ++i) rem &= rem - 1;
        }
      }
      // the rows' loads and each lane h < 4's head data, issued together
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool on = q[r] >= 0;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int f = j * 32 + lane;
          v[r][j] = on && f < d ? dec[q[r] * d + f] : 0.f;
        }
        a[r] = 0.f;
        lb[r] = -1;
        c[r] = 0.f;
        if (on && lane < 4) {
          const int h = lane;
          c[r] = derr[q[r]];
          if (h < 3) {
            lb[r] = cat[q[r] * C + h];
            a[r] = lse[q[r] * 3 + h];
          } else {
            a[r] = cont[q[r] * D];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (q[r] < 0) continue;  // warp-uniform
        const int i = base + k0 + r * kWarps;  // the listed index
        float y[PER];
        ln_row_in<PER>(v[r], d, gamma, beta, eps, y);
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int f = j * 32 + lane;
          if (f < d) ybuf[(long long)i * d + f] = y[j];
        }
        if (lane == 0) list[i] = (int32_t)q[r];
        if (lane < 4) {
          const int h = lane;
          float cf = __fmul_rn(heads.wt[h], c[r]);
          int t = -1;
          if (h < 3) {
            // a label no row of the (whole) head holds (take_label -1):
            // the head's dlogit is zero at this position, as jax.grad
            // gives through the fill-mode gather; one in another
            // shard's slice keeps it (t = -1: no onehot here)
            if constexpr (SLICED) {
              const int vf = h < 2 ? sl.vf[h] : heads.v[h];
              if (take_label(lb[r], vf) < 0) cf = 0.f;
              t = h < 2 ? take_slice_label(lb[r], vf, sl.lo[h], heads.v[h])
                        : take_label(lb[r], vf);
            } else {
              t = take_label(lb[r], heads.v[h]);
              if (t < 0) cf = 0.f;
            }
          }
          coef[(long long)i * 4 + h] = cf;
          lab[(long long)i * 4 + h] = t;
          aux[(long long)i * 4 + h] = a[r];
        }
      }
    }
    // dy's padding rows: zero (the real ones are the folders'), the k-th
    // to warp k mod 8
    {
      unsigned rem = pad;
      for (int k = 0; rem; rem &= rem - 1, ++k) {
        if (k % kWarps != wid) continue;
        float4* out =
            reinterpret_cast<float4*>(dy + (c0 + __ffs(rem) - 1) * d);
        for (int e = lane; e < d4; e += 32)
          out[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    base += nreal;
  }
  if (blockIdx.x == gridDim.x - 1 && tid == 0) *count = base;
}

// ---------------------------------------------------------------- main
struct Work {
  Heads heads;
  const float* ybuf;
  const float* coef;
  const int32_t* lab;
  const float* aux;
  const int32_t* list;
  float* dl;
  float* part;
  float* dy;
  float* dw;
  float* db;
  int* cnt;
  int d, vtot, vp, S, n, ntiles;
};

constexpr int kSlack = 1024;  // floats past the last region: dy's reads
                              // of the columns past d (64 NC4 - d < 1024)

// shared-memory floats a CTA: the larger of a slice item's (y tile, the
// ring's two weight stages, dlogit transposed) and a dW item's (two
// stages of dlogit and y), and the slack
template <int TS>
__host__ __device__ inline int main_smem_floats(int d) {
  const int kTP = tile_positions(TS), kVR = 16 * TS, ld = d + 4;
  const int rows = kTP * ld + 2 * kVR * ld + kVR * (kTP + 4);
  const int cols = 2 * kBChunk * (kBRows + kBCols);
  return (rows > cols ? rows : cols) + kSlack;
}

// Where a (tile, slice) item reads: its head, rows, weight tiles.
struct SliceAt {
  int h, v_begin, v_end, nw, t0, np;
  const float* W;
  const float* B;
};

template <int TS>
__device__ __forceinline__ SliceAt slice_at(const Work& w, int tile, int s) {
  constexpr int kTP = tile_positions(TS);
  constexpr int kVR = 16 * TS;
  SliceAt a;
  a.h = 0;
  for (; a.h < 3; ++a.h) {
    const int ns = slices_of(w.heads.v[a.h]);
    if (s < ns) break;
    s -= ns;
  }
  const int V = w.heads.v[a.h];
  a.v_begin = s * kSlice;
  a.v_end = min(V, a.v_begin + kSlice);
  a.nw = (a.v_end - a.v_begin + kVR - 1) / kVR;  // ring tiles
  a.W = w.heads.w[a.h];
  a.B = w.heads.b[a.h];
  a.t0 = tile * kTP;
  a.np = min(kTP, w.n - a.t0);
  return a;
}

// cp.async of an item's y tile (into s_y) and of its weight tile j (into
// ring stage `stage` mod 2), not committed
template <int TS>
__device__ __forceinline__ void load_y(const Work& w, const SliceAt& a,
                                       float* s_y) {
  constexpr int kTP = tile_positions(TS);
  const int d = w.d, ld = d + 4, d4 = d / 4;
  for (int e = threadIdx.x; e < kTP * d4; e += kThreads) {
    const int p = e / d4, c4 = e % d4;
    cp16(s_y + p * ld + 4 * c4,
         p < a.np ? w.ybuf + (long long)(a.t0 + p) * d + 4 * c4 : w.ybuf,
         p < a.np);
  }
}

template <int TS>
__device__ __forceinline__ void load_w(const Work& w, const SliceAt& a,
                                       int j, float* s_w, int stage) {
  constexpr int kVR = 16 * TS;
  const int d = w.d, ld = d + 4, d4 = d / 4;
  const int v0 = a.v_begin + j * kVR;
  float* dst = s_w + (stage & 1) * kVR * ld;
  for (int e = threadIdx.x; e < kVR * d4; e += kThreads) {
    const int r = e / d4, c4 = e % d4;
    const bool on = v0 + r < a.v_end;
    cp16(dst + r * ld + 4 * c4,
         on ? a.W + (long long)(v0 + r) * d + 4 * c4 : a.W, on);
  }
}

// One (tile, slice) item: the logits, dlogit, and the slice's dy partial;
// the tile's last item folds the partials into dy. Its weight tile j
// lands in ring stage j. dy_heads: read where SLICED.
template <int TS, int NC4, bool SLICED>
__device__ void slice_item(const Work& w, int tile, int gs, float* smem,
                           float* s_coef, int* s_lab, float* s_lse,
                           float* s_c0, float* s_bias, int* s_flag,
                           int dy_heads) {
  constexpr int kTP = tile_positions(TS);
  constexpr int kVR = 16 * TS;
  constexpr int kLdt = kTP + 4;
  const int d = w.d, ld = d + 4, d4 = d / 4;
  float* s_y = smem;                   // (kTP, ld)
  float* s_w = s_y + kTP * ld;         // 2 x (kVR, ld)
  float* s_dlt = s_w + 2 * kVR * ld;   // (kVR, kLdt): dlogit, row-major
  const int tid = threadIdx.x;
  const SliceAt at = slice_at<TS>(w, tile, gs);
  const int h = at.h, v_begin = at.v_begin, v_end = at.v_end, nw = at.nw;
  const float* __restrict__ B = at.B;
  float* __restrict__ dl_out = w.dl + w.heads.off[h];  // head h's rows
  const int t0 = at.t0, np = at.np;

  // ---- the positions' y and the first two weight tiles, in flight
  load_y<TS>(w, at, s_y);
  load_w<TS>(w, at, 0, s_w, 0);
  cp_commit();
  if (nw > 1) {
    load_w<TS>(w, at, 1, s_w, 1);
    cp_commit();
  }
  for (int r = tid; r < kSlice; r += kThreads)  // the slice's biases
    s_bias[r] = v_begin + r < v_end ? B[v_begin + r] : 0.f;
  if (tid < kTP) {
    const int p = tid;
    if (p < np) {
      const long long i = (long long)(t0 + p) * 4 + h;
      s_coef[p] = w.coef[i];
      s_lab[p] = w.lab[i];
      s_lse[p] = h < 3 ? w.aux[i] : 0.f;
      s_c0[p] = h < 3 ? 0.f : w.aux[i];
    } else {
      s_coef[p] = 0.f;
      s_lab[p] = -1;
      s_lse[p] = 0.f;
      s_c0[p] = 0.f;
    }
  }

  const int tp = tid >> 4, tv = tid & 15;
  float4 acc_dy[TS][NC4];
#pragma unroll
  for (int i = 0; i < TS; ++i)
#pragma unroll
    for (int k = 0; k < NC4; ++k)
      acc_dy[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int j = 0; j < nw; ++j) {
    if (j + 1 < nw)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();  // tile j (and y) landed for every thread
    const float* sw = s_w + (j & 1) * kVR * ld;
    const int v0 = v_begin + j * kVR;
    float acc[TS][TS];
#pragma unroll
    for (int i = 0; i < TS; ++i)
#pragma unroll
      for (int jj = 0; jj < TS; ++jj) acc[i][jj] = 0.f;
#pragma unroll 4
    for (int k = 0; k < d; k += 4) {
      float4 yv[TS], wv[TS];
#pragma unroll
      for (int i = 0; i < TS; ++i)
        yv[i] = *reinterpret_cast<const float4*>(s_y + (tp * TS + i) * ld +
                                                 k);
#pragma unroll
      for (int jj = 0; jj < TS; ++jj)
        wv[jj] = *reinterpret_cast<const float4*>(sw + (tv + 16 * jj) * ld +
                                                  k);
#pragma unroll
      for (int i = 0; i < TS; ++i)
#pragma unroll
        for (int jj = 0; jj < TS; ++jj) {
          float a = acc[i][jj];
          a = fmaf(yv[i].x, wv[jj].x, a);
          a = fmaf(yv[i].y, wv[jj].y, a);
          a = fmaf(yv[i].z, wv[jj].z, a);
          a = fmaf(yv[i].w, wv[jj].w, a);
          acc[i][jj] = a;
        }
    }
    // ---- dlogit, into shared memory (row-major: a row's positions in
    // a run)
#pragma unroll
    for (int jj = 0; jj < TS; ++jj) {
      const int r = tv + 16 * jj;
      const int v = v0 + r;
      const float bias = s_bias[v - v_begin];
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        const int p = tp * TS + i;
        float g = 0.f;
        if (v < v_end) {
          const float z = __fadd_rn(acc[i][jj], bias);
          if (h < 3) {
            float pr = expf(__fsub_rn(z, s_lse[p]));
            if (v == s_lab[p]) pr = __fsub_rn(pr, 1.f);
            g = __fmul_rn(pr, s_coef[p]);
          } else {
            g = __fmul_rn(s_coef[p], __fmul_rn(2.f, __fsub_rn(z, s_c0[p])));
          }
        }
        s_dlt[r * kLdt + p] = g;
      }
    }
    __syncthreads();
    // ---- dy += dlogit . W over the tile's rows (0 past the slice)
#pragma unroll 2
    for (int r = 0; r < kVR; ++r) {
      float a[TS];
      if constexpr (TS == 4) {
        const float4 t = *reinterpret_cast<const float4*>(
            s_dlt + r * kLdt + tp * 4);
        a[0] = t.x;
        a[1] = t.y;
        a[2] = t.z;
        a[3] = t.w;
      } else {
#pragma unroll
        for (int i = 0; i < TS; ++i) a[i] = s_dlt[r * kLdt + tp * TS + i];
      }
      // no branch on d: a column past d reads the next row (or the slack
      // past the stages) into an accumulator that is never written out,
      // so the loads run ahead of the products
      const float4* wr = reinterpret_cast<const float4*>(sw + r * ld);
#pragma unroll
      for (int k = 0; k < NC4; ++k) {
        const float4 wq = wr[tv + 16 * k];
#pragma unroll
        for (int i = 0; i < TS; ++i) {
          acc_dy[i][k].x = fmaf(a[i], wq.x, acc_dy[i][k].x);
          acc_dy[i][k].y = fmaf(a[i], wq.y, acc_dy[i][k].y);
          acc_dy[i][k].z = fmaf(a[i], wq.z, acc_dy[i][k].z);
          acc_dy[i][k].w = fmaf(a[i], wq.w, acc_dy[i][k].w);
        }
      }
    }
    // ---- the real positions' dlogit out to the scratch for dW, a row of
    // the tile a run (coalesced)
    const int nr = min(kVR, v_end - v0);
    for (int e = tid; e < np * nr; e += kThreads) {
      const int p = e / nr, r = e % nr;
      dl_out[(long long)(t0 + p) * w.vp + v0 + r] = s_dlt[r * kLdt + p];
    }
    __syncthreads();  // stage j and s_dlt read
    if (j + 2 < nw) {
      load_w<TS>(w, at, j + 2, s_w, j + 2);
      cp_commit();
    }
  }
  // ---- the slice's dy partial: zero for a head not in dy_heads (its
  // products ran all the same, so the loop above is the unsliced one)
  if constexpr (SLICED) {
    if (!((dy_heads >> h) & 1)) {  // CTA-uniform
#pragma unroll
      for (int i = 0; i < TS; ++i)
#pragma unroll
        for (int k = 0; k < NC4; ++k)
          acc_dy[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  float* my = w.part + ((long long)tile * w.S + gs) * kTP * d;
#pragma unroll
  for (int i = 0; i < TS; ++i) {
    const int p = tp * TS + i;
    if (p >= np) continue;
    float4* out = reinterpret_cast<float4*>(my + (long long)p * d);
#pragma unroll
    for (int k = 0; k < NC4; ++k) {
      const int c4 = tv + 16 * k;
      if (c4 < d4) out[c4] = acc_dy[i][k];
    }
  }
  // ---- this slice's dlogit is out for this tile; the tile's last slice
  // item adds the tile's partials in slice order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    atomicAdd(w.cnt + kLead + gs, 1);
    *s_flag = atomicAdd(w.cnt + kLead + w.S + tile, 1) == w.S - 1;
  }
  __syncthreads();
  if (*s_flag) {
    __threadfence();
    const float4* src = reinterpret_cast<const float4*>(
        w.part + (long long)tile * w.S * kTP * d);
    const long long pitch4 = (long long)kTP * d4;  // a slice's partial
    for (int e = tid; e < np * d4; e += kThreads) {
      const int p = e / d4, c4 = e % d4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s0 = 0; s0 < w.S; s0 += kFoldBatch) {
        float4 v[kFoldBatch];
#pragma unroll
        for (int b = 0; b < kFoldBatch; ++b)
          v[b] = s0 + b < w.S
                     ? __ldcg(src + (s0 + b) * pitch4 + (long long)p * d4 +
                              c4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int b = 0; b < kFoldBatch; ++b)
          if (s0 + b < w.S) {
            a.x = __fadd_rn(a.x, v[b].x);
            a.y = __fadd_rn(a.y, v[b].y);
            a.z = __fadd_rn(a.z, v[b].z);
            a.w = __fadd_rn(a.w, v[b].w);
          }
      }
      reinterpret_cast<float4*>(w.dy)[(long long)w.list[t0 + p] * d4 + c4] =
          a;
    }
    if (tid == 0) w.cnt[kLead + w.S + tile] = 0;
  }
  __syncthreads();  // s_flag and the shared tiles free for the next item
}

// the first global slice index of head h
__device__ __forceinline__ int slice_base(const Heads& hs, int h) {
  int b = 0;
  for (int i = 0; i < h; ++i) b += slices_of(hs.v[i]);
  return b;
}

// One dW item: head rows [v0, v0 + kBRows) of the stacked V, columns
// [k0, k0 + kBCols) of d; db too where k0 == 0.
__device__ void dw_item(const Work& w, int item, float* smem) {
  const int d = w.d;
  const int ndt = (d + kBCols - 1) / kBCols;
  const int v0 = (item / ndt) * kBRows, k0 = (item % ndt) * kBCols;
  const int v1 = min(w.vtot, v0 + kBRows);
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;

  // ---- wait until every tile of the slices these rows lie in is out
  if (tid == 0 && w.ntiles > 0) {
    for (int h = 0; h < 4; ++h) {
      const int lo = max(v0, w.heads.off[h]) - w.heads.off[h];
      const int hi = min(v1, w.heads.off[h] + w.heads.v[h]) - w.heads.off[h];
      if (lo >= hi) continue;
      const int base = slice_base(w.heads, h);
      for (int s = lo / kSlice; s <= (hi - 1) / kSlice; ++s)
        while (load_acquire(w.cnt + kLead + base + s) < w.ntiles)
          __nanosleep(256);
    }
  }
  __syncthreads();
  __threadfence();

  // a ring stage: kBChunk positions' dlogit (kBRows) and y (kBCols)
  constexpr int kStage = kBChunk * (kBRows + kBCols);
  auto load = [&](int c) {
    const int i0 = c * kBChunk;
    float* sd = smem + (c & 1) * kStage;
    float* sy = sd + kBChunk * kBRows;
    for (int e = tid; e < kBChunk * (kBRows / 4); e += kThreads) {
      const int ii = e / (kBRows / 4), q = e % (kBRows / 4);
      const int v = v0 + 4 * q;
      const bool on = i0 + ii < w.n && v < w.vp;
      cp16(sd + ii * kBRows + 4 * q,
           on ? w.dl + (long long)(i0 + ii) * w.vp + v : w.dl, on);
    }
    for (int e = tid; e < kBChunk * (kBCols / 4); e += kThreads) {
      const int ii = e / (kBCols / 4), q = e % (kBCols / 4);
      const int k = k0 + 4 * q;
      const bool on = i0 + ii < w.n && k < d;
      cp16(sy + ii * kBCols + 4 * q,
           on ? w.ybuf + (long long)(i0 + ii) * d + k : w.ybuf, on);
    }
    cp_commit();
  };
  // thread (wid, lane) of the first kDwWarps warps: rows 4 rq .. 4 rq +
  // 3, columns 4 cq .. 4 cq + 3; the other warps only stage. The item's
  // time is its positions' chain at the shared-memory rate of its warps,
  // so fewer warps a narrower item keep the rate an output and cut the
  // time an item (the launch's tail)
  constexpr int kRq = kBRows / 4;            // row quads
  constexpr int kWarpCols = 4 * (32 / kRq);  // columns a warp
  constexpr int kDwWarps = kBCols / kWarpCols;
  static_assert(kBCols % kWarpCols == 0 && kDwWarps <= kThreads / 32,
                "dW tile");
  const bool on = wid < kDwWarps;  // warp-uniform
  const int rq = lane % kRq, cq = lane / kRq + 32 / kRq * wid;
  // warp 0's lanes below kRq carry the item's rows' db chains
  const bool dbl = k0 == 0 && wid == 0 && lane < kRq;
  float4 acc[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  float dbs[4] = {0.f, 0.f, 0.f, 0.f};
  const int nc = (w.n + kBChunk - 1) / kBChunk;
  if (nc > 0) load(0);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      load(c + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* sd = smem + (c & 1) * kStage;
    const float* sy = sd + kBChunk * kBRows;
    const int len = on ? min(kBChunk, w.n - c * kBChunk) : 0;
    for (int ii = 0; ii < len; ++ii) {
      const float4 g = *reinterpret_cast<const float4*>(sd + ii * kBRows +
                                                        4 * rq);
      const float4 yv = *reinterpret_cast<const float4*>(sy + ii * kBCols +
                                                         4 * cq);
      const float gs[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r].x = fmaf(gs[r], yv.x, acc[r].x);
        acc[r].y = fmaf(gs[r], yv.y, acc[r].y);
        acc[r].z = fmaf(gs[r], yv.z, acc[r].z);
        acc[r].w = fmaf(gs[r], yv.w, acc[r].w);
      }
      if (dbl) {
#pragma unroll
        for (int r = 0; r < 4; ++r) dbs[r] = __fadd_rn(dbs[r], gs[r]);
      }
    }
    __syncthreads();  // stage c read before stage c + 2 is loaded
  }
  if (!on) return;
  const int k = k0 + 4 * cq;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int v = v0 + 4 * rq + r;
    if (v < v1 && k < d)
      *reinterpret_cast<float4*>(w.dw + (long long)v * d + k) = acc[r];
    if (dbl && v < v1) w.db[v] = dbs[r];
  }
}

template <int TS, int NC4, bool SLICED>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
recon_bwd_main_kernel(
    Heads heads, int d, const int32_t* __restrict__ count,
    const int32_t* __restrict__ list, const float* __restrict__ coef,
    const int32_t* __restrict__ lab, const float* __restrict__ aux,
    const float* __restrict__ ybuf, float* __restrict__ dl, int vtot,
    int vp, int S, float* __restrict__ part, float* __restrict__ dy,
    float* __restrict__ dw, float* __restrict__ db, int* __restrict__ cnt,
    int dy_heads) {
  constexpr int kTP = tile_positions(TS);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float s_coef[kTP], s_lse[kTP], s_c0[kTP], s_bias[kSlice];
  __shared__ int s_lab[kTP];
  __shared__ long long s_item;
  __shared__ int s_flag;
  wait_prior_grid();  // the prep grid's list, y and count
  Work w;
  w.heads = heads;
  w.ybuf = ybuf;
  w.coef = coef;
  w.lab = lab;
  w.aux = aux;
  w.list = list;
  w.dl = dl;
  w.part = part;
  w.dy = dy;
  w.dw = dw;
  w.db = db;
  w.cnt = cnt;
  w.d = d;
  w.vtot = vtot;
  w.vp = vp;
  w.S = S;
  w.n = *count;
  w.ntiles = (w.n + kTP - 1) / kTP;
  const long long slice_items = (long long)w.ntiles * S;
  const long long dw_items =
      (long long)((vtot + kBRows - 1) / kBRows) * ((d + kBCols - 1) / kBCols);
  const int tid = threadIdx.x;
  unsigned long long* ticket = reinterpret_cast<unsigned long long*>(cnt);
  for (;;) {
    if (tid == 0) s_item = (long long)atomicAdd(ticket, 1ull);
    __syncthreads();
    const long long item = s_item;
    __syncthreads();  // s_item read before a later draw rewrites it
    if (item >= slice_items + dw_items) break;  // CTA-uniform
    if (item < slice_items)
      slice_item<TS, NC4, SLICED>(w, (int)(item % w.ntiles),
                                  (int)(item / w.ntiles), smem, s_coef,
                                  s_lab, s_lse, s_c0, s_bias, &s_flag,
                                  dy_heads);
    else
      dw_item(w, (int)(item - slice_items), smem);
    __syncthreads();
  }
  // the last CTA out resets the ticket and the slices' counts
  if (tid == 0 && atomicAdd(cnt + 2, 1) == (int)gridDim.x - 1) {
    *ticket = 0ull;
    cnt[2] = 0;
    for (int s = 0; s < S; ++s) cnt[kLead + s] = 0;
  }
}

template <int PER, int TS, int NC4, bool SLICED>
int launch_all(const float* dec, long long M, int d, const float* gamma,
               const float* beta, float eps, const Heads& heads,
               const SliceOf& sl, int dy_heads,
               const float* lse, const int32_t* cat, int C, const float* cont,
               int D, const uint8_t* mask, const float* derr, int vtot, int S,
               int* cnt, char* scratch, float* dy, float* dw, float* db,
               int sms, int* launched, cudaStream_t st) {
  const Layout o = layout_of(M, d, vtot, S);
  auto* list = reinterpret_cast<int32_t*>(scratch + o.list);
  auto* count = reinterpret_cast<int32_t*>(scratch + o.count);
  auto* coef = reinterpret_cast<float*>(scratch + o.coef);
  auto* lab = reinterpret_cast<int32_t*>(scratch + o.lab);
  auto* aux = reinterpret_cast<float*>(scratch + o.aux);
  auto* ybuf = reinterpret_cast<float*>(scratch + o.y);
  auto* dl = reinterpret_cast<float*>(scratch + o.dl);
  auto* part = reinterpret_cast<float*>(scratch + o.part);
  const int smem = main_smem_floats<TS>(d) * (int)sizeof(float);
  // the most this instantiation takes: at its largest d (64 NC4)
  const int smem_max = main_smem_floats<TS>(64 * NC4) * (int)sizeof(float);
  auto* kernel = recon_bwd_main_kernel<TS, NC4, SLICED>;
  static int g_grid[kMaxDevices];  // the persistent grid, a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int* cached = dev < kMaxDevices ? &g_grid[dev] : nullptr;
  int grid = cached != nullptr ? *cached : 0;
  if (grid <= 0) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem_max);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid = sms * per_sm;
    if (cached != nullptr) *cached = grid;
  }
  // no more CTAs than the items could be
  const int kTP = tile_positions(TS);
  const long long most = (M + kTP - 1) / kTP * S +
                         (long long)((vtot + kBRows - 1) / kBRows) *
                             ((d + kBCols - 1) / kBCols);
  if (most < grid) grid = (int)most;

  const long long P = kPrepPos * ((M + (long long)kPrepPos * kPrepMaxCtas -
                                   1) / ((long long)kPrepPos * kPrepMaxCtas));
  const unsigned prep = (unsigned)((M + P - 1) / P);
  recon_bwd_prep_kernel<PER, SLICED><<<prep, kPrepThreads, 0, st>>>(
      dec, M, d, gamma, beta, eps, heads, lse, cat, C, cont, D, mask, derr,
      P, list, count, coef, lab, aux, ybuf, dy, sl);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ++*launched;

  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, heads, d, (const int32_t*)count,
                         (const int32_t*)list, (const float*)coef,
                         (const int32_t*)lab, (const float*)aux,
                         (const float*)ybuf, dl, vtot, o.vp, S, part, dy, dw,
                         db, cnt, dy_heads);
  if (e != cudaSuccess || (e = cudaGetLastError()) != cudaSuccess)
    return (int)e;
  ++*launched;
  return 0;
}

}  // namespace

// The vocabulary slices a tile's positions take (128 rows aligned to each
// head's start): the dy partials a tile.
extern "C" int recon_ce_bwd_slices(int v0, int v1, int v2, int v3) {
  return slices_of(v0) + slices_of(v1) + slices_of(v2) + slices_of(v3);
}

// The int32 counters a launch over M positions needs (zero before the
// first call, left zero by every call): the lead, a count a slice and a
// ticket a tile of listed positions (at the smallest tile, d > 256's).
extern "C" long long recon_ce_bwd_counters(long long M, int v0, int v1,
                                           int v2, int v3) {
  return kLead + recon_ce_bwd_slices(v0, v1, v2, v3) +
         (M + tile_positions(1) - 1) / tile_positions(1);
}

// The scratch a launch needs, in bytes (written before it is read).
extern "C" long long recon_ce_bwd_scratch(long long M, int d, int v0, int v1,
                                          int v2, int v3) {
  if (d <= 0) return -1;
  return layout_of(M, d, v0 + v1 + v2 + v3,
                   recon_ce_bwd_slices(v0, v1, v2, v3))
      .total;
}

// K20. dec: (M, d) f32, the decoder's output before dec_ln, 16-byte
// aligned, d % 4 == 0 up to 1024; gamma, beta: (d,) f32; w0..w3 (16-byte
// aligned) and b0..b3: the service, name, kind and duration heads, (V_h, d)
// and (V_h,) f32 (V_3 = 1); lse: (M, 3) f32, K11's log-sum-exps; cat: (M,
// C) int32, cont: (M, D) f32, mask: (M,) bytes; derr: (M,) f32, the
// gradient of each position's error; the four loss weights; vf0, lo0,
// vf1, lo1: the service and name heads' whole widths and the first row of
// the slice w0 and w1 hold (v0 = vf0, lo0 = 0 unsliced); dy_heads: bit h
// where head h's dlogit . W enters dy (15: every head). cnt:
// recon_ce_bwd_counters(...) int32, zero before the first call and reused
// as each call leaves it; scratch: recon_ce_bwd_scratch(...) bytes,
// 256-byte aligned. Out, written whole: dy (M, d) f32, 16-byte aligned; dw
// (V, d) and db (V,) f32, the four heads' gradients stacked in order
// (V = sum V_h). sms: the card's multiprocessors; *launched: the kernels
// launched.
extern "C" int recon_ce_bwd_launch(
    const void* dec, long long M, int d, const void* gamma, const void* beta,
    float eps, const void* w0, const void* w1, const void* w2,
    const void* w3, const void* b0, const void* b1, const void* b2,
    const void* b3, int v0, int v1, int v2, int v3, const void* lse,
    const void* cat, int C, const void* cont, int D, const void* mask,
    const void* derr, float w_s, float w_n, float w_k, float w_d, int vf0,
    int lo0, int vf1, int lo1, int dy_heads, void* cnt, void* scratch,
    void* dy, void* dw, void* db, int sms, int* launched, void* stream) {
  *launched = 0;
  if (M <= 0 || M > 0x7fffffffLL || v0 < 1 || v1 < 1 || v2 < 1 || v3 != 1 ||
      C < 3 || D < 1 || d < 4 || d % 4 != 0 || d > 1024 || sms <= 0 ||
      lo0 < 0 || lo1 < 0 || lo0 + v0 > vf0 || lo1 + v1 > vf1 ||
      dy_heads < 0 || dy_heads > 15)
    return (int)cudaErrorInvalidValue;
  Heads heads;
  const SliceOf sl = {{vf0, vf1}, {lo0, lo1}};
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
  const auto* x = static_cast<const float*>(dec);
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* ls = static_cast<const float*>(lse);
  const auto* ct = static_cast<const int32_t*>(cat);
  const auto* cf = static_cast<const float*>(cont);
  const auto* mk = static_cast<const uint8_t*>(mask);
  const auto* de = static_cast<const float*>(derr);
  auto* cn = static_cast<int*>(cnt);
  auto* sc = static_cast<char*>(scratch);
  auto* oy = static_cast<float*>(dy);
  auto* ow = static_cast<float*>(dw);
  auto* ob = static_cast<float*>(db);
  // the tile by d: 64 positions up to d 128, 32 to 256, 16 past (dy's
  // registers: TS x 4 NC4 = 16 TS x d / 256 a thread); the slice mode's
  // instantiation only where the heads are a slice or dy_heads leaves one
  // out
  const bool sliced = vf0 != v0 || vf1 != v1 || lo0 != 0 || lo1 != 0 ||
                      dy_heads != 15;
  auto run = [&](auto mode) -> int {
    constexpr bool SL = decltype(mode)::value;
    if (d <= 128)
      return launch_all<4, 4, 2, SL>(x, M, d, g, bt, eps, heads, sl, dy_heads,
                                     ls, ct, C, cf, D, mk, de, vtot, S, cn, sc,
                                     oy, ow, ob, sms, launched, st);
    if (d <= 256)
      return launch_all<8, 2, 4, SL>(x, M, d, g, bt, eps, heads, sl, dy_heads,
                                     ls, ct, C, cf, D, mk, de, vtot, S, cn, sc,
                                     oy, ow, ob, sms, launched, st);
    if (d <= 512)
      return launch_all<16, 1, 8, SL>(x, M, d, g, bt, eps, heads, sl,
                                      dy_heads, ls, ct, C, cf, D, mk, de, vtot,
                                      S, cn, sc, oy, ow, ob, sms, launched,
                                      st);
    return launch_all<32, 1, 16, SL>(x, M, d, g, bt, eps, heads, sl,
                                     dy_heads, ls, ct, C, cf, D, mk, de, vtot,
                                     S, cn, sc, oy, ow, ob, sms, launched, st);
  };
  return sliced ? run(std::true_type{}) : run(std::false_type{});
}
