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
//   2. the logits of each head, with an online log-sum-exp (running max and
//      rescaled sum) over the service, name and kind vocabularies: the (M,
//      2569) logits never reach device memory (the plain version at T =
//      8192 traces would hold 4.3 GB of them);
//   3. ce = lse - logit[label], mse = (duration - continuous[..., 0])^2;
//      a label is read as _ce's jnp.take_along_axis in fill mode reads it
//      (embed_take.cuh take_label): one in [-V, 0) wraps, any other past
//      the head gives a NaN ce, so a NaN error (and squashed score) at
//      that real position; the log-sum-exps stay finite;
//   4. err accumulated in the reference's order (:116-120) with separate
//      IEEE steps.
// The f32 kernel (the trainer's forward) can also write each real
// position's three log-sum-exps (lse, (M, 3)), which K20 (recon_ce_bwd.cu)
// turns into the softmax without a second sweep of the vocabularies.
// Slice mode (a shard of the "model" axis: odigos_tpu/parallel/sharding.py
// :104 puts the service and name heads' columns on it, and XLA takes _ce's
// log_softmax across the split vocabulary): the service and name heads are
// this shard's rows [lo, lo + v) of heads of vf rows (vf = v, lo = 0: a head
// the mesh guard keeps whole), a label read against the whole head and
// then found in the slice (embed_take.cuh take_slice_label), and each real
// position writes a record of kRec floats in place of its error: (lse_s,
// zl_s, lse_n, zl_n, ce_k, dd, lse_k, 0), the slice's log-sum-exps, the
// label's logit where the slice holds it (NaN elsewhere), the kind head's
// cross-entropy lse_k - zl_k, dd = duration - continuous[..., 0] and lse_k
// (0 on the wide bf16 route). K24 (vocab_merge.cu) merges the shards'
// records into the error in weighted_error's steps, so at tp = 1 the two
// give this kernel's bits.
// Masked positions write 0 (the reference multiplies finite values by 0
// there) and are not scored: on the host route ~84% of a row is padding on
// the otel mix (10.3 spans a trace in L = 64), on the fused route (one row
// per possible trace) ~98%.
//
// Two kernels, by the working type (recon.kernel_route):
//
// bf16 (served): the heads on tensor cores. dec_ln's output is a bf16
// value, so with each f32 weight split into three bf16 planes, W = W_hi +
// W_mid + W_lo exactly (8 + 8 + 8 significant bits; kernels/recon.py
// head_planes checks it), y W = y W_hi + y W_mid + y W_lo, each product
// exact in f32: three bf16 passes with f32 accumulation give the f32
// logits up to the summation order. Two launches:
//   compact  a thread per position: masked ones get err = 0, real ones are
//            listed (block ballots, one atomic a block; order is free, each
//            position's result is its own), and eight lanes a listed row
//            take its LayerNorm statistics (ln_exact.cuh's mean and 1 /
//            std), once a position, with every SM's warps in flight to
//            hide the chains of shuffles and divisions;
//   score    persistent CTAs of 8 warps, as many as the SMs hold, over
//            work items (a tile of 128 listed positions, a slice of the
//            tensor-core columns) until the device-side count runs out. A
//            tile splits into S slices when there are few tiles (T = 256:
//            22 tiles, S = 6), S chosen on the card from the count. An item:
//            its rows' labels and statistics read a thread a row, their
//            decoder rows gathered by cp.async into a bf16 (128, d) A tile
//            in shared memory and normalised there in place (ln_exact.cuh's
//            IEEE steps from the statistics); the service and name heads'
//            planes (each head padded to 64 columns, bias -inf there)
//            streamed by cp.async through a 3-stage ring of (3, 64, d)
//            tiles (each with its columns' bias); mma.sync m16n8k16 bf16
//            -> f32, warps 4 x 2 over (128 rows, 64 columns), the three
//            planes into one accumulator; the bias added and the online
//            log-sum-exp and the label's logit taken from the accumulator
//            fragments in registers. A split tile's slices leave (max,
//            sum, label logit) partials; the last to finish (an atomic per
//            tile) merges them. The kind (8) and duration (1) heads, too narrow
//            for a tile, are f32 dots on CUDA cores from shared memory at
//            the end, then the error.
// Bound on the card: operations. 2 d (512 + 2048) bf16 x 3 planes = 1.97
// MFLOP a real position: at T = 2048 traces (20,848 real positions) 41.0
// GFLOP, 0.0415 ms at 989 TFLOP/s; the bytes (the real rows, labels, the
// mask, err, 2 MB of planes) ~38 MB, 0.011 ms. mma.sync, not wgmma: the
// A tile is built in place by the LayerNorm and the logits are consumed in
// registers, and each CTA reads the planes from L2 once an item (~2 MB a
// tile: 128 flops a byte, about the L2's rate at the tensor-core peak).
//
// CUDA cores (f32, the trainer's forward with its log-sum-exps; and bf16
// where head_planes cannot split the heads: y is then bf16, the heads f32
// FMAs all the same). Its numbers are those of the design it replaced (a
// CTA of 256 threads a chunk of 256 consecutive positions; at the
// trainer's step 8 CTAs on 132 SMs), bit for bit: each logit the same
// fmaf chain over k ascending from 0 plus the bias; each head's 16
// residue classes mod 16 of the vocabulary walked row by row in ascending
// order with the same running (max, sum) update (lse_step); the classes
// merged by the same xor 8, 4, 2, 1 tree (lse_merge is commutative, so a
// subtree's value is the same whichever lanes hold it); the same error.
// Two launches:
//   list   a thread a position: masked ones get err = 0 (and lse = 0), real
//          ones are listed (block ballots, an atomic a block) with their
//          dec_ln statistics (ln_exact.cuh's mean and 1 / std, eight lanes
//          a row, blocks of 64 positions so the grid spans the SMs);
//   score  persistent CTAs of 256 threads over work items (a tile of P
//          listed positions, the service or the name head, a group of CG
//          of its classes: those = g mod 16 / CG, the leaves of one subtree
//          of the merge tree), until the device-side count runs out.
//          CG is chosen so an item holds ~256 weight rows (service 8
//          classes of 32 rows, name 2 of 128: 10 items a tile, 200 at the
//          trainer's 619 real positions). An item: its positions' dec_ln
//          from the statistics into a (P, d + pad) f32 tile; its classes'
//          rows streamed in chunks of NR rows (the rows of a class in
//          order) by cp.async; the logits of a chunk by a register tile a
//          thread (4 positions x 4 rows; 16-byte shared reads of 8
//          distinct positions and 4 distinct rows a warp: conflict-free)
//          into shared memory; each (position, class) walked by one thread
//          over the chunk's logits in order, the walk of chunk k - 1
//          issued before chunk k's products; the item's subtree merged by
//          shuffles; its (max, sum) and, where it walked the label's row,
//          the label's logit left in the scratch. The tile's first item
//          also takes the kind and duration logits (a thread a dot). The
//          last item of a tile to finish (a ticket a tile, no float
//          atomics) merges the items by the tree's top, walks the kind
//          head's classes a lane each, and writes the error, the
//          log-sum-exps and the squashed score.
// P = 32 positions and 128-row chunks at d <= 128 (64 x 64, 8 x 2 logits
// a thread, from kLargeM positions: each weight row is read by twice the
// positions), both single-buffered (two CTAs an SM); 32 x 32 double-
// buffered to d 256, 16 x 32 to 512, 8 x 32 single-buffered to 1024
// (shared memory).
// Bound: 2 d (512 + 2048 + 8 + 1) = 657,664 f32 flops a real position at d
// 128: 0.0061 ms at the trainer's 619 positions and 0.205 ms at T = 2048
// (20,848) at 67 TFLOP/s. Each logit also costs its walk step (an exp and
// a few selects, ~15% of its 128 FMAs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "embed_take.cuh"
#include "ln_exact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// merge a running (max, sum) with another; -inf marks an empty one
__device__ __forceinline__ void lse_merge(float& m, float& s, float mo,
                                          float so) {
  const float mn = fmaxf(m, mo);
  const float a = m == -INFINITY ? 0.f : s * expf(m - mn);
  const float b = mo == -INFINITY ? 0.f : so * expf(mo - mn);
  m = mn;
  s = a + b;
}

// the error of one position from its heads' log-sum-exps and label logits
// and its duration logit, in the reference's order with IEEE steps
__device__ __forceinline__ float weighted_error(
    float lse_s, float zl_s, float lse_n, float zl_n, float lse_k,
    float zl_k, float dur, float c0, float w_s, float w_n, float w_k,
    float w_d) {
  const float dd = __fsub_rn(dur, c0);
  float e = __fmul_rn(w_s, __fsub_rn(lse_s, zl_s));
  e = __fadd_rn(e, __fmul_rn(w_n, __fsub_rn(lse_n, zl_n)));
  e = __fadd_rn(e, __fmul_rn(w_k, __fsub_rn(lse_k, zl_k)));
  return __fadd_rn(e, __fmul_rn(w_d, __fmul_rn(dd, dd)));
}

// slice mode: a position's record for K24 (the header's layout)
constexpr int kRec = 8;

__device__ __forceinline__ void write_record(float* r, float lse_s,
                                             float zl_s, float lse_n,
                                             float zl_n, float ce_k,
                                             float dd, float lse_k) {
  float4* r4 = reinterpret_cast<float4*>(r);
  r4[0] = make_float4(lse_s, zl_s, lse_n, zl_n);
  r4[1] = make_float4(ce_k, dd, lse_k, 0.f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst,
                                                 const void* src,
                                                 bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// ---------------------------------------------------------------- f32

struct Heads {
  const float* w[4];  // (V_h, d) f32, torch Linear layout
  const float* b[4];  // (V_h,) f32
  int v[4];
};

constexpr int kItemRows = 256;  // an item's weight rows, about
constexpr int kMinTile = 8;     // the smallest tile of listed positions
constexpr int kListPos = 64;    // positions a block of the list kernel
constexpr long long kLargeM = 16384;  // positions from which d <= 128
                                      // takes 64-position tiles

// One step of a class's walk over its next logit z: the running (max,
// sum) update of the design before this one (where z > m the sum is
// rescaled, s * e + 1 by one FMA, else e is added), with its one exp
// taken on the argument either branch gives, so a warp does not diverge
__device__ __forceinline__ void lse_step(float& m, float& s, float z) {
  const bool up = z > m;
  const float e = expf(up ? m - z : z - m);
  s = up ? s * e + 1.f : s + e;
  m = up ? z : m;
}

// The residue classes mod 16 an item of a head of v rows walks: CG of them
// (a power of two; CG ceil(v / 16) <= kItemRows where one class allows),
// those congruent to the item's group g mod 16 / CG, the leaves of one
// subtree of the xor 8, 4, 2, 1 merge tree (tests/test_torch_kernel_
// models.py replays the rule and the walk).
__host__ __device__ inline int class_group(int v) {
  const int rows = (v + 15) / 16;
  int cg = 16;
  while (cg > 1 && cg * rows > kItemRows) cg >>= 1;
  return cg;
}

// a tile's items: the service head's groups, then the name head's
__host__ __device__ inline int items_per_tile(int v0, int v1) {
  return 16 / class_group(v0) + 16 / class_group(v1);
}

// a shared row of d floats: 16-byte reads of 8 rows hit distinct banks
// (the pitch in 16-byte words is odd)
__host__ __device__ inline int f32_pitch(int d) {
  return (d / 4) % 2 == 0 ? d + 4 : d + 8;
}

__host__ __device__ inline long long align16(long long b) {
  return (b + 15) & ~15LL;
}

// The f32 route's scratch: its counters (int32, zero when made, left at
// zero by every call: the count, the CTAs' exit ticket, a ticket a tile)
// and its data (written before they are read: the list, the LayerNorm
// statistics, the (max, sum) partials, the label logits), each cached per
// device and stream.
struct F32Scratch {
  int32_t* count;      // real positions listed
  int32_t* done;       // score CTAs finished
  int32_t* tile_done;  // (M / kMinTile + 1,) a tile's items finished
  int32_t* list;       // (M,) the real positions
  float2* stats;       // (M,) their dec_ln mean and 1 / std
  float2* part;        // (M, items a tile): (max, sum) of an item's subtree
  float* zl;           // (M, 2): the service and name label logits
  float* zk;           // (M, kind rows + 1): the kind and duration logits
};

__host__ __device__ inline long long f32_counters(long long M) {
  return 2 + M / kMinTile + 1;
}

__host__ __device__ inline long long f32_data_bytes(long long M, int ni,
                                                    int nk) {
  return align16(4 * M) + align16(8 * M) + align16(8 * M * ni) +
         align16(8 * M) + align16(4 * M * nk);
}

F32Scratch carve_f32(void* counters, void* data, long long M, int ni) {
  F32Scratch s;
  s.count = static_cast<int32_t*>(counters);
  s.done = s.count + 1;
  s.tile_done = s.count + 2;
  char* p = static_cast<char*>(data);
  s.list = reinterpret_cast<int32_t*>(p);
  p += align16(4 * M);
  s.stats = reinterpret_cast<float2*>(p);
  p += align16(8 * M);
  s.part = reinterpret_cast<float2*>(p);
  p += align16(8 * M * ni);
  s.zl = reinterpret_cast<float*>(p);
  p += align16(8 * M);
  s.zk = reinterpret_cast<float*>(p);
  return s;
}

struct F32Args {
  const void* dec;
  long long M;
  int d;
  const float* gamma;
  const float* beta;
  float eps;
  Heads heads;
  const int32_t* cat;
  int C;
  const float* cont;
  int D;
  float w_s, w_n, w_k, w_d;
  float* err;
  const int32_t* span_map;
  float* scores;
  float* lse;
  int vf[2], lo[2];  // the service and name heads' whole widths and this
                     // shard's first row (vf = v, lo = 0 unsliced)
  float* rec;        // slice mode: (M, kRec) records, err unwritten
  F32Scratch sc;
};

// Lists the real positions (block ballots, one atomic a block: the order
// is free, each position's result is its own), writes 0 at the others, and
// takes each listed position's dec_ln statistics (ln_exact.cuh's mean and
// 1 / std: exact f64 sums, so any lane layout gives warp_ln_row_strided's
// bits) at its list slot, once a position. A block of 256 threads takes
// kListPos positions, so a block's real rows (eight lanes each) are one
// pass of its 32 lane groups and the grid spans the SMs at the trainer's
// 2048 positions.
template <typename T>
__global__ void __launch_bounds__(kThreads) recon_ce_list_kernel(
    const uint8_t* __restrict__ mask, long long M, const T* __restrict__ dec,
    int d, float eps, float* __restrict__ err, float* __restrict__ lse,
    int32_t* __restrict__ list, float2* __restrict__ stats,
    int32_t* __restrict__ count) {
  __shared__ int s_wcount[kWarps];
  __shared__ int s_base, s_pos[kThreads];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long base = (long long)blockIdx.x * kListPos;
  const long long q = base + tid;
  const bool in = tid < kListPos && q < M;
  const bool real = in && mask[q];
  if (in && !real) {
    if (err != nullptr) err[q] = 0.f;
    if (lse != nullptr)
      for (int h = 0; h < 3; ++h) lse[q * 3 + h] = 0.f;
  }
  const unsigned bal = __ballot_sync(0xffffffffu, real);
  if (lane == 0) s_wcount[wid] = __popc(bal);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    off += w < wid ? s_wcount[w] : 0;
    total += s_wcount[w];
  }
  if (tid == 0) s_base = total ? atomicAdd(count, total) : 0;
  if (real) s_pos[off + __popc(bal & ((1u << lane) - 1u))] = tid;
  __syncthreads();
  if (tid < total) list[s_base + tid] = (int)(base + s_pos[tid]);
  // eight lanes a row, four rows a warp at once: each lane sums its values
  // (sub, sub + 8, ...) exactly in f64, the group's sums by three shuffles
  // (ln_mean's and ln_rstd's steps on the row's sums)
  const int sub = lane & 7;
  for (int k = wid * 4 + (lane >> 3); k - (lane >> 3) < total;
       k += kThreads / 8) {  // warp-uniform
    const bool mine = k < total;
    const T* xr = dec + (base + s_pos[mine ? k : 0]) * d;
    double sum = 0.0;
    if (mine)
      for (int f = sub; f < d; f += 8) sum += (double)load_f(xr + f);
    const float mean = __fdiv_rn((float)group_sum<8>(sum), (float)d);
    double sq = 0.0;
    if (mine)
      for (int f = sub; f < d; f += 8) sq += ln_sq_dev(load_f(xr + f), mean);
    const float var = __fdiv_rn((float)group_sum<8>(sq), (float)d);
    const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    if (mine && sub == 0) stats[s_base + k] = make_float2(mean, rstd);
  }
}

// A head logit's dot on CUDA cores: the f32 FMA chain over k ascending
// from 0, four values a step, of the design before this one
__device__ __forceinline__ float row_dot(const float* y, const float* w,
                                         int d) {
  float a = 0.f;
  for (int k = 0; k < d; k += 4) {
    const float4 yv = *reinterpret_cast<const float4*>(y + k);
    const float4 wv = __ldg(reinterpret_cast<const float4*>(w + k));
    a = fmaf(yv.x, wv.x, a);
    a = fmaf(yv.y, wv.y, a);
    a = fmaf(yv.z, wv.z, a);
    a = fmaf(yv.w, wv.w, a);
  }
  return a;
}

// The scoring kernel: persistent CTAs over items (a tile of P listed
// positions, the service or name head, a group of its classes) until the
// device-side count runs out. TSP, TSR: the GEMM thread's positions tp +
// 8 i (i < TSP) and chunk rows tr + 32 j (j < TSR), so P = 8 TSP and a
// chunk NR = 32 TSR rows; DB: the chunks double-buffered.
template <typename T, int TSP, int TSR, bool DB>
__global__ void __launch_bounds__(kThreads) recon_ce_kernel(const F32Args a) {
  constexpr int P = 8 * TSP;
  constexpr int NR = 32 * TSR;
  constexpr int LDL = NR + 1;
  constexpr int NB = DB ? 2 : 1;
  constexpr int kPairs = (16 * P + kThreads - 1) / kThreads;
  const int d = a.d, ld = f32_pitch(d);
  extern __shared__ float4 smem4[];
  float* s_y = reinterpret_cast<float*>(smem4);  // (P, ld): dec_ln's rows
  float* s_w = s_y + P * ld;                     // NB x (NR, ld): a chunk
  float* s_l = s_w + NB * NR * ld;               // (P, LDL): its logits
  __shared__ int s_q[P], s_lab[P];
  __shared__ float2 s_st[P];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const T* dec = static_cast<const T*>(a.dec);
  const int count = *a.sc.count;
  const int tiles = (count + P - 1) / P;
  const int n0 = 16 / class_group(a.heads.v[0]);
  const int ni = n0 + 16 / class_group(a.heads.v[1]);
  const long long items = (long long)tiles * ni;
  const int tp = lane & 7, tr = (wid << 2) | (lane >> 3);

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = (int)(item / ni), it = (int)(item % ni);
    const int h = it < n0 ? 0 : 1;
    const int g = it < n0 ? it : it - n0;
    const int V = a.heads.v[h];
    const int cg = class_group(V), step = 16 / cg;
    const int rj = NR / cg;  // a class's rows a chunk
    const int nchunks = ((V + 15) / 16 + rj - 1) / rj;
    const float* __restrict__ W = a.heads.w[h];
    const float* __restrict__ B = a.heads.b[h];
    const int p0 = tile * P, np = min(P, count - p0);

    __syncthreads();  // the previous item's shared data are consumed
    if (tid < P) {
      int q = -1, lab = -1;
      float2 st = make_float2(0.f, 0.f);
      if (tid < np) {
        q = a.sc.list[p0 + tid];
        lab = take_slice_label(a.cat[(long long)q * a.C + h], a.vf[h],
                               a.lo[h], V);
        st = a.sc.stats[p0 + tid];
      }
      s_q[tid] = q;
      s_lab[tid] = lab;
      s_st[tid] = st;
    }
    // chunk k: its row r = ci rj + jj is the head's row g + step ci + 16
    // (k rj + jj), the jj-th of class g + step ci (zeros past V)
    auto load_chunk = [&](int k, float* dst) {
      const int d4 = d / 4;
      for (int e = tid; e < NR * d4; e += kThreads) {
        const int r = e / d4, c4 = e - r * d4;
        const int ci = r / rj, jj = r - ci * rj;
        const int v = g + step * ci + 16 * (k * rj + jj);
        const bool in = v < V;
        cp_async16_zfill(smem_u32(dst + r * ld + 4 * c4),
                         W + (long long)(in ? v : 0) * d + 4 * c4, in);
      }
      cp_async_commit();
    };
    load_chunk(0, s_w);
    __syncthreads();  // s_q, s_st
    // dec_ln of the tile's positions from their statistics (ln_exact.cuh's
    // steps: warp_ln_row_strided's bits), every thread on a row's values
    // in turn; zeros past np
    for (int e = tid; e < P * d; e += kThreads) {
      const int p = e / d, f = e - p * d;
      float y = 0.f;
      if (p < np) {
        const T* xr = dec + (long long)s_q[p] * d;
        y = ln_out(load_f(xr + f), s_st[p].x, s_st[p].y, __ldg(a.gamma + f),
                   __ldg(a.beta + f), xr);
      }
      s_y[p * ld + f] = y;
    }

    // the walks: pair pr = p cg + ci (a position's classes on neighbouring
    // lanes), this thread's pairs tid + u kThreads (P cg <= 16 P)
    float m[kPairs], s[kPairs], zlab[kPairs];
    bool has[kPairs];
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      m[u] = -INFINITY;
      s[u] = 0.f;
      zlab[u] = 0.f;
      has[u] = false;
    }
    // class g + step ci of position p over chunk k's logits, ascending
    auto walk = [&](int k) {
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        const int pr = tid + u * kThreads;
        const int p = pr / cg, ci = pr - p * cg;
        if (p >= np) continue;
        const int c = g + step * ci;
        const int lab = s_lab[p];
        const float* lr = s_l + p * LDL + ci * rj;
        for (int jj = 0; jj < rj; ++jj) {
          const int v = c + 16 * (k * rj + jj);
          if (v >= V) break;
          const float z = lr[jj];
          if (v == lab) {
            zlab[u] = z;
            has[u] = true;
          }
          lse_step(m[u], s[u], z);
        }
      }
    };

    for (int k = 0; k < nchunks; ++k) {
      const float* w = s_w + (DB ? (k & 1) * NR * ld : 0);
      cp_async_wait<0>();
      __syncthreads();  // chunk k landed; dec_ln's rows and k - 1's logits
      if (DB && k + 1 < nchunks)
        load_chunk(k + 1, s_w + ((k + 1) & 1) * NR * ld);
      if (k > 0) walk(k - 1);  // its warps' latency under the others' FMAs
      // this thread's rows of the chunk and their bias, loaded under the
      // products
      int vr[TSR];
      float bias[TSR];
#pragma unroll
      for (int j = 0; j < TSR; ++j) {
        const int r = tr + 32 * j;
        const int ci = r / rj, jj = r - ci * rj;
        vr[j] = g + step * ci + 16 * (k * rj + jj);
        bias[j] = vr[j] < V ? __ldg(B + vr[j]) : 0.f;
      }
      float acc[TSP][TSR];
#pragma unroll
      for (int i = 0; i < TSP; ++i)
#pragma unroll
        for (int j = 0; j < TSR; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < d; kk += 4) {
        float4 yv[TSP], wv[TSR];
#pragma unroll
        for (int i = 0; i < TSP; ++i)
          yv[i] = *reinterpret_cast<const float4*>(s_y + (tp + 8 * i) * ld +
                                                   kk);
#pragma unroll
        for (int j = 0; j < TSR; ++j)
          wv[j] = *reinterpret_cast<const float4*>(w + (tr + 32 * j) * ld +
                                                   kk);
#pragma unroll
        for (int i = 0; i < TSP; ++i)
#pragma unroll
          for (int j = 0; j < TSR; ++j) {
            float x = acc[i][j];
            x = fmaf(yv[i].x, wv[j].x, x);
            x = fmaf(yv[i].y, wv[j].y, x);
            x = fmaf(yv[i].z, wv[j].z, x);
            x = fmaf(yv[i].w, wv[j].w, x);
            acc[i][j] = x;
          }
      }
      __syncthreads();  // k - 1's walk is done with the logits (and one
                        // buffer's chunk with W)
      if (!DB && k + 1 < nchunks) load_chunk(k + 1, s_w);
#pragma unroll
      for (int j = 0; j < TSR; ++j) {
        if (vr[j] >= V) continue;
#pragma unroll
        for (int i = 0; i < TSP; ++i)
          s_l[(tp + 8 * i) * LDL + tr + 32 * j] =
              __fadd_rn(acc[i][j], bias[j]);
      }
    }
    __syncthreads();
    walk(nchunks - 1);

    // the item's subtree of the merge tree (xor cg / 2, ..., 1 over a
    // position's classes: xor 8, ..., step over the class), then its
    // (max, sum) and the label's logit where the item walked its row
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      for (int o = cg >> 1; o; o >>= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[u], o);
        const float so = __shfl_xor_sync(0xffffffffu, s[u], o);
        lse_merge(m[u], s[u], mo, so);
      }
      const int pr = tid + u * kThreads;
      const int p = pr / cg, ci = pr - p * cg;
      if (p < np) {
        const long long slot = p0 + p;
        if (ci == 0) a.sc.part[slot * ni + it] = make_float2(m[u], s[u]);
        if (has[u]) a.sc.zl[slot * 2 + h] = zlab[u];
      }
    }

    // the tile's kind logits and duration logit, by its first item (a
    // thread a dot: the parent's chains) while the others run
    const int nk = a.heads.v[2] + 1;
    if (it == 0) {
      for (int e = tid; e < P * nk; e += kThreads) {
        const int p = e % P, r = e / P;
        if (p >= np) continue;
        const float* wr = r + 1 < nk ? a.heads.w[2] + (long long)r * d
                                     : a.heads.w[3];
        const float b = r + 1 < nk ? __ldg(a.heads.b[2] + r)
                                   : __ldg(a.heads.b[3]);
        a.sc.zk[(p0 + p) * (long long)nk + r] =
            __fadd_rn(row_dot(s_y + p * ld, wr, d), b);
      }
    }

    // the tile's last item to finish takes the merge (a ticket a tile)
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(a.sc.tile_done + tile, 1) == ni - 1;
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
    if (tid == 0) a.sc.tile_done[tile] = 0;
    // 16 lanes a position (lane tv, a class or an item): the top of each
    // tree, the kind head's classes walked over the first item's logits,
    // the error
    const int tv = tid & 15;
    for (int pp = tid >> 4; pp < P; pp += kThreads / 16) {  // warp-uniform
      const bool live = pp < np;
      const long long q = live ? s_q[pp] : 0;
      const long long slot = p0 + pp;
      float lse3[3], zl3[3];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int nh = 16 / class_group(a.heads.v[hh]);
        float mm = -INFINITY, ss = 0.f;
        if (live && tv < nh) {
          const float2 ms = __ldcg(a.sc.part + slot * ni +
                                   (hh == 0 ? 0 : n0) + tv);
          mm = ms.x;
          ss = ms.y;
        }
        for (int o = nh >> 1; o; o >>= 1) {
          const float mo = __shfl_xor_sync(0xffffffffu, mm, o);
          const float so = __shfl_xor_sync(0xffffffffu, ss, o);
          lse_merge(mm, ss, mo, so);
        }
        lse3[hh] = mm + logf(ss);
        const int lab = live ? take_slice_label(a.cat[q * a.C + hh],
                                                a.vf[hh], a.lo[hh],
                                                a.heads.v[hh])
                             : -1;
        zl3[hh] = lab < 0 ? NAN : __ldcg(a.sc.zl + slot * 2 + hh);
      }
      {
        const int Vk = nk - 1;
        const int lab = live ? take_label(a.cat[q * a.C + 2], Vk) : -1;
        const float* zr = a.sc.zk + slot * nk;
        float mm = -INFINITY, ss = 0.f, zk = 0.f;
        for (int v = tv; live && v < Vk; v += 16) {
          const float z = __ldcg(zr + v);
          if (v == lab) zk = z;
          lse_step(mm, ss, z);
        }
#pragma unroll
        for (int o = 8; o; o >>= 1) {
          const float mo = __shfl_xor_sync(0xffffffffu, mm, o);
          const float so = __shfl_xor_sync(0xffffffffu, ss, o);
          lse_merge(mm, ss, mo, so);
        }
        lse3[2] = mm + logf(ss);
        const float zs = __shfl_sync(0xffffffffu, zk, (lane & 16) | (lab & 15));
        zl3[2] = lab < 0 ? NAN : zs;
      }
      if (live && tv == 0) {
        const float dur = __ldcg(a.sc.zk + slot * nk + nk - 1);
        if (a.rec != nullptr) {
          write_record(a.rec + q * kRec, lse3[0], zl3[0], lse3[1], zl3[1],
                       __fsub_rn(lse3[2], zl3[2]),
                       __fsub_rn(dur, a.cont[q * a.D]), lse3[2]);
          continue;
        }
        const float e = weighted_error(lse3[0], zl3[0], lse3[1], zl3[1],
                                       lse3[2], zl3[2], dur, a.cont[q * a.D],
                                       a.w_s, a.w_n, a.w_k, a.w_d);
        a.err[q] = e;
        if (a.lse != nullptr)
          for (int hh = 0; hh < 3; ++hh) a.lse[q * 3 + hh] = lse3[hh];
        if (a.span_map != nullptr) {
          const int idx = a.span_map[q];
          if (idx >= 0) a.scores[idx] = 1.f - expf(-e);
        }
      }
    }
  }
  // the last CTA to finish leaves the count and its own ticket at zero:
  // every CTA read the count before it took a ticket
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(a.sc.done, 1) == (int)gridDim.x - 1) {
      *a.sc.count = 0;
      *a.sc.done = 0;
    }
  }
}

template <int TSP, int TSR, bool DB>
int f32_smem(int d) {
  const int P = 8 * TSP, NR = 32 * TSR;
  return ((P + (DB ? 2 : 1) * NR) * f32_pitch(d) + P * (NR + 1)) *
         (int)sizeof(float);
}

template <typename T, int TSP, int TSR, bool DB>
int launch_f32_t(const F32Args& a, const uint8_t* mask, int sms,
                 int* launches, cudaStream_t st) {
  // the scoring kernel's attribute and grid first: once the list kernel
  // has counted into the scratch, only the scoring kernel zeroes it
  auto kern = recon_ce_kernel<T, TSP, TSR, DB>;
  const int smem = f32_smem<TSP, TSR, DB>(a.d);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;  // the persistent CTAs: as many as the SMs hold
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long blocks = (a.M + kListPos - 1) / kListPos;
  recon_ce_list_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      mask, a.M, static_cast<const T*>(a.dec), a.d, a.eps, a.err, a.lse,
      a.sc.list, a.sc.stats, a.sc.count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ++*launches;
  kern<<<sms * per_sm, kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launches;
  return (int)e;
}

// the tile by d: 32 positions x 128-row chunks to d 128 (64 x 64 from
// kLargeM positions: each weight row read by twice the positions, half
// the items), both single-buffered (two CTAs an SM); 32 x 32 double-
// buffered to d 256, 16 x 32 to 512, 8 x 32 single-buffered to 1024
// (shared memory)
template <typename T>
int launch_f32_d(const F32Args& a, const uint8_t* mask, int sms,
                 int* launches, cudaStream_t st) {
  if (a.d <= 128 && a.M >= kLargeM)
    return launch_f32_t<T, 8, 2, false>(a, mask, sms, launches, st);
  if (a.d <= 128)
    return launch_f32_t<T, 4, 4, false>(a, mask, sms, launches, st);
  if (a.d <= 256)
    return launch_f32_t<T, 4, 1, true>(a, mask, sms, launches, st);
  if (a.d <= 512)
    return launch_f32_t<T, 2, 1, true>(a, mask, sms, launches, st);
  return launch_f32_t<T, 1, 1, false>(a, mask, sms, launches, st);
}

// ---------------------------------------------------------------- bf16

constexpr int kTcThreads = 256;  // 8 warps: 4 across rows, 2 across columns
constexpr int kBM = 128;         // listed positions a tile
constexpr int kMI = kBM / 64;    // m16 tiles a warp (4 warps across rows)
constexpr int kRI = 2 * kMI;     // accumulator rows a thread
static_assert(kBM % 64 == 0 && kBM <= kTcThreads, "a thread a row");
constexpr int kPlanePad = 64;    // columns each tensor-core head pads to
constexpr int kMaxKind = 16;     // the kind head's width (CUDA cores)
constexpr int kMaxSlices = 16;   // vocabulary slices a tile may split into
constexpr int kPart = 6;         // a partial row: m_s, s_s, m_n, s_n, z_s, z_n

template <int D>
struct TcGeom {
  static constexpr int NT = D <= 128 ? 64 : 32;  // columns a ring stage
  static constexpr int STAGES = D <= 128 ? 3 : 2;
  static constexpr int LD = D + 8;  // bf16 a shared row: ldmatrix without
                                    // bank conflicts (LD / 8 odd)
  static constexpr int NW = NT / 16;  // n8 tiles a warp
  static constexpr int A_ELEMS = kBM * LD;
  // a stage: the three planes' NT rows, then the NT columns' f32 bias
  static constexpr int STAGE_ELEMS = 3 * NT * LD + 2 * NT;
  // the A tile, the ring, the kind (<= kMaxKind) and duration weights,
  // gamma and beta
  static constexpr int SMEM =
      (A_ELEMS + STAGES * STAGE_ELEMS) * 2 + (kMaxKind + 3) * D * 4;
};

struct TcArgs {
  const __nv_bfloat16* dec;
  const float* gamma;
  const float* beta;
  float eps;
  const __nv_bfloat16* planes;  // (3, v_tc, D): W_hi, W_mid, W_lo
  const float* pbias;           // (v_tc,), -inf at the padding columns
  int vs_pad, v_tc, v_s, v_n;   // service columns padded; the real widths
  const float* wk;              // kind (v_k, D) f32, bias bk
  const float* bk;
  int v_k;
  const float* wd;  // duration (1, D) f32, bias bd
  const float* bd;
  const int32_t* cat;
  int C;
  const float* cont;
  int Dc;
  float w_s, w_n, w_k, w_d;
  float* err;
  const int32_t* span_map;
  float* scores;
  int vf_s, lo_s, vf_n, lo_n;  // slice mode's heads (as F32Args' vf, lo)
  float* rec;                  // slice mode: (M, kRec) records
  const int32_t* list;   // the compacted real positions
  const float2* stats;   // their LayerNorm statistics (mean, 1 / std)
  const int32_t* count;  // how many
  float* part;           // (part_items, kPart, kBM) partials
  int part_items;
  int32_t* tile_done;  // per split tile, zeroed: slices finished
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a . b on tensor cores: a 16x16 (row), b 16x8 (col), bf16 -> f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The slices S a tile splits into: the fewest rounds of items over the
// grid, each item costing its columns plus a fixed part (the LayerNorm, the
// ring's fill: ~1.5 stages), within the partials' room.
// kernels/recon.py tc_slices is the same rule on the host.
__device__ __forceinline__ int plan_slices(int tiles, int vt, int grid,
                                           int part_items) {
  int best = 1;
  long long best_cost = LLONG_MAX;
  const int smax = vt < kMaxSlices ? vt : kMaxSlices;
  for (int s = 1; s <= smax; ++s) {
    const long long items = (long long)tiles * s;
    if (s > 1 && items > part_items) break;
    const long long rounds = (items + grid - 1) / grid;
    const long long cost = rounds * (4LL * ((vt + s - 1) / s) + 6);
    if (cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  return best;
}

// stage the three planes' columns [col0, col0 + NT) into a ring stage
template <int D>
__device__ __forceinline__ void load_stage(const __nv_bfloat16* planes,
                                           const float* pbias, int v_tc,
                                           int col0, __nv_bfloat16* st,
                                           int tid) {
  using G = TcGeom<D>;
  constexpr int CH = D / 8;  // 16-byte chunks a row
  constexpr int PLANE = G::NT * CH;
  for (int e = tid; e < 3 * PLANE; e += kTcThreads) {
    const int p = e / PLANE, r = (e % PLANE) / CH, c = e % CH;
    cp_async16(smem_u32(st + (p * G::NT + r) * G::LD + c * 8),
               planes + ((long long)p * v_tc + col0 + r) * D + c * 8);
  }
  if (tid < G::NT / 4)
    cp_async16(smem_u32(st + 3 * G::NT * G::LD + tid * 8),
               pbias + col0 + tid * 4);
}

// a packed pair of bf16 (the lower address first) as floats
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xFFFF0000u));
}

// fold one tile's logits (this thread's 2 NW of a row) into the row's
// running (max, sum)
template <int NW>
__device__ __forceinline__ void lse_add(float& m, float& s,
                                        const float (&z)[NW][2], float tm) {
  const float mn = fmaxf(m, tm);
  if (mn == -INFINITY) return;  // nothing but padding columns yet
  float acc = m == mn ? s : m == -INFINITY ? 0.f : s * __expf(m - mn);
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) acc += __expf(z[j][e] - mn);
  m = mn;
  s = acc;
}

// Lists the real positions, and takes each one's LayerNorm statistics
// (mean, 1 / std, the arithmetic of ln_exact.cuh: exact f64
// sums, IEEE steps) at its list slot: once a position, eight lanes a row,
// in a launch with every SM's warps in flight.
template <int D>
__global__ void __launch_bounds__(kThreads) recon_compact_kernel(
    const uint8_t* __restrict__ mask, long long M,
    const __nv_bfloat16* __restrict__ dec, float eps, float* __restrict__ err,
    int32_t* __restrict__ list, float2* __restrict__ stats,
    int32_t* __restrict__ count) {
  __shared__ int s_wcount[kWarps];
  __shared__ int s_base, s_pos[kThreads];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long base = (long long)blockIdx.x * kThreads;
  const long long q = base + tid;
  const bool real = q < M && mask[q];
  if (q < M && !real && err != nullptr) err[q] = 0.f;
  const unsigned bal = __ballot_sync(0xffffffffu, real);
  if (lane == 0) s_wcount[wid] = __popc(bal);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    off += w < wid ? s_wcount[w] : 0;
    total += s_wcount[w];
  }
  if (tid == 0) s_base = total ? atomicAdd(count, total) : 0;
  if (real) s_pos[off + __popc(bal & ((1u << lane) - 1u))] = tid;
  __syncthreads();
  if (tid < total) list[s_base + tid] = (int)(base + s_pos[tid]);
  // eight lanes a row, four rows a warp at once: each lane sums d / 8
  // values exactly in f64 (any order), the group's sums by three shuffles
  constexpr int V = D / 8;
  const int sub = lane & 7;
  for (int k = wid * 4 + (lane >> 3); k - (lane >> 3) < total;
       k += kThreads / 8) {
    const bool mine = k < total;
    float v[V];
    double sum = 0.0;
    if (mine) {
      const __nv_bfloat16* xr = dec + (base + s_pos[k]) * D + sub * V;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[j] = load_f(xr + j);
        sum += (double)v[j];
      }
    }
#pragma unroll
    for (int o = 4; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = __fdiv_rn((float)sum, (float)D);
    double sq = 0.0;
    if (mine) {
#pragma unroll
      for (int j = 0; j < V; ++j) sq += ln_sq_dev(v[j], mean);
    }
#pragma unroll
    for (int o = 4; o; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float var = __fdiv_rn((float)sq, (float)D);
    const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    if (mine && sub == 0) stats[s_base + k] = make_float2(mean, rstd);
  }
}

// the products of one column tile: the A tile (128 rows) times the three
// planes of a ring stage, this warp's 32 rows x NT / 2 columns, into acc
template <int D>
__device__ __forceinline__ void tile_products(
    float (&acc)[kMI][TcGeom<D>::NW][4], float2 (&bias)[TcGeom<D>::NW],
    const __nv_bfloat16* sA, const __nv_bfloat16* sb, int wm, int wn,
    int lane) {
  using G = TcGeom<D>;
  constexpr int NT = G::NT, LD = G::LD, NW = G::NW;
  // this thread's columns' bias, out of the stage before it is refilled
  const float2* sbias = reinterpret_cast<const float2*>(sb + 3 * NT * LD);
#pragma unroll
  for (int j = 0; j < NW; ++j)
    bias[j] = sbias[(wn * (NT / 2) + (lane & 3) * 2 + 8 * j) / 2];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[kMI][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
      ldsm_x4(smem_u32(sA + (wm * (kBM / 4) + mi * 16 + (lane & 15)) * LD +
                       kk * 16 + (lane >> 4) * 8),
              af[mi]);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const __nv_bfloat16* bp = sb + (p * NT + wn * (NT / 2)) * LD;
#pragma unroll
      for (int jj = 0; jj < NW / 2; ++jj) {
        uint32_t bf[4];
        ldsm_x4(smem_u32(bp + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                  LD +
                         kk * 16 + ((lane >> 3) & 1) * 8),
                bf);
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          mma_bf16(acc[mi][2 * jj], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * jj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
}

// one column tile's logits from the fragments: the bias added, the label's
// logit kept, the rows' online log-sum-exp of the tile's head advanced;
// element (j, e) of row i is column col0 + 8 j + e
template <int NW>
__device__ __forceinline__ void tile_epilogue(
    const float (&acc)[kMI][NW][4], const float2 (&bias)[NW], int col0,
    int h, const int (&lab)[2][kRI], const int (&rows_i)[kRI],
    float (*s_zl)[kBM], float (&m)[2][kRI], float (&s)[2][kRI]) {
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int mi = i >> 1, hf = i & 1;
    float z[NW][2];
    float tm = -INFINITY;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      z[j][0] = __fadd_rn(acc[mi][j][hf * 2], bias[j].x);
      z[j][1] = __fadd_rn(acc[mi][j][hf * 2 + 1], bias[j].y);
      tm = fmaxf(tm, fmaxf(z[j][0], z[j][1]));
    }
    // the label's logit, where this thread holds its column
    const int dl = (h == 0 ? lab[0][i] : lab[1][i]) - col0;
    if ((unsigned)dl < 8u * NW) {
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (dl == 8 * j + e) s_zl[h][rows_i[i]] = z[j][e];
    }
    if (h == 0)
      lse_add<NW>(m[0][i], s[0][i], z, tm);
    else
      lse_add<NW>(m[1][i], s[1][i], z, tm);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    recon_tc_kernel(const TcArgs a) {
  using G = TcGeom<D>;
  constexpr int NT = G::NT, LD = G::LD, NW = G::NW;
  constexpr int ST = G::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sB = sA + G::A_ELEMS;
  float* sK = reinterpret_cast<float*>(sB + G::STAGES * G::STAGE_ELEMS);
  __shared__ int s_lab[3][kBM], s_q[kBM];
  __shared__ float2 s_st[kBM];
  __shared__ float s_c0[kBM], s_zl[2][kBM];
  __shared__ float s_pm[2][2][kBM], s_ps[2][2][kBM];  // [warp col][head][row]
  __shared__ float s_kz[kBM][kMaxKind + 1];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int count = *a.count;
  const int tiles = (count + kBM - 1) / kBM;
  const int vt = a.v_tc / NT;
  const int S = plan_slices(tiles, vt, gridDim.x, a.part_items);
  const long long items = (long long)tiles * S;
  // this thread's four accumulator rows: (m tile, half) = (i / 2, i % 2)
  int rows_i[kRI];
#pragma unroll
  for (int i = 0; i < kRI; ++i)
    rows_i[i] = wm * (kBM / 4) + (i >> 1) * 16 + (i & 1) * 8 + (lane >> 2);

  // the kind and duration weights (for their dots), gamma and beta (for
  // the LayerNorm) into shared memory
  float* sG = sK + (kMaxKind + 1) * D;
  for (int e = tid; e < (a.v_k + 1) * D; e += kTcThreads)
    sK[e] = e < a.v_k * D ? __ldg(a.wk + e) : __ldg(a.wd + e - a.v_k * D);
  for (int e = tid; e < D; e += kTcThreads) {
    sG[e] = __ldg(a.gamma + e);
    sG[D + e] = __ldg(a.beta + e);
  }

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = (int)(item / S), slice = (int)(item % S);
    const int t0 = slice * vt / S, nt = (slice + 1) * vt / S - t0;
    const int rows = min(kBM, count - tile * kBM);
    const int32_t* list = a.list + (long long)tile * kBM;
    __syncthreads();  // the previous item's shared tiles are consumed
    // the tile's positions, labels, targets and LayerNorm statistics, a
    // thread a row
    if (tid < kBM) {
      int q = -1;
      float2 st = make_float2(0.f, 1.f);  // a row past the last: finite
      if (tid < rows) {
        q = list[tid];
        st = a.stats[(long long)tile * kBM + tid];
        const int32_t* c = a.cat + (long long)q * a.C;
        const int l0 = take_slice_label(c[0], a.vf_s, a.lo_s, a.v_s);
        const int l1 = take_slice_label(c[1], a.vf_n, a.lo_n, a.v_n);
        s_lab[0][tid] = l0;
        s_lab[1][tid] = l1 < 0 ? -1 : a.vs_pad + l1;
        s_lab[2][tid] = take_label(c[2], a.v_k);
        s_c0[tid] = a.cont[(long long)q * a.Dc];
        // a label no row holds keeps NaN: its error is NaN
        s_zl[0][tid] = l0 < 0 ? NAN : 0.f;
        s_zl[1][tid] = l1 < 0 ? NAN : 0.f;
      } else {
        s_lab[0][tid] = s_lab[1][tid] = s_lab[2][tid] = -1;
        s_zl[0][tid] = 0.f;
        s_zl[1][tid] = 0.f;
      }
      s_q[tid] = q;
      s_st[tid] = st;
    }
    __syncthreads();
    // their decoder rows gathered into the A tile (zeros past the last)
    for (int e = tid; e < kBM * (D / 8); e += kTcThreads) {
      const int r = e / (D / 8), c = e % (D / 8);
      __nv_bfloat16* dst = sA + r * LD + c * 8;
      if (r < rows)
        cp_async16(smem_u32(dst), a.dec + (long long)s_q[r] * D + c * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
    // the ring's first stages, in flight during the LayerNorm
#pragma unroll
    for (int s = 0; s < ST - 1; ++s) {
      if (s < nt)
        load_stage<D>(a.planes, a.pbias, a.v_tc, (t0 + s) * NT,
                      sB + s * G::STAGE_ELEMS, tid);
      cp_async_commit();
    }
    cp_async_wait<ST - 1>();  // the rows (the oldest group) landed
    __syncthreads();
    // dec_ln in place from the statistics: 8 values a thread a step
    for (int e = tid; e < kBM * (D / 8); e += kTcThreads) {
      const int r = e / (D / 8), c = e % (D / 8);
      uint4* p = reinterpret_cast<uint4*>(sA + r * LD + c * 8);
      const uint4 u = *p;
      const float2 st = s_st[r];
      const float* g = sG + c * 8;
      const float* b = sG + D + c * 8;
      uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 f = bf16x2_to_float2(w[h]);
        const float y0 = ln_out(f.x, st.x, st.y, g[2 * h], b[2 * h], sA);
        const float y1 = ln_out(f.y, st.x, st.y, g[2 * h + 1], b[2 * h + 1],
                                sA);
        w[h] = (__float_as_uint(y0) >> 16) |
               (__float_as_uint(y1) & 0xFFFF0000u);
      }
      *p = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();
    int lab[2][kRI];
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      lab[0][i] = s_lab[0][rows_i[i]];
      lab[1][i] = s_lab[1][rows_i[i]];
    }
    float m[2][kRI], s[2][kRI];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
        m[h][i] = -INFINITY;
        s[h][i] = 0.f;
      }

    // the column tiles: wait for a tile's stage, refill the one the tile
    // before it used, the products, then the logits' epilogue
    float acc[kMI][NW][4];
    float2 bias[NW];
    const int cw = wn * (NT / 2) + (lane & 3) * 2;  // this thread's columns
    for (int it = 0; it < nt; ++it) {
      const int t = t0 + it;
      cp_async_wait<ST - 2>();
      __syncthreads();
      if (it + ST - 1 < nt)
        load_stage<D>(a.planes, a.pbias, a.v_tc, (t + ST - 1) * NT,
                      sB + ((it + ST - 1) % ST) * G::STAGE_ELEMS, tid);
      cp_async_commit();
      tile_products<D>(acc, bias, sA, sB + (it % ST) * G::STAGE_ELEMS, wm,
                       wn, lane);
      tile_epilogue<NW>(acc, bias, t * NT + cw, t * NT < a.vs_pad ? 0 : 1,
                        lab, rows_i, s_zl, m, s);
    }
    cp_async_wait<0>();
    // a row's (max, sum): its quad of lanes, then its two column warps
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float mo = __shfl_xor_sync(0xffffffffu, m[h][i], o);
          const float so = __shfl_xor_sync(0xffffffffu, s[h][i], o);
          lse_merge(m[h][i], s[h][i], mo, so);
        }
        if ((lane & 3) == 0) {
          s_pm[wn][h][rows_i[i]] = m[h][i];
          s_ps[wn][h][rows_i[i]] = s[h][i];
        }
      }
    __syncthreads();
    float fm[2], fs[2], fz[2];
    if (tid < kBM) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        fm[h] = s_pm[0][h][tid];
        fs[h] = s_ps[0][h][tid];
        lse_merge(fm[h], fs[h], s_pm[1][h][tid], s_ps[1][h][tid]);
        fz[h] = s_zl[h][tid];
      }
    }
    if (S > 1) {  // leave the partial; the tile's last slice merges
      float* rec = a.part + item * (long long)(kPart * kBM);
      if (tid < kBM) {
        rec[0 * kBM + tid] = fm[0];
        rec[1 * kBM + tid] = fs[0];
        rec[2 * kBM + tid] = fm[1];
        rec[3 * kBM + tid] = fs[1];
        rec[4 * kBM + tid] = fz[0];
        rec[5 * kBM + tid] = fz[1];
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) s_last = atomicAdd(a.tile_done + tile, 1) == S - 1;
      __syncthreads();
      if (!s_last) continue;
      __threadfence();
      if (tid < rows) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          fm[h] = -INFINITY;
          fs[h] = 0.f;
          fz[h] = 0.f;
        }
        for (int sl = 0; sl < S; ++sl) {
          const float* rp =
              a.part + ((long long)tile * S + sl) * (kPart * kBM) + tid;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            lse_merge(fm[h], fs[h], __ldcg(rp + (2 * h) * kBM),
                      __ldcg(rp + (2 * h + 1) * kBM));
            fz[h] += __ldcg(rp + (4 + h) * kBM);  // one slice holds it
          }
        }
      }
    }
    // the kind and duration logits, f32 dots on CUDA cores: a warp's
    // threads on one weight row (shared memory, broadcast) and 32 rows of
    // y, 8 bf16 of y and 8 f32 of the weight a step
    const int vk1 = a.v_k + 1;
    for (int e = tid; e < rows * vk1; e += kTcThreads) {
      const int j = e / rows, r = e % rows;
      const float4* w = reinterpret_cast<const float4*>(sK + j * D);
      const uint4* y = reinterpret_cast<const uint4*>(sA + r * LD);
      float d4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < D / 8; ++k) {
        const uint4 yv = y[k];
        const float4 w0 = w[2 * k], w1 = w[2 * k + 1];
        const float2 y0 = bf16x2_to_float2(yv.x), y1 = bf16x2_to_float2(yv.y);
        const float2 y2 = bf16x2_to_float2(yv.z), y3 = bf16x2_to_float2(yv.w);
        d4[0] = fmaf(y0.x, w0.x, fmaf(y0.y, w0.y, d4[0]));
        d4[1] = fmaf(y1.x, w0.z, fmaf(y1.y, w0.w, d4[1]));
        d4[2] = fmaf(y2.x, w1.x, fmaf(y2.y, w1.y, d4[2]));
        d4[3] = fmaf(y3.x, w1.z, fmaf(y3.y, w1.w, d4[3]));
      }
      const float dot = (d4[0] + d4[1]) + (d4[2] + d4[3]);
      s_kz[r][j] = __fadd_rn(dot, j < a.v_k ? __ldg(a.bk + j) : __ldg(a.bd));
    }
    __syncthreads();
    if (tid < rows) {
      float km = -INFINITY, ks = 0.f;
      for (int j = 0; j < a.v_k; ++j) km = fmaxf(km, s_kz[tid][j]);
      for (int j = 0; j < a.v_k; ++j) ks += expf(s_kz[tid][j] - km);
      const float lse_k = km + logf(ks);
      const float zl_k = s_lab[2][tid] < 0 ? NAN : s_kz[tid][s_lab[2][tid]];
      const long long q = s_q[tid];
      if (a.rec != nullptr) {
        write_record(a.rec + q * kRec, fm[0] + logf(fs[0]), fz[0],
                     fm[1] + logf(fs[1]), fz[1], __fsub_rn(lse_k, zl_k),
                     __fsub_rn(s_kz[tid][a.v_k], s_c0[tid]), lse_k);
        continue;
      }
      const float e = weighted_error(
          fm[0] + logf(fs[0]), fz[0], fm[1] + logf(fs[1]), fz[1], lse_k,
          zl_k, s_kz[tid][a.v_k], s_c0[tid], a.w_s, a.w_n, a.w_k, a.w_d);
      a.err[q] = e;
      if (a.span_map != nullptr) {
        const int idx = a.span_map[q];
        if (idx >= 0) a.scores[idx] = 1.f - expf(-e);
      }
    }
  }
}

template <int D>
int launch_tc_t(const TcArgs& a, long long M, const uint8_t* mask,
                int32_t* list, float2* stats, int32_t* count, int sms,
                int* launches, cudaStream_t st) {
  const long long blocks = (M + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  recon_compact_kernel<D><<<(unsigned)blocks, kThreads, 0, st>>>(
      mask, M, a.dec, a.eps, a.err, list, stats, count);
  ++*launches;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(recon_tc_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           TcGeom<D>::SMEM);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;  // the persistent CTAs: as many as the SMs hold
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, recon_tc_kernel<D>, kTcThreads, TcGeom<D>::SMEM);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  recon_tc_kernel<D><<<sms * per_sm, kTcThreads, TcGeom<D>::SMEM, st>>>(a);
  ++*launches;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------- bf16, any width
// d % 16 == 0 up to 1024 off the widths above: the A tile of 128 rows and
// the ring of whole-d plane stages no longer fit shared memory at wide d.
// Two launches again:
//   prep   a thread per position lists the real ones (as compact); a warp
//          a listed row takes its LayerNorm (lane k holding values k, k +
//          32, ...) and, from the normalised bf16 values, the kind and
//          duration logits as f32 warp dots: (mean, 1 / std, the kind CE,
//          the duration logit) at the row's list slot;
//   score  persistent CTAs of 8 warps over tiles of 64 listed positions:
//          the rows gathered by cp.async into a (64, d rounded to 64) bf16
//          A tile (zeros past d) and normalised in place; the planes
//          streamed through a 4-stage ring of (3 planes, 32 columns, 64 of
//          d) chunks, the (column tile, d chunk) steps in one sequence;
//          mma.sync m16n8k16, warps 4 x 2 over (64 rows, 32 columns); at a
//          column tile's last chunk the bias, label logit and online
//          log-sum-exp from the fragments, as above.
// The same three-plane products and f32 sums: the same bound.
constexpr int kWBM = 64;    // listed positions a tile
constexpr int kWNT = 32;    // columns a column tile
constexpr int kWKC = 64;    // d a chunk
constexpr int kWST = 4;     // ring stages
constexpr int kWLD = kWKC + 8;  // a stage row: ldmatrix without conflicts
constexpr int kWStage = 3 * kWNT * kWLD;  // bf16 a stage

__host__ __device__ constexpr int wide_pad(int d) {
  return (d + kWKC - 1) / kWKC * kWKC;
}
__host__ __device__ constexpr int wide_smem(int d) {
  return (kWBM * (wide_pad(d) + 8) + kWST * kWStage) * 2;
}

template <int PER>
__global__ void __launch_bounds__(kThreads) recon_prep_kernel(
    const uint8_t* __restrict__ mask, long long M, int d,
    const __nv_bfloat16* __restrict__ dec, const float* __restrict__ gamma,
    const float* __restrict__ beta, float eps, const float* __restrict__ wk,
    const float* __restrict__ bk, int v_k, const float* __restrict__ wd,
    const float* __restrict__ bd, const int32_t* __restrict__ cat, int C,
    float* __restrict__ err, int32_t* __restrict__ list,
    float4* __restrict__ rec, int32_t* __restrict__ count) {
  __shared__ int s_wcount[kWarps];
  __shared__ int s_base, s_pos[kThreads];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long base = (long long)blockIdx.x * kThreads;
  const long long q = base + tid;
  const bool real = q < M && mask[q];
  if (q < M && !real && err != nullptr) err[q] = 0.f;
  const unsigned bal = __ballot_sync(0xffffffffu, real);
  if (lane == 0) s_wcount[wid] = __popc(bal);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    off += w < wid ? s_wcount[w] : 0;
    total += s_wcount[w];
  }
  if (tid == 0) s_base = total ? atomicAdd(count, total) : 0;
  if (real) s_pos[off + __popc(bal & ((1u << lane) - 1u))] = tid;
  __syncthreads();
  if (tid < total) list[s_base + tid] = (int)(base + s_pos[tid]);
  for (int k = wid; k < total; k += kWarps) {
    const long long p = base + s_pos[k];
    const __nv_bfloat16* xr = dec + p * d;
    float v[PER];
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int f = j * 32 + lane;
      v[j] = f < d ? load_f(xr + f) : 0.f;
      s += (double)v[j];
    }
    const float mean = ln_mean(s, d);
    double sq = 0.0;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (j * 32 + lane < d) sq += ln_sq_dev(v[j], mean);
    const float rstd = ln_rstd(sq, d, eps);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int f = j * 32 + lane;
      v[j] = f < d ? ln_out(v[j], mean, rstd, __ldg(gamma + f),
                            __ldg(beta + f), xr)
                   : 0.f;
    }
    // the kind logits and the duration logit: f32 warp dots
    const int lab = take_label(cat[p * C + 2], v_k);
    float km = -INFINITY, ks = 0.f, zl = lab < 0 ? NAN : 0.f, dur = 0.f;
    for (int h = 0; h <= v_k; ++h) {
      const float* w = h < v_k ? wk + (long long)h * d : wd;
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int f = j * 32 + lane;
        if (f < d) a = fmaf(v[j], __ldg(w + f), a);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      const float z = __fadd_rn(a, h < v_k ? __ldg(bk + h) : __ldg(bd));
      if (h == v_k) {
        dur = z;
      } else {
        if (h == lab) zl = z;
        lse_merge(km, ks, z, 1.f);
      }
    }
    if (lane == 0)
      rec[s_base + k] = make_float4(mean, rstd, __fsub_rn(km + logf(ks), zl),
                                    dur);
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
    recon_tc_wide_kernel(const TcArgs a, int d, const float4* rec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dp = wide_pad(d), lda = dp + 8;
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sB = sA + kWBM * lda;
  __shared__ int s_lab[2][kWBM], s_q[kWBM];
  __shared__ float4 s_rec[kWBM];
  __shared__ float s_c0[kWBM], s_zl[2][kWBM];
  __shared__ float s_pm[2][2][kWBM], s_ps[2][2][kWBM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  const int count = *a.count;
  const int tiles = (count + kWBM - 1) / kWBM;
  const int nk = dp / kWKC, nct = a.v_tc / kWNT, steps = nct * nk;
  const int rows_i[2] = {wm * 16 + gid, wm * 16 + gid + 8};
  const int cw = wn * (kWNT / 2) + tig * 2;  // this thread's column pair

  auto load_step = [&](int step, int slot) {
    const int ct = step / nk, kc = step - (step / nk) * nk;
    __nv_bfloat16* st = sB + slot * kWStage;
    for (int e = tid; e < 3 * kWNT * (kWKC / 8); e += kTcThreads) {
      const int p = e / (kWNT * (kWKC / 8));
      const int r = (e / (kWKC / 8)) % kWNT, c = e % (kWKC / 8);
      const int k0 = kc * kWKC + c * 8;
      const bool in = k0 < d;
      cp_async16_zfill(
          smem_u32(st + (p * kWNT + r) * kWLD + c * 8),
          a.planes + ((long long)p * a.v_tc + ct * kWNT + r) * d +
              (in ? k0 : 0),
          in);
    }
  };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int rows = min(kWBM, count - tile * kWBM);
    __syncthreads();  // the previous tile's shared data are consumed
    if (tid < kWBM) {
      int q = -1;
      float4 r4 = make_float4(0.f, 1.f, 0.f, 0.f);  // past the last: finite
      if (tid < rows) {
        q = a.list[(long long)tile * kWBM + tid];
        r4 = rec[(long long)tile * kWBM + tid];
        const int32_t* c = a.cat + (long long)q * a.C;
        const int l0 = take_slice_label(c[0], a.vf_s, a.lo_s, a.v_s);
        const int l1 = take_slice_label(c[1], a.vf_n, a.lo_n, a.v_n);
        s_lab[0][tid] = l0;
        s_lab[1][tid] = l1 < 0 ? -1 : a.vs_pad + l1;
        s_c0[tid] = a.cont[(long long)q * a.Dc];
        s_zl[0][tid] = l0 < 0 ? NAN : 0.f;
        s_zl[1][tid] = l1 < 0 ? NAN : 0.f;
      } else {
        s_lab[0][tid] = s_lab[1][tid] = -1;
        s_zl[0][tid] = 0.f;
        s_zl[1][tid] = 0.f;
      }
      s_q[tid] = q;
      s_rec[tid] = r4;
    }
    __syncthreads();
    for (int e = tid; e < kWBM * (dp / 8); e += kTcThreads) {
      const int r = e / (dp / 8), c = e % (dp / 8);
      const bool in = r < rows && c * 8 < d;
      cp_async16_zfill(smem_u32(sA + r * lda + c * 8),
                       a.dec + (long long)(in ? s_q[r] : 0) * d +
                           (in ? c * 8 : 0),
                       in);
    }
    cp_async_commit();
#pragma unroll
    for (int s = 0; s < kWST - 1; ++s) {
      if (s < steps) load_step(s, s);
      cp_async_commit();
    }
    cp_async_wait<kWST - 1>();  // the rows (the oldest group) landed
    __syncthreads();
    for (int e = tid; e < kWBM * (d / 8); e += kTcThreads) {
      const int r = e / (d / 8), c = e % (d / 8);
      uint4* p = reinterpret_cast<uint4*>(sA + r * lda + c * 8);
      const uint4 u = *p;
      const float4 st = s_rec[r];
      uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int f = c * 8 + 2 * h;
        const float2 x = bf16x2_to_float2(w[h]);
        const float y0 = ln_out(x.x, st.x, st.y, __ldg(a.gamma + f),
                                __ldg(a.beta + f), sA);
        const float y1 = ln_out(x.y, st.x, st.y, __ldg(a.gamma + f + 1),
                                __ldg(a.beta + f + 1), sA);
        w[h] = (__float_as_uint(y0) >> 16) |
               (__float_as_uint(y1) & 0xFFFF0000u);
      }
      *p = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();
    int lab[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lab[0][i] = s_lab[0][rows_i[i]];
      lab[1][i] = s_lab[1][rows_i[i]];
    }
    float m[2][2], s[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[h][i] = -INFINITY;
        s[h][i] = 0.f;
      }
    float acc[2][4];
    for (int it = 0; it < steps; ++it) {
      cp_async_wait<kWST - 2>();
      __syncthreads();
      if (it + kWST - 1 < steps) load_step(it + kWST - 1, (it + kWST - 1) % kWST);
      cp_async_commit();
      const int ct = it / nk, kc = it - (it / nk) * nk;
      if (kc == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      }
      const __nv_bfloat16* sb = sB + (it % kWST) * kWStage;
#pragma unroll
      for (int kk = 0; kk < kWKC / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4(smem_u32(sA + (wm * 16 + (lane & 15)) * lda + kc * kWKC +
                         kk * 16 + (lane >> 4) * 8),
                af);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          uint32_t bf[4];
          ldsm_x4(smem_u32(sb + (p * kWNT + wn * (kWNT / 2) + (lane & 7) +
                                 ((lane >> 4) << 3)) *
                                    kWLD +
                           kk * 16 + ((lane >> 3) & 1) * 8),
                  bf);
          mma_bf16(acc[0], af, bf[0], bf[1]);
          mma_bf16(acc[1], af, bf[2], bf[3]);
        }
      }
      if (kc == nk - 1) {  // the column tile's logits
        const int col0 = ct * kWNT + cw;
        const int h = ct * kWNT < a.vs_pad ? 0 : 1;
        float2 bias[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          bias[j] = make_float2(__ldg(a.pbias + col0 + 8 * j),
                                __ldg(a.pbias + col0 + 8 * j + 1));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float z[2][2];
          float tm = -INFINITY;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            z[j][0] = __fadd_rn(acc[j][i * 2], bias[j].x);
            z[j][1] = __fadd_rn(acc[j][i * 2 + 1], bias[j].y);
            tm = fmaxf(tm, fmaxf(z[j][0], z[j][1]));
          }
          const int dl = lab[h][i] - col0;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (dl == 8 * j + e) s_zl[h][rows_i[i]] = z[j][e];
          if (h == 0)
            lse_add<2>(m[0][i], s[0][i], z, tm);
          else
            lse_add<2>(m[1][i], s[1][i], z, tm);
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float mo = __shfl_xor_sync(0xffffffffu, m[h][i], o);
          const float so = __shfl_xor_sync(0xffffffffu, s[h][i], o);
          lse_merge(m[h][i], s[h][i], mo, so);
        }
        if (tig == 0) {
          s_pm[wn][h][rows_i[i]] = m[h][i];
          s_ps[wn][h][rows_i[i]] = s[h][i];
        }
      }
    __syncthreads();
    if (tid < rows) {
      float fm[2], fs[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        fm[h] = s_pm[0][h][tid];
        fs[h] = s_ps[0][h][tid];
        lse_merge(fm[h], fs[h], s_pm[1][h][tid], s_ps[1][h][tid]);
      }
      const float4 r4 = s_rec[tid];
      const long long q = s_q[tid];
      if (a.rec != nullptr) {  // no kind log-sum-exp here: lse_k 0
        write_record(a.rec + q * kRec, fm[0] + logf(fs[0]), s_zl[0][tid],
                     fm[1] + logf(fs[1]), s_zl[1][tid], r4.z,
                     __fsub_rn(r4.w, s_c0[tid]), 0.f);
        continue;
      }
      const float e = weighted_error(fm[0] + logf(fs[0]), s_zl[0][tid],
                                     fm[1] + logf(fs[1]), s_zl[1][tid], r4.z,
                                     0.f, r4.w, s_c0[tid], a.w_s, a.w_n,
                                     a.w_k, a.w_d);
      a.err[q] = e;
      if (a.span_map != nullptr) {
        const int idx = a.span_map[q];
        if (idx >= 0) a.scores[idx] = 1.f - expf(-e);
      }
    }
  }
}

int launch_tc_wide(const TcArgs& a, long long M, int d, const uint8_t* mask,
                   int32_t* list, float4* rec, int32_t* count, int sms,
                   int* launches, cudaStream_t st) {
  const long long blocks = (M + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned g = (unsigned)blocks;
  int32_t* cnt = count;
  if (d <= 256)
    recon_prep_kernel<8><<<g, kThreads, 0, st>>>(
        mask, M, d, a.dec, a.gamma, a.beta, a.eps, a.wk, a.bk, a.v_k, a.wd,
        a.bd, a.cat, a.C, a.err, list, rec, cnt);
  else if (d <= 512)
    recon_prep_kernel<16><<<g, kThreads, 0, st>>>(
        mask, M, d, a.dec, a.gamma, a.beta, a.eps, a.wk, a.bk, a.v_k, a.wd,
        a.bd, a.cat, a.C, a.err, list, rec, cnt);
  else
    recon_prep_kernel<32><<<g, kThreads, 0, st>>>(
        mask, M, d, a.dec, a.gamma, a.beta, a.eps, a.wk, a.bk, a.v_k, a.wd,
        a.bd, a.cat, a.C, a.err, list, rec, cnt);
  ++*launches;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem = wide_smem(d);
  e = cudaFuncSetAttribute(recon_tc_wide_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, recon_tc_wide_kernel, kTcThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  recon_tc_wide_kernel<<<sms * per_sm, kTcThreads, smem, st>>>(a, d, rec);
  ++*launches;
  return (int)cudaGetLastError();
}

}  // namespace

// The bytes of K11's f32 data scratch for M positions, service, name and
// kind heads of v0, v1 and v2 rows; -1 off their range.
extern "C" long long recon_ce_f32_scratch(long long M, int v0, int v1,
                                          int v2) {
  if (M < 0 || v0 < 1 || v1 < 1 || v2 < 1) return -1;
  return f32_data_bytes(M, items_per_tile(v0, v1), v2 + 1);
}

// The int32 counters of K11's f32 route for M positions.
extern "C" long long recon_ce_f32_counters(long long M) {
  return M < 0 ? -1 : f32_counters(M);
}

// K11 on CUDA cores (f32 FMAs). dec: (M, d) f32 (dtype 0) or bf16 (dtype
// 1: heads the three planes cannot hold), the decoder's output before
// dec_ln, 16-byte aligned, d % 4 == 0 up to 1024, M < 2^31; gamma, beta:
// (d,) f32; w0..w3: the service, name, kind and duration heads' (V_h, d)
// f32 weights (16-byte aligned), b0..b3 their (V_h,) biases (V_3 = 1);
// cat: (M, C) int32 (labels in columns 0-2), cont: (M, D) f32 (target in
// column 0); mask: (M,) bytes; the four loss weights; err: (M,) f32 out.
// span_map (nullable): (M,) int32 original span index, -1 at padding;
// scores: zero-filled f32, written at span_map[q] for each real q.
// lse (nullable): (M, 3) f32 out, each real position's log-sum-exps of the
// service, name and kind logits (0 at padding), for K20's backward.
// vf0, lo0, vf1, lo1: the service and name heads' whole widths and the
// first row of the slice w0 and w1 hold (v0 = vf0, lo0 = 0 unsliced).
// rec (nullable, slice mode): (M, 8) f32 out, each real position's record
// (the header's layout) in place of err, lse and scores (err, span_map and
// lse then null).
// counters: recon_ce_f32_counters(M) int32, zero before their first call
// and left so by each (one set a stream: calls on one stream run in
// order); scratch: recon_ce_f32_scratch(M, v0, v1, v2) bytes, 16-byte
// aligned.
// sms: the card's multiprocessors. *launches gets the kernels launched
// (2).
extern "C" int recon_ce_f32_launch(
    const void* dec, int dtype, long long M, int d, const void* gamma,
    const void* beta, float eps, const void* w0, const void* w1,
    const void* w2, const void* w3, const void* b0, const void* b1,
    const void* b2, const void* b3, int v0, int v1, int v2, int v3,
    const void* cat, int C, const void* cont, int D, const void* mask,
    float w_s, float w_n, float w_k, float w_d, void* err,
    const void* span_map, void* scores, void* lse, int vf0, int lo0,
    int vf1, int lo1, void* rec, void* counters, void* scratch, int sms,
    int* launches, void* stream) {
  *launches = 0;
  if (M < 0 || M > 0x7fffffffLL || v0 < 1 || v1 < 1 || v2 < 1 || v3 != 1 ||
      C < 3 || D < 1 || d < 4 || d % 4 != 0 || d > 1024 ||
      (dtype != 0 && dtype != 1) || counters == nullptr ||
      scratch == nullptr || sms < 1 ||
      (span_map != nullptr && scores == nullptr) || lo0 < 0 || lo1 < 0 ||
      lo0 + v0 > vf0 || lo1 + v1 > vf1 ||
      (rec != nullptr ? span_map != nullptr || lse != nullptr
                      : err == nullptr))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  F32Args a;
  const void* ws[4] = {w0, w1, w2, w3};
  const void* bs[4] = {b0, b1, b2, b3};
  const int vs[4] = {v0, v1, v2, v3};
  for (int h = 0; h < 4; ++h) {
    a.heads.w[h] = static_cast<const float*>(ws[h]);
    a.heads.b[h] = static_cast<const float*>(bs[h]);
    a.heads.v[h] = vs[h];
  }
  a.dec = dec;
  a.M = M;
  a.d = d;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.eps = eps;
  a.cat = static_cast<const int32_t*>(cat);
  a.C = C;
  a.cont = static_cast<const float*>(cont);
  a.D = D;
  a.w_s = w_s;
  a.w_n = w_n;
  a.w_k = w_k;
  a.w_d = w_d;
  a.err = static_cast<float*>(err);
  a.span_map = static_cast<const int32_t*>(span_map);
  a.scores = static_cast<float*>(scores);
  a.lse = static_cast<float*>(lse);
  a.vf[0] = vf0;
  a.vf[1] = vf1;
  a.lo[0] = lo0;
  a.lo[1] = lo1;
  a.rec = static_cast<float*>(rec);
  a.sc = carve_f32(counters, scratch, M, items_per_tile(v0, v1));
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_f32_d<__nv_bfloat16>(a, m, sms, launches, st);
  return launch_f32_d<float>(a, m, sms, launches, st);
}

// K11, bf16 (tensor cores). dec: (M, d) bf16; gamma, beta as above;
// planes: (3, v_tc, d) bf16, the service and name heads' W_hi, W_mid,
// W_lo, each head's rows padded with zeros to a multiple of 64 (service
// rows [0, vs_pad), name rows [vs_pad, v_tc)); pbias: (v_tc,) f32, -inf at
// the padding; v_s, v_n: the real widths; wk, bk: the kind head (v_k <=
// 16); wd, bd: the duration head; cat, cont, mask, the loss weights, err,
// span_map and scores as above; vf_s, lo_s, vf_n, lo_n and rec as the f32
// launcher's (slice mode: err and span_map null). d: 32, 64, 128 or 256
// (the 128-position
// kernel), else d % 16 == 0 up to 1024 (the 64-position kernel chunked
// along d). Scratch: list (M,) int32; stats (M, 2) f32 (each listed
// position's LayerNorm mean and 1 / std; (M, 4) 16-byte aligned off the
// four widths: also the kind CE and the duration logit); part:
// part_floats f32, room for part_floats / (6 * 128) split items'
// partials; count (1,) and tile_done (that room / 2 + 1) int32, zeroed.
// sms: the card's multiprocessors (the persistent grid is as many CTAs as
// they hold). dec 16-byte aligned, M < 2^31. *launches gets the kernels
// launched.
extern "C" int recon_ce_tc_launch(
    const void* dec, long long M, int d, const void* gamma, const void* beta,
    float eps, const void* planes, const void* pbias, int vs_pad, int v_tc,
    int v_s, int v_n, const void* wk, const void* bk, int v_k,
    const void* wd, const void* bd, const void* cat, int C,
    const void* cont, int D, const void* mask, float w_s, float w_n,
    float w_k, float w_d, void* err, const void* span_map, void* scores,
    int vf_s, int lo_s, int vf_n, int lo_n, void* rec, void* list,
    void* stats, void* count, void* part, long long part_floats,
    void* tile_done, int sms, int* launches, void* stream) {
  *launches = 0;
  if (M < 0 || M > 0x7fffffffLL || v_s < 1 || v_n < 1 || v_k < 1 ||
      v_k > kMaxKind || vs_pad < v_s || vs_pad % kPlanePad ||
      v_tc - vs_pad < v_n || v_tc % kPlanePad || C < 3 || D < 1 ||
      part_floats < 0 || sms < 1 || (span_map != nullptr && scores == nullptr)
      || lo_s < 0 || lo_n < 0 || lo_s + v_s > vf_s || lo_n + v_n > vf_n ||
      (rec != nullptr ? span_map != nullptr : err == nullptr))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  TcArgs a;
  a.dec = static_cast<const __nv_bfloat16*>(dec);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.eps = eps;
  a.planes = static_cast<const __nv_bfloat16*>(planes);
  a.pbias = static_cast<const float*>(pbias);
  a.vs_pad = vs_pad;
  a.v_tc = v_tc;
  a.v_s = v_s;
  a.v_n = v_n;
  a.wk = static_cast<const float*>(wk);
  a.bk = static_cast<const float*>(bk);
  a.v_k = v_k;
  a.wd = static_cast<const float*>(wd);
  a.bd = static_cast<const float*>(bd);
  a.cat = static_cast<const int32_t*>(cat);
  a.C = C;
  a.cont = static_cast<const float*>(cont);
  a.Dc = D;
  a.w_s = w_s;
  a.w_n = w_n;
  a.w_k = w_k;
  a.w_d = w_d;
  a.err = static_cast<float*>(err);
  a.span_map = static_cast<const int32_t*>(span_map);
  a.scores = static_cast<float*>(scores);
  a.vf_s = vf_s;
  a.lo_s = lo_s;
  a.vf_n = vf_n;
  a.lo_n = lo_n;
  a.rec = static_cast<float*>(rec);
  a.list = static_cast<const int32_t*>(list);
  a.stats = static_cast<const float2*>(stats);
  a.count = static_cast<const int32_t*>(count);
  a.part = static_cast<float*>(part);
  a.part_items = (int)(part_floats / (kPart * kBM));
  a.tile_done = static_cast<int32_t*>(tile_done);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int32_t* l = static_cast<int32_t*>(list);
  float2* sts = static_cast<float2*>(stats);
  int32_t* n = static_cast<int32_t*>(count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_tc_t<32>(a, M, m, l, sts, n, sms, launches, st);
    case 64:
      return launch_tc_t<64>(a, M, m, l, sts, n, sms, launches, st);
    case 128:
      return launch_tc_t<128>(a, M, m, l, sts, n, sms, launches, st);
    case 256:
      return launch_tc_t<256>(a, M, m, l, sts, n, sms, launches, st);
    default:
      if (d % 16 != 0 || d > 1024) return (int)cudaErrorInvalidValue;
      return launch_tc_wide(a, M, d, m, l, static_cast<float4*>(stats), n,
                            sms, launches, st);
  }
}
