// K18: the backward pass of the span-embedding gather-sum (K2) — for Hopper
// (sm_90a), f32 (the trainer's working type).
//
// Replaces: the gradient XLA derives for the nn.Embed sum of
// odigos_tpu/models/layers.py SpanEmbedder (:35-56) and the positional add
// and padding mask of Encoder (:106-115), inside the jitted value_and_grad
// of odigos_tpu/training/trainer.py:171. The JAX package has no Pallas
// kernel here; the trainer's step on the card needs a hand-written one.
//
// The forward sums, at each slot n with segment > 0, one row of each table
// as K2 reads it (jnp.take's fill mode, as Flax's nn.Embed: an id in [0,
// rows) takes its row, one in [-rows, 0) row id + rows, any other id none,
// and jax.grad drops its gradient; a one-row table takes every id; the
// positions are held into their table); so each table's gradient row t is
// the sum of the upstream gradient dy[n] over the live slots that gathered
// row t:
//   service  columns 0 and 4 (the parent service shares the table),
//   name     column 1,  kind  column 2 (8 rows),  status  column 3 (4 rows),
//   attr     columns 5 .. C - 1, where the model has attribute slots,
//   pos      the positions.
// (The continuous projection's gradient is two small matrix products in
// kernels/autograd.py.) The small tables take 2048 slots into 4 to 32 rows
// at the trainer's shapes: scattering with atomics would pile hundreds of
// adds on each address and sum in a different order every run. So each
// table's entries (column j, slot n), in that order, are sorted stably by
// row and summed in a fixed order, with no atomics on the sums.
//
// One launch. A CTA of 32 warps takes kRows rows of one table and a slab
// of kSlab columns (kNarrow where the table is one row block: the small
// tables' hot rows are read by four CTAs at d 256, not one SM):
// * the sort, by every warp: warp w takes the w-th contiguous chunk of the
//   table's entries, reads their ids kGroup batches of 32 at a time (every
//   load issued first), counts its entries of each of the CTA's rows (lanes
//   that share a row by __match_any_sync, the lowest adding their count) and
//   those below the CTA's rows; an exclusive scan over (row, warp) gives
//   each warp's place in each row, so a second pass over the chunk writes
//   every entry's slot at its stable place in the table's entry list (the
//   CTA's rows start where the entries of the rows below end);
// * the sums: the CTA's M listed entries are cut into 32 contiguous runs,
//   one a warp, each lane adding up to 8 columns of the runs' dy rows in
//   f64 (16-byte loads, 4 rows in flight); a row a run holds whole is
//   rounded once and stored, a row cut across runs leaves each run's f64
//   part in shared memory, and the run that holds the row's first entry
//   adds the parts in run order, rounds once and stores. A hot row (4
//   status rows for 611 slots) is summed by many warps; a row no slot
//   gathered is written as zero vectors.
// The integer counts leave no trace in the result, and each sum runs in one
// fixed order, so a step is reproducible. The f64 sum of f32 terms is
// exact while their binade spread plus log2(count) plus 24 stays within 53
// bits, so the plain version (index_add_ in f64, rounded once) and the
// parent design give the same bits there whatever the order.
//
// Bound on the card: bytes. At the trainer's 2048 slots of d 256 the
// function needs the segments, each live slot's dy row and ids once (611
// live slots in a step: 0.6 MB) and writes the tables' gradients (512 +
// 2048 + 8 + 4 + 32 rows of 1 KB, 2.7 MB): 3.3 MB, 1.0 us at 3.35 TB/s.
// This pass reads a live slot's dy row once a table it feeds (six times,
// mostly from L2) and each table's ids once a CTA of the table; one f64 add
// a value read. The measured times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "embed_take.cuh"  // take_row

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;    // table rows a CTA
constexpr int kSlab = 256;   // columns a CTA: 8 a lane
constexpr int kNarrow = 64;  // ... of a table of one row block (4 CTAs)
constexpr int kPer = kSlab / 32;
constexpr int kGroup = 4;    // batches of 32 entries whose ids load at once
constexpr int kMaxTables = 6;
constexpr int kMaxD = 1024;
constexpr int kMaxRows = 49152;  // each of a table's CTAs reads all its ids
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
// dynamic shared memory: two f64 parts of kSlab columns a warp
constexpr int kPartBytes = kWarps * 2 * kSlab * 8;

static_assert(kRows * kWarps == kThreads, "the (row, warp) scan: a thread each");

struct Table {
  long long grad_off;   // the table's first gradient element
  long long order_off;  // its entry lists' first element (one a slab)
  int rows;             // the gradient's rows (the table's)
  int id_rows;          // the rows an id addresses (kind 8, status 4)
  int col_first;        // the table's categorical columns: col_first +
  int col_step;         //   j * col_step for j < ncols
  int ncols;
  int use_pos;          // 1: the ids are the positions (one column)
  int cta_first;        // its first CTA
  int slab_w;           // columns a CTA: kSlab, or kNarrow where the
  int slabs;            //   table is one row block; CTAs a row block
};

struct Tables {
  Table t[kMaxTables];
  int n;
  int ctas;
};

// The row ids of entries base + 32 g + lane (column e / N, slot e % N;
// the plan keeps every entry index below 2^31), -1 past hi, at a padding
// slot or for an id that takes no row; every load issued before any is
// used
__device__ __forceinline__ void group_ids(const Table& tb, int base, int hi,
                                          int N, const int* __restrict__ cat,
                                          int C, const int* __restrict__ pos,
                                          const int* __restrict__ seg,
                                          int lane, int (&id)[kGroup],
                                          int (&slot)[kGroup]) {
  int sg[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int e = base + 32 * g + lane;
    sg[g] = 0;
    id[g] = 0;
    slot[g] = 0;
    if (e < hi) {
      const int j = e / N;
      const int n = e - j * N;
      slot[g] = n;
      sg[g] = __ldg(seg + n);
      id[g] = tb.use_pos ? __ldg(pos + n)
                         : __ldg(cat + (long long)n * C + tb.col_first +
                                 j * tb.col_step);
    }
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int x = id[g];
    const int r = tb.use_pos ? (x < 0 ? 0 : (x < tb.id_rows ? x
                                                             : tb.id_rows - 1))
                             : take_row(x, tb.id_rows);
    id[g] = sg[g] <= 0 ? -1 : r;
  }
}

// lane's columns of a slab: VEC, 16-byte vectors at 4 lane + 128 k; else
// lane + 32 k (k < kPer / 4 or kPer)
template <bool VEC>
__device__ __forceinline__ int col_of(int lane, int k) {
  return VEC ? 4 * lane + 128 * (k >> 2) + (k & 3) : lane + 32 * k;
}

template <bool VEC>
__device__ __forceinline__ void add_row(double (&acc)[kPer],
                                        const float* __restrict__ src,
                                        int lane, int width) {
  if (VEC) {
#pragma unroll
    for (int k = 0; k < kPer / 4; ++k) {
      const int c = 4 * lane + 128 * k;
      if (c < width) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(src + c));
        acc[4 * k] += (double)x.x;
        acc[4 * k + 1] += (double)x.y;
        acc[4 * k + 2] += (double)x.z;
        acc[4 * k + 3] += (double)x.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = lane + 32 * k;
      if (c < width) acc[k] += (double)__ldg(src + c);
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store_row(float* dst, const double (&acc)[kPer],
                                          int lane, int width) {
  if (VEC) {
#pragma unroll
    for (int k = 0; k < kPer / 4; ++k) {
      const int c = 4 * lane + 128 * k;
      if (c < width)
        *reinterpret_cast<float4*>(dst + c) =
            make_float4((float)acc[4 * k], (float)acc[4 * k + 1],
                        (float)acc[4 * k + 2], (float)acc[4 * k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = lane + 32 * k;
      if (c < width) dst[c] = (float)acc[k];
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
span_embed_bwd_kernel(Tables tabs, const float* __restrict__ dy,
                      const int* __restrict__ cat,
                      const int* __restrict__ pos,
                      const int* __restrict__ seg, long long N, int C, int d,
                      float* __restrict__ grads, int* __restrict__ order) {
  extern __shared__ double parts[];  // [warp][2][kSlab]
  __shared__ int off[kRows * kWarps];  // (row, warp): counts, then places
  __shared__ int rstart[kRows + 1];
  __shared__ int wsum[kWarps];
  __shared__ int below_w[kWarps];
  __shared__ int first_row[kWarps], last_row[kWarps];
  __shared__ int first_part[kWarps], last_part[kWarps];

  int t = 0;
  while (t + 1 < tabs.n && (int)blockIdx.x >= tabs.t[t + 1].cta_first) ++t;
  const Table& tb = tabs.t[t];
  const int local = blockIdx.x - tb.cta_first;
  const int blk = local / tb.slabs;
  const int slab = local - blk * tb.slabs;
  const int r0 = blk * kRows;
  const int nrows = min(kRows, tb.rows - r0);
  const int c0 = slab * tb.slab_w;
  const int width = min(tb.slab_w, d - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = (int)N * (tb.use_pos ? 1 : tb.ncols);
  const int chunk = (E + kWarps - 1) / kWarps;
  const int lo = min(E, warp * chunk), hi = min(E, lo + chunk);
  const unsigned below_lanes = (1u << lane) - 1u;

  // ---- the sort, pass 1: counts of (row, warp), and entries below r0
  off[tid] = 0;
  __syncthreads();
  int below = 0;
  for (int base = lo; base < hi; base += 32 * kGroup) {
    int id[kGroup], slot[kGroup];
    group_ids(tb, base, hi, (int)N, cat, C, pos, seg, lane, id, slot);
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      below += __popc(__ballot_sync(kFull, id[g] >= 0 && id[g] < r0));
      const int loc = (id[g] >= r0 && id[g] < r0 + nrows) ? id[g] - r0 : -1;
      const unsigned peers = __match_any_sync(kFull, loc);
      if (loc >= 0 && (peers & below_lanes) == 0)
        off[loc * kWarps + warp] += __popc(peers);
      __syncwarp();
    }
  }
  if (lane == 0) below_w[warp] = below;
  __syncthreads();

  // ---- exclusive scan over (row, warp), a thread each
  const int cnt = off[tid];
  int inc = cnt;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = wsum[lane];
    int b = below_w[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
      b += __shfl_xor_sync(kFull, b, o);
    }
    wsum[lane] = w;  // inclusive over warps
    if (lane == 0) below_w[0] = b;  // the entries of the rows below r0
  }
  __syncthreads();
  const int place = inc - cnt + (warp > 0 ? wsum[warp - 1] : 0);
  off[tid] = place;
  if (tid % kWarps == 0) rstart[tid / kWarps] = place;
  const int M = wsum[kWarps - 1];
  if (tid == 0) rstart[kRows] = M;
  int* list = order + tb.order_off + (long long)slab * E + below_w[0];
  __syncthreads();

  // ---- the sort, pass 2: each entry's slot at its stable place
  for (int base = lo; base < hi; base += 32 * kGroup) {
    int id[kGroup], slot[kGroup];
    group_ids(tb, base, hi, (int)N, cat, C, pos, seg, lane, id, slot);
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int loc = (id[g] >= r0 && id[g] < r0 + nrows) ? id[g] - r0 : -1;
      const unsigned peers = __match_any_sync(kFull, loc);
      if (loc >= 0)
        list[off[loc * kWarps + warp] + __popc(peers & below_lanes)] =
            slot[g];
      __syncwarp();
      if (loc >= 0 && (peers & below_lanes) == 0)
        off[loc * kWarps + warp] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();  // the list's writes seen by the whole CTA

  float* out = grads + tb.grad_off + (long long)r0 * d + c0;
  // ---- rows no slot gathered: zeros, every thread a (row, vector)
  const int per_row = VEC ? (width + 3) >> 2 : width;
  for (int i = tid; i < nrows * per_row; i += kThreads) {
    const int row = i / per_row, c = i - row * per_row;
    if (rstart[row] != rstart[row + 1]) continue;
    float* dst = out + (long long)row * d;
    if (VEC)
      *reinterpret_cast<float4*>(dst + 4 * c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    else
      dst[c] = 0.f;
  }

  // ---- the sums: run w of the list, rows whole stored, cut rows' parts
  const int rlo = (int)((long long)M * warp / kWarps);
  const int rhi = (int)((long long)M * (warp + 1) / kWarps);
  if (lane == 0) {  // an empty run's first row is -2
    first_row[warp] = rlo < rhi ? -1 : -2;
    last_row[warp] = -1;
    first_part[warp] = last_part[warp] = 0;
  }
  __syncwarp();
  if (rlo < rhi) {
    int row = 0;
    while (rstart[row + 1] <= rlo) ++row;
    const float* src0 = dy + c0;
    for (int e = rlo; e < rhi;) {
      const int end = min(rstart[row + 1], rhi);
      double acc[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) acc[k] = 0.0;
      for (int x0 = e; x0 < end; x0 += 32) {  // 32 slots read at once
        const int n = min(32, end - x0);
        const int mine = lane < n ? list[x0 + lane] : 0;
#pragma unroll 4
        for (int x = 0; x < n; ++x)
          add_row<VEC>(acc,
                       src0 + (long long)__shfl_sync(kFull, mine, x) * d,
                       lane, width);
      }
      const bool whole = e == rstart[row] && end == rstart[row + 1];
      if (whole) {
        store_row<VEC>(out + (long long)row * d, acc, lane, width);
      } else {
        const int s = e == rlo ? 0 : 1;
        double* part = parts + (warp * 2 + s) * kSlab;
#pragma unroll
        for (int k = 0; k < kPer; ++k) part[col_of<VEC>(lane, k)] = acc[k];
        if (lane == 0) {
          if (s == 0) {
            first_row[warp] = row;
            first_part[warp] = 1;
          } else {
            last_row[warp] = row;
            last_part[warp] = 1;
          }
        }
      }
      e = end;
      while (row < nrows && rstart[row + 1] <= e) ++row;
    }
  }
  __syncthreads();

  // ---- cut rows: the run holding a row's first entry adds the runs' parts
  // in run order (empty runs passed over), rounds once and stores
  for (int s = 0; s < 2; ++s) {
    const int row = s == 0 ? first_row[warp] : last_row[warp];
    if (!(s == 0 ? first_part[warp] : last_part[warp])) continue;
    if (s == 0 && rlo != rstart[row]) continue;  // an earlier run owns it
    double acc[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      acc[k] = parts[(warp * 2 + s) * kSlab + col_of<VEC>(lane, k)];
    for (int w = warp + 1; w < kWarps; ++w) {
      if (first_row[w] == -2) continue;
      if (!first_part[w] || first_row[w] != row) break;
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        acc[k] += parts[(w * 2) * kSlab + col_of<VEC>(lane, k)];
    }
    store_row<VEC>(out + (long long)row * d, acc, lane, width);
  }
}

std::atomic<int> g_attr_set[2][kMaxDevices];

template <bool VEC>
cudaError_t launch(const Tables& tabs, const float* dy, const int* cat,
                   const int* pos, const int* seg, long long N, int C, int d,
                   float* grads, int* order, cudaStream_t st) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || !g_attr_set[VEC][dev].load()) {
    e = cudaFuncSetAttribute(span_embed_bwd_kernel<VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kPartBytes);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) g_attr_set[VEC][dev].store(1);
  }
  span_embed_bwd_kernel<VEC><<<tabs.ctas, kThreads, kPartBytes, st>>>(
      tabs, dy, cat, pos, seg, N, C, d, grads, order);
  return cudaGetLastError();
}

// The launch plan from the host's meta (six ints a table: rows, id_rows,
// col_first, col_step, ncols, use_pos); false where the meta is refused.
bool plan(long long N, int d, int n_tables, const int* meta, Tables* tabs,
          long long* grad_elems, long long* order_ints) {
  if (N <= 0 || N > 0x7fffffffLL || d <= 0 || d > kMaxD || n_tables <= 0 ||
      n_tables > kMaxTables)
    return false;
  *tabs = Tables{};
  tabs->n = n_tables;
  long long goff = 0, ooff = 0, ctas = 0;
  for (int i = 0; i < n_tables; ++i) {
    Table& tb = tabs->t[i];
    tb.rows = meta[6 * i];
    tb.id_rows = meta[6 * i + 1];
    tb.col_first = meta[6 * i + 2];
    tb.col_step = meta[6 * i + 3];
    tb.ncols = meta[6 * i + 4];
    tb.use_pos = meta[6 * i + 5];
    if (tb.rows <= 0 || tb.rows > kMaxRows || tb.id_rows <= 0 ||
        tb.id_rows > tb.rows || (!tb.use_pos && tb.ncols <= 0))
      return false;
    tb.grad_off = goff;
    tb.order_off = ooff;
    tb.cta_first = (int)ctas;
    tb.slab_w = tb.rows <= kRows ? kNarrow : kSlab;
    tb.slabs = (d + tb.slab_w - 1) / tb.slab_w;
    goff += (long long)tb.rows * d;
    ooff += (long long)tb.slabs * N * (tb.use_pos ? 1 : tb.ncols);
    ctas += (long long)((tb.rows + kRows - 1) / kRows) * tb.slabs;
  }
  if (ctas > 0x7fffffffLL || ooff > 0x7fffffffLL) return false;
  tabs->ctas = (int)ctas;
  *grad_elems = goff;
  *order_ints = ooff;
  return true;
}

}  // namespace

// The f32 gradient elements (all tables, in order, each (rows, d)) and the
// int32 scratch elements a call takes, or -1 where the meta is refused.
extern "C" long long span_embed_bwd_sizes(long long N, int d, int n_tables,
                                          const int* meta,
                                          long long* order_ints) {
  Tables tabs;
  long long g = 0;
  if (!plan(N, d, n_tables, meta, &tabs, &g, order_ints)) return -1;
  return g;
}

// dy: (N, d) f32; cat: (N, C) int32; pos, seg: (N,) int32; meta: six ints
// a table (host). grads: the tables' gradients, one after another;
// order: span_embed_bwd_sizes' int32 scratch. One launch.
extern "C" int span_embed_bwd_launch(const void* dy, const void* cat,
                                     const void* pos, const void* seg,
                                     long long N, int C, int d, int n_tables,
                                     const int* meta, void* grads,
                                     void* order, void* stream) {
  Tables tabs;
  long long g = 0, o = 0;
  if (!plan(N, d, n_tables, meta, &tabs, &g, &o))
    return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(dy) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(grads) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* y = static_cast<const float*>(dy);
  const auto* c = static_cast<const int*>(cat);
  const auto* p = static_cast<const int*>(pos);
  const auto* s = static_cast<const int*>(seg);
  auto* gr = static_cast<float*>(grads);
  auto* ord = static_cast<int*>(order);
  return (int)(vec ? launch<true>(tabs, y, c, p, s, N, C, d, gr, ord, st)
                   : launch<false>(tabs, y, c, p, s, N, C, d, gr, ord, st));
}
