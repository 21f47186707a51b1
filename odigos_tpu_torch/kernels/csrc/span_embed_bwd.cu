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
// (the ids clamped into it, as K2 clamps them); so each table's gradient
// row t is the sum of the upstream gradient dy[n] over the live slots that
// gathered row t:
//   service  columns 0 and 4 (the parent service shares the table),
//   name     column 1,  kind  column 2 (8 rows),  status  column 3 (4 rows),
//   attr     columns 5 .. C - 1, where the model has attribute slots,
//   pos      the positions.
// (The continuous projection's gradient is two small matrix products in
// kernels/autograd.py.) The small tables take 2048 slots into 4 to 32 rows
// at the trainer's shapes: scattering with atomics would pile hundreds of
// adds on each address and sum in a different order every run. So this is
// a sort-and-segment route, with no atomics on the sums:
// * csr_kernel, a CTA a table (1024 threads): each entry (column j, slot
//   n) of the table's live slots gets its row id; a shared-memory histogram
//   of the ids, an exclusive scan into the table's row starts, then a
//   stable counting-sort fill by one warp (__match_any_sync ranks the lanes
//   that share an id, in entry order), so each row's entry list is in entry
//   order: column by column, slots ascending;
// * sum_kernel, a CTA a table row (8 warps): the row's entries split into
//   eight contiguous runs, each warp adding its run's dy rows in f64 (lane k
//   holding the columns k, k + 32, ...), the warps' sums combined in a fixed
//   order in shared memory, rounded once to f32. A row no slot gathered
//   gets 0.
// The integer histogram's atomics leave no trace in the result, and each
// sum runs in one fixed order, so a step is reproducible. The f64 sum of
// f32 terms is exact while their binade spread plus log2(count) plus 24
// stays within 53 bits, so the plain version (index_add_ in f64, rounded
// once) gives the same bits there whatever the order.
//
// Bound on the card: bytes. At the trainer's 2048 slots of d 256 the
// function needs the segments, each live slot's dy row and ids once (611
// live slots in a step: 0.6 MB) and writes the tables' gradients (512 +
// 2048 + 8 + 4 + 32 rows of 1 KB, 2.7 MB): 3.3 MB, 1.0 us at 3.35 TB/s.
// This pass reads a live slot's dy row once a table it feeds (six times);
// one f64 add a value read. The measured times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTables = 6;
constexpr int kCsrThreads = 1024;
constexpr int kSumThreads = 256;
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kMaxD = 1024;
constexpr int kMaxRows = 49152;  // a table's histogram in shared memory

struct Table {
  float* grad;      // (rows, d)
  int* row_start;   // (rows + 1,) scratch
  int* order;       // (entries,) scratch: slots, by row, in entry order
  int rows;         // the gradient's rows (the table's)
  int clamp_rows;   // ids clamp into [0, clamp_rows) (K2's clamp)
  int col_first;    // the table's categorical columns: col_first +
  int col_step;     //   j * col_step for j < ncols
  int ncols;
  int use_pos;      // 1: the ids are the positions (one column)
};

struct Tables {
  Table t[kMaxTables];
  int n;
  int row_prefix[kMaxTables + 1];  // CTAs of sum_kernel before table i
};

__device__ __forceinline__ long long entries(const Table& tb, long long N) {
  return N * (tb.use_pos ? 1 : tb.ncols);
}

// The row id of entry e (column e / N, slot e % N), or -1 at a padding slot
__device__ __forceinline__ int entry_id(const Table& tb, long long e,
                                        long long N, const int* cat, int C,
                                        const int* pos, const int* seg,
                                        int* slot) {
  const long long j = e / N;
  const long long n = e - j * N;
  *slot = (int)n;
  if (seg[n] <= 0) return -1;
  int id = tb.use_pos ? pos[n]
                      : cat[n * C + tb.col_first + j * tb.col_step];
  id = id < 0 ? 0 : id;
  return id < tb.clamp_rows ? id : tb.clamp_rows - 1;
}

// exclusive scan of a[0 .. n) in shared memory, in place, by the whole CTA
__device__ void block_exclusive_scan(int* a, int n) {
  __shared__ int wsum[kCsrThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (n + kCsrThreads - 1) / kCsrThreads;
  const int lo = min(n, tid * chunk), hi = min(n, lo + chunk);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += a[i];
  int inc = own;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = wsum[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int run = inc - own + (warp > 0 ? wsum[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kCsrThreads)
csr_kernel(Tables tabs, const int* __restrict__ cat,
           const int* __restrict__ pos, const int* __restrict__ seg,
           long long N, int C) {
  extern __shared__ int cnt[];  // rows + 1
  const Table& tb = tabs.t[blockIdx.x];
  const int rows = tb.rows;
  const long long E = entries(tb, N);
  const int tid = threadIdx.x;
  for (int i = tid; i <= rows; i += kCsrThreads) cnt[i] = 0;
  __syncthreads();
  for (long long e = tid; e < E; e += kCsrThreads) {
    int slot;
    const int id = entry_id(tb, e, N, cat, C, pos, seg, &slot);
    if (id >= 0) atomicAdd(&cnt[id], 1);
  }
  __syncthreads();
  block_exclusive_scan(cnt, rows + 1);
  for (int i = tid; i <= rows; i += kCsrThreads) tb.row_start[i] = cnt[i];
  __syncthreads();
  if (tid < 32) {  // the stable fill: one warp, entries in order
    const int lane = tid;
    for (long long base = 0; base < E; base += 32) {
      const long long e = base + lane;
      int slot = 0;
      const int id = e < E ? entry_id(tb, e, N, cat, C, pos, seg, &slot) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, id);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      if (id >= 0) tb.order[cnt[id] + rank] = slot;
      __syncwarp();
      if (id >= 0 && rank == 0) cnt[id] += __popc(peers);
      __syncwarp();
    }
  }
}

// d <= 32 * PER
template <int PER>
__global__ void __launch_bounds__(kSumThreads)
sum_kernel(Tables tabs, const float* __restrict__ dy, int d) {
  __shared__ double buf[kMaxD];
  int t = 0;
  while ((int)blockIdx.x >= tabs.row_prefix[t + 1]) ++t;
  const Table& tb = tabs.t[t];
  const int row = blockIdx.x - tabs.row_prefix[t];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long start = tb.row_start[row];
  const long long cnt = tb.row_start[row + 1] - start;
  const long long lo = start + cnt * warp / kSumWarps;
  const long long hi = start + cnt * (warp + 1) / kSumWarps;
  double acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.0;
#pragma unroll 4
  for (long long e = lo; e < hi; ++e) {
    const float* src = dy + (long long)tb.order[e] * d;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + 32 * j;
      if (c < d) acc[j] += (double)__ldg(src + c);
    }
  }
  for (int w = 0; w < kSumWarps; ++w) {  // fixed order: warp 0 first
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int c = lane + 32 * j;
        if (c < d) buf[c] = (w == 0 ? 0.0 : buf[c]) + acc[j];
      }
    }
    __syncthreads();
  }
  float* out = tb.grad + (long long)row * d;
  for (int c = threadIdx.x; c < d; c += kSumThreads) out[c] = (float)buf[c];
}

template <int PER>
cudaError_t launch_sum(const Tables& tabs, const float* dy, int d,
                       cudaStream_t st) {
  sum_kernel<PER><<<tabs.row_prefix[tabs.n], kSumThreads, 0, st>>>(tabs, dy,
                                                                   d);
  return cudaGetLastError();
}

}  // namespace

// dy: (N, d) f32; cat: (N, C) int32; pos, seg: (N,) int32. Per table i <
// n_tables (host arrays): grads[i] -> (rows, d) f32, row_start[i] -> (rows +
// 1,) int32 scratch, order[i] -> (entries,) int32 scratch, and six ints in
// meta[6 i ..]: rows, clamp_rows, col_first, col_step, ncols, use_pos.
extern "C" int span_embed_bwd_launch(const void* dy, const void* cat,
                                     const void* pos, const void* seg,
                                     long long N, int C, int d, int n_tables,
                                     const long long* grads,
                                     const long long* row_start,
                                     const long long* order, const int* meta,
                                     void* stream) {
  if (N <= 0 || N > 0x7fffffffLL || d <= 0 || d > kMaxD || n_tables <= 0 ||
      n_tables > kMaxTables)
    return (int)cudaErrorInvalidValue;
  Tables tabs = {};
  tabs.n = n_tables;
  int max_rows = 0;
  for (int i = 0; i < n_tables; ++i) {
    Table& tb = tabs.t[i];
    tb.grad = reinterpret_cast<float*>(grads[i]);
    tb.row_start = reinterpret_cast<int*>(row_start[i]);
    tb.order = reinterpret_cast<int*>(order[i]);
    tb.rows = meta[6 * i];
    tb.clamp_rows = meta[6 * i + 1];
    tb.col_first = meta[6 * i + 2];
    tb.col_step = meta[6 * i + 3];
    tb.ncols = meta[6 * i + 4];
    tb.use_pos = meta[6 * i + 5];
    if (tb.rows <= 0 || tb.rows > kMaxRows || tb.clamp_rows <= 0 ||
        tb.clamp_rows > tb.rows || (!tb.use_pos && tb.ncols <= 0))
      return (int)cudaErrorInvalidValue;
    max_rows = tb.rows > max_rows ? tb.rows : max_rows;
    tabs.row_prefix[i + 1] = tabs.row_prefix[i] + tb.rows;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = (max_rows + 1) * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      csr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  csr_kernel<<<n_tables, kCsrThreads, smem, st>>>(
      tabs, static_cast<const int*>(cat), static_cast<const int*>(pos),
      static_cast<const int*>(seg), N, C);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const auto* g = static_cast<const float*>(dy);
  if (d <= 32) return (int)launch_sum<1>(tabs, g, d, st);
  if (d <= 64) return (int)launch_sum<2>(tabs, g, d, st);
  if (d <= 128) return (int)launch_sum<4>(tabs, g, d, st);
  if (d <= 256) return (int)launch_sum<8>(tabs, g, d, st);
  if (d <= 512) return (int)launch_sum<16>(tabs, g, d, st);
  return (int)launch_sum<32>(tabs, g, d, st);
}
