// K7: next-fit packing of trace-sorted spans into (R, L) rows, and K13: one
// trace per row — for Hopper (sm_90a). K13 is described after K7's
// launcher, at the end of this file.
//
// Replaces the layout and pack of the JAX package's fused route,
// odigos_tpu/serving/fused.py _sorted_trace_layout (:429-459; new-trace
// flags, the cummax of trace starts, positions in the trace) and
// _build_pack_packed._pack (:512-574; chunks of L, segment lengths, a
// searchsorted next-fit, pointer doubling over log2(N) rounds to mark the
// row starts, four scatters into (R, L, .)). Its host spec is pack_arrays
// (odigos_tpu/features/featurizer.py; the port's copy in
// odigos_tpu_torch/features/featurizer.py), whose rows this kernel
// reproduces exactly: every span's row, column, segment slot (1-based in
// its row) and position in its chunk, traces longer than L split into
// chunks of L, and next-fit with the host's bisect_right semantics.
//
// Input: perm, the first n of N rows sorted by (trace_id_hi, trace_id_lo,
// start) (K6), and the features of each row. Three launches, the walk and
// the scatter each by programmatic dependent launch (started while the
// kernel before it runs, waiting in griddepcontrol.wait for its results:
// the launch gaps overlap the work):
//   layout   one thread per sorted index j < n: the first index of j's
//            trace from the warp's new-trace ballot, or, before the warp's
//            first trace start, by the warp probing the 32 spans before it
//            (then every 32nd up to 1024, then a binary search), so the
//            position in the trace needs no scan; j starts a segment
//            (chunk) when that position is a multiple of L; a ballot per
//            warp writes the segment starts as a bitmask (one bit per span);
//   walk     one block, the bitmask in shared memory. A row that starts
//            at span p takes every whole segment ending at or before p + L,
//            so the next row starts at nxt(p), the highest segment start in
//            (p, p + L] (at most three words of the mask, found with
//            __clz), or the row is the last one (p + L >= n). The row
//            starts are the orbit of 0 under nxt. The walk cuts [0, n) into
//            chunks of W >= L spans (pack.walk_plan). The first row start at
//            or after a chunk's first span c W lies in [c W, c W + L) (its
//            predecessor is below c W and nxt moves at most L) and is a
//            segment start there: one of at most L candidates. (1) Eight
//            lanes per chunk, a lane per candidate, walk nxt from each
//            candidate to the first start past the chunk and record that
//            start's candidate index in the next chunk (or the end, or a
//            broken layout) and the rows started inside the chunk; (2) one
//            thread composes the chunks' tables from span 0, giving each
//            chunk its true entry and the rows before it; (3) a thread per
//            chunk walks again from its entry and writes the row starts.
//            With ~sqrt(n / 8) chunks the dependent steps are ~2 W / row +
//            chunks (~70 at n = 65536), not one per row (~1,100);
//   scatter  one thread per output slot (r, c) of the (R, L) rows: the
//            span at sorted index rs[r] + c if the row holds it, else
//            padding. Every output element is written once, zeros
//            included, so the outputs need no memset. The slot's segment
//            id is the number of segment starts in [rs[r], j] (popc over
//            at most three mask words); its column is j - rs[r]. The same
//            thread records the span's (row, column) for the head (K8).
// Padding rows past n, and real spans beyond R rows (not reachable when R
// is sized by the next-fit bound 2n/L + 2), get row R: dropped.
//
// Bound on the card: bytes. The outputs are R * L * 40 B (R = 2048, L =
// 64: 5.2 MB, 1.6 us at 3.35 TB/s), the inputs ~36 B per span. The walk's
// chains of dependent shared-memory reads and the layout's search for
// each trace's start (dependent L2 reads) are latency, not bandwidth: the
// layout takes ~2 rounds of loads a warp where a binary search takes ~17,
// and the walk keeps its chains short (~100 steps at n = 131072, in 32-bit
// arithmetic) by splitting them over chunks, where a walk row by row takes
// ~1,100 steps at n = 65536.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWalkThreads = 1024;
constexpr long long kWalkSmemWords = 12288;  // the mask in smem up to 48 KB
constexpr int kWalkSlots = 8192;             // (chunk, candidate) slots: 64 KB
constexpr int kWalkLanes = 8;                // the walk's lanes a chunk

// programmatic dependent launch: the walk and the scatter are launched
// while the kernel before them runs, and wait here for its results; a
// kernel lets its dependents launch early. Both are no-ops in a kernel
// launched without the attribute.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ bool key_less(unsigned long long ah,
                                         unsigned long long al,
                                         unsigned long long bh,
                                         unsigned long long bl) {
  return ah < bh || (ah == bh && al < bl);
}

// sorted span p's trace id is (h, l)
__device__ __forceinline__ bool same_trace(
    const int32_t* __restrict__ perm,
    const unsigned long long* __restrict__ thi,
    const unsigned long long* __restrict__ tlo, long long p,
    unsigned long long h, unsigned long long l) {
  const int r = perm[p];
  return thi[r] == h && tlo[r] == l;
}

// The first sorted index of the trace (h, l) that holds sorted index j0 >
// 0 and j0 - 1 (a warp's collective, every lane the same arguments): the
// 32 spans before j0 at once, then every 32nd span up to 1024 back and the
// 32 spans of the window that holds the start, and past that a binary
// search: ~2 rounds of dependent loads for traces of up to ~1,000 spans,
// not the ~17 of a binary search from 0.
__device__ __forceinline__ long long warp_trace_start(
    const int32_t* __restrict__ perm,
    const unsigned long long* __restrict__ thi,
    const unsigned long long* __restrict__ tlo, long long j0,
    unsigned long long h, unsigned long long l, int lane) {
  long long p = j0 - 1 - lane;
  unsigned b = __ballot_sync(0xffffffffu,
                             p < 0 || !same_trace(perm, thi, tlo, p, h, l));
  if (b) return j0 - (__ffs(b) - 1);
  p = j0 - 32 * (lane + 1);
  b = __ballot_sync(0xffffffffu,
                    p < 0 || !same_trace(perm, thi, tlo, p, h, l));
  if (b) {  // the start lies in (j0 - 32 (k + 1), j0 - 32 k], k >= 1
    const long long lo = j0 - 32 * __ffs(b) + 1;
    b = __ballot_sync(0xffffffffu,
                      lo + lane >= 0 &&
                          same_trace(perm, thi, tlo, lo + lane, h, l));
    return lo + __ffs(b) - 1;
  }
  long long lo = 0, hi = j0 - 32 * 32;  // hi is in the trace
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const int r = perm[mid];
    if (key_less(thi[r], tlo[r], h, l))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One thread per sorted index j < n, whole warps: the new-trace flags
// (j's trace id against j - 1's) by a ballot give each span its trace's
// first index within the warp; the spans before the warp's first trace
// start share one warp_trace_start. Then the position in the chunk, and
// the segment-start bitmask a warp a word.
__global__ void __launch_bounds__(kThreads) pack_layout_kernel(
    const int32_t* __restrict__ perm,
    const unsigned long long* __restrict__ thi,
    const unsigned long long* __restrict__ tlo, long long n, int L,
    unsigned* __restrict__ mask, int32_t* __restrict__ pic) {
  launch_dependents();
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long words = (n + 31) >> 5;
  if ((j >> 5) >= words) return;  // whole warps: words * 32 is warp-aligned
  const int lane = threadIdx.x & 31;
  const long long j0 = j - lane;
  unsigned long long h = 0, l = 0;
  if (j < n) {
    const int r = perm[j];
    h = thi[r];
    l = tlo[r];
  }
  unsigned long long ph = __shfl_up_sync(0xffffffffu, h, 1);
  unsigned long long pl = __shfl_up_sync(0xffffffffu, l, 1);
  if (lane == 0 && j > 0) {
    const int r = perm[j - 1];
    ph = thi[r];
    pl = tlo[r];
  }
  const bool fresh = j < n && (j == 0 || ph != h || pl != l);
  const unsigned nt = __ballot_sync(0xffffffffu, fresh);
  long long first = j0;
  if (!(nt & 1u))  // the warp starts inside a trace (j0 > 0)
    first = warp_trace_start(perm, thi, tlo, j0,
                             __shfl_sync(0xffffffffu, h, 0),
                             __shfl_sync(0xffffffffu, l, 0), lane);
  const unsigned below = nt & (lane == 31 ? ~0u : (2u << lane) - 1u);
  if (below) first = j0 + 31 - __clz(below);
  bool seg = false;
  if (j < n) {
    const int pc = (int)((j - first) % L);
    seg = pc == 0;
    pic[j] = pc;
  }
  const unsigned b = __ballot_sync(0xffffffffu, seg);
  if (lane == 0) mask[j >> 5] = b;
}

constexpr int kEnd = -1;     // the orbit ended inside the chunk
constexpr int kBroken = -2;  // no segment start within L spans

// segment starts in [a, b], a <= b
__device__ __forceinline__ int starts_between(const unsigned* mask, int a,
                                              int b) {
  int c = 0;
  for (int w = a >> 5; w <= (b >> 5); ++w) {
    unsigned m = mask[w];
    if (w == (a >> 5)) m &= ~0u << (a & 31);
    if (w == (b >> 5)) m &= (2u << (b & 31)) - 1u;
    c += __popc(m);
  }
  return c;
}

// nxt(p): the highest segment start in (p, p + L], -1 if none; p + L < n
__device__ __forceinline__ int next_start(const unsigned* mask, int p,
                                          int L) {
  const int lim = p + L, w_lo = (p + 1) >> 5;
  for (int w = lim >> 5; w >= w_lo; --w) {
    unsigned m = mask[w];
    if (w == (lim >> 5)) m &= (2u << (lim & 31)) - 1u;  // bits <= lim
    if (w == w_lo) m &= ~0u << ((p + 1) & 31);          // bits > p
    if (m) return (w << 5) + 31 - __clz(m);
  }
  return -1;
}

// the k-th (from 0) segment start in [lo, hi), -1 if there are fewer
__device__ __forceinline__ int kth_start(const unsigned* mask, int lo,
                                         int hi, int k) {
  for (int w = lo >> 5; (w << 5) < hi; ++w) {
    unsigned m = mask[w];
    if (w == (lo >> 5)) m &= ~0u << (lo & 31);
    if (w == ((hi - 1) >> 5)) m &= (2u << ((hi - 1) & 31)) - 1u;
    const int c = __popc(m);
    if (k < c) {
      for (; k > 0; --k) m &= m - 1u;
      return (w << 5) + __ffs(m) - 1;
    }
    k -= c;
  }
  return -1;
}

// Shared memory: the (chunks, L) table of (exit candidate, rows), each
// chunk's entry candidate and rows before it, then (kSmem) the mask. Step
// 1 gives each chunk kWalkLanes lanes (a chunk's window holds ~L / 10
// candidates on trace-shaped traffic), so 128 chunks walk at once.
template <bool kSmem>
__global__ void __launch_bounds__(kWalkThreads)
    pack_walk_kernel(const unsigned* __restrict__ gmask, int n, int L, int R,
                     int chunks, int W, int32_t* __restrict__ rs,
                     int32_t* __restrict__ rows_used) {
  extern __shared__ int2 s_tab[];
  int* s_entry = reinterpret_cast<int*>(s_tab + chunks * L);
  int* s_base = s_entry + chunks;
  const unsigned* mask = gmask;
  const int tid = threadIdx.x;
  wait_prior_grid();  // the layout's bitmask
  launch_dependents();
  if (kSmem) {
    unsigned* s_mask = reinterpret_cast<unsigned*>(s_base + chunks);
    const int words = (n + 31) >> 5;
    for (int i = tid; i < words; i += kWalkThreads) s_mask[i] = gmask[i];
    mask = s_mask;
  }
  __syncthreads();
  // (1) each chunk's candidates walked to the next chunk
  for (int c = tid / kWalkLanes; c < chunks;
       c += kWalkThreads / kWalkLanes) {
    const int lo = c * W, end = lo + W, hi = min(lo + L, n);
    const int cands = starts_between(mask, lo, hi - 1);
    for (int k = tid % kWalkLanes; k < cands; k += kWalkLanes) {
      int p = kth_start(mask, lo, hi, k), rows = 0, out;
      for (;;) {
        ++rows;
        if (p + L >= n) {
          out = kEnd;
          break;
        }
        const int b = next_start(mask, p, L);
        if (b < 0) {
          out = kBroken;
          break;
        }
        p = b;
        if (p >= end) {  // its index among the next chunk's candidates
          out = starts_between(mask, end, p) - 1;
          break;
        }
      }
      s_tab[c * L + k] = make_int2(out, rows);
    }
  }
  __syncthreads();
  // (2) the true entries, from span 0 (candidate 0 of chunk 0)
  if (tid == 0) {
    int k = 0, r = 0;
    for (int c = 0; c < chunks; ++c) {
      s_entry[c] = k;
      s_base[c] = r;
      if (k >= 0) {
        const int2 t = s_tab[c * L + k];
        r += t.y;
        k = t.x;
      }
    }
    *rows_used = k == kBroken ? -1 : r;
  }
  __syncthreads();
  // (3) each chunk's rows from its true entry
  for (int c = tid; c < chunks; c += kWalkThreads) {
    const int k = s_entry[c];
    if (k < 0) continue;
    const int lo = c * W, end = lo + W;
    int p = kth_start(mask, lo, min(lo + L, n), k), r = s_base[c];
    for (;;) {
      if (r <= R) rs[r] = p;
      ++r;
      if (p + L >= n) break;
      const int b = next_start(mask, p, L);
      if (b < 0 || b >= end) break;
      p = b;
    }
  }
}

__global__ void __launch_bounds__(kThreads) pack_scatter_kernel(
    const int32_t* __restrict__ perm, const int32_t* __restrict__ cat,
    const float* __restrict__ cont, int C, int D,
    const unsigned* __restrict__ mask, const int32_t* __restrict__ pic,
    const int32_t* __restrict__ rs, const int32_t* __restrict__ rows_used,
    long long n, long long N, int L, int R, int32_t* __restrict__ catp,
    float* __restrict__ contp, int32_t* __restrict__ segs,
    int32_t* __restrict__ poss, int32_t* __restrict__ row_eff,
    int32_t* __restrict__ span_col) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  wait_prior_grid();  // the walk's row starts
  int ru = *rows_used;
  if (ru < 0) ru = 0;
  const int rows = ru < R ? ru : R;
  if (t < (long long)R * L) {
    const int r = (int)(t / L), c = (int)(t % L);
    long long j = -1, p0 = 0;
    if (r < rows) {
      p0 = rs[r];
      const long long p1 = r + 1 < ru ? rs[r + 1] : n;
      if (p0 + c < p1) j = p0 + c;
    }
    int32_t* cp = catp + t * C;
    float* xp = contp + t * D;
    if (j >= 0) {
      const long long idx = perm[j];
      for (int k = 0; k < C; ++k) cp[k] = cat[idx * C + k];
      for (int k = 0; k < D; ++k) xp[k] = cont[idx * D + k];
      segs[t] = starts_between(mask, p0, j);
      poss[t] = pic[j];
      row_eff[j] = r;
      span_col[j] = c;
    } else {
      for (int k = 0; k < C; ++k) cp[k] = 0;
      for (int k = 0; k < D; ++k) xp[k] = 0.f;
      segs[t] = 0;
      poss[t] = 0;
    }
  }
  if (t < N && (t >= n || (ru > R && t >= rs[R]))) {
    row_eff[t] = R;
    span_col[t] = 0;
  }
}

// ---- K13: one trace per row

constexpr int kRowsWarps = kThreads / 32;  // mask words a layout block

// One thread per sorted index j, whole blocks: the new-trace flag (j's
// trace id against j - 1's; the warp shares its ids by shuffles) by a
// ballot into the trace-start bitmask, a word a warp, and the block's
// count of trace starts. No search and no scan: a trace's ordinal is its
// block's prefix of counts plus its rank in the block, which the scatter
// takes.
__global__ void __launch_bounds__(kThreads) rows_layout_kernel(
    const int32_t* __restrict__ perm,
    const unsigned long long* __restrict__ thi,
    const unsigned long long* __restrict__ tlo, long long n,
    unsigned* __restrict__ mask, int32_t* __restrict__ block_count) {
  __shared__ int s_cnt[kRowsWarps];
  launch_dependents();
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  unsigned long long h = 0, l = 0;
  if (j < n) {
    const int r = perm[j];
    h = thi[r];
    l = tlo[r];
  }
  unsigned long long ph = __shfl_up_sync(0xffffffffu, h, 1);
  unsigned long long pl = __shfl_up_sync(0xffffffffu, l, 1);
  if (lane == 0 && j > 0 && j < n) {
    const int r = perm[j - 1];
    ph = thi[r];
    pl = tlo[r];
  }
  const bool fresh = j < n && (j == 0 || ph != h || pl != l);
  const unsigned b = __ballot_sync(0xffffffffu, fresh);
  if (lane == 0) {
    mask[j >> 5] = b;
    s_cnt[wid] = __popc(b);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kRowsWarps; ++w) c += s_cnt[w];
    block_count[blockIdx.x] = c;
  }
}

// Fills [e0, e1) of a flat array of T, 16-byte aligned at element 0,
// with `value`: scalar stores up to the first 16-byte boundary and past
// the last, 16-byte vector stores between; the worker t of `workers`
// takes every workers-th store.
template <typename T>
__device__ __forceinline__ void fill_range(T* __restrict__ base, long long e0,
                                           long long e1, long long t,
                                           long long workers, T value) {
  constexpr int V = 16 / (int)sizeof(T);
  if (e0 >= e1) return;
  const long long a0 = min(e1, (e0 + V - 1) / V * V);
  const long long a1 = max(a0, e1 / V * V);
  for (long long e = e0 + t; e < a0; e += workers) base[e] = value;
  union {
    uint4 u;
    T v[V];
  } vec;
#pragma unroll
  for (int k = 0; k < V; ++k) vec.v[k] = value;
  uint4* vb = reinterpret_cast<uint4*>(base);
  for (long long q = a0 / V + t; q < a1 / V; q += workers) vb[q] = vec.u;
  for (long long e = a1 + t; e < e1; e += workers) base[e] = value;
}

// A span's k features, src to dst: kFeatChunk loads in flight before
// their stores (in-order issue would otherwise wait out each load).
constexpr int kFeatChunk = 8;

template <typename T>
__device__ __forceinline__ void copy_features(T* __restrict__ dst,
                                              const T* __restrict__ src,
                                              int k) {
  for (int k0 = 0; k0 < k; k0 += kFeatChunk) {
    T v[kFeatChunk];
#pragma unroll
    for (int e = 0; e < kFeatChunk; ++e)
      if (k0 + e < k) v[e] = __ldg(src + k0 + e);
#pragma unroll
    for (int e = 0; e < kFeatChunk; ++e)
      if (k0 + e < k) dst[k0 + e] = v[e];
  }
}

// The rows, by programmatic dependent launch behind the layout. Every
// block first sums the layout's block counts: before its own (the prefix)
// and all (the trace count). A block b below the layout's grid then takes
// the sorted spans of the layout's block b, a thread a span: its trace's
// ordinal (the row) and its column from the mask, its slot gathered
// through perm and stored; each trace start also finds its trace's length
// and its warp fills the rest of that row with zeros, 16-byte stores. Then
// every block takes its share of the rows past the trace count, a pure
// zero fill (-1 in span_map) with 16-byte stores and no reads. Traces at
// ordinal >= R and spans at column >= L are dropped; every output element
// is written once.
__global__ void __launch_bounds__(kThreads) rows_scatter_kernel(
    const int32_t* __restrict__ perm, const int32_t* __restrict__ cat,
    const float* __restrict__ cont, int C, int D,
    const unsigned* __restrict__ mask,
    const int32_t* __restrict__ block_count, int nb, long long n, int L,
    int R, int32_t* __restrict__ rows_used, int32_t* __restrict__ catp,
    float* __restrict__ contp, uint8_t* __restrict__ maskp,
    int32_t* __restrict__ span_map) {
  __shared__ long long s_sum[2][kRowsWarps];
  __shared__ int s_word[kRowsWarps];
  wait_prior_grid();  // the layout's mask and counts
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  long long pre = 0, tot = 0;
  for (int k = tid; k < nb; k += kThreads) {
    const int c = block_count[k];
    tot += c;
    if (k < (int)blockIdx.x) pre += c;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    pre += __shfl_xor_sync(0xffffffffu, pre, o);
    tot += __shfl_xor_sync(0xffffffffu, tot, o);
  }
  if (lane == 0) {
    s_sum[0][wid] = pre;
    s_sum[1][wid] = tot;
  }
  const long long words = (n + 31) >> 5;
  const long long wd = (long long)blockIdx.x * kRowsWarps + wid;
  const unsigned mw = (int)blockIdx.x < nb && wd < words ? mask[wd] : 0u;
  if (lane == 0) s_word[wid] = __popc(mw);
  __syncthreads();
  pre = tot = 0;
#pragma unroll
  for (int w = 0; w < kRowsWarps; ++w) {
    pre += s_sum[0][w];
    tot += s_sum[1][w];
  }
  const long long rows = tot < R ? tot : R;
  if (blockIdx.x == 0 && tid == 0) *rows_used = (int32_t)tot;
  const long long LC = (long long)L * C, LD = (long long)L * D;
  // the real slots, a thread a sorted span j of layout block b: its
  // trace's ordinal is the starts at or before j, less one (the block's
  // prefix, its earlier words, its own word's bits up to j); its column
  // is j less the last start at or before j (looked for back at most L
  // spans: a slot at column >= L is dropped)
  const long long j = (long long)blockIdx.x * kThreads + tid;
  const bool in_block = (int)blockIdx.x < nb && j < n;
  const unsigned upto = lane == 31 ? ~0u : (2u << lane) - 1u;
  long long r = pre + __popc(mw & upto) - 1, c = L;
  for (int w = 0; w < wid; ++w) r += s_word[w];
  if (in_block) {
    if (mw & upto) {
      c = lane - (31 - __clz(mw & upto));
    } else {
      for (long long w = wd - 1; w >= 0 && (j - (w << 5) - 31) < L; --w) {
        const unsigned x = mask[w];
        if (x) {
          c = j - ((w << 5) + 31 - __clz(x));
          break;
        }
      }
    }
  }
  const bool slot = in_block && r < R && c < L;
  if (slot) {
    const long long idx = __ldg(perm + j), e = r * L + c;
    copy_features(catp + e * C, cat + idx * C, C);
    copy_features(contp + e * D, cont + idx * D, D);
    maskp[e] = 1;
    span_map[e] = (int32_t)idx;
  }
  // each trace start's row past its spans: the start finds its length
  // (the next start within L spans), then its warp fills the rest of the
  // row with zeros (-1 in span_map), 16-byte stores, a row at a time
  int len = 0;
  if (slot && c == 0) {
    const long long lim = j + L < n ? j + L : n;
    long long next = lim;
    const unsigned after = mw & ~upto;
    if (after) {
      next = min(lim, (wd << 5) + __ffs(after) - 1);
    } else {
      for (long long w = wd + 1; (w << 5) < lim; ++w) {
        const unsigned x = mask[w];
        if (x) {
          next = min(lim, (w << 5) + __ffs(x) - 1);
          break;
        }
      }
    }
    len = (int)(next - j);
  }
  for (unsigned st = __ballot_sync(0xffffffffu, len > 0); st;
       st &= st - 1u) {
    const int from = __ffs(st) - 1;
    const long long rr = __shfl_sync(0xffffffffu, r, from);
    const int ln = __shfl_sync(0xffffffffu, len, from);
    fill_range(catp, rr * LC + (long long)ln * C, (rr + 1) * LC, lane, 32,
               0);
    fill_range(contp, rr * LD + (long long)ln * D, (rr + 1) * LD, lane, 32,
               0.f);
    fill_range(maskp, rr * L + ln, (rr + 1) * L, lane, 32, (uint8_t)0);
    fill_range(span_map, rr * L + ln, (rr + 1) * L, lane, 32, -1);
  }
  // the rows past the trace count: zeros (span_map -1), no reads; thread
  // j of the grid's takes every grid-th store
  const long long all = (long long)gridDim.x * kThreads;
  fill_range(catp, rows * LC, (long long)R * LC, j, all, 0);
  fill_range(contp, rows * LD, (long long)R * LD, j, all, 0.f);
  fill_range(maskp, rows * L, (long long)R * L, j, all, (uint8_t)0);
  fill_range(span_map, rows * L, (long long)R * L, j, all, -1);
}

// the walk's dynamic shared memory, allowed past 48 KB
template <bool kSmem>
cudaError_t walk_smem(int bytes) {
  return cudaFuncSetAttribute(pack_walk_kernel<kSmem>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// K7. perm (N,) int32 (K6's trace order, identity past n); thi, tlo (N,)
// u64; cat (N, C) int32, cont (N, D) f32 by original row; the walk's plan
// (pack.walk_plan): chunks of W spans covering [0, n), none empty, W >= L
// when chunks > 1, chunks * L <= 8192. Scratch: mask ceil(N / 32) u32,
// pic (N,) int32, rs (R + 1,) int32. Out: rows_used (1,) int32 (the rows
// next-fit filled, -1 on a broken layout); catp (R, L, C), contp (R, L, D),
// segs, poss (R, L); row_eff, span_col (N,) by sorted index. *launches
// gets the number of kernels launched.
extern "C" int next_fit_pack_launch(
    const void* perm, const void* thi, const void* tlo, const void* cat,
    const void* cont, int C, int D, long long n, long long N, int L, int R,
    int chunks, int W, void* mask, void* pic, void* rs,
    void* rows_used, void* catp, void* contp, void* segs, void* poss,
    void* row_eff, void* span_col, int* launches, void* stream) {
  *launches = 0;
  if (n < 0 || N < n || L < 1 || R < 0 || C < 0 || D < 0 ||
      N + L > 0x7fffffffLL || chunks < 0 || W < 1 ||
      (long long)chunks * W < n || (long long)(chunks - 1) * W >= n ||
      (chunks > 1 && W < L) || (long long)chunks * L > kWalkSlots)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  unsigned* m = static_cast<unsigned*>(mask);
  const long long words = (n + 31) >> 5;
  if (n > 0) {
    const long long blocks = (words * 32 + kThreads - 1) / kThreads;
    pack_layout_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const int32_t*>(perm),
        static_cast<const unsigned long long*>(thi),
        static_cast<const unsigned long long*>(tlo), n, L, m,
        static_cast<int32_t*>(pic));
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const bool smem_mask = words <= kWalkSmemWords;
  const int smem = (int)((long long)chunks * L * 8 + chunks * 8 +
                         (smem_mask ? words * 4 : 0));
  if (smem_mask)
    err = walk_smem<true>(smem);
  else
    err = walk_smem<false>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kWalkThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const unsigned* cm = m;
  int32_t* crs = static_cast<int32_t*>(rs);
  int32_t* cru = static_cast<int32_t*>(rows_used);
  err = smem_mask ? cudaLaunchKernelEx(&cfg, pack_walk_kernel<true>, cm,
                                       (int)n, L, R, chunks, W, crs, cru)
                  : cudaLaunchKernelEx(&cfg, pack_walk_kernel<false>, cm,
                                       (int)n, L, R, chunks, W, crs, cru);
  ++*launches;
  if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess)
    return (int)err;
  const long long slots = (long long)R * L;
  const long long work = slots > N ? slots : N;
  if (work > 0) {
    const long long blocks = (work + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    err = cudaLaunchKernelEx(
        &cfg, pack_scatter_kernel, static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(cat), static_cast<const float*>(cont), C,
        D, cm, static_cast<const int32_t*>(pic),
        static_cast<const int32_t*>(rs),
        static_cast<const int32_t*>(rows_used), n, N, L, R,
        static_cast<int32_t*>(catp), static_cast<float*>(contp),
        static_cast<int32_t*>(segs), static_cast<int32_t*>(poss),
        static_cast<int32_t*>(row_eff), static_cast<int32_t*>(span_col));
    ++*launches;
    if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess)
      return (int)err;
  }
  return (int)cudaSuccess;
}

// K13: one trace per row, for the autoencoder's fused route. Replaces
// odigos_tpu/serving/fused.py _build_pack_spans (:462-488; after the
// shared _sorted_trace_layout, :429-459): row = the trace's ordinal in
// K6's (trace_id_hi, trace_id_lo, start) order, column = the span's
// position in its trace, spans at column >= L dropped (the host's
// assemble_sequences truncation), traces at row >= R dropped. Two
// launches, the second by programmatic dependent launch:
//   layout   a thread a sorted span: the trace-start bitmask by ballots
//            and each block's count of trace starts;
//   scatter  each block sums the counts (its prefix, and the trace count,
//            written to rows_used by block 0), writes the slots of its
//            layout block's spans (a thread a span: row and column from
//            the mask, the features gathered through perm), the rest of
//            each of their rows as zeros (a warp a row, 16-byte stores),
//            then its share of the zero rows past the trace count.
// Outputs: catp (R, L, C) int32, contp (R, L, D) f32, maskp (R, L) bytes
// and span_map (R, L) int32 (the span's original row, -1 at padding: K11
// writes each real position's score there), every element written once,
// each output 16-byte aligned. Scratch: mask (8 * blocks) u32 and
// block_count (blocks) int32, blocks = ceil(n / 256).
// Bound on the card: bytes, R * L * (4 C + 4 D + 5) out (R = 43008, L =
// 64: 102 MB, 30.6 us at 3.35 TB/s) plus ~28 B a span in; past the trace
// count (90% of the rows at the engine's R) the scatter is a store stream.
extern "C" int trace_rows_pack_launch(
    const void* perm, const void* thi, const void* tlo, const void* cat,
    const void* cont, int C, int D, long long n, long long N, int L, int R,
    void* mask, void* block_count, void* rows_used, void* catp, void* contp,
    void* maskp, void* span_map, int* launches, void* stream) {
  *launches = 0;
  if (n < 0 || N < n || L < 1 || R < 0 || C < 0 || D < 0 ||
      N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const long long nb = (n + kThreads - 1) / kThreads;
  if (nb > 0) {
    rows_layout_kernel<<<(unsigned)nb, kThreads, 0, st>>>(
        static_cast<const int32_t*>(perm),
        static_cast<const unsigned long long*>(thi),
        static_cast<const unsigned long long*>(tlo), n,
        static_cast<unsigned*>(mask), static_cast<int32_t*>(block_count));
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // enough blocks for the zero fill to stream: ~4 vectors a thread, at
  // most 8 blocks an SM; at least the layout's blocks (their rows)
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return (int)err;
  }
  const long long vecs = (long long)R * L * (4LL * C + 4LL * D + 5) / 16;
  long long grid = (vecs + 4LL * kThreads - 1) / (4LL * kThreads);
  if (grid > 8LL * sms) grid = 8LL * sms;
  if (grid < nb) grid = nb;
  if (grid < 1) grid = 1;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, rows_scatter_kernel, static_cast<const int32_t*>(perm),
      static_cast<const int32_t*>(cat), static_cast<const float*>(cont), C, D,
      static_cast<const unsigned*>(mask),
      static_cast<const int32_t*>(block_count), (int)nb, n, L, R,
      static_cast<int32_t*>(rows_used), static_cast<int32_t*>(catp),
      static_cast<float*>(contp), static_cast<uint8_t*>(maskp),
      static_cast<int32_t*>(span_map));
  ++*launches;
  if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess)
    return (int)err;
  return (int)cudaSuccess;
}
