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
// start) (K6), and the features of each row. Three launches:
//   layout   one thread per sorted index j < n: the first index of j's
//            trace by binary search over the sorted trace ids, so the
//            position in the trace needs no scan; j starts a segment
//            (chunk) when that position is a multiple of L; a ballot per
//            warp writes the segment starts as a bitmask (one bit per span);
//   walk     one block: the bitmask into shared memory (16 KB at 131072
//            spans), then one thread walks the rows. A row that starts at
//            span p takes every whole segment ending at or before p + L, so
//            the next row starts at the highest segment start in
//            (p, p + L] — at most three words of the mask, found with
//            __clz — or the row is the last one (p + L >= n). The walk
//            costs R_real steps (~n / 50 for trace-shaped traffic), not a
//            step per segment, and writes the row starts and R_real;
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
// 64: 5.2 MB, 1.6 us at 3.35 TB/s), the inputs ~36 B per span. The walk is
// a chain of dependent shared-memory reads on one thread (~20-40 cycles a
// row), and the layout's binary search ~17 dependent L2 reads per span:
// latency, not bandwidth, sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWalkThreads = 1024;
constexpr long long kWalkSmemWords = 12288;  // 48 KB, no attribute needed

__device__ __forceinline__ bool key_less(unsigned long long ah,
                                         unsigned long long al,
                                         unsigned long long bh,
                                         unsigned long long bl) {
  return ah < bh || (ah == bh && al < bl);
}

__global__ void __launch_bounds__(kThreads) pack_layout_kernel(
    const int32_t* __restrict__ perm,
    const unsigned long long* __restrict__ thi,
    const unsigned long long* __restrict__ tlo, long long n, int L,
    unsigned* __restrict__ mask, int32_t* __restrict__ pic) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long words = (n + 31) >> 5;
  if ((j >> 5) >= words) return;  // whole warps: words * 32 is warp-aligned
  bool seg = false;
  if (j < n) {
    const int idx = perm[j];
    const unsigned long long h = thi[idx], l = tlo[idx];
    long long lo = 0, hi = j;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      const int r = perm[mid];
      if (key_less(thi[r], tlo[r], h, l))
        lo = mid + 1;
      else
        hi = mid;
    }
    const int pc = (int)((j - lo) % L);
    seg = pc == 0;
    pic[j] = pc;
  }
  const unsigned b = __ballot_sync(0xffffffffu, seg);
  if ((threadIdx.x & 31) == 0) mask[j >> 5] = b;
}

template <bool kSmem>
__global__ void __launch_bounds__(kWalkThreads)
    pack_walk_kernel(const unsigned* __restrict__ gmask, long long n, int L,
                     int R, int32_t* __restrict__ rs,
                     int32_t* __restrict__ rows_used) {
  extern __shared__ unsigned s_mask[];
  const unsigned* mask = gmask;
  if (kSmem) {
    const long long words = (n + 31) >> 5;
    for (long long i = threadIdx.x; i < words; i += kWalkThreads)
      s_mask[i] = gmask[i];
    __syncthreads();
    mask = s_mask;
  }
  if (threadIdx.x != 0) return;
  int r = 0;
  long long p = 0;
  while (p < n) {
    if (r <= R) rs[r] = (int32_t)p;
    ++r;
    const long long lim = p + L;
    if (lim >= n) break;
    long long b = -1;
    const long long w_lo = (p + 1) >> 5, w_hi = lim >> 5;
    for (long long w = w_hi; w >= w_lo; --w) {
      unsigned m = mask[w];
      if (w == w_hi) m &= (2u << (lim & 31)) - 1u;  // bits <= lim
      if (w == w_lo) m &= ~0u << ((p + 1) & 31);    // bits > p
      if (m) {
        b = (w << 5) + 31 - __clz(m);
        break;
      }
    }
    if (b < 0) {  // no segment start within L spans: a broken layout
      r = -1;
      break;
    }
    p = b;
  }
  *rows_used = r;
}

// segment starts in [a, b], a <= b < a + L
__device__ __forceinline__ int starts_between(const unsigned* mask,
                                              long long a, long long b) {
  int c = 0;
  for (long long w = a >> 5; w <= (b >> 5); ++w) {
    unsigned m = mask[w];
    if (w == (a >> 5)) m &= ~0u << (a & 31);
    if (w == (b >> 5)) m &= (2u << (b & 31)) - 1u;
    c += __popc(m);
  }
  return c;
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

// One block: the trace ordinal of every trace start (a set bit of the
// new-trace bitmask), by a block scan of each thread's popcounts over its
// run of mask words; writes ts[o] = the sorted index where trace o starts,
// for o <= R, the sentinel ts[total] = n when total <= R, and the number
// of traces.
__global__ void __launch_bounds__(kWalkThreads) rows_scan_kernel(
    const unsigned* __restrict__ mask, long long n, int R,
    int32_t* __restrict__ ts, int32_t* __restrict__ rows_used) {
  __shared__ int s_warp[kWalkThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long words = (n + 31) >> 5;
  const long long per = (words + kWalkThreads - 1) / kWalkThreads;
  const long long w0 = tid * per;
  const long long w1 = w0 + per < words ? w0 + per : words;
  int c = 0;
  for (long long w = w0; w < w1; ++w) c += __popc(mask[w]);
  int x = c;  // inclusive scan within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int v = s_warp[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    s_warp[lane] = v;
  }
  __syncthreads();
  int o = x - c + (wid > 0 ? s_warp[wid - 1] : 0);
  for (long long w = w0; w < w1; ++w) {
    unsigned m = mask[w];
    while (m) {
      const int b = __ffs(m) - 1;
      m &= m - 1u;
      if (o <= R) ts[o] = (int32_t)((w << 5) + b);
      ++o;
    }
  }
  if (tid == 0) {
    const int total = s_warp[kWalkThreads / 32 - 1];
    *rows_used = total;
    if (total <= R) ts[total] = (int32_t)n;
  }
}

// One thread per output slot (r, c): the span at sorted index ts[r] + c if
// trace r holds it (c < its length; spans at c >= L are dropped), else
// padding. Every output element is written once, zeros included.
__global__ void __launch_bounds__(kThreads) rows_scatter_kernel(
    const int32_t* __restrict__ perm, const int32_t* __restrict__ cat,
    const float* __restrict__ cont, int C, int D,
    const int32_t* __restrict__ ts, const int32_t* __restrict__ rows_used,
    int L, int R, int32_t* __restrict__ catp, float* __restrict__ contp,
    uint8_t* __restrict__ maskp, int32_t* __restrict__ span_map) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)R * L) return;
  const int ru = *rows_used;
  const int rows = ru < R ? ru : R;
  const int r = (int)(t / L), c = (int)(t % L);
  long long j = -1;
  if (r < rows) {
    const long long p0 = ts[r];
    if (p0 + c < ts[r + 1]) j = p0 + c;
  }
  int32_t* cp = catp + t * C;
  float* xp = contp + t * D;
  if (j >= 0) {
    const long long idx = perm[j];
    for (int k = 0; k < C; ++k) cp[k] = cat[idx * C + k];
    for (int k = 0; k < D; ++k) xp[k] = cont[idx * D + k];
    maskp[t] = 1;
    span_map[t] = (int32_t)idx;
  } else {
    for (int k = 0; k < C; ++k) cp[k] = 0;
    for (int k = 0; k < D; ++k) xp[k] = 0.f;
    maskp[t] = 0;
    span_map[t] = -1;
  }
}

}  // namespace

// K7. perm (N,) int32 (K6's trace order, identity past n); thi, tlo (N,)
// u64; cat (N, C) int32, cont (N, D) f32 by original row. Scratch: mask
// ceil(N / 32) u32, pic (N,) int32, rs (R + 1,) int32. Out: rows_used (1,)
// int32 (the rows next-fit filled, -1 on a broken layout); catp (R, L, C),
// contp (R, L, D), segs, poss (R, L); row_eff, span_col (N,) by sorted
// index. *launches gets the number of kernels launched.
extern "C" int next_fit_pack_launch(
    const void* perm, const void* thi, const void* tlo, const void* cat,
    const void* cont, int C, int D, long long n, long long N, int L, int R,
    void* mask, void* pic, void* rs, void* rows_used, void* catp,
    void* contp, void* segs, void* poss, void* row_eff, void* span_col,
    int* launches, void* stream) {
  *launches = 0;
  if (n < 0 || N < n || L < 1 || R < 0 || C < 0 || D < 0 ||
      N > 0x7fffffffLL)
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
  if (words <= kWalkSmemWords)
    pack_walk_kernel<true><<<1, kWalkThreads, words * 4, st>>>(
        m, n, L, R, static_cast<int32_t*>(rs),
        static_cast<int32_t*>(rows_used));
  else
    pack_walk_kernel<false><<<1, kWalkThreads, 0, st>>>(
        m, n, L, R, static_cast<int32_t*>(rs),
        static_cast<int32_t*>(rows_used));
  ++*launches;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long slots = (long long)R * L;
  const long long work = slots > N ? slots : N;
  if (work > 0) {
    const long long blocks = (work + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    pack_scatter_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const int32_t*>(perm), static_cast<const int32_t*>(cat),
        static_cast<const float*>(cont), C, D, m,
        static_cast<const int32_t*>(pic), static_cast<const int32_t*>(rs),
        static_cast<const int32_t*>(rows_used), n, N, L, R,
        static_cast<int32_t*>(catp), static_cast<float*>(contp),
        static_cast<int32_t*>(segs), static_cast<int32_t*>(poss),
        static_cast<int32_t*>(row_eff), static_cast<int32_t*>(span_col));
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// K13: one trace per row, for the autoencoder's fused route. Replaces
// odigos_tpu/serving/fused.py _build_pack_spans (:462-488; after the
// shared _sorted_trace_layout, :429-459): row = the trace's ordinal in
// K6's (trace_id_hi, trace_id_lo, start) order, column = the span's
// position in its trace, spans at column >= L dropped (the host's
// assemble_sequences truncation), traces at row >= R dropped. Three
// launches:
//   layout   K7's layout kernel with L = INT_MAX: a position in the trace
//            is then a multiple of L only at 0, so its bitmask marks the
//            first span of each trace;
//   scan     one block: each thread's popcount over its run of mask words,
//            a block scan, then each trace start written at its ordinal
//            (ts, R + 1 entries, the sentinel n after the last trace) and
//            the trace count (rows_used, read by the host at harvest);
//   scatter  one thread per output slot, as K7's.
// Outputs: catp (R, L, C) int32, contp (R, L, D) f32, maskp (R, L) bytes
// and span_map (R, L) int32 (the span's original row, -1 at padding: K11
// writes each real position's score there), every element written once.
// Bound on the card: bytes, R * L * (4 C + 4 D + 5) out (R = 2048, L = 64:
// 17.3 MB, 5.2 us at 3.35 TB/s) plus ~28 B a span in; the layout's
// binary search (~17 dependent L2 reads a span) and the one-block scan set
// the time at these sizes.
extern "C" int trace_rows_pack_launch(
    const void* perm, const void* thi, const void* tlo, const void* cat,
    const void* cont, int C, int D, long long n, long long N, int L, int R,
    void* mask, void* pic, void* ts, void* rows_used, void* catp,
    void* contp, void* maskp, void* span_map, int* launches, void* stream) {
  *launches = 0;
  if (n < 0 || N < n || L < 1 || R < 0 || C < 0 || D < 0 ||
      N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  unsigned* m = static_cast<unsigned*>(mask);
  if (n > 0) {
    const long long words = (n + 31) >> 5;
    const long long blocks = (words * 32 + kThreads - 1) / kThreads;
    pack_layout_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const int32_t*>(perm),
        static_cast<const unsigned long long*>(thi),
        static_cast<const unsigned long long*>(tlo), n, 0x7fffffff, m,
        static_cast<int32_t*>(pic));
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  rows_scan_kernel<<<1, kWalkThreads, 0, st>>>(
      m, n, R, static_cast<int32_t*>(ts), static_cast<int32_t*>(rows_used));
  ++*launches;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long slots = (long long)R * L;
  if (slots > 0) {
    const long long blocks = (slots + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    rows_scatter_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const int32_t*>(perm), static_cast<const int32_t*>(cat),
        static_cast<const float*>(cont), C, D,
        static_cast<const int32_t*>(ts),
        static_cast<const int32_t*>(rows_used), L, R,
        static_cast<int32_t*>(catp), static_cast<float*>(contp),
        static_cast<uint8_t*>(maskp), static_cast<int32_t*>(span_map));
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
