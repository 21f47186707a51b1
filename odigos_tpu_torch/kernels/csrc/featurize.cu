// K5: the fused route's featurize over raw span columns, for Hopper
// (sm_90a), one launch after K6 has sorted the declarations.
//
// Replaces odigos_tpu/features/featurizer.py featurize_columns_jax and its
// three phases (:382-467): featurize_hash_jax (gathers through the hashed
// string tables, enum widening), featurize_join_jax (the per-frame parent
// self-join: a lexsort over 2N merged keys, a segment_min and a scatter)
// and featurize_assemble_jax (categorical stack, log-duration, is_root,
// depth hint). The semantics are the host spec's,
// odigos_tpu/features/featurizer.py featurize_columns (:259-322):
//
//   cat  = [svc_tab[svc], nam_tab[nam], kind, status, parent_service]
//   cont = [f32(log1p(f64(max(end - start, 0)) / 1000)), parent == 0,
//           parent == 0 ? 0 : found ? 1 : 0.5]
//
// The join: a span's parent row is the FIRST row (lowest index) of its own
// frame declaring span_id == parent_id; K6 has sorted the rows by (frame,
// span_id) stably, so one lower-bound binary search per span finds it, as
// the host's stable argsort + searchsorted does. The duration is exact:
// end - start in unsigned 64-bit integers (0 where end < start), converted
// once to f64 (round to nearest, as numpy's astype), divided by 1000 and
// log1p'd in f64, rounded once to f32 — the reference's split-clock f32
// recomposition is its documented x32 divergence, not its semantics.
//
// One thread per span: rows past n (padding) are written as zeros. Bound
// on the card: bytes — ~62 B of columns read per span and 32 B written,
// under 2 us at 65536 spans; the search adds ~17 dependent L2 reads per
// span, so the launch is latency-bound, a few microseconds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCat = 5;
constexpr int kCont = 3;

__global__ void __launch_bounds__(kThreads) featurize_kernel(
    const int32_t* __restrict__ svc_tab, const int32_t* __restrict__ nam_tab,
    int svc_len, int nam_len, const int32_t* __restrict__ svc,
    const int32_t* __restrict__ nam, const int8_t* __restrict__ kind,
    const int8_t* __restrict__ status,
    const unsigned long long* __restrict__ span,
    const unsigned long long* __restrict__ parent,
    const unsigned long long* __restrict__ start,
    const unsigned long long* __restrict__ end,
    const uint32_t* __restrict__ frame, const int32_t* __restrict__ decl,
    long long n, long long N, int32_t* __restrict__ cat,
    float* __restrict__ cont) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  int32_t* c = cat + i * kCat;
  float* x = cont + i * kCont;
  if (i >= n) {
#pragma unroll
    for (int k = 0; k < kCat; ++k) c[k] = 0;
#pragma unroll
    for (int k = 0; k < kCont; ++k) x[k] = 0.f;
    return;
  }
  const int si = min(max(svc[i], 0), svc_len - 1);
  const int ni = min(max(nam[i], 0), nam_len - 1);
  const uint32_t f = frame[i];
  const unsigned long long p = parent[i];
  // lower bound of (f, p) among the declarations sorted by (frame, span)
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const int r = decl[mid];
    const uint32_t fr = frame[r];
    if (fr < f || (fr == f && span[r] < p))
      lo = mid + 1;
    else
      hi = mid;
  }
  bool found = false;
  int psvc = 0;
  if (lo < n) {
    const int r = decl[lo];
    if (frame[r] == f && span[r] == p) {
      found = true;
      psvc = svc_tab[min(max(svc[r], 0), svc_len - 1)];
    }
  }
  c[0] = svc_tab[si];
  c[1] = nam_tab[ni];
  c[2] = static_cast<int32_t>(kind[i]);
  c[3] = static_cast<int32_t>(status[i]);
  c[4] = psvc;
  const unsigned long long s = start[i], e = end[i];
  const unsigned long long dur = e >= s ? e - s : 0ull;
  const double us = __ddiv_rn(__ull2double_rn(dur), 1000.0);
  x[0] = __double2float_rn(log1p(us));
  x[1] = p == 0ull ? 1.f : 0.f;
  x[2] = p == 0ull ? 0.f : (found ? 1.f : 0.5f);
}

}  // namespace

// K5. Tables: svc_tab (svc_len,), nam_tab (nam_len,) int32; columns (N,)
// each: svc, nam int32; kind, status int8; span, parent, start, end u64;
// frame int32 (>= 0 for the first n rows); decl (N,) int32, the rows
// sorted stably by (frame, span) (K6); out: cat (N, 5) int32, cont (N, 3)
// f32.
extern "C" int featurize_launch(const void* svc_tab, const void* nam_tab,
                                int svc_len, int nam_len, const void* svc,
                                const void* nam, const void* kind,
                                const void* status, const void* span,
                                const void* parent, const void* start,
                                const void* end, const void* frame,
                                const void* decl, long long n, long long N,
                                void* cat, void* cont, void* stream) {
  if (n < 0 || N < n || svc_len < 1 || nam_len < 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const long long blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  featurize_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(svc_tab),
      static_cast<const int32_t*>(nam_tab), svc_len, nam_len,
      static_cast<const int32_t*>(svc), static_cast<const int32_t*>(nam),
      static_cast<const int8_t*>(kind), static_cast<const int8_t*>(status),
      static_cast<const unsigned long long*>(span),
      static_cast<const unsigned long long*>(parent),
      static_cast<const unsigned long long*>(start),
      static_cast<const unsigned long long*>(end),
      static_cast<const uint32_t*>(frame), static_cast<const int32_t*>(decl),
      n, N, static_cast<int32_t*>(cat), static_cast<float*>(cont));
  return (int)cudaGetLastError();
}
