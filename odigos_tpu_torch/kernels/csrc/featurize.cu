// K5: the fused route's featurize over raw span columns, for Hopper
// (sm_90a): the parent self-join by a hash table on the card.
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
// frame declaring span_id == parent_id. The duration is exact: end - start
// in unsigned 64-bit integers (0 where end < start), converted once to f64
// (round to nearest, as numpy's astype), divided by 1000 and log1p'd in
// f64, rounded once to f32 — the reference's split-clock f32 recomposition
// is its documented x32 divergence, not its semantics.
//
// Design: an open-addressing table of P u64 slots (P a power of two >=
// 4N, so at most a quarter full; from the caller's pool, P * 8 bytes: 2 MB
// at N = 65536, in L2), each slot (row << 32 | the key's hash tag) or
// EMPTY; a probe step loads the 4-slot group (one 32-byte sector) that
// holds its slot and walks it in order, so a linear probe over a cluster
// takes one load a group, and a slot of another key is passed on its tag
// without loading that key. Three device steps on the stream:
//   clear    cudaMemsetAsync to EMPTY (all ones);
//   insert   one thread per real row, whole warps: the lanes of a warp
//            declaring one (frame, span) key (two __match_any_sync) leave
//            the insert to their lowest lane, which hashes the key (a
//            64-bit mix: the slot from its low bits, the tag from its high
//            word) and probes linearly: an EMPTY slot is claimed by
//            atomicCAS; a taken slot with the key's tag has its owner row's
//            key read from the INPUT columns (so no key is ever read
//            half-written), and on the same key the lower row wins by a
//            64-bit atomicMin (the row is the high word), skipped when the
//            owner is already lower; else the next slot. Whatever the
//            threads' order, each key's slot ends holding its lowest
//            declaring row: the reference's "first row wins";
//   probe    one thread per row of the bucket, launched by programmatic
//            dependent launch while the insert runs: it loads its columns,
//            gathers its own service and name and takes the duration
//            before griddepcontrol.wait, then probes (frame, parent_id) —
//            a group load, the owner's key, then its service: ~3
//            dependent loads, not the ~34 of a binary search over sorted
//            declarations — and writes cat and cont; rows past n are
//            written as zeros.
// Bound on the card: bytes (~46 B of columns read per span and 32 B
// written, 2.3 us at 65536 spans, plus the table's clear); the launches'
// dependent chains (group, owner key) set the time at these sizes. A key
// declared by many rows is one insert a warp, and rows finding a lower
// owner already in place issue no atomic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCat = 5;
constexpr int kCont = 3;
constexpr unsigned long long kEmpty = ~0ull;
constexpr int kGroup = 4;  // slots a probe step loads (32 bytes)

__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// the key's home slot: splitmix64's finalizer over the span id and the
// frame (the frame first multiplied by an odd constant, so equal span ids
// of two frames land apart)
__device__ __forceinline__ unsigned long long key_hash(
    uint32_t frame, unsigned long long span) {
  unsigned long long z = span ^ ((unsigned long long)frame *
                                 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// the 4-slot group (32 bytes, one sector) that holds slot g, g % 4 == 0
__device__ __forceinline__ void load_group(
    const unsigned long long* tab, unsigned long long g,
    unsigned long long (&q)[kGroup]) {
  const ulonglong2 a = __ldcg(reinterpret_cast<const ulonglong2*>(tab + g));
  const ulonglong2 b =
      __ldcg(reinterpret_cast<const ulonglong2*>(tab + g + 2));
  q[0] = a.x;
  q[1] = a.y;
  q[2] = b.x;
  q[3] = b.y;
}

__global__ void __launch_bounds__(kThreads) featurize_insert_kernel(
    const unsigned long long* __restrict__ span,
    const uint32_t* __restrict__ frame, long long n, unsigned long long pmask,
    unsigned long long* __restrict__ tab) {
  launch_dependents();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool real = i < n;
  const unsigned long long s = real ? span[i] : 0ull;
  const uint32_t f = real ? frame[i] : 0u;
  // the warp's lanes of one key: the lowest real one inserts (lanes are
  // rows in order, so it is the group's lowest row)
  const unsigned same = __match_any_sync(0xffffffffu, s) &
                        __match_any_sync(0xffffffffu, f) &
                        __ballot_sync(0xffffffffu, real);
  if (!real || (__ffs(same) - 1) != lane) return;
  const unsigned long long z = key_hash(f, s);
  const uint32_t tag = (uint32_t)(z >> 32);
  const unsigned long long v = ((unsigned long long)i << 32) | tag;
  unsigned long long h = z & pmask;
  for (;;) {
    const unsigned long long g = h & ~(unsigned long long)(kGroup - 1);
    unsigned long long q[kGroup];
    load_group(tab, g, q);
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      if (g + t < h) continue;
      unsigned long long cur = q[t];
      if (cur == kEmpty) {
        cur = atomicCAS(tab + g + t, kEmpty, v);
        if (cur == kEmpty) return;  // claimed
      }
      if ((uint32_t)cur != tag) continue;  // another key
      const long long o = (long long)(cur >> 32);
      if (frame[o] == f && span[o] == s) {  // the key's slot
        if (o > i) atomicMin(tab + g + t, v);
        return;
      }
    }
    h = (g + kGroup) & pmask;
  }
}

__global__ void __launch_bounds__(kThreads) featurize_probe_kernel(
    const int32_t* __restrict__ svc_tab, const int32_t* __restrict__ nam_tab,
    int svc_len, int nam_len, const int32_t* __restrict__ svc,
    const int32_t* __restrict__ nam, const int8_t* __restrict__ kind,
    const int8_t* __restrict__ status,
    const unsigned long long* __restrict__ span,
    const unsigned long long* __restrict__ parent,
    const unsigned long long* __restrict__ start,
    const unsigned long long* __restrict__ end,
    const uint32_t* __restrict__ frame,
    const unsigned long long* __restrict__ tab, unsigned long long pmask,
    long long n, long long N, int32_t* __restrict__ cat,
    float* __restrict__ cont) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) {
    wait_prior_grid();
    return;
  }
  int32_t* c = cat + i * kCat;
  float* x = cont + i * kCont;
  if (i >= n) {
    wait_prior_grid();
#pragma unroll
    for (int k = 0; k < kCat; ++k) c[k] = 0;
#pragma unroll
    for (int k = 0; k < kCont; ++k) x[k] = 0.f;
    return;
  }
  // the row's own columns, while the insert launch runs
  const int32_t sv = svc_tab[min(max(svc[i], 0), svc_len - 1)];
  const int32_t nv = nam_tab[min(max(nam[i], 0), nam_len - 1)];
  const int32_t kd = static_cast<int32_t>(kind[i]);
  const int32_t st = static_cast<int32_t>(status[i]);
  const uint32_t f = frame[i];
  const unsigned long long p = parent[i];
  const unsigned long long s0 = start[i], e0 = end[i];
  const unsigned long long dur = e0 >= s0 ? e0 - s0 : 0ull;
  const double us = __ddiv_rn(__ull2double_rn(dur), 1000.0);
  const float ld = __double2float_rn(log1p(us));
  const unsigned long long z = key_hash(f, p);
  const uint32_t tag = (uint32_t)(z >> 32);
  unsigned long long h = z & pmask;
  wait_prior_grid();  // the insert launch's table
  bool found = false;
  int32_t ps = 0;  // the parent row's service index
  for (bool more = true; more;) {
    const unsigned long long g = h & ~(unsigned long long)(kGroup - 1);
    unsigned long long q[kGroup];
    load_group(tab, g, q);
#pragma unroll
    for (int t = 0; t < kGroup && more; ++t) {
      if (g + t < h) continue;
      const unsigned long long cur = q[t];
      if (cur == kEmpty) {
        more = false;  // not declared in the frame
      } else if ((uint32_t)cur == tag) {
        const long long r = (long long)(cur >> 32);
        const int32_t sr = svc[r];  // beside the key's loads
        if (frame[r] == f && span[r] == p) {
          found = true;
          ps = sr;
          more = false;
        }
      }
    }
    h = (g + kGroup) & pmask;
  }
  const int32_t psvc = found ? svc_tab[min(max(ps, 0), svc_len - 1)] : 0;
  c[0] = sv;
  c[1] = nv;
  c[2] = kd;
  c[3] = st;
  c[4] = psvc;
  x[0] = ld;
  x[1] = p == 0ull ? 1.f : 0.f;
  x[2] = p == 0ull ? 0.f : (found ? 1.f : 0.5f);
}

}  // namespace

// K5. Tables: svc_tab (svc_len,), nam_tab (nam_len,) int32; columns (N,)
// each: svc, nam int32; kind, status int8; span, parent, start, end u64;
// frame int32 (>= 0 for the first n rows); table: P u64 scratch, 16-byte
// aligned, P a power of two >= max(4N, 4); out: cat (N, 5) int32, cont (N, 3) f32. *launches
// gets the number of kernels launched (the clear is a memset, not
// counted).
extern "C" int featurize_launch(const void* svc_tab, const void* nam_tab,
                                int svc_len, int nam_len, const void* svc,
                                const void* nam, const void* kind,
                                const void* status, const void* span,
                                const void* parent, const void* start,
                                const void* end, const void* frame,
                                void* table, long long P, long long n,
                                long long N, void* cat, void* cont,
                                int* launches, void* stream) {
  *launches = 0;
  if (n < 0 || N < n || svc_len < 1 || nam_len < 1 || P < 4 * N ||
      P < kGroup || (P & (P - 1)) != 0 || N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  auto* tab = static_cast<unsigned long long*>(table);
  const unsigned long long pmask = (unsigned long long)P - 1;
  const auto* sp = static_cast<const unsigned long long*>(span);
  const auto* fr = static_cast<const uint32_t*>(frame);
  if (n > 0) {
    if ((err = cudaMemsetAsync(tab, 0xFF, (size_t)P * 8, st)) != cudaSuccess)
      return (int)err;
    featurize_insert_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                              kThreads, 0, st>>>(sp, fr, n, pmask, tab);
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, featurize_probe_kernel, static_cast<const int32_t*>(svc_tab),
      static_cast<const int32_t*>(nam_tab), svc_len, nam_len,
      static_cast<const int32_t*>(svc),
      static_cast<const int32_t*>(nam), static_cast<const int8_t*>(kind),
      static_cast<const int8_t*>(status), sp,
      static_cast<const unsigned long long*>(parent),
      static_cast<const unsigned long long*>(start),
      static_cast<const unsigned long long*>(end), fr,
      static_cast<const unsigned long long*>(tab), pmask, n, N,
      static_cast<int32_t*>(cat), static_cast<float*>(cont));
  ++*launches;
  if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess)
    return (int)err;
  return (int)cudaSuccess;
}
