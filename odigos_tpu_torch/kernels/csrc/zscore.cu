// Streaming z-score detector for Hopper (sm_90a): the score (K4) and the
// Welford segmented update (K3) of one batch, in ONE launch.
//
// Replaces: odigos_tpu/models/zscore.py _score_kernel (:87-98) on the state
// before the batch, then _update_masked_kernel (:101-129; _update_kernel,
// :65-84, is its form with weights of 1), plus the squash 1 - exp(-z/4)
// and the cold-span count of odigos_tpu/serving/engine.py
// ZScoreBackend.score (:341-349). The JAX package left these to XLA as
// three segment_sums, a gather and a handful of elementwise ops.
//
// The group of a span is the Knuth mix of its (service, name) ids, in
// uint32 arithmetic that wraps as the reference's does:
//
//   gid = (u32(svc) * 2654435761 ^ u32(name) * 40503) mod G
//
// What one launch computes, each part switchable (the wrapper's
// zscore_score, zscore_update and zscore_score_update):
//   score  z = |x - mean| / sqrt(max(m2 / max(count - 1, 1), 1e-8)) on the
//          OLD state, 0 where count < min_count; the squashed score
//          1 - exp(-z / 4) and/or z; the number of spans among the first
//          n_valid whose z is 0 (cold);
//   A      per group, the sums of w and w*x over the batch;
//   B      per group, the sum of w * (x - b_mean[gid])^2, with
//          b_mean = f32(sum w*x) / max(f32(sum w), 1). Two passes, never
//          sum x^2 - n * mean^2: log-durations sit around 5-15 and the
//          one-pass form cancels in f32;
//   merge  per touched group, the Chan merge of (count, mean, M2) with
//          the batch's (n_b, b_mean, b_m2), term for term as the reference
//          writes it; an untouched group keeps its state (copied when the
//          output does not alias the input).
// The per-span terms (w*x and w*d*d) are rounded to f32 as in the
// reference; the sums are taken in f64 and rounded once to f32, so the
// order the atomics land in does not show (131072 terms lose ~1e-11
// relative in f64, far below an f32 rounding step) and the kernel matches
// the plain version, which sums in f64 too, almost always to the bit. A row
// of weight 0 adds nothing: all-zero weights leave the state bit for bit.
// With no weights given, every span weighs 1 (the engine's batches).
//
// Bound on the card: neither bytes nor operations. At the engine's cap of
// 65536 spans a call reads 12 B a span (two ids, the duration) and writes
// 4 (the score), and gathers and writes the state of the groups present
// (a few dozen on otel-demo traffic): ~1 MB, 0.3 us at 3.35 TB/s; the
// work is a few dozen operations a span. What costs is latency: the launch,
// the dependent load chains and the barriers between the phases.
//
// Design. Run as separate kernels (score, pass A, pass B, merge, and a
// fill of the cold counter) the function costs four dependent launches a
// call, reads and hashes every span three times, and zeroes and scans all
// G groups' sums in shared memory in every CTA of both passes (128 KiB at
// G = 8192, for a batch that touches a few dozen groups). Here:
// * One cooperative launch (every CTA resident) with one grid barrier,
//   between pass A and pass B. A thread loads its spans' ids and
//   durations once into registers (kHeld of them; past that, a span is
//   loaded again in each pass), computes the group id there and gathers
//   its group's old state at once; it adds its pass-A terms, then scores
//   the span from the gathered state (the gathers' latency hidden behind
//   pass A), and after the barrier adds its pass-B term from the same
//   registers. The last CTA to finish pass B (a ticket) merges.
// * A span a thread (kSpansPerThread): a CTA's work is a chain of
//   latencies (loads, warp aggregation, shared atomics, the flush), and
//   more CTAs hide it better than more spans a thread (2 and 4 a thread
//   measured 0.020 and 0.025 ms at N = 65536 against 0.017, with the
//   ablation tool); at most the CTAs the card holds at once, so 131072
//   spans take 2 a thread.
// * The contention trap: otel-demo traffic lands nearly every span in a
//   few dozen groups. Each pass aggregates inside a warp (__match_any_sync
//   on the group id, the leader adds its peers' terms in lane order; the
//   first pass's peer masks are kept for the second), then adds once per
//   group per warp into the CTA's sums in shared memory. Only the groups
//   the CTA touched are zeroed and flushed: a G-bit map in shared memory
//   marks them (set before the adds, scanned word by word). The flush
//   adds each touched group once into a (3, G) f64 scratch in device
//   memory and ORs the CTA's bits into a device bit map. After the
//   barrier each CTA reads its touched groups' b_mean into shared memory
//   at once. The merging CTA reads the device bit map a word a lane, so it
//   merges the touched groups only, and sets the map and the sums back to
//   0 for the next call.
// * A G whose sums do not fit in shared memory takes the global route: the
//   same warp aggregation, then atomics straight into the scratch.
// * The cold total is summed in a register a thread, a shuffle reduction a
//   warp and a shared counter a CTA, then added (no value returned) into
//   the caller's output word, which is 0 on entry: the engine's one
//   host-to-device copy writes that 0 beside the inputs, so no fill launch
//   and no round trip to L2 (a ticket) at the CTAs' tail.
// * The output state may alias the input (the engine updates in place):
//   the merge runs after every CTA's ticket, when every read of the old
//   state is past. Out of place, every group is copied at the start and
//   the touched ones overwritten by the merge.
// Cooperative grid against a thread-block cluster: a cluster form (one
// cluster of up to 16 CTAs, each owning a slice of the groups' sums in its
// shared memory, the others adding into it through distributed shared
// memory, barrier.cluster between the phases) lost at every shape (H100
// SXM, 700 W: at N = 65536 0.045 ms against 0.017, at 4096 0.019 against
// 0.017, at 131072 0.074 against 0.020) and was removed: 16 SMs cannot
// hide the chain of latencies that 128 CTAs hide, and the grid barrier
// costs less than the loads it lets run in parallel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;              // 16 warps a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kSpansPerThread = 1;         // grid sizing: spans a thread
constexpr int kHeld = 4;                   // spans a thread keeps in registers
constexpr int kWarpBuf = 64;               // doubles of staging per warp
constexpr int kCtlBytes = 16;              // the CTA's cold counter
constexpr int kSmemLimit = 232448;         // 227 KB, the most a block may use
constexpr int kMaxDevices = 64;
constexpr uint32_t kMulSvc = 2654435761u;  // Knuth's multiplicative constant
constexpr uint32_t kMulName = 40503u;

enum Route { kShared = 0, kGlobal = 1 };

struct Args {
  const int32_t* ids;  // (N, C) int32: columns 0 and 1 read
  const float* x;      // (N,)
  const float* w;      // (N,) or null: weights of 1
  long long N, n_valid;
  int C, per;          // row stride; spans a thread (grid-uniform)
  uint32_t G;
  float min_count;
  const float *in_count, *in_mean, *in_m2;
  float *out_count, *out_mean, *out_m2;  // null: no update
  float *z, *s;        // each may be null
  int* cold;           // may be null; 0 on entry, the count added to it
  double* sums;        // (3, G) f64, all 0 between calls
  uint32_t* gbits;     // ceil(G / 32) words, all 0 between calls
  unsigned int* ctl;   // 0 between calls: the merge's tickets
};

__host__ __device__ constexpr long long words_of(long long g) {
  return (g + 31) / 32;
}

__host__ __device__ constexpr long long pad8(long long bytes) {
  return (bytes + 7) & ~7LL;
}

// Shared memory of one CTA: the cold counter, the warps' staging, and on
// the shared route the bit map of touched groups and 2 x G f64 sums.
__host__ __device__ constexpr long long smem_bytes(int route, long long G) {
  return kCtlBytes + (long long)kWarps * kWarpBuf * 8 +
         (route == kShared ? pad8(4 * words_of(G)) + 16 * G : 0);
}

__device__ __forceinline__ int group_of(const Args& a, long long i) {
  const uint32_t svc = static_cast<uint32_t>(__ldg(a.ids + i * a.C));
  const uint32_t name = static_cast<uint32_t>(__ldg(a.ids + i * a.C + 1));
  return static_cast<int>(((svc * kMulSvc) ^ (name * kMulName)) % a.G);
}

// The batch mean from the pass-A sums, as the plain version computes it:
// both sums rounded to f32, then one IEEE division.
__device__ __forceinline__ float batch_mean(double sw, double swx) {
  const float n_b = __double2float_rn(sw);
  return __fdiv_rn(__double2float_rn(swx), fmaxf(n_b, 1.f));
}

// Adds every active lane's terms into acc0[key] (and acc1[key]) with one
// atomic per distinct key in the warp; peers is __match_any_sync(key).
// key < 0 marks a lane with nothing to add. All 32 lanes call it
// (warp-uniform loop). The leader of each key sums its peers' terms in
// lane order from the warp's staging buffer; on the global route it also
// marks the key in the device bit map.
template <int kVals>
__device__ __forceinline__ void warp_add(double* acc0, double* acc1,
                                         uint32_t* mark, int key,
                                         unsigned peers, double v0,
                                         double v1, double* wbuf) {
  const int lane = threadIdx.x & 31;
  wbuf[lane] = v0;
  if (kVals == 2) wbuf[32 + lane] = v1;
  __syncwarp();
  if (key >= 0 && lane == __ffs(peers) - 1) {
    double s0 = 0.0, s1 = 0.0;
    for (unsigned m = peers; m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      s0 += wbuf[j];
      if (kVals == 2) s1 += wbuf[32 + j];
    }
    atomicAdd(acc0 + key, s0);
    if (kVals == 2) atomicAdd(acc1 + key, s1);
    if (mark) {
      const uint32_t bit = 1u << (key & 31);
      if (!(__ldcg(mark + (key >> 5)) & bit)) atomicOr(mark + (key >> 5), bit);
    }
  }
  __syncwarp();  // the buffer is refilled on the next step
}

// Chan's merge of one group, term for term as the reference writes it.
__device__ __forceinline__ void merge_group(const Args& a, long long g,
                                            double sw, double swx,
                                            double m2) {
  const float n_a = a.in_count[g], mean_a = a.in_mean[g], m2_a = a.in_m2[g];
  const float n_b = __double2float_rn(sw);
  const float b_mean = batch_mean(sw, swx);
  const float b_m2 = __double2float_rn(m2);
  const float n_ab = __fadd_rn(n_a, n_b);
  const float safe_ab = fmaxf(n_ab, 1.f);
  const float delta = __fsub_rn(b_mean, mean_a);
  a.out_count[g] = n_ab;
  a.out_mean[g] = __fadd_rn(mean_a, __fmul_rn(delta, __fdiv_rn(n_b, safe_ab)));
  a.out_m2[g] = __fadd_rn(
      __fadd_rn(m2_a, b_m2),
      __fmul_rn(__fmul_rn(delta, delta),
                __fdiv_rn(__fmul_rn(n_a, n_b), safe_ab)));
}

__device__ __forceinline__ void copy_group(const Args& a, long long g) {
  a.out_count[g] = a.in_count[g];
  a.out_mean[g] = a.in_mean[g];
  a.out_m2[g] = a.in_m2[g];
}

// The score of one span against its group's state (count, mean, m2).
__device__ __forceinline__ float z_of(float xi, float cnt, float mean,
                                      float m2, float min_count) {
  const float var = __fdiv_rn(m2, fmaxf(__fsub_rn(cnt, 1.f), 1.f));
  const float sd = __fsqrt_rn(fmaxf(var, 1e-8f));
  const float z = __fdiv_rn(fabsf(__fsub_rn(xi, mean)), sd);
  return cnt >= min_count ? z : 0.f;
}

template <int kRoute>
__global__ void __launch_bounds__(kThreads)
    zscore_step_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_cold = reinterpret_cast<int*>(smem);
  int* s_last = s_cold + 1;
  double* staging = reinterpret_cast<double*>(smem + kCtlBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double* wbuf = staging + warp * kWarpBuf;
  const long long G = a.G;
  const long long nwords = words_of(G);
  uint32_t* bits = reinterpret_cast<uint32_t*>(staging + kWarps * kWarpBuf);
  double* acc = reinterpret_cast<double*>(
      reinterpret_cast<unsigned char*>(bits) + pad8(4 * nwords));

  const bool update = a.out_count != nullptr;
  const bool score = a.z || a.s || a.cold;
  const bool shared_sums = kRoute == kShared;
  // this thread's spans: i = j * T + t for j < per, the first kHeld held
  // in registers with their group's old state (gathered now, used by the
  // score after pass A's adds) and the peers of their update key (the
  // first pass's __match_any_sync, kept for the passes after it)
  const long long T = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int per = a.per;
  int gid[kHeld];
  float xv[kHeld], wv[kHeld], cv[kHeld], mv[kHeld], qv[kHeld], zv[kHeld];
  unsigned pv[kHeld];
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const long long i = j * T + t;
    gid[j] = -1;
    xv[j] = wv[j] = cv[j] = mv[j] = qv[j] = zv[j] = 0.f;
    pv[j] = 0u;
    if (j < per && i < a.N) {
      gid[j] = group_of(a, i);
      xv[j] = __ldg(a.x + i);
      wv[j] = a.w ? __ldg(a.w + i) : 1.f;
      if (score) {
        cv[j] = a.in_count[gid[j]];
        mv[j] = a.in_mean[gid[j]];
        qv[j] = a.in_m2[gid[j]];
      }
    }
  }
  // f(g, x, w, i, peers, held, cnt, mean, m2, z) for each of the thread's
  // spans, in order; warp-uniform (per is the same for every thread), so f
  // may use warp collectives. peers and z are the held span's slots (a
  // scratch for the others); the old state is gathered here for the others
  // when with_state.
  auto for_each = [&](auto&& f, bool with_state) {
#pragma unroll
    for (int j = 0; j < kHeld; ++j)
      if (j < per)
        f(gid[j], xv[j], wv[j], j * T + t, pv[j], true, cv[j], mv[j], qv[j],
          zv[j]);
    for (int j = kHeld; j < per; ++j) {
      const long long i = j * T + t;
      int g = -1;
      float xi = 0.f, wi = 0.f, c = 0.f, m = 0.f, q = 0.f, z = 0.f;
      unsigned peers = 0u;
      if (i < a.N) {
        g = group_of(a, i);
        xi = __ldg(a.x + i);
        wi = a.w ? __ldg(a.w + i) : 1.f;
        if (with_state) {
          c = a.in_count[g];
          m = a.in_mean[g];
          q = a.in_m2[g];
        }
      }
      f(g, xi, wi, i, peers, false, c, m, q, z);
    }
  };
  auto key_of = [](int g, float wi) { return (g >= 0 && wi != 0.f) ? g : -1; };
  // the bit map zeroed while the loads fly
  if (threadIdx.x == 0) *s_cold = 0;
  if (update && shared_sums)
    for (long long i = threadIdx.x; i < nwords; i += kThreads) bits[i] = 0u;
  __syncthreads();

  // out of place: every group's state copied now, the touched ones
  // overwritten by the merge (which comes after every CTA's ticket)
  if (update && a.out_count != a.in_count)
    for (long long g = t; g < G; g += T) copy_group(a, g);

  // ---- pass A: mark the touched groups, zero their sums, add w and w*x
  double* acc0 = shared_sums ? acc : a.sums;
  double* acc1 = shared_sums ? acc + G : a.sums + G;
  uint32_t* mark = shared_sums ? nullptr : a.gbits;
  if (update) {
    for_each([&](int g, float, float wi, long long, unsigned& peers, bool,
                 float, float, float, float&) {
      const int key = key_of(g, wi);
      peers = __match_any_sync(0xffffffffu, key);
      if (shared_sums && key >= 0 && lane == __ffs(peers) - 1) {
        const uint32_t bit = 1u << (key & 31);
        if (!(bits[key >> 5] & bit)) atomicOr(bits + (key >> 5), bit);
      }
    }, false);
    if (shared_sums) {
      __syncthreads();
      for (long long wd = threadIdx.x; wd < nwords; wd += kThreads)
        for (uint32_t m = bits[wd]; m; m &= m - 1) {
          const long long g = wd * 32 + __ffs(m) - 1;
          acc[g] = 0.0;
          acc[G + g] = 0.0;
        }
      __syncthreads();
    }
    for_each([&](int g, float xi, float wi, long long, unsigned& peers,
                 bool held, float, float, float, float&) {
      const int key = key_of(g, wi);
      if (!held) peers = __match_any_sync(0xffffffffu, key);
      warp_add<2>(acc0, acc1, mark, key, peers, wi, __fmul_rn(wi, xi),
                  wbuf);
    }, false);
  }

  // ---- score on the state before the batch (gathered at the start). With
  // an update, a held span's z waits in a register and is written after
  // the CTA's last ticket (the stores stay out of the fences before it).
  auto store_z = [&](long long i, float zi) {
    if (a.z) a.z[i] = zi;
    if (a.s) a.s[i] = __fsub_rn(1.f, expf(-__fmul_rn(zi, 0.25f)));
  };
  if (score) {
    int my_cold = 0;
    for_each([&](int g, float xi, float, long long i, unsigned&, bool held,
                 float cnt, float mean, float m2, float& zs) {
      if (g < 0) return;
      const float zi = z_of(xi, cnt, mean, m2, a.min_count);
      if (update && held)
        zs = zi;
      else
        store_z(i, zi);
      my_cold += (i < a.n_valid && zi == 0.f);
    }, true);
    if (a.cold) {
      my_cold = __reduce_add_sync(0xffffffffu, my_cold);
      if (lane == 0 && my_cold) atomicAdd(s_cold, my_cold);
    }
  }
  // the held spans' scores, once this CTA's part of the update is done
  auto store_held = [&]() {
    if (!score) return;
#pragma unroll
    for (int j = 0; j < kHeld; ++j)
      if (j < per && gid[j] >= 0) store_z(j * T + t, zv[j]);
  };
  __syncthreads();
  // the CTA's count into the caller's word (0 on entry); no value returned
  if (a.cold && threadIdx.x == 0 && *s_cold) atomicAdd(a.cold, *s_cold);
  if (!update) return;

  // ---- flush pass A's sums of the touched groups
  if (shared_sums) {
    for (long long wd = threadIdx.x; wd < nwords; wd += kThreads) {
      const uint32_t m0 = bits[wd];
      if (!m0) continue;
      atomicOr(a.gbits + wd, m0);
      for (uint32_t m = m0; m; m &= m - 1) {
        const long long g = wd * 32 + __ffs(m) - 1;
        const double s0 = acc[g], s1 = acc[G + g];
        acc[g] = 0.0;  // pass B's sums reuse row 0
        atomicAdd(a.sums + g, s0);
        atomicAdd(a.sums + G + g, s1);
      }
    }
  }
  cg::this_grid().sync();

  // ---- pass B: sum of w * (x - b_mean)^2. On the shared route the CTA
  // first reads its touched groups' b_mean into row 1 of its sums, all at
  // once; on the global route each key's leader reads it and shuffles it
  // to its peers.
  double* acc_m2 = shared_sums ? acc : a.sums + 2 * G;
  if (shared_sums) {
    for (long long wd = threadIdx.x; wd < nwords; wd += kThreads)
      for (uint32_t m = bits[wd]; m; m &= m - 1) {
        const long long g = wd * 32 + __ffs(m) - 1;
        acc[G + g] = batch_mean(__ldcg(a.sums + g), __ldcg(a.sums + G + g));
      }
    __syncthreads();
  }
  auto pass_b = [&](int g, float xi, float wi, long long, unsigned& peers,
                    bool held, float, float, float, float&) {
    const int key = key_of(g, wi);
    if (!held) peers = __match_any_sync(0xffffffffu, key);
    float bm = 0.f;
    if (shared_sums) {
      if (key >= 0) bm = (float)acc[G + key];
    } else {
      const int leader = __ffs(peers) - 1;
      if (key >= 0 && lane == leader)
        bm = batch_mean(__ldcg(a.sums + key), __ldcg(a.sums + G + key));
      bm = __shfl_sync(0xffffffffu, bm, leader);
    }
    const float d = __fsub_rn(xi, bm);
    warp_add<1>(acc_m2, nullptr, nullptr, key, peers,
                key >= 0 ? (double)__fmul_rn(wi, __fmul_rn(d, d)) : 0.0,
                0.0, wbuf);
  };
  for_each(pass_b, false);
  if (shared_sums) {
    __syncthreads();
    for (long long wd = threadIdx.x; wd < nwords; wd += kThreads)
      for (uint32_t m = bits[wd]; m; m &= m - 1) {
        const long long g = wd * 32 + __ffs(m) - 1;
        atomicAdd(a.sums + 2 * G + g, acc[g]);
      }
  }

  // ---- merge the touched groups (the others were copied at the start
  // where out != in). The last CTA to finish pass B merges: each thread's
  // adds made visible, then a ticket.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *s_last = atomicAdd(a.ctl, 1u) == gridDim.x - 1;
  store_held();
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  auto merge = [&](long long g) {
    merge_group(a, g, __ldcg(a.sums + g), __ldcg(a.sums + G + g),
                __ldcg(a.sums + 2 * G + g));
    a.sums[g] = 0.0;
    a.sums[G + g] = 0.0;
    a.sums[2 * G + g] = 0.0;
  };
  if (shared_sums) {
    // the touched groups listed in shared memory (a thread a word of the
    // device bit map, which it clears), then merged a thread a group
    int* s_n = s_cold;  // the CTA's cold count is added by now
    int* list = reinterpret_cast<int*>(acc);
    if (threadIdx.x == 0) *s_n = 0;
    __syncthreads();
    for (long long wd = threadIdx.x; wd < nwords; wd += kThreads) {
      const uint32_t m = __ldcg(a.gbits + wd);
      if (!m) continue;
      int k = atomicAdd(s_n, __popc(m));
      for (uint32_t r = m; r; r &= r - 1)
        list[k++] = (int)(wd * 32 + __ffs(r) - 1);
      a.gbits[wd] = 0u;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < *s_n; k += kThreads) merge(list[k]);
  } else {
    // no room for a list: a thread a word, its set bits in turn
    for (long long wd = threadIdx.x; wd < nwords; wd += kThreads) {
      const uint32_t m = __ldcg(a.gbits + wd);
      for (uint32_t r = m; r; r &= r - 1) merge(wd * 32 + __ffs(r) - 1);
      if (m) a.gbits[wd] = 0u;
    }
  }
  if (threadIdx.x == 0) a.ctl[0] = 0u;
}

// ---- once-per-device launch set-up: the shared-memory attribute, the SM
// count, and the CTAs an SM holds at the last shared-memory size asked for

struct LaunchInfo {
  std::atomic<int> attr_set[kMaxDevices];
  std::atomic<int> sms[kMaxDevices];
  std::atomic<long long> occ[kMaxDevices];  // (smem bytes << 8) | blocks
};

LaunchInfo g_info[2][2];  // [route][update]

template <int kRoute>
cudaError_t launch(Args& a, long long N, cudaStream_t stream) {
  auto kernel = zscore_step_kernel<kRoute>;
  const bool update = a.out_count != nullptr;
  LaunchInfo& info = g_info[kRoute][update];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!info.attr_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    int coop = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorCooperativeLaunchTooLarge;
    info.sms[dev].store(sms, std::memory_order_relaxed);
    info.attr_set[dev].store(1, std::memory_order_release);
  }
  const long long smem_ll = smem_bytes(kRoute, update ? a.G : 0);
  if (smem_ll > kSmemLimit) return cudaErrorInvalidValue;
  const int smem = (int)smem_ll;
  const long long occ = info.occ[dev].load(std::memory_order_acquire);
  int per_sm = 0;
  if ((occ >> 8) == smem) {
    per_sm = (int)(occ & 0xff);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    info.occ[dev].store(((long long)smem << 8) | (per_sm & 0xff),
                        std::memory_order_release);
  }
  // kSpansPerThread spans a thread, at most the CTAs the card holds at once
  const long long want =
      (N + (long long)kThreads * kSpansPerThread - 1) /
      ((long long)kThreads * kSpansPerThread);
  const long long cap =
      (long long)per_sm * info.sms[dev].load(std::memory_order_relaxed);
  const int blocks = (int)(want < 1 ? 1 : want < cap ? want : cap);
  const long long T = (long long)blocks * kThreads;
  a.per = (int)((N + T - 1) / T);
  if (!update) {
    kernel<<<blocks, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                     dim3(kThreads), args, (size_t)smem,
                                     stream);
}

}  // namespace

// K3 + K4 in one launch. ids: (N, C) int32, columns 0 and 1 read; x: (N,)
// f32; w: (N,) f32 or null (weights of 1); the state in_*: (G,) f32 each;
// out_*: (G,) f32 each, or all null for no update (they may alias in_*);
// z, s: (N,) f32 or null; cold: one int32 or null, 0 on entry (the count
// of z == 0 among the first n_valid spans is added to it); scratch: 3 * G
// f64 sums, then ceil(G / 32) uint32 words rounded up to an even count,
// then 2 more, all 0 on entry and all 0 again once the call's work has
// run (needed by an update only). route: 0 shared, 1 global (the wrapper
// picks; 0 is refused where the sums do not fit in shared memory). One
// launch, cooperative when it updates. Shapes are checked by the wrapper.
// Returns the CUDA error, 0 when launched.
extern "C" int zscore_step_launch(const void* ids, int C, const void* x,
                                  const void* w, long long N,
                                  long long n_valid, int G, float min_count,
                                  const void* in_count, const void* in_mean,
                                  const void* in_m2, void* out_count,
                                  void* out_mean, void* out_m2, void* z,
                                  void* s, void* cold, void* scratch,
                                  int route, void* stream) {
  if (N < 0 || C < 2 || G <= 0 || n_valid < 0 || n_valid > N ||
      (route != kShared && route != kGlobal) ||
      (!out_count != !out_mean) || (!out_count != !out_m2))
    return (int)cudaErrorInvalidValue;
  if (!out_count && !z && !s && !cold) return (int)cudaSuccess;
  if (out_count && !scratch) return (int)cudaErrorInvalidValue;
  Args a;
  a.ids = static_cast<const int32_t*>(ids);
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.N = N;
  a.n_valid = n_valid;
  a.C = C;
  a.per = 0;
  a.G = static_cast<uint32_t>(G);
  a.min_count = min_count;
  a.in_count = static_cast<const float*>(in_count);
  a.in_mean = static_cast<const float*>(in_mean);
  a.in_m2 = static_cast<const float*>(in_m2);
  a.out_count = static_cast<float*>(out_count);
  a.out_mean = static_cast<float*>(out_mean);
  a.out_m2 = static_cast<float*>(out_m2);
  a.z = static_cast<float*>(z);
  a.s = static_cast<float*>(s);
  a.cold = static_cast<int*>(cold);
  a.sums = static_cast<double*>(scratch);
  a.gbits = a.sums ? reinterpret_cast<uint32_t*>(a.sums + 3 * (long long)G)
                   : nullptr;
  a.ctl = a.gbits ? a.gbits + (words_of(G) + 1) / 2 * 2 : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(route == kGlobal ? launch<kGlobal>(a, N, st)
                                : launch<kShared>(a, N, st));
}
