// Streaming z-score detector kernels for Hopper (sm_90a): the Welford
// segmented update (K3) and the score (K4).
//
// Replaces: odigos_tpu/models/zscore.py _update_masked_kernel (:101-129;
// _update_kernel, :65-84, is its form with weights of 1) and _score_kernel
// (:87-98), plus the squash 1 - exp(-z/4) and the cold-span count of
// odigos_tpu/serving/engine.py ZScoreBackend.score (:341-349). The JAX
// package left these to XLA as three segment_sums, a gather and a handful
// of elementwise ops.
//
// The group of a span is the Knuth mix of its (service, name) ids, in
// uint32 arithmetic that wraps as the reference's does:
//
//   gid = (u32(svc) * 2654435761 ^ u32(name) * 40503) mod G
//
// K3, three launches on the caller's stream:
//   A  per group, the sums of w and w*x over the batch;
//   B  per group, the sum of w * (x - b_mean[gid])^2, with
//      b_mean = f32(sum w*x) / max(f32(sum w), 1). Two passes, never
//      sum x^2 - n * mean^2: log-durations sit around 5-15 and the one-pass
//      form cancels in f32;
//   C  one thread per group: the Chan merge of (count, mean, M2) with the
//      batch's (n_b, b_mean, b_m2), written term for term as the reference
//      writes it, then the scratch sums set back to 0 for the next call.
// The per-span terms (w*x and w*d*d) are rounded to f32 as in the
// reference; the sums are taken in f64 and rounded once to f32. f64 makes
// the result independent of the order the atomics land in (131072 terms
// lose ~1e-11 relative in f64, far below an f32 rounding step), so the
// kernel matches the plain version, which sums in f64 too, almost always to
// the bit. A row of weight 0 adds nothing: a batch padded with such rows,
// or one whose weights are all 0, leaves the state unchanged bit for bit.
//
// K4, one launch: one thread per span gathers its group's state and writes
//   z = |x - mean| / sqrt(max(m2 / max(count - 1, 1), 1e-8)),
//   0 where count < min_count,
// and, when asked, the squashed score 1 - exp(-z / 4) and the number of
// spans among the first n_valid whose z is 0 (cold).
//
// Bound on the card: neither bytes nor operations. At the engine's cap of
// 65536 spans a call moves ~2 MB (ids, durations, weights, the 96 KiB
// state, the scores), under 1 us at 3.35 TB/s; the work is a few dozen
// operations per span. Four launches back to back on a few microseconds of
// work each are bound by launch latency and by the dependency between
// them.
//
// Design (right first): the trap is contention. Synthetic otel-demo
// traffic lands nearly every span in a few dozen of the 8192 groups, and
// plain global atomics on a few addresses serialise. So each launch first
// aggregates inside a warp (__match_any_sync on the group id, the leader
// adds its peers' terms in lane order), then adds once per group per warp
// into a CTA-private copy of the sums in shared memory (2 x G doubles =
// 128 KiB at G = 8192, under the 227 KiB a block may use), and the CTA
// flushes each touched group once into the (3, G) f64 scratch in global
// memory. A G whose sums do not fit in shared memory takes the global
// route: the same warp aggregation, then atomics straight into the
// scratch. The wrapper picks the route by shape and the card tests pin
// both.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 1024;             // update passes: 32 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWarpBuf = 64;               // doubles of staging per warp
constexpr int kScoreThreads = 256;
constexpr int kMergeThreads = 256;
constexpr int kSmemLimit = 232448;         // 227 KB, the most a block may use
constexpr int kMaxDevices = 64;
constexpr uint32_t kMulSvc = 2654435761u;  // Knuth's multiplicative constant
constexpr uint32_t kMulName = 40503u;

enum Route { kShared = 0, kGlobal = 1 };

__device__ __forceinline__ int group_id(const int32_t* __restrict__ cat,
                                        long long i, int C, uint32_t G) {
  const uint32_t svc = static_cast<uint32_t>(cat[i * C]);
  const uint32_t name = static_cast<uint32_t>(cat[i * C + 1]);
  return static_cast<int>(((svc * kMulSvc) ^ (name * kMulName)) % G);
}

// The batch mean of group g from the pass-A sums, as the plain version
// computes it: both sums rounded to f32, then one IEEE division.
__device__ __forceinline__ float batch_mean(const double* sw,
                                            const double* swx, int g) {
  const float n_b = __double2float_rn(sw[g]);
  return __fdiv_rn(__double2float_rn(swx[g]), fmaxf(n_b, 1.f));
}

// Adds every active lane's terms into acc0[key] (and acc1[key]) with one
// atomic per distinct key in the warp. key < 0 marks a lane with nothing to
// add. All 32 lanes call it (warp-uniform loop). The leader of each key
// sums its peers' terms in lane order from the warp's staging buffer.
template <int kVals>
__device__ __forceinline__ void warp_add(double* acc0, double* acc1,
                                         int key, double v0, double v1,
                                         double* wbuf) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
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
  }
  __syncwarp();  // the buffer is refilled on the next step
}

// Pass A (kPass == 0): sums of w and w*x per group into scratch rows 0, 1.
// Pass B (kPass == 1): sum of w * (x - b_mean)^2 per group into row 2.
template <int kPass, int kRoute>
__global__ void __launch_bounds__(kThreads)
    zscore_pass_kernel(const int32_t* __restrict__ cat,
                       const float* __restrict__ x,
                       const float* __restrict__ w, long long N, int C,
                       uint32_t G, double* __restrict__ scratch) {
  constexpr int kVals = kPass == 0 ? 2 : 1;
  extern __shared__ double smem[];
  double* wbuf = smem + (threadIdx.x >> 5) * kWarpBuf;
  double* g_sw = scratch;
  double* g_swx = scratch + G;
  double* g_m2 = scratch + 2 * (size_t)G;
  double* acc0 = kPass == 0 ? g_sw : g_m2;
  double* acc1 = g_swx;
  double* s_acc = smem + kWarps * kWarpBuf;  // kVals x G, shared route
  if (kRoute == kShared) {
    for (int g = threadIdx.x; g < kVals * (int)G; g += kThreads)
      s_acc[g] = 0.0;
    __syncthreads();
    acc0 = s_acc;
    acc1 = s_acc + G;
  }
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kThreads;
  // warp-uniform trip count: every lane of a warp takes the same steps
  for (long long base = (long long)blockIdx.x * kThreads + (threadIdx.x & ~31);
       base < N; base += stride) {
    const long long i = base + lane;
    int key = -1;
    double v0 = 0.0, v1 = 0.0;
    if (i < N) {
      const float wi = w[i];
      if (wi != 0.f) {
        key = group_id(cat, i, C, G);
        const float xi = x[i];
        if (kPass == 0) {
          v0 = wi;
          v1 = __fmul_rn(wi, xi);
        } else {
          const float d = __fsub_rn(xi, batch_mean(g_sw, g_swx, key));
          v0 = __fmul_rn(wi, __fmul_rn(d, d));
        }
      }
    }
    warp_add<kVals>(acc0, acc1, key, v0, v1, wbuf);
  }
  if (kRoute == kShared) {
    __syncthreads();
    for (int g = threadIdx.x; g < (int)G; g += kThreads) {
      if (kPass == 0) {
        const double a = s_acc[g], b = s_acc[G + g];
        if (a != 0.0 || b != 0.0) {
          atomicAdd(g_sw + g, a);
          atomicAdd(g_swx + g, b);
        }
      } else {
        const double a = s_acc[g];
        if (a != 0.0) atomicAdd(g_m2 + g, a);
      }
    }
  }
}

// Pass C: the Chan merge, one thread per group, then the scratch set back
// to 0. in_* and out_* may alias (each thread reads its group, then writes
// it).
__global__ void __launch_bounds__(kMergeThreads)
    zscore_merge_kernel(const float* in_count, const float* in_mean,
                        const float* in_m2, float* out_count,
                        float* out_mean, float* out_m2, int G,
                        double* __restrict__ scratch) {
  const int g = blockIdx.x * kMergeThreads + threadIdx.x;
  if (g >= G) return;
  double* sw = scratch;
  double* swx = scratch + G;
  double* sm2 = scratch + 2 * (size_t)G;
  const double sw_d = sw[g], swx_d = swx[g], m2_d = sm2[g];
  const float n_a = in_count[g], mean_a = in_mean[g], m2_a = in_m2[g];
  sw[g] = 0.0;
  swx[g] = 0.0;
  sm2[g] = 0.0;
  if (sw_d == 0.0 && swx_d == 0.0 && m2_d == 0.0) {
    // nothing merged: what the formulas give at n_b = 0, bit for bit
    out_count[g] = n_a;
    out_mean[g] = mean_a;
    out_m2[g] = m2_a;
    return;
  }
  const float n_b = __double2float_rn(sw_d);
  const float b_mean = __fdiv_rn(__double2float_rn(swx_d), fmaxf(n_b, 1.f));
  const float b_m2 = __double2float_rn(m2_d);
  const float n_ab = __fadd_rn(n_a, n_b);
  const float safe_ab = fmaxf(n_ab, 1.f);
  const float delta = __fsub_rn(b_mean, mean_a);
  out_count[g] = n_ab;
  out_mean[g] = __fadd_rn(mean_a, __fmul_rn(delta, __fdiv_rn(n_b, safe_ab)));
  out_m2[g] = __fadd_rn(
      __fadd_rn(m2_a, b_m2),
      __fmul_rn(__fmul_rn(delta, delta),
                __fdiv_rn(__fmul_rn(n_a, n_b), safe_ab)));
}

__global__ void __launch_bounds__(kScoreThreads)
    zscore_score_kernel(const int32_t* __restrict__ cat,
                        const float* __restrict__ x,
                        const float* __restrict__ count,
                        const float* __restrict__ mean,
                        const float* __restrict__ m2, long long N, int C,
                        uint32_t G, float min_count, float* __restrict__ z_out,
                        float* __restrict__ s_out, int* __restrict__ cold,
                        long long n_valid) {
  const long long i = (long long)blockIdx.x * kScoreThreads + threadIdx.x;
  bool is_cold = false;
  if (i < N) {
    const int g = group_id(cat, i, C, G);
    const float cnt = count[g];
    const float var = __fdiv_rn(m2[g], fmaxf(__fsub_rn(cnt, 1.f), 1.f));
    const float sd = __fsqrt_rn(fmaxf(var, 1e-8f));
    float z = __fdiv_rn(fabsf(__fsub_rn(x[i], mean[g])), sd);
    z = cnt >= min_count ? z : 0.f;
    z_out[i] = z;
    if (s_out) s_out[i] = __fsub_rn(1.f, expf(-__fmul_rn(z, 0.25f)));
    is_cold = i < n_valid && z == 0.f;
  }
  if (cold) {
    const unsigned b = __ballot_sync(0xffffffffu, is_cold);
    if ((threadIdx.x & 31) == 0 && b) atomicAdd(cold, __popc(b));
  }
}

// ---- once-per-device launch set-up: the shared-memory attribute, the SM
// count and the CTAs per SM at the last shared-memory size asked for

struct LaunchInfo {
  std::atomic<int> attr_set[kMaxDevices];
  std::atomic<int> sms[kMaxDevices];
  std::atomic<long long> occ[kMaxDevices];  // (smem bytes << 8) | blocks
};

LaunchInfo g_a_shared, g_a_global, g_b_shared, g_b_global;

template <int kPass, int kRoute>
cudaError_t launch_pass(LaunchInfo& info, const int32_t* cat, const float* x,
                        const float* w, long long N, int C, uint32_t G,
                        double* scratch, cudaStream_t stream) {
  auto kernel = zscore_pass_kernel<kPass, kRoute>;
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
    info.sms[dev].store(sms, std::memory_order_relaxed);
    info.attr_set[dev].store(1, std::memory_order_release);
  }
  constexpr int kVals = kPass == 0 ? 2 : 1;
  const long long smem_ll =
      (long long)kWarps * kWarpBuf * 8 +
      (kRoute == kShared ? (long long)kVals * G * 8 : 0);
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
  // at least a span per thread, at most the CTAs the card holds at once
  const long long want = (N + kThreads - 1) / kThreads;
  const long long cap = (long long)per_sm * info.sms[dev].load(
                                                std::memory_order_relaxed);
  const int blocks = (int)(want < cap ? want : cap);
  kernel<<<blocks, kThreads, smem, stream>>>(cat, x, w, N, C, G, scratch);
  return cudaGetLastError();
}

}  // namespace

// K3. cat: (N, C) int32, columns 0 and 1 read; x, w: (N,) f32; the state
// in_* and out_*: (G,) f32 each (may alias); scratch: (3, G) f64, all 0 on
// entry and all 0 again once the call's work has run. route: 0 shared,
// 1 global (the wrapper picks; 0 is refused where 2 x G doubles do not fit
// in shared memory). Shapes are checked by the wrapper.
extern "C" int zscore_update_launch(const void* cat, const void* x,
                                    const void* w, long long N, int C,
                                    int G, const void* in_count,
                                    const void* in_mean, const void* in_m2,
                                    void* out_count, void* out_mean,
                                    void* out_m2, void* scratch, int route,
                                    void* stream) {
  if (N < 0 || C < 2 || G <= 0 || (route != kShared && route != kGlobal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* c = static_cast<const int32_t*>(cat);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  double* s = static_cast<double*>(scratch);
  const uint32_t g = static_cast<uint32_t>(G);
  cudaError_t err = cudaSuccess;
  if (N > 0) {
    err = route == kShared
              ? launch_pass<0, kShared>(g_a_shared, c, xf, wf, N, C, g, s, st)
              : launch_pass<0, kGlobal>(g_a_global, c, xf, wf, N, C, g, s, st);
    if (err != cudaSuccess) return (int)err;
    err = route == kShared
              ? launch_pass<1, kShared>(g_b_shared, c, xf, wf, N, C, g, s, st)
              : launch_pass<1, kGlobal>(g_b_global, c, xf, wf, N, C, g, s, st);
    if (err != cudaSuccess) return (int)err;
  }
  zscore_merge_kernel<<<(G + kMergeThreads - 1) / kMergeThreads,
                        kMergeThreads, 0, st>>>(
      static_cast<const float*>(in_count), static_cast<const float*>(in_mean),
      static_cast<const float*>(in_m2), static_cast<float*>(out_count),
      static_cast<float*>(out_mean), static_cast<float*>(out_m2), G, s);
  return (int)cudaGetLastError();
}

// K4. cat: (N, C) int32; x: (N,) f32; the state (G,) f32 each; z: (N,) f32
// out. s (N,) f32 and cold (one int32, set to 0 by the caller) may be null:
// when given, s gets 1 - exp(-z/4) and cold the count of z == 0 among the
// first n_valid spans.
extern "C" int zscore_score_launch(const void* cat, const void* x,
                                   long long N, int C, int G,
                                   const void* count, const void* mean,
                                   const void* m2, float min_count, void* z,
                                   void* s, void* cold, long long n_valid,
                                   void* stream) {
  if (N < 0 || C < 2 || G <= 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const long long blocks = (N + kScoreThreads - 1) / kScoreThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  zscore_score_kernel<<<(unsigned)blocks, kScoreThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cat), static_cast<const float*>(x),
      static_cast<const float*>(count), static_cast<const float*>(mean),
      static_cast<const float*>(m2), N, C, static_cast<uint32_t>(G),
      min_count, static_cast<float*>(z), static_cast<float*>(s),
      static_cast<int*>(cold), n_valid);
  return (int)cudaGetLastError();
}
