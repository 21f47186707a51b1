// K19: the backward pass of FFN1's tanh GELU, with FFN1's bias gradient —
// for Hopper (sm_90a), f32 (the trainer's working type).
//
// Replaces: the gradient XLA derives for nn.gelu (jax.nn.gelu's default
// tanh form) after FFN1's Dense at odigos_tpu/models/layers.py :79-80 (and
// the autoencoder's dec_ff1, odigos_tpu/models/autoencoder.py:78-79),
// inside the jitted value_and_grad of odigos_tpu/training/trainer.py:171.
// The JAX package has no Pallas kernel here; the trainer's step on the card
// needs a hand-written one.
//
// From the upstream gradient dY and FFN1's pre-activation `pre` (K15's f32
// route writes it beside the GELU output, kernels/dense.py `pre=`), both
// (M, N):
//   dPre = dY * gelu'(pre),
//   gelu'(x) = 0.5 (1 + t) + (0.5 x)(1 - t^2) * C (1 + 3 K x^2),
//   t = tanh(C (x + K x^3)),  C = sqrt(2 / pi),  K = 0.044715,
// in f32 IEEE steps (no contraction into FMAs: the plain version's separate
// ops), and db1 = the column sums of dPre in f64, rounded once, fused into
// the same pass. The sums' order is fixed: each block of 16 rows is a left
// fold of its rows from 0.0, and a column's sum a left fold of its blocks
// in order from 0.0, so a step is reproducible (no float atomics) and db
// is the design before this one's to the bit (tests/test_torch_kernel_
// models.py replays both).
//
// One launch, no float atomics (a step is reproducible). A unit is (a
// block of 16 rows, a group of 128 columns); CTAs of 128 threads, a folder
// a column group first, then producers as many as units up to 8 an SM (at
// the trainer's (2048, 1024) 1024 units, one a CTA, and 8 folders):
// * producers take units grid-strided, block-major (a block's groups
//   together, so the blocks come up about in order): each thread issues
//   its 4 rows' 16-byte loads of dY and pre (8 vectors) before any
//   arithmetic, the CTA claims the unit while they are in flight, computes
//   dPre and stores it (16 bytes), and leaves its values in shared memory;
//   a thread a column then folds the block's 16 rows in order (f64) into
//   the block's partial ((blocks, N) f64) and the CTA raises the (group,
//   block) flag (a release at gpu scope);
// * a folder adds its group's partials in block order as their flags come
//   up (a thread a block's flag, an acquire; the ready prefix by ballots),
//   a thread a column, 32 loads in flight, and rounds db once. The folders' adds run under the producers' streaming
//   instead of after it (a ticketed last CTA folding all of a group's 128
//   partials at the end cost 9 us at the trainer's shape).
// A folder whose next block is not up claims it and produces it itself,
// unless a producer claimed it first; so it waits only on a unit claimed
// by a running CTA, which never waits: the kernel ends whatever room the
// card has for its CTAs (other streams' kernels, a shared card), where a
// folder waiting on a producer that had no room would not.
// The flags and the partials are cached per device and stream
// (kernels/build.py stream_scratch); each flag is set back to zero by the
// later of its unit's owner and its folder, so all are zero between calls.
// The parent design ran two launches: 128 CTAs of 16 rows x 1024 columns
// (fewer than the SMs), each thread's rows one dependent pair of loads at
// a time, then a thread a column over the partials.
//
// Bound on the card: bytes. At the trainer's FFN1 (M 2048, N 1024) the pass
// reads dY and pre (16.8 MB) and writes dPre (8.4 MB): 7.5 us at 3.35
// TB/s, against ~25 flops and a tanh a value; the partials (1 MB written
// and read, in L2) add 0.6 us. The measured times are in PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;                  // rows a block (the fold's unit)
constexpr int kCols = 128;                 // columns a group: a thread each
constexpr int kRowsPerThread = kRows / (kThreads / 32);  // 4: warps x rows
constexpr int kCtasPerSm = 8;              // the grid's cap: SMs x this
constexpr int kMinCtasPerSm = 6;           // resident an SM: <= 80 registers
constexpr int kFoldBatch = 32;             // partials in flight a fold step
constexpr float kGeluC = 0x1.988454p-1f;   // f32(sqrt(2 / pi)), K15's
constexpr float kGeluK = 0x1.6e4e26p-5f;   // f32(0.044715), K15's
constexpr float kGeluK3 = 0x1.12ba9cp-3f;  // f32(3 * kGeluK)
static_assert(kCols == kThreads && kCols == 4 * 32, "a warp a row");

// gelu'(x) for jax.nn.gelu's tanh form, IEEE steps
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  const float inner = __fmul_rn(kGeluC, __fadd_rn(x, __fmul_rn(kGeluK, x3)));
  const float t = tanhf(inner);
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, t));
  const float pdf =
      __fmul_rn(__fmul_rn(0.5f, x), __fsub_rn(1.0f, __fmul_rn(t, t)));
  const float dinner =
      __fmul_rn(kGeluC, __fadd_rn(1.0f, __fmul_rn(kGeluK3, x2)));
  return __fadd_rn(cdf, __fmul_rn(pdf, dinner));
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// A unit's flag, bits set by atomic ORs: kClaim (the CTA producing it has
// it), kDone (its partial written, released), kOwner (its producer CTA
// came to it, once), kFolded (its folder added it, once). Of the owner and
// the folder, the one whose OR finds the other's bit sets the flag back to
// 0: after both, neither touches it again in this call.
constexpr int kClaim = 1;
constexpr int kDone = 2;
constexpr int kOwner = 4;
constexpr int kFolded = 8;

// Unit (block b, column group grp): dPre stored, the block's 16 rows folded
// in order (f64) into its partial, kDone raised. As the unit's `owner` the
// CTA first claims it while its loads are in flight, and leaves it to the
// folder that claimed it first. CTA-uniform (it holds barriers); it never
// waits on another CTA.
__device__ __forceinline__ void produce(long long b, int grp, bool owner,
                                        long long M, int N, long long blocks,
                                        const float* __restrict__ dy,
                                        const float* __restrict__ pre,
                                        float* __restrict__ dpre,
                                        int* __restrict__ flags,
                                        double* __restrict__ part,
                                        float4 (*s_r)[kCols / 4], int* s_won) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long m0 = b * kRows;
  const int rows = (int)min((long long)kRows, M - m0);
  const int n0 = grp * kCols + 4 * lane;  // this thread's 4 columns
  const bool cols = n0 < N;               // N % 4 == 0: all 4 or none
  int* flag = flags + grp * blocks + b;
  // rows warp + 4 i of the block: every load first
  float4 g[kRowsPerThread], x[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = warp + 4 * i;
    g[i] = x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (cols && r < rows) {
      const long long o = (m0 + r) * N + n0;
      g[i] = __ldg(reinterpret_cast<const float4*>(dy + o));
      x[i] = __ldg(reinterpret_cast<const float4*>(pre + o));
    }
  }
  if (owner) {
    if (tid == 0) {
      const int old = atomicOr(flag, kOwner | kClaim);
      *s_won = !(old & kClaim);
      if (old & kFolded) *flag = 0;  // the folder is past it
    }
    __syncthreads();
    if (!*s_won) {   // CTA-uniform: a folder produces it
      __syncthreads();  // s_won read before the next unit writes it
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = warp + 4 * i;
    float4 v;
    v.x = __fmul_rn(g[i].x, gelu_tanh_grad(x[i].x));
    v.y = __fmul_rn(g[i].y, gelu_tanh_grad(x[i].y));
    v.z = __fmul_rn(g[i].z, gelu_tanh_grad(x[i].z));
    v.w = __fmul_rn(g[i].w, gelu_tanh_grad(x[i].w));
    if (cols && r < rows)
      *reinterpret_cast<float4*>(dpre + (m0 + r) * N + n0) = v;
    s_r[r][lane] = v;
  }
  __syncthreads();
  // the block's fold, a thread a column: its rows in order from 0.0
  const int n = grp * kCols + tid;
  if (n < N) {
    const float* col = reinterpret_cast<const float*>(s_r) + tid;
    double acc = 0.0;
    for (int r = 0; r < rows; ++r) acc += (double)col[r * kCols];
    part[b * N + n] = acc;
  }
  // the block's flag, after every partial of it (bar.sync, then a
  // release at gpu scope); s_r and s_won free again for the next unit
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    atomicOr(flag, kDone);  // after the fence: a release
  }
}

// flags: (groups, blocks) int32, zero between calls (each left so by its
// owner or its folder); part: the (blocks, N) f64 partials. CTAs
// [0, groups) fold, the others own units grid-strided.
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
gelu_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ pre,
                long long M, int N, float* __restrict__ dpre,
                float* __restrict__ db, int* __restrict__ flags,
                double* __restrict__ part) {
  __shared__ float4 s_r[kRows][kCols / 4];  // a block's dPre values
  __shared__ int s_won;
  __shared__ int s_first[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long blocks = (M + kRows - 1) / kRows;
  const int groups = (N + kCols - 1) / kCols;
  const long long units = blocks * groups;

  if ((int)blockIdx.x >= groups) {
    // units block-major (a block's groups together), so the blocks of a
    // group come up about in order, as its folder takes them
    const long long producers = gridDim.x - groups;
    for (long long u = blockIdx.x - groups; u < units; u += producers) {
      const long long b = u / groups;
      produce(b, (int)(u - b * groups), true, M, N, blocks, dy, pre, dpre,
              flags, part, s_r, &s_won);
    }
    return;
  }
  // a folder: group grp's blocks added in order as their flags come up
  // (thread t watches block b0 + t's)
  const int grp = blockIdx.x;
  const int n = grp * kCols + tid;
  int* fl = flags + grp * blocks;
  long long tried = 0;  // blocks below this: claimed once, or tried
  double s = 0.0;
  for (long long b0 = 0; b0 < blocks;) {
    const bool ready =
        b0 + tid < blocks && (load_acquire(fl + b0 + tid) & kDone);
    const unsigned late = __ballot_sync(0xffffffffu, !ready);
    if (lane == 0) s_first[warp] = late ? __ffs(late) - 1 : 32;
    __syncthreads();  // the flags read; the partials they release visible
    int len = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const int f = s_first[w];
      len += len == 32 * w ? f : 0;
    }
    __syncthreads();  // s_first read before the next round writes it
    if (len == 0) {   // CTA-uniform
      if (tried <= b0) {
        // block b0 once: claim it and produce it here, or its claim is a
        // running CTA's (which never waits), or it is done
        tried = b0 + 1;
        if (tid == 0) s_won = !(atomicOr(fl + b0, kClaim) & kClaim);
        __syncthreads();
        const bool won = s_won;
        __syncthreads();
        if (won) {
          produce(b0, grp, false, M, N, blocks, dy, pre, dpre, flags, part,
                  s_r, &s_won);
          continue;
        }
      }
      __nanosleep(128);
      continue;
    }
    if (tid < len && (atomicOr(fl + b0 + tid, kFolded) & kOwner))
      fl[b0 + tid] = 0;  // its owner came to it before
    if (n < N) {
      for (int p0 = 0; p0 < len; p0 += kFoldBatch) {
        double v[kFoldBatch];
#pragma unroll
        for (int p = 0; p < kFoldBatch; ++p)
          v[p] = p0 + p < len ? __ldcg(part + (b0 + p0 + p) * N + n) : 0.0;
#pragma unroll
        for (int p = 0; p < kFoldBatch; ++p)
          if (p0 + p < len) s += v[p];
      }
    }
    b0 += len;
  }
  if (n < N) db[n] = (float)s;
}

}  // namespace

// The f64 partials gelu_tanh_bwd_launch needs at (M, N): a row of N a
// block of 16 rows.
extern "C" long long gelu_bwd_scratch(long long M, int N) {
  if (M < 0 || N < 0) return -1;
  return (M + kRows - 1) / kRows * (long long)N;
}

// The int32 flags it needs at (M, N): one a (column group, block).
extern "C" long long gelu_bwd_flags(long long M, int N) {
  if (M < 0 || N < 0) return -1;
  return (M + kRows - 1) / kRows * (long long)((N + kCols - 1) / kCols);
}

// dy, pre, dpre: (M, N) f32, 16-byte aligned, N % 4 == 0; db: (N,) f32;
// flags: gelu_bwd_flags(M, N) int32, zero before their first use and left
// so by every call (one set a stream); part: gelu_bwd_scratch(M, N) f64.
// sms: the card's multiprocessors. *launched gets the kernels launched
// (1, or 0 where nothing was).
extern "C" int gelu_tanh_bwd_launch(const void* dy, const void* pre,
                                    long long M, int N, void* dpre, void* db,
                                    void* flags, void* part, int sms,
                                    int* launched, void* stream) {
  *launched = 0;
  const long long groups = (N + kCols - 1) / kCols;
  const long long units = (M + kRows - 1) / kRows * groups;
  if (M <= 0 || N <= 0 || N % 4 != 0 || sms < 1 ||
      (M + kRows - 1) / kRows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long cap = (long long)sms * kCtasPerSm;
  // a folder a column group, then the producers
  const unsigned grid = (unsigned)(groups + (units < cap ? units : cap));
  gelu_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<const float*>(pre), M, N,
      static_cast<float*>(dpre), static_cast<float*>(db),
      static_cast<int*>(flags), static_cast<double*>(part));
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) *launched = 1;
  return (int)e;
}
