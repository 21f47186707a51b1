// K14 and K15: the float encoder block's dense chain — for Hopper (sm_90a).
//
// Replaces the LN/GEMM/GELU/residual chain of odigos_tpu/models/layers.py
// EncoderBlock.__call__ (:68-81) and the decoder's dec_ff1 -> gelu ->
// dec_ff2 of odigos_tpu/models/autoencoder.py (:78-80): everything of the
// block but the attention (K1).
//
// K14 ln_bf16: Flax's LayerNorm(dtype) over the last dimension, any d %
// 8 == 0 from 8 to 1024 (the models' d_model, kernels/coverage.py). Every
// load and store is a 16-byte vector: a row lives on the d / 8 (bf16; f32:
// d / 4) lanes of a group rounded up to a power of two, so a warp holds 32
// / G rows at d <= 128 (bf16) and each row's shuffle trees are log2 G
// deep; up to 128 vectors a row (every bf16 width) the group is the warp
// (up to 4 vectors a lane), past that (f32 past d 512) one CTA takes a row
// (vectors spread over 256 threads, the sums through shared memory). The
// grid is persistent (SMs x the CTAs an SM holds) and each warp issues its
// next rows' loads before reducing the current ones. With a device row
// count (live, per) the rows at or past live[0] * per are neither read nor
// written: the fused routes' padding rows, with no host sync. The
// arithmetic is ln_exact.cuh's (f64 row sums rounded once, IEEE steps,
// the result rounded to the working type), so the plain version (torch's
// f64 sums) gives the same bits where both f64 sums are exact: the
// values' sum is exact when their binade spread + log2(d) + 8 (bf16; f32:
// + 24) <= 53, i.e. a spread of 35 binades at d 1024 in bf16; the squared
// deviations are f32 values, exact while their spread + log2(d) + 24 <=
// 53 (19 binades at d 1024). Past that each sum may round in f64 (a
// relative 2^-53 before the f32 rounding), and kernel and plain may differ
// by one step of the output type (tests/test_torch_dense.py holds the
// plain version there). Bound: bytes (the row read once, written once).
//
// K15 gemm_bf16: out = epilogue(x . w^T + b), x (M, K) and w (N, K) both
// K-major (the Linear layout), b (N,), all in the working type, f32
// accumulators, then Flax's rounding points (Dense(dtype) returns the
// working type from its dot_general, then adds the bias in it):
//   mode 0 "none"      round(round(acc) + b)                (q, k, v)
//   mode 1 "residual"  round(res + round(round(acc) + b))   (out, FFN2)
//   mode 2 "gelu_tanh" round(gelu(round(round(acc) + b)))  (FFN1)
//   mode 4 "partial"   acc, in f32, no bias  (a row-parallel product's
//                      share on one rank of the "model" axis: out, FFN2)
// with gelu the tanh form of jax.nn.gelu in f32 (K10's gelu_tanh, IEEE
// steps, tanhf) and the adds bf16x2 adds (correctly rounded, equal to the
// plain version's f32 add then round). The output is written in `planes`
// contiguous planes of N / planes columns, so the fused QKV product
// (N = 3d) leaves q, k and v each contiguous for K1. With a device row
// count (the fused routes' real rows, as K14 takes it) the walk covers
// only the row tiles that hold a real row: the padding tiles past them are
// neither read nor written, so their time and their contents (whatever
// the allocator left, which the GELU's rare-value path would otherwise
// meet) do not reach the launch.
//
// bf16 design (the serving path): wgmma.mma_async m64n128k16 bf16 -> f32
// with both operands in shared memory under the 128-byte swizzle, loaded
// by TMA (cp.async.bulk.tensor, zero fill past M, N and K). A persistent
// CTA (one per SM, up to 225 KB of shared memory) holds two consumer
// warpgroups, each computing whole 128 x 128 tiles (two m64 accumulators,
// 128 registers) from its own mbarrier ring (2 to 4 stages), filled by
// its own producer warp (one lane issues the TMA loads), with one wgmma
// group kept in flight. The CTA's tiles alternate between the warpgroups
// (ping-pong), so one warpgroup's epilogue overlaps the other's products.
// Where K <= 256 the walk is weight-stationary: a CTA keeps one column
// tile's W slice resident and walks row tiles, so only A streams through
// L2 (half the traffic of reloading both at K = 256); deeper K streams A
// and W tiles, N fastest. The epilogue takes the bias from shared memory,
// the residual from the staging buffer (loaded there by TMA) and the GELU
// from a shared table of the formula's own bf16 results (see gelu_index);
// it rounds in registers, writes the tile into shared memory as
// 128-byte-swizzled 64-column boxes (conflict-free), and one thread
// stores them with the TMA (rows past M and columns past N clipped). All
// offsets are 64-bit: the autoencoder's fused route reaches M = 8.1 M
// rows, M x 512 outputs past 2^32 elements.
// The f32 route (the f32 model on the card, the trainers' forward) is
// gemm_f32.cu's, on the CUDA cores.
//
// Bound on the card: bytes at these widths. At M = 131072 tokens, d 256:
// QKV (N 768, K 256) reads 67 MB and writes 201 MB (0.080 ms at 3.35 TB/s)
// for 51.5 GFLOP (0.052 ms at 989 TFLOP/s); FFN1 (N 1024) 67 + 268 MB
// (0.100 ms); FFN2 (K 1024, + residual) 268 + 67 + 67 MB (0.120 ms).
// Measured times are in PERF.md.
//
// Mode 4 writes the warpgroup's accumulators straight from registers as
// 8-byte f32 pairs (a quad of lanes covers 32 contiguous bytes of a row):
// no rounding, no bias, no staging. Its sum over the ranks of the
// "model" axis is all-reduced in f32, then K23 rounds it.
//
// K23 tp_epilogue: Flax's rounding chain on the all-reduced partials of a
// row-parallel product, out = round(res + round(round(acc) + b)) (or
// round(round(acc) + b) without a residual) in the working type, with
// K15's own pair arithmetic (epi_bf16x2 modes 1 and 0; f32: __fadd_rn),
// so that at tp = 1 K23 of a whole "partial" product gives K15's bits.
// One pass over (M, N): a thread takes 8 bf16 (or 4 f32) outputs a step,
// every load and store a 16-byte vector, grid-stride. Bound: bytes. At
// the served R 2048, L 64, d 256 (bf16): 134 MB of partials, 33.5 MB of
// residual read and 33.5 MB written: 0.060 ms at 3.35 TB/s.
//
// The TMA descriptors are encoded on the host for every launch with the
// driver's cuTensorMapEncodeTiled, fetched through the runtime's
// cudaGetDriverEntryPoint: no link against libcuda.

#include <cuda.h>  // CUtensorMap and its enums; the entry point is fetched
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ln_exact.cuh"
#include "tc_common.cuh"  // mbarriers, TMA, staging, GELU table, maps

namespace {

// ------------------------------------------------------------------- K14
// (16-byte vectors, group sums, the row count and the persistent grid are
// ln_exact.cuh's, shared with K8 and K12)
constexpr int kLnThreads = 256;
constexpr int kLnWarps = kLnThreads / 32;

// A row of d values on G lanes of a warp (32 / G rows a warp at once),
// lane sub holding the 16-byte vectors sub, sub + G, ... (NV of them; those
// at or past d / EPV are idle). Persistent: the grid is as many CTAs as
// the SMs hold, each warp walking its rows with the next rows' loads
// issued before the current ones are reduced.
template <typename T, int G, int NV>
__global__ void __launch_bounds__(kLnThreads) ln_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, float eps, long long rows, int d,
    const int* __restrict__ live, int per, T* __restrict__ out) {
  constexpr int EPV = Vec<T>::EPV;
  constexpr int RW = 32 / G;  // rows a warp at once
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  const int nvec = d / EPV;
  const long long lim = ln_row_limit(rows, live, per);
  const float inv_d = inv_pow2(d);
  float g[NV][EPV], b[NV][EPV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int vi = j * G + sub;
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      const bool in = vi < nvec;
      g[j][e] = in ? __ldg(gamma + vi * EPV + e) : 0.f;
      b[j][e] = in ? __ldg(beta + vi * EPV + e) : 0.f;
    }
  }
  const long long stride = (long long)gridDim.x * kLnWarps * RW;
  long long r = ((long long)blockIdx.x * kLnWarps + (threadIdx.x >> 5)) * RW +
                lane / G;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  uint4 cur[NV], nxt[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (r < lim && j * G + sub < nvec)
      cur[j] = __ldg(xv + r * nvec + j * G + sub);
  // warp-uniform walk: a group past the limit idles through the shuffles
  for (long long r0 = r - lane / G; r0 < lim; r0 += stride, r += stride) {
    const long long rn = r + stride;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (rn < lim && j * G + sub < nvec)
        nxt[j] = __ldg(xv + rn * nvec + j * G + sub);
    const bool mine = r < lim;
    float v[NV][EPV], mean, rstd;
#pragma unroll
    for (int j = 0; j < NV; ++j) unpack(cur[j], v[j]);
    group_ln_stats<G>(v, sub, nvec, d, inv_d, eps, &mean, &rstd);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!mine || j * G + sub >= nvec) continue;
      float y[EPV];
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        y[e] = ln_out(v[j][e], mean, rstd, g[j][e], b[j][e], x);
      ov[r * nvec + j * G + sub] = pack(y);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
  }
}

// A row wider than a warp's registers (more than 128 vectors: f32 past d
// 512): one CTA a row, thread t holding the vectors t, t + 256, ... (NV of
// them), the
// row's sums through shared memory; persistent, the next row's loads
// issued before the current one is reduced.
template <typename T, int NV>
__global__ void __launch_bounds__(kLnThreads) ln_wide_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, float eps, long long rows, int d,
    const int* __restrict__ live, int per, T* __restrict__ out) {
  constexpr int EPV = Vec<T>::EPV;
  __shared__ double s_part[2][kLnWarps];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nvec = d / EPV;
  const long long lim = ln_row_limit(rows, live, per);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  uint4 cur[NV], nxt[NV];
  long long r = blockIdx.x;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (r < lim && j * kLnThreads + tid < nvec)
      cur[j] = __ldg(xv + r * nvec + j * kLnThreads + tid);
  for (; r < lim; r += gridDim.x) {  // block-uniform
    const long long rn = r + gridDim.x;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (rn < lim && j * kLnThreads + tid < nvec)
        nxt[j] = __ldg(xv + rn * nvec + j * kLnThreads + tid);
    float v[NV][EPV];
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      unpack(cur[j], v[j]);
      if (j * kLnThreads + tid < nvec) {
#pragma unroll
        for (int e = 0; e < EPV; ++e) s += (double)v[j][e];
      }
    }
    s = warp_sum(s);
    if (lane == 0) s_part[0][wid] = s;
    __syncthreads();
    s = 0.0;
#pragma unroll
    for (int w = 0; w < kLnWarps; ++w) s += s_part[0][w];
    const float mean = __fdiv_rn((float)s, (float)d);
    double q = 0.0;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (j * kLnThreads + tid < nvec) {
#pragma unroll
        for (int e = 0; e < EPV; ++e) q += ln_sq_dev(v[j][e], mean);
      }
    q = warp_sum(q);
    if (lane == 0) s_part[1][wid] = q;
    __syncthreads();
    q = 0.0;
#pragma unroll
    for (int w = 0; w < kLnWarps; ++w) q += s_part[1][w];
    const float var = __fdiv_rn((float)q, (float)d);
    const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int vi = j * kLnThreads + tid;
      if (vi >= nvec) continue;
      float y[EPV];
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        y[e] = ln_out(v[j][e], mean, rstd, __ldg(gamma + vi * EPV + e),
                      __ldg(beta + vi * EPV + e), x);
      ov[r * nvec + vi] = pack(y);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
    __syncthreads();  // s_part is rewritten by the next row
  }
}

template <typename K, typename T>
cudaError_t ln_go(K kernel, int (&cache)[kMaxDevices], const T* x,
                  const float* g, const float* b, float eps, long long rows,
                  int d, const int* live, int per, T* out, long long units,
                  cudaStream_t st) {
  int grid = 0;
  cudaError_t e = persistent_grid(kernel, kLnThreads, cache, &grid);
  if (e != cudaSuccess) return e;
  if (units < grid) grid = (int)(units > 0 ? units : 1);
  kernel<<<grid, kLnThreads, 0, st>>>(x, g, b, eps, rows, d, live, per, out);
  return cudaGetLastError();
}

#define LN_ROWS(G_, NV_)                                                    \
  {                                                                         \
    static int cache[kMaxDevices];                                          \
    constexpr long long slots = kLnWarps * (32 / (G_));                     \
    return ln_go(ln_rows_kernel<T, G_, NV_>, cache, x, g, b, eps, rows, d,  \
                 live, per, out, (rows + slots - 1) / slots, st);           \
  }

// d % 8 == 0, 8 <= d <= 1024: the group of lanes a row and the vectors a
// lane, or (f32 past d 512) one CTA a row
template <typename T>
cudaError_t ln_launch_t(const T* x, const float* g, const float* b, float eps,
                        long long rows, int d, const int* live, int per,
                        T* out, cudaStream_t st) {
  const int nvec = d / Vec<T>::EPV;
  if (nvec <= 1) LN_ROWS(1, 1)
  if (nvec <= 2) LN_ROWS(2, 1)
  if (nvec <= 4) LN_ROWS(4, 1)
  if (nvec <= 8) LN_ROWS(8, 1)
  if (nvec <= 16) LN_ROWS(16, 1)
  if (nvec <= 32) LN_ROWS(32, 1)
  if (nvec <= 64) LN_ROWS(32, 2)
  if (nvec <= 128) LN_ROWS(32, 4)
  // past 128 vectors only f32 reaches here (d <= 1024: 256 vectors)
  if constexpr (Vec<T>::EPV == 4) {
    static int c1[kMaxDevices];
    if (nvec <= kLnThreads)
      return ln_go(ln_wide_kernel<T, 1>, c1, x, g, b, eps, rows, d, live,
                   per, out, rows, st);
  }
  return cudaErrorInvalidValue;
}
#undef LN_ROWS

// ------------------------------------------------------- K15 epilogue
// (the GELU table, of the formula's own bf16 results, is tc_common.cuh's)
//
// Two neighbouring columns at once. A bf16x2 add of two bf16 pairs is the
// exact sum rounded once, which equals the plain version's f32 add then
// round (the f32 sum of two bf16 values is exact unless their exponents
// are more than 16 apart, and then both roundings return the larger).
// MODE 2's GELU is looked up by the caller; MODE 3 evaluates the same
// formula per output (kept to hold the table to it).
template <int MODE>
__device__ __forceinline__ __nv_bfloat162 epi_bf16x2(float a0, float a1,
                                                     __nv_bfloat162 b,
                                                     __nv_bfloat162 r) {
  // round(round(acc) + b)
  __nv_bfloat162 y = __hadd2(__floats2bfloat162_rn(a0, a1), b);
  if constexpr (MODE == 3) {  // round(gelu(y)), gelu in f32
    const float2 f = __bfloat1622float2(y);
    y = __floats2bfloat162_rn(gelu_tanh(f.x), gelu_tanh(f.y));
  }
  if constexpr (MODE == 1) y = __hadd2(r, y);  // round(res + y)
  return y;
}

// ------------------------------------------- K15 bf16: wgmma + TMA route
constexpr int BM = 128;  // rows of a tile: one consumer warpgroup's
constexpr int BN = 128;
constexpr int BK = 64;  // 128 bytes of bf16: one 128-byte swizzle row
constexpr int kConsumerWgs = 2;
constexpr int kTcThreads = 160 * kConsumerWgs;  // + a producer warp each
constexpr int kTileA = BM * BK * 2;
constexpr int kTileB = BN * BK * 2;
constexpr int kMaxStages = 4;
// Weight-stationary walk (K <= kWsMaxK): the CTA keeps its BN x K slice of
// W resident and its ring stages hold A tiles only.
constexpr int kWsMaxK = 256;
constexpr int kWsSlice = kWsMaxK / BK * kTileB;

// Shared memory of one build (227 KB at most): each warpgroup's ring of
// kStages stages (streaming: an A and a W tile each; weight-stationary: an
// A tile each, the W slice beside) and its output staging, half a tile
// (two 64 x 64 boxes, stored and refilled twice a tile: a residual's
// second half is loaded in between, hidden behind the other warpgroup's
// products) or, for the weight-stationary residual steps, whose short
// products would not hide that load, a whole 128-row tile. Half-tile
// staging leaves room for deeper rings (4 or 3 stages) or the GELU table
// (32 KB); then the bias pairs.
template <int MODE, bool WS>
struct TcCfg {
  static constexpr bool kHalf = !(WS && MODE == 1);
  static constexpr int kStages =
      WS ? (MODE == 0 || MODE == 4 ? 4 : 3) : (MODE < 2 || MODE == 4 ? 3 : 2);
  static constexpr int kStageBytes = WS ? kTileA : kTileA + kTileB;
  static constexpr int kBoxRows = kHalf ? BM / 2 : BM;
  static constexpr int kBoxBytes = kBoxRows * 64 * 2;  // rows x 64 columns
  static constexpr int kWgBytes = kStages * kStageBytes + 2 * kBoxBytes;
  static constexpr int kMain = (WS ? kWsSlice : 0) + kConsumerWgs * kWgBytes;
  static constexpr int kTab = MODE == 2 || MODE == 3 ? kGeluEntries * 2 : 0;
  static constexpr int kSmem = 1024 + kMain + kTab + kConsumerWgs * BN * 2;
  static_assert(kStages <= kMaxStages, "barrier arrays");
  static_assert(kSmem + 256 <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// One warpgroup's 64 rows x 128 columns through the epilogue into the
// staging buffer (staged_pair, tc_common.cuh); bias2[j] is the bias pair
// of the thread's columns 8 j + 2 (lane % 4) + {0, 1}.
// MODE 2 stages the table's results and notes whether any of its values
// is rare; a thread that has one runs its outputs again, the formula on
// the rare ones alone (a branch around the whole pass, rarely taken). The
// rows go in chunks of kChunk column groups: every shared-memory load of a
// chunk (the residual, the table) is issued before its stores, so the
// loads' latency overlaps instead of waiting behind each store.
template <int MODE, int ROWS>
__device__ __forceinline__ void epilogue_rows(
    const float (&acc)[64], int r0, uint8_t* __restrict__ buf,
    const __nv_bfloat162 (&bias2)[BN / 8],
    const uint16_t* __restrict__ tab) {
  constexpr int kChunk = 4;
  const int lane = threadIdx.x & 31;
  const int rw = r0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  bool rare = false;
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += kChunk) {
    uint32_t v[kChunk][2];
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + jj;
        __nv_bfloat162 r2 = __floats2bfloat162_rn(0.f, 0.f);
        if constexpr (MODE == 1)  // the residual, staged by TMA
          r2 = *staged_pair<ROWS>(buf, j, rw + 8 * h, lane);
        const __nv_bfloat162 y = epi_bf16x2<MODE>(
            acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], bias2[j], r2);
        v[jj][h] = *reinterpret_cast<const uint32_t*>(&y);
      }
    }
    if constexpr (MODE == 2) {
      uint32_t lo[kChunk][2], hi[kChunk][2];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rare |= gelu_rare(v[jj][h] & 0xFFFFu) | gelu_rare(v[jj][h] >> 16);
          lo[jj][h] = tab[gelu_index(v[jj][h] & 0xFFFFu)];
          hi[jj][h] = tab[gelu_index(v[jj][h] >> 16)];
        }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) v[jj][h] = lo[jj][h] | (hi[jj][h] << 16);
    }
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(
            staged_pair<ROWS>(buf, j0 + jj, rw + 8 * h, lane)) = v[jj][h];
  }
  if constexpr (MODE == 2) {
    if (rare) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 y = epi_bf16x2<0>(
              acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], bias2[j], bias2[j]);
          const uint32_t v = *reinterpret_cast<const uint32_t*>(&y);
          uint16_t* e = reinterpret_cast<uint16_t*>(
              staged_pair<ROWS>(buf, j, rw + 8 * h, lane));
          if (gelu_rare(v & 0xFFFFu)) e[0] = gelu_formula_bits(v & 0xFFFFu);
          if (gelu_rare(v >> 16)) e[1] = gelu_formula_bits(v >> 16);
        }
      }
    }
  }
}

// Mode 4: one warpgroup's 64 rows x 128 columns of f32 accumulators
// stored as they are, each thread's column pairs as 8-byte stores (rows
// past M and columns past N skipped; N % 8 == 0, so a pair is in or out).
__device__ __forceinline__ void store_partial(const float (&acc)[64],
                                              long long row0, int n0,
                                              long long M, int N,
                                              float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long rw = row0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = rw + 8 * h;
    if (r >= M) continue;
    float* row = out + r * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (lane & 3);
      if (c < N)
        *reinterpret_cast<float2*>(row + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// Persistent; each CTA's tiles alternate between its two consumer
// warpgroups (ping-pong: one warpgroup's epilogue overlaps the other's
// products). Each warpgroup has its own ring of stages, filled by its own
// producer warp: with one shared ring a warpgroup could wait on a stage
// two phases ahead of its barrier, where the phase parity no longer tells
// them apart. The walk:
//   WS     the CTA owns column tile blockIdx.x % n_tiles, whose W slice
//          (BN x K, K <= kWsMaxK) it loads once, and row tiles
//          blockIdx.x / n_tiles + i * groups; the n_tiles CTAs of a row
//          group read the same A rows at about the same time, so A comes
//          from L2 once per column tile and W not at all: half the L2
//          traffic of the streaming walk at K = 256, and the room a W tile
//          took goes to deeper A rings (the loads are latency-bound: what
//          is in flight sets their rate);
//   else   tiles blockIdx.x, + gridDim.x, ... in the flat (m, n) order, N
//          fastest, each stage holding an A and a W tile.
// The consumer keeps one wgmma group in flight (wait_group 1) and frees a
// stage one step after its products were issued. The epilogue takes the
// bias from shared memory (staged once a tile) and, in residual mode, the
// residual tile from the staging buffer, loaded there by TMA while the
// tile's products run. With a row count (live, per), the walk stops at
// the last row tile that holds a row below live[0] * per: the tiles past
// it are neither read nor written.
template <int MODE, bool WS>
__global__ void __launch_bounds__(kTcThreads, 1) gemm_tc_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_out,
    const __grid_constant__ CUtensorMap map_res,
    const __nv_bfloat16* __restrict__ bias, long long M, int N, int K,
    int plane_cols, int n_tiles, long long m_tiles,
    const int* __restrict__ live, int per, float* __restrict__ out_f32) {
  using C = TcCfg<MODE, WS>;
  constexpr int S = C::kStages;
  constexpr int kStageBytes = C::kStageBytes;
  constexpr int ROWS = C::kBoxRows;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bars[kConsumerWgs][kMaxStages];
  __shared__ __align__(8) uint64_t empty_bars[kConsumerWgs][kMaxStages];
  __shared__ __align__(8) uint64_t res_bars[kConsumerWgs];
  __shared__ __align__(8) uint64_t w_bar;
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the rings to it
  uint8_t* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint16_t* gelu_tab = reinterpret_cast<uint16_t*>(smem + C::kMain);
  auto* bias_smem =
      reinterpret_cast<__nv_bfloat162*>(smem + C::kMain + C::kTab);
  const int ktiles = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int g = 0; g < kConsumerWgs; ++g) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        mbar_init(&full_bars[g][s], 1);
        mbar_init(&empty_bars[g][s], 4);  // the warpgroup's four warps
      }
      mbar_init(&res_bars[g], 1);
    }
    mbar_init(&w_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (MODE == 2) gelu_table_fill(gelu_tab);
  __syncthreads();

  // warpgroup wg's ring, staging buffer and tiles (its producer warp is
  // warp 4 * kConsumerWgs + wg)
  const int wg = warp < 4 * kConsumerWgs ? warp >> 2
                                         : warp - 4 * kConsumerWgs;
  uint8_t* wslice = smem;  // WS: the CTA's W slice, ktiles boxes
  uint8_t* ring = smem + (WS ? kWsSlice : 0) + wg * C::kWgBytes;
  uint8_t* out_buf = ring + S * kStageBytes;
  uint64_t* full = full_bars[wg];
  uint64_t* empty = empty_bars[wg];
  // the walk: tile q of the warpgroup's is (q / n_tiles, q % n_tiles) in
  // the flat order, or (q, ws_col) for the weight-stationary walk
  const long long stride = WS ? gridDim.x / n_tiles : gridDim.x;
  const long long first =
      (WS ? blockIdx.x / n_tiles : blockIdx.x) + wg * stride;
  const long long step = kConsumerWgs * stride;
  const long long live_tiles = live_row_tiles(live, per, M, BM, m_tiles);
  const long long limit = WS ? live_tiles : live_tiles * n_tiles;
  const int ws_col = WS ? (int)(blockIdx.x % n_tiles) : 0;

  if (warp >= 4 * kConsumerWgs) {  // a producer warp: one lane loads
    if (lane == 0) {
      // warpgroup 0 has a tile whenever warpgroup 1 has one, so its
      // producer loads the slice for both (none past the row count)
      if (WS && wg == 0 && first < limit) {
        mbar_expect_tx(&w_bar, ktiles * kTileB);
        for (int kt = 0; kt < ktiles; ++kt)
          tma_load_2d(wslice + kt * kTileB, &map_w, kt * BK, ws_col * BN,
                      &w_bar);
      }
      long long it = 0;
      for (long long q = first; q < limit; q += step) {
        const int m0 = (int)(WS ? q : q / n_tiles) * BM;
        const int n0 = (WS ? ws_col : (int)(q % n_tiles)) * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = (int)(it % S);
          if (it >= S) mbar_wait(&empty[s], (int)((it / S - 1) & 1));
          uint8_t* st = ring + s * kStageBytes;
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_2d(st, &map_x, kt * BK, m0, &full[s]);
          if constexpr (!WS)
            tma_load_2d(st + kTileA, &map_w, kt * BK, n0, &full[s]);
        }
      }
    }
    return;
  }

  const bool leader = (threadIdx.x & 127) == 0;
  __nv_bfloat162* s_bias = bias_smem + wg * (BN / 2);
  if (WS && first < limit) mbar_wait(&w_bar, 0);
  long long it = 0;
  int res_phase = 0;  // residual loads waited for so far: their parity
  for (long long q = first; q < limit; q += step) {
    const long long m0 = (WS ? q : q / n_tiles) * BM;
    const int n0 = (WS ? ws_col : (int)(q % n_tiles)) * BN;
    float acc0[64], acc1[64];  // tile rows [0, 64) and [64, 128)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = (int)(it % S);
      mbar_wait(&full[s], (int)((it / S) & 1));
      const uint32_t a = smem_u32(ring + s * kStageBytes);
      const uint32_t b =
          WS ? smem_u32(wslice + kt * kTileB) : a + kTileA;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // 32 bytes along the swizzle
        const uint64_t db = sw128_desc(b + kk * 32);
        wgmma_m64n128k16(acc0, sw128_desc(a + kk * 32), db);
        wgmma_m64n128k16(acc1, sw128_desc(a + 64 * 128 + kk * 32), db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (MODE == 1 && kt == 0 && leader)
        // the residual's (first) rows into the staging buffer, once the
        // last tile's store has read it (rows past M arrive as zeroes)
        load_residual<C::kBoxBytes>(&map_res, out_buf, m0, n0, N,
                                    &res_bars[wg]);
      __syncwarp();
      if (kt > 0) {  // the previous step's products are done: free it
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % S]);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % S]);
    if constexpr (MODE == 4) {  // the shard's partial product, unrounded
      store_partial(acc0, m0, n0, M, N, out_f32);
      store_partial(acc1, m0 + 64, n0, M, N, out_f32);
      continue;
    }

    // the staging buffer is free once the last store has read it
    if (MODE != 1 && leader)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    {  // the tile's bias pairs, once (N % 8 == 0: a pair is in or out)
      const int t = threadIdx.x & 127;
      if (t < BN / 2) {
        const int n = n0 + 2 * t;
        s_bias[t] = n < N
                        ? *reinterpret_cast<const __nv_bfloat162*>(bias + n)
                        : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
    wg_sync(1 + wg);
    __nv_bfloat162 bias2[BN / 8];  // this thread's column pairs
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) bias2[j] = s_bias[j * 4 + (lane & 3)];
    if constexpr (MODE == 1) mbar_wait(&res_bars[wg], res_phase++ & 1);
    if constexpr (C::kHalf) {  // rows [0, 64), stored; then [64, 128)
      epilogue_rows<MODE, ROWS>(acc0, 0, out_buf, bias2, gelu_tab);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(1 + wg);
      if (leader) {
        store_boxes<ROWS>(&map_out, out_buf, m0, n0, N, plane_cols);
        if (MODE == 1 && m0 + 64 < M)  // the second half's residual rows
          load_residual<C::kBoxBytes>(&map_res, out_buf, m0 + 64, n0, N,
                                      &res_bars[wg]);
        else
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      wg_sync(1 + wg);
      if (MODE == 1 && m0 + 64 < M)
        mbar_wait(&res_bars[wg], res_phase++ & 1);
      epilogue_rows<MODE, ROWS>(acc1, 0, out_buf, bias2, gelu_tab);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(1 + wg);
      if (leader)
        store_boxes<ROWS>(&map_out, out_buf, m0 + 64, n0, N, plane_cols);
    } else {
      epilogue_rows<MODE, ROWS>(acc0, 0, out_buf, bias2, gelu_tab);
      epilogue_rows<MODE, ROWS>(acc1, 64, out_buf, bias2, gelu_tab);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(1 + wg);
      if (leader) store_boxes<ROWS>(&map_out, out_buf, m0, n0, N, plane_cols);
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

struct TcArgs {
  CUtensorMap mx, mw, mo, mo_half, mr, mr_half;
  const __nv_bfloat16* b;
  long long M;
  int N, K, pc, sms;
  const int* live;
  int per;
  float* out_f32;  // mode 4's output
};

template <int MODE, bool WS>
cudaError_t launch_tc_mode(const TcArgs& a, cudaStream_t st) {
  using C = TcCfg<MODE, WS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_tc_kernel<MODE, WS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (attr != cudaSuccess) return attr;
  const int n_tiles = (a.N + BN - 1) / BN;
  const long long m_tiles = (a.M + BM - 1) / BM;
  long long grid;
  if (WS) {  // row groups of n_tiles CTAs, no more groups than row tiles
    const long long groups = a.sms / n_tiles;
    grid = (groups < m_tiles ? groups : m_tiles) * n_tiles;
  } else {
    const long long tiles = m_tiles * n_tiles;
    grid = tiles < a.sms ? tiles : a.sms;
  }
  gemm_tc_kernel<MODE, WS><<<(unsigned)grid, kTcThreads, C::kSmem, st>>>(
      a.mx, a.mw, C::kHalf ? a.mo_half : a.mo, C::kHalf ? a.mr_half : a.mr,
      a.b, a.M, a.N, a.K,
      a.pc, n_tiles, m_tiles, a.live, a.per, a.out_f32);
  return cudaGetLastError();
}

template <bool WS>
cudaError_t launch_tc_walk(int mode, const TcArgs& a, cudaStream_t st) {
  switch (mode) {
    case 0: return launch_tc_mode<0, WS>(a, st);
    case 1: return launch_tc_mode<1, WS>(a, st);
    case 2: return launch_tc_mode<2, WS>(a, st);
    case 3: return launch_tc_mode<3, WS>(a, st);
    default: return launch_tc_mode<4, WS>(a, st);
  }
}

cudaError_t launch_tc(int mode, const void* x, const void* w, const void* b,
                      const void* res, void* out, long long M, int N, int K,
                      int planes, const int* live, int per, cudaStream_t st) {
  TcArgs a;
  a.live = live;
  a.per = per;
  a.out_f32 = mode == 4 ? static_cast<float*>(out) : nullptr;
  a.pc = N / planes;
  if (planes > 1 && a.pc % 64 != 0) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&a.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dw[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t dout[3] = {(cuuint64_t)a.pc, (cuuint64_t)M,
                              (cuuint64_t)planes};
  const cuuint64_t dres[3] = {(cuuint64_t)N, (cuuint64_t)M, 1};
  const cuuint32_t bx[2] = {BK, BM}, bw[2] = {BK, BN}, bo[3] = {64, BM, 1},
                   bh[3] = {64, BM / 2, 1};
  if (!make_map(&a.mx, x, 2, dx, bx) || !make_map(&a.mw, w, 2, dw, bw) ||
      !make_map(&a.mo, out, 3, dout, bo) ||
      !make_map(&a.mo_half, out, 3, dout, bh) ||
      !make_map(&a.mr, mode == 1 ? res : out, 3, mode == 1 ? dres : dout,
                bo) ||
      !make_map(&a.mr_half, mode == 1 ? res : out, 3,
                mode == 1 ? dres : dout, bh))
    return cudaErrorInvalidValue;
  a.b = static_cast<const __nv_bfloat16*>(b);
  a.M = M;
  a.N = N;
  a.K = K;
  const int n_tiles = (N + BN - 1) / BN;
  if (K <= kWsMaxK && n_tiles <= a.sms)
    return launch_tc_walk<true>(mode, a, st);
  return launch_tc_walk<false>(mode, a, st);
}

// ------------------------------------------------------------------- K23
constexpr int kEpiThreads = 256;

// bf16: 8 outputs a step (two float4 of acc, a 16-byte vector each of b,
// the residual and the output); N % 8 == 0, so a step lies in one row
template <bool RES>
__global__ void __launch_bounds__(kEpiThreads) tp_epilogue_bf16_kernel(
    const float* __restrict__ acc, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
    long long steps, int N) {
  const int steps_row = N / 8;
  for (long long i = blockIdx.x * (long long)kEpiThreads + threadIdx.x;
       i < steps; i += (long long)gridDim.x * kEpiThreads) {
    const long long e = i * 8;
    const int c = (int)(i % steps_row) * 8;
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(acc + e));
    const float4 a1 = __ldg(reinterpret_cast<const float4*>(acc + e + 4));
    const uint4 bv = __ldg(reinterpret_cast<const uint4*>(b + c));
    uint4 rv = make_uint4(0, 0, 0, 0);
    if constexpr (RES) rv = __ldg(reinterpret_cast<const uint4*>(res + e));
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bv);
    const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv);
    uint4 ov;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      o2[p] = epi_bf16x2<RES ? 1 : 0>(a[2 * p], a[2 * p + 1], b2[p], r2[p]);
    *reinterpret_cast<uint4*>(out + e) = ov;
  }
}

// f32: 4 outputs a step, res + (acc + b) as K15's f32 route adds them
template <bool RES>
__global__ void __launch_bounds__(kEpiThreads) tp_epilogue_f32_kernel(
    const float* __restrict__ acc, const float* __restrict__ b,
    const float* __restrict__ res, float* __restrict__ out, long long steps,
    int N) {
  const int steps_row = N / 4;
  for (long long i = blockIdx.x * (long long)kEpiThreads + threadIdx.x;
       i < steps; i += (long long)gridDim.x * kEpiThreads) {
    const long long e = i * 4;
    const int c = (int)(i % steps_row) * 4;
    const float4 a = __ldg(reinterpret_cast<const float4*>(acc + e));
    const float4 bv = __ldg(reinterpret_cast<const float4*>(b + c));
    float4 y = make_float4(__fadd_rn(a.x, bv.x), __fadd_rn(a.y, bv.y),
                           __fadd_rn(a.z, bv.z), __fadd_rn(a.w, bv.w));
    if constexpr (RES) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(res + e));
      y = make_float4(__fadd_rn(r.x, y.x), __fadd_rn(r.y, y.y),
                      __fadd_rn(r.z, y.z), __fadd_rn(r.w, y.w));
    }
    *reinterpret_cast<float4*>(out + e) = y;
  }
}

// The grid: as many CTAs as the SMs hold at once, fewer for small calls
template <typename K>
cudaError_t epi_grid(K kernel, int (&cache)[kMaxDevices], long long steps,
                     int* grid) {
  cudaError_t e = persistent_grid(kernel, kEpiThreads, cache, grid);
  if (e != cudaSuccess) return e;
  const long long need = (steps + kEpiThreads - 1) / kEpiThreads;
  if (need < *grid) *grid = (int)(need > 0 ? need : 1);
  return cudaSuccess;
}

template <bool RES>
cudaError_t tp_epilogue_t(int dtype, const void* acc, const void* b,
                          const void* res, void* out, long long M, int N,
                          cudaStream_t st) {
  int grid = 0;
  cudaError_t e;
  const float* a = static_cast<const float*>(acc);
  if (dtype == 1) {
    static int cache[kMaxDevices];
    const long long steps = M * (N / 8);
    e = epi_grid(tp_epilogue_bf16_kernel<RES>, cache, steps, &grid);
    if (e != cudaSuccess) return e;
    tp_epilogue_bf16_kernel<RES><<<grid, kEpiThreads, 0, st>>>(
        a, static_cast<const __nv_bfloat16*>(b),
        static_cast<const __nv_bfloat16*>(res),
        static_cast<__nv_bfloat16*>(out), steps, N);
  } else {
    static int cache[kMaxDevices];
    const long long steps = M * (N / 4);
    e = epi_grid(tp_epilogue_f32_kernel<RES>, cache, steps, &grid);
    if (e != cudaSuccess) return e;
    tp_epilogue_f32_kernel<RES><<<grid, kEpiThreads, 0, st>>>(
        a, static_cast<const float*>(b), static_cast<const float*>(res),
        static_cast<float*>(out), steps, N);
  }
  return cudaGetLastError();
}

}  // namespace

// K14. x: (rows, d) bf16 (dtype 1) or f32 (dtype 0), 16-byte aligned;
// gamma, beta: (d,) f32; out: (rows, d) in x's type; d % 8 == 0, 8 <= d
// <= 1024. live (nullable): a (1,) int32 count on the device; rows at or
// past live[0] * per are neither read nor written.
extern "C" int ln_bf16_launch(const void* x, int dtype, const void* gamma,
                              const void* beta, float eps, long long rows,
                              int d, const void* live, int per, void* out,
                              void* stream) {
  if (rows < 0 || (dtype != 0 && dtype != 1) || d < 8 || d % 8 != 0 ||
      d > 1024 || per < 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const int* lv = static_cast<const int*>(live);
  if (dtype == 1)
    return (int)ln_launch_t(static_cast<const __nv_bfloat16*>(x), g, b, eps,
                            rows, d, lv, per,
                            static_cast<__nv_bfloat16*>(out), st);
  return (int)ln_launch_t(static_cast<const float*>(x), g, b, eps, rows, d,
                          lv, per, static_cast<float*>(out), st);
}

// K15, bf16. mode 0 none, 1 residual, 2 gelu_tanh, 3 gelu_tanh by the
// formula per output (the same results as 2), 4 partial (out: (M, N) f32,
// the accumulators unrounded; b null, planes 1, no row count). x: (M, K), w: (N, K), both
// 16-byte aligned with K % 16 == 0; b: (N,), 4-byte aligned; res: (M, N)
// for mode 1, else null; out: (planes, M, N / planes), 16-byte aligned;
// N % 8 == 0 and (N / planes) % 8 == 0 (with planes > 1: % 64 == 0),
// planes == 1 for mode 1. live (nullable): a (1,) int32 count on the
// device; the row tiles (128 rows) that hold no row below live[0] * per
// are neither read nor written.
extern "C" int gemm_bf16_launch(const void* x, const void* w, const void* b,
                                const void* res, void* out, int mode,
                                long long M, int N, int K, int planes,
                                const void* live, int per, void* stream) {
  if (M < 0 || N < 8 || N % 8 != 0 || K < 16 || K % 16 != 0 || planes < 1 ||
      N % planes != 0 || (N / planes) % 8 != 0 || mode < 0 || mode > 4 ||
      (mode == 1) != (res != nullptr) || (mode == 1 && planes != 1) ||
      per < 1 || (mode != 4) != (b != nullptr) ||
      (mode == 4 && (planes != 1 || live != nullptr)))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  return (int)launch_tc(mode, x, w, b, res, out, M, N, K, planes,
                        static_cast<const int*>(live), per,
                        static_cast<cudaStream_t>(stream));
}

// K23. acc: (M, N) f32; b: (N,) and res (nullable): (M, N) in the working
// type (dtype 1 bf16, 0 f32); out: (M, N) in it; every pointer 16-byte
// aligned, N % 8 == 0.
extern "C" int tp_epilogue_launch(const void* acc, const void* b,
                                  const void* res, void* out, int dtype,
                                  long long M, int N, void* stream) {
  if (M < 0 || N < 8 || N % 8 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(res != nullptr
                   ? tp_epilogue_t<true>(dtype, acc, b, res, out, M, N, st)
                   : tp_epilogue_t<false>(dtype, acc, b, res, out, M, N, st));
}
