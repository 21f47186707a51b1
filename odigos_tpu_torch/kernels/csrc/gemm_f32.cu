// K15 gemm_bf16's f32 route — for Hopper (sm_90a), on the CUDA cores.
//
// Replaces the f32 Dense chain of odigos_tpu/models/layers.py
// EncoderBlock.__call__ (:72-80: q, k, v, out + residual, FFN1 + GELU,
// FFN2 + residual) and the decoder's dec_ff1 -> gelu -> dec_ff2 of
// odigos_tpu/models/autoencoder.py (:78-80), as the f32 model runs them:
// the trainers' forward (FFN1 also writes its pre-activation, K19's input)
// and the f32 scorer on the card. dense.cu holds the bf16 route.
//
//   out = epilogue(x . w^T + b), x (M, K), w (N, K), both K-major
//   mode 0 none       acc + b
//   mode 1 residual   res + (acc + b)
//   mode 2/3 gelu     gelu_tanh(acc + b), acc + b also into `pre` if given
//   mode 4 partial    acc (no bias: a row-parallel product's share on one
//                     rank of the "model" axis, finished by K23)
// in `planes` contiguous planes of N / planes columns (the fused QKV).
//
// The bits: each output is one fmaf chain over k = 0 .. K - 1 in order,
// from +0, then __fadd_rn(acc, b[n]) and the epilogue's IEEE steps, so
// any tiling that keeps the chain gives the same bits (the trainers' AUC
// rests on a recipe that swings with any change of summation order: no
// split K, no TF32).
//
// Bound on the card: operations. At the trainers' M = 2048 rows the
// products take 0.27-1.07 GFLOP against 4-20 MB of operands: 4-16 us at
// 67 TFLOP/s f32, 1-6 us of bytes. So the design feeds the FMA units:
// * a thread holds a TM x TN block of outputs (8 x 8, 8 x 4 or 4 x 4) in
//   registers and reads its operands as 16-byte vectors, 4 k-values of one
//   row of x or of w each: TM + TN shared-memory reads for 4 TM TN FMAs;
// * the K dimension walks in slabs of 32 (128-byte rows, 8 chunks of 16
//   bytes), copied into shared memory with 16-byte cp.async into a ring of
//   four stages, so that the next three slabs load during this slab's
//   FMAs (a slab's FMAs take less than a load's trip from device memory);
//   chunks are placed at chunk ^ ((row >> 2) & 7), so the 8 lanes of a
//   quarter warp, whose w rows lie 4 apart, read 8 different bank groups
//   (their x rows are one row: a broadcast);
// * the tile (BM x BN, 128 threads) is chosen by shape so that the grid
//   gives each SM about two CTAs: 64 x 128 (8 x 8 a thread) where it makes
//   enough of them (FFN1 at M 2048, every product at the serving M), 64 x
//   64 (8 x 4) for QKV and the autoencoder's FFN1, 32 x 64 (4 x 4) for the
//   narrow N of the out-projection, FFN2 and the autoencoder (`plan_tile`);
// * the epilogue loads the residual and stores the output and `pre` as
//   16-byte vectors (a thread's columns come in groups of 4).
// With a device row count (the fused routes' real rows) the row tiles that
// hold no real row are neither read nor written. Measured times are in
// PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tc_common.cuh"  // gelu_tanh, live_row_tiles

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 32;     // k-values of a slab: a 128-byte row
constexpr int kChunks = kBK / 4;
constexpr int kStages = 4;  // slabs in flight: 3 ahead of the FMAs
constexpr int kMaxDevices = 64;

// the float offset of (row, 16-byte chunk) in a slab of 128-byte rows
__device__ __forceinline__ int slab_at(int row, int chunk) {
  return row * kBK + ((chunk ^ ((row >> 2) & 7)) << 2);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool on) {
  const uint32_t d = smem_u32(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(on ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tile of BM x BN outputs a CTA of 128 threads computes, TM x TN a
// thread: thread (ty, tx) holds rows ty * TM + i and, in TN / 4 groups of
// 4, columns g * 4 * NTX + 4 * tx + c.
template <int BM, int BN, int TM, int TN>
struct Tile {
  static constexpr int NTX = BN / TN;  // threads along N
  static constexpr int NTY = BM / TM;
  static constexpr int G = TN / 4;     // column groups a thread
  static_assert(NTX * NTY == kThreads, "128 threads a CTA");
  static_assert(NTX >= 8 && 32 % NTX == 0, "a quarter warp spans 8 tx");
  static constexpr int kStageFloats = (BM + BN) * kBK;
};

// CTAs an SM must hold: the registers a thread may take (8 x 8: 255, the
// smaller blocks 170)
template <int TM, int TN>
constexpr int min_ctas() {
  return TM * TN >= 64 ? 2 : 3;
}

template <int MODE, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads, (min_ctas<TM, TN>())) gemm_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ res,
    float* __restrict__ out, long long M, int N, int K, int plane_cols,
    int n_tiles, const int* __restrict__ live, int per,
    float* __restrict__ pre) {
  using T = Tile<BM, BN, TM, TN>;
  extern __shared__ __align__(16) float smem[];  // kStages slabs
  const long long m0 = (long long)(blockIdx.x / n_tiles) * BM;
  // a tile past the row count is neither read nor written
  if (m0 >= live_row_tiles(live, per, M, BM, (M + BM - 1) / BM) * BM)
    return;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;
  const int tid = threadIdx.x;
  const int tx = tid % T::NTX;
  const int ty = tid / T::NTX;

  // ---- a slab's copies: the rows of x, then of w, 8 chunks each; rows
  // past M or N and chunks past K are zero-filled (never summed)
  auto load = [&](int slab, int stage) {
    float* as = smem + stage * T::kStageFloats;
    float* bs = as + BM * kBK;
    const int k0 = slab * kBK;
#pragma unroll
    for (int it = 0; it < (BM + BN) * kChunks / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int row = idx / kChunks;
      const int chunk = idx % kChunks;
      const int k = k0 + chunk * 4;
      if (row < BM) {
        const long long m = m0 + row;
        const bool on = m < M && k < K;
        cp_async16(as + slab_at(row, chunk), on ? x + m * K + k : x, on);
      } else {
        const int r = row - BM;
        const int n = n0 + r;
        const bool on = n < N && k < K;
        cp_async16(bs + slab_at(r, chunk),
                   on ? w + (long long)n * K + k : w, on);
      }
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int slabs = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs)
      load(s, s);
    else
      cp_async_commit();  // an empty group keeps the count
  }
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<kStages - 2>();  // slab s has landed
    __syncthreads();  // ... for every thread, and slab s - 1 is consumed
    if (s + kStages - 1 < slabs)
      load(s + kStages - 1, (s + kStages - 1) % kStages);
    else
      cp_async_commit();
    const float* as = smem + (s % kStages) * T::kStageFloats;
    const float* bs = as + BM * kBK;
    // K % 16 == 0: a slab holds 8 chunks, the last of K % 32 == 16 four
    const bool half = K - s * kBK < kBK;
#pragma unroll 2
    for (int c = 0; c < kChunks; ++c) {
      if (half && c >= kChunks / 2) break;
      float4 b[TN];
#pragma unroll
      for (int g = 0; g < T::G; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          b[g * 4 + q] = *reinterpret_cast<const float4*>(
              bs + slab_at(g * 4 * T::NTX + 4 * tx + q, c));
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(
            as + slab_at(ty * TM + i, c));
        // k ascending within the chunk: each output's one chain
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
      }
    }
  }

  // ---- the epilogue, 4 columns at a time (N % 8 == 0 and the plane's
  // columns % 8 == 0: a group lies in one plane, whole or past N)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int g = 0; g < T::G; ++g) {
      const int n = n0 + g * 4 * T::NTX + 4 * tx;
      if (n >= N) continue;
      float y[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        y[q] = MODE == 4 ? acc[i][g * 4 + q]
                         : __fadd_rn(acc[i][g * 4 + q], __ldg(bias + n + q));
      if constexpr (MODE == 2 || MODE == 3) {
        if (pre != nullptr)  // planes == 1 here
          *reinterpret_cast<float4*>(pre + m * N + n) =
              make_float4(y[0], y[1], y[2], y[3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) y[q] = gelu_tanh(y[q]);
      }
      if constexpr (MODE == 1) {
        const float4 r = __ldg(reinterpret_cast<const float4*>(res + m * N +
                                                               n));
        y[0] = __fadd_rn(r.x, y[0]);
        y[1] = __fadd_rn(r.y, y[1]);
        y[2] = __fadd_rn(r.z, y[2]);
        y[3] = __fadd_rn(r.w, y[3]);
      }
      const int plane = n / plane_cols;
      *reinterpret_cast<float4*>(out + (long long)plane * M * plane_cols +
                                 m * plane_cols + (n - plane * plane_cols)) =
          make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

// ---- the tile by shape

struct TileShape {
  int bm, bn;
};
// largest first: 8 x 8, 8 x 4 and 4 x 4 outputs a thread
constexpr TileShape kTiles[3] = {{64, 128}, {64, 64}, {32, 64}};

std::atomic<int> g_sms[kMaxDevices];

// The largest tile whose grid gives every SM about two CTAs (at least 15 /
// 8 of the SM count), else the smallest: a larger block reads fewer shared
// values a FMA, but below two CTAs an SM the SMs' schedulers idle (PERF.md
// §6: the three tiles timed at each of the trainers' products)
int plan_tile(long long M, int N, int sms) {
  for (int t = 0; t < 2; ++t) {
    const long long ctas = (M + kTiles[t].bm - 1) / kTiles[t].bm *
                           ((N + kTiles[t].bn - 1) / kTiles[t].bn);
    if (8 * ctas >= 15LL * sms) return t;
  }
  return 2;
}

template <int MODE, int BM, int BN, int TM, int TN>
cudaError_t launch_tile(const float* x, const float* w, const float* b,
                        const float* res, float* out, long long M, int N,
                        int K, int pc, const int* live, int per, float* pre,
                        cudaStream_t st) {
  constexpr int kSmem = kStages * Tile<BM, BN, TM, TN>::kStageFloats * 4;
  static std::atomic<int> attr_set[kMaxDevices];
  auto kernel = gemm_f32_kernel<MODE, BM, BN, TM, TN>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!attr_set[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e != cudaSuccess) return e;
    attr_set[dev].store(1, std::memory_order_release);
  }
  const int n_tiles = (N + BN - 1) / BN;
  const long long tiles = (M + BM - 1) / BM * n_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, kThreads, kSmem, st>>>(
      x, w, b, res, out, M, N, K, pc, n_tiles, live, per, pre);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(int tile, const float* x, const float* w,
                        const float* b, const float* res, float* out,
                        long long M, int N, int K, int pc, const int* live,
                        int per, float* pre, cudaStream_t st) {
  switch (tile) {
    case 0:
      return launch_tile<MODE, 64, 128, 8, 8>(x, w, b, res, out, M, N, K, pc,
                                              live, per, pre, st);
    case 1:
      return launch_tile<MODE, 64, 64, 8, 4>(x, w, b, res, out, M, N, K, pc,
                                             live, per, pre, st);
    default:
      return launch_tile<MODE, 32, 64, 4, 4>(x, w, b, res, out, M, N, K, pc,
                                             live, per, pre, st);
  }
}

// The tile kTiles[*tile] for (M, N) on the current device
cudaError_t tile_for(long long M, int N, int* tile) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int sms = g_sms[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    g_sms[dev].store(sms, std::memory_order_relaxed);
  }
  *tile = plan_tile(M, N, sms);
  return cudaSuccess;
}

}  // namespace

// The tile (its index in kTiles) a launch at (M, N) takes on the current
// device; -1 without one. A row count skips whole tiles of its height.
extern "C" int gemm_f32_tile(long long M, int N) {
  int tile = 0;
  if (tile_for(M, N, &tile) != cudaSuccess) return -1;
  return tile;
}

// mode 0 none, 1 residual, 2 gelu_tanh, 3 the same GELU (the bf16 route's
// formula mode), 4 partial (acc; b null, planes 1, no row count). x: (M, K), w: (N, K), 16-byte aligned, K % 16 == 0; b:
// (N,), 4-byte aligned; res: (M, N) for mode 1, else null, 16-byte
// aligned; out: (planes, M, N / planes), 16-byte aligned; N % 8 == 0, (N
// / planes) % 8 == 0, planes == 1 for mode 1. live (nullable): a (1,)
// int32 count on the device; the row tiles (gemm_f32_tile) that hold
// no row below live[0] * per are neither read nor written. pre (nullable;
// modes 2 and 3, planes 1): an (M, N) 16-byte aligned buffer that takes
// acc + b before the GELU. One launch.
extern "C" int gemm_f32_launch(const void* x, const void* w, const void* b,
                               const void* res, void* out, int mode,
                               long long M, int N, int K, int planes,
                               const void* live, int per, void* pre,
                               void* stream) {
  if (M < 0 || N < 8 || N % 8 != 0 || K < 16 || K % 16 != 0 || planes < 1 ||
      N % planes != 0 || (N / planes) % 8 != 0 || mode < 0 || mode > 4 ||
      (mode == 1) != (res != nullptr) || (mode == 1 && planes != 1) ||
      per < 1 || (pre != nullptr && (mode < 2 || mode > 3 || planes != 1)) ||
      (mode != 4) != (b != nullptr) ||
      (mode == 4 && (planes != 1 || live != nullptr)))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  int tile = 0;
  cudaError_t e = tile_for(M, N, &tile);
  if (e != cudaSuccess) return (int)e;
  const auto* xx = static_cast<const float*>(x);
  const auto* ww = static_cast<const float*>(w);
  const auto* bb = static_cast<const float*>(b);
  const auto* rr = static_cast<const float*>(res);
  auto* oo = static_cast<float*>(out);
  auto* pp = static_cast<float*>(pre);
  const auto* lv = static_cast<const int*>(live);
  const int pc = N / planes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    e = launch_mode<0>(tile, xx, ww, bb, rr, oo, M, N, K, pc, lv, per,
                       nullptr, st);
  else if (mode == 1)
    e = launch_mode<1>(tile, xx, ww, bb, rr, oo, M, N, K, pc, lv, per,
                       nullptr, st);
  else if (mode == 4)
    e = launch_mode<4>(tile, xx, ww, bb, rr, oo, M, N, K, pc, lv, per,
                       nullptr, st);
  else
    e = launch_mode<2>(tile, xx, ww, bb, rr, oo, M, N, K, pc, lv, per, pp,
                       st);
  return (int)e;
}
