// K14 and K15: the float encoder block's dense chain — for Hopper (sm_90a).
//
// Replaces the LN/GEMM/GELU/residual chain of odigos_tpu/models/layers.py
// EncoderBlock.__call__ (:68-81) and the decoder's dec_ff1 -> gelu ->
// dec_ff2 of odigos_tpu/models/autoencoder.py (:78-80): everything of the
// block but the attention (K1).
//
// K14 ln_bf16: Flax's LayerNorm(dtype) over the last dimension, one warp
// per row, d = 32 * PER values, lane k holding [k * PER, (k + 1) * PER)
// loaded and stored 16 bytes at a time, two rows in flight per warp (both
// loaded before either is reduced). The arithmetic is ln_exact.cuh's
// (exact f64 row sums rounded once, IEEE steps, the result rounded to the
// working type), so the plain version (torch's f64 sums) gives the same
// bits. Bound: bytes (the row read once, written once).
//
// K15 gemm_bf16: out = epilogue(x . w^T + b), x (M, K) and w (N, K) both
// K-major (the Linear layout), b (N,), all in the working type, f32
// accumulators, then Flax's rounding points (Dense(dtype) returns the
// working type from its dot_general, then adds the bias in it):
//   mode 0 "none"      round(round(acc) + b)                (q, k, v)
//   mode 1 "residual"  round(res + round(round(acc) + b))   (out, FFN2)
//   mode 2 "gelu_tanh" round(gelu(round(round(acc) + b)))  (FFN1)
// with gelu the tanh form of jax.nn.gelu in f32 (K10's gelu_tanh, IEEE
// steps, tanhf) and the adds bf16x2 adds (correctly rounded, equal to the
// plain version's f32 add then round). The output is written in `planes`
// contiguous planes of N / planes columns, so the fused QKV product
// (N = 3d) leaves q, k and v each contiguous for K1.
//
// bf16 design (the serving path): wgmma.mma_async m64n128k16 bf16 -> f32
// with both operands in shared memory under the 128-byte swizzle, loaded
// by TMA (cp.async.bulk.tensor, zero fill past M, N and K). A persistent
// CTA (one per SM, 193 KB of shared memory) holds two consumer
// warpgroups, each computing whole 128 x 128 tiles (two m64 accumulators,
// 128 registers) from its own 2-stage mbarrier ring, filled by its own
// producer warp (one lane issues the TMA loads). The CTA's tiles
// alternate between the warpgroups (ping-pong), so one warpgroup's
// epilogue overlaps the other's products; consecutive CTAs walk N first
// and share their A rows through L2. The epilogue rounds in registers,
// writes the tile into shared memory as two 128-byte-swizzled 128 x 64
// boxes (conflict-free), and one thread stores them with the TMA
// (cp.async.bulk.tensor, rows past M and columns past N clipped). All
// offsets are 64-bit: the autoencoder's fused route reaches M = 8.1 M
// rows, M x 512 outputs past 2^32 elements.
// f32 (the f32 model on the card): a plain CUDA-core tiled kernel, 64 x 64
// tiles, 4 x 4 outputs a thread, f32 FMA accumulation.
//
// Bound on the card: bytes at these widths. At M = 131072 tokens, d 256:
// QKV (N 768, K 256) reads 67 MB and writes 201 MB (0.080 ms at 3.35 TB/s)
// for 51.5 GFLOP (0.052 ms at 989 TFLOP/s); FFN1 (N 1024) 67 + 268 MB
// (0.100 ms); FFN2 (K 1024, + residual) 268 + 67 + 67 MB (0.120 ms).
// Measured (PERF.md): every step but FFN1 within 2x of its bound; FFN1's
// GELU epilogue (an accurate tanhf per output) is ALU-bound, 3x.
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

namespace {

constexpr float kGeluC = 0x1.988454p-1f;  // f32(sqrt(2 / pi))
constexpr float kGeluK = 0x1.6e4e26p-5f;  // f32(0.044715)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(kGeluC, __fadd_rn(x, __fmul_rn(kGeluK, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

// ------------------------------------------------------------------- K14
// PER values of T from src to dst, in the widest aligned pieces
template <typename T, int PER>
__device__ __forceinline__ void copy_row(T* dst, const T* src) {
  constexpr int bytes = PER * (int)sizeof(T);
  if constexpr (bytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < bytes / 16; ++i)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else if constexpr (bytes % 8 == 0) {
#pragma unroll
    for (int i = 0; i < bytes / 8; ++i)
      reinterpret_cast<uint2*>(dst)[i] = reinterpret_cast<const uint2*>(src)[i];
  } else if constexpr (bytes % 4 == 0) {
#pragma unroll
    for (int i = 0; i < bytes / 4; ++i)
      reinterpret_cast<uint32_t*>(dst)[i] =
          reinterpret_cast<const uint32_t*>(src)[i];
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) dst[i] = src[i];
  }
}

__device__ __forceinline__ void to_t(float v, float* p) { *p = v; }
__device__ __forceinline__ void to_t(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kLnThreads = 256;
constexpr int kLnWarps = kLnThreads / 32;
constexpr int kLnRows = 2;  // rows a warp has in flight: loads first

template <typename T, int PER>
__global__ void __launch_bounds__(kLnThreads) ln_bf16_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, float eps, long long rows,
    T* __restrict__ out) {
  constexpr int d = 32 * PER;
  const int lane = threadIdx.x & 31;
  const int k0 = lane * PER;
  float g[PER], b[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    g[j] = gamma[k0 + j];
    b[j] = beta[k0 + j];
  }
  const long long warps = (long long)gridDim.x * kLnWarps;
  for (long long r0 = (long long)blockIdx.x * kLnWarps + (threadIdx.x >> 5);
       r0 < rows; r0 += kLnRows * warps) {
    __align__(16) T v[kLnRows][PER];
#pragma unroll
    for (int i = 0; i < kLnRows; ++i)
      if (r0 + i * warps < rows)  // warp-uniform
        copy_row<T, PER>(v[i], x + (r0 + i * warps) * d + k0);
#pragma unroll
    for (int i = 0; i < kLnRows; ++i) {
      const long long r = r0 + i * warps;
      if (r >= rows) break;
      float y[PER];
      warp_ln_row<T, PER>(v[i], g, b, eps, y);
      __align__(16) T o[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) to_t(y[j], o + j);
      copy_row<T, PER>(out + r * d + k0, o);
    }
  }
}

template <typename T>
int ln_launch_t(const T* x, const float* g, const float* b, float eps,
                long long rows, int d, T* out, cudaStream_t st) {
  long long blocks = (rows + kLnWarps * kLnRows - 1) / (kLnWarps * kLnRows);
  if (blocks > 4096) blocks = 4096;  // grid-stride beyond
  const unsigned grid = (unsigned)blocks;
  switch (d) {
    case 32:
      ln_bf16_kernel<T, 1>
          <<<grid, kLnThreads, 0, st>>>(x, g, b, eps, rows, out);
      break;
    case 64:
      ln_bf16_kernel<T, 2>
          <<<grid, kLnThreads, 0, st>>>(x, g, b, eps, rows, out);
      break;
    case 128:
      ln_bf16_kernel<T, 4>
          <<<grid, kLnThreads, 0, st>>>(x, g, b, eps, rows, out);
      break;
    case 256:
      ln_bf16_kernel<T, 8>
          <<<grid, kLnThreads, 0, st>>>(x, g, b, eps, rows, out);
      break;
    case 512:
      ln_bf16_kernel<T, 16>
          <<<grid, kLnThreads, 0, st>>>(x, g, b, eps, rows, out);
      break;
    case 1024:
      ln_bf16_kernel<T, 32>
          <<<grid, kLnThreads, 0, st>>>(x, g, b, eps, rows, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- K15 epilogue
// Two neighbouring columns at once. A bf16x2 add of two bf16 pairs is the
// exact sum rounded once, which equals the plain version's f32 add then
// round (the f32 sum of two bf16 values is exact unless their exponents
// are more than 16 apart, and then both roundings return the larger).
template <int MODE>
__device__ __forceinline__ __nv_bfloat162 epi_bf16x2(float a0, float a1,
                                                     __nv_bfloat162 b,
                                                     __nv_bfloat162 r) {
  // round(round(acc) + b)
  __nv_bfloat162 y = __hadd2(__floats2bfloat162_rn(a0, a1), b);
  if constexpr (MODE == 2) {  // round(gelu(y)), gelu in f32
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
constexpr int kStages = 2;  // per consumer warpgroup: a ring each
constexpr int kConsumerWgs = 2;
constexpr int kTcThreads = 160 * kConsumerWgs;  // + a producer warp each
constexpr int kTileA = BM * BK * 2;
constexpr int kTileB = BN * BK * 2;
constexpr int kStageBytes = kTileA + kTileB;
constexpr int kOutHalf = BM * 64 * 2;  // 128 rows x 64 columns of bf16
constexpr int kOutBytes = 2 * kOutHalf;  // one warpgroup's output tile
constexpr int kTcSmem = kConsumerWgs * (kStages * kStageBytes + kOutBytes) +
                        1024;  // + 1024-byte alignment: 193 KB

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the warpgroup's 128 threads meet at named barrier `id`
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// shared-memory descriptor of a K-major bf16 tile under the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO
// unused, layout type 1 (SWIZZLE_128B) in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

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

// One warpgroup's 64 rows x 128 columns of accumulators (rows [r0, r0 +
// 64) of the tile) through the epilogue into the output staging buffer,
// laid out as the two 128-byte-swizzled 128 x 64 boxes the TMA store
// reads: column pair (c, c + 1) of tile row r lands in box c / 64, row r,
// 16-byte chunk (c % 64 / 8) ^ (r % 8). Warp w of the warpgroup holds rows
// 16 w + lane / 4 (+ 8); acc[4 j + 2 h + e] is column 8 j + 2 (lane % 4)
// + e of the row + 8 h (wgmma's m64nNk16 accumulator layout).
template <int MODE>
__device__ __forceinline__ void epilogue_rows(
    const float (&acc)[64], int r0, uint8_t* buf,
    const __nv_bfloat16* __restrict__ bias,
    const __nv_bfloat16* __restrict__ res, long long m0, int n0,
    long long M, int N) {
  const int lane = threadIdx.x & 31;
  const int rw = r0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + (lane & 3) * 2;
    const int n = n0 + c;
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    const __nv_bfloat162 b2 =
        n < N ? *reinterpret_cast<const __nv_bfloat162*>(bias + n) : zero;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw + 8 * h;
      __nv_bfloat162 r2 = zero;
      if constexpr (MODE == 1) {
        const long long m = m0 + r;
        if (m < M && n < N)
          r2 = *reinterpret_cast<const __nv_bfloat162*>(res + m * N + n);
      }
      const __nv_bfloat162 y =
          epi_bf16x2<MODE>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], b2, r2);
      *reinterpret_cast<__nv_bfloat162*>(
          buf + (j >> 3) * kOutHalf + r * 128 +
          (((j & 7) ^ (r & 7)) << 4) + (lane & 3) * 4) = y;
    }
  }
}

// Persistent: the CTA takes tiles blockIdx.x, + gridDim.x, ... (N
// fastest, so the tiles in flight share their A rows through L2); its
// q-th tile goes to consumer warpgroup q % 2 (ping-pong: one warpgroup's
// epilogue overlaps the other's products). Each warpgroup has its own
// ring of stages, filled by its own producer warp: with one shared ring a
// warpgroup could wait on a stage two phases ahead of its barrier, where
// the phase parity no longer tells them apart.
template <int MODE>
__global__ void __launch_bounds__(kTcThreads, 1) gemm_tc_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_out,
    const __nv_bfloat16* __restrict__ bias,
    const __nv_bfloat16* __restrict__ res, long long M, int N, int K,
    int plane_cols, int n_tiles, long long tiles) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bars[kConsumerWgs][kStages];
  __shared__ __align__(8) uint64_t empty_bars[kConsumerWgs][kStages];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the rings to it
  uint8_t* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int ktiles = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int g = 0; g < kConsumerWgs; ++g)
#pragma unroll
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full_bars[g][s], 1);
        mbar_init(&empty_bars[g][s], 4);  // the warpgroup's four warps
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup wg's ring, staging buffer and tiles (its producer warp is
  // warp 4 * kConsumerWgs + wg)
  const int wg = warp < 4 * kConsumerWgs ? warp >> 2
                                         : warp - 4 * kConsumerWgs;
  uint8_t* ring = smem + wg * (kStages * kStageBytes + kOutBytes);
  uint64_t* full = full_bars[wg];
  uint64_t* empty = empty_bars[wg];
  const long long first = blockIdx.x + wg * (long long)gridDim.x;
  const long long step = kConsumerWgs * (long long)gridDim.x;

  if (warp >= 4 * kConsumerWgs) {  // a producer warp: one lane loads
    if (lane == 0) {
      long long it = 0;
      for (long long t = first; t < tiles; t += step) {
        const int m0 = (int)(t / n_tiles) * BM;
        const int n0 = (int)(t % n_tiles) * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = (int)(it % kStages);
          if (it >= kStages)
            mbar_wait(&empty[s], (int)((it / kStages - 1) & 1));
          uint8_t* st = ring + s * kStageBytes;
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_2d(st, &map_x, kt * BK, m0, &full[s]);
          tma_load_2d(st + kTileA, &map_w, kt * BK, n0, &full[s]);
        }
      }
    }
    return;
  }

  const bool leader = (threadIdx.x & 127) == 0;
  uint8_t* out_buf = ring + kStages * kStageBytes;
  long long it = 0;
  for (long long t = first; t < tiles; t += step) {
    const long long m0 = (t / n_tiles) * BM;
    const int n0 = (int)(t % n_tiles) * BN;
    float acc0[64], acc1[64];  // tile rows [0, 64) and [64, 128)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = (int)(it % kStages);
      mbar_wait(&full[s], (int)((it / kStages) & 1));
      const uint32_t a = smem_u32(ring + s * kStageBytes);
      const uint32_t b = a + kTileA;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // 32 bytes along the swizzle
        const uint64_t db = sw128_desc(b + kk * 32);
        wgmma_m64n128k16(acc0, sw128_desc(a + kk * 32), db);
        wgmma_m64n128k16(acc1, sw128_desc(a + 64 * 128 + kk * 32), db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // the staging buffer is free once the last tile's store has read it
    if (leader)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    wg_sync(1 + wg);
    epilogue_rows<MODE>(acc0, 0, out_buf, bias, res, m0, n0, M, N);
    epilogue_rows<MODE>(acc1, 64, out_buf, bias, res, m0, n0, M, N);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(1 + wg);
    if (leader) {
      // each 64-column box lies in one plane (plane_cols % 64 == 0 when
      // there are several); rows past M and columns past N are clipped
      for (int half = 0; half < 2; ++half) {
        const int n = n0 + 64 * half;
        if (n >= N) break;
        const int plane = n / plane_cols;
        tma_store_3d(&map_out, out_buf + half * kOutHalf,
                     n - plane * plane_cols, (int)m0, plane);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a bf16 tensor of dims[0] x dims[1] x dims[2] (innermost first, packed),
// moved in 128-byte-swizzled boxes of box[0] x box[1] x box[2]
bool make_map(CUtensorMap* map, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE>
cudaError_t launch_tc_mode(const CUtensorMap& mx, const CUtensorMap& mw,
                           const CUtensorMap& mo, const __nv_bfloat16* b,
                           const __nv_bfloat16* r, long long M, int N, int K,
                           int pc, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_tc_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcSmem);
  if (attr != cudaSuccess) return attr;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int n_tiles = (N + BN - 1) / BN;
  const long long tiles = (M + BM - 1) / BM * n_tiles;
  const long long grid = tiles < sms ? tiles : sms;
  gemm_tc_kernel<MODE><<<(unsigned)grid, kTcThreads, kTcSmem, st>>>(
      mx, mw, mo, b, r, M, N, K, pc, n_tiles, tiles);
  return cudaGetLastError();
}

cudaError_t launch_tc(int mode, const void* x, const void* w, const void* b,
                      const void* res, void* out, long long M, int N, int K,
                      int planes, cudaStream_t st) {
  const int pc = N / planes;
  if (planes > 1 && pc % 64 != 0) return cudaErrorInvalidValue;
  const cuuint64_t dx[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dw[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t dout[3] = {(cuuint64_t)pc, (cuuint64_t)M,
                              (cuuint64_t)planes};
  const cuuint32_t bx[2] = {BK, BM}, bw[2] = {BK, BN}, bo[3] = {64, BM, 1};
  CUtensorMap mx, mw, mo;
  if (!make_map(&mx, x, 2, dx, bx) || !make_map(&mw, w, 2, dw, bw) ||
      !make_map(&mo, out, 3, dout, bo))
    return cudaErrorInvalidValue;
  const auto* bb = static_cast<const __nv_bfloat16*>(b);
  const auto* rr = static_cast<const __nv_bfloat16*>(res);
  if (mode == 0) return launch_tc_mode<0>(mx, mw, mo, bb, rr, M, N, K, pc, st);
  if (mode == 1) return launch_tc_mode<1>(mx, mw, mo, bb, rr, M, N, K, pc, st);
  return launch_tc_mode<2>(mx, mw, mo, bb, rr, M, N, K, pc, st);
}

// ---------------------------------------------- K15 f32: CUDA-core route
constexpr int SB = 64;   // tile rows and columns
constexpr int SBK = 16;  // K step
constexpr int kF32Threads = 256;

template <int MODE>
__global__ void __launch_bounds__(kF32Threads) gemm_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ res,
    float* __restrict__ out, long long M, int N, int K, int plane_cols,
    int n_tiles) {
  __shared__ float As[SBK][SB + 4];
  __shared__ float Bs[SBK][SB + 4];
  const long long m0 = (long long)(blockIdx.x / n_tiles) * SB;
  const int n0 = (int)(blockIdx.x % n_tiles) * SB;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += SBK) {
#pragma unroll
    for (int i = 0; i < SB * SBK / kF32Threads; ++i) {
      const int idx = threadIdx.x + i * kF32Threads;
      const int r = idx >> 4;
      const int kk = idx & 15;
      const int k = k0 + kk;
      const long long m = m0 + r;
      const int n = n0 + r;
      As[kk][r] = (m < M && k < K) ? x[m * K + k] : 0.f;
      Bs[kk][r] = (n < N && k < K) ? w[(long long)n * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty * 4 + i];
        b[i] = Bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float y = __fadd_rn(acc[i][j], bias[n]);
      if constexpr (MODE == 2) y = gelu_tanh(y);
      if constexpr (MODE == 1) y = __fadd_rn(res[m * N + n], y);
      const int plane = n / plane_cols;
      out[(long long)plane * M * plane_cols + m * plane_cols +
          (n - plane * plane_cols)] = y;
    }
  }
}

cudaError_t launch_f32(int mode, const void* x, const void* w, const void* b,
                       const void* res, void* out, long long M, int N, int K,
                       int planes, cudaStream_t st) {
  const int n_tiles = (N + SB - 1) / SB;
  const long long tiles = (M + SB - 1) / SB * n_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto* xx = static_cast<const float*>(x);
  const auto* ww = static_cast<const float*>(w);
  const auto* bb = static_cast<const float*>(b);
  const auto* rr = static_cast<const float*>(res);
  auto* oo = static_cast<float*>(out);
  const int pc = N / planes;
  const unsigned g = (unsigned)tiles;
  if (mode == 0)
    gemm_f32_kernel<0><<<g, kF32Threads, 0, st>>>(xx, ww, bb, rr, oo, M, N, K,
                                                  pc, n_tiles);
  else if (mode == 1)
    gemm_f32_kernel<1><<<g, kF32Threads, 0, st>>>(xx, ww, bb, rr, oo, M, N, K,
                                                  pc, n_tiles);
  else
    gemm_f32_kernel<2><<<g, kF32Threads, 0, st>>>(xx, ww, bb, rr, oo, M, N, K,
                                                  pc, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// K14. x: (rows, d) bf16 (dtype 1) or f32 (dtype 0), 16-byte aligned;
// gamma, beta: (d,) f32; out: (rows, d) in x's type. d is 32, 64, 128,
// 256, 512 or 1024.
extern "C" int ln_bf16_launch(const void* x, int dtype, const void* gamma,
                              const void* beta, float eps, long long rows,
                              int d, void* out, void* stream) {
  if (rows < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (dtype == 1)
    return ln_launch_t(static_cast<const __nv_bfloat16*>(x), g, b, eps, rows,
                       d, static_cast<__nv_bfloat16*>(out), st);
  return ln_launch_t(static_cast<const float*>(x), g, b, eps, rows, d,
                     static_cast<float*>(out), st);
}

// K15. x: (M, K), w: (N, K), both 16-byte aligned with K % 16 == 0; b:
// (N,); res: (M, N) for mode 1, else null; out: (planes, M, N / planes),
// 16-byte aligned; all bf16 (dtype 1) or all f32 (dtype 0); N % 8 == 0
// and (N / planes) % 8 == 0 (bf16 with planes > 1: % 64 == 0), planes ==
// 1 for mode 1.
extern "C" int gemm_bf16_launch(const void* x, const void* w, const void* b,
                                const void* res, void* out, int dtype,
                                int mode, long long M, int N, int K,
                                int planes, void* stream) {
  if (M < 0 || N < 8 || N % 8 != 0 || K < 16 || K % 16 != 0 || planes < 1 ||
      N % planes != 0 || (N / planes) % 8 != 0 || mode < 0 || mode > 2 ||
      (mode == 1) != (res != nullptr) || (mode == 1 && planes != 1) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_f32(mode, x, w, b, res, out, M, N, K, planes, st);
  return (int)launch_tc(mode, x, w, b, res, out, M, N, K, planes, st);
}
