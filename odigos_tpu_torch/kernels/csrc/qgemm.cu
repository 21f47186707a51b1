// K10: int8 x int8 -> int32 GEMM on tensor cores with the dequantize,
// bias and the block's next step fused into the epilogue — for Hopper
// (sm_90a).
//
// Replaces the product half of odigos_tpu/models/quantized.py _qdense
// (:72-78): acc = x_q . w_q in s32, y = acc * (a_s * w_s) + b in f32, cast
// to the working type — with what the block does next folded in
// (_block, :174-200):
//   mode 0 "none"            out = round_T(y)                  (q, k, v)
//   mode 1 "residual"        out = round_T(res + round_T(y))   (out, FFN2)
//   mode 2 "gelu_tanh"       out = round_T(gelu(round_T(y)))  (FFN1)
//   mode 3 "gelu_tanh_quant" h = round_bf16(gelu(round_bf16(y))), then
//                            FFN2's activation quantize of h (_qdense
//                            :63-71): a_s' = absmax_row(h) * f32(1/127),
//                            codes = clamp(rint(h / a_s'), ±127); writes
//                            the int8 codes and a_s', never h  (FFN1)
// Every f32 step is an IEEE-rounded __fmul_rn / __fadd_rn in the
// reference's order (a_s * w_s first), never contracted into an FMA, so
// the kernel equals its plain version bit for bit: the s32 sum is exact in
// any order, and so is its conversion to f32 (|acc| <= 1024 * 128^2 =
// 2^24). gelu is the tanh form of jax.nn.gelu (tc_common.cuh's gelu_tanh,
// tanhf), looked up in the table of its own bf16 results on the bf16
// path; mode 3's codes are quant_exact.cuh's, the same bits as K9's plain
// mode on h.
//
// x_q (M, K) int8 row-major, w_q (N, K) int8 (K-major: the Linear layout),
// a_s (M,), w_s (N,), b (N,) f32; out (M, N) in the working type, or split
// into `planes` planes of N / planes columns, (planes, M, N / planes), so
// that the fused QKV product leaves q, k and v each contiguous for K1.
//
// bf16 design (the serving path), K15's (dense.cu) on the s8 core:
// wgmma.mma_async m64nNk32 .s32.s8.s8 with both operands K-major in shared
// memory under the 128-byte swizzle (a row of 128 int8 values; s8 wgmma
// takes K-major operands only, which x_q and w_q already are), loaded by
// TMA with zero fill past M, N and K.
//   Modes 0-2: a persistent CTA (one per SM) holds two consumer
//   warpgroups, each computing whole 128 x 128 tiles (two m64n128 s32
//   accumulators) from its own mbarrier ring, filled by its own producer
//   warp; the CTA's tiles alternate between them (ping-pong), so one's
//   epilogue overlaps the other's products. At K <= 256 (QKV, out, FFN1)
//   the walk is weight-stationary: a CTA keeps its column tile's W slice
//   (at most 32 KB, half K15's) resident and walks row tiles, A rings 4
//   deep ("none") or 3; deeper K (FFN2) streams A and W tiles in a 2-deep
//   ring. The epilogue takes w_s and b (f32 pairs) from shared memory,
//   staged once a tile, a_s of its four rows in registers, the residual
//   from the staging buffer (loaded there by TMA), the GELU from the
//   table; it writes 128-byte-swizzled 64-column bf16 boxes that one thread
//   stores with the TMA. At K <= 256 the s32 sum becomes f32 by the 1.5 *
//   2^23 addition (exact for |acc| <= 2^22; two full-rate steps in place
//   of a quarter-rate conversion).
//   Mode 3 (N <= 1024, K <= 256): the row's absmax needs all its N
//   columns, so a cluster of 4 CTAs owns 64-row blocks: CTA rank r takes
//   columns [r nq, (r + 1) nq) (nq = N / 4, at most 256) and keeps those
//   rows of W1 resident (64 KB at d 256: W1 is read once per CTA, not once
//   per row block). Its two warpgroups take the cluster's row blocks in
//   turn, each with two A blocks (its producer warp keeps the next one
//   loading); for a block, m64n128 chunks, then pass 1 (dequantize, GELU
//   from a 16 KB table, |h| maxima) stages the bf16 h in shared memory
//   (rows swizzled by 16-byte chunks: no bank conflicts either way); the
//   rows' maxima go to the cluster's other CTAs through distributed shared
//   memory (remote stores and a remote mbarrier arrive, two slots by
//   parity); pass 2 reads h back a row a warp and stores 8 codes a lane,
//   256 contiguous bytes a warp. A warp stages and quantizes the same 16
//   rows, so it syncs with nobody but the cluster. Rank 0 writes the
//   scales.
// All offsets are 64-bit.
// f32 (dtype 0; no served route runs it on the card), and bf16 split into
// planes of a width off a multiple of 64 (a plane would cut the TMA
// stores' 64-column boxes): PR 5's kernel, a 128 x 128 output tile per CTA
// of 8 warps (2 x 4), each warp 64 x 32 as 4 x 4 mma.sync.m16n8k32 s8
// tiles, K in steps of 64 through a two-stage cp.async ring, tiles on a
// flat grid, N fastest, each output pair stored from registers.
//
// Bound on the card: bytes. At M = 131072 tokens: QKV (K 256, N 768) reads
// 33.6 MB of x_q and writes 201 MB of bf16 (0.070 ms at 3.35 TB/s);
// out-proj + residual (N 256) 33.6 + 67 + 67 MB (0.050 ms); FFN1 + GELU +
// quantize (N 1024) 33.6 + 0.3 MB in, 134.2 + 0.5 MB of codes and scales
// out (0.0505 ms); FFN2 + residual (K 1024) 134 + 67 + 67 MB (0.080 ms).
// The int8 tensor-core peak (1,979 TOP/s dense) would need 0.013-0.054 ms
// for the same products. Measured times are in PERF.md.

#include <cuda.h>  // CUtensorMap and its enums; the entry point is fetched
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "quant_exact.cuh"
#include "tc_common.cuh"  // mbarriers, TMA, staging, GELU table, maps

namespace {

// ---------------- f32 (dtype 0), bf16 planes off 64 columns: mma.sync
constexpr int SBM = 128;
constexpr int SBN = 128;
constexpr int SBK = 64;
constexpr int kSimtThreads = 256;
constexpr int LDS = SBK + 16;  // bytes per shared row: 80, ldmatrix-safe
constexpr int kSimtTileBytes = SBM * LDS;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one 128-row x 64-byte tile of a K-major int8 matrix with `rows` rows
__device__ __forceinline__ void load_tile(uint8_t* smem,
                                          const int8_t* __restrict__ g,
                                          long long row0, long long rows,
                                          int K, int k0) {
#pragma unroll
  for (int i = 0; i < (SBM * SBK / 16) / kSimtThreads; ++i) {
    const int c = threadIdx.x + i * kSimtThreads;
    const int r = c >> 2;
    const int kc = k0 + (c & 3) * 16;
    const bool ok = row0 + r < rows && kc < K;
    const int8_t* src = ok ? g + (row0 + r) * K + kc : g;
    cp_async16(smem_u32(smem + r * LDS + (c & 3) * 16), src, ok ? 16 : 0);
  }
}

template <typename T>
struct Out;
template <>
struct Out<float> {
  static __device__ __forceinline__ float round(float y) { return y; }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
};
template <>
struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float y) {
    return __bfloat162float(__float2bfloat16_rn(y));
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a,
                                                float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <typename T, int MODE>
__global__ void __launch_bounds__(kSimtThreads) qgemm_mma_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
    const float* __restrict__ as, const float* __restrict__ ws,
    const float* __restrict__ bias, const T* __restrict__ res,
    T* __restrict__ out, long long M, int N, int K, int plane_cols,
    int n_tiles) {
  __shared__ __align__(128) uint8_t smem[2][2][kSimtTileBytes];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;  // 0..1: 64-row half
  const int wn = warp & 3;   // 0..3: 32-column quarter
  const long long m0 = (long long)(blockIdx.x / n_tiles) * SBM;
  const int n0 = (int)(blockIdx.x % n_tiles) * SBN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (K + SBK - 1) / SBK;
  load_tile(smem[0][0], xq, m0, M, K, 0);
  load_tile(smem[0][1], wq, n0, N, K, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) {
      const int s = (kt + 1) & 1;
      load_tile(smem[s][0], xq, m0, M, K, (kt + 1) * SBK);
      load_tile(smem[s][1], wq, n0, N, K, (kt + 1) * SBK);
    }
    cp_async_commit();  // possibly empty: keeps wait_group 1 uniform
    cp_async_wait1();
    __syncthreads();
    const uint8_t* sa = smem[kt & 1][0];
    const uint8_t* sb = smem[kt & 1][1];
#pragma unroll
    for (int ks = 0; ks < SBK; ks += 32) {
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        // matrices: rows 0-7 | 8-15 of bytes 0-15, then of bytes 16-31
        ldmatrix_x4(smem_u32(sa + (wm * 64 + mi * 16 + (lane & 15)) * LDS +
                             ks + (lane >> 4) * 16),
                    a[mi]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: n 0-7 bytes 0-15 | 16-31, then n 8-15 likewise
        uint32_t r[4];
        ldmatrix_x4(smem_u32(sb + (wn * 32 + nj * 16 + (lane & 7) +
                                   (lane >> 4) * 8) * LDS +
                             ks + ((lane >> 3) & 1) * 16),
                    r);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    __syncthreads();  // the stage is refilled next iteration
  }

  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + wn * 32 + ni * 8 + t * 2;
    if (n >= N) continue;  // N % 8 == 0: the pair is wholly in or out
    const float ws0 = ws[n], ws1 = ws[n + 1];
    const float b0 = bias[n], b1 = bias[n + 1];
    const int plane = n / plane_cols;
    T* outp = out + (long long)plane * M * plane_cols + (n - plane *
                                                       plane_cols);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wm * 64 + mi * 16 + g + h * 8;
        if (m >= M) continue;
        const float a_s = as[m];
        float y0 = Out<T>::round(__fadd_rn(
            __fmul_rn((float)acc[mi][ni][2 * h], __fmul_rn(a_s, ws0)), b0));
        float y1 = Out<T>::round(__fadd_rn(
            __fmul_rn((float)acc[mi][ni][2 * h + 1], __fmul_rn(a_s, ws1)),
            b1));
        if constexpr (MODE == 2) {
          y0 = gelu_tanh(y0);
          y1 = gelu_tanh(y1);
        }
        if constexpr (MODE == 1) {
          y0 = __fadd_rn(Out<T>::load(res + m * N + n), y0);
          y1 = __fadd_rn(Out<T>::load(res + m * N + n + 1), y1);
        }
        Out<T>::store2(outp + m * plane_cols, y0, y1);
      }
    }
  }
}

template <typename T>
cudaError_t launch_mma(int mode, const void* xq, const void* wq,
                       const void* as, const void* ws, const void* b,
                       const void* res, void* out, long long M, int N, int K,
                       int planes, cudaStream_t st) {
  const int n_tiles = (N + SBN - 1) / SBN;
  const long long tiles = (M + SBM - 1) / SBM * n_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)tiles;
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* a = static_cast<const float*>(as);
  const float* s = static_cast<const float*>(ws);
  const float* bb = static_cast<const float*>(b);
  const T* r = static_cast<const T*>(res);
  T* o = static_cast<T*>(out);
  const int pc = N / planes;
  if (mode == 0)
    qgemm_mma_kernel<T, 0><<<grid, kSimtThreads, 0, st>>>(
        x, w, a, s, bb, r, o, M, N, K, pc, n_tiles);
  else if (mode == 1)
    qgemm_mma_kernel<T, 1><<<grid, kSimtThreads, 0, st>>>(
        x, w, a, s, bb, r, o, M, N, K, pc, n_tiles);
  else
    qgemm_mma_kernel<T, 2><<<grid, kSimtThreads, 0, st>>>(
        x, w, a, s, bb, r, o, M, N, K, pc, n_tiles);
  return cudaGetLastError();
}

// ------------------------------------------ bf16: wgmma s8 + TMA route
constexpr int BM = 128;  // rows of a tile: one consumer warpgroup's
constexpr int BN = 128;
constexpr int BK = 128;  // 128 bytes of int8: one 128-byte swizzle row
constexpr int kConsumerWgs = 2;
constexpr int kTcThreads = 160 * kConsumerWgs;  // + a producer warp each
constexpr int kTile = BM * BK;  // an A or a W tile: 16 KB
constexpr int kMaxStages = 4;
// Weight-stationary walk (K <= kWsMaxK): the CTA keeps its BN x K slice of
// W resident and its ring stages hold A tiles only.
constexpr int kWsMaxK = 256;
constexpr int kWsSlice = kWsMaxK / BK * kTile;
constexpr int kTabBytes = (kGeluEntries * 2 + 15) / 16 * 16;  // the table

// s32 -> f32, exactly: at K <= 256 |acc| <= 256 * 128^2 = 2^22, where the
// 1.5 * 2^23 addition is exact; deeper K converts
template <bool SMALL>
__device__ __forceinline__ float acc_f32(int a) {
  if constexpr (SMALL)
    return __fsub_rn(__int_as_float(a + kRoundMagicBits), kRoundMagic);
  return __int2float_rn(a);
}

// round_bf16(acc * (a_s * w_s) + b) of two neighbouring columns
template <bool SMALL>
__device__ __forceinline__ __nv_bfloat162 dequant2(int a0, int a1, float as,
                                                   float2 ws, float2 b) {
  const float y0 =
      __fadd_rn(__fmul_rn(acc_f32<SMALL>(a0), __fmul_rn(as, ws.x)), b.x);
  const float y1 =
      __fadd_rn(__fmul_rn(acc_f32<SMALL>(a1), __fmul_rn(as, ws.y)), b.y);
  return __floats2bfloat162_rn(y0, y1);
}

__device__ __forceinline__ uint32_t bits2(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// round(gelu(y)) of a bf16 pair's bits v from the table over |y|'s bits
// [LO, LO + SPAN) and zero; notes a rare value
template <unsigned LO = kGeluLo, unsigned SPAN = kGeluSpan>
__device__ __forceinline__ uint32_t gelu_pair(uint32_t v,
                                              const uint16_t* __restrict__ tab,
                                              bool& rare) {
  rare |= gelu_rare<LO, SPAN>(v & 0xFFFFu) | gelu_rare<LO, SPAN>(v >> 16);
  return (uint32_t)tab[gelu_index<LO, SPAN>(v & 0xFFFFu)] |
         ((uint32_t)tab[gelu_index<LO, SPAN>(v >> 16)] << 16);
}

// the formula on a pair's rare values, the table's results elsewhere
template <unsigned LO = kGeluLo, unsigned SPAN = kGeluSpan>
__device__ __forceinline__ uint32_t gelu_pair_fix(uint32_t y, uint32_t h) {
  if (gelu_rare<LO, SPAN>(y & 0xFFFFu))
    h = (h & 0xFFFF0000u) | gelu_formula_bits(y & 0xFFFFu);
  if (gelu_rare<LO, SPAN>(y >> 16))
    h = (h & 0xFFFFu) | ((uint32_t)gelu_formula_bits(y >> 16) << 16);
  return h;
}

// Shared memory of one build (227 KB at most): the W slice (WS), each
// warpgroup's ring of kStages stages (streaming: an A and a W tile each;
// weight-stationary: an A tile each) and its output staging, half a tile
// (two 64 x 64 boxes, stored and refilled twice a tile) or, for the
// weight-stationary residual step, a whole 128-row tile; the GELU table
// (mode 2); each warpgroup's w_s and b pairs.
template <int MODE, bool WS>
struct TcCfg {
  static constexpr bool kHalf = !(WS && MODE == 1);
  static constexpr int kStages = WS ? (MODE == 0 ? 4 : 3) : 2;
  static constexpr int kStageBytes = WS ? kTile : 2 * kTile;
  static constexpr int kBoxRows = kHalf ? BM / 2 : BM;
  static constexpr int kBoxBytes = kBoxRows * 64 * 2;  // rows x 64 bf16
  static constexpr int kWgBytes = kStages * kStageBytes + 2 * kBoxBytes;
  static constexpr int kMain = (WS ? kWsSlice : 0) + kConsumerWgs * kWgBytes;
  static constexpr int kTab = MODE == 2 ? kTabBytes : 0;
  static constexpr int kScal = kConsumerWgs * BN * 8;  // f32 w_s, b
  static constexpr int kSmem = 1024 + kMain + kTab + kScal;
  static_assert(kStages <= kMaxStages, "barrier arrays");
  static_assert(kSmem + 256 <= 232448, "over the 227 KB a block may use");
};

// d (+)= a . b; scale_d == 0 overwrites d (the first k-step: no zeroing)
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t da,
                                                    uint64_t db,
                                                    int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One warpgroup's 64 rows x 128 columns of s32 accumulators (rows [r0, r0
// + 64) of the staging buffer) dequantized through the epilogue into the
// staging buffer (staged_pair, tc_common.cuh). The thread's rows use the
// scales as_lo (row + 0) and as_hi (row + 8); s_ws / s_b hold the tile's
// column pairs. MODE 2 stages the table's results and notes a rare value;
// a thread that has one runs its outputs again, the formula on the rare
// ones alone. A chunk's shared-memory loads go before its stores.
template <int MODE, int ROWS, bool SMALL>
__device__ __forceinline__ void epilogue_rows(
    const int (&acc)[64], int r0, uint8_t* __restrict__ buf,
    const float2* __restrict__ s_ws, const float2* __restrict__ s_b,
    float as_lo, float as_hi, const uint16_t* __restrict__ tab) {
  constexpr int kChunk = 4;
  const int lane = threadIdx.x & 31;
  const int rw = r0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  bool rare = false;
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += kChunk) {
    uint32_t v[kChunk][2];
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const int j = j0 + jj;
      const float2 w = s_ws[j * 4 + (lane & 3)];
      const float2 b = s_b[j * 4 + (lane & 3)];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162 y = dequant2<SMALL>(acc[4 * j + 2 * h],
                                           acc[4 * j + 2 * h + 1],
                                           h ? as_hi : as_lo, w, b);
        if constexpr (MODE == 1)  // round(res + y): the residual by TMA
          y = __hadd2(*staged_pair<ROWS>(buf, j, rw + 8 * h, lane), y);
        v[jj][h] = bits2(y);
      }
    }
    if constexpr (MODE == 2) {
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) v[jj][h] = gelu_pair(v[jj][h], tab, rare);
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
        const float2 w = s_ws[j * 4 + (lane & 3)];
        const float2 b = s_b[j * 4 + (lane & 3)];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t y = bits2(dequant2<SMALL>(
              acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], h ? as_hi : as_lo,
              w, b));
          uint32_t* e = reinterpret_cast<uint32_t*>(
              staged_pair<ROWS>(buf, j, rw + 8 * h, lane));
          *e = gelu_pair_fix(y, *e);
        }
      }
    }
  }
}

// Persistent, two ping-pong consumer warpgroups each with its own ring and
// producer warp (K15's gemm_tc_kernel, on the s8 core). The walk:
//   WS     the CTA owns column tile blockIdx.x % n_tiles, whose W slice
//          (BN x K, K <= kWsMaxK) it loads once, and row tiles
//          blockIdx.x / n_tiles + i * groups;
//   else   tiles blockIdx.x, + gridDim.x, ... in the flat (m, n) order, N
//          fastest, each stage holding an A and a W tile.
// The consumer keeps one wgmma group in flight and frees a stage one step
// after its products were issued.
template <int MODE, bool WS>
__global__ void __launch_bounds__(kTcThreads, 1) qgemm_s8_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_out,
    const __grid_constant__ CUtensorMap map_res,
    const float* __restrict__ as, const float* __restrict__ ws,
    const float* __restrict__ bias, long long M, int N, int K,
    int plane_cols, int n_tiles, long long m_tiles) {
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
  auto* scal = reinterpret_cast<float2*>(smem + C::kMain + C::kTab);
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

  const int wg = warp < 4 * kConsumerWgs ? warp >> 2
                                         : warp - 4 * kConsumerWgs;
  uint8_t* wslice = smem;  // WS: the CTA's W slice, ktiles boxes
  uint8_t* ring = smem + (WS ? kWsSlice : 0) + wg * C::kWgBytes;
  uint8_t* out_buf = ring + S * kStageBytes;
  uint64_t* full = full_bars[wg];
  uint64_t* empty = empty_bars[wg];
  const long long stride = WS ? gridDim.x / n_tiles : gridDim.x;
  const long long first =
      (WS ? blockIdx.x / n_tiles : blockIdx.x) + wg * stride;
  const long long step = kConsumerWgs * stride;
  const long long limit = WS ? m_tiles : m_tiles * n_tiles;
  const int ws_col = WS ? (int)(blockIdx.x % n_tiles) : 0;

  if (warp >= 4 * kConsumerWgs) {  // a producer warp: one lane loads
    if (lane == 0) {
      if (WS && wg == 0) {
        mbar_expect_tx(&w_bar, ktiles * kTile);
        for (int kt = 0; kt < ktiles; ++kt)
          tma_load_2d(wslice + kt * kTile, &map_w, kt * BK, ws_col * BN,
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
            tma_load_2d(st + kTile, &map_w, kt * BK, n0, &full[s]);
        }
      }
    }
    return;
  }

  const bool leader = (threadIdx.x & 127) == 0;
  float2* s_ws = scal + wg * BN;  // the tile's column pairs: w_s, then b
  float2* s_b = s_ws + BN / 2;
  const int rw = (warp & 3) * 16 + (lane >> 2);
  if (WS && first < limit) mbar_wait(&w_bar, 0);
  long long it = 0;
  int res_phase = 0;  // residual loads waited for so far: their parity
  for (long long q = first; q < limit; q += step) {
    const long long m0 = (WS ? q : q / n_tiles) * BM;
    const int n0 = (WS ? ws_col : (int)(q % n_tiles)) * BN;
    int acc0[64], acc1[64];  // tile rows [0, 64) and [64, 128)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = (int)(it % S);
      mbar_wait(&full[s], (int)((it / S) & 1));
      const uint32_t a = smem_u32(ring + s * kStageBytes);
      const uint32_t b = WS ? smem_u32(wslice + kt * kTile) : a + kTile;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {  // 32 bytes along the swizzle
        const uint64_t db = sw128_desc(b + kk * 32);
        wgmma_s8_m64n128k32(acc0, sw128_desc(a + kk * 32), db);
        wgmma_s8_m64n128k32(acc1, sw128_desc(a + 64 * 128 + kk * 32), db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (MODE == 1 && kt == 0 && leader)
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

    // the staging buffer is free once the last store has read it
    if (MODE != 1 && leader)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    {  // the tile's w_s and b pairs, once (N % 8 == 0: a pair is in or out)
      const int t = threadIdx.x & 127;
      const int n = n0 + 2 * (t & 63);
      const float* src = t < 64 ? ws : bias;
      (t < 64 ? s_ws : s_b)[t & 63] =
          n < N ? *reinterpret_cast<const float2*>(src + n)
                : make_float2(0.f, 0.f);
    }
    float asr[4];  // a_s of the thread's rows: + 0, + 8, + 64, + 72
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + rw + (i & 1) * 8 + (i >> 1) * 64;
      asr[i] = m < M ? as[m] : 0.f;
    }
    wg_sync(1 + wg);
    if constexpr (MODE == 1) mbar_wait(&res_bars[wg], res_phase++ & 1);
    if constexpr (C::kHalf) {  // rows [0, 64), stored; then [64, 128)
      epilogue_rows<MODE, ROWS, WS>(acc0, 0, out_buf, s_ws, s_b, asr[0],
                                    asr[1], gelu_tab);
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
      epilogue_rows<MODE, ROWS, WS>(acc1, 0, out_buf, s_ws, s_b, asr[2],
                                    asr[3], gelu_tab);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(1 + wg);
      if (leader)
        store_boxes<ROWS>(&map_out, out_buf, m0 + 64, n0, N, plane_cols);
    } else {
      epilogue_rows<MODE, ROWS, WS>(acc0, 0, out_buf, s_ws, s_b, asr[0],
                                    asr[1], gelu_tab);
      epilogue_rows<MODE, ROWS, WS>(acc1, 64, out_buf, s_ws, s_b, asr[2],
                                    asr[3], gelu_tab);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(1 + wg);
      if (leader) store_boxes<ROWS>(&map_out, out_buf, m0, n0, N, plane_cols);
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ------------------------------- bf16 mode 3: FFN1 + GELU + quantize
constexpr int kQCl = 4;             // CTAs of a cluster: a row's columns
constexpr int QBM = 64;             // rows of a block: one warpgroup's wgmma M
constexpr int QCH = 128;            // columns of a chunk (m64n128k32)
constexpr int kQCols = 256;         // a CTA's columns at most: two chunks
constexpr int kQMaxN = kQCl * kQCols;  // d_ff: 1024
constexpr int kQMaxK = 256;
constexpr int kQKt = kQMaxK / BK;   // k-tiles
constexpr int kQABox = QBM * BK;    // a 64-row x 128-byte box of A: 8 KB
constexpr int kQW = kQKt * kQCols * BK;  // the resident W columns: 64 KB
constexpr int kQA = kQKt * kQABox;  // an A block: 16 KB
constexpr int kQRow = kQCols * 2;   // a row of staged bf16 h: 512 B
constexpr int kQH = QBM * kQRow;    // an h block: 32 KB
constexpr int kQX = 2 * kQCl * QBM * 4;  // the rows' maxima, two slots
constexpr int kQWg = 2 * kQA + kQH + kQX;  // a warpgroup's: 66 KB
// The GELU table over 2^-29 <= |y| < 8 (biased exponents 98..129) and
// zero, 16 KB: half K15's, so each warpgroup's A blocks fit twice. A
// smaller |y| (never the padded rows' exact zero) takes the formula.
constexpr unsigned kQGeluLo = 98u << 7;
constexpr unsigned kQGeluSpan = 32u << 7;
constexpr int kQTabBytes = (2 * ((int)kQGeluSpan + 1) * 2 + 15) / 16 * 16;
constexpr int kQSmem = 1024 + kQW + kConsumerWgs * kQWg + kQTabBytes +
                       kQCols * 8;
static_assert(kQSmem + 256 <= 232448, "over the 227 KB a block may use");

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the shared::cluster address of p's counterpart in CTA `rank`
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void peer_store(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}
__device__ __forceinline__ void peer_arrive(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// |h| of a bf16 pair's bits, as a bf16 pair
__device__ __forceinline__ __nv_bfloat162 abs2(uint32_t h) {
  const uint32_t a = h & 0x7FFF7FFFu;
  return *reinterpret_cast<const __nv_bfloat162*>(&a);
}

// the staged h pair at row r, columns c, c + 1 of an h block: rows of 512
// bytes, 16-byte chunks swizzled by the row's low bits, so the accumulator
// layout's stores (8 rows x 4 pairs a warp) and the row reads (a row's 32
// chunks a warp) are both free of bank conflicts
__device__ __forceinline__ uint32_t* h_pair(uint8_t* hb, int r, int c) {
  return reinterpret_cast<uint32_t*>(hb + r * kQRow +
                                     ((((c >> 3) ^ (r & 7))) << 4) +
                                     (c & 7) * 2);
}

// Pass 1 of a 128-column chunk (columns c0.. of the CTA's): the thread's
// s32 accumulators (acc[4 j + 2 h + e]: column c0 + 8 j + 2 q + e of row
// rw + 8 h) dequantized with the chunk's w_s / b pairs and the rows' input
// scales asr, rounded to bf16, through the GELU table (the formula for
// rare values) into the staged h, |h| folded into the rows' maxima mx.
__device__ __forceinline__ void chunk_gelu(const int (&acc)[64], int c0,
                                           const float2* __restrict__ s_ws,
                                           const float2* __restrict__ s_b,
                                           const float (&asr)[2],
                                           const uint16_t* __restrict__ tab,
                                           uint8_t* hb, int rw,
                                           __nv_bfloat162 (&mx)[2]) {
  const int q4 = threadIdx.x & 3;
  bool rare = false;
#pragma unroll
  for (int j = 0; j < QCH / 8; ++j) {
    const int p = (c0 >> 1) + j * 4 + q4;
    const float2 w = s_ws[p], b = s_b[p];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t v = gelu_pair<kQGeluLo, kQGeluSpan>(
          bits2(dequant2<true>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                               asr[h], w, b)),
          tab, rare);
      *h_pair(hb, rw + 8 * h, c0 + 8 * j + 2 * q4) = v;
      mx[h] = __hmax2(mx[h], abs2(v));
    }
  }
  if (rare) {  // the formula on the rare values (their maxima too)
#pragma unroll
    for (int j = 0; j < QCH / 8; ++j) {
      const int p = (c0 >> 1) + j * 4 + q4;
      const float2 w = s_ws[p], b = s_b[p];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* e = h_pair(hb, rw + 8 * h, c0 + 8 * j + 2 * q4);
        const uint32_t v = gelu_pair_fix<kQGeluLo, kQGeluSpan>(
            bits2(dequant2<true>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                                 asr[h], w, b)),
            *e);
        *e = v;
        mx[h] = __hmax2(mx[h], abs2(v));
      }
    }
  }
}

// Pass 2 of row r: lane l quantizes the row's staged h columns 8 l ..
// 8 l + 7 with its a_s (inv = fl(1 / a_s)) and, if `store`, stores the 8
// codes at dst. A branch, rarely taken, redoes the row by the true
// division where a product lies near a rounding boundary.
__device__ __forceinline__ void row_codes(const uint8_t* hb, int r, float a,
                                          float inv, int8_t* __restrict__ dst,
                                          bool store) {
  const int lane = threadIdx.x & 31;
  const uint4 u = *reinterpret_cast<const uint4*>(hb + r * kQRow +
                                                  ((lane ^ (r & 7)) << 4));
  const uint32_t v[4] = {u.x, u.y, u.z, u.w};
  int m[8];
  bool near = false;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    m[2 * e] = quant_code_bits(__uint_as_float(v[e] << 16), inv, near);
    m[2 * e + 1] =
        quant_code_bits(__uint_as_float(v[e] & 0xFFFF0000u), inv, near);
  }
  if (near) {  // rare: a product near a rounding boundary
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      m[2 * e] = quant_code_exact(__uint_as_float(v[e] << 16), a);
      m[2 * e + 1] = quant_code_exact(__uint_as_float(v[e] & 0xFFFF0000u), a);
    }
  }
  // the low byte of each is the code
  const uint32_t w0 = __byte_perm(__byte_perm(m[0], m[1], 0x0040),
                                  __byte_perm(m[2], m[3], 0x0040), 0x5410);
  const uint32_t w1 = __byte_perm(__byte_perm(m[4], m[5], 0x0040),
                                  __byte_perm(m[6], m[7], 0x0040), 0x5410);
  if (store) *reinterpret_cast<uint2*>(dst) = make_uint2(w0, w1);
}

// Pass 2 of a 64-row block for warp w of a warpgroup: its rows 16 w ..
// 16 w + 15 (the rows it staged), a_s from the maxima xs[rank][row] of
// every CTA, rank 0 writing the scales.
__device__ __forceinline__ void block_codes(const uint8_t* hb,
                                            const float* xs, long long m0,
                                            long long M, int N, int col0,
                                            int valid, bool write_scales,
                                            int8_t* __restrict__ codes,
                                            float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const int w16 = ((threadIdx.x >> 5) & 3) * 16;
  // lane l % 16's row: its a_s and fl(1 / a_s)
  const int r_own = w16 + (lane & 15);
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < kQCl; ++k) amax = fmaxf(amax, xs[k * QBM + r_own]);
  const float a_own = quant_scale(amax);
  const float inv_own = __fdiv_rn(1.0f, a_own);
  if (write_scales && lane < 16 && m0 + r_own < M) scales[m0 + r_own] = a_own;
  const bool lane_in = 8 * lane < valid;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const long long m = m0 + w16 + i;
    row_codes(hb, w16 + i, __shfl_sync(0xffffffffu, a_own, i),
              __shfl_sync(0xffffffffu, inv_own, i),
              codes + m * N + col0 + 8 * lane, lane_in && m < M);
  }
}

// A cluster of kQCl CTAs owns 64-row blocks: CTA rank r takes columns
// [r nq, r nq + nq) (nq = N / kQCl rounded up to 8, at most 256) with
// those rows of W resident. Its two warpgroups take the cluster's blocks
// in turn (warpgroup g: blocks cid + (2 i + g) * n_clusters), and
// warpgroup g of every CTA of the cluster the same blocks, so they meet to
// swap their rows' maxima: each quad leader stores its two rows' maxima
// into the other CTAs' shared memory (slot by parity) and arrives on
// their barrier. Pass 1 stages h in shared memory; pass 2 reads it back a
// row a warp, coalesced. Warp w holds rows 16 w .. 16 w + 15 of the block
// in both passes, so it syncs with nobody but the cluster; a producer
// warp keeps the warpgroup's next A block loading into its second buffer.
__global__ void __launch_bounds__(kTcThreads, 1) qgemm_s8_quant_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w, const float* __restrict__ as,
    const float* __restrict__ ws, const float* __restrict__ bias,
    int8_t* __restrict__ codes, float* __restrict__ scales, long long M,
    int N, int K, int nq, long long m_blocks) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t a_full[kConsumerWgs][2];
  __shared__ __align__(8) uint64_t a_empty[kConsumerWgs][2];
  __shared__ __align__(8) uint64_t x_bars[kConsumerWgs][2];
  __shared__ __align__(8) uint64_t w_bar;
  uint8_t* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* wq_s = smem;  // [k-tile][kQCols rows of 128 bytes]
  // per warpgroup: two A blocks, h, the maxima's two slots
  uint8_t* wg_base = smem + kQW;
  uint16_t* gelu_tab =
      reinterpret_cast<uint16_t*>(wg_base + kConsumerWgs * kQWg);
  auto* s_ws = reinterpret_cast<float2*>(wg_base + kConsumerWgs * kQWg +
                                         kQTabBytes);
  float2* s_b = s_ws + kQCols / 2;
  const int ktiles = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t rank = cluster_rank();
  const long long cid = cluster_id();
  const long long n_clusters = cluster_count();
  const int col0 = (int)rank * nq;
  const int valid = min(nq, N - col0);  // this CTA's columns (may be <= 0)
  const int nch = valid > 0 ? (valid + QCH - 1) / QCH : 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int g = 0; g < kConsumerWgs; ++g) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        mbar_init(&a_full[g][s], 1);
        mbar_init(&a_empty[g][s], 4);  // the warpgroup's four warps
        mbar_init(&x_bars[g][s], 32 * (kQCl - 1));  // the others' leaders
      }
    }
    mbar_init(&w_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  gelu_table_fill<kQGeluLo, kQGeluSpan>(gelu_tab);
  for (int p = threadIdx.x; p < kQCols / 2; p += blockDim.x) {
    const int n = col0 + 2 * p;
    const bool in = 2 * p < valid;
    s_ws[p] = in ? *reinterpret_cast<const float2*>(ws + n)
                 : make_float2(0.f, 0.f);
    s_b[p] = in ? *reinterpret_cast<const float2*>(bias + n)
                : make_float2(0.f, 0.f);
  }
  __syncthreads();
  cluster_sync();  // the other CTAs' barriers are initialised

  const int wg = warp < 4 * kConsumerWgs ? warp >> 2
                                         : warp - 4 * kConsumerWgs;
  uint8_t* a_mine = wg_base + wg * kQWg;  // [2][kQA]
  uint8_t* hb = a_mine + 2 * kQA;
  float* xbuf = reinterpret_cast<float*>(hb + kQH);  // [slot][rank][row]
  const long long first = cid + wg * n_clusters;
  const long long step = kConsumerWgs * n_clusters;

  if (warp >= 4 * kConsumerWgs) {  // a producer warp: one lane loads
    if (lane == 0) {
      if (wg == 0) {  // the resident W rows, a 128-row box a chunk
        mbar_expect_tx(&w_bar, ktiles * nch * kTile);
        for (int kt = 0; kt < ktiles; ++kt)
          for (int c = 0; c < nch; ++c)
            tma_load_2d(wq_s + kt * kQCols * BK + c * kTile, &map_w,
                        kt * BK, col0 + c * QCH, &w_bar);
      }
      long long it = 0;
      for (long long q = first; q < m_blocks; q += step, ++it) {
        const int s = (int)(it & 1);  // two A blocks in turn
        if (it >= 2) mbar_wait(&a_empty[wg][s], (int)(((it >> 1) - 1) & 1));
        mbar_expect_tx(&a_full[wg][s], ktiles * kQABox);
        for (int kt = 0; kt < ktiles; ++kt)
          tma_load_2d(a_mine + s * kQA + kt * kQABox, &map_x, kt * BK,
                      (int)(q * QBM), &a_full[wg][s]);
      }
    }
    return;
  }

  const int q4 = lane & 3;
  const int rw = (warp & 3) * 16 + (lane >> 2);  // rows rw, rw + 8
  if (first < m_blocks) mbar_wait(&w_bar, 0);
  const uint32_t w_base = smem_u32(wq_s);
  long long it = 0;
  for (long long q = first; q < m_blocks; q += step, ++it) {
    const long long m0 = q * QBM;
    const int s = (int)(it & 1);
    float asr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + rw + 8 * h;
      asr[h] = m < M ? as[m] : 0.f;
    }
    __nv_bfloat162 mx[2];  // max |h| of the thread's two rows
    mx[0] = mx[1] = __floats2bfloat162_rn(0.f, 0.f);
    mbar_wait(&a_full[wg][s], (int)((it >> 1) & 1));
    const uint32_t a_base = smem_u32(a_mine + s * kQA);
#pragma unroll
    for (int c = 0; c < kQCols / QCH; ++c) {
      if (c >= nch) break;
      int acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8_m64n128k32(
              acc, sw128_desc(a_base + kt * kQABox + kk * 32),
              sw128_desc(w_base + kt * kQCols * BK + c * kTile + kk * 32));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (c == nch - 1) {  // the block's A is read: free it
        __syncwarp();
        if (lane == 0) mbar_arrive(&a_empty[wg][s]);
      }
      chunk_gelu(acc, c * QCH, s_ws, s_b, asr, gelu_tab, hb, rw, mx);
    }
    if (nch == 0) {  // no products: the A block is free at once
      __syncwarp();
      if (lane == 0) mbar_arrive(&a_empty[wg][s]);
    }
    // the rows' maxima over this CTA's columns, to every CTA's slot
    float* xs = xbuf + s * kQCl * QBM;  // [rank][row]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = fmaxf(__low2float(mx[h]), __high2float(mx[h]));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (q4 == 0) {
        const int i = (int)rank * QBM + rw + 8 * h;
        xs[i] = v;
#pragma unroll
        for (uint32_t d = 1; d < kQCl; ++d)
          peer_store(peer_addr(xs + i, (rank + d) % kQCl), v);
      }
    }
    if (q4 == 0) {
#pragma unroll
      for (uint32_t d = 1; d < kQCl; ++d)
        peer_arrive(peer_addr(&x_bars[wg][s], (rank + d) % kQCl));
    }
    mbar_wait_cluster(&x_bars[wg][s], (int)((it >> 1) & 1));
    __syncwarp();  // the warp's rows of h and its own maxima are staged
    block_codes(hb, xs, m0, M, N, col0, valid, rank == 0, codes, scales);
    __syncwarp();  // h is read: the next block may stage the warp's rows
  }
}

// ---------------------------------------------------------------- host
struct TcArgs {
  CUtensorMap mx, mw, mo, mo_half, mr, mr_half;
  const float *as, *ws, *b;
  long long M;
  int N, K, pc, sms;
};

template <int MODE, bool WS>
cudaError_t launch_tc_mode(const TcArgs& a, cudaStream_t st) {
  using C = TcCfg<MODE, WS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      qgemm_s8_kernel<MODE, WS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  qgemm_s8_kernel<MODE, WS><<<(unsigned)grid, kTcThreads, C::kSmem, st>>>(
      a.mx, a.mw, C::kHalf ? a.mo_half : a.mo, C::kHalf ? a.mr_half : a.mr,
      a.as, a.ws, a.b, a.M, a.N, a.K, a.pc, n_tiles, m_tiles);
  return cudaGetLastError();
}

template <bool WS>
cudaError_t launch_tc_walk(int mode, const TcArgs& a, cudaStream_t st) {
  switch (mode) {
    case 0: return launch_tc_mode<0, WS>(a, st);
    case 1: return launch_tc_mode<1, WS>(a, st);
    default: return launch_tc_mode<2, WS>(a, st);
  }
}

bool make_map_s8(CUtensorMap* map, const void* ptr, cuuint64_t K,
                 cuuint64_t rows, cuuint32_t box_rows) {
  const cuuint64_t dims[2] = {K, rows};
  const cuuint32_t box[2] = {BK, box_rows};
  return make_map_of(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ptr, 2, dims,
                     box);
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

cudaError_t launch_tc(int mode, const void* x, const void* w, const void* as,
                      const void* ws, const void* b, const void* res,
                      void* out, long long M, int N, int K, int planes,
                      cudaStream_t st) {
  TcArgs a;
  a.pc = N / planes;  // planes > 1: a multiple of 64 (qgemm_launch)
  cudaError_t e = sm_count(&a.sms);
  if (e != cudaSuccess) return e;
  const cuuint64_t dout[3] = {(cuuint64_t)a.pc, (cuuint64_t)M,
                              (cuuint64_t)planes};
  const cuuint64_t dres[3] = {(cuuint64_t)N, (cuuint64_t)M, 1};
  const cuuint32_t bo[3] = {64, BM, 1}, bh[3] = {64, BM / 2, 1};
  if (!make_map_s8(&a.mx, x, K, M, BM) || !make_map_s8(&a.mw, w, K, N, BN) ||
      !make_map(&a.mo, out, 3, dout, bo) ||
      !make_map(&a.mo_half, out, 3, dout, bh) ||
      !make_map(&a.mr, mode == 1 ? res : out, 3, mode == 1 ? dres : dout,
                bo) ||
      !make_map(&a.mr_half, mode == 1 ? res : out, 3,
                mode == 1 ? dres : dout, bh))
    return cudaErrorInvalidValue;
  a.as = static_cast<const float*>(as);
  a.ws = static_cast<const float*>(ws);
  a.b = static_cast<const float*>(b);
  a.M = M;
  a.N = N;
  a.K = K;
  const int n_tiles = (N + BN - 1) / BN;
  if (K <= kWsMaxK && n_tiles <= a.sms)
    return launch_tc_walk<true>(mode, a, st);
  return launch_tc_walk<false>(mode, a, st);
}

cudaError_t launch_quant(const void* x, const void* w, const void* as,
                         const void* ws, const void* b, void* codes,
                         void* scales, long long M, int N, int K,
                         cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      qgemm_s8_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kQSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap mx, mw;
  if (!make_map_s8(&mx, x, K, M, QBM) || !make_map_s8(&mw, w, K, N, QCH))
    return cudaErrorInvalidValue;
  const int nq = ((N + kQCl - 1) / kQCl + 7) / 8 * 8;  // <= kQCols
  const long long m_blocks = (M + QBM - 1) / QBM;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = kQCl;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = kQSmem;
  cfg.stream = st;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3((unsigned)(sms / kQCl * kQCl));
  static int clusters = 0;  // the card's resident clusters: asked once
  if (clusters == 0) {
    e = cudaOccupancyMaxActiveClusters(&clusters, qgemm_s8_quant_kernel,
                                       &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
  }
  const long long n = clusters < m_blocks ? clusters : m_blocks;
  cfg.gridDim = dim3((unsigned)(kQCl * n));
  return cudaLaunchKernelEx(&cfg, qgemm_s8_quant_kernel, mx, mw,
                            static_cast<const float*>(as),
                            static_cast<const float*>(ws),
                            static_cast<const float*>(b),
                            static_cast<int8_t*>(codes),
                            static_cast<float*>(scales), M, N, K, nq,
                            m_blocks);
}

}  // namespace

// K10. xq: (M, K) int8, wq: (N, K) int8, both 16-byte aligned with
// K % 16 == 0; as: (M,), ws, b: (N,) f32, 8-byte aligned; res: (M, N) in
// the output type for mode 1, else null; out: (planes, M, N / planes) bf16
// (dtype 1) or f32 (dtype 0), 16-byte aligned, N % 8 == 0 and (N /
// planes) % 8 == 0, planes == 1 for mode 1. Mode 3 (bf16 only, N <= 1024,
// K <= 256, planes 1): out is the (M, N) int8 codes, scales the (M,) f32
// a_s of FFN2's input; else scales is null.
extern "C" int qgemm_launch(const void* xq, const void* wq, const void* as,
                            const void* ws, const void* b, const void* res,
                            void* out, void* scales, int dtype, int mode,
                            long long M, int N, int K, int planes,
                            void* stream) {
  if (M < 0 || N < 8 || N % 8 != 0 || K < 16 || K % 16 != 0 || planes < 1 ||
      N % planes != 0 || (N / planes) % 8 != 0 || mode < 0 || mode > 3 ||
      (mode == 1) != (res != nullptr) || (mode == 1 && planes != 1) ||
      (mode == 3) != (scales != nullptr) ||
      (mode == 3 && (dtype != 1 || planes != 1 || N > kQMaxN ||
                     K > kQMaxK)) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 3)
    return (int)launch_quant(xq, wq, as, ws, b, out, scales, M, N, K, st);
  if (dtype == 0)
    return (int)launch_mma<float>(mode, xq, wq, as, ws, b, res, out, M, N, K,
                                  planes, st);
  if (planes > 1 && (N / planes) % 64 != 0)  // a plane splits a TMA box
    return (int)launch_mma<__nv_bfloat16>(mode, xq, wq, as, ws, b, res, out,
                                          M, N, K, planes, st);
  return (int)launch_tc(mode, xq, wq, as, ws, b, res, out, M, N, K, planes,
                        st);
}
