// The Hopper tensor-core plumbing shared by K15 (dense.cu) and K10
// (qgemm.cu) — for sm_90a.
//
//   * mbarriers, TMA loads and stores (cp.async.bulk.tensor), the named
//     barrier of one warpgroup, the shared-memory descriptor of a K-major
//     tile under the 128-byte swizzle (rows of 128 bytes: 64 bf16 or 128
//     int8 values, so a wgmma k-step of 32 bytes is k16 in bf16 and k32
//     in int8);
//   * the output staging of a warpgroup's 64-row accumulators as the
//     128-byte-swizzled 64-column bf16 boxes the TMA reads and writes, and
//     the residual's TMA load into it;
//   * the tanh GELU of jax.nn.gelu in f32 (IEEE steps, tanhf) and its table
//     of the formula's own bf16 results, indexed by a bf16 input's bits;
//   * on the host, the driver's cuTensorMapEncodeTiled, fetched through the
//     runtime's cudaGetDriverEntryPoint (no link against libcuda).
// Everything sits in an anonymous namespace: each source that includes it
// is compiled into a library of its own.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the entry point is fetched
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ------------------------------------------------------------ row count
// The row tiles of `tile` rows that hold a row below live[0] * per, at
// most `tiles`; all of them without a count (K15's and K10's fused-route
// padding rows). Read by every thread at the kernel's start: the count was
// written by an earlier launch.
__device__ __forceinline__ long long live_row_tiles(const int* live, int per,
                                                    long long M, int tile,
                                                    long long tiles) {
  if (live == nullptr) return tiles;
  const long long n = (long long)max(__ldg(live), 0) * per;
  const long long t = ((n < M ? n : M) + tile - 1) / tile;
  return t < tiles ? t : tiles;
}

// ------------------------------------------------------------ GELU table
// The GELU's input is a bf16 value, so round(gelu(y)) is a function of 16
// bits. Each CTA tabulates it with gelu_tanh itself for 2^-61 <= |y| < 8
// (biased exponents 66..129: 64 x 128 mantissas) and y = +-0 (a zero bias
// on a zero product; K15 skips the fused routes' padding row tiles, whose
// leftover contents would be rare values), 8,193 slots of a positive
// and a negative entry, 16,386 in all (32 KB of shared memory), indexed by
// y's bits. The range reaches that far down because a narrower one (2^-10,
// 6.5 KB) left tiny values in most warps' 4,096 outputs a tile. The
// epilogue is issue-bound (one warp a scheduler runs it), so a lookup is a
// handful of integer steps: the slot clamped into the table, the sign as
// its low bit. Elsewhere (|y| >= 8, inf, NaN, |y| < 2^-61) a thread notes
// a rare value and, after its rows, runs the formula on those alone. A
// lookup returns the formula's bits: the table needs no bound of its own.
constexpr unsigned kGeluLo = 66u << 7;  // |y|'s bits at 2^-61
constexpr unsigned kGeluSpan = 64u << 7;  // slots of the range; zero's next
constexpr int kGeluEntries = 2 * (kGeluSpan + 1);

__device__ __forceinline__ uint16_t gelu_formula_bits(uint32_t b) {
  const float y = __bfloat162float(__ushort_as_bfloat16((uint16_t)b));
  return __bfloat16_as_ushort(__float2bfloat16_rn(gelu_tanh(y)));
}

// A table over another range (|y|'s bits from LO, SPAN slots) works the
// same way; its entries are 2 (SPAN + 1).

// |y|'s bits a (y's bits h) outside the table: neither in the range nor 0
template <unsigned LO = kGeluLo, unsigned SPAN = kGeluSpan>
__device__ __forceinline__ bool gelu_rare(uint32_t h) {
  const uint32_t u = (h & 0x7FFFu) - LO;
  return u >= SPAN && u != 0u - LO;
}

// the entry of y's bits h: 2 x slot + sign (a rare value lands on zero's)
template <unsigned LO = kGeluLo, unsigned SPAN = kGeluSpan>
__device__ __forceinline__ uint32_t gelu_index(uint32_t h) {
  const uint32_t u = (h & 0x7FFFu) - LO;
  return ((u < SPAN ? u : SPAN) << 1) | ((h >> 15) & 1u);
}

template <unsigned LO = kGeluLo, unsigned SPAN = kGeluSpan>
__device__ __forceinline__ void gelu_table_fill(uint16_t* tab) {
  for (int i = threadIdx.x; i < (int)(2 * (SPAN + 1)); i += blockDim.x) {
    const uint32_t slot = (uint32_t)i >> 1;
    tab[i] = gelu_formula_bits(((i & 1u) << 15) |
                               (slot < SPAN ? slot + LO : 0u));
  }
}

// ----------------------------------------------------- mbarriers and TMA
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

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
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

// shared-memory descriptor of a K-major tile under the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused,
// layout type 1 (SWIZZLE_128B) in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// ------------------------------------------------------ output staging
// One warpgroup's 64 rows x 128 columns of accumulators (rows [r0, r0 +
// 64) of the staging buffer) go through an epilogue into the staging
// buffer, laid out as the two 128-byte-swizzled ROWS x 64 boxes the TMA
// store reads (and, for the residual, the TMA load wrote): column pair (c,
// c + 1) of staging row r lands in box c / 64, row r, 16-byte chunk (c %
// 64 / 8) ^ (r % 8). Warp w of the warpgroup holds rows 16 w + lane / 4
// (+ 8); acc[4 j + 2 h + e] is column 8 j + 2 (lane % 4) + e of the row +
// 8 h (wgmma's m64nN accumulator layout).
template <int ROWS>
__device__ __forceinline__ __nv_bfloat162* staged_pair(uint8_t* buf, int j,
                                                       int r, int lane) {
  return reinterpret_cast<__nv_bfloat162*>(
      buf + (j >> 3) * (ROWS * 128) + r * 128 + (((j & 7) ^ (r & 7)) << 4) +
      (lane & 3) * 4);
}

// The residual's rows m0.. (one staging buffer's worth: two 64-column
// boxes of BOX bytes) into the staging buffer, on barrier bar, once the
// last store has read the buffer. Called by the warpgroup's leader.
template <int BOX>
__device__ __forceinline__ void load_residual(const CUtensorMap* map_res,
                                              uint8_t* buf, long long m0,
                                              int n0, int N, uint64_t* bar) {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  const int boxes = n0 + 64 < N ? 2 : 1;
  mbar_expect_tx(bar, boxes * BOX);
  for (int half = 0; half < boxes; ++half)
    tma_load_3d(buf + half * BOX, map_res, n0 + 64 * half, (int)m0, 0, bar);
}

// The staging buffer's rows [0, ROWS) out to rows m0.. of the output, one
// 64-column box at a time (each box lies in one plane: plane_cols % 64 ==
// 0 when there are several); rows past M and columns past N are clipped.
// Called by the warpgroup's leader.
template <int ROWS>
__device__ __forceinline__ void store_boxes(const CUtensorMap* map_out,
                                            const uint8_t* buf, long long m0,
                                            int n0, int N, int plane_cols) {
  for (int half = 0; half < 2; ++half) {
    const int n = n0 + 64 * half;
    if (n >= N) break;
    const int plane = n / plane_cols;
    tma_store_3d(map_out, buf + half * (ROWS * 128), n - plane * plane_cols,
                 (int)m0, plane);
  }
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// -------------------------------------------------- host: tensor maps
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

// a tensor of dims[0] x dims[1] x dims[2] elements of `esize` bytes
// (innermost first, packed), moved in 128-byte-swizzled boxes of box[0] x
// box[1] x box[2] (box[0] * esize <= 128)
bool make_map_of(CUtensorMap* map, CUtensorMapDataType type, int esize,
                 const void* ptr, int rank, const cuuint64_t* dims,
                 const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t strides[2] = {dims[0] * esize, dims[0] * dims[1] * esize};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the same for a bf16 tensor
bool make_map(CUtensorMap* map, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint32_t* box) {
  return make_map_of(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, rank,
                     dims, box);
}

}  // namespace
