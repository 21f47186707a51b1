// K10: int8 x int8 -> int32 GEMM on tensor cores with the dequantize,
// bias and the block's next step fused into the epilogue — for Hopper
// (sm_90a).
//
// Replaces the product half of odigos_tpu/models/quantized.py _qdense
// (:72-78): acc = x_q . w_q in s32, y = acc * (a_s * w_s) + b in f32, cast
// to the working type — with what the block does next folded in
// (_block, :174-200):
//   mode 0 "none"      out = round_T(y)                     (q, k, v)
//   mode 1 "residual"  out = round_T(res + round_T(y))      (out-proj, FFN2)
//   mode 2 "gelu_tanh" out = round_T(gelu(round_T(y)))     (FFN1)
// Every f32 step is an IEEE-rounded __fmul_rn / __fadd_rn in the
// reference's order (a_s * w_s first), never contracted into an FMA, so
// the kernel equals its plain version bit for bit: the s32 sum is exact in
// any order, and so is its conversion to f32 (|acc| <= 1024 * 127^2 <
// 2^24). gelu is the tanh form of jax.nn.gelu, x * (0.5 * (1 + tanh(c *
// (x + 0.044715 * x^3)))), with f32 constants and tanhf (torch.tanh's own
// function on the card).
//
// x_q (M, K) int8 row-major, w_q (N, K) int8 (K-major: the Linear layout),
// a_s (M,), w_s (N,), b (N,) f32; out (M, N) in the working type, or split
// into `planes` planes of N / planes columns, (planes, M, N / planes), so
// that the fused QKV product leaves q, k and v each contiguous for K1.
//
// Design: a 128 x 128 output tile per CTA of 8 warps (2 x 4), each warp
// 64 x 32 as 4 x 4 mma.sync.m16n8k32 s8 tiles with s32 accumulators in
// registers; K in steps of 64 through a two-stage shared-memory ring (40
// KB) filled with 16-byte cp.async copies, rows padded to 80 bytes so the
// ldmatrix reads of both operands are free of bank conflicts; ragged M, N
// and K zero-filled by the copies (K % 16 == 0 keeps every 16-byte chunk
// wholly in or out). Consecutive CTAs walk N first and share their A tile
// through L2. The epilogue stores each thread's pairs straight from
// registers. Two variants measured no faster on the H100 (PERF.md): a
// four-stage ring (all of a K = 256 product's loads in flight at once) and
// an epilogue staged through shared memory for 16-byte stores (half the
// warps idle in each pass: slower). mma.sync rather than wgmma: a simple
// kernel that is right first; at these widths the product is bound by
// bytes.
//
// Bound on the card: bytes. At M = 131072 tokens: QKV (K 256, N 768) reads
// 33.6 MB of x_q and writes 201 MB of bf16 (0.070 ms at 3.35 TB/s);
// out-proj + residual (N 256) 33.6 + 67 + 67 MB (0.050 ms); FFN1 + GELU
// (N 1024) 33.6 + 268 MB (0.090 ms); FFN2 + residual (K 1024) 134 + 67 +
// 67 MB (0.080 ms). The int8 tensor-core peak (1,979 TOP/s dense) would
// need 0.013-0.054 ms for the same products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int kThreads = 256;
constexpr int LDS = BK + 16;  // bytes per shared row: 80, ldmatrix-safe
constexpr int kTileBytes = BM * LDS;
constexpr float kGeluC = 0x1.988454p-1f;   // f32(sqrt(2 / pi))
constexpr float kGeluK = 0x1.6e4e26p-5f;   // f32(0.044715)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
  for (int i = 0; i < (BM * BK / 16) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
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

__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(kGeluC, __fadd_rn(x, __fmul_rn(kGeluK, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

// round_T(y), or round_T(gelu(round_T(y))); mode 1 adds its residual to
// the rounded y at the store
template <typename T, int MODE>
__device__ __forceinline__ float epilogue(int acc, float as, float ws,
                                          float b) {
  const float y = Out<T>::round(
      __fadd_rn(__fmul_rn((float)acc, __fmul_rn(as, ws)), b));
  if constexpr (MODE == 2) return Out<T>::round(gelu_tanh(y));
  return y;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) qgemm_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
    const float* __restrict__ as, const float* __restrict__ ws,
    const float* __restrict__ bias, const T* __restrict__ res,
    T* __restrict__ out, long long M, int N, int K, int plane_cols) {
  __shared__ __align__(128) uint8_t smem[2][2][kTileBytes];  // [stage][A|B]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;  // 0..1: 64-row half
  const int wn = warp & 3;   // 0..3: 32-column quarter
  const long long m0 = (long long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (K + BK - 1) / BK;
  load_tile(smem[0][0], xq, m0, M, K, 0);
  load_tile(smem[0][1], wq, n0, N, K, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) {
      const int s = (kt + 1) & 1;
      load_tile(smem[s][0], xq, m0, M, K, (kt + 1) * BK);
      load_tile(smem[s][1], wq, n0, N, K, (kt + 1) * BK);
    }
    cp_async_commit();  // possibly empty: keeps wait_group 1 uniform
    cp_async_wait1();
    __syncthreads();
    const uint8_t* sa = smem[kt & 1][0];
    const uint8_t* sb = smem[kt & 1][1];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
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
        float y0 = epilogue<T, MODE>(acc[mi][ni][2 * h], a_s, ws0, b0);
        float y1 = epilogue<T, MODE>(acc[mi][ni][2 * h + 1], a_s, ws1, b1);
        if constexpr (MODE == 1) {
          y0 = Out<T>::round(__fadd_rn(Out<T>::load(res + m * N + n), y0));
          y1 = Out<T>::round(
              __fadd_rn(Out<T>::load(res + m * N + n + 1), y1));
        }
        Out<T>::store2(outp + m * plane_cols, y0, y1);
      }
    }
  }
}

template <typename T>
cudaError_t launch_t(int mode, const void* xq, const void* wq,
                     const void* as, const void* ws, const void* b,
                     const void* res, void* out, long long M, int N, int K,
                     int planes, cudaStream_t st) {
  const dim3 grid((unsigned)((N + BN - 1) / BN),
                  (unsigned)((M + BM - 1) / BM));
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* a = static_cast<const float*>(as);
  const float* s = static_cast<const float*>(ws);
  const float* bb = static_cast<const float*>(b);
  const T* r = static_cast<const T*>(res);
  T* o = static_cast<T*>(out);
  const int pc = N / planes;
  if (mode == 0)
    qgemm_kernel<T, 0><<<grid, kThreads, 0, st>>>(x, w, a, s, bb, r, o, M,
                                                  N, K, pc);
  else if (mode == 1)
    qgemm_kernel<T, 1><<<grid, kThreads, 0, st>>>(x, w, a, s, bb, r, o, M,
                                                  N, K, pc);
  else
    qgemm_kernel<T, 2><<<grid, kThreads, 0, st>>>(x, w, a, s, bb, r, o, M,
                                                  N, K, pc);
  return cudaGetLastError();
}

}  // namespace

// K10. xq: (M, K) int8, wq: (N, K) int8, both 16-byte aligned with
// K % 16 == 0; as: (M,), ws, b: (N,) f32; res: (M, N) in the output type
// for mode 1, else null; out: (planes, M, N / planes) bf16 (dtype 1) or
// f32 (dtype 0), N % 8 == 0 and (N / planes) % 8 == 0, planes == 1 for
// mode 1.
extern "C" int qgemm_launch(const void* xq, const void* wq, const void* as,
                            const void* ws, const void* b, const void* res,
                            void* out, int dtype, int mode, long long M,
                            int N, int K, int planes, void* stream) {
  if (M < 0 || N < 8 || N % 8 != 0 || K < 16 || K % 16 != 0 || planes < 1 ||
      N % planes != 0 || (N / planes) % 8 != 0 || mode < 0 || mode > 2 ||
      (mode == 1) != (res != nullptr) || (mode == 1 && planes != 1) ||
      (dtype != 0 && dtype != 1) || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_t<__nv_bfloat16>(mode, xq, wq, as, ws, b, res, out, M,
                                        N, K, planes, st);
  return (int)launch_t<float>(mode, xq, wq, as, ws, b, res, out, M, N, K,
                              planes, st);
}
