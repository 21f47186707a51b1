// K19: the backward pass of FFN1's tanh GELU, with FFN1's bias gradient —
// for Hopper (sm_90a), f32 (the trainer's working type).
//
// Replaces: the gradient XLA derives for nn.gelu (jax.nn.gelu's default
// tanh form) after FFN1's Dense at odigos_tpu/models/layers.py :79-80,
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
// ops), and db1 = the column sums of dPre (f64, rounded once), fused into
// the same pass.
//
// Two launches, no atomics (a step is reproducible):
// * gelu_bwd_kernel: a CTA a block of 16 rows and 1024 columns, a thread 4
//   neighbouring columns (16-byte loads of dY and pre, a 16-byte store of
//   dPre) down the block's rows, keeping their f64 column sums, written as
//   the block's partial (a (row blocks, N) f64 scratch);
// * gelu_bwd_cols_kernel: a thread a column adds the partials in a fixed
//   order in f64 and rounds once.
// Why CUDA C++ and not Triton: one elementwise pass and a column sum serve
// either, and this keeps the port on its one nvcc build path
// (kernels/build.py).
//
// Bound on the card: bytes. At the trainer's FFN1 (M 2048, N 1024) the pass
// reads dY and pre (16.8 MB) and writes dPre (8.4 MB): 7.5 us at 3.35
// TB/s, against ~25 flops and a tanh a value. The measured times are in
// PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;                // rows a CTA
constexpr int kCols = 4 * kThreads;      // columns a CTA
constexpr float kGeluC = 0x1.988454p-1f;   // f32(sqrt(2 / pi)), K15's
constexpr float kGeluK = 0x1.6e4e26p-5f;   // f32(0.044715), K15's
constexpr float kGeluK3 = 0x1.12ba9cp-3f;  // f32(3 * kGeluK)

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

__global__ void __launch_bounds__(kThreads)
gelu_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ pre,
                long long M, int N, float* __restrict__ dpre,
                double* __restrict__ part) {
  const int n0 = blockIdx.y * kCols + threadIdx.x * 4;
  if (n0 >= N) return;
  const long long m0 = (long long)blockIdx.x * kRows;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int t = 0; t < kRows; ++t) {
    const long long m = m0 + t;
    if (m >= M) break;
    const long long o = m * N + n0;
    const float4 g = *reinterpret_cast<const float4*>(dy + o);
    const float4 x = *reinterpret_cast<const float4*>(pre + o);
    float4 r;
    r.x = __fmul_rn(g.x, gelu_tanh_grad(x.x));
    r.y = __fmul_rn(g.y, gelu_tanh_grad(x.y));
    r.z = __fmul_rn(g.z, gelu_tanh_grad(x.z));
    r.w = __fmul_rn(g.w, gelu_tanh_grad(x.w));
    *reinterpret_cast<float4*>(dpre + o) = r;
    acc[0] += (double)r.x;
    acc[1] += (double)r.y;
    acc[2] += (double)r.z;
    acc[3] += (double)r.w;
  }
  double* p = part + (long long)blockIdx.x * N + n0;
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = acc[i];
}

__global__ void __launch_bounds__(kThreads)
gelu_bwd_cols_kernel(const double* __restrict__ part, long long P, int N,
                     float* __restrict__ db) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  double s = 0.0;
  for (long long p = 0; p < P; ++p) s += part[p * N + n];
  db[n] = (float)s;
}

}  // namespace

// The f64 partials gelu_tanh_bwd_launch needs: gelu_bwd_partials(M) * N.
extern "C" long long gelu_bwd_partials(long long M) {
  return (M + kRows - 1) / kRows;
}

// dy, pre, dpre: (M, N) f32, 16-byte aligned, N % 4 == 0; db: (N,) f32;
// part: gelu_bwd_partials(M) * N f64.
extern "C" int gelu_tanh_bwd_launch(const void* dy, const void* pre,
                                    long long M, int N, void* dpre, void* db,
                                    void* part, void* stream) {
  if (M <= 0 || N <= 0 || N % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long rb = (M + kRows - 1) / kRows;
  if (rb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)rb, (unsigned)((N + kCols - 1) / kCols));
  auto* pp = static_cast<double*>(part);
  gelu_bwd_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(dy), static_cast<const float*>(pre), M, N,
      static_cast<float*>(dpre), pp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gelu_bwd_cols_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      pp, rb, N, static_cast<float*>(db));
  return (int)cudaGetLastError();
}
