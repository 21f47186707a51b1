// K8: the transformer's final LayerNorm, span head and sigmoid at each real
// span, written straight to the span's original index — for Hopper
// (sm_90a).
//
// Replaces odigos_tpu/models/transformer.py _TraceTransformerModule's
// span_head (:83-88; the encoder's final LayerNorm before it,
// odigos_tpu/models/layers.py Encoder) together with the inverse scatter
// of odigos_tpu/serving/fused.py _build_forward_packed._forward
// (:577-597): mat[row, col] gathered per sorted span, then
// zeros(N).at[perm].set(val).
//
// Per sorted index j < n whose row is < R, one warp: the hidden state
// h[row, col, :] (d values, bf16 or f32), LayerNorm with f32 statistics
// (two passes: mean, then the mean square of the deviations), eps 1e-6,
// gamma and beta; the result rounded to the working type (bf16), as Flax's
// LayerNorm(dtype=bf16) does, BEFORE the f32 head dot; the d -> 1 dot plus
// bias in f32; the sigmoid; written to out[perm[j]]. Sorted indices j >= n
// are padding (perm[j] = j) and get 0, and so does a span whose row is R
// (dropped), so the host fetches the (N,) scores in span order with no
// scatter. Padding rows cost nothing: only real spans are evaluated.
//
// Bound on the card: bytes — n * d * 2 B of h (33.5 MB at 65536 spans, d =
// 256, bf16: 10 us at 3.35 TB/s) plus 16 B of indices and 4 B of score per
// span; the arithmetic is ~8 d flops per span. Each warp reads its span's
// d values as consecutive lanes on consecutive addresses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) span_head_kernel(
    const T* __restrict__ h, int d, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ w,
    const float* __restrict__ bias, float eps,
    const int32_t* __restrict__ perm, const int32_t* __restrict__ row_eff,
    const int32_t* __restrict__ span_col, long long n, long long N, int R,
    int L, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long j = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       j < N; j += warps) {
    const int r = j < n ? row_eff[j] : R;
    if (r >= R) {  // padding (perm[j] = j) or a dropped span: score 0
      if (lane == 0) out[j < n ? perm[j] : j] = 0.f;
      continue;
    }
    const T* x = h + ((long long)r * L + span_col[j]) * d;
    float s = 0.f;
    for (int k = lane; k < d; k += 32) s += load_f(x + k);
    const float mean = __fdiv_rn(warp_sum(s), (float)d);
    float q = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float t = load_f(x + k) - mean;
      q = fmaf(t, t, q);
    }
    const float rstd = rsqrtf(__fdiv_rn(warp_sum(q), (float)d) + eps);
    float z = 0.f;
    for (int k = lane; k < d; k += 32) {
      float y = (load_f(x + k) - mean) * rstd * gamma[k] + beta[k];
      if (sizeof(T) == 2) y = __bfloat162float(__float2bfloat16_rn(y));
      z = fmaf(y, w[k], z);
    }
    z = warp_sum(z) + *bias;
    if (lane == 0) out[perm[j]] = 1.f / (1.f + expf(-z));
  }
}

}  // namespace

// K8. h: (R, L, d) bf16 (dtype 1) or f32 (dtype 0), the encoder's output
// before its final LayerNorm; gamma, beta, w: (d,) f32; bias: one f32;
// perm, row_eff, span_col: (N,) int32 by sorted index (perm[j] = j for
// j >= n); out: (N,) f32 by original span index.
extern "C" int span_head_launch(const void* h, int dtype, int R, int L,
                                int d, const void* gamma, const void* beta,
                                const void* w, const void* bias, float eps,
                                const void* perm, const void* row_eff,
                                const void* span_col, long long n,
                                long long N, void* out, void* stream) {
  if (n < 0 || N < n || d < 1 || R < 0 || L < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  long long blocks = (N + kWarps - 1) / kWarps;
  if (blocks > 4096) blocks = 4096;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* wf = static_cast<const float*>(w);
  const float* bs = static_cast<const float*>(bias);
  const int32_t* p = static_cast<const int32_t*>(perm);
  const int32_t* re = static_cast<const int32_t*>(row_eff);
  const int32_t* sc = static_cast<const int32_t*>(span_col);
  float* o = static_cast<float*>(out);
  if (dtype == 1)
    span_head_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(h), d, g, b, wf, bs, eps, p, re,
        sc, n, N, R, L, o);
  else
    span_head_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(h), d, g, b, wf, bs, eps, p, re, sc, n, N,
        R, L, o);
  return (int)cudaGetLastError();
}
