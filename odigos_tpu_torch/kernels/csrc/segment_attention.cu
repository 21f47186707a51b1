// Packed segment-masked multi-head attention for Hopper (sm_90a).
//
// Replaces: odigos_tpu/models/layers.py EncoderBlock.__call__ ->
// flax.linen.MultiHeadDotProductAttention under the packed block-diagonal
// mask that Encoder.__call__ builds from `segments` (layers.py:72-75 and
// :116-119). The JAX package left this to XLA; it has no Pallas kernel.
//
// Semantics (Flax's dot_product_attention_weights, flax 0.12.3):
//   q is divided by sqrt(hd) rounded to the working type, in that type;
//   key j is allowed for query i iff seg[i] == seg[j] && seg[i] > 0;
//   a disallowed score takes the FINITE finfo(T).min, never -inf, so a
//   query on a padding slot gets the uniform average of V over the row's
//   L slots (as in Flax) instead of a NaN that would reach real rows
//   through P.V next layer.
// Scores, softmax and P.V run in f32; the output is rounded once.
//
// Bound on the card: bytes. q, k, v and out each hold R*L*H*hd elements
// (33.6 MB each in bf16 at R=2048, L=64, H=4, hd=64) while the work is
// 4*hd flops per allowed (query, key) pair: tens of flops per byte moved,
// far under the ~295 flop/byte where an H100 turns compute-bound in bf16.
//
// Two kernels, both hand-written, chosen by the Python wrapper; a launch
// that fails raises, there is no fallback to the plain version.
//
// * `segment_attention_tc_kernel` (bf16 with hd % 16 == 0, L % 4 == 0 and
//   16-byte aligned tensors: the main path). Persistent: one CTA of 16
//   warps per SM walks the packed rows. In the (R, L, H, hd) layout a
//   row's q, k and v are each one contiguous L*H*hd span, so the CTA takes
//   whole rows, all heads. Shared memory holds a two-stage ring of rows:
//   Q, K and V as the row's slots with 16 bytes of padding after each, so
//   that ldmatrix reads are free of bank conflicts, and the row's segment
//   ids. Every thread copies its share of the next row with 16-byte
//   cp.async while the current row computes (one 1-D bulk copy (TMA) per
//   slot and tensor on an mbarrier, which the padded layout needs, measured
//   slower than these copies). Each warp owns (head, 16 queries) items:
//   S = Q.K^T on tensor cores (mma.sync m16n8k16 bf16 -> f32, operands by
//   ldmatrix), the mask built in registers from the staged segment ids,
//   the softmax in registers in f32, and P.V again on tensor cores. P
//   stays f32 in effect: it is split into bf16 hi + lo parts and both
//   products are accumulated in f32, so no rounding of P enters the
//   output. A 16-key tile none of whose live segments meets the live
//   queries' segment range is skipped (every weight in it is exactly 0)
//   unless a query of the block is padding. The output is rounded once to
//   bf16, staged through the warp's own (already read) Q rows and stored
//   with 16-byte writes. mma.sync rather than wgmma: the work is bound by
//   bytes, each (head, 16-query) product is small, and the register
//   fragments keep the mask, the softmax and the hi/lo split in registers
//   with no swizzled operand layouts for the odd hd the wrapper admits.
//   Slots past L in the 16-key tiles are zero in shared memory and weigh
//   exactly 0.
// * `segment_attention_kernel<T, NB, VEC>` (f32: the trainers' forward,
//   which also writes each query's log-sum-exp, and the f32 model; and the
//   bf16 shapes the tensor-core kernel does not take): one CTA of 256
//   threads per (row, head), the tiles staged as f32 with 16-byte loads,
//   scores and P.V on CUDA cores in NB x NB and NB x 4 register blocks fed
//   by 16-byte shared-memory reads, the softmax one warp per row; each
//   score, weight and output one sum in a fixed order (a score over d, an
//   output over every key, ascending; the softmax's shuffle trees), so the
//   output and the log-sum-exp do not depend on the blocking. f32 stays on
//   CUDA cores because no tensor-core route is exact in f32.
//
// Two tiled kernels take what the one-tile kernels above cannot: L up to
// 1024 (K7's walk), hd up to 256, or a row whose stage does not fit shared
// memory. Both give each CTA 64 queries of one (row, head) and stream the
// keys in 64-key tiles with an online softmax: a running max and sum in
// f32 per query, the output rescaled by exp(m_old - m_new) when the max
// rises and divided by the sum once at the end. This is also the form
// ring attention needs (the log-sum-exp of a K/V block). The finite fill
// survives the tiling: a padding query's scores are all finfo.min, so its
// running max is that value and every slot below L weighs exp(0) = 1 (the
// uniform average); a live query that meets only masked keys first counts
// them, and its first allowed key rescales them by exp(finfo.min - s) = 0
// exactly. Skipping a key tile whose live segments all miss the CTA's live
// queries is exact only for live queries, so a CTA holding a padding
// query takes every tile. Keys past L weigh exactly 0 (-inf; their V rows
// are zero-filled).
// * `flash::segment_attention_flash_kernel<ND>` (bf16, hd % 16 == 0): 4
//   warps of 16 queries; K and V tiles in a two-stage cp.async ring; S and
//   P.V on mma.sync as above (P split into bf16 hi + lo); ND 16-column
//   blocks of the output in registers (hd <= 64, 128, 256).
// * `tiled::segment_attention_tiled_kernel<T, DB>` (f32, and bf16 with hd
//   % 16 != 0): 256 threads, the tiles staged as f32 in shared memory,
//   scores and P.V on CUDA cores, a warp a query row for the softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"  // DeviceOnce, max_smem_once, the f32 tiles

namespace {

constexpr int kMaxL = 64;
constexpr int kMaxHd = 64;

// ---- the SM count, once per device

DeviceOnce g_sm_count;

cudaError_t sm_count(int* n) {
  return once_per_device(g_sm_count, n, [](int dev, int* v) {
    return cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount, dev);
  });
}

// =====================================================================
// The tensor-core kernel (bf16)
// =====================================================================

namespace tc {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemLimit = 232448;  // 227 KB, the most a block may use

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Shared-memory geometry of one stage for (L, H, hd): Q, K and V each as
// the row's [Lk][H*hd] slots (Lk = L rounded to 16 keys) with 8 elements
// of padding after every slot, then the row's Lk segment ids.
struct Geom {
  int Lk, ld, tensor_bytes, stage_bytes;
  __host__ __device__ Geom(int L, int H, int hd)
      : Lk(round16(L)), ld(H * hd + 8),
        tensor_bytes(round16(L) * (H * hd + 8) * 2),
        stage_bytes(3 * round16(L) * (H * hd + 8) * 2 + round16(L) * 4) {}
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously (completes at wait_group)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a . b on tensor cores: a 16x16 (row), b 16x8 (col), bf16 -> f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// q * (1 / scale_div) rounded to bf16, on a packed pair: Flax divides q
// in bf16; PyTorch's plain version on the card multiplies by the f32
// reciprocal of the scalar, which this matches bit for bit
__device__ __forceinline__ uint32_t scale_q(uint32_t x, float inv_scale) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16(f.x * inv_scale, f.y * inv_scale);
}

// p = hi + lo, both bf16: hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// Every thread starts its share of row r's copies into one stage, 16
// bytes each, into the padded slot rows, then commits them as one group.
__device__ __forceinline__ void copy_row(
    char* stage, const Geom& g, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const int32_t* __restrict__ seg, int r, int L, int H, int hd) {
  const int cps = H * hd / 8;  // 16-byte chunks per slot of one tensor
  const uint32_t s0 = smem_u32(stage);
  const size_t base = (size_t)r * L * H * hd;
  // chunk e = (slot l, chunk w); stepped without dividing in the loop
  int e = threadIdx.x;
  int l = e / cps;
  int w = e - l * cps;
  const int dl = kThreads / cps;
  const int dw = kThreads - dl * cps;
  for (; e < L * cps; e += kThreads) {
    const uint32_t dst = s0 + (l * g.ld + w * 8) * 2;
    const size_t src = base + (size_t)e * 8;
    cp_async16(dst, q + src);
    cp_async16(dst + g.tensor_bytes, k + src);
    cp_async16(dst + 2 * g.tensor_bytes, v + src);
    l += dl;
    w += dw;
    if (w >= cps) {
      w -= cps;
      ++l;
    }
  }
  if ((int)threadIdx.x < L / 4)  // L % 4 == 0: the ids in 16-byte chunks
    cp_async16(s0 + 3 * g.tensor_bytes + threadIdx.x * 16,
               seg + (size_t)r * L + threadIdx.x * 4);
  cp_async_commit();
}

// One warp's item: head h, queries l0..l0+15 of the row in `stage`.
__device__ __forceinline__ void attend_item(char* stage, const Geom& g,
                                            __nv_bfloat16* __restrict__ out,
                                            int r, int h, int l0, int L,
                                            int H, int hd, float inv_scale,
                                            float big_neg) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // fragment row (and +8)
  const int tig = lane & 3;   // fragment column pair
  const int nk16 = g.Lk >> 4;
  const int nd16 = hd >> 4;
  const int ld2 = g.ld * 2;   // bytes from one slot to the next
  const uint32_t qs = smem_u32(stage) + h * hd * 2;
  const uint32_t ks = qs + g.tensor_bytes;
  const uint32_t vs = qs + 2 * g.tensor_bytes;
  const int32_t* segs =
      reinterpret_cast<const int32_t*>(stage + 3 * g.tensor_bytes);

  // ---- Q fragments (16 queries x hd), scaled and rounded to bf16
  uint32_t qf[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t < nd16) {
      const int row = l0 + (lane & 15);
      const int col = t * 16 + (lane >> 4) * 8;
      ldsm_x4(qs + row * ld2 + col * 2, qf[t]);
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[t][i] = scale_q(qf[t][i], inv_scale);
    }
  }

  // ---- the 16-key tiles these queries need. A live query's weight on a
  // key of another segment is exp(finfo.min - max) = 0 exactly, so a tile
  // whose live keys' segments all lie outside the live queries' range
  // adds nothing and is skipped; a padding query (it averages every slot
  // of the row) keeps every tile.
  const unsigned all = 0xffffffffu;
  const int qrow = l0 + (lane & 15);
  const int qseg = qrow < L ? segs[qrow] : 0;
  const bool pad_q = __any_sync(all, qrow < L && qseg <= 0);
  const int qmin = __reduce_min_sync(all, qseg > 0 ? qseg : INT_MAX);
  const int qmax = __reduce_max_sync(all, qseg > 0 ? qseg : 0);
  uint32_t need = 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // tiles 2*half and 2*half + 1
    const int key = lane + 32 * half;
    const int ks_ = key < L ? segs[key] : 0;
    int tmin = ks_ > 0 ? ks_ : INT_MAX;
    int tmax = ks_ > 0 ? ks_ : 0;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {  // within each 16-lane half
      tmin = min(tmin, __shfl_xor_sync(all, tmin, o));
      tmax = max(tmax, __shfl_xor_sync(all, tmax, o));
    }
    const bool hit = pad_q || (tmin <= qmax && tmax >= qmin);
    const uint32_t bits = __ballot_sync(all, hit);
    need |= ((bits & 1u) | ((bits >> 16 & 1u) << 1)) << (2 * half);
  }

  // ---- S = Q.K^T, 16 queries x Lk keys, f32 accumulators
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    if (np < nk16 && (need >> np & 1u)) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < nd16) {
          uint32_t b[4];
          const int key = np * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
          const int col = t * 16 + ((lane >> 3) & 1) * 8;
          ldsm_x4(ks + key * ld2 + col * 2, b);
          mma_bf16(s[2 * np], qf[t], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf[t], b[2], b[3]);
        }
      }
    }
  }

  // ---- mask (finite fill inside L, exactly 0 weight past L) + softmax
  const int sq0 = segs[l0 + gid];      // rows past L read the zero fill
  const int sq1 = segs[l0 + gid + 8];
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < 2 * nk16) {
      const int key = j * 8 + tig * 2;
      const int2 sk = *reinterpret_cast<const int2*>(segs + key);
      const bool skip = !(need >> (j >> 1) & 1u);  // weighs 0 (see above)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int sq = (i >> 1) ? sq1 : sq0;
        const int kseg = (i & 1) ? sk.y : sk.x;
        const float x = (skip || key + (i & 1) >= L)
                            ? -INFINITY
                            : ((sq == kseg && sq > 0) ? s[j][i] : big_neg);
        s[j][i] = x;
        if (i >> 1) m1 = fmaxf(m1, x);
        else m0 = fmaxf(m0, x);
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l_0 = 0.f, l_1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < 2 * nk16 && (need >> (j >> 1) & 1u)) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(s[j][i] - ((i >> 1) ? m1 : m0));  // 0 past L
        s[j][i] = e;
        if (i >> 1) l_1 += e;
        else l_0 += e;
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_0 += __shfl_xor_sync(0xffffffffu, l_0, o);
    l_1 += __shfl_xor_sync(0xffffffffu, l_1, o);
  }
  const float inv0 = 1.f / l_0;
  const float inv1 = 1.f / l_1;

  // ---- O = P.V with P = P_hi + P_lo (both bf16), f32 accumulators
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
#pragma unroll
  for (int kp = 0; kp < 4; ++kp) {
    if (kp < nk16 && (need >> kp & 1u)) {
      // the S accumulators of key tiles 2kp, 2kp+1 are P's A fragment
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kp][0] * inv0, s[2 * kp][1] * inv0, ph[0], pl[0]);
      split_pair(s[2 * kp][2] * inv1, s[2 * kp][3] * inv1, ph[1], pl[1]);
      split_pair(s[2 * kp + 1][0] * inv0, s[2 * kp + 1][1] * inv0, ph[2],
                 pl[2]);
      split_pair(s[2 * kp + 1][2] * inv1, s[2 * kp + 1][3] * inv1, ph[3],
                 pl[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np < nd16) {
          uint32_t b[4];
          const int key = kp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = np * 16 + ((lane >> 4) & 1) * 8;
          ldsm_x4_trans(vs + key * ld2 + col * 2, b);
          mma_bf16(o[2 * np], ph, b[0], b[1]);
          mma_bf16(o[2 * np], pl, b[0], b[1]);
          mma_bf16(o[2 * np + 1], ph, b[2], b[3]);
          mma_bf16(o[2 * np + 1], pl, b[2], b[3]);
        }
      }
    }
  }

  // ---- round once, stage in this warp's own Q rows (read above, by this
  // warp only), then 16-byte stores of whole (slot, head) spans
  __nv_bfloat16* qrows =
      reinterpret_cast<__nv_bfloat16*>(stage) + h * hd;
  const int r0 = l0 + gid;
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < 2 * nd16) {
      const int col = j * 8 + tig * 2;
      if (r0 < L)
        *reinterpret_cast<uint32_t*>(qrows + r0 * g.ld + col) =
            pack_bf16(o[j][0], o[j][1]);
      if (r1 < L)
        *reinterpret_cast<uint32_t*>(qrows + r1 * g.ld + col) =
            pack_bf16(o[j][2], o[j][3]);
    }
  }
  __syncwarp();
  const int c8 = hd >> 3;
  const int rows = min(16, L - l0);
  for (int e = lane; e < rows * c8; e += 32) {
    const int l = l0 + e / c8;
    const int c = e % c8;
    const uint4 val =
        *reinterpret_cast<const uint4*>(qrows + l * g.ld + c * 8);
    *reinterpret_cast<uint4*>(out + ((size_t)(r * L + l) * H + h) * hd +
                              c * 8) = val;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
segment_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const int32_t* __restrict__ seg,
                            __nv_bfloat16* __restrict__ out, int R, int L,
                            int H, int hd, int stages, float inv_scale,
                            float big_neg) {
  extern __shared__ __align__(128) char tc_smem[];
  const Geom g(L, H, hd);
  char* data = tc_smem;

  // zero every stage once: the copies fill only slots < L, so the keys
  // and queries past L in the 16-key tiles stay zero
  {
    uint4* z = reinterpret_cast<uint4*>(data);
    const int n = stages * g.stage_bytes / 16;
    for (int i = threadIdx.x; i < n; i += kThreads)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int nqb = g.Lk >> 4;  // 16-query blocks per head
  const int items = H * nqb;

  int r = blockIdx.x;
  if (r >= R) return;
  copy_row(data, g, q, k, v, seg, r, L, H, hd);
  for (int it = 0; r < R; r += gridDim.x, ++it) {
    const int s = stages == 2 ? (it & 1) : 0;
    char* stage = data + s * g.stage_bytes;
    const int rn = r + gridDim.x;
    if (stages == 2) {
      // the other stage was released by the barrier that ended the
      // previous row: the next row's copies fly while this row computes
      if (rn < R)
        copy_row(data + (s ^ 1) * g.stage_bytes, g, q, k, v, seg, rn, L, H,
                  hd);
      else
        cp_async_commit();  // an empty group keeps the count of groups
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int item = warp; item < items; item += kWarps)
      attend_item(stage, g, out, r, item / nqb, (item % nqb) * 16, L, H, hd,
                  inv_scale, big_neg);
    __syncthreads();
    if (stages == 1 && rn < R) copy_row(stage, g, q, k, v, seg, rn, L, H, hd);
  }
}

DeviceOnce g_tc_attr;

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seg, void* out, int R, int L, int H, int hd,
                   float inv_scale, float big_neg, cudaStream_t stream) {
  const Geom g(L, H, hd);
  if (g.stage_bytes > kSmemLimit || hd % 16 != 0 || L % 4 != 0)
    return cudaErrorInvalidValue;
  const int stages = 2 * g.stage_bytes <= kSmemLimit ? 2 : 1;
  cudaError_t err =
      max_smem_once(g_tc_attr, segment_attention_tc_kernel, kSmemLimit);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int grid = R < sms ? R : sms;
  segment_attention_tc_kernel<<<grid, kThreads, stages * g.stage_bytes,
                                stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(seg),
      static_cast<__nv_bfloat16*>(out), R, L, H, hd, stages, inv_scale,
      big_neg);
  return cudaGetLastError();
}

}  // namespace tc

// =====================================================================
// The tiled tensor-core kernel (bf16, L up to 1024, hd up to 256)
// =====================================================================

namespace flash {

using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldsm_x4;
using tc::ldsm_x4_trans;
using tc::mma_bf16;
using tc::pack_bf16;
using tc::scale_q;
using tc::smem_u32;
using tc::split_pair;

constexpr int kWarps = 4;  // 16 queries a warp, 64 a CTA
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 64;    // queries a CTA
constexpr int kBK = 64;    // keys a tile
constexpr int kMaxL = 1024;
constexpr int kMaxTiles = kMaxL / kBK;
constexpr int kDynLimit = tc::kSmemLimit - 1024;  // dynamic shared memory

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst,
                                                 const void* src,
                                                 bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// shared memory: Q (kBQ slots), then two stages of K and V (kBK slots
// each), every slot hd bf16 + 8 of padding (ldmatrix without bank
// conflicts), then the row's segment ids
__host__ __device__ constexpr int slot_ld(int hd) { return hd + 8; }
__host__ __device__ constexpr int smem_bytes(int hd, int L) {
  return 5 * kBQ * slot_ld(hd) * 2 + ((L + 3) & ~3) * 4;
}

// a 64-slot block of one head's q, k or v into shared memory (zeros past L)
__device__ __forceinline__ void copy_block(uint32_t dst,
                                           const __nv_bfloat16* src, int r,
                                           int l0, int L, int H, int h,
                                           int hd) {
  const int cps = hd / 8;  // 16-byte chunks a slot
  for (int e = threadIdx.x; e < kBQ * cps; e += kThreads) {
    const int l = e / cps, c = e - l * cps;
    const bool in = l0 + l < L;
    const size_t g = ((size_t)(r * L + (in ? l0 + l : 0)) * H + h) * hd + c * 8;
    cp_async16_zfill(dst + (l * slot_ld(hd) + c * 8) * 2, src + g, in);
  }
}

// One CTA: 64 queries of (row r, head h), 4 warps of 16. The key tiles
// the CTA needs stream through a two-stage cp.async ring; each warp keeps
// an online softmax (running max and sum in f32, the output rescaled when
// the max rises) and P.V on tensor cores with P split into bf16 hi + lo.
// A key tile whose live segments all miss the live queries' range weighs
// exactly 0 for a live query and is skipped, unless a query of the CTA is
// padding: Flax gives a padding query the uniform average of V over the
// row's L slots (every score the finite finfo.min), which needs every tile.
// ND: 16-column blocks of hd the registers hold (hd <= 16 * ND).
template <int ND>
__global__ void __launch_bounds__(kThreads, 1)
segment_attention_flash_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const int32_t* __restrict__ seg,
                               __nv_bfloat16* __restrict__ out, int L, int H,
                               int hd, float inv_scale, float big_neg) {
  extern __shared__ __align__(128) char fl_smem[];
  const int ld = slot_ld(hd);
  const int blk_bytes = kBQ * ld * 2;
  const uint32_t qs = smem_u32(fl_smem);
  const uint32_t kvs = qs + blk_bytes;  // stage s: K at + 2 s, V at + 2 s + 1
  int32_t* segs = reinterpret_cast<int32_t*>(fl_smem + 5 * blk_bytes);
  __shared__ int s_tiles[kMaxTiles];
  __shared__ int s_ntiles;

  const int nqb = (L + kBQ - 1) / kBQ;
  const int r = blockIdx.x / (H * nqb);
  const int rem = blockIdx.x - r * H * nqb;
  const int h = rem / nqb;
  const int q0 = (rem - h * nqb) * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  copy_block(qs, q, r, q0, L, H, h, hd);
  cp_async_commit();
  for (int l = tid; l < L; l += kThreads) segs[l] = seg[(size_t)r * L + l];
  __syncthreads();

  // the tiles this CTA needs (every thread computes the same list)
  if (warp == 0) {
    const unsigned all = 0xffffffffu;
    int qmin = INT_MAX, qmax = 0;
    bool pad = false;
    for (int l = q0 + lane; l < min(q0 + kBQ, L); l += 32) {
      const int s = segs[l];
      if (s > 0) {
        qmin = min(qmin, s);
        qmax = max(qmax, s);
      } else {
        pad = true;
      }
    }
    qmin = __reduce_min_sync(all, qmin);
    qmax = __reduce_max_sync(all, qmax);
    pad = __any_sync(all, pad);
    int n = 0;
    const int nt = (L + kBK - 1) / kBK;
    for (int t = 0; t < nt; ++t) {
      int tmin = INT_MAX, tmax = 0;
      for (int l = t * kBK + lane; l < min(t * kBK + kBK, L); l += 32) {
        const int s = segs[l];
        if (s > 0) {
          tmin = min(tmin, s);
          tmax = max(tmax, s);
        }
      }
      tmin = __reduce_min_sync(all, tmin);
      tmax = __reduce_max_sync(all, tmax);
      if (pad || (tmin <= qmax && tmax >= qmin)) {
        if (lane == 0) s_tiles[n] = t;
        ++n;
      }
    }
    if (lane == 0) s_ntiles = n;
  }
  __syncthreads();
  const int ntiles = s_ntiles;
  if (ntiles > 0) {
    copy_block(kvs, k, r, s_tiles[0] * kBK, L, H, h, hd);
    copy_block(kvs + blk_bytes, v, r, s_tiles[0] * kBK, L, H, h, hd);
  }
  cp_async_commit();

  const int gid = lane >> 2, tig = lane & 3;
  const int nd16 = hd >> 4;
  const int ld2 = ld * 2;
  const uint32_t qw = qs + warp * 16 * ld2;  // this warp's 16 queries
  const int sq0 = q0 + warp * 16 + gid < L ? segs[q0 + warp * 16 + gid] : 0;
  const int sq1 =
      q0 + warp * 16 + gid + 8 < L ? segs[q0 + warp * 16 + gid + 8] : 0;

  float o[2 * ND][4];
#pragma unroll
  for (int j = 0; j < 2 * ND; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int st = i & 1;
    if (i + 1 < ntiles) {
      const uint32_t nx = kvs + (st ^ 1) * 2 * blk_bytes;
      copy_block(nx, k, r, s_tiles[i + 1] * kBK, L, H, h, hd);
      copy_block(nx + blk_bytes, v, r, s_tiles[i + 1] * kBK, L, H, h, hd);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kt0 = s_tiles[i] * kBK;
    const uint32_t ks = kvs + st * 2 * blk_bytes;
    const uint32_t vs = ks + blk_bytes;

    // ---- S = Q.K^T: 16 queries x 64 keys, f32
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int t = 0; t < ND; ++t) {
      if (t < nd16) {
        uint32_t a[4];
        ldsm_x4(qw + (lane & 15) * ld2 + (t * 16 + (lane >> 4) * 8) * 2, a);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = scale_q(a[e], inv_scale);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          const int key = np * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
          const int col = t * 16 + ((lane >> 3) & 1) * 8;
          ldsm_x4(ks + key * ld2 + col * 2, b);
          mma_bf16(s[2 * np], a, b[0], b[1]);
          mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
      }
    }

    // ---- mask (finite fill inside L, no weight past L), online softmax
    float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt0 + j * 8 + tig * 2 + (e & 1);
        const int sq = (e >> 1) ? sq1 : sq0;
        float x = -INFINITY;
        if (key < L) x = (sq > 0 && segs[key] == sq) ? s[j][e] : big_neg;
        s[j][e] = x;
        if (e >> 1) tm1 = fmaxf(tm1, x);
        else tm0 = fmaxf(tm0, x);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, off));
      tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, off));
    }
    // a tile holds a key below L, so the new maxima are finite
    const float n0 = fmaxf(m0, tm0), n1 = fmaxf(m1, tm1);
    const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);  // 0 at the start
    m0 = n0;
    m1 = n1;
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - ((e >> 1) ? n1 : n0));  // 0 past L
        s[j][e] = p;
        if (e >> 1) r1 += p;
        else r0 += p;
      }
    }
    l0 = l0 * a0 + r0;
    l1 = l1 * a1 + r1;
#pragma unroll
    for (int j = 0; j < 2 * ND; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }

    // ---- O += P.V, P = P_hi + P_lo (both bf16), f32 accumulators
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kp][0], s[2 * kp][1], ph[0], pl[0]);
      split_pair(s[2 * kp][2], s[2 * kp][3], ph[1], pl[1]);
      split_pair(s[2 * kp + 1][0], s[2 * kp + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kp + 1][2], s[2 * kp + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < ND; ++np) {
        if (np < nd16) {
          uint32_t b[4];
          const int key = kp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = np * 16 + ((lane >> 4) & 1) * 8;
          ldsm_x4_trans(vs + key * ld2 + col * 2, b);
          mma_bf16(o[2 * np], ph, b[0], b[1]);
          mma_bf16(o[2 * np], pl, b[0], b[1]);
          mma_bf16(o[2 * np + 1], ph, b[2], b[3]);
          mma_bf16(o[2 * np + 1], pl, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next tile's copies
  }

  // ---- divide once, round once, stage in this warp's Q rows, 16-byte
  // stores of whole (slot, head) spans
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  __nv_bfloat16* qrows =
      reinterpret_cast<__nv_bfloat16*>(fl_smem) + warp * 16 * ld;
#pragma unroll
  for (int j = 0; j < 2 * ND; ++j) {
    if (j < 2 * nd16) {
      const int col = j * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(qrows + gid * ld + col) =
          pack_bf16(o[j][0] * i0, o[j][1] * i0);
      *reinterpret_cast<uint32_t*>(qrows + (gid + 8) * ld + col) =
          pack_bf16(o[j][2] * i1, o[j][3] * i1);
    }
  }
  __syncwarp();
  const int c8 = hd >> 3;
  const int lq = q0 + warp * 16;
  const int rows = max(0, min(16, L - lq));
  for (int e = lane; e < rows * c8; e += 32) {
    const int l = e / c8, c = e - (e / c8) * c8;
    const uint4 val = *reinterpret_cast<const uint4*>(qrows + l * ld + c * 8);
    *reinterpret_cast<uint4*>(out + ((size_t)(r * L + lq + l) * H + h) * hd +
                              c * 8) = val;
  }
}

DeviceOnce g_attr[3];

template <int ND>
cudaError_t launch_nd(DeviceOnce& once, const void* q, const void* k,
                      const void* v, const void* seg, void* out, int R,
                      int L, int H, int hd, float inv_scale, float big_neg,
                      cudaStream_t stream) {
  const int smem = smem_bytes(hd, L);
  // the most a block may use, less room for the kernel's static arrays
  cudaError_t err = max_smem_once(once, segment_attention_flash_kernel<ND>,
                                  kDynLimit);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)R * H * ((L + kBQ - 1) / kBQ);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  segment_attention_flash_kernel<ND><<<(unsigned)grid, kThreads, smem,
                                       stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(seg),
      static_cast<__nv_bfloat16*>(out), L, H, hd, inv_scale, big_neg);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seg, void* out, int R, int L, int H, int hd,
                   float inv_scale, float big_neg, cudaStream_t stream) {
  if (hd % 16 != 0 || hd > 256 || L > kMaxL || smem_bytes(hd, L) > kDynLimit)
    return cudaErrorInvalidValue;
  if (hd <= 64)
    return launch_nd<4>(g_attr[0], q, k, v, seg, out, R, L, H, hd, inv_scale,
                        big_neg, stream);
  if (hd <= 128)
    return launch_nd<8>(g_attr[1], q, k, v, seg, out, R, L, H, hd, inv_scale,
                        big_neg, stream);
  return launch_nd<16>(g_attr[2], q, k, v, seg, out, R, L, H, hd, inv_scale,
                       big_neg, stream);
}

}  // namespace flash

// =====================================================================
// The CUDA-core kernel (f32, and bf16 shapes the tensor-core one skips)
// =====================================================================

namespace simt {

constexpr int kThreads = 256;
// the most dynamic shared memory an instance takes (L = 64, hd = 64): three
// 64 x 68 tiles and the segments
constexpr int kMaxSmemBytes = 3 * 64 * 68 * 4 + kMaxL * 4;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// The row pitch of a staged tile of n columns: n rounded to whole 16-byte
// vectors, then to an odd count of them, so that the 8 lanes of a quarter
// warp, on 8 consecutive rows, read 8 different bank groups
__host__ __device__ constexpr int tile_pitch(int n) {
  return 4 * (((n + 3) / 4) | 1);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// q scaled and rounded to T, then held as f32: Flax divides in the
// working type
template <typename T>
__device__ __forceinline__ float scaled_q(T x, float scale_div) {
  return to_f32(from_f32<T>(to_f32(x) / scale_div));
}

// 16 bytes of T (4 f32 or 8 bf16 values) into dst as f32, q scaled
__device__ __forceinline__ void put16(float* dst, uint4 raw, float sd,
                                      bool q, float) {
  float4 x = *reinterpret_cast<const float4*>(&raw);
  if (q) x = make_float4(x.x / sd, x.y / sd, x.z / sd, x.w / sd);
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ void put16(float* dst, uint4 raw, float sd,
                                      bool q, __nv_bfloat16) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
  float f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f[i] = q ? scaled_q(h[i], sd) : __bfloat162float(h[i]);
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// One CTA of 256 threads a (row, head), each sum in one fixed order (so the
// output and the log-sum-exp keep their bits whatever the blocking), the
// work shaped for the CUDA cores:
// * the row's q, k, v slots (each head's hd values contiguous) are staged
//   as f32 tiles with 16-byte loads (VEC: hd a whole number of vectors,
//   16-byte aligned tensors; else one value a thread), every load of a
//   thread issued before its stores, no division a value; rows at a pitch
//   of an odd count of 16-byte vectors (tile_pitch);
// * S = Q.K^T: thread (ty, tx) holds NB x NB scores (rows ty + 16 a, keys
//   tx + 16 b; NB = 2 up to L 32, 4 up to 64) and reads q and k as 16-byte
//   vectors, 4 dims of a row each: 2 NB reads for 4 NB^2 FMAs, each score
//   one fmaf chain over d ascending from +0 (pad dims: q +0, k -0, a
//   product of -0 that leaves every sum as it is);
// * the scores, masked with the finite fill, overwrite the Q tile; the
//   softmax takes a warp a query row (two rows of a warp at once);
// * O = P.V: thread (ty, tx) holds NB rows x 4 dims (4 tx .. 4 tx + 3),
//   reads 4 weights of a row and the 4 keys' V vectors as 16-byte vectors,
//   each output one fmaf chain over every key j < L ascending (masked keys'
//   exact zeros included: a NaN or inf in V spreads as through the plain
//   version's product; pad keys: weight +0, V -0), and stores 16-byte
//   vectors (f32 VEC).
template <typename T, int NB, bool VEC>
__global__ void __launch_bounds__(kThreads)
segment_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int32_t* __restrict__ seg,
                         T* __restrict__ out, int L, int H, int hd,
                         float scale_div, float big_neg,
                         float* __restrict__ lse) {
  constexpr int RT = 16 * NB;  // rows a thread grid covers
  extern __shared__ __align__(16) float simt_smem[];
  const int PQ = tile_pitch(hd);
  const int SP = tile_pitch(L);
  const int L4 = round4(L);
  const int D4 = round4(hd);
  float* qs = simt_smem;                    // [RT][PQ], then scores [RT][SP]
  float* ks = qs + RT * max(PQ, SP);        // [RT][PQ]
  float* vs = ks + RT * PQ;                 // [L4][PQ]
  int* segs = reinterpret_cast<int*>(vs + L4 * PQ);
  float* sc = qs;

  const int r = blockIdx.x / H;
  const int h = blockIdx.x - r * H;
  const int tid = threadIdx.x;
  const size_t slot0 = (size_t)r * L * H + h;  // slot l at (slot0 + l H) hd

  // ---- stage the (row, head) tiles as f32
  const int my_seg = tid < L ? __ldg(seg + (size_t)r * L + tid) : 0;
  if (VEC) {
    constexpr int EPV = 16 / sizeof(T);  // values a 16-byte vector
    // a thread's vectors of each tensor, at most (L 64 x hd 64)
    constexpr int kVec = kMaxL * kMaxHd / EPV / kThreads;
    const int hv = hd / EPV;
    uint4 rq[kVec], rk[kVec], rv[kVec];
    int at[kVec];
#pragma unroll
    for (int t = 0; t < kVec; ++t) {  // every load first
      const int e = tid + t * kThreads;
      at[t] = -1;
      if (e < L * hv) {
        const int l = e / hv;
        const int c = (e - l * hv) * EPV;
        const size_t g = (slot0 + (size_t)l * H) * hd + c;
        at[t] = l * PQ + c;
        rq[t] = __ldg(reinterpret_cast<const uint4*>(q + g));
        rk[t] = __ldg(reinterpret_cast<const uint4*>(k + g));
        rv[t] = __ldg(reinterpret_cast<const uint4*>(v + g));
      }
    }
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      if (at[t] < 0) continue;
      put16(qs + at[t], rq[t], scale_div, true, T());
      put16(ks + at[t], rk[t], scale_div, false, T());
      put16(vs + at[t], rv[t], scale_div, false, T());
    }
  } else {
    for (int e = tid; e < L * hd; e += kThreads) {
      const int l = e / hd;
      const int d = e - l * hd;
      const size_t g = (slot0 + (size_t)l * H) * hd + d;
      qs[l * PQ + d] = scaled_q(q[g], scale_div);
      ks[l * PQ + d] = to_f32(k[g]);
      vs[l * PQ + d] = to_f32(v[g]);
    }
  }
  // pads: dims past hd (q +0, k and v -0) and keys past L (v -0)
  for (int e = tid; e < L * (D4 - hd); e += kThreads) {
    const int l = e / (D4 - hd);
    const int d = hd + e - l * (D4 - hd);
    qs[l * PQ + d] = 0.f;
    ks[l * PQ + d] = -0.f;
    vs[l * PQ + d] = -0.f;
  }
  for (int e = tid; e < (L4 - L) * D4; e += kThreads)
    vs[(L + e / D4) * PQ + e % D4] = -0.f;
  if (tid < L) segs[tid] = my_seg;
  __syncthreads();

  // ---- scores: thread (ty, tx) owns rows ty + 16 a and keys tx + 16 b
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[NB][NB];
#pragma unroll
  for (int a = 0; a < NB; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[a][b] = 0.f;
  for (int d = 0; d < D4; d += 4) {
    float4 qa[NB], kb[NB];
#pragma unroll
    for (int a = 0; a < NB; ++a)
      qa[a] = *reinterpret_cast<const float4*>(qs + (ty + 16 * a) * PQ + d);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      kb[b] = *reinterpret_cast<const float4*>(ks + (tx + 16 * b) * PQ + d);
#pragma unroll
    for (int a = 0; a < NB; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        acc[a][b] = fmaf(qa[a].x, kb[b].x, acc[a][b]);
        acc[a][b] = fmaf(qa[a].y, kb[b].y, acc[a][b]);
        acc[a][b] = fmaf(qa[a].z, kb[b].z, acc[a][b]);
        acc[a][b] = fmaf(qa[a].w, kb[b].w, acc[a][b]);
      }
  }
  __syncthreads();  // the Q tile is read: the scores take its place
#pragma unroll
  for (int a = 0; a < NB; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int j = tx + 16 * b;
      if (i < L && j < L4) {
        const bool ok = j < L && segs[i] == segs[j] && segs[i] > 0;
        sc[i * SP + j] = j >= L ? 0.f : ok ? acc[a][b] : big_neg;
      }
    }
  }
  __syncthreads();

  // ---- softmax over keys, one warp per query row (the same shuffle trees),
  // two rows of a warp at once: rows i and i + 8
  const int warp = tid >> 5;
  const int lane = tid & 31;
  constexpr int kWarps = kThreads / 32;
  for (int i0 = warp; i0 < L; i0 += 2 * kWarps) {
    float x0[2], x1[2], m[2], e0[2], e1[2], s[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * kWarps;
      // lanes past L, and a row past L, read as big_neg: never above a
      // real entry's score
      x0[u] = i < L && lane < L ? sc[i * SP + lane] : big_neg;
      x1[u] = i < L && lane + 32 < L ? sc[i * SP + lane + 32] : big_neg;
      m[u] = fmaxf(x0[u], x1[u]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        m[u] = fmaxf(m[u], __shfl_xor_sync(0xffffffffu, m[u], o));
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      e0[u] = lane < L ? expf(x0[u] - m[u]) : 0.f;
      e1[u] = lane + 32 < L ? expf(x1[u] - m[u]) : 0.f;
      s[u] = e0[u] + e1[u];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * kWarps;
      if (i >= L) continue;
      if (lane < L) sc[i * SP + lane] = e0[u] / s[u];
      if (lane + 32 < L) sc[i * SP + lane + 32] = e1[u] / s[u];
      // the row's log-sum-exp for the backward pass (K16), when asked for
      if (lse != nullptr && lane == 0)
        lse[((size_t)r * H + h) * L + i] = m[u] + logf(s[u]);
    }
  }
  __syncthreads();

  // ---- out = P.V: thread (ty, tx) owns rows ty + 16 a, dims 4 tx .. + 3
  if (4 * tx >= D4) return;
  float o[NB][4];
#pragma unroll
  for (int a = 0; a < NB; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[a][c] = 0.f;
  for (int j = 0; j < L4; j += 4) {
    float4 p[NB], vv[4];
#pragma unroll
    for (int a = 0; a < NB; ++a)
      p[a] = *reinterpret_cast<const float4*>(sc + (ty + 16 * a) * SP + j);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      vv[t] = *reinterpret_cast<const float4*>(vs + (j + t) * PQ + 4 * tx);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int a = 0; a < NB; ++a) {
        const float pj = t == 0 ? p[a].x : t == 1 ? p[a].y
                                         : t == 2 ? p[a].z : p[a].w;
        o[a][0] = fmaf(pj, vv[t].x, o[a][0]);
        o[a][1] = fmaf(pj, vv[t].y, o[a][1]);
        o[a][2] = fmaf(pj, vv[t].z, o[a][2]);
        o[a][3] = fmaf(pj, vv[t].w, o[a][3]);
      }
  }
#pragma unroll
  for (int a = 0; a < NB; ++a) {
    const int i = ty + 16 * a;
    if (i >= L) continue;
    T* dst = out + (slot0 + (size_t)i * H) * hd + 4 * tx;
    if (VEC && sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(o[a][0], o[a][1], o[a][2], o[a][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * tx + c < hd) dst[c] = from_f32<T>(o[a][c]);
    }
  }
}

// (T, NB, VEC) -> the instance's once-per-device shared-memory attribute
DeviceOnce g_attr[2][2][2];

template <typename T, int NB, bool VEC>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const void* seg, void* out, int R, int L, int H, int hd,
                     float scale_div, float big_neg, void* lse,
                     cudaStream_t stream) {
  auto kernel = segment_attention_kernel<T, NB, VEC>;
  cudaError_t err = max_smem_once(
      g_attr[sizeof(T) == 2][NB == 4][VEC], kernel, kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  const int RT = 16 * NB;
  const int PQ = tile_pitch(hd);
  const int SP = tile_pitch(L);
  const int bytes =
      (RT * (PQ > SP ? PQ : SP) + RT * PQ + round4(L) * PQ) * 4 + L * 4;
  kernel<<<R * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(seg),
      static_cast<T*>(out), L, H, hd, scale_div, big_neg,
      static_cast<float*>(lse));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seg, void* out, int R, int L, int H, int hd,
                   float scale_div, float big_neg, void* lse,
                   cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const bool vec = aligned && (hd * (int)sizeof(T)) % 16 == 0;
  if (L <= 32)
    return vec ? launch_t<T, 2, true>(q, k, v, seg, out, R, L, H, hd,
                                      scale_div, big_neg, lse, stream)
               : launch_t<T, 2, false>(q, k, v, seg, out, R, L, H, hd,
                                       scale_div, big_neg, lse, stream);
  return vec ? launch_t<T, 4, true>(q, k, v, seg, out, R, L, H, hd,
                                    scale_div, big_neg, lse, stream)
             : launch_t<T, 4, false>(q, k, v, seg, out, R, L, H, hd,
                                     scale_div, big_neg, lse, stream);
}

}  // namespace simt

// =====================================================================
// The tiled CUDA-core kernel (f32, and bf16 with hd % 16 != 0, at L or
// hd past the one-tile kernel's 64)
// =====================================================================

namespace tiled {

using tiles::kB;  // queries a CTA, keys a tile
using tiles::kSld;
using tiles::kThreads;
constexpr int kMaxL = 1024;
constexpr int kMaxTiles = kMaxL / kB;

using simt::from_f32;
using simt::to_f32;

// the shared tiles (attention_tiles.cuh), then the row's segment ids
__host__ __device__ constexpr size_t smem_bytes(int hd, int L) {
  return tiles::smem_floats(hd) * 4 + (size_t)L * 4;
}

// One CTA: 64 queries of (row r, head h). Key tiles of 64 stream through
// shared memory; each query keeps a running max and sum (the online
// softmax), and thread (ty, tx) keeps the output of queries ty + 16 a at
// dims tx + 16 c in registers, rescaled when a query's max rises. Tiles
// are skipped as in the tensor-core kernels (exact for live queries; none
// when a query of the CTA is padding). DB: 16-dim blocks a thread holds.
// The tile loops are attention_tiles.cuh's, shared with K22.
template <typename T, int DB>
__global__ void __launch_bounds__(kThreads)
segment_attention_tiled_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const int32_t* __restrict__ seg,
                               T* __restrict__ out, int L, int H, int hd,
                               float scale_div, float big_neg,
                               float* __restrict__ lse) {
  extern __shared__ float tl_smem[];
  const int ld = hd + 1;
  const tiles::Smem t = tiles::carve(tl_smem, ld);
  int* segs = t.tail;
  __shared__ int s_tiles[kMaxTiles];
  __shared__ int s_ntiles;

  const int nqb = (L + kB - 1) / kB;
  const int r = blockIdx.x / (H * nqb);
  const int rem = blockIdx.x - r * H * nqb;
  const int h = rem / nqb;
  const int q0 = (rem - h * nqb) * kB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int l = tid; l < L; l += kThreads) segs[l] = seg[(size_t)r * L + l];
  // q scaled and rounded to T, as Flax divides in the working type; rows
  // past L are zero
  for (int e = tid; e < kB * hd; e += kThreads) {
    const int l = e / hd, dd = e - l * hd;
    float x = 0.f;
    if (q0 + l < L)
      x = to_f32(from_f32<T>(
          to_f32(q[((size_t)(r * L + q0 + l) * H + h) * hd + dd]) /
          scale_div));
    t.qs[l * ld + dd] = x;
  }
  if (tid < kB) {
    t.run_m[tid] = -INFINITY;
    t.run_l[tid] = 0.f;
  }
  __syncthreads();
  if (warp == 0) {
    const unsigned all = 0xffffffffu;
    int qmin = INT_MAX, qmax = 0;
    bool pad = false;
    for (int l = q0 + lane; l < min(q0 + kB, L); l += 32) {
      const int s = segs[l];
      if (s > 0) {
        qmin = min(qmin, s);
        qmax = max(qmax, s);
      } else {
        pad = true;
      }
    }
    qmin = __reduce_min_sync(all, qmin);
    qmax = __reduce_max_sync(all, qmax);
    pad = __any_sync(all, pad);
    int n = 0;
    for (int tt = 0; tt < (L + kB - 1) / kB; ++tt) {
      int tmin = INT_MAX, tmax = 0;
      for (int l = tt * kB + lane; l < min(tt * kB + kB, L); l += 32) {
        const int s = segs[l];
        if (s > 0) {
          tmin = min(tmin, s);
          tmax = max(tmax, s);
        }
      }
      tmin = __reduce_min_sync(all, tmin);
      tmax = __reduce_max_sync(all, tmax);
      if (pad || (tmin <= qmax && tmax >= qmin)) {
        if (lane == 0) s_tiles[n] = tt;
        ++n;
      }
    }
    if (lane == 0) s_ntiles = n;
  }
  __syncthreads();

  const int tx = tid & 15, ty = tid >> 4;
  float o[4][DB];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DB; ++c) o[a][c] = 0.f;

  for (int i = 0; i < s_ntiles; ++i) {
    const int kt0 = s_tiles[i] * kB;
    __syncthreads();  // the previous tile's K, V and scores are consumed
    tiles::stage_kv(t, k, v, r * L + kt0, L - kt0, H, h, hd, ld,
                    tid);
    __syncthreads();
    // ---- scores of queries ty + 16 a and keys tx + 16 b, masked
    float acc[4][4];
    tiles::score_block(t, ld, hd, ty, tx, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int iq = q0 + ty + 16 * a;
      const int sq = iq < L ? segs[iq] : 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = kt0 + tx + 16 * b;
        t.sc[(ty + 16 * a) * kSld + tx + 16 * b] =
            j >= L ? -INFINITY
                   : ((sq > 0 && segs[j] == sq) ? acc[a][b] : big_neg);
      }
    }
    __syncthreads();
    // ---- the online softmax, a warp a query row (the max is finite: the
    // tile has a key < L; the rescale is 0 at the first tile)
    tiles::softmax_rows(t, warp, lane, true, true);
    __syncthreads();
    // ---- O = O * alpha + P.V (keys past L weigh exactly 0)
    tiles::pv_accumulate<DB>(t, ld, hd, kB, ty, tx, o);
  }
  __syncthreads();
  // each query's log-sum-exp for the backward pass (K16), when asked for
  if (lse != nullptr && tid < kB && q0 + tid < L)
    lse[((size_t)r * H + h) * L + q0 + tid] =
        t.run_m[tid] + logf(t.run_l[tid]);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int iq = q0 + ty + 16 * a;
    if (iq >= L) continue;
    const float inv = 1.f / t.run_l[ty + 16 * a];
#pragma unroll
    for (int c = 0; c < DB; ++c) {
      const int dd = tx + 16 * c;
      if (dd < hd)
        out[((size_t)(r * L + iq) * H + h) * hd + dd] =
            from_f32<T>(o[a][c] * inv);
    }
  }
}

template <typename T, int DB>
cudaError_t launch_db(DeviceOnce& once, const void* q, const void* k,
                      const void* v, const void* seg, void* out, int R,
                      int L, int H, int hd, float scale_div, float big_neg,
                      void* lse, cudaStream_t stream) {
  cudaError_t err = max_smem_once(once, segment_attention_tiled_kernel<T, DB>,
                                  flash::kDynLimit);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)R * H * ((L + kB - 1) / kB);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  segment_attention_tiled_kernel<T, DB>
      <<<(unsigned)grid, kThreads, smem_bytes(hd, L), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int32_t*>(seg),
          static_cast<T*>(out), L, H, hd, scale_div, big_neg,
          static_cast<float*>(lse));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(DeviceOnce (&once)[2], const void* q, const void* k,
                   const void* v, const void* seg, void* out, int R, int L,
                   int H, int hd, float scale_div, float big_neg, void* lse,
                   cudaStream_t stream) {
  if (hd > 256 || L > kMaxL || smem_bytes(hd, L) > (size_t)flash::kDynLimit)
    return cudaErrorInvalidValue;
  if (hd <= 64)
    return launch_db<T, 4>(once[0], q, k, v, seg, out, R, L, H, hd,
                           scale_div, big_neg, lse, stream);
  return launch_db<T, 16>(once[1], q, k, v, seg, out, R, L, H, hd, scale_div,
                          big_neg, lse, stream);
}

DeviceOnce g_tiled_f32[2], g_tiled_bf16[2];

}  // namespace tiled

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. route: 0 = the one-tile CUDA-core
// kernel (L <= 64, hd <= 64), 1 = the one-tile tensor-core kernel (bf16,
// hd % 16 == 0, L % 4 == 0, 16-byte aligned, L <= 64, hd <= 64, a row's
// stage within shared memory), 2 = the tiled tensor-core kernel (bf16, hd
// % 16 == 0, 16-byte aligned, L <= 1024, hd <= 256), 3 = the tiled
// CUDA-core kernel (L <= 1024, hd <= 256). Shapes are checked by the
// Python wrapper (R * H > 0, contiguous (R, L, H, hd)). lse (nullable, the
// CUDA-core routes 0 and 3 only): an (R, H, L) f32 buffer that takes each
// query's log-sum-exp of its masked scores, for the backward pass (K16).
extern "C" int segment_attention_launch(const void* q, const void* k,
                                        const void* v, const void* seg,
                                        void* out, int R, int L, int H,
                                        int hd, int dtype, int route,
                                        float scale_div, float big_neg,
                                        void* lse, void* stream) {
  if (R <= 0 || H <= 0 || L <= 0 || hd <= 0 || L > tiled::kMaxL ||
      hd > 256 || (dtype != 0 && dtype != 1) || route < 0 || route > 3)
    return (int)cudaErrorInvalidValue;
  if (route < 2 && (L > kMaxL || hd > kMaxHd))
    return (int)cudaErrorInvalidValue;
  if ((route == 1 || route == 2) && (dtype != 1 || lse != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 1:
      return (int)tc::launch(q, k, v, seg, out, R, L, H, hd, 1.f / scale_div,
                             big_neg, s);
    case 2:
      return (int)flash::launch(q, k, v, seg, out, R, L, H, hd,
                                1.f / scale_div, big_neg, s);
    case 3:
      if (dtype == 0)
        return (int)tiled::launch<float>(tiled::g_tiled_f32, q, k, v, seg, out, R,
                                         L, H, hd, scale_div, big_neg, lse, s);
      return (int)tiled::launch<__nv_bfloat16>(tiled::g_tiled_bf16, q, k, v, seg,
                                               out, R, L, H, hd, scale_div,
                                               big_neg, lse, s);
    default:
      if (dtype == 0)
        return (int)simt::launch<float>(q, k, v, seg, out, R, L, H, hd,
                                        scale_div, big_neg, lse, s);
      return (int)simt::launch<__nv_bfloat16>(q, k, v, seg, out, R, L, H, hd,
                                              scale_div, big_neg, lse, s);
  }
}
