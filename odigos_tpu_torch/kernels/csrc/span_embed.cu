// Span-embedding gather-sum for Hopper (sm_90a).
//
// Replaces: odigos_tpu/models/layers.py SpanEmbedder.__call__ plus the
// positional add and the padding mask of Encoder.__call__ (layers.py:35-56
// and :106-115), which the JAX package left to XLA as five embedding
// gathers, an attr-slot gather-sum, a 3->d Dense and two elementwise ops.
// For every packed slot n it computes, in f32, rounding once to T:
//
//   x = svc[c0] + name[c1] + kind[c2] + status[c3] + svc[c4]
//       + sum_s attr[c5+s] + cont @ Wc^T + bc + pos[positions]
//   out = segments > 0 ? x : 0
//
// (c4 is the parent service: it shares the service table.) Each table is
// read as Flax's nn.Embed reads it, jnp.take in fill mode (flax 0.12.3):
// an id in [0, rows) takes its row, one in [-rows, 0) row id + rows, and
// any other id a NaN row, so the live slot's whole sum is NaN; a one-row
// table is broadcast to every id. The positions are the packer's own (0 <=
// p < max_len) and are held into the positional table. The sum runs term
// by term in the plain version's order with no fused multiply-add
// (__fadd_rn/__fmul_rn), so kernel and plain version agree to the bit in
// f32 wherever every id is in range, and put NaN in the same slots.
//
// Bound on the card: bytes. Each slot writes d outputs and reads a few ids
// and 3 floats, and its live slots gather a few table rows that stay in the
// 50 MB L2. The f32 work is ~13 flops per output element, far under what
// the output bytes cost. What held the first design back was cache traffic
// and latency: every slot re-read kind, status, its positional row and all
// of cont_w and cont_b (~10 KB of L1/L2 reads per 512 B written) with
// 4-byte loads, one slot after another.
//
// Design (the sliced path: 16-byte aligned tables, d a multiple of
// 32 * kCols): persistent CTAs of 16 warps. Each CTA stages in shared
// memory the tables every slot reads: kind (8 x d), status (4 x d),
// cont_w transposed to (3, d), cont_b, and the positional table when it
// fits (max_len x d: 64 KB at the default; read from global otherwise).
// A warp owns a fixed slice of 32 * kCols columns (all of d = 256), so
// its lane's kCols columns of cont_w and cont_b stay in registers. The
// CTA walks batches of slots; the next batch's ids, continuous values,
// positions and segments are copied into shared memory (4-byte cp.async,
// a second buffer) while this batch sums, so no slot waits on device
// memory for its words. A warp takes kSlotsPerWarp consecutive slots of a
// batch: the service, name and parent-service rows (and attr rows) come
// from L2 as float4 loads, the next slot's loaded while this slot sums;
// kind, status and pos come from shared memory as float4; the output
// leaves as one 16-byte store of 8 bf16 per lane. A padding slot gathers
// nothing and stores zeros. Any other d takes the scalar path: one warp
// per slot, one column per lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "embed_take.cuh"  // take_row

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 1;   // one CTA of 16 warps per SM: <= 128 regs
constexpr int kCols = 8;        // columns per lane on the sliced path
constexpr int kBaseFields = 5;  // service, name, kind, status, parent_service
constexpr int kKindVocab = 8;
constexpr int kStatusVocab = 4;
constexpr int kMetaAttrLane = 10;  // scalar path: lanes 10.. hold attr ids
constexpr int kSmallTableRows = kKindVocab + kStatusVocab + 3 + 1;
constexpr int kSmemLimit = 232448;      // 227 KB, the most a block may use
constexpr int kStagePosLimit = 108032;  // with the batch buffers, 113 KB
constexpr int kSlotsPerWarp = 4;  // consecutive slots a warp takes per batch
constexpr int kBatchMax = kWarps * kSlotsPerWarp;  // slots of a batch
constexpr int kMetaWords = 12;    // a slot's words in shared memory (10 used)
constexpr int kMetaBytes = 2 * kBatchMax * kMetaWords * 4;  // two buffers
constexpr int kMaxDevices = 64;

// A position's row: the packer's positions lie in [0, max_len)
__device__ __forceinline__ int pos_row(int p, int n) {
  return p < 0 ? 0 : (p >= n ? n - 1 : p);
}

// A row to read for an id: its own, or row 0 where it takes none (the sum
// is replaced by NaN then)
__device__ __forceinline__ size_t read_row(int i, int n) {
  const int r = take_row(i, n);
  return (size_t)(r < 0 ? 0 : r);
}

// kCols consecutive f32 columns of one table row or of the output
struct Cols {
  float v[kCols];
};

// the output of a slot with an id that takes no row
__device__ __forceinline__ Cols nan_cols() {
  Cols c;
#pragma unroll
  for (int i = 0; i < kCols; ++i) c.v[i] = __int_as_float(0x7fffffff);
  return c;
}

__device__ __forceinline__ Cols ld_global(const float* p) {
  Cols c;
#pragma unroll
  for (int i = 0; i < kCols; i += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + i));
    c.v[i] = a.x, c.v[i + 1] = a.y, c.v[i + 2] = a.z, c.v[i + 3] = a.w;
  }
  return c;
}

__device__ __forceinline__ Cols ld_shared(const float* p) {
  Cols c;
#pragma unroll
  for (int i = 0; i < kCols; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    c.v[i] = a.x, c.v[i + 1] = a.y, c.v[i + 2] = a.z, c.v[i + 3] = a.w;
  }
  return c;
}

__device__ __forceinline__ void add(Cols& acc, const Cols& x) {
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc.v[i] = __fadd_rn(acc.v[i], x.v[i]);
}

__device__ __forceinline__ void store(float* o, const Cols& x) {
#pragma unroll
  for (int i = 0; i < kCols; i += 4)
    *reinterpret_cast<float4*>(o + i) =
        make_float4(x.v[i], x.v[i + 1], x.v[i + 2], x.v[i + 3]);
}

__device__ __forceinline__ void store(__nv_bfloat16* o, const Cols& x) {
  uint32_t w[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) {
    __nv_bfloat162 p = __floats2bfloat162_rn(x.v[2 * i], x.v[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&p);
  }
  if (kCols == 8)
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
}

__device__ __forceinline__ void cp_async4(int* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
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

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ((x0*w0 + x1*w1) + x2*w2) + b, each step rounded, as the plain version
__device__ __forceinline__ float cont_proj(float x0, float x1, float x2,
                                           float w0, float w1, float w2,
                                           float b) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x0, w0), __fmul_rn(x1, w1)),
                             __fmul_rn(x2, w2)),
                   b);
}

// The scalar path's slot words, lane i holding word i: 0-4 base ids, 5-7
// continuous (as bits), 8 position, 9 segment, 10-31 attr ids 5..26 (past
// C: a copy of id 0, never read). One load: each lane picks its address.
__device__ __forceinline__ int load_meta(const int32_t* __restrict__ cat,
                                         const float* __restrict__ cont,
                                         const int32_t* __restrict__ pos,
                                         const int32_t* __restrict__ seg,
                                         int n, int C, int lane) {
  int a = lane < kMetaAttrLane ? lane : kBaseFields + lane - kMetaAttrLane;
  a = a < C ? a : 0;
  const int32_t* p =
      lane < kBaseFields || lane >= kMetaAttrLane
          ? cat + (size_t)n * C + a
          : lane < kBaseFields + 3
                ? reinterpret_cast<const int32_t*>(cont) + (size_t)n * 3 +
                      lane - kBaseFields
                : lane == 8 ? pos + n : seg + n;
  return __ldg(p);
}

template <typename T, bool kSliced>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
span_embed_kernel(const int32_t* __restrict__ cat,
                  const float* __restrict__ cont,
                  const int32_t* __restrict__ positions,
                  const int32_t* __restrict__ segments,
                  const float* __restrict__ svc, const float* __restrict__ name,
                  const float* __restrict__ kind,
                  const float* __restrict__ status,
                  const float* __restrict__ attr,
                  const float* __restrict__ cont_w,
                  const float* __restrict__ cont_b,
                  const float* __restrict__ pos_tab, T* __restrict__ out,
                  int N, int C, int d, int n_svc, int n_name, int n_attr,
                  int n_pos, int stage_pos) {
  extern __shared__ __align__(16) float emb_smem[];
  float* s_kind = emb_smem;                    // [8][d]
  float* s_status = s_kind + kKindVocab * d;   // [4][d]
  float* s_cw = s_status + kStatusVocab * d;   // [3][d], cont_w transposed
  float* s_cb = s_cw + 3 * d;                  // [d]
  float* s_pos = s_cb + d;                     // [n_pos][d] when staged

  // ---- stage the tables every slot reads
  for (int i = threadIdx.x; i < kKindVocab * d; i += kThreads)
    s_kind[i] = kind[i];
  for (int i = threadIdx.x; i < kStatusVocab * d; i += kThreads)
    s_status[i] = status[i];
  for (int i = threadIdx.x; i < 3 * d; i += kThreads) {
    const int j = i / d;
    s_cw[i] = cont_w[(size_t)(i - j * d) * 3 + j];
  }
  for (int i = threadIdx.x; i < d; i += kThreads) s_cb[i] = cont_b[i];
  if (stage_pos) {
    if (kSliced) {
      const float4* src = reinterpret_cast<const float4*>(pos_tab);
      float4* dst = reinterpret_cast<float4*>(s_pos);
      for (int i = threadIdx.x; i < n_pos * d / 4; i += kThreads)
        dst[i] = __ldg(src + i);
    } else {
      for (int i = threadIdx.x; i < n_pos * d; i += kThreads)
        s_pos[i] = pos_tab[i];
    }
  }
  __syncthreads();
  const float* pos_t = stage_pos ? s_pos : pos_tab;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const unsigned all = 0xffffffffu;

  if (kSliced) {
    // Each warp owns one slice of 32 * kCols columns (d / (32 * kCols)
    // slices; the launcher checks they divide the warps), so its lane's
    // kCols columns of cont_w and cont_b stay in registers. The CTA walks
    // batches of slots: the next batch's ids, continuous values, positions
    // and segments are copied into shared memory (cp.async, a second
    // buffer) while this batch sums, and a warp takes kSlotsPerWarp
    // consecutive slots of the batch, the next slot's L2 rows in flight
    // while this slot sums.
    const int warp = threadIdx.x >> 5;
    const int slices = d / (32 * kCols);
    const int col = (warp % slices) * 32 * kCols + lane * kCols;
    const int B = kWarps / slices * kSlotsPerWarp;  // slots per batch
    const int n_batches = (N + B - 1) / B;
    int* meta = reinterpret_cast<int*>(s_pos + (stage_pos ? n_pos * d : 0));
    const Cols w0 = ld_shared(s_cw + col);
    const Cols w1 = ld_shared(s_cw + d + col);
    const Cols w2 = ld_shared(s_cw + 2 * d + col);
    const Cols bc = ld_shared(s_cb + col);

    // batch b's words into meta buffer `buf`: slot s at s * kMetaWords,
    // words 0-4 ids, 5-7 continuous (bits), 8 position, 9 segment
    auto fetch = [&](int b, int buf) {
      int* m = meta + buf * kBatchMax * kMetaWords;
      for (int t = threadIdx.x; t < B * 10; t += kThreads) {
        const int slot = t / 10;
        const int f = t - slot * 10;
        const int n = b * B + slot;
        if (n >= N) continue;
        const int32_t* src =
            f < kBaseFields ? cat + (size_t)n * C + f
            : f < kBaseFields + 3
                ? reinterpret_cast<const int32_t*>(cont) + (size_t)n * 3 +
                      f - kBaseFields
            : f == 8 ? positions + n
                     : segments + n;
        cp_async4(m + slot * kMetaWords + f, src);
      }
      cp_async_commit();
    };
    // the slot's three L2 rows (service, name, parent service), when live
    auto gather = [&](const int* mk, Cols (&g)[3]) {
      if (mk[9] > 0) {
        g[0] = ld_global(svc + read_row(mk[0], n_svc) * d + col);
        g[1] = ld_global(name + read_row(mk[1], n_name) * d + col);
        g[2] = ld_global(svc + read_row(mk[4], n_svc) * d + col);
      }
    };

    int buf = 0;
    if (blockIdx.x < n_batches) fetch(blockIdx.x, 0);
    for (int b = blockIdx.x; b < n_batches; b += gridDim.x, buf ^= 1) {
      if (b + gridDim.x < n_batches)
        fetch(b + gridDim.x, buf ^ 1);
      else
        cp_async_commit();  // an empty group keeps the count of groups
      cp_async_wait<1>();
      __syncthreads();
      const int first = (warp / slices) * kSlotsPerWarp;
      const int* m = meta + (buf * kBatchMax + first) * kMetaWords;
      const int n0 = b * B + first;
      Cols g[2][3] = {};
      if (n0 < N) gather(m, g[0]);
#pragma unroll
      for (int k = 0; k < kSlotsPerWarp; ++k) {
        const int n = n0 + k;
        if (n >= N) break;
        const int* mk = m + k * kMetaWords;
        if (k + 1 < kSlotsPerWarp && n + 1 < N)
          gather(mk + kMetaWords, g[(k + 1) & 1]);
        const int4 w_a = *reinterpret_cast<const int4*>(mk);      // c0-c3
        const int4 w_b = *reinterpret_cast<const int4*>(mk + 4);  // c4, x
        const int2 w_c = *reinterpret_cast<const int2*>(mk + 8);  // pos, seg
        T* o = out + (size_t)n * d + col;
        if (w_c.y > 0) {
          const Cols(&gc)[3] = g[k & 1];
          const int i_kind = take_row(w_a.z, kKindVocab);
          const int i_status = take_row(w_a.w, kStatusVocab);
          const int i_pos = pos_row(w_c.x, n_pos);
          // negative where an id takes no row: the slot is NaN
          int miss = take_row(w_a.x, n_svc) | take_row(w_a.y, n_name) |
                     i_kind | i_status | take_row(w_b.x, n_svc);
          // the sum in the plain version's order
          Cols acc = gc[0];
          add(acc, gc[1]);
          add(acc, ld_shared(s_kind + max(i_kind, 0) * d + col));
          add(acc, ld_shared(s_status + max(i_status, 0) * d + col));
          add(acc, gc[2]);
          for (int a = kBaseFields; a < C; ++a) {
            const int id = __ldg(cat + (size_t)n * C + a);
            miss |= take_row(id, n_attr);
            add(acc, ld_global(attr + read_row(id, n_attr) * d + col));
          }
          const float x0 = __int_as_float(w_b.y);
          const float x1 = __int_as_float(w_b.z);
          const float x2 = __int_as_float(w_b.w);
          Cols proj;
#pragma unroll
          for (int i = 0; i < kCols; ++i)
            proj.v[i] =
                cont_proj(x0, x1, x2, w0.v[i], w1.v[i], w2.v[i], bc.v[i]);
          add(acc, proj);
          add(acc, stage_pos ? ld_shared(pos_t + (size_t)i_pos * d + col)
                             : ld_global(pos_t + (size_t)i_pos * d + col));
          store(o, miss < 0 ? nan_cols() : acc);
        } else {
          store(o, Cols{});
        }
      }
      __syncthreads();  // every warp is done with `buf` before its refill
    }
    return;
  }

  // Any other d: one column per lane. The column loop runs a warp-uniform
  // count (every lane reaches each shuffle); a lane past d skips its work.
  const int stride = gridDim.x * kWarps;
  for (int n = gw; n < N; n += stride) {
    const int meta = load_meta(cat, cont, positions, segments, n, C, lane);
    T* o = out + (size_t)n * d;
    if (__shfl_sync(all, meta, 9) <= 0) {
      for (int col = lane; col < d; col += 32) o[col] = from_f32<T>(0.f);
      continue;
    }
    const int r_svc = take_row(__shfl_sync(all, meta, 0), n_svc);
    const int r_name = take_row(__shfl_sync(all, meta, 1), n_name);
    const int r_kind = take_row(__shfl_sync(all, meta, 2), kKindVocab);
    const int r_status = take_row(__shfl_sync(all, meta, 3), kStatusVocab);
    const int r_parent = take_row(__shfl_sync(all, meta, 4), n_svc);
    // negative where an id takes no row: the slot is NaN
    int miss = r_svc | r_name | r_kind | r_status | r_parent;
    const size_t i_svc = (size_t)max(r_svc, 0);
    const size_t i_name = (size_t)max(r_name, 0);
    const int i_kind = max(r_kind, 0);
    const int i_status = max(r_status, 0);
    const size_t i_parent = (size_t)max(r_parent, 0);
    const float x0 = __int_as_float(__shfl_sync(all, meta, 5));
    const float x1 = __int_as_float(__shfl_sync(all, meta, 6));
    const float x2 = __int_as_float(__shfl_sync(all, meta, 7));
    const size_t i_pos = (size_t)pos_row(__shfl_sync(all, meta, 8), n_pos);
    for (int base = 0; base < d; base += 32) {
      const int col = base + lane;
      const bool on = col < d;
      float acc = 0.f;
      if (on) {
        acc = __fadd_rn(svc[i_svc * d + col], name[i_name * d + col]);
        acc = __fadd_rn(acc, s_kind[i_kind * d + col]);
        acc = __fadd_rn(acc, s_status[i_status * d + col]);
        acc = __fadd_rn(acc, svc[i_parent * d + col]);
      }
      for (int a = kBaseFields; a < C; ++a) {
        const int id = a < kBaseFields + 32 - kMetaAttrLane
                           ? __shfl_sync(all, meta,
                                         a - kBaseFields + kMetaAttrLane)
                           : __ldg(cat + (size_t)n * C + a);
        miss |= take_row(id, n_attr);
        if (on) acc = __fadd_rn(acc, attr[read_row(id, n_attr) * d + col]);
      }
      if (!on) continue;
      acc = __fadd_rn(acc, cont_proj(x0, x1, x2, s_cw[col], s_cw[d + col],
                                     s_cw[2 * d + col], s_cb[col]));
      acc = __fadd_rn(acc, pos_t[i_pos * d + col]);
      o[col] = from_f32<T>(miss < 0 ? __int_as_float(0x7fffffff) : acc);
    }
  }
}

// ---- once-per-device launch set-up: the shared-memory attribute and the
// number of CTAs per SM at the last shared-memory size asked for

struct LaunchInfo {
  std::atomic<int> attr_set[kMaxDevices];
  std::atomic<int> sms[kMaxDevices];
  std::atomic<long long> occ[kMaxDevices];  // (smem bytes << 8) | blocks
};

template <typename T, bool kSliced>
cudaError_t launch(LaunchInfo& info, const void* cat, const void* cont,
                   const void* positions, const void* segments,
                   const void* svc, const void* name, const void* kind,
                   const void* status, const void* attr, const void* cont_w,
                   const void* cont_b, const void* pos_tab, void* out, int N,
                   int C, int d, int n_svc, int n_name, int n_attr,
                   int n_pos, cudaStream_t stream) {
  auto kernel = span_embed_kernel<T, kSliced>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!info.attr_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    info.sms[dev].store(sms, std::memory_order_relaxed);
    info.attr_set[dev].store(1, std::memory_order_release);
  }
  const long long small = (long long)kSmallTableRows * d * 4;
  const long long with_pos = small + (long long)n_pos * d * 4;
  const int stage_pos = with_pos <= kStagePosLimit ? 1 : 0;
  const int smem =
      (int)(stage_pos ? with_pos : small) + (kSliced ? kMetaBytes : 0);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  long long occ = info.occ[dev].load(std::memory_order_acquire);
  int per_sm = 0;
  if ((occ >> 8) == smem) {
    per_sm = (int)(occ & 0xff);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    info.occ[dev].store(((long long)smem << 8) | (per_sm & 0xff),
                        std::memory_order_release);
  }
  const int sms = info.sms[dev].load(std::memory_order_relaxed);
  // no more CTAs than batches: each stages the tables once
  const long long want = ((long long)N + kBatchMax - 1) / kBatchMax;
  const int cap = per_sm * sms;
  const int blocks = (int)(want < cap ? want : cap);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(cat), static_cast<const float*>(cont),
      static_cast<const int32_t*>(positions),
      static_cast<const int32_t*>(segments), static_cast<const float*>(svc),
      static_cast<const float*>(name), static_cast<const float*>(kind),
      static_cast<const float*>(status), static_cast<const float*>(attr),
      static_cast<const float*>(cont_w), static_cast<const float*>(cont_b),
      static_cast<const float*>(pos_tab), static_cast<T*>(out), N, C, d,
      n_svc, n_name, n_attr, n_pos, stage_pos);
  return cudaGetLastError();
}

LaunchInfo g_f32_sliced, g_f32_scalar, g_bf16_sliced, g_bf16_scalar;

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the output type; tables are f32).
// aligned: 1 when every table and the output are 16-byte aligned (the
// wrapper checks). The sliced path takes aligned tables at d % (32 *
// kCols) == 0 with whole slices per CTA; any other d the scalar path.
// `attr` may be null only when C == 5. Shapes are checked by the wrapper.
extern "C" int span_embed_launch(
    const void* cat, const void* cont, const void* positions,
    const void* segments, const void* svc, const void* name,
    const void* kind, const void* status, const void* attr,
    const void* cont_w, const void* cont_b, const void* pos_tab, void* out,
    int N, int C, int d, int n_svc, int n_name, int n_attr, int n_pos,
    int dtype, int aligned, void* stream) {
  if (N <= 0 || d <= 0 || C < kBaseFields || (C > kBaseFields && !attr))
    return (int)cudaErrorInvalidValue;
  const int width = 32 * kCols;
  const bool sliced = aligned && d % width == 0 && kWarps % (d / width) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPAN_EMBED_ARGS                                                    \
  cat, cont, positions, segments, svc, name, kind, status, attr, cont_w,  \
      cont_b, pos_tab, out, N, C, d, n_svc, n_name, n_attr, n_pos, st
  cudaError_t err;
  if (dtype == 0)
    err = sliced ? launch<float, true>(g_f32_sliced, SPAN_EMBED_ARGS)
                 : launch<float, false>(g_f32_scalar, SPAN_EMBED_ARGS);
  else if (dtype == 1)
    err = sliced
              ? launch<__nv_bfloat16, true>(g_bf16_sliced, SPAN_EMBED_ARGS)
              : launch<__nv_bfloat16, false>(g_bf16_scalar, SPAN_EMBED_ARGS);
  else
    err = cudaErrorInvalidValue;
#undef SPAN_EMBED_ARGS
  return (int)err;
}
