// The f32 CUDA-core attention tiles of K1's tiled kernel
// (segment_attention.cu `segment_attention_tiled_kernel`), and the
// once-per-device helpers and to_f32 that K22 (ring_attention.cu, on the
// tensor cores) also uses — for sm_90a.
//
// The kernel gives a CTA of 256 threads 64 queries of one (row, head) and
// streams the keys through shared memory in 64-key tiles with an online
// softmax. Its tiles are here:
//   * the shared-memory layout: Q, K and V tiles of kB x (D + 1) f32 (a
//     row padded by one float, so the 16 key rows a warp reads sit in 16
//     banks), the score tile, each query's running max, sum and rescale,
//     then a tail the kernel owns (the row's segment ids);
//   * the staging of a K and V tile as f32, zero past the last key;
//   * the 4 x 4 register block of q.k products a thread: queries ty + 16 a
//     and keys tx + 16 j (tx = tid & 15, ty = tid >> 4);
//   * the online softmax, a warp a query row: the tile's max merged into
//     the running max, the weights written over the scores, the running
//     sum rescaled by exp(m_old - m_new) and that rescale kept for P.V;
//   * O = O * rescale + P.V, thread (ty, tx) holding queries ty + 16 a at
//     dims tx + 16 c (c < DB) in registers.
// The kernel keeps the rest: how q is read and scaled, the mask and its
// fill, the final division and store.
//
// Also the once-per-device attribute helper (DeviceOnce, max_smem_once)
// both sources use. Everything sits in an anonymous namespace: each
// source that includes it is compiled into a library of its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;

// ---- once-per-device attributes (cudaFuncSetAttribute, SM count)

struct DeviceOnce {
  std::atomic<int> state[kMaxDevices];  // 0 unset, else value + 1
};

template <typename Fn>
cudaError_t once_per_device(DeviceOnce& once, int* value, Fn&& compute) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) {
    const int s = once.state[dev].load(std::memory_order_acquire);
    if (s != 0) {
      *value = s - 1;
      return cudaSuccess;
    }
  }
  err = compute(dev, value);
  if (err == cudaSuccess && dev < kMaxDevices)
    once.state[dev].store(*value + 1, std::memory_order_release);
  return err;
}

template <typename K>
cudaError_t max_smem_once(DeviceOnce& once, K kernel, int bytes) {
  int unused = 0;
  return once_per_device(once, &unused, [&](int, int* v) {
    *v = bytes;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  });
}

namespace tiles {

constexpr int kThreads = 256;
constexpr int kB = 64;        // queries a CTA, keys a tile
constexpr int kSld = kB + 1;  // the score tile's row pitch

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the shared floats before the kernel's own tail, at head dim D
__host__ __device__ constexpr size_t smem_floats(int D) {
  return (size_t)3 * kB * (D + 1) + (size_t)kB * kSld + 3 * kB;
}

struct Smem {
  float* qs;     // kB x (D + 1)
  float* ks;     // kB x (D + 1)
  float* vs;     // kB x (D + 1)
  float* sc;     // kB x kSld: scores, then weights
  float* run_m;  // kB: running max
  float* run_l;  // kB: running sum
  float* run_a;  // kB: this tile's rescale
  int* tail;     // the kernel's own
};

__device__ __forceinline__ Smem carve(float* base, int ld) {
  Smem t;
  t.qs = base;
  t.ks = t.qs + kB * ld;
  t.vs = t.ks + kB * ld;
  t.sc = t.vs + kB * ld;
  t.run_m = t.sc + kB * kSld;
  t.run_l = t.run_m + kB;
  t.run_a = t.run_l + kB;
  t.tail = reinterpret_cast<int*>(t.run_a + kB);
  return t;
}

// K and V rows pos0 .. pos0 + n - 1 of head h, in the (positions, H, D)
// layout, as f32 into the tiles; rows from n on are zero. The positions
// are ints: the caller bounds them below 2^31 (K1's R L), and K1 runs
// their 32-bit sums measurably faster than size_t's.
template <typename T>
__device__ __forceinline__ void stage_kv(const Smem& t,
                                         const T* __restrict__ k,
                                         const T* __restrict__ v, int pos0,
                                         int n, int H, int h, int D, int ld,
                                         int tid) {
  for (int e = tid; e < kB * D; e += kThreads) {
    const int l = e / D, dd = e - l * D;
    float kx = 0.f, vx = 0.f;
    if (l < n) {
      const size_t g = ((size_t)(pos0 + l) * H + h) * D + dd;
      kx = to_f32(k[g]);
      vx = to_f32(v[g]);
    }
    t.ks[l * ld + dd] = kx;
    t.vs[l * ld + dd] = vx;
  }
}

// dot[a][j] = q_(ty + 16 a) . k_(tx + 16 j) over the staged tiles
__device__ __forceinline__ void score_block(const Smem& t, int ld, int D,
                                            int ty, int tx,
                                            float (&dot)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) dot[a][j] = 0.f;
  for (int dd = 0; dd < D; ++dd) {
    float qa[4], kb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) qa[a] = t.qs[(ty + 16 * a) * ld + dd];
#pragma unroll
    for (int j = 0; j < 4; ++j) kb[j] = t.ks[(tx + 16 * j) * ld + dd];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) dot[a][j] = fmaf(qa[a], kb[j], dot[a][j]);
  }
}

// The online softmax over the score tile, a warp a query row: the row's
// max merged into run_m, each weight exp(x - m_new) written over its
// score (0 for key lane / lane + 32 where keep0 / keep1 is false, whatever
// the exponential gives), run_l rescaled by exp(m_old - m_new) plus the
// weights, and that rescale left in run_a for pv_accumulate. The caller
// fills the tile so that each row's max is finite.
__device__ __forceinline__ void softmax_rows(const Smem& t, int warp,
                                             int lane, bool keep0,
                                             bool keep1) {
  for (int row = warp; row < kB; row += kThreads / 32) {
    const float x0 = t.sc[row * kSld + lane];
    const float x1 = t.sc[row * kSld + lane + 32];
    float tm = fmaxf(x0, x1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, off));
    const float mo = t.run_m[row];
    const float mn = fmaxf(mo, tm);
    const float p0 = keep0 ? expf(x0 - mn) : 0.f;
    const float p1 = keep1 ? expf(x1 - mn) : 0.f;
    float sum = p0 + p1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    t.sc[row * kSld + lane] = p0;
    t.sc[row * kSld + lane + 32] = p1;
    __syncwarp();
    if (lane == 0) {
      const float al = expf(mo - mn);
      t.run_a[row] = al;
      t.run_l[row] = t.run_l[row] * al + sum;
      t.run_m[row] = mn;
    }
  }
}

// o = o * run_a + P.V over the tile's first nk keys (DB: 16-dim blocks a
// thread holds; dims past D read 0)
template <int DB>
__device__ __forceinline__ void pv_accumulate(const Smem& t, int ld, int D,
                                              int nk, int ty, int tx,
                                              float (&o)[4][DB]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float al = t.run_a[ty + 16 * a];
#pragma unroll
    for (int c = 0; c < DB; ++c) o[a][c] *= al;
  }
  for (int j = 0; j < nk; ++j) {
    float pa[4], vb[DB];
#pragma unroll
    for (int a = 0; a < 4; ++a) pa[a] = t.sc[(ty + 16 * a) * kSld + j];
#pragma unroll
    for (int c = 0; c < DB; ++c) {
      const int dd = tx + 16 * c;
      vb[c] = dd < D ? t.vs[j * ld + dd] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < DB; ++c) o[a][c] = fmaf(pa[a], vb[c], o[a][c]);
  }
}

}  // namespace tiles

}  // namespace
