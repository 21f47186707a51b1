// K24: the cross-shard merge of the autoencoder's vocabulary-sliced
// cross-entropies — for Hopper (sm_90a).
//
// Replaces what XLA inserts when odigos_tpu/parallel/sharding.py:104
// (PARTITION_RULES) puts the service and name heads' columns on the "model"
// axis: the cross-shard max, sum and label gather inside _ce's log_softmax
// and take_along_axis (odigos_tpu/models/autoencoder.py:93-95), then
// _errors' weighted sum (:112-120).
//
// Input: each shard's K11 slice-mode records (recon_ce.cu), gathered over
// the model axis in rank order, (tp, M, 8) f32: per real position (lse_s,
// zl_s, lse_n, zl_n, ce_k, dd, lse_k, 0), the log-sum-exp of the shard's
// slice of each vocabulary head, the label's logit where the slice holds
// it, the replicated kind head's cross-entropy, duration - target and the
// kind head's log-sum-exp. A thread a position:
//   lse_h = m + log(sum_r exp(lse_h[r] - m)), m the largest, over the
//           parts of head h in rank order (a head the mesh guard keeps
//           whole is one part: rank 0's lse_h itself, counted once);
//   zl_h  = the label's logit from the rank whose slice holds it, the
//           label read against the whole head (embed_take.cuh
//           take_label); NaN where no row holds it (fill mode: C5);
//   err   = w_s (lse_s - zl_s) + w_n (lse_n - zl_n) + w_k ce_k
//           + w_d dd dd, in K11's weighted_error steps;
// and, where asked (the trainer's forward), the merged log-sum-exps (lse_s,
// lse_n, lse_k) that K20 reads. Padding positions write 0. Every rank
// merges the same gathered bytes in the same order, so the error is
// bit-equal over the model group; at tp = 1 it is K11's error bit for bit
// (one part: no arithmetic on the log-sum-exps).
// Bound on the card: bytes. A real position reads rank 0's 32-byte record,
// the first 16 bytes of each other rank's where a head is sliced, and its
// two labels (8 bytes); every position reads its mask byte and writes its
// 4-byte error and, where asked, its 12 bytes of log-sum-exps.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "embed_take.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRec = 8;  // floats a record (recon_ce.cu)

struct MergeArgs {
  const float* rec;  // (tp, M, kRec)
  int tp;
  long long M;
  const int32_t* cat;
  int C;
  const uint8_t* mask;
  int vf[2], vs[2];  // each head's whole width and its slice's (vf: whole)
  float w_s, w_n, w_k, w_d;
  float* err;
  float* lse;  // nullable: (M, 3)
};

__global__ void __launch_bounds__(kThreads) vocab_merge_kernel(
    const MergeArgs a) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x; q < a.M;
       q += stride) {
    if (!a.mask[q]) {
      a.err[q] = 0.f;
      if (a.lse != nullptr)
        for (int h = 0; h < 3; ++h) a.lse[q * 3 + h] = 0.f;
      continue;
    }
    const float4* r4 = reinterpret_cast<const float4*>(a.rec + q * kRec);
    const long long rank4 = a.M * (kRec / 4);  // a rank's records, float4
    const float4 k0 = __ldg(r4 + 1);           // rank 0's ce_k, dd, lse_k
    float lse[2], zl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int parts = a.vf[h] / a.vs[h];
      const float2 own = h == 0 ? make_float2(__ldg(r4).x, __ldg(r4).y)
                                : make_float2(__ldg(r4).z, __ldg(r4).w);
      float l = own.x;
      if (parts > 1) {
        float m = -INFINITY;
        for (int r = 0; r < parts; ++r) {
          const float4 v = __ldg(r4 + r * rank4);
          m = fmaxf(m, h == 0 ? v.x : v.z);
        }
        float s = 0.f;
        for (int r = 0; r < parts; ++r) {
          const float4 v = __ldg(r4 + r * rank4);
          s = __fadd_rn(s, expf(__fsub_rn(h == 0 ? v.x : v.z, m)));
        }
        l = __fadd_rn(m, logf(s));
      }
      lse[h] = l;
      const int lab = take_label(a.cat[q * a.C + h], a.vf[h]);
      float z = NAN;
      if (lab >= 0) {
        const float4 v = __ldg(r4 + (lab / a.vs[h]) * rank4);
        z = h == 0 ? v.y : v.w;
      }
      zl[h] = z;
    }
    const float dd = k0.y;
    float e = __fmul_rn(a.w_s, __fsub_rn(lse[0], zl[0]));
    e = __fadd_rn(e, __fmul_rn(a.w_n, __fsub_rn(lse[1], zl[1])));
    e = __fadd_rn(e, __fmul_rn(a.w_k, k0.x));
    a.err[q] = __fadd_rn(e, __fmul_rn(a.w_d, __fmul_rn(dd, dd)));
    if (a.lse != nullptr) {
      a.lse[q * 3] = lse[0];
      a.lse[q * 3 + 1] = lse[1];
      a.lse[q * 3 + 2] = k0.z;
    }
  }
}

}  // namespace

// K24. rec: (tp, M, 8) f32, the shards' K11 slice-mode records in rank
// order, 16-byte aligned; cat: (M, C) int32 (labels in columns 0-1);
// mask: (M,) bytes; vf0, vs0, vf1, vs1: the service and name heads' whole
// widths and each shard's slice width (vs = vf: a whole head; else vf =
// tp vs); the four loss weights. Out: err (M,) f32; lse (nullable): (M, 3)
// f32, the merged log-sum-exps (0 at padding). sms: the card's
// multiprocessors; *launches gets the kernels launched (1).
extern "C" int vocab_ce_merge_launch(const void* rec, int tp, long long M,
                                     const void* cat, int C,
                                     const void* mask, int vf0, int vs0,
                                     int vf1, int vs1, float w_s, float w_n,
                                     float w_k, float w_d, void* err,
                                     void* lse, int sms, int* launches,
                                     void* stream) {
  *launches = 0;
  const int vf[2] = {vf0, vf1}, vs[2] = {vs0, vs1};
  if (M < 0 || tp < 1 || C < 2 || sms < 1 || rec == nullptr ||
      err == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int h = 0; h < 2; ++h)
    if (vs[h] < 1 || vf[h] % vs[h] != 0 ||
        (vf[h] != vs[h] && vf[h] != tp * vs[h]))
      return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  MergeArgs a;
  a.rec = static_cast<const float*>(rec);
  a.tp = tp;
  a.M = M;
  a.cat = static_cast<const int32_t*>(cat);
  a.C = C;
  a.mask = static_cast<const uint8_t*>(mask);
  for (int h = 0; h < 2; ++h) {
    a.vf[h] = vf[h];
    a.vs[h] = vs[h];
  }
  a.w_s = w_s;
  a.w_n = w_n;
  a.w_k = w_k;
  a.w_d = w_d;
  a.err = static_cast<float*>(err);
  a.lse = static_cast<float*>(lse);
  long long blocks = (M + kThreads - 1) / kThreads;
  const long long most = 8LL * sms;  // grid-stride past 8 CTAs an SM
  if (blocks > most) blocks = most;
  vocab_merge_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launches;
  return (int)e;
}
