// K6: a stable LSD radix sort of multi-word unsigned keys for Hopper
// (sm_90a), returning the int32 permutation that sorts them.
//
// Replaces the two sorts of the JAX package's fused route, which XLA runs
// as jnp.lexsort: the trace-major, time-minor layout sort of
// odigos_tpu/serving/fused.py _sorted_trace_layout (:429-459; keys
// trace_id_hi, trace_id_lo, start_unix_nano) and the sort under the
// per-frame parent self-join of odigos_tpu/features/featurizer.py
// featurize_join_jax (:405-440; keys frame, span_id). The reference splits
// each u64 into u32 halves because it serves without x64; this kernel
// keeps whole u64 words (PyTorch int64 tensors read as unsigned).
//
// Contract: keys are up to four words, each 32 or 64 bits, least
// significant first; the first n of N rows are sorted, stably (tied keys
// keep their order), and rows n..N-1 (padding) keep the identity: out[j]
// = j. That is what the reference's is_pad-primary lexsort gives.
//
// Design (right first):
//   prep     one grid pass: the identity payload, and per word the OR of
//            the keys and the OR of their complements; a digit whose bits
//            are equal in every key (the same in both ORs) needs no pass;
//   per 8-bit digit pass, two launches, both returning at once when the
//   digit is constant over the keys (start_hi's top bytes, frame in a
//   one-frame group, the upper bytes of small frame ordinals):
//     hist    each block counts the digits of its tile of 2048 keys
//             (8 warps x 8 rounds of 32), into counts[digit][block];
//     scatter each block recounts its tile, takes its offsets straight
//             from counts (the keys of smaller digits anywhere, then the
//             same digit in earlier blocks: 256 threads x nblocks reads,
//             a few dozen blocks at the route's sizes), and writes every
//             key at its stable rank: warps own consecutive sub-tiles,
//             each round ranks its 32 lanes by __match_any_sync + popc in
//             lane order, and a per-(warp, digit) running offset in
//             shared memory carries the order from round to round;
//   finish   copies the payload out of whichever ping-pong buffer the
//            live passes left it in, and writes the identity for padding.
// A global atomicAdd scatter would not be stable; ranking by lane, round,
// warp and block order is. Each kernel works out for itself which buffer
// holds the current order (the parity of the live passes before it), so
// skipping needs no host sync.
//
// Bound on the card: bytes. The keys are read once and the permutation
// written once (at N = 65536 spans the trace sort's three u64 words and
// the int32 payload: 1.8 MB, 0.5 us at 3.35 TB/s), but each live pass
// gathers its digit through the current payload and writes the payload
// anew, and the ~20 live passes of a trace sort are ~40 dependent
// launches of a few microseconds each: launch latency bounds it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWords = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr int kWarpTile = kRounds * 32;
constexpr int kTile = kWarps * kWarpTile;  // keys per block
constexpr int kBins = 256;
constexpr int kPrepThreads = 256;

struct Keys {
  const void* word[kMaxWords];  // least significant first
  int bits[kMaxWords];          // 32 or 64
  int n_words;
};

__device__ __forceinline__ unsigned long long key_word(const Keys& k, int w,
                                                       long long i) {
  return k.bits[w] == 64
             ? static_cast<const unsigned long long*>(k.word[w])[i]
             : static_cast<unsigned long long>(
                   static_cast<const unsigned int*>(k.word[w])[i]);
}

// The digit at `shift` of word `w` differs between some two keys.
__device__ __forceinline__ bool digit_live(const unsigned long long* var,
                                           int w, int shift) {
  return ((var[2 * w] & var[2 * w + 1]) >> shift) & 0xFFull;
}

// Pass p's word and shift, and the parity of the live passes before it
// (which ping-pong buffer holds the order pass p reads). p may be the
// total number of passes: then only the parity is meaningful.
__device__ bool pass_info(const Keys& k, const unsigned long long* var,
                          int p, int* w_out, int* shift_out, int* parity) {
  int q = 0, live = 0;
  for (int w = 0; w < k.n_words; ++w) {
    for (int s = 0; s < k.bits[w]; s += 8, ++q) {
      if (q == p) {
        *w_out = w;
        *shift_out = s;
        *parity = live & 1;
        return digit_live(var, w, s);
      }
      live += digit_live(var, w, s);
    }
  }
  *parity = live & 1;
  return false;
}

__device__ __forceinline__ unsigned long long shfl_or64(unsigned long long v) {
  for (int o = 16; o; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kPrepThreads)
    sort_prep_kernel(Keys k, long long n, unsigned long long* var,
                     int* __restrict__ buf0) {
  __shared__ unsigned long long s_or[kMaxWords][2][kPrepThreads / 32];
  unsigned long long o[kMaxWords], no[kMaxWords];
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) o[w] = no[w] = 0;
  const long long stride = (long long)gridDim.x * kPrepThreads;
  for (long long i = (long long)blockIdx.x * kPrepThreads + threadIdx.x;
       i < n; i += stride) {
    buf0[i] = static_cast<int>(i);
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      if (w < k.n_words) {
        const unsigned long long x = key_word(k, w, i);
        const unsigned long long m =
            k.bits[w] == 64 ? ~0ull : 0xFFFFFFFFull;
        o[w] |= x;
        no[w] |= ~x & m;
      }
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    const unsigned long long a = shfl_or64(o[w]), b = shfl_or64(no[w]);
    if (lane == 0) {
      s_or[w][0][warp] = a;
      s_or[w][1][warp] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kMaxWords) {
    const int w = threadIdx.x >> 1, which = threadIdx.x & 1;
    if (w < k.n_words) {
      unsigned long long acc = 0;
      for (int i = 0; i < kPrepThreads / 32; ++i) acc |= s_or[w][which][i];
      if (acc) atomicOr(var + 2 * w + which, acc);
    }
  }
}

// The warp's digits for its sub-tile of the block's tile, -1 past n, and
// the payload each came with.
__device__ __forceinline__ void load_digits(const Keys& k, int w, int shift,
                                            long long n,
                                            const int* __restrict__ src,
                                            int (&digit)[kRounds],
                                            int (&idx)[kRounds]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base =
      (long long)blockIdx.x * kTile + (long long)warp * kWarpTile + lane;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * 32;
    digit[r] = -1;
    idx[r] = 0;
    if (i < n) {
      idx[r] = src[i];
      digit[r] = static_cast<int>((key_word(k, w, idx[r]) >> shift) & 0xFF);
    }
  }
}

// s_cnt[warp][d] = how many of the warp's keys have digit d. Each round's
// leaders hold distinct digits, so they never write the same cell.
__device__ __forceinline__ void count_digits(const int (&digit)[kRounds],
                                             int (*s_cnt)[kBins]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads)
    (&s_cnt[0][0])[i] = 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const unsigned peers = __match_any_sync(0xffffffffu, digit[r]);
    if (digit[r] >= 0 && lane == __ffs(peers) - 1)
      s_cnt[warp][digit[r]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    sort_hist_kernel(Keys k, long long n, const unsigned long long* var,
                     int pass, const int* buf0, const int* buf1,
                     int* __restrict__ counts) {
  int w, shift, parity;
  if (!pass_info(k, var, pass, &w, &shift, &parity)) return;
  __shared__ int s_cnt[kWarps][kBins];
  int digit[kRounds], idx[kRounds];
  load_digits(k, w, shift, n, parity ? buf1 : buf0, digit, idx);
  count_digits(digit, s_cnt);
  const int d = threadIdx.x;  // kThreads == kBins
  int total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += s_cnt[i][d];
  counts[(long long)d * gridDim.x + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    sort_scatter_kernel(Keys k, long long n, const unsigned long long* var,
                        int pass, int* buf0, int* buf1,
                        const int* __restrict__ counts) {
  int w, shift, parity;
  if (!pass_info(k, var, pass, &w, &shift, &parity)) return;
  __shared__ int s_cnt[kWarps][kBins];
  __shared__ int s_warp_sum[kWarps];
  const int* src = parity ? buf1 : buf0;
  int* dst = parity ? buf0 : buf1;
  int digit[kRounds], idx[kRounds];
  load_digits(k, w, shift, n, src, digit, idx);
  count_digits(digit, s_cnt);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // offsets: digits below d anywhere, then digit d in earlier blocks
  const int d = threadIdx.x;
  const int nb = gridDim.x;
  int total = 0, before = 0;
  const int* row = counts + (long long)d * nb;
  for (int b = 0; b < nb; ++b) {
    const int c = row[b];
    total += c;
    if (b < (int)blockIdx.x) before += c;
  }
  // exclusive scan of the digit totals over the block's 256 threads
  int incl = total;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_warp_sum[warp] = incl;
  __syncthreads();
  int warp_base = 0;
  for (int i = 0; i < warp; ++i) warp_base += s_warp_sum[i];
  int off = warp_base + incl - total + before;
  // per-(warp, digit) start: the block's offset, then earlier warps
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int c = s_cnt[i][d];
    s_cnt[i][d] = off;
    off += c;
  }
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const unsigned peers = __match_any_sync(0xffffffffu, digit[r]);
    if (digit[r] >= 0)
      dst[s_cnt[warp][digit[r]] + __popc(peers & lt)] = idx[r];
    __syncwarp();
    if (digit[r] >= 0 && lane == __ffs(peers) - 1)
      s_cnt[warp][digit[r]] += __popc(peers);
    __syncwarp();
  }
}

__global__ void sort_finish_kernel(Keys k, long long n, long long N,
                                   const unsigned long long* var,
                                   int n_passes, const int* buf0,
                                   const int* buf1, int* __restrict__ out,
                                   int* passes_out) {
  int w, shift, parity;
  pass_info(k, var, n_passes, &w, &shift, &parity);
  const int* src = parity ? buf1 : buf0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < N; i += stride)
    out[i] = i < n ? src[i] : static_cast<int>(i);
  if (passes_out && blockIdx.x == 0 && threadIdx.x == 0) {
    int live = 0;
    for (int ww = 0; ww < k.n_words; ++ww)
      for (int s = 0; s < k.bits[ww]; s += 8) live += digit_live(var, ww, s);
    *passes_out = live;
  }
}

}  // namespace

// K6. words: n_words (<= 4) device pointers to (N,) keys, LEAST significant
// first, each bits[i] = 32 or 64 wide (read unsigned); var: 2 * n_words
// u64 of zeroes (the digit-variation masks; left filled); buf0, buf1: (N,)
// int32 scratch; counts: 256 * ceil(n / 2048) int32 scratch; out: (N,)
// int32, the permutation; passes_out: one int32 for the number of live
// digit passes, or null. Returns the first CUDA error, 0 when all
// launched; *launches gets the number of kernels launched.
extern "C" int radix_sort_launch(const void* const* words, const int* bits,
                                 int n_words, long long n, long long N,
                                 void* var, void* buf0, void* buf1,
                                 void* counts, void* out, void* passes_out,
                                 int* launches, void* stream) {
  *launches = 0;
  if (n_words < 1 || n_words > kMaxWords || n < 0 || N < n ||
      N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Keys k;
  int n_passes = 0;
  for (int i = 0; i < kMaxWords; ++i) {
    k.word[i] = i < n_words ? words[i] : nullptr;
    k.bits[i] = i < n_words ? bits[i] : 0;
    if (i < n_words) {
      if (bits[i] != 32 && bits[i] != 64) return (int)cudaErrorInvalidValue;
      n_passes += bits[i] / 8;
    }
  }
  k.n_words = n_words;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* v = static_cast<unsigned long long*>(var);
  int* b0 = static_cast<int*>(buf0);
  int* b1 = static_cast<int*>(buf1);
  cudaError_t err;
  if (n > 0) {
    long long blocks = (n + kPrepThreads * 8 - 1) / (kPrepThreads * 8);
    sort_prep_kernel<<<(unsigned)blocks, kPrepThreads, 0, st>>>(k, n, v, b0);
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const unsigned nb = (unsigned)((n + kTile - 1) / kTile);
    for (int p = 0; p < n_passes; ++p) {
      sort_hist_kernel<<<nb, kThreads, 0, st>>>(k, n, v, p, b0, b1,
                                                static_cast<int*>(counts));
      ++*launches;
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      sort_scatter_kernel<<<nb, kThreads, 0, st>>>(
          k, n, v, p, b0, b1, static_cast<const int*>(counts));
      ++*launches;
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  if (N > 0) {
    long long blocks = (N + 255) / 256;
    if (blocks > 1024) blocks = 1024;
    sort_finish_kernel<<<(unsigned)blocks, 256, 0, st>>>(
        k, n, N, v, n_passes, b0, b1, static_cast<int*>(out),
        static_cast<int*>(passes_out));
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
