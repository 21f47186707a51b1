// K6: a stable LSD radix sort of multi-word unsigned keys for Hopper
// (sm_90a), returning the int32 permutation that sorts them.
//
// Replaces the trace sort of the JAX package's fused route, which XLA runs
// as jnp.lexsort: the trace-major, time-minor layout sort of
// odigos_tpu/serving/fused.py _sorted_trace_layout (:429-459; keys
// trace_id_hi, trace_id_lo, start_unix_nano). (The reference's other
// lexsort, under the parent self-join of odigos_tpu/features/featurizer.py
// featurize_join_jax, has no sort in the port: K5 joins by a hash table.)
// The reference splits
// each u64 into u32 halves because it serves without x64; this kernel
// keeps whole u64 words (PyTorch int64 tensors read as unsigned).
//
// Contract: keys are up to four words, each 32 or 64 bits, least
// significant first; the first n of N rows are sorted, stably (tied keys
// keep their order), and rows n..N-1 (padding) keep the identity: out[j]
// = j. That is what the reference's is_pad-primary lexsort gives.
//
// Design: ONE cooperative launch a sort (cudaLaunchCooperativeKernel, every
// block resident), its phases separated by grid-wide barriers:
//   prep     the identity for the padding rows; per block, the OR of its
//            keys and the OR of their complements, word by word; after a
//            barrier every block folds all blocks' ORs and lists the live
//            8-bit digits (a digit whose bits are equal in every key needs
//            no pass: start_hi's top bytes, frame in a one-frame group, the
//            upper bytes of small frame ordinals). A dead digit costs
//            nothing: it is not in the list. No live digit: the identity.
//   per live digit, two barriers:
//     hist    each block counts the digits of its own contiguous run of
//             1024-key tiles (8 warps x 4 rounds of 32 lanes, warp leaders
//             of __match_any_sync groups adding popcounts into per-warp
//             shared counters), into counts[block][digit];
//     scatter each block takes its offsets from counts (the keys of smaller
//             digits anywhere, then the same digit in earlier blocks) and
//             walks its tiles in order, writing every key at its stable
//             rank: within a tile by lane, round and warp (__match_any_sync
//             + popc, per-(warp, digit) starts in shared memory), across
//             tiles by a per-digit running offset.
//   The first pass reads the identity without storing it; the last pass
//   writes straight into the output; the passes between ping-pong two
//   scratch buffers.
// Any N below 2^31 is taken: a block loops over as many tiles as its share
// needs (the grid is at most the blocks that fit on the card at once). A
// block that owns one tile (every block, up to N = 1024 x the grid) keeps
// its digits, payload and match masks in registers and its per-warp counts
// in shared memory from hist to scatter: one gather and one round of
// __match_any_sync a pass. A global atomicAdd scatter would not be stable;
// ranking by lane, round, warp, tile and block order is. Nothing is
// synchronised with the host: the digit list lives on the card.
//
// Bound on the card: bytes. The keys are read once and the permutation
// written once (at N = 65536 spans the trace sort's three u64 words and
// the int32 payload: 1.8 MB, 0.5 us at 3.35 TB/s), but each live pass
// gathers its digit through the current payload and writes the payload
// anew, and each pass waits at two grid barriers: at the route's sizes (4
// to 128 blocks) the barriers and each block's serial latency bound it,
// no longer the launches. Tiles of 1024 keys (not 2048 or 512) measured
// fastest over N = 4096..131072: smaller tiles shorten a block's serial
// work, more blocks lengthen the barriers and the offset scans.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWords = 4;
constexpr int kMaxPasses = kMaxWords * 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;
constexpr int kWarpTile = kRounds * 32;
constexpr int kTile = kWarps * kWarpTile;  // keys per tile
constexpr int kBins = 256;
constexpr int kOrSlots = 2 * kMaxWords;  // per block: OR, complement-OR
constexpr int kScanBatch = 16;  // blocks' counts loaded at once a batch

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

__device__ __forceinline__ unsigned long long shfl_or64(unsigned long long v) {
  for (int o = 16; o; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Tile t's digits for this warp's sub-tile, -1 past n, and the payload
// each came with (the identity when src is null).
__device__ __forceinline__ void load_digits(const Keys& k, int w, int shift,
                                            long long n, long long t,
                                            const int* __restrict__ src,
                                            int (&digit)[kRounds],
                                            int (&idx)[kRounds]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = t * kTile + (long long)warp * kWarpTile + lane;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * 32;
    digit[r] = -1;
    idx[r] = 0;
    if (i < n) {
      idx[r] = src ? src[i] : static_cast<int>(i);
      digit[r] = static_cast<int>((key_word(k, w, idx[r]) >> shift) & 0xFF);
    }
  }
}

// s_cnt[warp][d] += how many of the warp's keys have digit d; peers[r]
// keeps round r's __match_any_sync mask for the scatter. Each round's
// leaders hold distinct digits, so they never write the same cell.
__device__ __forceinline__ void count_digits(const int (&digit)[kRounds],
                                             unsigned (&peers)[kRounds],
                                             int (*s_cnt)[kBins]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    peers[r] = __match_any_sync(0xffffffffu, digit[r]);
    if (digit[r] >= 0 && lane == __ffs(peers[r]) - 1)
      s_cnt[warp][digit[r]] += __popc(peers[r]);
    __syncwarp();
  }
}

__device__ __forceinline__ void zero_counts(int (*s_cnt)[kBins]) {
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads)
    (&s_cnt[0][0])[i] = 0;
}

// counts: kBins x gridDim.x int32, laid out [block][digit]; ors:
// kOrSlots x gridDim.x u64; buf0, buf1: (n,) int32 scratch; out: (N,).
// The block owns tiles [blockIdx.x * tpb, (blockIdx.x + 1) * tpb).
__global__ void __launch_bounds__(kThreads, 2)
    radix_sort_kernel(Keys k, long long n, long long N, long long tpb,
                      unsigned long long* __restrict__ ors,
                      int* __restrict__ counts, int* buf0, int* buf1,
                      int* out, int* passes_out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_cnt[kWarps][kBins];
  __shared__ int s_off[kBins];
  __shared__ int s_warp_sum[kWarps];
  __shared__ unsigned long long s_or[kOrSlots][kWarps];
  __shared__ unsigned long long s_var[kMaxWords];
  __shared__ unsigned char s_pass[kMaxPasses][2];  // word, shift
  __shared__ int s_live;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = gridDim.x;
  const long long gstride = (long long)nb * kThreads;
  const long long gtid = (long long)blockIdx.x * kThreads + threadIdx.x;

  // ---- prep: padding rows, and this block's ORs over a grid stride
  for (long long i = n + gtid; i < N; i += gstride) out[i] = (int)i;
  {
    unsigned long long o[kMaxWords], no[kMaxWords];
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) o[w] = no[w] = 0;
    for (long long i = gtid; i < n; i += gstride) {
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
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      const unsigned long long a = shfl_or64(o[w]), b = shfl_or64(no[w]);
      if (lane == 0) {
        s_or[2 * w][warp] = a;
        s_or[2 * w + 1][warp] = b;
      }
    }
    __syncthreads();
    if (threadIdx.x < kOrSlots) {
      unsigned long long acc = 0;
      for (int i = 0; i < kWarps; ++i) acc |= s_or[threadIdx.x][i];
      ors[(long long)blockIdx.x * kOrSlots + threadIdx.x] = acc;
    }
  }
  grid.sync();
  // every block folds the ORs and lists the live digits, least
  // significant first
  if (threadIdx.x < kMaxWords) {
    const int w = threadIdx.x;
    unsigned long long a = 0, b = 0;
    if (w < k.n_words)
      for (int i = 0; i < nb; ++i) {
        a |= ors[(long long)i * kOrSlots + 2 * w];
        b |= ors[(long long)i * kOrSlots + 2 * w + 1];
      }
    s_var[w] = a & b;  // bits that differ between two keys
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int live = 0;
    for (int w = 0; w < k.n_words; ++w)
      for (int s = 0; s < k.bits[w]; s += 8)
        if ((s_var[w] >> s) & 0xFFull) {
          s_pass[live][0] = (unsigned char)w;
          s_pass[live][1] = (unsigned char)s;
          ++live;
        }
    s_live = live;
    if (passes_out && blockIdx.x == 0) *passes_out = live;
  }
  __syncthreads();
  const int live = s_live;
  if (live == 0) {  // every key equal (or n <= 1): the identity
    for (long long i = gtid; i < n; i += gstride) out[i] = (int)i;
    return;
  }

  const long long tiles = (n + kTile - 1) / kTile;
  const long long t0 = (long long)blockIdx.x * tpb;
  const long long t1 = t0 + tpb < tiles ? t0 + tpb : tiles;
  const bool one_tile = t1 - t0 == 1;
  const unsigned lt = (1u << lane) - 1u;
  int digit[kRounds], idx[kRounds];
  unsigned peers[kRounds];
  for (int p = 0; p < live; ++p) {
    const int w = s_pass[p][0], shift = s_pass[p][1];
    const int* src = p == 0 ? nullptr : ((p - 1) & 1 ? buf1 : buf0);
    int* dst = p == live - 1 ? out : (p & 1 ? buf1 : buf0);

    // ---- hist: this block's digit counts over its tiles
    zero_counts(s_cnt);
    __syncthreads();
    for (long long t = t0; t < t1; ++t) {
      load_digits(k, w, shift, n, t, src, digit, idx);
      count_digits(digit, peers, s_cnt);
    }
    __syncthreads();
    {
      const int d = threadIdx.x;  // kThreads == kBins
      int total = 0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) total += s_cnt[i][d];
      counts[(long long)blockIdx.x * kBins + d] = total;
    }
    grid.sync();

    // ---- offsets: digits below d anywhere, then d in earlier blocks
    {
      const int d = threadIdx.x;
      int total = 0, before = 0;
      for (int b0 = 0; b0 < nb; b0 += kScanBatch) {
        int c[kScanBatch];  // every load of a batch in flight at once
#pragma unroll
        for (int i = 0; i < kScanBatch; ++i)
          c[i] = b0 + i < nb ? counts[(long long)(b0 + i) * kBins + d] : 0;
#pragma unroll
        for (int i = 0; i < kScanBatch; ++i) {
          total += c[i];
          before += b0 + i < (int)blockIdx.x ? c[i] : 0;
        }
      }
      // exclusive scan of the digit totals over the block's 256 threads
      int incl = total;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane == 31) s_warp_sum[warp] = incl;
      __syncthreads();
      int warp_base = 0;
      for (int i = 0; i < warp; ++i) warp_base += s_warp_sum[i];
      s_off[d] = warp_base + incl - total + before;
    }

    // ---- scatter: the block's tiles in order, each key at its rank (a
    // block of one tile still holds its digits, masks and per-warp counts
    // from the hist)
    for (long long t = t0; t < t1; ++t) {
      if (!one_tile) {
        load_digits(k, w, shift, n, t, src, digit, idx);
        zero_counts(s_cnt);
        __syncthreads();
        count_digits(digit, peers, s_cnt);
        __syncthreads();
      }
      {  // per-(warp, digit) starts: the running offset, then earlier warps
        const int d = threadIdx.x;
        int off = s_off[d];
#pragma unroll
        for (int i = 0; i < kWarps; ++i) {
          const int c = s_cnt[i][d];
          s_cnt[i][d] = off;
          off += c;
        }
        s_off[d] = off;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        if (digit[r] >= 0)
          dst[s_cnt[warp][digit[r]] + __popc(peers[r] & lt)] = idx[r];
        __syncwarp();
        if (digit[r] >= 0 && lane == __ffs(peers[r]) - 1)
          s_cnt[warp][digit[r]] += __popc(peers[r]);
        __syncwarp();
      }
      __syncthreads();
    }
    if (p + 1 < live) grid.sync();
  }
}

}  // namespace

// The largest grid K6 launches on the current device: the blocks that fit
// on it at once (a cooperative launch needs every block resident), at
// most two an SM (each pass's offset scan reads one count per block).
extern "C" int radix_sort_max_grid(int* grid) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, radix_sort_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid = sms * (per_sm < 2 ? per_sm : 2);
  return (int)cudaSuccess;
}

// K6. words: n_words (<= 4) device pointers to (N,) keys, LEAST significant
// first, each bits[i] = 32 or 64 wide (read unsigned); grid blocks (at
// most radix_sort_max_grid's), each owning tpb consecutive tiles of 1024
// keys (grid * tpb * 1024 >= n); scratch: 2 * n + 256 * grid + 16 * grid
// int32 (8-byte aligned); out: (N,) int32, the permutation; passes_out:
// one int32 for the number of live digit passes, or null. One cooperative
// launch. Returns the CUDA error, 0 when launched.
extern "C" int radix_sort_launch(const void* const* words, const int* bits,
                                 int n_words, long long n, long long N,
                                 int grid, long long tpb, void* scratch,
                                 void* out, void* passes_out, void* stream) {
  if (n_words < 1 || n_words > kMaxWords || n < 0 || N < n ||
      N > 0x7fffffffLL || grid < 1 || tpb < 0 ||
      (long long)grid * tpb * kTile < n)
    return (int)cudaErrorInvalidValue;
  Keys k;
  for (int i = 0; i < kMaxWords; ++i) {
    k.word[i] = i < n_words ? words[i] : nullptr;
    k.bits[i] = i < n_words ? bits[i] : 0;
    if (i < n_words && bits[i] != 32 && bits[i] != 64)
      return (int)cudaErrorInvalidValue;
  }
  k.n_words = n_words;
  if (N == 0) return (int)cudaSuccess;
  int* s = static_cast<int*>(scratch);
  unsigned long long* ors = reinterpret_cast<unsigned long long*>(s);
  int* counts = s + 2 * kOrSlots * (long long)grid;
  int* buf0 = counts + (long long)kBins * grid;
  int* buf1 = buf0 + n;
  int* o = static_cast<int*>(out);
  int* po = static_cast<int*>(passes_out);
  void* args[] = {&k, &n, &N, &tpb, &ors, &counts, &buf0, &buf1, &o, &po};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)radix_sort_kernel, dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
}
