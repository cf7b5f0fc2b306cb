// K10 and K11: the WordPiece greedy longest match and the WordLevel lookup,
// for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// complexity_tokenizer_tpu_torch/utils/cuda_build.py; no PyTorch headers.
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() of its launch.
//
// Both read word rows of codepoints, chars [B, W] int32 (-1 pads, W <= 128)
// with lens [B] int32, and a CHD table keyed on two 32-bit polynomial
// hashes of a string (disp [n_buckets], rows [size] of (h1, h2, slot, -)),
// whose slot indexes token_chars [S, Lt], token_lens [S] and emit_ids [S]
// (ops/wordpiece_device.py).  The hashes are the JAX package's, bit for bit
// (_poly_hash_np: h = h * base + (c + 1) in uint32, with two bases).
//
// K10 replaces rolling_prefix_hashes + WordPieceDevice._fn
// (complexity_tokenizer_tpu/ops/wordpiece_device.py) and gives bit for bit
// its plain twin wordpiece_match_plain: out [B, W] (each match's id at its
// start column, -1 elsewhere), count [B] and poison [B].  One warp a word:
// - the word's prefix hashes P1, P2 [W + 1] by a warp scan of the affine
//   steps (x -> x * base + u) over chunks of 32, into shared memory;
// - a step probes every candidate length l = 1..min(Lt, W) at once, a lane
//   each (four lengths a lane for 128): the key of chars[start, start + l)
//   is P[start + l] - P[start] * base^l, plus seed * base^l past the
//   word's first position (the "##" form); all displacement reads go out
//   before any row read;
// - the longest hit is the highest set bit of the hits' ballots; the exact
//   check of its slot's characters against the word is a warp vote; a
//   failure poisons the word (no emit, advance one) and the host
//   re-tokenizes it; a miss emits UNK (if present) and advances one;
// - the steps of a word are its tokens; a word over max_input is one UNK at
//   column 0, or nothing without UNK.
//
// K11 replaces WordLevelDevice._fn (the same file) and gives bit for bit
// wordlevel_lookup_plain: out [B] int32 (the word's id, UNK on a miss, -1
// for an empty word).  One warp a word: the whole-row hash (a -1 entry is
// skipped) by the same scan, one probe, the exact check by a warp vote.
//
// Bound: latency.  The bytes are each word's live characters in (4 B each;
// the rows are padded to 128 lanes, the padding is not needed), the ids
// out (K10: the dense [B, W] row) and the table entries the probes touch
// (4 B of displacement, 16 B of row), all in L2 after the first touch; each step of a word waits on two
// dependent reads (displacement, row), then the check's read of the slot's
// characters.  Four warps (four words) a block; a batch of tens of
// thousands of words keeps every SM full.  On an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py), the benchmark corpus's 44,975 distinct words:
// K10 0.089 ms at 30,522 entries, K11 0.022 ms at 40,001; their shares of
// the bound are in PERF.md, section 6.

#include <cstdint>
#include <cuda_runtime.h>

#include "chd_hash.cuh"

namespace {

constexpr uint32_t kB1 = 0x01000193u;
constexpr uint32_t kB2 = 0x0BADC0DFu;
constexpr uint32_t kSeed1 = 0x9E3779B9u;
constexpr uint32_t kSeed2 = 0x7F4A7C15u;
constexpr int32_t kInfRank = 0x3FFFFFFF;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kMaxW = 128;         // lanes a word row
constexpr int kChunks = kMaxW / 32;
constexpr int kWpWarps = 4;        // words a block

struct Tables {
  const int32_t* __restrict__ disp;
  const int4* __restrict__ rows;
  uint32_t size_mask;
  uint32_t bucket_mask;
  const int32_t* __restrict__ token_chars;  // [S, Lt]
  const int32_t* __restrict__ token_lens;   // [S]
  const int32_t* __restrict__ emit_ids;     // [S]
  int Lt;
  int32_t unk;  // -1: no UNK
};

__device__ __forceinline__ int32_t disp_of(const Tables& t, uint32_t a, uint32_t b) {
  return __ldg(t.disp + (mix_hash(a, b) & t.bucket_mask));
}

// The slot of the key (a, b) given its displacement d, or kInfRank.
__device__ __forceinline__ int32_t slot_of(const Tables& t, uint32_t a, uint32_t b, int32_t d) {
  const int4 r = __ldg(t.rows + ((mix_hash2(a, b) + (uint32_t)d) & t.size_mask));
  return r.x == (int32_t)a && r.y == (int32_t)b ? r.z : kInfRank;
}

// base^e mod 2^32
__device__ __forceinline__ uint32_t ipow(uint32_t base, int e) {
  uint32_t r = 1;
  while (e) {
    if (e & 1) r *= base;
    base *= base;
    e >>= 1;
  }
  return r;
}

// Inclusive warp scan of the affine maps x -> x * m + v (in lane order):
// on return lane j holds the composition of lanes 0..j.
__device__ __forceinline__ void affine_scan(uint32_t& m, uint32_t& v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t pm = __shfl_up_sync(kFull, m, o);
    const uint32_t pv = __shfl_up_sync(kFull, v, o);
    if (lane >= o) {
      v = pv * m + v;
      m = pm * m;
    }
  }
}

// ---------------------------------------------------------------------------
// K10

__global__ void __launch_bounds__(kWpWarps * 32)
wordpiece_kernel(const int32_t* __restrict__ chars, const int32_t* __restrict__ lens,
                 Tables tb, int32_t max_input, int32_t* __restrict__ out,
                 int32_t* __restrict__ count, bool* __restrict__ poison, int B, int W) {
  __shared__ uint32_t pow1[kMaxW + 1], pow2[kMaxW + 1];
  __shared__ int32_t s_chars[kWpWarps][kMaxW];
  __shared__ int32_t s_out[kWpWarps][kMaxW];
  __shared__ uint32_t s_p1[kWpWarps][kMaxW + 1], s_p2[kWpWarps][kMaxW + 1];
  for (int i = threadIdx.x; i <= W; i += blockDim.x) {
    pow1[i] = ipow(kB1, i);
    pow2[i] = ipow(kB2, i);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWpWarps + warp;
  if (row >= B) return;
  int32_t* cs = s_chars[warp];
  int32_t* os = s_out[warp];
  uint32_t* P1 = s_p1[warp];
  uint32_t* P2 = s_p2[warp];
  const int32_t* rc = chars + row * W;
  const int len = __ldg(lens + row);
  // the prefix hashes of the whole row, a chunk of 32 lanes at a time
  uint32_t c1 = 0, c2 = 0;  // P[32 k], the carry into chunk k
  if (lane == 0) {
    P1[0] = 0;
    P2[0] = 0;
  }
  for (int i0 = 0; i0 < W; i0 += 32) {
    const int i = i0 + lane;
    const int32_t c = i < W ? __ldg(rc + i) : -1;
    if (i < W) {
      cs[i] = c;
      os[i] = -1;
    }
    const uint32_t u = c >= 0 ? (uint32_t)c + 1u : 0u;
    uint32_t m1 = i < W ? kB1 : 1u, v1 = i < W ? u : 0u;
    uint32_t m2 = i < W ? kB2 : 1u, v2 = v1;
    affine_scan(m1, v1, lane);
    affine_scan(m2, v2, lane);
    const uint32_t p1 = c1 * m1 + v1, p2 = c2 * m2 + v2;
    if (i < W) {
      P1[i + 1] = p1;
      P2[i + 1] = p2;
    }
    c1 = __shfl_sync(kFull, p1, 31);
    c2 = __shfl_sync(kFull, p2, 31);
  }
  __syncwarp();
  const int maxlen = min(tb.Lt, W);
  bool poisoned = false;
  int start = 0;
  if (len <= max_input) {
    while (start < len) {
      // every candidate length at once: displacement reads, then row reads
      const int sc = min(max(start, 0), W);
      uint32_t a[kChunks], b[kChunks];
      bool live[kChunks];
      int32_t d[kChunks], slot[kChunks];
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int l = 32 * k + lane + 1;
        live[k] = l <= maxlen && start + l <= len;
        a[k] = b[k] = 0;
        if (live[k]) {
          const int ec = min(start + l, W);
          a[k] = P1[ec] - P1[sc] * pow1[l];
          b[k] = P2[ec] - P2[sc] * pow2[l];
          if (start > 0) {
            a[k] += kSeed1 * pow1[l];
            b[k] += kSeed2 * pow2[l];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kChunks; ++k) d[k] = live[k] ? disp_of(tb, a[k], b[k]) : 0;
#pragma unroll
      for (int k = 0; k < kChunks; ++k) slot[k] = live[k] ? slot_of(tb, a[k], b[k], d[k]) : kInfRank;
      // the longest hit
      int best_l = 0;
      int32_t best = kInfRank;
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const uint32_t hits = __ballot_sync(kFull, slot[k] != kInfRank);
        if (hits) {
          const int src = 31 - __clz(hits);
          best_l = 32 * k + src + 1;
          best = __shfl_sync(kFull, slot[k], src);
        }
      }
      bool good = false;
      if (best_l > 0) {
        // the exact check of the slot's characters (hash collisions)
        const int32_t* tc = tb.token_chars + (int64_t)best * tb.Lt;
        bool ok = true;
        for (int j = lane; j < best_l; j += 32)
          ok &= __ldg(tc + j) == cs[min(max(start + j, 0), W - 1)];
        good = __all_sync(kFull, ok) && __ldg(tb.token_lens + best) == best_l;
        poisoned |= !good;
      }
      if (lane == 0 && start < W) {
        if (good) os[start] = __ldg(tb.emit_ids + best);
        else if (best_l == 0 && tb.unk >= 0) os[start] = tb.unk;
      }
      start += good ? best_l : 1;
    }
  } else if (lane == 0 && tb.unk >= 0) {
    os[0] = tb.unk;  // over the limit: one UNK
  }
  __syncwarp();
  int n = 0;
  for (int i = lane; i < W; i += 32) {
    const int32_t v = os[i];
    out[row * W + i] = v;
    n += v >= 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(kFull, n, o);
  if (lane == 0) {
    count[row] = n;
    poison[row] = poisoned;
  }
}

// ---------------------------------------------------------------------------
// K11

__global__ void __launch_bounds__(kWpWarps * 32)
wordlevel_kernel(const int32_t* __restrict__ chars, const int32_t* __restrict__ lens,
                 Tables tb, int32_t* __restrict__ out, int B, int W) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWpWarps + warp;
  if (row >= B) return;
  const int32_t* rc = chars + row * W;
  const int len = __ldg(lens + row);
  // the whole row's hashes: a -1 entry is skipped (the identity step)
  uint32_t h1 = 0, h2 = 0;
  int32_t c[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int i = 32 * k + lane;
    c[k] = i < W ? __ldg(rc + i) : -1;
    const bool on = c[k] >= 0;
    uint32_t m1 = on ? kB1 : 1u, v1 = on ? (uint32_t)c[k] + 1u : 0u;
    uint32_t m2 = on ? kB2 : 1u, v2 = v1;
    affine_scan(m1, v1, lane);
    affine_scan(m2, v2, lane);
    h1 = h1 * __shfl_sync(kFull, m1, 31) + __shfl_sync(kFull, v1, 31);
    h2 = h2 * __shfl_sync(kFull, m2, 31) + __shfl_sync(kFull, v2, 31);
  }
  if (len <= 0) {
    if (lane == 0) out[row] = -1;
    return;
  }
  const int32_t slot = slot_of(tb, h1, h2, disp_of(tb, h1, h2));
  bool ok = slot != kInfRank && len <= tb.Lt;
  if (ok) {
    ok = __ldg(tb.token_lens + slot) == len;
    const int32_t* tc = tb.token_chars + (int64_t)slot * tb.Lt;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int j = 32 * k + lane;
      if (j < len) ok &= __ldg(tc + j) == c[k];
    }
  }
  ok = __all_sync(kFull, ok);
  if (lane == 0) out[row] = ok ? __ldg(tb.emit_ids + slot) : tb.unk;
}

Tables make_tables(const void* disp, const void* rows, unsigned size_mask, unsigned bucket_mask,
                   const void* token_chars, const void* token_lens, const void* emit_ids, int Lt,
                   int unk) {
  return Tables{static_cast<const int32_t*>(disp), static_cast<const int4*>(rows),
                (uint32_t)size_mask, (uint32_t)bucket_mask,
                static_cast<const int32_t*>(token_chars), static_cast<const int32_t*>(token_lens),
                static_cast<const int32_t*>(emit_ids), Lt, (int32_t)unk};
}

}  // namespace

extern "C" {

// K10: chars [B, W] int32 (W <= 128), lens [B] int32, the CHD table (rows
// 16-byte aligned) and the slot tables -> out [B, W] int32, count [B]
// int32, poison [B] bool
int ctok_wordpiece_match(const void* chars, const void* lens, const void* disp,
                         const void* rows, unsigned size_mask, unsigned bucket_mask,
                         const void* token_chars, const void* token_lens,
                         const void* emit_ids, int Lt, int unk, int max_input, void* out,
                         void* count, void* poison, int B, int W, void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaSuccess;
  if (W > kMaxW || Lt <= 0) return (int)cudaErrorInvalidValue;
  const Tables tb = make_tables(disp, rows, size_mask, bucket_mask, token_chars, token_lens,
                                emit_ids, Lt, unk);
  const int blocks = (B + kWpWarps - 1) / kWpWarps;
  wordpiece_kernel<<<blocks, kWpWarps * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(chars), static_cast<const int32_t*>(lens), tb, max_input,
      static_cast<int32_t*>(out), static_cast<int32_t*>(count), static_cast<bool*>(poison), B,
      W);
  return (int)cudaGetLastError();
}

// K11: chars [B, W] int32 (W <= 128), lens [B] int32, the tables -> out [B]
// int32
int ctok_wordlevel_lookup(const void* chars, const void* lens, const void* disp,
                          const void* rows, unsigned size_mask, unsigned bucket_mask,
                          const void* token_chars, const void* token_lens,
                          const void* emit_ids, int Lt, int unk, void* out, int B, int W,
                          void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (W > kMaxW || W < 0 || Lt <= 0) return (int)cudaErrorInvalidValue;
  const Tables tb = make_tables(disp, rows, size_mask, bucket_mask, token_chars, token_lens,
                                emit_ids, Lt, unk);
  const int blocks = (B + kWpWarps - 1) / kWpWarps;
  wordlevel_kernel<<<blocks, kWpWarps * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(chars), static_cast<const int32_t*>(lens), tb,
      static_cast<int32_t*>(out), B, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
