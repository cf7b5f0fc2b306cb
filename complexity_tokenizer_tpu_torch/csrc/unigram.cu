// K12: the Unigram (SentencePiece) Viterbi segmentation, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// complexity_tokenizer_tpu_torch/utils/cuda_build.py; no PyTorch headers.
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch.
//
// K12 replaces make_viterbi_fn (complexity_tokenizer_tpu/ops/unigram_device.py),
// which JAX runs as a lax.scan over end positions, and gives bit for bit
// viterbi_ragged_plain (ops/unigram_device.py) on the same texts: chars [N]
// int32, the codepoints of all texts end to end, offs [B + 1] int32 and lens
// [B] int32 -> one int32 buffer [N + 2B]: out [N] (each chosen piece's id at
// its start character, the fallback marker for a single-character fallback,
// -1 elsewhere), count [B] (the entries of out that are not -1) and poison
// [B] (1 when a decision fell inside the float32 margin or a chosen piece
// failed the exact check).
//
// The pieces: a CHD table keyed on a string's two 32-bit polynomial hashes
// (disp [n_buckets], rows [size] of (h1, h2, id, -)), piece_chars [V, Lt],
// piece_lens [V], piece_scores [V] float32; the hashes are the JAX
// package's, bit for bit (_poly_hash_np: h = h * base + (c + 1) in uint32).
//
// A warp takes a text (at most 128 characters):
// - its characters and prefix hashes P1, P2 [n + 1] (an affine scan of
//   x -> x * base + (c + 1)) into shared memory; the powers from
//   hash_powers;
// - the candidates (end e, length l <= min(maxcand, e)) do not depend on the
//   DP, so a chunk of up to kCand of them is scored first, a lane each: the
//   key of chars[e - l, e) is P[e] - P[e - l] * base^l, the CHD probe (the
//   displacement, then the row), then the piece's length and score; a hit of
//   another length scores nothing, a single character that is no piece
//   falls back (its score the fallback score);
// - then the DP steps over the chunk's ends read only shared memory: lane j
//   takes lengths j + 1, j + 33, ...; prev + score in float32 (__fadd_rn:
//   nothing is contracted); three warp reductions give the maximum, the
//   largest length that reaches it (ties to the smallest start, as the
//   reference) and the runner-up; a margin under 1e-4 * (1 + |best|)
//   (__fsub_rn, __fmul_rn) poisons the text;
// - every end's chosen piece is checked against the text's characters, a
//   lane an end; lane 0 backtracks and writes the ids.
//
// Bound: latency.  The bytes are each text's characters in (4 B each), its
// offset and length, the ids out (4 B a character, count and poison 4 B
// each) and the table entries the probes and checks touch (up to the CHD
// table, the lengths and scores, piece_chars), all in L2 after the first
// touch.  A chunk of candidates waits on three dependent reads
// (displacement, row, length and score), a DP step on one warp reduction.
// Times, the bound and the launch shape are in PERF.md, section 6.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "chd_hash.cuh"

namespace {

constexpr uint32_t kB1 = 0x01000193u;
constexpr uint32_t kB2 = 0x0BADC0DFu;
constexpr int32_t kInfRank = 0x3FFFFFFF;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kMaxW = 128;          // characters a text
constexpr int kPowLen = kMaxW + 1;  // a row of the powers table
constexpr int kVitWarps = 4;        // warps (texts) a block
constexpr int kCand = 512;          // candidates a warp scores before the DP steps over them
constexpr int kLaneLens = kMaxW / 32;  // candidate lengths a lane takes at most
constexpr float kNeg = -1e30f;      // ops/unigram_device.py's _NEG
constexpr float kHalfNeg = kNeg * 0.5f;
constexpr float kEps = 1e-4f;
constexpr int32_t kFbTag = INT32_MIN;  // a candidate that is the fallback

struct Pieces {
  const int32_t* __restrict__ disp;
  const int4* __restrict__ rows;
  uint32_t size_mask;
  uint32_t bucket_mask;
  const int32_t* __restrict__ chars;   // [V, Lt]
  const int32_t* __restrict__ lens;    // [V]
  const float* __restrict__ scores;    // [V]
  int Lt;
};

// A warp's text
struct TextSpace {
  uint32_t P1[kPowLen];
  uint32_t P2[kPowLen];
  float best[kPowLen];   // the DP's best total at each end
  int32_t text[kMaxW];   // the characters
  int32_t tid[kMaxW];    // end e's chosen id (at e - 1): -1 none
  int32_t len[kMaxW];    // its length: -1 a fallback, 0 none
  float csc[kCand];      // a chunk's candidates: score
  int32_t ctid[kCand];   // and id (kFbTag: the fallback)
};

// Inclusive scan of the affine maps x -> x * m + v over the warp's lanes (in
// lane order): on return lane j holds the composition of lanes 0..j.
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__global__ void __launch_bounds__(kVitWarps * 32)
viterbi_kernel(const int32_t* __restrict__ chars, const int32_t* __restrict__ offs,
               const int32_t* __restrict__ lens, int B, Pieces pc,
               const uint32_t* __restrict__ pows, float fb, int maxcand, int32_t fb_id,
               int32_t* __restrict__ out, int32_t* __restrict__ count,
               int32_t* __restrict__ poison) {
  __shared__ TextSpace s_text[kVitWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kVitWarps + warp;
  if (t >= B) return;  // the whole warp
  TextSpace& ws = s_text[warp];
  const int off = __ldg(offs + t);
  const int slots = __ldg(offs + t + 1) - off;
  const int n = max(0, min(min(__ldg(lens + t), slots), kMaxW));
  // -1 in every slot; lane 0 writes the ids after the __syncwarp below
  for (int i = lane; i < slots; i += 32) out[off + i] = -1;

  // 1. the characters and the prefix hashes, 32 at a time
  if (lane == 0) {
    ws.P1[0] = 0;
    ws.P2[0] = 0;
    ws.best[0] = 0.0f;
  }
  uint32_t c1 = 0, c2 = 0;  // P[i0], the carry into the chunk
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const bool in = i < n;
    const int32_t c = in ? __ldg(chars + off + i) : -1;
    if (in) ws.text[i] = c;
    uint32_t m1 = in ? kB1 : 1u, v1 = in && c >= 0 ? (uint32_t)c + 1u : 0u;
    uint32_t m2 = in ? kB2 : 1u, v2 = v1;
    affine_scan(m1, v1, lane);
    affine_scan(m2, v2, lane);
    const uint32_t p1 = c1 * m1 + v1, p2 = c2 * m2 + v2;
    if (in) {
      ws.P1[i + 1] = p1;
      ws.P2[i + 1] = p2;
    }
    c1 = __shfl_sync(kFull, p1, 31);
    c2 = __shfl_sync(kFull, p2, 31);
  }
  __syncwarp();

  const int Lc = min(maxcand, kMaxW);      // candidate lengths 1..Lc
  const int per = max(1, kCand / Lc);      // ends a chunk
  bool amb = false;
  for (int e0 = 1; e0 <= n; e0 += per) {
    const int e1 = min(n, e0 + per - 1);
    const int ncand = (e1 - e0 + 1) * Lc;
    // 2. score the chunk's candidates, a lane each
    for (int i = lane; i < ncand; i += 32) {
      const int e = e0 + i / Lc, l = i % Lc + 1;
      float sc = kNeg;
      int32_t id = -1;
      if (l <= e) {
        const uint32_t a = ws.P1[e] - ws.P1[e - l] * __ldg(pows + l);
        const uint32_t b = ws.P2[e] - ws.P2[e - l] * __ldg(pows + kPowLen + l);
        const int32_t d = __ldg(pc.disp + (mix_hash(a, b) & pc.bucket_mask));
        const int4 r = __ldg(pc.rows + ((mix_hash2(a, b) + (uint32_t)d) & pc.size_mask));
        if (r.x == (int32_t)a && r.y == (int32_t)b && r.z != kInfRank) {
          id = r.z;
          // a hash hit of another length scores nothing and is no fallback
          if (__ldg(pc.lens + id) == l) sc = __ldg(pc.scores + id);
        } else if (l == 1) {
          id = kFbTag;
          sc = fb;
        }
      }
      ws.csc[i] = sc;
      ws.ctid[i] = id;
    }
    __syncwarp();
    // 3. the DP over the chunk's ends
    for (int e = e0; e <= e1; ++e) {
      const int base = (e - e0) * Lc;
      float tot[kLaneLens];
      float m = -CUDART_INF_F;
#pragma unroll
      for (int r = 0; r < kLaneLens; ++r) {
        const int l = lane + 1 + 32 * r;
        tot[r] = -CUDART_INF_F;  // no candidate
        if (l <= Lc) {
          const float sc = ws.csc[base + l - 1];
          tot[r] = l <= e && sc > kHalfNeg ? __fadd_rn(ws.best[e - l], sc) : kNeg;
          m = fmaxf(m, tot[r]);
        }
      }
      m = warp_max(m);
      int k = 0;  // the largest length reaching the maximum
#pragma unroll
      for (int r = 0; r < kLaneLens; ++r) {
        const int l = lane + 1 + 32 * r;
        if (l <= Lc && tot[r] == m) k = l;
      }
      k = warp_max(k);
      float runner = -CUDART_INF_F;
#pragma unroll
      for (int r = 0; r < kLaneLens; ++r) {
        const int l = lane + 1 + 32 * r;
        if (l <= Lc && l != k) runner = fmaxf(runner, tot[r]);
      }
      // the chosen lane counts as -1e30 among the others, as in the plain version
      runner = fmaxf(warp_max(runner), kNeg);
      const bool valid = m > kHalfNeg;
      if (valid && runner > kHalfNeg &&
          __fsub_rn(m, runner) < __fmul_rn(kEps, __fadd_rn(1.0f, fabsf(m))))
        amb = true;
      if (lane == 0) {
        const int32_t ct = ws.ctid[base + k - 1];
        ws.best[e] = valid ? m : kNeg;
        ws.tid[e - 1] = valid ? (ct == kFbTag ? fb_id : ct) : -1;
        ws.len[e - 1] = valid ? (ct == kFbTag ? -1 : k) : 0;
      }
      __syncwarp();
    }
  }

  // 4. the exact check of every end's chosen piece, a lane an end
  bool bad = false;
  for (int e = lane + 1; e <= n; e += 32) {
    const int32_t id = ws.tid[e - 1];
    const int L = ws.len[e - 1];
    if (id >= 0 && L > 0) {
      const int32_t* pch = pc.chars + (int64_t)id * pc.Lt;
      for (int j = 0; j < L; ++j) bad |= __ldg(pch + j) != ws.text[e - L + j];
    }
  }
  const bool poisoned = __any_sync(kFull, bad) || amb;

  // 5. the backtrack: ids at their start positions
  if (lane == 0) {
    int pos = n, emitted = 0;
    while (pos > 0) {
      const int32_t id = ws.tid[pos - 1];
      const int L = ws.len[pos - 1];
      const int start = pos - (L < 0 ? 1 : max(L, 1));
      out[off + start] = id;
      emitted += id != -1;
      pos = start;
    }
    count[t] = emitted;
    poison[t] = poisoned ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// K12: chars [N] int32, offs [B + 1] int32, lens [B] int32, the CHD table
// (rows 16-byte aligned), the piece tables, the fallback score, the longest
// candidate (1..128), the fallback marker and the powers [4, 129] uint32 ->
// res [N + 2B] int32 (out, count, poison)
int ctok_viterbi(const void* chars, const void* offs, const void* lens, int B, const void* disp,
                 const void* rows, unsigned size_mask, unsigned bucket_mask,
                 const void* piece_chars, const void* piece_lens, const void* piece_scores,
                 int Lt, float fallback_score, int maxcand, int fallback_id, const void* pows,
                 void* res, int N, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Lt <= 0 || Lt > kMaxW || maxcand < 1 || maxcand > kMaxW || N < 0)
    return (int)cudaErrorInvalidValue;
  const Pieces pc{static_cast<const int32_t*>(disp), static_cast<const int4*>(rows),
                  (uint32_t)size_mask, (uint32_t)bucket_mask,
                  static_cast<const int32_t*>(piece_chars), static_cast<const int32_t*>(piece_lens),
                  static_cast<const float*>(piece_scores), Lt};
  int32_t* out = static_cast<int32_t*>(res);
  const int blocks = (B + kVitWarps - 1) / kVitWarps;
  viterbi_kernel<<<blocks, kVitWarps * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(chars), static_cast<const int32_t*>(offs),
      static_cast<const int32_t*>(lens), B, pc, static_cast<const uint32_t*>(pows),
      fallback_score, maxcand, (int32_t)fallback_id, out, out + N, out + N + B);
  return (int)cudaGetLastError();
}

// K12's launch shape: info gets threads a block, registers a thread, static
// shared bytes a block, local (spill) bytes a thread and resident blocks per
// SM
int ctok_viterbi_info(int* info) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, viterbi_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, viterbi_kernel, kVitWarps * 32, 0);
  if (err != cudaSuccess) return (int)err;
  const int shape[] = {kVitWarps * 32, fa.numRegs, (int)fa.sharedSizeBytes,
                       (int)fa.localSizeBytes, blocks};
  for (int i = 0; i < 5; ++i) info[i] = shape[i];
  return (int)cudaSuccess;
}

}  // extern "C"
