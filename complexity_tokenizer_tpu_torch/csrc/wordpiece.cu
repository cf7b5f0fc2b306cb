// K10 and K11: the WordPiece greedy longest match and the WordLevel lookup,
// for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// complexity_tokenizer_tpu_torch/utils/cuda_build.py; no PyTorch headers.
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() of its launch.
//
// Both probe a CHD table keyed on two 32-bit polynomial hashes of a string
// (disp [n_buckets], rows [size] of (h1, h2, slot, emit id)), whose slot
// indexes token_chars [S, Lt], token_lens [S] and emit_ids [S]
// (ops/wordpiece_device.py; the port's table build puts emit_ids[slot] in
// the row's fourth word, which the JAX tables leave at -1).  The hashes are
// the JAX package's, bit for bit (_poly_hash_np: h = h * base + (c + 1) in
// uint32, with two bases).
//
// K10 replaces rolling_prefix_hashes + WordPieceDevice._fn
// (complexity_tokenizer_tpu/ops/wordpiece_device.py).  Its words come
// ragged: chars [N] int32, the codepoints of all words end to end, offs
// [B + 1] int32 and lens [B] int32 (lens[i] = the word's characters, or,
// over max_input, its length, one slot and no characters) -> out [N] (each
// match's id at its start character, -1 elsewhere), count [B] and poison
// [B], bit for bit wordpiece_match_ragged_plain on the same words.
// - Lane groups sized to the word: the words [0, n8) are matched 4 a warp
//   by groups of 8 lanes, [n8, n16) 2 a warp by groups of 16, the rest a
//   warp each.  The caller orders the words by length so that a group's
//   word fits its lanes; a longer one is still right, in more chunks.
// - The word's prefix hashes P1, P2 [n + 1] by a scan of the affine steps
//   x -> x * base + u over its live characters only, confined to the group
//   (shuffles of the group's width), into shared memory.
// - A step probes the candidate lengths l = 1..min(Lt, n - start) at once,
//   a lane each, in as many chunks of the group's width as they need: the
//   key of chars[start, start + l) is P[start + l] - P[start] * base^l,
//   plus seed * base^l past the word's first position (the "##" form); the
//   powers come from a table built once per device (hash_powers), not
//   computed in the kernel.  All displacement reads go out before any row
//   read; the row brings the slot and the emit id.
// - The longest hit is the highest set bit of the group's ballots.  Its
//   exact check (the slot's characters and length against the word) is off
//   the step's critical path: its loads go out with the next step's
//   displacement reads, which start at start + l; a failed check (a hash
//   collision) poisons the word, drops that next step and runs the step
//   again from start + 1, as the plain version does.  A miss emits UNK (if
//   present) and advances one.
// - Every slot of a word is -1 unless an id is emitted there; a word over
//   max_input is one UNK in its one slot, or nothing without UNK.
//
// K11 replaces WordLevelDevice._fn (the same file) and gives bit for bit
// wordlevel_lookup_ragged_plain on the same ragged words as K10's: chars
// [N] int32, offs [B + 1] int32 and lens [B] int32 -> out [B] int32 (the
// word's id, UNK on a miss or a failed check, -1 for a word of length <= 0),
// in the words' order.
// - K10's lane groups: the words [0, n8) 4 a warp by groups of 8 lanes,
//   [n8, n16) 2 a warp by groups of 16, the rest a warp each.
// - The whole-word hashes by one affine scan a base over the word's live
//   characters only (a -1 character is the identity step), in chunks of
//   the group's width where the word is longer than its group.
// - One displacement read and one row read; the row brings the slot and
//   the emit id (its fourth word), so no emit_ids read follows.
// - The exact check: token_lens[slot] and token_chars[slot, 0:len] one lane
//   a character (-1 past the word's slots), ended by a vote of the group.
//
// Bound: latency.  The bytes are each word's live characters in (4 B
// each), the offsets and lengths (4 B a word each), the ids out (K10: 4 B
// a character, with count and poison; K11: 4 B a word) and the table
// entries the probes touch (4 B of displacement, 16 B of row; K11 also 4 B
// of length and 4 B a character checked), all in L2 after the first touch.
// A K10 step waits on two dependent reads (displacement, row); a K11 word
// on the characters, those two and the check.  Times, the bound and the
// launch shape are in PERF.md, section 6.

#include <cstdint>
#include <cuda_runtime.h>

#include "chd_hash.cuh"

namespace {

constexpr uint32_t kB1 = 0x01000193u;
constexpr uint32_t kB2 = 0x0BADC0DFu;
constexpr int32_t kInfRank = 0x3FFFFFFF;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kMaxW = 128;         // characters a word (K10)
constexpr int kWpWarps = 4;        // warps a block
constexpr int kPowLen = kMaxW + 1;  // a row of the powers table
// K10's launch bound, resident blocks an SM (64 registers a thread; at 12,
// 40 registers, it spilled 134 bytes a thread)
constexpr int kWpMinBlocks = 8;

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

// Inclusive scan of the affine maps x -> x * m + v in each segment of G
// lanes (in lane order): on return lane j of a segment holds the
// composition of its lanes 0..j.  Every lane of the warp takes part.
template <int G>
__device__ __forceinline__ void affine_scan(uint32_t& m, uint32_t& v, int gl) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    const uint32_t pm = __shfl_up_sync(kFull, m, o, G);
    const uint32_t pv = __shfl_up_sync(kFull, v, o, G);
    if (gl >= o) {
      v = pv * m + v;
      m = pm * m;
    }
  }
}

// ---------------------------------------------------------------------------
// K10

// Candidate chunks a pass probes together: a warp word's longest
// candidates fit one pass; a group of 8 or 16 takes one chunk a pass (its
// words fit it when the caller sorts them)
template <int G>
constexpr int kPass = G == 32 ? kMaxW / 32 : 1;

// The words [word, word + 32 / G) of `end` (a group of G lanes each), with
// every lane of the warp.  sp: the warp's prefix-hash space, a [2][129]
// region a group.
template <int G>
__device__ __forceinline__ void match_words(const int32_t* __restrict__ chars,
                                            const int32_t* __restrict__ offs,
                                            const int32_t* __restrict__ lens, const Tables& tb,
                                            const uint32_t* __restrict__ pows, int32_t max_input,
                                            int word, int end, uint32_t (*sp)[2][kPowLen],
                                            int32_t* __restrict__ out,
                                            int32_t* __restrict__ count,
                                            bool* __restrict__ poison, int lane) {
  constexpr int kP = kPass<G>;
  const int g = lane / G, gl = lane % G;
  const uint32_t low = (uint32_t)((1ull << G) - 1ull);
  word += g;
  const bool valid = word < end;
  int off = 0, slots = 0, len = 0;
  if (valid) {
    off = __ldg(offs + word);
    slots = __ldg(offs + word + 1) - off;
    len = __ldg(lens + word);
  }
  const bool over = valid && len > max_input;
  const int n = over ? 0 : max(0, min(min(len, slots), kMaxW));  // the characters matched
  uint32_t* P1 = sp[g][0];
  uint32_t* P2 = sp[g][1];
  // -1 in every slot; the ids are written after the __syncwarp below
  for (int i = gl; i < slots; i += G) out[off + i] = -1;
  // the prefix hashes, a chunk of G characters at a time
  const int nmax = __reduce_max_sync(kFull, n);
  if (gl == 0) {
    P1[0] = 0;
    P2[0] = 0;
  }
  uint32_t c1 = 0, c2 = 0;  // P[i0], the carry into the chunk
  for (int i0 = 0; i0 < nmax; i0 += G) {
    const int i = i0 + gl;
    const bool in = i < n;
    const int32_t c = in ? __ldg(chars + off + i) : -1;
    uint32_t m1 = in ? kB1 : 1u, v1 = in && c >= 0 ? (uint32_t)c + 1u : 0u;
    uint32_t m2 = in ? kB2 : 1u, v2 = v1;
    affine_scan<G>(m1, v1, gl);
    affine_scan<G>(m2, v2, gl);
    const uint32_t p1 = c1 * m1 + v1, p2 = c2 * m2 + v2;
    if (in) {
      P1[i + 1] = p1;
      P2[i + 1] = p2;
    }
    c1 = __shfl_sync(kFull, p1, G - 1, G);
    c2 = __shfl_sync(kFull, p2, G - 1, G);
  }
  __syncwarp();
  // the powers of the first chunk's candidate, l = gl + 1
  const uint32_t q1 = __ldg(pows + gl + 1), q2 = __ldg(pows + kPowLen + gl + 1);
  const uint32_t s1 = __ldg(pows + 2 * kPowLen + gl + 1);
  const uint32_t s2 = __ldg(pows + 3 * kPowLen + gl + 1);
  int emitted = over && tb.unk >= 0 ? 1 : 0;
  if (over && gl == 0 && slots > 0 && tb.unk >= 0) out[off] = tb.unk;
  bool poisoned = false;
  int start = 0;
  // the step whose exact check is still to come: its start, length, slot, id
  bool pend = false;
  int pstart = 0, plen = 0;
  int32_t pslot = 0, pemit = 0;
  for (;;) {
    if (!__any_sync(kFull, n > 0 && (start < n || pend))) break;
    // 1. the pending check's loads: its first chunk of characters, the length
    int32_t tch = 0, wch = 0, tl = 0;
    if (pend) {
      tl = __ldg(tb.token_lens + pslot);
      if (gl < plen) {
        tch = __ldg(tb.token_chars + (int64_t)pslot * tb.Lt + gl);
        wch = __ldg(chars + off + pstart + gl);
      }
    }
    // 2. the candidates at start, past the pending step: every displacement
    // read of a pass, then every row read; the longest hit
    const int lim = start < n ? min(tb.Lt, n - start) : 0;
    int best_l = 0;
    int32_t best_slot = 0, best_emit = 0;
    for (int c0 = 0;; c0 += kP) {
      uint32_t a[kP], b[kP];
      bool live[kP];
      int32_t d[kP];
      int4 r[kP];
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        const int l = (c0 + k) * G + gl + 1;
        live[k] = l <= lim;
        a[k] = b[k] = 0;
        if (live[k]) {
          const bool first = c0 + k == 0;
          const uint32_t w1 = first ? q1 : __ldg(pows + l);
          const uint32_t w2 = first ? q2 : __ldg(pows + kPowLen + l);
          a[k] = P1[start + l] - P1[start] * w1;
          b[k] = P2[start + l] - P2[start] * w2;
          if (start > 0) {
            a[k] += first ? s1 : __ldg(pows + 2 * kPowLen + l);
            b[k] += first ? s2 : __ldg(pows + 3 * kPowLen + l);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kP; ++k) d[k] = live[k] ? disp_of(tb, a[k], b[k]) : 0;
#pragma unroll
      for (int k = 0; k < kP; ++k)
        r[k] = live[k] ? __ldg(tb.rows + ((mix_hash2(a[k], b[k]) + (uint32_t)d[k]) & tb.size_mask))
                       : make_int4(0, 0, kInfRank, 0);
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        const bool hit = live[k] && r[k].x == (int32_t)a[k] && r[k].y == (int32_t)b[k] &&
                         r[k].z != kInfRank;
        const uint32_t hb = (__ballot_sync(kFull, hit) >> (g * G)) & low;
        const int src = hb ? 31 - __clz(hb) : 0;
        const int32_t slot = __shfl_sync(kFull, r[k].z, src, G);
        const int32_t emit = __shfl_sync(kFull, r[k].w, src, G);
        if (hb) {
          best_l = (c0 + k) * G + src + 1;
          best_slot = slot;
          best_emit = emit;
        }
      }
      if (!__any_sync(kFull, (c0 + kP) * G < lim)) break;
    }
    // 3. the pending check decides: its id, or poison and the step again
    // from its start + 1 (the candidates above are dropped)
    bool ok = !pend || gl >= plen || tch == wch;
    if (pend)
      for (int j = gl + G; j < plen; j += G)  // a token longer than the group
        ok &= __ldg(tb.token_chars + (int64_t)pslot * tb.Lt + j) ==
              __ldg(chars + off + pstart + j);
    const bool bad = (__ballot_sync(kFull, !ok) >> (g * G)) & low;
    const bool fail = pend && (bad || tl != plen);
    if (pend && !fail) {
      if (gl == 0) out[off + pstart] = pemit;
      ++emitted;
    }
    pend = false;
    if (fail) {
      poisoned = true;
      start = pstart + 1;
    } else if (start < n) {
      if (best_l > 0) {
        pend = true;
        pstart = start;
        plen = best_l;
        pslot = best_slot;
        pemit = best_emit;
        start += best_l;
      } else {
        if (tb.unk >= 0) {
          if (gl == 0) out[off + start] = tb.unk;
          ++emitted;
        }
        ++start;
      }
    }
  }
  if (valid && gl == 0) {
    count[word] = emitted;
    poison[word] = poisoned;
  }
}

// A warp's words: 4 of the words [0, n8), 2 of [n8, n16) or one of
// [n16, B), by the warp's index.
__global__ void __launch_bounds__(kWpWarps * 32, kWpMinBlocks)
wordpiece_kernel(const int32_t* __restrict__ chars, const int32_t* __restrict__ offs,
                 const int32_t* __restrict__ lens, Tables tb, const uint32_t* __restrict__ pows,
                 int32_t max_input, int n8, int n16, int B, int32_t* __restrict__ out,
                 int32_t* __restrict__ count, bool* __restrict__ poison) {
  __shared__ uint32_t s_p[kWpWarps][4][2][kPowLen];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWpWarps + warp;
  const int w8 = (n8 + 3) / 4, w16 = (n16 - n8 + 1) / 2;
  if (gw < w8) {
    match_words<8>(chars, offs, lens, tb, pows, max_input, 4 * gw, n8, s_p[warp], out, count,
                   poison, lane);
  } else if (gw < w8 + w16) {
    match_words<16>(chars, offs, lens, tb, pows, max_input, n8 + 2 * (gw - w8), n16, s_p[warp],
                    out, count, poison, lane);
  } else if (n16 + gw - w8 - w16 < B) {
    match_words<32>(chars, offs, lens, tb, pows, max_input, n16 + gw - w8 - w16, B, s_p[warp],
                    out, count, poison, lane);
  }
}

// ---------------------------------------------------------------------------
// K11

constexpr int kWlWarps = 8;  // K11's warps a block

// The words [word, word + 32 / G) of `end` (a group of G lanes each), with
// every lane of the warp.
template <int G>
__device__ __forceinline__ void lookup_words(const int32_t* __restrict__ chars,
                                             const int32_t* __restrict__ offs,
                                             const int32_t* __restrict__ lens, const Tables& tb,
                                             int word, int end, int32_t* __restrict__ out,
                                             int lane) {
  const int g = lane / G, gl = lane % G;
  const uint32_t low = (uint32_t)((1ull << G) - 1ull);
  word += g;
  const bool valid = word < end;
  int off = 0, slots = 0, len = 0;
  if (valid) {
    off = __ldg(offs + word);
    slots = __ldg(offs + word + 1) - off;
    len = __ldg(lens + word);
  }
  // the whole word's hashes, a chunk of G characters at a time; the first
  // chunk's character stays in a register for the check
  const int nmax = __reduce_max_sync(kFull, max(slots, 0));
  uint32_t h1 = 0, h2 = 0;
  int32_t first = -1;
#pragma unroll 1  // unrolled, it kept the trip count's parity in local memory
  for (int i0 = 0; i0 < nmax; i0 += G) {
    const int i = i0 + gl;
    const int32_t c = i < slots ? __ldg(chars + off + i) : -1;
    if (i0 == 0) first = c;
    const bool on = c >= 0;
    uint32_t m1 = on ? kB1 : 1u, v1 = on ? (uint32_t)c + 1u : 0u;
    uint32_t m2 = on ? kB2 : 1u, v2 = v1;
    affine_scan<G>(m1, v1, gl);
    affine_scan<G>(m2, v2, gl);
    h1 = h1 * __shfl_sync(kFull, m1, G - 1, G) + __shfl_sync(kFull, v1, G - 1, G);
    h2 = h2 * __shfl_sync(kFull, m2, G - 1, G) + __shfl_sync(kFull, v2, G - 1, G);
  }
  // one probe: the row brings the slot and the emit id
  const bool live = valid && len > 0;
  bool ok = false;
  int32_t slot = 0, emit = 0;
  if (live) {
    const int4 r = __ldg(tb.rows + ((mix_hash2(h1, h2) + (uint32_t)disp_of(tb, h1, h2)) &
                                    tb.size_mask));
    slot = r.z;
    emit = r.w;
    ok = r.x == (int32_t)h1 && r.y == (int32_t)h2 && slot != kInfRank && len <= tb.Lt;
  }
  // the exact check, one lane a character; -1 past the word's slots
  if (ok) {
    ok = __ldg(tb.token_lens + slot) == len;
    const int32_t* tc = tb.token_chars + (int64_t)slot * tb.Lt;
    for (int j = gl; j < len; j += G) {
      const int32_t wc = j == gl ? first : (j < slots ? __ldg(chars + off + j) : -1);
      ok &= __ldg(tc + j) == wc;
    }
  }
  const bool fail = (__ballot_sync(kFull, live && !ok) >> (g * G)) & low;
  if (valid && gl == 0) out[word] = live ? (fail ? tb.unk : emit) : -1;
}

// A warp's words: 4 of the words [0, n8), 2 of [n8, n16) or one of
// [n16, B), by the warp's index.
__global__ void __launch_bounds__(kWlWarps * 32)
wordlevel_kernel(const int32_t* __restrict__ chars, const int32_t* __restrict__ offs,
                 const int32_t* __restrict__ lens, Tables tb, int n8, int n16, int B,
                 int32_t* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWlWarps + warp;
  const int w8 = (n8 + 3) / 4, w16 = (n16 - n8 + 1) / 2;
  if (gw < w8) {
    lookup_words<8>(chars, offs, lens, tb, 4 * gw, n8, out, lane);
  } else if (gw < w8 + w16) {
    lookup_words<16>(chars, offs, lens, tb, n8 + 2 * (gw - w8), n16, out, lane);
  } else if (n16 + gw - w8 - w16 < B) {
    lookup_words<32>(chars, offs, lens, tb, n16 + gw - w8 - w16, B, out, lane);
  }
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

// K10: chars [N] int32, offs [B + 1] int32, lens [B] int32, the word
// groups (0 <= n8 <= n16 <= B), the CHD table (rows 16-byte aligned, the
// emit id in each row's fourth word), the slot tables and the powers [4,
// 129] uint32 -> out [N] int32, count [B] int32, poison [B] bool
int ctok_wordpiece_match(const void* chars, const void* offs, const void* lens, int n8, int n16,
                         int B, const void* disp, const void* rows, unsigned size_mask,
                         unsigned bucket_mask, const void* token_chars, const void* token_lens,
                         const void* emit_ids, int Lt, int unk, int max_input, const void* pows,
                         void* out, void* count, void* poison, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (n8 < 0 || n8 > n16 || n16 > B || Lt <= 0 || Lt > kMaxW) return (int)cudaErrorInvalidValue;
  const Tables tb = make_tables(disp, rows, size_mask, bucket_mask, token_chars, token_lens,
                                emit_ids, Lt, unk);
  const int warps = (n8 + 3) / 4 + (n16 - n8 + 1) / 2 + (B - n16);
  const int blocks = (warps + kWpWarps - 1) / kWpWarps;
  wordpiece_kernel<<<blocks, kWpWarps * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(chars), static_cast<const int32_t*>(offs),
      static_cast<const int32_t*>(lens), tb, static_cast<const uint32_t*>(pows), max_input, n8,
      n16, B, static_cast<int32_t*>(out), static_cast<int32_t*>(count),
      static_cast<bool*>(poison));
  return (int)cudaGetLastError();
}

// K10's launch shape: info gets threads a block, registers a thread, static
// shared bytes a block, local (spill) bytes a thread and resident blocks
// per SM
int ctok_wordpiece_info(int* info) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, wordpiece_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wordpiece_kernel, kWpWarps * 32, 0);
  if (err != cudaSuccess) return (int)err;
  const int shape[] = {kWpWarps * 32, fa.numRegs, (int)fa.sharedSizeBytes,
                       (int)fa.localSizeBytes, blocks};
  for (int i = 0; i < 5; ++i) info[i] = shape[i];
  return (int)cudaSuccess;
}

// K11: chars [N] int32, offs [B + 1] int32, lens [B] int32, the word
// groups (0 <= n8 <= n16 <= B), the CHD table (rows 16-byte aligned, the
// emit id in each row's fourth word) and the slot tables -> out [B] int32
int ctok_wordlevel_lookup(const void* chars, const void* offs, const void* lens, int n8, int n16,
                          int B, const void* disp, const void* rows, unsigned size_mask,
                          unsigned bucket_mask, const void* token_chars, const void* token_lens,
                          int Lt, int unk, void* out, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (n8 < 0 || n8 > n16 || n16 > B || Lt <= 0) return (int)cudaErrorInvalidValue;
  const Tables tb = make_tables(disp, rows, size_mask, bucket_mask, token_chars, token_lens,
                                nullptr, Lt, unk);
  const int warps = (n8 + 3) / 4 + (n16 - n8 + 1) / 2 + (B - n16);
  const int blocks = (warps + kWlWarps - 1) / kWlWarps;
  wordlevel_kernel<<<blocks, kWlWarps * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(chars), static_cast<const int32_t*>(offs),
      static_cast<const int32_t*>(lens), tb, n8, n16, B, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// K11's launch shape, as ctok_wordpiece_info's
int ctok_wordlevel_info(int* info) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, wordlevel_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wordlevel_kernel, kWlWarps * 32,
                                                      0);
  if (err != cudaSuccess) return (int)err;
  const int shape[] = {kWlWarps * 32, fa.numRegs, (int)fa.sharedSizeBytes,
                       (int)fa.localSizeBytes, blocks};
  for (int i = 0; i < 5; ++i) info[i] = shape[i];
  return (int)cudaSuccess;
}

}  // extern "C"
