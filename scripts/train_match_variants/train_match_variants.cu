// The package's K18 (complexity_tokenizer_tpu_torch/csrc/wordpiece_train.cu,
// train_match_kernel and ctok_train_match) with the designs it was measured
// against behind switches, for scripts/study_train_match_variants.py.  With
// no macro defined this is the package's K18; the package's source has no
// switch.  Built alone with the package's nvcc flags and -I
// complexity_tokenizer_tpu_torch/csrc; same C signature as the package.
//
// - K18_META (1): a hit's form length and symbol from the table row's fourth
//   word, (len << 16) | sym, which the trainer's mirror writes
//   (parallel/wordpiece_trainer.py:_MatchTables.device_buffer); 0: from
//   slot_meta[slot], one more dependent read a hit (meta-from-slot).
// - K18_AHEAD (0): the exact check of a step's longest hit right after the
//   step's ballots; 1: off the step's critical path, its loads sent out
//   with the next step's probes, which start at start + l, a failed check
//   dropping that step and running again from start + 1 (as K10,
//   csrc/wordpiece.cu; check-ahead).
// - K18_LONGEST (1): the warps taken in reverse, so that the blocks of the
//   longest words (the last, as the caller sorts them) start first; 0: in
//   the words' order (word-order).
// - K18_FIT (1): no group wider than lt_cap's candidates (every word in
//   groups of 8 up to lt_cap 8, none past 16 up to 16: a step's candidates
//   still fit one chunk), so more words share a warp; 0: the caller's
//   groups as given (unfitted).
// - K18_MINB (0): no occupancy bound; N: __launch_bounds__(128, N), N
//   resident blocks an SM asked of the register allocator (min-blocks-N).

#include <cstdint>
#include <cuda_runtime.h>

#include "chd_hash.cuh"

#ifndef K18_META
#define K18_META 1
#endif
#ifndef K18_AHEAD
#define K18_AHEAD 0
#endif
#ifndef K18_LONGEST
#define K18_LONGEST 1
#endif
#ifndef K18_FIT
#define K18_FIT 1
#endif
#ifndef K18_MINB
#define K18_MINB 0
#endif

namespace {

constexpr uint32_t kB1 = 0x01000193u;
constexpr uint32_t kB2 = 0x0BADC0DFu;
constexpr uint32_t kSeed1 = 0x9E3779B9u;
constexpr uint32_t kSeed2 = 0x7F4A7C15u;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kMaxW = 128;            // characters a form
constexpr int kMaxProbe = 16;         // the open-address table's probe budget
constexpr int32_t kMaxCp = 0x110000;  // the fallback maps' codepoints
constexpr int kMatchWarps = 4;        // K18's warps a block

struct MatchArgs {
  const int32_t* __restrict__ chars;
  const int32_t* __restrict__ offs;
  const int32_t* __restrict__ lens;
  const int4* __restrict__ table;
  uint32_t mask;
  const int2* __restrict__ slot_meta;
  const int32_t* __restrict__ slot_chars;
  const int32_t* __restrict__ fb_map;
  int lt_cap;
  int32_t* __restrict__ out;
  int32_t* __restrict__ poison;
};

// The row of key (h1, h2): true and the row when a row of the run holds it.
// The key is compared before the empty test, so the empty key (0, 1) takes
// the first empty row (slot 0), as JAX does; an empty row ends the run (no
// key lies past it: the table only grows, at a run's first empty row).
__device__ __forceinline__ bool probe_row(const int4* __restrict__ table, uint32_t mask,
                                          uint32_t h1, uint32_t h2, int4& row) {
  const uint32_t base = mix_hash(h1, h2);
#pragma unroll 1
  for (int j = 0; j < kMaxProbe; ++j) {
    const int4 r = __ldg(table + ((base + j) & mask));
    if ((uint32_t)r.x == h1 && (uint32_t)r.y == h2) {
      row = r;
      return true;
    }
    if (r.x == 0 && r.y == 1) return false;
  }
  return false;
}

// The words [word, word + 32 / G) of `end`, a group of G lanes each, with
// every lane of the warp.
template <int G>
__device__ __forceinline__ void match_words(const MatchArgs& a, int word, int end, int lane) {
  const int g = lane / G, gl = lane % G, shift = g * G;
  const uint32_t low = (uint32_t)((1ull << G) - 1ull);
  const int w = word + g;
  const bool valid = w < end;
  int off = 0, slots = 0, n = 0;
  if (valid) {
    off = __ldg(a.offs + w);
    slots = __ldg(a.offs + w + 1) - off;
    n = max(0, min(__ldg(a.lens + w), slots));
  }
  const int32_t* c = a.chars + off;
  int32_t* ow = a.out + off;
  for (int i = gl; i < slots; i += G) ow[i] = -1;  // the symbols after the __syncwarp
  __syncwarp();
  // lane gl's candidate in a chunk is gl + 1 characters long: base^(gl + 1)
  uint32_t q1 = 1u, q2 = 1u;
  {
    uint32_t b1 = kB1, b2 = kB2;
    for (int e = gl + 1; e; e >>= 1, b1 *= b1, b2 *= b2) {
      if (e & 1) {
        q1 *= b1;
        q2 *= b2;
      }
    }
  }
  const int span = min(G, a.lt_cap);  // the lanes a chunk's scan must serve
  bool poisoned = false;
  int start = 0;
#if K18_AHEAD
  // the step whose exact check is still to come: its start, length, slot,
  // symbol, fallback symbol and this lane's character of the word there
  bool pend = false;
  int pstart = 0, plen = 0;
  int32_t pslot = 0, psym = 0, pfb = 0, pch = 0;
  while (__any_sync(kFull, start < n || pend)) {
    // the pending check's first chunk, a character of the form a lane
    int32_t tch = 0;
    if (pend && gl < plen) tch = __ldg(a.slot_chars + (int64_t)pslot * kMaxW + gl);
#else
  while (__any_sync(kFull, start < n)) {
#endif
    // every candidate length at start, a lane each, in chunks of G
    const int maxl = start < n ? min(a.lt_cap, n - start) : 0;
    const int32_t ch0 = gl < maxl ? __ldg(c + start + gl) : 0;
    int32_t fb = -1;
    if (gl == 0 && maxl > 0)
      fb = __ldg(a.fb_map + (start > 0 ? kMaxCp : 0) + min(max(ch0, 0), kMaxCp - 1));
    int best_l = 0;
    int32_t best_slot = 0, best_sym = 0;
    uint32_t c1 = start > 0 ? kSeed1 : 0u, c2 = start > 0 ? kSeed2 : 0u;  // the chunk's prefix
    for (int c0 = 0; __any_sync(kFull, c0 < maxl); c0 += G) {
      const int l = c0 + gl + 1;
      const bool live = l <= maxl;
      const int32_t ch = c0 == 0 ? ch0 : (live ? __ldg(c + start + l - 1) : 0);
      // inclusive scan of h -> h * base + u: lane j holds sum_{i <= j} u_i base^(j - i)
      uint32_t v1 = ch >= 0 ? (uint32_t)ch + 1u : 0u, v2 = v1;
      uint32_t m1 = kB1, m2 = kB2;
#pragma unroll
      for (int o = 1; o < G; o <<= 1) {
        if (o >= span) break;
        const uint32_t p1 = __shfl_up_sync(kFull, v1, o, G);
        const uint32_t p2 = __shfl_up_sync(kFull, v2, o, G);
        if (gl >= o) {
          v1 += p1 * m1;
          v2 += p2 * m2;
        }
        m1 *= m1;
        m2 *= m2;
      }
      const uint32_t h1 = c1 * q1 + v1, h2 = c2 * q2 + v2;
      c1 = __shfl_sync(kFull, h1, G - 1, G);
      c2 = __shfl_sync(kFull, h2, G - 1, G);
      bool hit = false;
      int32_t slot = 0, sym = 0;
      int4 r;
      if (live && probe_row(a.table, a.mask, h1, h2, r)) {
#if K18_META
        uint32_t meta = (uint32_t)r.w;
        if (r.x == 0 && r.y == 1) {  // the empty key: slot 0's (length, symbol)
          const int2 m0 = __ldg(a.slot_meta);
          meta = ((uint32_t)m0.x << 16) | ((uint32_t)m0.y & 0xFFFFu);
        }
        hit = (int)(meta >> 16) == l;  // the length guard
        sym = (int32_t)(meta & 0xFFFFu);
#else
        const int2 m = __ldg(a.slot_meta + r.z);
        hit = m.x == l;  // the length guard
        sym = m.y;
#endif
        slot = r.z;
      }
      // the longest hit: the highest lane of the latest chunk with one
      const uint32_t hb = (__ballot_sync(kFull, hit) >> shift) & low;
      const int src = hb ? 31 - __clz(hb) : 0;
      const int32_t bs = __shfl_sync(kFull, slot, src, G);
      const int32_t by = __shfl_sync(kFull, sym, src, G);
      if (hb) {
        best_l = c0 + src + 1;
        best_slot = bs;
        best_sym = by;
      }
    }
    const int32_t fb0 = __shfl_sync(kFull, fb, 0, G);
#if K18_AHEAD
    // the pending check decides: its symbol, or poison, its fallback
    // symbol and the step again from its start + 1 (this step dropped)
    bool ok = !pend || gl >= plen || tch == pch;
    if (pend)
      for (int k = gl + G; k < plen; k += G)  // a form longer than the group
        ok &= __ldg(a.slot_chars + (int64_t)pslot * kMaxW + k) == __ldg(c + pstart + k);
    const bool bad = (__ballot_sync(kFull, !ok) >> shift) & low;  // every lane votes
    const bool fail = pend && bad;
    if (pend && gl == 0) ow[pstart] = fail ? pfb : psym;
    if (fail) {
      poisoned = true;
      start = pstart + 1;
      pend = false;
    } else {
      pend = false;
      if (start < n) {
        if (best_l > 0) {
          pend = true;
          pstart = start;
          plen = best_l;
          pslot = best_slot;
          psym = best_sym;
          pfb = fb0;
          pch = ch0;
          start += best_l;
        } else {
          if (gl == 0) ow[start] = fb0;
          poisoned |= fb0 < 0;
          ++start;
        }
      }
    }
#else
    // the exact check of the longest hit, a character a lane, a vote
    bool ok = true;
    if (best_l > 0)
      for (int k = gl; k < best_l; k += G)
        ok &= __ldg(a.slot_chars + (int64_t)best_slot * kMaxW + k) ==
              (k == gl ? ch0 : __ldg(c + start + k));
    const bool bad = (__ballot_sync(kFull, !ok) >> shift) & low;
    if (start < n) {
      const bool good = best_l > 0 && !bad;
      if (gl == 0) ow[start] = good ? best_sym : fb0;
      poisoned |= best_l > 0 ? bad : fb0 < 0;
      start += good ? best_l : 1;
    }
#endif
  }
  if (valid && gl == 0) a.poison[w] = poisoned;
}

// A warp's words: 4 of the words [0, n8), 2 of [n8, n16) or one of
// [n16, B), by the warp's index (taken from the last warp with
// K18_LONGEST).
#if K18_MINB
__global__ void __launch_bounds__(kMatchWarps * 32, K18_MINB)
#else
__global__ void __launch_bounds__(kMatchWarps * 32)
#endif
train_match_kernel(MatchArgs a, int n8, int n16, int B, int warps) {
  const int lane = threadIdx.x & 31;
  int gw = blockIdx.x * kMatchWarps + (threadIdx.x >> 5);
  if (gw >= warps) return;
#if K18_LONGEST
  gw = warps - 1 - gw;
#endif
  const int w8 = (n8 + 3) / 4, w16 = (n16 - n8 + 1) / 2;
  if (gw < w8) {
    match_words<8>(a, 4 * gw, n8, lane);
  } else if (gw < w8 + w16) {
    match_words<16>(a, n8 + 2 * (gw - w8), n16, lane);
  } else {
    match_words<32>(a, n16 + gw - w8 - w16, B, lane);
  }
}

}  // namespace

extern "C" {

// chars [N], offs [B + 1], lens [B] int32, the word groups (0 <= n8 <= n16
// <= B); table [T] int4 (16-byte aligned; (len << 16) | sym in each filled
// row's fourth word), t_mask = T - 1; slot_meta [S] int2; slot_chars [S,
// 128]; fb_map [2, 0x110000]; lt_cap 1..128 -> out [N] int32, poison [B]
// int32
int ctok_train_match(const void* chars, const void* offs, const void* lens, int n8, int n16,
                     int B, const void* table, unsigned t_mask, const void* slot_meta,
                     const void* slot_chars, const void* fb_map, int lt_cap, void* out,
                     void* poison, void* stream) {
  if (B < 0 || n8 < 0 || n8 > n16 || n16 > B || lt_cap < 1 || lt_cap > kMaxW ||
      (t_mask & (t_mask + 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
#if K18_FIT
  if (lt_cap <= 8) {
    n8 = n16 = B;
  } else if (lt_cap <= 16) {
    n16 = B;
  }
#endif
  const int warps = (n8 + 3) / 4 + (n16 - n8 + 1) / 2 + (B - n16);
  const MatchArgs a{static_cast<const int32_t*>(chars),
                    static_cast<const int32_t*>(offs),
                    static_cast<const int32_t*>(lens),
                    static_cast<const int4*>(table),
                    (uint32_t)t_mask,
                    static_cast<const int2*>(slot_meta),
                    static_cast<const int32_t*>(slot_chars),
                    static_cast<const int32_t*>(fb_map),
                    lt_cap,
                    static_cast<int32_t*>(out),
                    static_cast<int32_t*>(poison)};
  train_match_kernel<<<(warps + kMatchWarps - 1) / kMatchWarps, kMatchWarps * 32, 0,
                       (cudaStream_t)stream>>>(a, n8, n16, B, warps);
  return (int)cudaGetLastError();
}

}  // extern "C"
