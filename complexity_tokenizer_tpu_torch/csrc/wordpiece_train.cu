// K18 and K19: the device WordPiece trainer's greedy match and pair count,
// for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// complexity_tokenizer_tpu_torch/utils/cuda_build.py; no PyTorch headers.
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the CUDA error of its launches.
//
// They replace the XLA program of the JAX package's
// parallel/wordpiece_trainer.py, _match_count_program (none calls
// pl.pallas_call): match_rows (:197-272) and the pair count of fn
// (:274-317).  The wrappers and plain versions are in
// complexity_tokenizer_tpu_torch/ops/wordpiece_train_device.py.
//
// K18 takes the distinct words ragged (chars [N] int32 end to end, offs
// [B + 1], lens [B]; the caller orders them by length and gives the lane
// groups (n8, n16): the words of at most 8 and 16 slots) and the trainer's
// tables: an open-address table [T] of int4 rows (h1, h2, slot, (len << 16)
// | sym: the form's length and symbol), the empty row (0, 1, 0, 0), T a
// power of two; each slot's (length, symbol) [S] int2 and characters [S,
// 128] int32; the fallback symbols fb_map [2, 0x110000] (the bare
// character, "##" + character).  As match_rows decides it:
// - lane groups sized to the word, as K10's: the words [0, n8) 4 a warp by
//   groups of 8 lanes, [n8, n16) 2 a warp by groups of 16, the rest a warp
//   each; a word longer than its group is still right, in more chunks.  No
//   group is wider than lt_cap's candidates (every word in groups of 8 up to
//   lt_cap 8, none past 16 up to 16), so more words share a warp.  The
//   warps are taken from the last, so that the longest words start first;
// - a step probes every candidate length l = 1..min(lt_cap, n - start) at
//   once, lane j the length j + 1 (in chunks of the group's width where the
//   lengths are wider).  The two hashes of chars[start, start + l) come from
//   an inclusive scan over the group's lanes of the affine steps h -> h *
//   base + (c + 1) in uint32, from the continuation seeds past the word's
//   start (equal to JAX's P[e] - P[s] * base^l + seed * base^l).  Each lane
//   walks its own probe run, up to 16 rows from mix_hash(h1, h2) & (T - 1),
//   and takes the first row whose key matches.  No key lies past an empty
//   row of its run (the table only grows and inserts at the first empty
//   row), so an empty row ends the probe, as a miss unless the key is the
//   empty key itself (JAX's rule then takes that row's slot, 0, whose length
//   and symbol come from slot_meta[0]);
// - the row's fourth word decides the hit with the probe's one read: a hit
//   counts when the form has length l (the length guard); the longest is the
//   highest set bit of the group's ballots, a later chunk before an earlier;
// - only the longest hit is checked, a character a lane, ended by a vote of
//   the group: a mismatch (a hash collision) poisons the word, emits the
//   fallback symbol and advances one, as a miss does; a miss whose character
//   has no fallback symbol poisons the word too;
// - out: the symbol at each piece's start, -1 in the word's other slots
//   (written first by the group's lanes, coalesced); poison [B] int32.
//
// K19 over K18's out [N], the words' offs, freqs [B] and poison [B]: every
// adjacent pair of a word's symbols (the -1 between pieces skipped), keyed
// (a << 16) | b, weighted by the word's frequency; a poisoned word adds
// nothing (JAX weights it 0 and drops keys whose sum is 0).  Its state is
// an open-address table [T] of int2 (key, count) rows (key -1: empty;
// linear probing from mix_hash(key, 0)), a list of the rows a call claims
// and a head (the list's length, the poisoned words, the compaction's
// blocks done).  The caller clears it once; every call leaves it cleared,
// so no call clears the table or passes over all its T rows.  Two launches:
// - the insert: a warp takes 32 consecutive slots of out in one coalesced
//   load; each lane finds its slot's word (a 32-ary search of offs for the
//   slot at the step's start, then the next 32 offsets shuffled) and the
//   slot before it that holds a symbol (a ballot, or the last symbol before
//   the step); a slot holding a symbol whose earlier symbol lies in its
//   word adds the pair: atomicCAS claims the key's row, atomicAdd sums the
//   weight.  A block gathers the rows its lanes claimed in shared memory
//   (one shared atomic a warp) and appends them to the list with one
//   global atomic, with its share of the poisoned words;
// - the compaction, the insert's programmatic dependent: after
//   griddepcontrol.wait, a thread a listed row writes (key, count) into res
//   [2 + 2 cap] and returns the row to empty; res[0] = the list's length,
//   res[1] = the poisoned words; the last block to finish zeroes the head.
// The table holds at least twice the slots, so it cannot fill.  int32 sums
// are the same in any order, so the set of (key, count) equals
// pair_count_plain's bit for bit; their order is the claims'.
//
// Bound: latency.  K18's bytes are the words' characters in, the symbols
// and poison flags out and the table rows its probes touch (16 B each, in
// L2 after the first touch); a step waits on its characters, the group's
// scan, one probe's row reads (one row in most runs), a ballot and the check
// of its hit.  The designs it was measured against are in
// scripts/train_match_variants/.  K19 reads the symbols once and writes each key once; a
// claimed row is read and written back once more, and the atomics on a hot
// key's row queue in L2.

#include <cstdint>
#include <cuda_runtime.h>

#include "chd_hash.cuh"
#include "dependent_launch.cuh"

namespace {

constexpr uint32_t kB1 = 0x01000193u;
constexpr uint32_t kB2 = 0x0BADC0DFu;
constexpr uint32_t kSeed1 = 0x9E3779B9u;
constexpr uint32_t kSeed2 = 0x7F4A7C15u;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kMaxW = 128;            // characters a form
constexpr int kMaxProbe = 16;         // the open-address table's probe budget
constexpr int32_t kMaxCp = 0x110000;  // the fallback maps' codepoints
constexpr int kThreads = 256;         // K19's threads a block
constexpr int kMatchWarps = 4;        // K18's warps a block

// ---------------------------------------------------------------------------
// K18

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
  while (__any_sync(kFull, start < n)) {
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
        uint32_t meta = (uint32_t)r.w;
        if (r.x == 0 && r.y == 1) {  // the empty key: slot 0's (length, symbol)
          const int2 m0 = __ldg(a.slot_meta);
          meta = ((uint32_t)m0.x << 16) | ((uint32_t)m0.y & 0xFFFFu);
        }
        hit = (int)(meta >> 16) == l;  // the length guard
        sym = (int32_t)(meta & 0xFFFFu);
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
  }
  if (valid && gl == 0) a.poison[w] = poisoned;
}

// A warp's words: 4 of the words [0, n8), 2 of [n8, n16) or one of
// [n16, B), by the warp's index counted from the last (the longest words'
// blocks first).
__global__ void __launch_bounds__(kMatchWarps * 32)
train_match_kernel(MatchArgs a, int n8, int n16, int B, int warps) {
  const int lane = threadIdx.x & 31;
  int gw = blockIdx.x * kMatchWarps + (threadIdx.x >> 5);
  if (gw >= warps) return;
  gw = warps - 1 - gw;
  const int w8 = (n8 + 3) / 4, w16 = (n16 - n8 + 1) / 2;
  if (gw < w8) {
    match_words<8>(a, 4 * gw, n8, lane);
  } else if (gw < w8 + w16) {
    match_words<16>(a, n8 + 2 * (gw - w8), n16, lane);
  } else {
    match_words<32>(a, n16 + gw - w8 - w16, B, lane);
  }
}

// ---------------------------------------------------------------------------
// K19

constexpr int kCompactMaxBlocks = 264;  // two a SM: the compaction strides over the list

// The last w in [0, B] with offs[w] <= p, the same p in every lane (offs[0]
// = 0 <= p): the word that holds slot p, empty words passed over.  A 32-ary
// search, one ballot a level (3 levels for 30,000 words).
__device__ __forceinline__ int warp_word_of(const int32_t* __restrict__ offs, int B, int p,
                                            int lane) {
  int lo = 0, len = B + 1;
  while (len > 1) {
    const int step = (len + 31) >> 5;
    const bool le = lane * step < len && __ldg(offs + lo + lane * step) <= p;
    const int k = 31 - __clz(__ballot_sync(kFull, le));  // lane 0 holds: offs[lo] <= p
    const int nlo = lo + k * step;
    len = min(step, lo + len - nlo);
    lo = nlo;
  }
  return lo;
}

// The same for one lane's p (the slow path, when 32 words or more start in
// a step: empty or one-slot words).
__device__ __forceinline__ int lane_word_of(const int32_t* __restrict__ offs, int B, int p) {
  int lo = 0, hi = B;  // offs[lo] <= p < offs[hi + 1], offs[B + 1] taken as infinite
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(offs + mid) <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Adds f to key's row, claiming an empty row for a new key; returns whether
// this call claimed it, and the row.
__device__ __forceinline__ bool insert_pair(int2* __restrict__ table, uint32_t mask, int32_t key,
                                            int32_t f, uint32_t* row) {
  uint32_t h = mix_hash((uint32_t)key, 0u) & mask;
  bool claimed = false;
  while (true) {
    // the atomicCAS alone, no read of the key before it: a read first took
    // 5% more over the run (scripts/study_pair_count_variants.py)
    const int32_t prev = atomicCAS(reinterpret_cast<int32_t*>(table + h), -1, key);
    if (prev == -1) {
      claimed = true;
      break;
    }
    if (prev == key) break;
    h = (h + 1) & mask;  // a row holds its key until the compaction: probe on
  }
  atomicAdd(reinterpret_cast<int32_t*>(table + h) + 1, f);
  *row = h;
  return claimed;
}

__global__ void __launch_bounds__(kThreads)
pair_insert_kernel(const int32_t* __restrict__ out, int N, const int32_t* __restrict__ offs,
                   const int32_t* __restrict__ freqs, const int32_t* __restrict__ poison, int B,
                   int2* __restrict__ table, uint32_t mask, int32_t* __restrict__ rows,
                   int32_t* __restrict__ head) {
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ int32_t s_rows[kThreads];  // the rows this block claimed
  __shared__ int32_t s_n, s_poison, s_base;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s_n = 0;
    s_poison = 0;
  }
  __syncthreads();
  // this block's share of the poisoned words, by index
  int np = 0;
  for (int w = blockIdx.x * kThreads + threadIdx.x; w < B; w += gridDim.x * kThreads)
    np += __ldg(poison + w) != 0;
  np = __reduce_add_sync(kFull, np);
  if (lane == 0 && np) atomicAdd(&s_poison, np);

  const int base = (blockIdx.x * kThreads + threadIdx.x) & ~31;  // the warp's 32 slots
  if (base < N) {
    const int p = base + lane;
    const int32_t s = p < N ? __ldg(out + p) : -1;
    int c0 = base - 32;  // the step before, for the symbol before the first
    int32_t v = c0 >= 0 ? __ldg(out + c0 + lane) : -1;
    const int wc = warp_word_of(offs, B, base, lane);
    const int ws0 = __ldg(offs + wc);
    const int32_t nxt = wc + 1 + lane <= B ? __ldg(offs + wc + 1 + lane) : 0x7FFFFFFF;
    // lane's word: wc + the starts among the next 32 at or before p
    int cnt = 0;
#pragma unroll
    for (int k = 16; k >= 1; k >>= 1) {
      const int32_t o = __shfl_sync(kFull, nxt, cnt + k - 1);
      if (o <= p) cnt += k;
    }
    const int32_t o31 = __shfl_sync(kFull, nxt, 31);
    if (cnt == 31 && o31 <= p) cnt = 32;
    const int32_t o_prev = __shfl_sync(kFull, nxt, max(cnt - 1, 0));
    int w = wc + cnt;
    int wstart = cnt > 0 ? o_prev : ws0;
    if (o31 <= base + 31) {  // 32 starts or more in the step (empty words)
      w = lane_word_of(offs, B, p);
      wstart = __ldg(offs + w);
    }
    // the last symbol before the step, as far back as the step's first word
    int cq = -1;
    int32_t ca = 0;
    while (true) {
      const unsigned mm = __ballot_sync(kFull, v >= 0);
      if (mm) {
        cq = c0 + 31 - __clz(mm);
        ca = __shfl_sync(kFull, v, 31 - __clz(mm));
        break;
      }
      if (c0 <= ws0) break;
      c0 -= 32;
      v = c0 + lane >= 0 ? __ldg(out + c0 + lane) : -1;
    }
    // the symbol before this lane's: in the step, or the one before it
    const bool live = s >= 0;
    const unsigned below = __ballot_sync(kFull, live) & ((1u << lane) - 1u);
    const int src = below ? 31 - __clz(below) : 0;
    const int32_t a_in = __shfl_sync(kFull, s, src);
    const int q = below ? base + src : cq;
    const int32_t a = below ? a_in : ca;
    int32_t f = 0;
    if (live && w < B && q >= wstart && __ldg(poison + w) == 0) f = __ldg(freqs + w);
    uint32_t row = 0;
    const bool claimed = f > 0 && insert_pair(table, mask, (a << 16) | s, f, &row);
    const unsigned cm = __ballot_sync(kFull, claimed);
    if (cm) {
      const int leader = __ffs(cm) - 1;
      int b0 = 0;
      if (lane == leader) b0 = atomicAdd(&s_n, __popc(cm));
      b0 = __shfl_sync(kFull, b0, leader);
      if (claimed) s_rows[b0 + __popc(cm & ((1u << lane) - 1u))] = (int32_t)row;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_n) s_base = atomicAdd(head, s_n);
    if (s_poison) atomicAdd(head + 1, s_poison);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s_n; i += kThreads) rows[s_base + i] = s_rows[i];
}

__global__ void __launch_bounds__(kThreads)
pair_compact_kernel(int2* __restrict__ table, const int32_t* __restrict__ rows,
                    int32_t* __restrict__ head, int32_t* __restrict__ res) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int n = __ldcg(head);
  int2* kv = reinterpret_cast<int2*>(res + 2);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const int32_t r = __ldcg(rows + i);
    kv[i] = __ldcg(table + r);
    table[r] = make_int2(-1, 0);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    res[0] = n;
    res[1] = __ldcg(head + 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(head + 2, 1) == (int)gridDim.x - 1) {  // every block has read the head
      head[0] = 0;
      head[1] = 0;
      head[2] = 0;
    }
  }
}

int blocks_for(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

template <typename K>
int shape_of(K kernel, int threads, int* info) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  if (err != cudaSuccess) return (int)err;
  const int shape[] = {threads, fa.numRegs, (int)fa.sharedSizeBytes, (int)fa.localSizeBytes,
                       blocks};
  for (int i = 0; i < 5; ++i) info[i] = shape[i];
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// K18: chars [N], offs [B + 1], lens [B] int32, the word groups (0 <= n8
// <= n16 <= B); table [T] int4 (16-byte aligned; (len << 16) | sym in each
// filled row's fourth word), t_mask = T - 1; slot_meta [S] int2; slot_chars
// [S, 128]; fb_map [2, 0x110000]; lt_cap 1..128 -> out [N] int32, poison
// [B] int32
int ctok_train_match(const void* chars, const void* offs, const void* lens, int n8, int n16,
                     int B, const void* table, unsigned t_mask, const void* slot_meta,
                     const void* slot_chars, const void* fb_map, int lt_cap, void* out,
                     void* poison, void* stream) {
  if (B < 0 || n8 < 0 || n8 > n16 || n16 > B || lt_cap < 1 || lt_cap > kMaxW ||
      (t_mask & (t_mask + 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (lt_cap <= 8) {
    n8 = n16 = B;
  } else if (lt_cap <= 16) {
    n16 = B;
  }
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

int ctok_train_match_info(int* info) {
  return shape_of(train_match_kernel, kMatchWarps * 32, info);
}

// K19: out [N], offs [B + 1], freqs [B], poison [B] int32; table [T] int2
// (8-byte aligned, every row (-1, 0) on entry and on return; T a power of
// two, at least 2 N), rows [T / 2] int32, head [4] int32 (zero on entry and
// on return), res [2 + T] int32 (res + 2 8-byte aligned) -> res: the keys'
// number, the poisoned words' number, the (key, count) pairs
int ctok_pair_count(const void* out, int N, const void* offs, const void* freqs,
                    const void* poison, int B, void* table, int T, void* rows, void* head,
                    void* res, void* stream) {
  if (N < 0 || B < 0 || T < 64 || (T & (T - 1)) != 0 || (int64_t)2 * N > T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int2* tab = static_cast<int2*>(table);
  int32_t* hd = static_cast<int32_t*>(head);
  if (N > 0 || B > 0) {
    pair_insert_kernel<<<max(blocks_for(N), 1), kThreads, 0, s>>>(
        static_cast<const int32_t*>(out), N, static_cast<const int32_t*>(offs),
        static_cast<const int32_t*>(freqs), static_cast<const int32_t*>(poison), B, tab,
        (uint32_t)(T - 1), static_cast<int32_t*>(rows), hd);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)ctok::launch_dependent(pair_compact_kernel,
                                     dim3(min(max(blocks_for(N), 1), kCompactMaxBlocks)),
                                     dim3(kThreads), 0, s, tab,
                                     static_cast<const int32_t*>(rows), hd,
                                     static_cast<int32_t*>(res));
}

int ctok_pair_count_info(int* info) { return shape_of(pair_insert_kernel, kThreads, info); }

}  // extern "C"
