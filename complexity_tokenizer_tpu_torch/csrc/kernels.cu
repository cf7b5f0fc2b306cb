// Hand-written CUDA kernels of the device encode pipeline, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// complexity_tokenizer_tpu_torch/utils/cuda_build.py; no PyTorch headers.
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() of its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "chd_hash.cuh"

namespace {

constexpr uint32_t kMiss = 0xFFFFFFFFu;  // empty cuckoo slot / no pair

// ---------------------------------------------------------------------------
// K1: byte -> token seed.
//
// Replaces pallas_seed_tokens (complexity_tokenizer_tpu/ops/pallas_kernels.py)
// and its XLA twin merge.seed_tokens: out[r, i] = table[arr[r, i]] where
// i < lens[r], else -1.
//
// Bound: bytes.  Each byte before lens[r] read once (1 B) and each token
// written once (4 B), so most of the traffic is stores; at the main path's
// [8192, 512] batch that is 19.2 MB, about 5.7 us at 3.35 TB/s.  (The
// kernel reads whole rows: skipping the loads past lens[r] was slower.)
// At the main path's smaller batches the launch sets the time: one launch
// with almost no work takes 1.5 us.  The
// TPU kernel split the table on its high bit to fit Mosaic's 128-lane
// gather; here the 256-entry table sits in shared memory, and the text's
// bank conflicts cost nothing measurable (the same time on one repeated
// byte as on text or random bytes).
//
// Design: a streaming kernel.
// - Segments.  A row is cut into segments of 128 bytes (the last may be
//   short).  A warp takes kSeedUnroll consecutive segments (in row-major
//   order) per step: each lane loads 4 bytes of each (one coalesced 128 B
//   load per segment) and stores their 4 tokens as one int4 (one contiguous
//   512 B store per segment).  The segments' rows and columns come from one
//   division per step and an increment per segment; lens[r] is one
//   broadcast load per segment.
// - Latency.  All loads of a step are issued before any is used, and the
//   next step's loads before this step's stores.  The first step's loads
//   are issued before the block stages the table, so those round trips
//   overlap.
// - Registers.  Only the step's bytes and lengths stay in registers; the
//   rows are walked again at the store.  With 32 registers a thread, 8
//   blocks of 256 fit an SM, so the grid at [8192, 512] is one wave.
// - Persistent grid: at most the card's resident blocks (SMs x blocks per
//   SM, read once per device), each staging the table once and striding
//   over the steps.
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), warm (inputs and
// output in L2) / cold (none of them): [16, 4096] 1.7 / 2.1 us, [8192, 128]
// 3.0 / 4.0 us, [8192, 512] 6.7-6.9 / 8.8-8.9 us, 64-65% of the bound.
// Requires W % 16 == 0 and 16-byte-aligned rows (checked by the wrapper;
// the kernel itself needs W % 4 == 0 and 4-byte-aligned rows).
constexpr int kSeedThreads = 256;   // one table entry per thread
constexpr int kSeedUnroll = 4;      // segments per warp step
constexpr int kSeedMinBlocks = 8;   // 32 registers: a one-wave grid resident

struct SeedStep {
  int len[kSeedUnroll];
  uint32_t bytes[kSeedUnroll];
};

// The segments of one warp step: calls f(k, row, col, live) for each.
template <typename F>
__device__ __forceinline__ void seed_walk(int B, int W, int S, uint32_t step,
                                          int lane, F f) {
  const uint32_t s0 = step * kSeedUnroll;
  uint32_t row = s0 / (uint32_t)S;
  int seg = (int)(s0 - row * (uint32_t)S);
#pragma unroll
  for (int k = 0; k < kSeedUnroll; ++k) {
    const int col = seg * 128 + 4 * lane;
    f(k, row, col, row < (uint32_t)B && col < W);
    if (++seg == S) {
      seg = 0;
      ++row;
    }
  }
}

__device__ __forceinline__ void seed_load(const uint8_t* __restrict__ arr,
                                          const int32_t* __restrict__ lens,
                                          int B, int W, int S, uint32_t step,
                                          int lane, SeedStep& s) {
  seed_walk(B, W, S, step, lane, [&](int k, uint32_t row, int col, bool live) {
    s.len[k] = row < (uint32_t)B ? __ldg(lens + row) : 0;
    s.bytes[k] = live ? __ldg(reinterpret_cast<const uint32_t*>(
                            arr + (int64_t)row * W + col))
                      : 0u;
  });
}

__device__ __forceinline__ int4 seed_tokens4(const int32_t* __restrict__ tab,
                                             uint32_t w, int c, int len) {
  int4 o;
  o.x = c + 0 < len ? tab[(w >> 0) & 0xFF] : -1;
  o.y = c + 1 < len ? tab[(w >> 8) & 0xFF] : -1;
  o.z = c + 2 < len ? tab[(w >> 16) & 0xFF] : -1;
  o.w = c + 3 < len ? tab[(w >> 24) & 0xFF] : -1;
  return o;
}

// The step's rows are walked again here rather than kept in registers
__device__ __forceinline__ void seed_store(const int32_t* __restrict__ tab,
                                           int32_t* __restrict__ out, int B,
                                           int W, int S, uint32_t step,
                                           int lane, const SeedStep& s) {
  seed_walk(B, W, S, step, lane, [&](int k, uint32_t row, int col, bool live) {
    if (live)
      *reinterpret_cast<int4*>(out + (int64_t)row * W + col) =
          seed_tokens4(tab, s.bytes[k], col, s.len[k]);
  });
}

// steps = ceil(B * S / kSeedUnroll) with S = ceil(W / 128) segments a row
__global__ void __launch_bounds__(kSeedThreads, kSeedMinBlocks)
    seed_tokens_kernel(const uint8_t* __restrict__ arr,
                       const int32_t* __restrict__ lens,
                       const int32_t* __restrict__ table,
                       int32_t* __restrict__ out, int B, int W, int S,
                       uint32_t steps) {
  __shared__ int32_t tab[256];
  constexpr int kWarps = kSeedThreads / 32;
  const int lane = threadIdx.x & 31;
  const uint32_t stride = gridDim.x * kWarps;
  uint32_t step = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int32_t entry = __ldg(table + threadIdx.x);
  SeedStep cur;
  if (step < steps) seed_load(arr, lens, B, W, S, step, lane, cur);
  tab[threadIdx.x] = entry;
  __syncthreads();
  if (step >= steps) return;
  for (;;) {
    const uint32_t next = step + stride;
    const bool more = next < steps;
    SeedStep nxt;
    if (more) seed_load(arr, lens, B, W, S, next, lane, nxt);
    seed_store(tab, out, B, W, S, step, lane, cur);
    if (!more) return;
    cur = nxt;
    step = next;
  }
}

// ---------------------------------------------------------------------------
// K2 and K5: segmented BPE merge fixpoint, one walk over two pair tables.
//
// K2 replaces the jax.lax.while_loop of _segmented_fixpoint / merge_words_qc
// (complexity_tokenizer_tpu/ops/merge.py) with its probe qc_lookup_jnp,
// mix_hash_jnp and mix_hash2_jnp (ops/hashtable.py): the two-choice cuckoo
// table of the vocabularies that fit u16 (QcProbe).  K5 replaces the same
// loop in merge_words (ops/merge.py) with its probe chd_lookup_rows_jnp: the
// CHD table of the vocabularies past u16 (ChdProbe).  Each gives bit for bit
// the (tokens, count) of its plain twin merge_fixpoint_qc_plain /
// merge_fixpoint_chd_plain (ops/merge.py): merged ids at the leftmost byte
// of their span, -1 tombstones elsewhere, per-row counts of live ids.  The
// walk below is templated over the probe; only the probe and the width of
// a cached probe differ.
//
// Words.  A word is a maximal run of equal wid >= 0.  A pair is an alive
// token and the next alive token of the same word (an OOV byte, table entry
// -1, is a tombstone from the start and is skipped), so words never
// interact and each runs to its own fixpoint.
//
// Greedy apply.  The JAX step merges, in each word, every occurrence of the
// word's minimum-rank pair except one whose previous alive pair also matches:
// in a run "a a a a a" only the pair 0-1.  This kernel applies every
// non-overlapping occurrence, greedily from left to right (0-1 and 2-3), and
// reaches the same fixpoint: ranks are unique per pair, so two best pairs
// overlap only in a run of one token a.  The pipeline takes only well-formed
// tables (ops/pipeline.py, core/bpe.py:merges_well_formed): every pair that
// contains merge r's product ranks after r.  After the JAX step merges the
// leading "a a" of a run, the two pairs it creates hold the product, so they
// rank after the run's pair, and the next step merges the next leftmost
// "a a" of the same run, and so on: the one-merge-per-step order, which is
// the greedy order.  Greedy does the same merges in one step; the JAX rule
// needs about n/2 steps for a run of n.  On a table that is not well-formed
// the two differ, as the device pipeline's refusal of such tables says.
//
// Cached probes.  Each alive position keeps its probed (rank, minted) entry
// (or a miss) in shared memory, probed once: K2 packs rank<<16|minted in a
// u32, K5 rank<<32|minted in a u64 (past u16 both need 17 bits or more).
// Taking the pair at an alive entry changes only its own pair and the pair
// of the kept entry before it, so only those are probed again; the word's
// minimum comes from the cached values.  The minimum is taken over the
// entry's 32-bit key (K2: the whole entry; K5: the rank), kMiss for a miss.
// Ranks are unique, so the minimum key is the minimum rank and equal keys
// are equal pairs with one minted id: a taken entry writes its own.  At
// most two probes per merge.
//
// Alive list.  Each word walks a compacted list of its alive positions
// (uint16 in `aux`, over the word's own range, compacted in place every
// step), never a scan over tombstones.
//
// Work.  One block owns one row in shared memory, 14 B a position for K2
// and 18 B for K5: tokens 4 B, cached probes 4 B (K2) or 8 B (K5), the alive
// lists, the row's word-boundary list (from a block-wide scan) and its short
// words sorted by length, 2 B each.
// The block has a quarter of the row's width in threads, 64 to 1,024.
// - Words of more than kWarpWordBytes bytes go to a whole warp each; warps
//   take 32 boundaries at a time from a shared counter.  A warp word takes
//   its minimum key with __reduce_min_sync (32-bit only, hence the key),
//   its best pairs as a __ballot_sync
//   mask per chunk of 32 alive entries, the greedy pick inside a run of
//   consecutive best pairs from the mask (the run's start from __clz, its
//   parity carried across chunks), the compaction from a second ballot, and
//   probes a chunk's changed pairs in parallel (marked by kFlag).
// - The other words go to one thread each, longest first (a counting sort
//   by length, so a warp's lanes walk words of about equal work); warps
//   take 32 of them at a time from a second counter.  A thread word runs
//   each step as one pass: pick, compact, probe the changed pairs, minimum.
//
// Bound.  Device memory sees each row once in and once out (12 B a
// position) plus the table entries of each probe (K2: two 8-byte rows; K5: a
// 4-byte displacement and a 16-byte row); the work is the word's initial
// pairs plus at most two probes per merge.  What limits it is latency and
// issue: each step of a word waits on its probes in L2 (K2's table is about
// a megabyte, two independent reads; K5's is 4 MB of rows and 256 KB of
// displacements at 100,000 ids, two dependent reads) after a serial walk
// of the word in shared memory.  A word pack is one wave of blocks, so its
// time is the serial chain of its slowest word.
//
// K5's rounds (ChdProbe::kBatched; K2 keeps the walk described above).
// The chain of a word is made of round trips to L2, so K5 keeps every
// probe a step needs in flight at once:
// - First round.  Once the row is in shared memory (the word starts and
//   gaps as flags in `aux`, from each lane's word id and its left
//   neighbour's), every thread probes the pair of each of kChdFirst alive
//   positions, i = g0 + k * threads + tid: all displacement reads, then
//   all row reads (ChdProbe::round).  The walks start with their caches
//   full; a word's n - 1 initial probes cost one round, not n - 1.
// - A thread word's step queues the pairs it changes (kChdQueue in
//   registers, `left | right << 16`) and probes them in one round when the
//   queue is full or the pass ends.
// - A warp word's step gathers its marked entries from all chunks into one
//   slot a lane (ballot, nth_set_bit, a shuffle) and probes 32 at a time:
//   a step of a 128-entry word waits on one round, not four.
// - No barrier between long and short words: a counting sort puts every
//   word of two bytes or more in `order` (long words first, then short
//   ones longest first) before the walks; a warp takes long words one at
//   a time and, when none is left, short words 32 at a time.
// - Launch bounds by block size (kChdSmallSmThreads, kChdSmThreads): at
//   K2's 32 registers the rounds spill, and spills cost more than the
//   resident blocks they buy; 64- and 1,024-thread blocks get 48
//   registers, the others 40 (12 blocks of 128 threads an SM).
// - The search for a pair in the first round stops after kChdReach
//   tombstones (kPendingEntry): one lane would otherwise walk a run of OOV
//   bytes alone, 1,000 positions in a row of one OOV letter.
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, the same call as
// K2's walk on these rows; scripts/study_k5_variants.py for the
// constants), warm at 100,000 ids: 0.0154 ms a [1024, 128] word pack
// (probe by probe: 0.0226), 0.0233 ms the [256, 128] pack of the longest
// words (0.0441), 0.029 / 0.032 / 0.148 ms at [16, 4096] / [8192, 128] /
// [8192, 512] (0.051 / 0.041 / 0.169), one 4,096-byte word of one letter
// 0.077 ms (0.087).  Still 6-9x the bytes bound at the full packs and
// batches and about 75x at the small ones: what is left is the serial walk
// of a word's steps in shared memory and the launch.  At 32 registers
// (94-110 B spilled a thread) K5 is 13-32% slower; at 48 everywhere,
// [8192, 512] loses 6% for its fewer resident blocks; a queue of 2 or 8,
// 128-thread blocks for short rows and a warp threshold of 16 do no better.
constexpr int kWarpWordBytes = 32;  // longer words are walked by a whole warp
constexpr uint16_t kFlag = 0x8000;  // alive list: probe again; boundaries: gap
constexpr uint16_t kPosMask = 0x7FFF;
constexpr uint32_t kFull = 0xFFFFFFFFu;
// K5 only (see "K5's rounds" above)
constexpr int kChdWarpWordBytes = 32;  // longer words are walked by a warp
constexpr int kChdSmallThreads = 64;   // threads of a block for rows <= 256
// launch bounds, threads per SM: for the blocks of kChdSmallThreads and
// for the wider ones (registers a thread: 65,536 over these)
constexpr int kChdSmallSmThreads = 1024;
constexpr int kChdSmThreads = 1536;
constexpr int kChdFirst = 2;           // positions a thread probes per round
constexpr int kChdQueue = 4;           // a thread word's re-probes per round
constexpr int kChdReach = 8;  // the first round looks this far for a pair
static_assert(kChdWarpWordBytes <= 32, "one warp scans the length buckets");

// A probe policy: the cached Entry, its miss value, the probe, the 32-bit
// key whose minimum picks a word's best pair, and the minted id.

// K2: the u16 two-choice cuckoo table; an entry is rank << 16 | minted.
struct QcProbe {
  using Entry = uint32_t;
  static constexpr Entry kMissEntry = kMiss;
  static constexpr bool kBatched = false;  // probes each pair as the walk reaches it
  const uint2* __restrict__ t1;
  const uint2* __restrict__ t2;
  uint32_t mask;

  // rank << 16 | minted for the pair (a, b), or kMiss.
  __device__ __forceinline__ Entry probe(int32_t a, int32_t b) const {
    const uint32_t ua = (uint32_t)a, ub = (uint32_t)b;
    const uint32_t k = (ua << 16) | ub;
    if (k == kMiss) return kMiss;  // the sentinel key never hits
    const uint2 r1 = __ldg(t1 + (mix_hash(ua, ub) & mask));
    const uint2 r2 = __ldg(t2 + (mix_hash2(ua, ub) & mask));
    if (r1.x == k) return r1.y;
    if (r2.x == k) return r2.y;
    return kMiss;
  }
  static __device__ __forceinline__ uint32_t key(Entry v) { return v; }
  static __device__ __forceinline__ int32_t minted(Entry v) {
    return (int32_t)(v & 0xFFFFu);
  }
};

// K5: the CHD table, rows (key_a, key_b, rank, minted) of 16 B; an entry is
// rank << 32 | minted.  Empty rows hold -1 keys, which no pair of ids >= 0
// matches, and ranks stay below INF_RANK = 0x3FFFFFFF, so a hit's key is
// never kMiss.
struct ChdProbe {
  using Entry = uint64_t;
  static constexpr Entry kMissEntry = ~0ull;
  // the first round found no alive position within kChdReach: the walk
  // probes this pair (its key is kMiss's, so it counts for no minimum)
  static constexpr Entry kPendingEntry = ~1ull;
  static constexpr bool kBatched = true;  // probes issued in rounds
  const int32_t* __restrict__ disp;
  const int4* __restrict__ rows;
  uint32_t size_mask;
  uint32_t bucket_mask;
  uint32_t zero = 0;  // 0 at run time, which ptxas cannot see (round)

  // slot = (mix2(a, b) + disp[mix1(a, b) & (B - 1)]) & (T - 1): the row
  // read waits on the displacement read.  In two halves, so that a round
  // issues all its displacement reads before any row read.
  __device__ __forceinline__ int32_t disp_of(int32_t a, int32_t b) const {
    return __ldg(disp + (mix_hash((uint32_t)a, (uint32_t)b) & bucket_mask));
  }
  __device__ __forceinline__ int4 row_of(int32_t a, int32_t b, int32_t d) const {
    return __ldg(rows + ((mix_hash2((uint32_t)a, (uint32_t)b) + (uint32_t)d) & size_mask));
  }
  static __device__ __forceinline__ Entry entry(int32_t a, int32_t b, int4 r) {
    if (r.x != a || r.y != b) return kMissEntry;
    return ((uint64_t)(uint32_t)r.z << 32) | (uint32_t)r.w;
  }
  __device__ __forceinline__ Entry probe(int32_t a, int32_t b) const {
    return entry(a, b, row_of(a, b, disp_of(a, b)));
  }
  // One round over the pairs (a[i], b[i]) with live[i]: every displacement
  // read, then every row read, then the compares; a dead pair is a miss.
  // Each row read takes every displacement (masked by `zero`), and each
  // compare every row, so that ptxas cannot issue a pair's row read right
  // after its own displacement read and compare it before the next pair's
  // reads: in K6's kernel it did, two L2 latencies a pair instead of two a
  // round.
  template <int N>
  __device__ __forceinline__ void round(const int32_t (&a)[N], const int32_t (&b)[N],
                                        const bool (&live)[N], Entry (&v)[N]) const {
    int32_t d[N];
    int4 r[N];
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = live[i] ? disp_of(a[i], b[i]) : 0;
    int32_t all_d = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) all_d ^= d[i];
    all_d &= (int32_t)zero;
#pragma unroll
    for (int i = 0; i < N; ++i)
      r[i] = live[i] ? row_of(a[i], b[i], d[i] + all_d) : make_int4(-1, -1, 0, 0);
    int32_t all_r = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) all_r ^= r[i].x;
    all_r &= (int32_t)zero;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      r[i].x ^= all_r;
      v[i] = live[i] ? entry(a[i], b[i], r[i]) : kMissEntry;
    }
  }
  static __device__ __forceinline__ uint32_t key(Entry v) {
    return (uint32_t)(v >> 32);
  }
  static __device__ __forceinline__ int32_t minted(Entry v) {
    return (int32_t)(uint32_t)v;
  }
};

// --- one thread per word ----------------------------------------------------

// Runs the word [p, e) of the shared row to its fixpoint on one thread.
// Each step is one pass over the word's alive list aux[0, m): it takes the
// step's best pairs greedily, compacts the list in place, probes a kept
// entry's pair as soon as its right neighbour is final (only where the step
// changed the pair) and takes the minimum for the next step.  A cached
// value read before its entry is reached is the old pair's, which is what
// the greedy pick compares.
template <class P>
__device__ void thread_word(int32_t* t, typename P::Entry* rm,
                            uint16_t* aux_row, int p, int e, const P& tb) {
  using Entry = typename P::Entry;
  uint16_t* aux = aux_row + p;
  int m = 0, left = -1;
  uint32_t best = kMiss;
  for (int q = p; q < e; ++q) {
    if (t[q] < 0) continue;
    if (left >= 0) {
      const Entry v = tb.probe(t[left], t[q]);
      rm[left] = v;
      best = min(best, P::key(v));
    }
    aux[m++] = (uint16_t)q;
    left = q;
  }
  if (left >= 0) rm[left] = P::kMissEntry;
  while (best != kMiss) {
    uint32_t next = kMiss;
    int out = 0;
    int lpos = -1;          // the last kept entry
    bool lchanged = false;  // its pair changed in this step
    bool consumed = false;  // the entry is the right token of a taken pair
    for (int k = 0; k < m; ++k) {
      const int pos = aux[k];
      if (consumed) {
        t[pos] = -1;
        consumed = false;
        continue;
      }
      const Entry v = rm[pos];
      const bool taken = P::key(v) == best;
      if (taken) {
        t[pos] = P::minted(v);
        consumed = true;
      }
      if (lpos >= 0) {  // the pair (lpos, pos) is final
        Entry lv = rm[lpos];
        if (lchanged || taken) {
          lv = tb.probe(t[lpos], t[pos]);
          rm[lpos] = lv;
        }
        next = min(next, P::key(lv));
      }
      aux[out++] = (uint16_t)pos;
      lpos = pos;
      lchanged = taken;
    }
    // the last kept entry has no pair; unless taken, it was the last before
    if (lchanged) rm[lpos] = P::kMissEntry;
    m = out;
    best = next;
  }
}

// --- one warp per word ------------------------------------------------------

// Probes the marked (kFlag) entries of the alive list aux[0, m), a chunk of
// 32 at a time in parallel, clears their marks and returns the word's
// minimum key.
template <class P>
__device__ uint32_t warp_probe_pass(const int32_t* t, typename P::Entry* rm,
                                    uint16_t* aux, int m, const P& tb,
                                    int lane) {
  uint32_t mn = kMiss;
  for (int base = 0; base < m; base += 32) {
    const int k = base + lane;
    const uint16_t a = k < m ? aux[k] : 0;
    const uint16_t an = k + 1 < m ? aux[k + 1] : 0;
    __syncwarp();  // lane k-1 has read slot k before lane k rewrites it
    const int pos = a & kPosMask;
    typename P::Entry v = P::kMissEntry;
    if (k < m) {
      if (a & kFlag) {
        if (k + 1 < m) v = tb.probe(t[pos], t[an & kPosMask]);
        rm[pos] = v;
        aux[k] = (uint16_t)pos;
      } else {
        v = rm[pos];
      }
    }
    mn = min(mn, P::key(v));
  }
  __syncwarp();
  return __reduce_min_sync(kFull, mn);
}

// One greedy step of a warp word; returns the new length of its alive list.
template <class P>
__device__ int warp_apply(int32_t* t, const typename P::Entry* rm,
                          uint16_t* aux, int m, uint32_t best, int lane) {
  const uint32_t lt = (1u << lane) - 1u;
  int out = 0;
  uint32_t carry = 0;  // the previous chunk's last entry was taken
  for (int base = 0; base < m; base += 32) {
    const int k = base + lane;
    const bool valid = k < m;
    const int pos = valid ? aux[k] : 0;
    const typename P::Entry v = valid ? rm[pos] : P::kMissEntry;
    const uint32_t isb = __ballot_sync(kFull, valid && P::key(v) == best);
    // taken = best and the entry before not taken: inside a run of
    // consecutive best entries every second one from the run's start, the
    // parity shifted by one where the run goes on from a taken entry
    const uint32_t below = ~isb & lt;
    const int run_start = below ? 32 - __clz(below) : 0;
    const int parity = lane - run_start + (run_start == 0 ? (int)carry : 0);
    const bool sel = ((isb >> lane) & 1u) && !(parity & 1);
    const uint32_t S = __ballot_sync(kFull, sel);
    const bool consumed = (((S << 1) | carry) >> lane) & 1u;
    const bool keep = valid && !consumed;
    const uint32_t K = __ballot_sync(kFull, keep);
    const int nidx = out + __popc(K & lt);
    __syncwarp();  // every slot of the chunk is read before any is rewritten
    if (sel) t[pos] = P::minted(v);
    if (valid && consumed) t[pos] = -1;
    if (keep) {
      const bool again = sel || (lane < 31 && ((S >> (lane + 1)) & 1u));
      aux[nidx] = (uint16_t)(pos | (again ? kFlag : 0));
    }
    // the last kept entry of the chunk before: its right neighbour changed
    if (lane == 0 && sel && out > 0) aux[out - 1] |= kFlag;
    out += __popc(K);
    carry = S >> 31;
  }
  __syncwarp();
  return out;
}

// Runs the word [p, e) of the shared row to its fixpoint on a whole warp.
template <class P>
__device__ void warp_word(int32_t* t, typename P::Entry* rm,
                          uint16_t* aux_row, int p, int e, const P& tb,
                          int lane) {
  uint16_t* aux = aux_row + p;
  const uint32_t lt = (1u << lane) - 1u;
  int m = 0;
  for (int base = p; base < e; base += 32) {
    const int q = base + lane;
    const bool alive = q < e && t[q] >= 0;
    const uint32_t A = __ballot_sync(kFull, alive);
    if (alive) aux[m + __popc(A & lt)] = (uint16_t)(q | kFlag);
    m += __popc(A);
  }
  __syncwarp();
  uint32_t best = warp_probe_pass(t, rm, aux, m, tb, lane);
  while (best != kMiss) {
    m = warp_apply<P>(t, rm, aux, m, best, lane);
    best = warp_probe_pass(t, rm, aux, m, tb, lane);
  }
}

// --- K5: the walks with their probes in rounds --------------------------------

// Probes the queued pairs q[0, n) (left | right << 16) of a thread word in
// one round, caches them at their left entries and returns the least key.
__device__ __forceinline__ uint32_t chd_flush(const int32_t* t, uint64_t* rm,
                                              const uint32_t (&q)[kChdQueue],
                                              int n, const ChdProbe& tb) {
  int32_t a[kChdQueue], b[kChdQueue];
  bool live[kChdQueue];
  uint64_t v[kChdQueue];
#pragma unroll
  for (int i = 0; i < kChdQueue; ++i) {
    live[i] = i < n;
    a[i] = live[i] ? t[q[i] & 0xFFFFu] : 0;
    b[i] = live[i] ? t[q[i] >> 16] : 0;
  }
  tb.round(a, b, live, v);
  uint32_t mn = kMiss;
#pragma unroll
  for (int i = 0; i < kChdQueue; ++i) {
    if (live[i]) {
      rm[q[i] & 0xFFFFu] = v[i];
      mn = min(mn, ChdProbe::key(v[i]));
    }
  }
  return mn;
}

// thread_word with the cache full from the row's first round: each step's
// pass queues the pairs it changes instead of probing each as it reaches
// it, and probes them kChdQueue at a time in one round (the pass writes
// behind itself only, so a flush in the middle of it is safe).
__device__ void thread_word_chd(int32_t* t, uint64_t* rm, uint16_t* aux_row,
                                int p, int e, const ChdProbe& tb) {
  uint16_t* aux = aux_row + p;
  int m = 0, left = -1;
  uint32_t best = kMiss;
  uint64_t lv = ChdProbe::kMissEntry;  // the entry cached at `left`
  for (int r = p; r < e; ++r) {
    if (t[r] < 0) continue;
    if (lv == ChdProbe::kPendingEntry) {  // a pair the first round left (rare)
      lv = tb.probe(t[left], t[r]);
      rm[left] = lv;
      best = min(best, ChdProbe::key(lv));
    }
    lv = rm[r];
    aux[m++] = (uint16_t)r;
    best = min(best, ChdProbe::key(lv));
    left = r;
  }
  if (lv == ChdProbe::kPendingEntry) rm[left] = ChdProbe::kMissEntry;
  while (best != kMiss) {
    uint32_t next = kMiss;
    int out = 0, lpos = -1, nq = 0;
    bool lchanged = false, consumed = false;
    uint32_t q[kChdQueue] = {};
    uint32_t lkey = kMiss;  // the key cached at lpos
    for (int k = 0; k < m; ++k) {
      const int pos = aux[k];
      if (consumed) {
        t[pos] = -1;
        consumed = false;
        continue;
      }
      const uint64_t v = rm[pos];
      const bool taken = ChdProbe::key(v) == best;
      if (taken) {
        t[pos] = ChdProbe::minted(v);
        consumed = true;
      }
      if (lpos >= 0) {  // the pair (lpos, pos) is final
        if (lchanged || taken) {
#pragma unroll
          for (int i = kChdQueue - 1; i > 0; --i) q[i] = q[i - 1];
          q[0] = (uint32_t)lpos | ((uint32_t)pos << 16);
          if (++nq == kChdQueue) {
            next = min(next, chd_flush(t, rm, q, nq, tb));
            nq = 0;
          }
        } else {
          next = min(next, lkey);
        }
      }
      aux[out++] = (uint16_t)pos;
      lpos = pos;
      lkey = ChdProbe::key(v);
      lchanged = taken;
    }
    if (lchanged) rm[lpos] = ChdProbe::kMissEntry;
    if (nq) next = min(next, chd_flush(t, rm, q, nq, tb));
    m = out;
    best = next;
  }
}

// The n-th set bit (from 0) of x, which has more than n.
__device__ __forceinline__ int nth_set_bit(uint32_t x, int n) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int c = __popc(x & ((1u << s) - 1u));
    if (n >= c) {
      n -= c;
      x >>= s;
      pos += s;
    }
  }
  return pos;
}

constexpr uint32_t kNoRight = 0xFFFFu;  // a slot's pair has no right entry

// One lane's probe of its slot (left | right << 16), cached at the left.
__device__ __forceinline__ uint32_t chd_slot_probe(const int32_t* t, uint64_t* rm,
                                                   uint32_t slot, const ChdProbe& tb) {
  const uint32_t l = slot & 0xFFFFu, r = slot >> 16;
  const uint64_t v = r == kNoRight ? ChdProbe::kMissEntry : tb.probe(t[l], t[r]);
  rm[l] = v;
  return ChdProbe::key(v);
}

// warp_probe_pass in rounds: the marked (kFlag) entries of all chunks are
// gathered, in order, into one slot a lane (the chunk's ballot, the n-th
// marked entry's lane from nth_set_bit, a shuffle), and a round of 32
// probes goes out only when the slots are full or the list ends.  Clears
// the marks; returns the word's minimum key.
__device__ uint32_t warp_probe_chd(const int32_t* t, uint64_t* rm, uint16_t* aux,
                                   int m, const ChdProbe& tb, int lane) {
  uint32_t mn = kMiss;
  int cnt = 0;        // slots filled (the same in every lane)
  uint32_t slot = 0;  // this lane's pair
  for (int base = 0; base < m; base += 32) {
    const int k = base + lane;
    const uint16_t a = k < m ? aux[k] : 0;
    const uint32_t right = k + 1 < m ? (uint32_t)(aux[k + 1] & kPosMask) : kNoRight;
    const bool marked = k < m && (a & kFlag);
    const int pos = a & kPosMask;
    if (k < m && !marked) mn = min(mn, ChdProbe::key(rm[pos]));
    const uint32_t F = __ballot_sync(kFull, marked);
    const int n = __popc(F);
    const uint32_t pk = (uint32_t)pos | (right << 16);
    // lanes cnt.. take the chunk's marked entries in order
    int j = lane - cnt;
    uint32_t got = __shfl_sync(kFull, pk, j >= 0 && j < n ? nth_set_bit(F, j) : lane);
    if (j >= 0 && j < n) slot = got;
    __syncwarp();  // every lane has read its entries before the marks go
    if (marked) aux[k] = (uint16_t)pos;
    if (cnt + n >= 32) {  // the slots are full: one round of 32 probes
      mn = min(mn, chd_slot_probe(t, rm, slot, tb));
      const int used = 32 - cnt;  // the chunk's entries in that round
      j = lane + used;
      got = __shfl_sync(kFull, pk, j < n ? nth_set_bit(F, j) : lane);
      if (j < n) slot = got;
      cnt = n - used;
    } else {
      cnt += n;
    }
  }
  if (lane < cnt) mn = min(mn, chd_slot_probe(t, rm, slot, tb));
  __syncwarp();
  return __reduce_min_sync(kFull, mn);
}

// warp_word with the cache full from the row's first round.
__device__ void warp_word_chd(int32_t* t, uint64_t* rm, uint16_t* aux_row,
                              int p, int e, const ChdProbe& tb, int lane) {
  uint16_t* aux = aux_row + p;
  const uint32_t lt = (1u << lane) - 1u;
  int m = 0;
  uint32_t mn = kMiss;
  bool pending = false;
  for (int base = p; base < e; base += 32) {
    const int q = base + lane;
    const bool alive = q < e && t[q] >= 0;
    const uint32_t A = __ballot_sync(kFull, alive);
    if (alive) {
      const uint64_t v = rm[q];
      const bool pend = v == ChdProbe::kPendingEntry;  // probed below
      aux[m + __popc(A & lt)] = (uint16_t)(q | (pend ? kFlag : 0));
      mn = min(mn, ChdProbe::key(v));
      pending |= pend;
    }
    m += __popc(A);
  }
  __syncwarp();
  uint32_t best = __any_sync(kFull, pending) ? warp_probe_chd(t, rm, aux, m, tb, lane)
                                             : __reduce_min_sync(kFull, mn);
  while (best != kMiss) {
    m = warp_apply<ChdProbe>(t, rm, aux, m, best, lane);
    best = warp_probe_chd(t, rm, aux, m, tb, lane);
  }
}

// --- the row's block ----------------------------------------------------------

// 32-bit words of a cached probe
template <class P>
constexpr int kEntryWords = (int)(sizeof(typename P::Entry) / 4);

// K5's row: the position flags in aux until the walks take it over
constexpr uint16_t kStartBit = 1;  // the word id changes here
constexpr uint16_t kGapBit = 2;    // word id -1

// K5's first round: every thread probes the pair of each alive position
// i = g0 + k * kThreads + tid (k < kChdFirst) with the next alive position
// of its word, all displacement reads, then all row reads; the last alive
// position of a word caches a miss.  The search for the next alive position
// stops after kChdReach tombstones (one lane would otherwise walk a whole
// run of OOV bytes alone): such a position caches kPendingEntry, and its
// word's walk probes the pair.
template <int kThreads>
__device__ __forceinline__ void chd_first_round(const int32_t* t, uint64_t* rm,
                                                const uint16_t* flags, int L,
                                                const ChdProbe& tb, int tid) {
  for (int g0 = 0; g0 < L; g0 += kChdFirst * kThreads) {
    int32_t a[kChdFirst], b[kChdFirst];
    bool live[kChdFirst];
    uint64_t v[kChdFirst];
#pragma unroll
    for (int k = 0; k < kChdFirst; ++k) {
      const int i = g0 + k * kThreads + tid;
      live[k] = false;
      a[k] = b[k] = 0;
      if (i < L && t[i] >= 0 && !(flags[i] & kGapBit)) {
        int q = i + 1;
        const int reach = min(L, i + 1 + kChdReach);
        while (q < reach && !(flags[q] & kStartBit) && t[q] < 0) ++q;
        if (q == L || (flags[q] & kStartBit)) {
          rm[i] = ChdProbe::kMissEntry;
        } else if (t[q] < 0) {  // a run of tombstones longer than the reach
          rm[i] = ChdProbe::kPendingEntry;
        } else {
          live[k] = true;
          a[k] = t[i];
          b[k] = t[q];
        }
      }
    }
    tb.round(a, b, live, v);
#pragma unroll
    for (int k = 0; k < kChdFirst; ++k)
      if (live[k]) rm[g0 + k * kThreads + tid] = v[k];
  }
}

// ---------------------------------------------------------------------------
// K6: the word path's merge, from the packed bytes.
//
// Replaces the start-bit unpack, the word-id cumsum, the byte seed and the
// merge fixpoint of the JAX package's unphased fill body
// (complexity_tokenizer_tpu/ops/wordpath.py, DeviceWordEncoder.
// _local_fill_body): packed word rows -> the merged rows [B, L] int32 and
// their live counts [B], what K3 -> K1 -> K2 or K5 write.  K4 (wordfill.cu)
// then compacts them into the fused buffer: the fill is two launches,
// where it was four.  K6 is the fixpoint kernel below with a second row
// policy, FillRows: where the row comes from.  TokenRows (K2, K5) reads
// tokens and word ids.
//
// The prologue (K3 and K1): block r reads row_len, the row's bytes and its
// start bits coalesced, and puts t[i] = byte_table[byte] (-1 at and past
// row_len, and for an OOV byte) and the word start / gap flags straight
// into shared memory; no word id or seed token goes through device
// memory.  The flags are K3's word ids without the ids: a position at or
// past row_len, or before the row's first start bit, has word id -1 (a
// gap); a start is position 0, a set bit before row_len, and row_len
// itself when a word ends there.  The epilogue is the fixpoint's own.
//
// Bound: latency, as the fixpoint's.  With K4 after it, 2.8-3.7 us more
// than the fixpoint alone on tokens and word ids, K4's launch most of it.
// A one-launch design that also did K4's work (a decoupled look-back over
// the rows' counts, a row ticket, a scratch zeroed by the block counted
// last) took 3.7-8.1 us more than the fixpoint alone, and 1.7-4.4 us more
// than this kernel and K4 together on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md): its look-back waited on the slowest rows, and its ticket and
// fences came before every row's stores.

// K2 and K5: the kernel's own arguments tokens_in, wid
struct TokenRows {
  static constexpr bool kFill = false;
  static constexpr bool kWordRow = false;
};

struct FillRows {
  static constexpr bool kFill = true;
  static constexpr bool kWordRow = false;
  const uint8_t* __restrict__ bytes;       // [B, L]
  const uint8_t* __restrict__ start_bits;  // [B, L / 8], little endian
  const int32_t* __restrict__ row_len;     // [B]
  const int32_t* __restrict__ byte_table;  // [256], -1 = OOV
};

// ---------------------------------------------------------------------------
// K9: the merge fixpoint with one word a row.
//
// Replaces _word_rows_fixpoint / merge_word_rows (complexity_tokenizer_tpu/
// ops/merge.py), which CharBPE and the ByteLevel BPE model run over the
// dense symbol ids of their string merge tables (ops/stringbpe_device.py):
// tokens [B, W] int32 (-1 pads and tombstones), the row is the word ->
// merged tokens [B, W] and live counts [B], bit for bit its plain twin
// merge_word_rows_plain (ops/merge.py).  It is K5's kernel with a third row
// policy, WordRows: the prologue reads the tokens alone (no word-id tensor)
// and marks one word start, at position 0, so the walk is K5's (the first
// round, then a warp over the row's alive entries) and its greedy apply is
// that of the JAX step with one word a row: every best pair, the leading
// one winning in a run of equal symbols, on a well-formed table (the
// build refuses the others, C6).  Symbol ids run past the table's
// universe (characters no merge names, numbered after it per batch): the
// CHD probe compares both keys of a row and assumes no bound on the ids,
// so such an id never hits.
//
// Bound: latency, as K5's: each step of a word waits on its probes in L2.
// One block of 64 threads a row of 128 lanes (K5's launch for rows up to
// 256), so a batch of n words is n blocks, at least 16 resident an SM;
// the word is walked by one warp and the other waits.  On an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py): 0.227-0.228 ms for the 44,974
// distinct words of the benchmark corpus at 50K (0.241-0.243 at 100K);
// its share of the bound (the live symbols in, the dense rows out, the
// probes' table entries) is in PERF.md, section 6.
struct WordRows {
  static constexpr bool kFill = false;
  static constexpr bool kWordRow = true;
};

// K6's prologue: puts row `row`'s tokens in t and its start / gap flags in
// aux.  The bytes, start bits and length of the row are loaded together,
// and the table entry of every byte, before the length masks them.
template <int kThreads>
__device__ __forceinline__ void fill_load(const FillRows& io, int32_t* t, uint16_t* aux,
                                          int64_t row, int L, int tid) {
  __shared__ int s_first;
  if (tid == 0) s_first = L;
  __syncthreads();
  const uint8_t* rb = io.bytes + row * L;
  const uint8_t* sb = io.start_bits + row * (L / 8);
  const int len = min(max(__ldg(io.row_len + row), 0), L);
  int first = L;  // this thread's first start
#pragma unroll 4
  for (int i = tid; i < L; i += kThreads) {
    const uint8_t b = __ldg(rb + i);
    const bool bit = (__ldg(sb + (i >> 3)) >> (i & 7)) & 1;
    const int32_t v = __ldg(io.byte_table + b);
    const bool set = i < len && bit;
    t[i] = i < len ? v : -1;
    aux[i] = set ? kStartBit : 0;
    if (set) first = min(first, i);
  }
  first = __reduce_min_sync(kFull, first);
  if ((tid & 31) == 0 && first < L) atomicMin(&s_first, first);
  __syncthreads();
  first = s_first;  // the row's first start, L if none
  for (int i = tid; i < L; i += kThreads) {
    const bool start = i == 0 || (aux[i] & kStartBit) || (i == len && first < len);
    const bool gap = i >= len || i < first;
    aux[i] = (uint16_t)((start ? kStartBit : 0) | (gap ? kGapBit : 0));
  }
}

// kMinBlocks: the launch bound, resident blocks per SM (K2: 2048 threads,
// so 32 registers; K5: min_blocks_chd).  R: TokenRows (K2, K5: the rows
// are tokens_in / wid) or FillRows (K6: the rows are io's, and tokens_in
// and wid are null).  Both write tokens_out / count.
template <class P, int kThreads, int kMinBlocks, class R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
merge_fixpoint_kernel(const int32_t* __restrict__ tokens_in,
                      const int32_t* __restrict__ wid, P tb_arg,
                      int32_t* __restrict__ tokens_out,
                      int32_t* __restrict__ count, int L, R io) {
  // K5 keeps its rounds as ptxas schedules them; its `zero` is folded
  // away here, so that the masks of ChdProbe::round exist in K6 only
  P tb = tb_arg;
  if constexpr (P::kBatched && !R::kFill) tb.zero = 0;
  using Entry = typename P::Entry;
  constexpr int kWarps = kThreads / 32;
  constexpr int kEw = kEntryWords<P>;
  // the word starts and gaps as flags in aux (K5, K6), or word ids in rm
  constexpr bool kFlags = P::kBatched || R::kFill || R::kWordRow;
  extern __shared__ __align__(16) int32_t smem[];
  // [L] tokens and [L] probes; the 8-byte probes of K5 go first, aligned
  int32_t* t = kEw == 1 ? smem : smem + kEw * L;
  Entry* rm = reinterpret_cast<Entry*>(kEw == 1 ? smem + L : smem);
  // [L] lists
  uint16_t* aux = reinterpret_cast<uint16_t*>(smem + (1 + kEw) * L);
  uint16_t* bnd = aux + L;  // [L + 1] word boundaries (kFlag: a wid -1 run)
  uint16_t* order = bnd + L + 1;  // [L] short words, longest first
  __shared__ int warp_sums[kWarps];
  __shared__ int by_len[kWarpWordBytes + 1];
  __shared__ int next_chunk, next_word, n_short, block_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = (int64_t)blockIdx.x * L;
  if constexpr (R::kFill) {
    fill_load<kThreads>(io, t, aux, blockIdx.x, L, tid);
  } else if constexpr (R::kWordRow) {
    // one word, from position 0; its tombstones are skipped by the walk
    for (int i = tid; i < L; i += kThreads) {
      t[i] = tokens_in[base + i];
      aux[i] = i == 0 ? kStartBit : 0;
    }
  } else if constexpr (P::kBatched) {
    // the word starts and gaps as flags in aux, from each lane's word id
    // and its left neighbour's
    for (int i0 = 0; i0 < L; i0 += kThreads) {
      const int i = i0 + tid;
      const int32_t w = i < L ? wid[base + i] : -1;
      int32_t left = __shfl_up_sync(kFull, w, 1);
      if (lane == 0) left = i > 0 && i < L ? wid[base + i - 1] : ~w;
      if (i < L) {
        t[i] = tokens_in[base + i];
        aux[i] = (uint16_t)((i == 0 || w != left ? kStartBit : 0) | (w < 0 ? kGapBit : 0));
      }
    }
  } else {
    // word ids sit in rm's space until the boundary list is built
    for (int i = tid; i < L; i += kThreads) {
      t[i] = tokens_in[base + i];
      rm[i] = (Entry)(uint32_t)wid[base + i];
    }
  }
  if (tid == 0) {
    next_chunk = 0;
    next_word = 0;
    block_count = 0;
  }
  for (int n = tid; n <= kWarpWordBytes; n += kThreads) by_len[n] = 0;
  __syncthreads();
  if constexpr (P::kBatched) chd_first_round<kThreads>(t, rm, aux, L, tb, tid);
  auto starts = [&](int q) {
    if constexpr (kFlags) return (aux[q] & kStartBit) != 0;
    else return q == 0 || rm[q] != rm[q - 1];
  };
  auto gap = [&](int q) {
    if constexpr (kFlags) return (aux[q] & kGapBit) != 0;
    else return (int32_t)rm[q] < 0;
  };

  // boundary list: every position where the word id changes, in order,
  // from a block-wide exclusive scan of each thread's slice
  const int slice = (L + kThreads - 1) / kThreads;
  const int lo = min(L, tid * slice), hi = min(L, lo + slice);
  int c = 0;
  for (int q = lo; q < hi; ++q) c += starts(q);
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  int off = (warp > 0 ? warp_sums[warp - 1] : 0) + incl - c;
  const int nb = warp_sums[kWarps - 1];
  for (int q = lo; q < hi; ++q)
    if (starts(q)) bnd[off++] = (uint16_t)(q | (gap(q) ? kFlag : 0));
  if (tid == 0) bnd[nb] = (uint16_t)L;
  __syncthreads();

  if constexpr (P::kBatched) {
    // every word of two or more bytes in `order`, by a counting sort:
    // bucket 0 the long words, then the short ones longest first
    constexpr int kBuckets = kChdWarpWordBytes;
    auto bucket = [](int n) { return n > kChdWarpWordBytes ? 0 : kChdWarpWordBytes + 1 - n; };
    for (int k = tid; k < nb; k += kThreads) {
      const int s = bnd[k];
      const int n = (bnd[k + 1] & kPosMask) - s;
      if (!(s & kFlag) && n > 1) atomicAdd(&by_len[bucket(n)], 1);
    }
    __shared__ int n_long;
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the buckets
      const int x = lane < kBuckets ? by_len[lane] : 0;
      int s = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += y;
      }
      const int longs = __shfl_sync(kFull, x, 0);
      if (lane < kBuckets) by_len[lane] = s - x;
      if (lane == 31) {
        n_long = longs;
        n_short = s - longs;
      }
    }
    __syncthreads();
    for (int k = tid; k < nb; k += kThreads) {
      const int s = bnd[k];
      const int n = (bnd[k + 1] & kPosMask) - s;
      if (!(s & kFlag) && n > 1) order[atomicAdd(&by_len[bucket(n)], 1)] = (uint16_t)k;
    }
    __syncthreads();
    // The warps take the long words one at a time (a whole warp each); a
    // warp that finds none left goes straight on to the short words, 32 at
    // a time (a lane each), with no barrier between the two
    for (;;) {
      int j = 0;
      if (lane == 0) j = atomicAdd(&next_chunk, 1);
      j = __shfl_sync(kFull, j, 0);
      if (j >= n_long) break;
      const int k = order[j];
      warp_word_chd(t, rm, aux, bnd[k], bnd[k + 1] & kPosMask, tb, lane);
    }
    for (;;) {
      int c0 = 0;
      if (lane == 0) c0 = atomicAdd(&next_word, 32);
      c0 = __shfl_sync(kFull, c0, 0);
      if (c0 >= n_short) break;
      if (c0 + lane < n_short) {
        const int k = order[n_long + c0 + lane];
        thread_word_chd(t, rm, aux, bnd[k], bnd[k + 1] & kPosMask, tb);
      }
    }
  } else {
    // long words: a whole warp each
    for (;;) {
      int c0 = 0;
      if (lane == 0) c0 = atomicAdd(&next_chunk, 32);
      c0 = __shfl_sync(kFull, c0, 0);
      if (c0 >= nb) break;
      const int k = c0 + lane;
      bool is_long = false;
      if (k < nb) {
        const int s = bnd[k];
        is_long = !(s & kFlag) && (bnd[k + 1] & kPosMask) - s > kWarpWordBytes;
      }
      for (uint32_t lm = __ballot_sync(kFull, is_long); lm; lm &= lm - 1) {
        const int j = c0 + __ffs(lm) - 1;
        warp_word(t, rm, aux, bnd[j], bnd[j + 1] & kPosMask, tb, lane);
      }
    }
    // short words, one thread each, longest first: a counting sort by length
    // puts words of one length side by side, so the lanes of a warp walk words
    // of about equal work; warps take 32 of them at a time
    for (int k = tid; k < nb; k += kThreads) {
      const int s = bnd[k];
      const int n = (bnd[k + 1] & kPosMask) - s;
      if (!(s & kFlag) && n <= kWarpWordBytes) atomicAdd(&by_len[n], 1);
    }
    __syncthreads();
    if (tid == 0) {
      int acc = 0;
      for (int n = kWarpWordBytes; n > 0; --n) {
        const int words = by_len[n];
        by_len[n] = acc;
        acc += words;
      }
      n_short = acc;
    }
    __syncthreads();
    for (int k = tid; k < nb; k += kThreads) {
      const int s = bnd[k];
      const int n = (bnd[k + 1] & kPosMask) - s;
      if (!(s & kFlag) && n <= kWarpWordBytes) order[atomicAdd(&by_len[n], 1)] = (uint16_t)k;
    }
    __syncthreads();
    for (;;) {
      int c0 = 0;
      if (lane == 0) c0 = atomicAdd(&next_word, 32);
      c0 = __shfl_sync(kFull, c0, 0);
      if (c0 >= n_short) break;
      if (c0 + lane < n_short) {
        const int k = order[c0 + lane];
        thread_word(t, rm, aux, bnd[k], bnd[k + 1] & kPosMask, tb);
      }
    }
  }
  __syncthreads();

  int n = 0;
  for (int i = tid; i < L; i += kThreads) {
    const int32_t v = t[i];
    tokens_out[base + i] = v;
    n += v >= 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(kFull, n, o);
  if (lane == 0) atomicAdd(&block_count, n);
  __syncthreads();
  if (tid == 0) count[blockIdx.x] = block_count;
}

constexpr int min_blocks_chd(int threads) {
  return (threads == kChdSmallThreads ? kChdSmallSmThreads : kChdSmThreads) / threads;
}

template <class P, int kThreads, class R>
cudaError_t launch_merge(const int32_t* tokens_in, const int32_t* wid, P tb,
                         int32_t* tokens_out, int32_t* count, int B, int L,
                         cudaStream_t stream, int* info, R io) {
  constexpr int kMinBlocks = P::kBatched ? min_blocks_chd(kThreads) : 2048 / kThreads;
  const auto kernel = merge_fixpoint_kernel<P, kThreads, kMinBlocks, R>;
  // tokens 4 B and probes 4 or 8 B a position, alive lists, boundaries
  // (L + 1) and the sorted short words 2 B each
  const size_t smem = (size_t)(10 + 4 * kEntryWords<P>) * L + 4;
  // the kernel's static shared memory counts against the same 48 KB default
  // limit, so opt in to more dynamic shared memory well before it; once per
  // device and size, so that a launch captured in a CUDA graph makes no
  // attribute call; the opt-in and this cache belong to each instantiation
  static size_t opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 32 * 1024 && (dev >= 64 || opted[dev] < smem)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted[dev] = smem;
  }
  if (info) {  // the launch's shape instead of a launch
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    const int shape[] = {kThreads, fa.numRegs, (int)fa.sharedSizeBytes, (int)smem,
                         (int)fa.localSizeBytes, blocks};
    for (int i = 0; i < 6; ++i) info[i] = shape[i];
    return cudaSuccess;
  }
  kernel<<<B, kThreads, smem, stream>>>(
      tokens_in, wid, tb, tokens_out, count, L, io);
  return cudaGetLastError();
}

// a quarter of the row's width in threads, 64 to 1,024; with `info`, the
// launch's shape instead of a launch
template <class P, class R = TokenRows>
cudaError_t dispatch_merge(const void* tokens_in, const void* wid, P tb,
                           void* tokens_out, void* count, int B, int L,
                           void* stream, int* info = nullptr, R io = R{}) {
  if (B == 0 || L == 0) return cudaSuccess;
  if (L > kPosMask) return cudaErrorInvalidValue;  // uint16 positions
  const auto* ti = static_cast<const int32_t*>(tokens_in);
  const auto* wi = static_cast<const int32_t*>(wid);
  auto* to = static_cast<int32_t*>(tokens_out);
  auto* co = static_cast<int32_t*>(count);
  const auto s = (cudaStream_t)stream;
  constexpr int kSmall = P::kBatched ? kChdSmallThreads : 64;
  if (L <= 256) return launch_merge<P, kSmall>(ti, wi, tb, to, co, B, L, s, info, io);
  if (L <= 512) return launch_merge<P, 128>(ti, wi, tb, to, co, B, L, s, info, io);
  if (L <= 1024) return launch_merge<P, 256>(ti, wi, tb, to, co, B, L, s, info, io);
  if (L <= 2048) return launch_merge<P, 512>(ti, wi, tb, to, co, B, L, s, info, io);
  return launch_merge<P, 1024>(ti, wi, tb, to, co, B, L, s, info, io);
}

// K6 for one probe; with `info`, the launch's shape instead of a launch
template <class P>
cudaError_t dispatch_word_merge(const void* bytes, const void* start_bits, const void* row_len,
                                const void* byte_table, P tb, void* tokens_out, void* count,
                                int B, int L, void* stream, int* info = nullptr) {
  if (L % 8) return cudaErrorInvalidValue;  // a start-bit byte per 8 positions
  const FillRows io{static_cast<const uint8_t*>(bytes), static_cast<const uint8_t*>(start_bits),
                    static_cast<const int32_t*>(row_len),
                    static_cast<const int32_t*>(byte_table)};
  return dispatch_merge(nullptr, nullptr, tb, tokens_out, count, B, L, stream, info, io);
}

cudaError_t launch_seed(const uint8_t* arr, const int32_t* lens,
                        const int32_t* table, int32_t* out, int B, int W,
                        cudaStream_t stream) {
  if (B <= 0 || W <= 0) return cudaSuccess;
  const int S = (W + 127) / 128;
  const int64_t steps = ((int64_t)B * S + kSeedUnroll - 1) / kSeedUnroll;
  if (steps * kSeedUnroll >= ((int64_t)1 << 32))
    return cudaErrorInvalidValue;  // 32-bit segment indices
  // the persistent grid: SMs x resident blocks, read once per device, so
  // that a launch captured in a CUDA graph makes no attribute call
  static int resident[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int blocks = dev < 64 ? resident[dev] : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, seed_tokens_kernel, kSeedThreads, 0);
    if (err != cudaSuccess) return err;
    blocks = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) resident[dev] = blocks;
  }
  const int64_t need = (steps + kSeedThreads / 32 - 1) / (kSeedThreads / 32);
  if (need < blocks) blocks = (int)need;
  seed_tokens_kernel<<<blocks, kSeedThreads, 0, stream>>>(
      arr, lens, table, out, B, W, S, (uint32_t)steps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ctok_seed_tokens(const void* arr, const void* lens, const void* table,
                     void* out, int B, int W, void* stream) {
  return (int)launch_seed(
      static_cast<const uint8_t*>(arr), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(out), B, W,
      (cudaStream_t)stream);
}

int ctok_merge_fixpoint_qc(const void* tokens_in, const void* wid,
                           const void* t1, const void* t2, unsigned mask,
                           void* tokens_out, void* count, int B, int L,
                           void* stream) {
  const QcProbe tb{static_cast<const uint2*>(t1),
                   static_cast<const uint2*>(t2), (uint32_t)mask};
  return (int)dispatch_merge(tokens_in, wid, tb, tokens_out, count, B, L,
                             stream);
}

// rows must be 16-byte aligned (one int4 load a probe; checked by the
// wrapper)
int ctok_merge_fixpoint_chd(const void* tokens_in, const void* wid,
                            const void* disp, const void* rows,
                            unsigned size_mask, unsigned bucket_mask,
                            void* tokens_out, void* count, int B, int L,
                            void* stream) {
  const ChdProbe tb{static_cast<const int32_t*>(disp),
                    static_cast<const int4*>(rows), (uint32_t)size_mask,
                    (uint32_t)bucket_mask};
  return (int)dispatch_merge(tokens_in, wid, tb, tokens_out, count, B, L,
                             stream);
}

// K6, the word path's merge from the packed bytes, on the cuckoo table
// (K2's walk) or on the CHD table (K5's): bytes [B, L] uint8, start_bits
// [B, L/8] uint8, row_len [B] int32, byte_table [256] int32 -> tokens_out
// [B, L] int32 (merged ids, -1 elsewhere), count [B] int32 (live ids a row).
int ctok_word_merge_qc(const void* bytes, const void* start_bits, const void* row_len,
                       const void* byte_table, const void* t1, const void* t2, unsigned mask,
                       void* tokens_out, void* count, int B, int L, void* stream) {
  const QcProbe tb{static_cast<const uint2*>(t1),
                   static_cast<const uint2*>(t2), (uint32_t)mask};
  return (int)dispatch_word_merge(bytes, start_bits, row_len, byte_table, tb, tokens_out,
                                  count, B, L, stream);
}

// rows 16-byte aligned, as for ctok_merge_fixpoint_chd
int ctok_word_merge_chd(const void* bytes, const void* start_bits, const void* row_len,
                        const void* byte_table, const void* disp, const void* rows,
                        unsigned size_mask, unsigned bucket_mask, void* tokens_out,
                        void* count, int B, int L, void* stream) {
  const ChdProbe tb{static_cast<const int32_t*>(disp),
                    static_cast<const int4*>(rows), (uint32_t)size_mask,
                    (uint32_t)bucket_mask};
  return (int)dispatch_word_merge(bytes, start_bits, row_len, byte_table, tb, tokens_out,
                                  count, B, L, stream);
}

// K9, the merge fixpoint with one word a row, on the CHD table: tokens_in
// [B, L] int32 -> tokens_out [B, L] int32, count [B] int32; rows 16-byte
// aligned, as for ctok_merge_fixpoint_chd
int ctok_merge_word_rows(const void* tokens_in, const void* disp, const void* rows,
                         unsigned size_mask, unsigned bucket_mask, void* tokens_out,
                         void* count, int B, int L, void* stream) {
  const ChdProbe tb{static_cast<const int32_t*>(disp),
                    static_cast<const int4*>(rows), (uint32_t)size_mask,
                    (uint32_t)bucket_mask};
  return (int)dispatch_merge(tokens_in, nullptr, tb, tokens_out, count, B, L, stream,
                             nullptr, WordRows{});
}

// The launch shape of K2 (chd = 0) or K5 (chd = 1) for rows of L, or with
// fill = 1 that of K6 on the same table: info gets threads a block,
// registers a thread, static and dynamic shared bytes a block, local
// (spill) bytes a thread and resident blocks per SM.
int ctok_merge_fixpoint_info(int chd, int fill, int L, int* info) {
  if (fill) {
    if (chd)
      return (int)dispatch_word_merge(nullptr, nullptr, nullptr, nullptr, ChdProbe{}, nullptr,
                                      nullptr, 1, L, nullptr, info);
    return (int)dispatch_word_merge(nullptr, nullptr, nullptr, nullptr, QcProbe{}, nullptr,
                                    nullptr, 1, L, nullptr, info);
  }
  if (chd)
    return (int)dispatch_merge(nullptr, nullptr, ChdProbe{}, nullptr, nullptr, 1, L,
                               nullptr, info);
  return (int)dispatch_merge(nullptr, nullptr, QcProbe{}, nullptr, nullptr, 1, L,
                             nullptr, info);
}

const char* ctok_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
