// K7: the device batch decode's gather and compaction, hand-written for
// Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// complexity_tokenizer_tpu_torch/utils/cuda_build.py; no PyTorch headers.
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch.
//
// Replaces DecodePipeline._decode_fn of the JAX package
// (complexity_tokenizer_tpu/ops/decode.py:71-95), which XLA compiled for
// the TPU: it pads the batch to [B, T], gathers every id's bytes from a
// padded [V, W] table into [B, T, W], masks them by length and sorts each
// row's [T * W] bytes to compact them.  That layout grows with the longest
// token (W) and the longest row (T); at the corpus's 10,043 rows, one of
// them over 4,096 ids, it runs to gigabytes.  Here the ids come ragged (flat
// int32 ids, int64 row offsets) and the output is flat: the kept ids' bytes
// back to back, which is each row's concatenation in row order, and the row
// byte offsets.
//
// The function: id k is kept when 0 <= id < V and not (skip_special and id
// is special); out bytes = the concatenation of the kept ids' bytes in flat
// order; out_offsets[r] = the bytes of the kept ids before row r's first
// id, out_offsets[B] the total.
//
// Bound by bytes: the ids and row offsets in, the table entries the ids
// touch, the bytes out; there is no arithmetic to speak of.  The bytes out
// are most of it (about 4 an id on the corpus).  The two-launch K7 before
// this one ran at 13-35x that bound; measured node by node (PERF.md §6),
// 56-71% of its time went to the scatter, which stored each byte alone at a
// scattered address, and 30% to the totals launch, whose last block scanned
// every tile total alone; every id and its entry (a flag, then two offsets,
// three dependent loads) were read in both launches, and a memset node came
// first.
//
// Design: one launch over tiles of 1,024 consecutive ids, one block a tile
// (so a long row spreads over blocks and short rows share one).
//   - The table holds one 16-byte entry per id (ops/decode.py:
//     decode_entries): word 0 the length (bits 0-30) and the special flag
//     (bit 31); a token of at most 12 bytes inline in bytes 4-15, a longer
//     one's int64 start in the arena in words 1-2.  A thread reads its four
//     ids (each load coalesced across the block) and then their entries, one
//     16-byte load each, all in flight at once: two dependent L2 round trips
//     an id, and neither is read again.
//   - The block scans the lengths (each id's place in the tile) and ORs
//     every kept byte into a 16 KB staging buffer in shared memory, zeroed
//     first, at its place: a word at a time (an atomic OR, since the ids on
//     either side of a word boundary share the word; the bytes of an entry
//     past its length are zero), not a store a byte.  An id's first 16
//     bytes go by its own thread (inline from the entry, or two aligned
//     16-byte loads of the arena, which is padded to a multiple of 16
//     bytes), the rest of a longer id by its whole warp, 16 bytes a lane, so
//     a long token does not hold up one thread.
//   - The tile's byte offset comes from a decoupled look-back: a block takes
//     its tile from a ticket (so every tile before it has started and will
//     finish), publishes its total as a 64-bit status word (flag and value
//     in one store), and the whole block reads its predecessors' words,
//     1,024 a round (4 a thread), back to the nearest inclusive prefix, then
//     publishes its own.  The staging copy does not wait for it: the stage
//     is laid out from the tile's first byte, and the stores realign it.
//   - The block writes its output range with aligned 16-byte stores,
//     neighbouring threads on neighbouring chunks (each chunk two shared
//     loads and four funnel shifts, the shift the same for the whole
//     block), and the unaligned head and tail byte by byte; then the offset
//     of every row that starts in the tile (two warps search the row
//     offsets, 32 probes a step, while the entries are on their way).  A
//     tile of more than 16 KB (long tokens) goes out in windows of the
//     stage's size.  Nothing is written past the caller's capacity.
//   - The state (ticket, count of finished tiles, status words) must be
//     zero at a launch, and a CUDA graph replays the same buffers: the last
//     block to finish returns it to zero, after a fence on each block's
//     count, so no memset node is needed.
// Each block: 256 threads, 20,736 bytes of shared memory, at most 48
// registers a thread (a few spilled), 5 blocks an SM.  At 4 blocks (64
// registers, no spill) or 6 or 8 (40 or 32, more spilled) K7 measured
// slower on the corpus's rows (scripts/study_k7_variants.py, PERF.md §6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using i64 = long long;
using u64 = unsigned long long;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // ids a block
constexpr int kInline = 12;                   // token bytes an entry holds
constexpr int kStage = 16384;                 // bytes of the staging window
constexpr int kMinBlocks = 5;  // resident blocks an SM: 48 registers a thread
constexpr int kLook = 4;       // status words a thread reads a look-back round
constexpr uint32_t kAll = 0xFFFFFFFFu;
constexpr uint32_t kLenMask = 0x7FFFFFFFu;
constexpr i64 kNoEnd = 0x7FFFFFFFFFFFFFFFLL;
constexpr u64 kAggregate = 1ull << 62;  // status flags, above the value
constexpr u64 kPrefix = 2ull << 62;
constexpr u64 kValue = kAggregate - 1;

struct Args {
  const int32_t* ids;
  i64 n;
  const i64* row_off;  // [B + 1]
  int B;
  const uint4* entries;  // [V]
  const uint8_t* arena;  // padded to a multiple of 16 bytes
  int V;
  int skip_special;
  i64* state;  // ticket, count of finished tiles, status word by tile
  uint8_t* out;  // [8 (B + 1) + cap]
  i64 cap;
};

struct Smem {
  uint4 stage[kStage / 16 + 1];  // + 1: the shifted read of the last chunk
  int32_t pos[kTile];            // each id's first byte in the tile
  int wsum[kPerThread][kWarps];
  i64 red[kWarps];
  int stop[kWarps];
  int rows[2];
  int tile;
  int last;
};

__device__ __forceinline__ i64 warp_sum(i64 v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// first r in [0, count) with row_off[r] >= x (count when there is none), by
// one warp: 32 probes a step
__device__ __forceinline__ int warp_lower_bound(const i64* row_off, int count, i64 x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = count;
  while (lo < hi) {
    const i64 span = hi - lo;
    const int p = lo + (int)(span * lane / 32);
    const unsigned below = __ballot_sync(kAll, __ldg(row_off + p) < x);
    const int c = __popc(below);
    const int new_lo = c > 0 ? lo + (int)(span * (c - 1) / 32) + 1 : lo;
    hi = c < 32 ? lo + (int)(span * c / 32) : hi;
    lo = new_lo;
  }
  return lo;
}

// warps 0 and 1: the rows that start in the tile; the last tile also takes
// the rows that start at n and the entry B (the total)
__device__ __forceinline__ void find_rows(Smem& s, const Args& a, i64 base, bool last) {
  if (threadIdx.x < 64) {
    const i64 x = threadIdx.x < 32 ? base : (last ? kNoEnd : base + kTile);
    const int r = warp_lower_bound(a.row_off, a.B + 1, x);
    if ((threadIdx.x & 31) == 0) s.rows[threadIdx.x >> 5] = r;
  }
}

// the tile's ids (id k * kThreads + tid of the tile is the thread's k-th,
// so each load is coalesced), then their entries, all loads in flight
__device__ __forceinline__ void load_tile(const Args& a, i64 base, uint4 (&e)[kPerThread]) {
  int32_t id[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const i64 j = base + k * kThreads + threadIdx.x;
    id[k] = j < a.n ? __ldg(a.ids + j) : -1;
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    e[k] = (uint32_t)id[k] < (uint32_t)a.V ? __ldg(a.entries + id[k]) : make_uint4(0, 0, 0, 0);
}

// the bytes the output keeps of an id with entry e (0 for a dropped id)
__device__ __forceinline__ int kept_len(const Args& a, const uint4& e) {
  return a.skip_special && (e.x >> 31) ? 0 : (int)(e.x & kLenMask);
}

// each id's first byte in the tile (ids in tile order), into s.pos;
// returns the tile's bytes
__device__ __forceinline__ int scan_tile(Smem& s, const Args& a, const uint4 (&e)[kPerThread]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) incl[k] = kept_len(a, e[k]);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int y = __shfl_up_sync(kAll, incl[k], o);
      if (lane >= o) incl[k] += y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) s.wsum[k][warp] = incl[k];
  }
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    int before = 0, sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = s.wsum[k][w];
      before += w < warp ? v : 0;
      sum += v;
    }
    s.pos[k * kThreads + threadIdx.x] = total + before + incl[k] - kept_len(a, e[k]);
    total += sum;
  }
  return total;
}

// the 16 bytes from byte h (0..15) of the 32 bytes x, y
__device__ __forceinline__ uint4 shifted(const uint4 x, const uint4 y, int h) {
  const int r = 8 * (h & 3);
  uint32_t w0, w1, w2, w3, w4;
  switch (h >> 2) {
    case 0: w0 = x.x; w1 = x.y; w2 = x.z; w3 = x.w; w4 = y.x; break;
    case 1: w0 = x.y; w1 = x.z; w2 = x.w; w3 = y.x; w4 = y.y; break;
    case 2: w0 = x.z; w1 = x.w; w2 = y.x; w3 = y.y; w4 = y.z; break;
    default: w0 = x.w; w1 = y.x; w2 = y.y; w3 = y.z; w4 = y.w; break;
  }
  return make_uint4(__funnelshift_r(w0, w1, r), __funnelshift_r(w1, w2, r),
                    __funnelshift_r(w2, w3, r), __funnelshift_r(w3, w4, r));
}

// the `need` (1..16) bytes of the arena from `at` on, in two aligned loads
// at most (the arena is padded to a multiple of 16 bytes, so neither reads
// past it)
__device__ __forceinline__ uint4 arena_chunk(const uint8_t* arena, i64 at, int need) {
  const uint4* q = reinterpret_cast<const uint4*>(arena + (at & ~15ll));
  const int h = (int)(at & 15);
  const uint4 x = __ldg(q);
  return shifted(x, h + need > 16 ? __ldg(q + 1) : x, h);
}

// the first m (0..16) bytes of v, the rest zero
__device__ __forceinline__ uint4 first_bytes(uint4 v, int m) {
  const auto keep = [m](int k) {
    const int b = m - 4 * k;  // bytes of word k to keep
    return b >= 4 ? 0xFFFFFFFFu : b <= 0 ? 0u : (1u << (8 * b)) - 1;
  };
  return make_uint4(v.x & keep(0), v.y & keep(1), v.z & keep(2), v.w & keep(3));
}

// v's 16 bytes ORed into the stage from byte d on (d may be negative in a
// window; words outside it are skipped).  The stage is zero there, and
// bytes of v that belong to no id are zero, so neighbouring ids that share
// a word do not disturb each other: a word takes one atomic OR, not a
// store a byte.
template <bool kClip>
__device__ __forceinline__ void or_bytes(uint32_t* st, const uint4 v, int d) {
  const int q = d >> 2, r = 8 * (d & 3);
  const uint32_t w[5] = {v.x << r, __funnelshift_l(v.x, v.y, r), __funnelshift_l(v.y, v.z, r),
                         __funnelshift_l(v.z, v.w, r), __funnelshift_l(v.w, 0u, r)};
#pragma unroll
  for (int i = 0; i < 5; ++i)
    if (w[i] && (!kClip || (q + i >= 0 && q + i < kStage / 4))) atomicOr(st + q + i, w[i]);
}

__device__ __forceinline__ void zero_stage(Smem& s) {
  for (int i = threadIdx.x; i < kStage / 16 + 1; i += kThreads) s.stage[i] = make_uint4(0, 0, 0, 0);
}

// the thread's ids' bytes that fall in the window [lo, lo + kStage) of the
// tile, ORed into the zeroed stage at their place less lo: an id's first
// 16 bytes by its own thread (inline, or one chunk of the arena), the rest
// of a longer id by its whole warp, 16 bytes a lane
template <bool kClip>
__device__ __forceinline__ void stage_bytes(Smem& s, const Args& a, const uint4 (&e)[kPerThread],
                                            int lo) {
  uint32_t* st = reinterpret_cast<uint32_t*>(s.stage);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int l = kept_len(a, e[k]), p = s.pos[k * kThreads + threadIdx.x] - lo;
    const i64 start = (i64)e[k].y | ((i64)e[k].z << 32);
    const bool in = l > 0 && (!kClip || (p + l > 0 && p < kStage));
    if (in) {
      // inline bytes past the length are zero in the entry
      const uint4 v = l <= kInline ? make_uint4(e[k].y, e[k].z, e[k].w, 0)
                                   : first_bytes(arena_chunk(a.arena, start, min(l, 16)), l);
      or_bytes<kClip>(st, v, p);
    }
    for (unsigned m = __ballot_sync(kAll, in && l > 16); m; m &= m - 1) {
      const int src = __ffs(m) - 1;
      const int tl = __shfl_sync(kAll, l, src), tp = __shfl_sync(kAll, p, src);
      const i64 ts = __shfl_sync(kAll, start, src);
      for (int c = 16 * (lane + 1); c < tl; c += 16 * 32) {
        if (kClip && (tp + c + 16 <= 0 || tp + c >= kStage)) continue;
        or_bytes<kClip>(st, first_bytes(arena_chunk(a.arena, ts + c, min(tl - c, 16)), tl - c),
                        tp + c);
      }
    }
  }
}

// the stage's first wlen bytes to body[at, at + wlen), clipped to the
// capacity: aligned 16-byte stores, neighbouring threads on neighbouring
// chunks; the unaligned head and tail byte by byte
__device__ __forceinline__ void store_window(const Smem& s, const Args& a, i64 at, int wlen) {
  const i64 end = min(at + wlen, a.cap);
  if (end <= at) return;
  const uint8_t* st = reinterpret_cast<const uint8_t*>(s.stage);
  uint8_t* body = a.out + 8 * ((i64)a.B + 1);
  uint8_t* p0 = body + at;
  uint8_t* p1 = body + end;
  uint8_t* a0 = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p0) + 15) & ~(uintptr_t)15);
  uint8_t* a1 = reinterpret_cast<uint8_t*>(reinterpret_cast<uintptr_t>(p1) & ~(uintptr_t)15);
  if (a0 >= a1) {  // no whole chunk
    for (int i = threadIdx.x; i < p1 - p0; i += kThreads) p0[i] = st[i];
    return;
  }
  const int head = (int)(a0 - p0), tail = (int)(p1 - a1), t0 = (int)(a1 - p0);
  if (threadIdx.x < head) p0[threadIdx.x] = st[threadIdx.x];
  if (threadIdx.x >= 32 && threadIdx.x - 32 < tail) a1[threadIdx.x - 32] = st[t0 + threadIdx.x - 32];
  const int chunks = (int)((a1 - a0) >> 4);
  uint4* dst = reinterpret_cast<uint4*>(a0);
  for (int c = threadIdx.x; c < chunks; c += kThreads)
    dst[c] = shifted(s.stage[c], s.stage[c + 1], head);
}

// the offsets of the rows that start in the tile
__device__ __forceinline__ void write_rows(const Smem& s, const Args& a, i64 base, i64 tile_base,
                                           i64 end) {
  i64* out_off = reinterpret_cast<i64*>(a.out);
  for (int r = s.rows[0] + threadIdx.x; r < s.rows[1]; r += kThreads) {
    const i64 d = __ldg(a.row_off + r) - base;
    out_off[r] = d + base >= a.n ? end : (d >= 0 && d < kTile ? tile_base + s.pos[d] : 0);
  }
}

// the tile's bytes, window by window, and its rows; the single window was
// staged before the offset was known
__device__ __forceinline__ void finish_tile(Smem& s, const Args& a, const uint4 (&e)[kPerThread],
                                            i64 base, int total, i64 tile_base) {
  if (total <= kStage) {
    store_window(s, a, tile_base, total);
  } else {
    for (int lo = 0; lo < total; lo += kStage) {
      __syncthreads();  // the stage is read out
      zero_stage(s);
      __syncthreads();
      stage_bytes<true>(s, a, e, lo);
      __syncthreads();
      store_window(s, a, tile_base + lo, min(kStage, total - lo));
    }
  }
  write_rows(s, a, base, tile_base, tile_base + total);
}

__device__ __forceinline__ void publish(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 peek(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// by the whole block: the bytes of the tiles before `tile`, from their
// status words, kLook a thread and kThreads * kLook a round (so one L2 round
// trip for up to 1,024 predecessors when no prefix is out yet), back to the
// nearest inclusive prefix
__device__ __forceinline__ i64 look_back(Smem& s, const u64* status, int tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kRound = kThreads * kLook;
  i64 excl = 0;
  for (int j = tile - 1;; j -= kRound) {
    u64 w[kLook];  // w[k]: the tile k * kThreads + tid before tile j + 1
#pragma unroll
    for (int k = 0; k < kLook; ++k) {
      const int t = j - k * kThreads - (int)threadIdx.x;
      w[k] = t >= 0 ? peek(status + t) : kPrefix;  // before tile 0: a prefix of 0
    }
    for (int spin = 0;; ++spin) {
      bool wait = false;
#pragma unroll
      for (int k = 0; k < kLook; ++k) wait |= w[k] < kAggregate;
      if (!__syncthreads_or(wait)) break;
      if (spin == (1 << 24)) __trap();  // a predecessor never published: fail, do not hang
#pragma unroll
      for (int k = 0; k < kLook; ++k)
        if (w[k] < kAggregate) w[k] = peek(status + j - k * kThreads - (int)threadIdx.x);
    }
    int near = kRound;  // the nearest tile that holds a prefix, by distance
#pragma unroll
    for (int k = kLook - 1; k >= 0; --k)
      if (w[k] >= kPrefix) near = k * kThreads + threadIdx.x;
    near = __reduce_min_sync(kAll, near);
    if (lane == 0) s.stop[warp] = near;
    __syncthreads();
    int stop = kRound;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) stop = min(stop, s.stop[k]);
    i64 v = 0;
#pragma unroll
    for (int k = 0; k < kLook; ++k)
      v += k * kThreads + (int)threadIdx.x <= stop ? (i64)(w[k] & kValue) : 0;
    v = warp_sum(v);
    if (lane == 0) s.red[warp] = v;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWarps; ++k) excl += s.red[k];
    __syncthreads();  // s.stop and s.red are read before the next round
    if (stop < kRound) return excl;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) decode_gather_kernel(Args a) {
  __shared__ Smem s;
  u64* ctl = reinterpret_cast<u64*>(a.state);
  u64* status = ctl + 2;
  if (threadIdx.x == 0) s.tile = (int)atomicAdd(ctl, 1ull);
  zero_stage(s);
  __syncthreads();
  const int tile = s.tile;
  const i64 base = (i64)tile * kTile;
  uint4 e[kPerThread];
  load_tile(a, base, e);
  find_rows(s, a, base, tile == (int)gridDim.x - 1);  // while the entries come
  const int total = scan_tile(s, a, e);
  if (threadIdx.x == 0) publish(status + tile, (tile ? kAggregate : kPrefix) | (u64)total);
  if (total <= kStage) stage_bytes<false>(s, a, e, 0);
  const i64 excl = tile ? look_back(s, status, tile) : 0;
  if (threadIdx.x == 0 && tile) publish(status + tile, kPrefix | (u64)(excl + total));
  __syncthreads();  // the stage is written
  finish_tile(s, a, e, base, total, excl);
  // the last block to finish returns the ticket, the count and the status
  // words to zero for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's status stores come before its count
    s.last = atomicAdd(reinterpret_cast<unsigned*>(ctl + 1), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s.last) {
    __threadfence();
    for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) status[i] = 0;
    if (threadIdx.x == 0) ctl[0] = ctl[1] = 0;
  }
}

}  // namespace

extern "C" {

// K7's launch.  entries: [V] 16-byte entries; arena padded to a multiple of
// 16 bytes; state: int64 [tiles + 2], zero (K7 leaves it zero); out: the
// B + 1 int64 row offsets, then cap bytes (none is written past them).
int ctok_decode_gather(const void* ids, long long n, const void* row_off, int B,
                       const void* entries, const void* arena, int V, int skip_special,
                       void* state, void* out, long long cap, void* stream) {
  if (n <= 0 || B < 0 || V <= 0 || cap < 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const int32_t*>(ids), n, static_cast<const i64*>(row_off), B,
               static_cast<const uint4*>(entries), static_cast<const uint8_t*>(arena), V,
               skip_special, static_cast<i64*>(state), static_cast<uint8_t*>(out), cap};
  const auto s = (cudaStream_t)stream;
  decode_gather_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// info[0..4]: threads a block, registers a thread, static shared bytes a
// block, local bytes a thread, resident blocks per SM of K7's kernel
int ctok_decode_info(int* info) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, decode_gather_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, decode_gather_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int shape[] = {kThreads, fa.numRegs, (int)fa.sharedSizeBytes, (int)fa.localSizeBytes,
                       blocks};
  for (int i = 0; i < 5; ++i) info[i] = shape[i];
  return (int)cudaSuccess;
}

}  // extern "C"
