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
// [B + 1], lens [B]; the caller orders them by length) and the trainer's
// tables: an open-address table [T] of int4 rows (h1, h2, slot, 0), the
// empty row (0, 1, 0, 0), T a power of two; each slot's (length, symbol)
// [S] int2 and characters [S, 128] int32; the fallback symbols fb_map
// [2, 0x110000] (the bare character, "##" + character).  A thread a word,
// as match_rows decides it:
// - at each start the candidate lengths l = 1..min(lt_cap, n - start) in
//   turn: the two hashes of chars[start, start + l) grow by one step a
//   length (h = h * base + (c + 1) in uint32, from the continuation seeds
//   past the word's start: equal to JAX's P[e] - P[s] * base^l + seed *
//   base^l); each is probed at up to 16 slots from mix_hash(h1, h2) & (T -
//   1) and takes the first row whose key matches.  No key lies past an
//   empty row of its run (the table only grows and inserts at the first
//   empty row), so an empty row ends the probe, as a miss unless the key is
//   the empty key itself (JAX's rule then takes that row's slot, 0);
// - a hit counts when the slot's form has length l (the length guard); the
//   longest counts, and only its characters are checked: a mismatch poisons
//   the word, emits the fallback symbol and advances one, as a miss does;
//   a miss whose character has no fallback symbol poisons the word too;
// - out: the symbol at each piece's start, -1 in the word's other slots;
//   poison [B] int32.
//
// K19 over K18's out, the words' offs, freqs [B] and poison [B]: every
// adjacent pair of a word's symbols (the -1 between pieces skipped), keyed
// (a << 16) | b, weighted by the word's frequency; a poisoned word adds
// nothing (JAX weights it 0 and drops keys whose sum is 0).  The launcher
// clears a table of T int32 keys (-1 empty) and counts and the result's
// head; a thread a word inserts its pairs (atomicCAS claims a key's row,
// atomicAdd sums its count, linear probing from mix_hash(key, 0)); a
// second pass, a thread a row, writes the rows whose count is above 0 as
// (key, count) into res [2 + 2 cap] after res[0] = their number (a warp's
// rows claim their places with one atomic); res[1] counts the poisoned
// words.  The table holds at least twice the slots, so it cannot fill.
// int32 sums are the same in any order, so the set of (key, count) equals
// pair_count_plain's bit for bit; their order is the table's.
//
// Bound: latency.  K18's bytes are the words' characters in, the symbols
// and poison flags out and the table rows its probes touch (16 B each, in
// L2 after the first touch); a candidate waits on one probe's dependent
// row reads.  K19 reads the symbols once and writes each key once; its
// clear writes the table (8 B a row).

#include <cstdint>
#include <cuda_runtime.h>

#include "chd_hash.cuh"

namespace {

constexpr uint32_t kB1 = 0x01000193u;
constexpr uint32_t kB2 = 0x0BADC0DFu;
constexpr uint32_t kSeed1 = 0x9E3779B9u;
constexpr uint32_t kSeed2 = 0x7F4A7C15u;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kMaxW = 128;           // characters a word
constexpr int kMaxProbe = 16;        // the open-address table's probe budget
constexpr int32_t kMaxCp = 0x110000;  // the fallback maps' codepoints
constexpr int kThreads = 256;

// The slot of key (h1, h2) in the open-address table, -1 when absent.
__device__ __forceinline__ int32_t probe(const int4* __restrict__ table, uint32_t mask,
                                         uint32_t h1, uint32_t h2) {
  const uint32_t base = mix_hash(h1, h2);
#pragma unroll 1
  for (int j = 0; j < kMaxProbe; ++j) {
    const int4 r = __ldg(table + ((base + j) & mask));
    if ((uint32_t)r.x == h1 && (uint32_t)r.y == h2) return r.z;
    if (r.x == 0 && r.y == 1) return -1;  // empty: no key lies past it
  }
  return -1;
}

// ---------------------------------------------------------------------------
// K18

__global__ void __launch_bounds__(kThreads)
train_match_kernel(const int32_t* __restrict__ chars, const int32_t* __restrict__ offs,
                   const int32_t* __restrict__ lens, int B, const int4* __restrict__ table,
                   uint32_t mask, const int2* __restrict__ slot_meta,
                   const int32_t* __restrict__ slot_chars, const int32_t* __restrict__ fb_map,
                   int lt_cap, int32_t* __restrict__ out, int32_t* __restrict__ poison) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= B) return;
  const int o = offs[w];
  const int slots = offs[w + 1] - o;
  const int n = min(lens[w], slots);
  const int32_t* c = chars + o;
  int32_t* ow = out + o;
  for (int p = 0; p < slots; ++p) ow[p] = -1;
  int32_t poisoned = 0;
  int start = 0;
  while (start < n) {
    uint32_t h1 = start > 0 ? kSeed1 : 0u;
    uint32_t h2 = start > 0 ? kSeed2 : 0u;
    const int maxl = min(lt_cap, n - start);
    int best_l = 0;
    int32_t best = 0;
#pragma unroll 1
    for (int l = 1; l <= maxl; ++l) {
      const uint32_t u = (uint32_t)c[start + l - 1] + 1u;
      h1 = h1 * kB1 + u;
      h2 = h2 * kB2 + u;
      const int32_t slot = probe(table, mask, h1, h2);
      if (slot >= 0 && __ldg(&slot_meta[slot].x) == l) {
        best_l = l;
        best = slot;
      }
    }
    bool good = best_l > 0;
    if (good) {
      const int32_t* t = slot_chars + (int64_t)best * kMaxW;
      for (int k = 0; k < best_l; ++k) {
        if (__ldg(t + k) != c[start + k]) {
          good = false;
          break;
        }
      }
      if (!good) poisoned = 1;  // a hash collision: never a shorter hit
    }
    int32_t sym;
    if (good) {
      sym = __ldg(&slot_meta[best].y);
    } else {
      const int32_t cp = min(max(c[start], 0), kMaxCp - 1);
      sym = __ldg(fb_map + (start > 0 ? kMaxCp : 0) + cp);
      if (best_l == 0 && sym < 0) poisoned = 1;
    }
    ow[start] = sym;
    start += good ? best_l : 1;
  }
  poison[w] = poisoned;
}

// ---------------------------------------------------------------------------
// K19

__device__ __forceinline__ void insert_pair(int32_t* __restrict__ keys,
                                            int32_t* __restrict__ counts, uint32_t mask,
                                            int32_t key, int32_t f) {
  uint32_t h = mix_hash((uint32_t)key, 0u) & mask;
  while (true) {
    const int32_t k = keys[h];
    if (k == key) break;
    if (k == -1) {
      const int32_t prev = atomicCAS(&keys[h], -1, key);
      if (prev == -1 || prev == key) break;
    }
    h = (h + 1) & mask;  // a row holds its key for good: probe on
  }
  atomicAdd(&counts[h], f);
}

__global__ void __launch_bounds__(kThreads)
pair_insert_kernel(const int32_t* __restrict__ out, const int32_t* __restrict__ offs,
                   const int32_t* __restrict__ freqs, const int32_t* __restrict__ poison, int B,
                   int32_t* __restrict__ keys, int32_t* __restrict__ counts, uint32_t mask,
                   int32_t* __restrict__ res) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= B) return;
  if (poison[w] != 0) {
    atomicAdd(&res[1], 1);
    return;
  }
  const int32_t f = freqs[w];
  if (f <= 0) return;
  const int end = offs[w + 1];
  int32_t prev = -1;
  for (int p = offs[w]; p < end; ++p) {
    const int32_t s = out[p];
    if (s < 0) continue;
    if (prev >= 0) insert_pair(keys, counts, mask, (prev << 16) | s, f);
    prev = s;
  }
}

__global__ void __launch_bounds__(kThreads)
pair_compact_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ counts, int T,
                    int32_t* __restrict__ res) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t cnt = i < T ? counts[i] : 0;
  const bool take = cnt > 0;
  const unsigned ballot = __ballot_sync(kFull, take);
  if (ballot == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(ballot) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&res[0], __popc(ballot));
  base = __shfl_sync(kFull, base, leader);
  if (take) {
    const int j = base + __popc(ballot & ((1u << lane) - 1u));
    res[2 + 2 * j] = keys[i];
    res[3 + 2 * j] = cnt;
  }
}

int blocks_for(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

template <typename K>
int shape_of(K kernel, int* info) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int shape[] = {kThreads, fa.numRegs, (int)fa.sharedSizeBytes, (int)fa.localSizeBytes,
                       blocks};
  for (int i = 0; i < 5; ++i) info[i] = shape[i];
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// K18: chars [N], offs [B + 1], lens [B] int32; table [T] int4 (16-byte
// aligned), t_mask = T - 1; slot_meta [S] int2; slot_chars [S, 128]; fb_map
// [2, 0x110000]; lt_cap 1..128 -> out [N] int32, poison [B] int32
int ctok_train_match(const void* chars, const void* offs, const void* lens, int B,
                     const void* table, unsigned t_mask, const void* slot_meta,
                     const void* slot_chars, const void* fb_map, int lt_cap, void* out,
                     void* poison, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (lt_cap < 1 || lt_cap > kMaxW || (t_mask & (t_mask + 1)) != 0)
    return (int)cudaErrorInvalidValue;
  train_match_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(chars), static_cast<const int32_t*>(offs),
      static_cast<const int32_t*>(lens), B, static_cast<const int4*>(table), (uint32_t)t_mask,
      static_cast<const int2*>(slot_meta), static_cast<const int32_t*>(slot_chars),
      static_cast<const int32_t*>(fb_map), lt_cap, static_cast<int32_t*>(out),
      static_cast<int32_t*>(poison));
  return (int)cudaGetLastError();
}

int ctok_train_match_info(int* info) { return shape_of(train_match_kernel, info); }

// K19: out [N], offs [B + 1], freqs [B], poison [B] int32; keys and counts
// [T] int32 (T a power of two, at least twice the slots), res [2 + 2 cap]
// int32, cap = T / 2 -> res: the keys' number, the poisoned words' number,
// the (key, count) pairs
int ctok_pair_count(const void* out, const void* offs, const void* freqs, const void* poison,
                    int B, void* keys, void* counts, int T, void* res, int cap, void* stream) {
  if (T < 32 || (T & (T - 1)) != 0 || 2 * cap < T) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(keys, 0xFF, sizeof(int32_t) * (size_t)T, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * (size_t)T, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(res, 0, 2 * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    pair_insert_kernel<<<blocks_for(B), kThreads, 0, s>>>(
        static_cast<const int32_t*>(out), static_cast<const int32_t*>(offs),
        static_cast<const int32_t*>(freqs), static_cast<const int32_t*>(poison), B,
        static_cast<int32_t*>(keys), static_cast<int32_t*>(counts), (uint32_t)(T - 1),
        static_cast<int32_t*>(res));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  pair_compact_kernel<<<blocks_for(T), kThreads, 0, s>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(counts), T,
      static_cast<int32_t*>(res));
  return (int)cudaGetLastError();
}

int ctok_pair_count_info(int* info) { return shape_of(pair_insert_kernel, info); }

}  // extern "C"
