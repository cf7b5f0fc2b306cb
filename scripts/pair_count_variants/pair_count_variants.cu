// Designs of K19 (csrc/wordpiece_train.cu's ctok_pair_count) that the
// package does not ship, for scripts/study_pair_count_variants.py only.
// The entry has the package's C signature and state (an int2 (key, count)
// table left cleared, a list of claimed rows, a head of 4 int32).  Built
// alone with the package's nvcc flags, -I complexity_tokenizer_tpu_torch/csrc
// and one set of these macros:
// - K19_STEPS: 32-slot steps a warp takes one after another (the package
//   1), its loads issued together;
// - K19_AGG: 0 (the package) each pair goes to the global table; 1 a
//   block first sums its pairs in a table of its own in shared memory
//   (2 x its slots of int2), then adds each of its keys to the global table
//   once;
// - K19_CLAIM: 1 (the package) a block gathers its claimed rows in shared
//   memory and appends them to the list with one global atomic; 0 a warp
//   appends its claims with one global atomic of its own;
// - K19_PDL: 1 (the package) the compaction is the insert's programmatic
//   dependent; 0 a plain launch;
// - K19_WALK: 0 (the package) a warp 32 slots; 1 a thread a word walking
//   its slots one after another (the parent's insert), with the list and
//   the compaction of the package (its claims appended a warp at a time);
// - K19_CAS: 1 (the package) a probe's atomicCAS alone; 0 a probe reads
//   the row's key before its atomicCAS (the design first shipped);
// - K19_DEDUP: 0 (the package) every lane adds its own pair; 1 the lanes
//   of a warp holding one key (__match_any_sync) add their sum once;
// - K19_FUSED: 0 (the package) two launches; 1 one cooperative launch of
//   at most the blocks the card holds at once, striding over the slots,
//   a grid barrier, then the compaction.
// With none set, this is the package's K19.

#include <cstdint>
#include <cuda_runtime.h>

#include "chd_hash.cuh"
#include "dependent_launch.cuh"

#ifndef K19_STEPS
#define K19_STEPS 1
#endif
#ifndef K19_AGG
#define K19_AGG 0
#endif
#ifndef K19_CLAIM
#define K19_CLAIM 1
#endif
#ifndef K19_PDL
#define K19_PDL 1
#endif
#ifndef K19_WALK
#define K19_WALK 0
#endif
#ifndef K19_CAS
#define K19_CAS 1
#endif
#ifndef K19_DEDUP
#define K19_DEDUP 0
#endif
#ifndef K19_FUSED
#define K19_FUSED 0
#endif

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kSteps = K19_STEPS;
constexpr int kBlockSlots = kThreads * kSteps;
constexpr int kAggRows = 2 * kBlockSlots;  // K19_AGG: a power of two
constexpr int kCompactMaxBlocks = 264;

int blocks_for(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

__device__ __forceinline__ int warp_word_of(const int32_t* __restrict__ offs, int B, int p,
                                            int lane) {
  int lo = 0, len = B + 1;
  while (len > 1) {
    const int step = (len + 31) >> 5;
    const bool le = lane * step < len && __ldg(offs + lo + lane * step) <= p;
    const int k = 31 - __clz(__ballot_sync(kFull, le));
    const int nlo = lo + k * step;
    len = min(step, lo + len - nlo);
    lo = nlo;
  }
  return lo;
}

__device__ __forceinline__ int lane_word_of(const int32_t* __restrict__ offs, int B, int p) {
  int lo = 0, hi = B;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(offs + mid) <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool insert_pair(int2* __restrict__ table, uint32_t mask, int32_t key,
                                            int32_t f, uint32_t* row) {
  uint32_t h = mix_hash((uint32_t)key, 0u) & mask;
  bool claimed = false;
  while (true) {
    int32_t* kp = reinterpret_cast<int32_t*>(table + h);
#if K19_CAS
    const int32_t prev = atomicCAS(kp, -1, key);
    if (prev == -1) {
      claimed = true;
      break;
    }
    if (prev == key) break;
#else
    const int32_t k = __ldcg(kp);
    if (k == key) break;
    if (k == -1) {
      const int32_t prev = atomicCAS(kp, -1, key);
      if (prev == -1) {
        claimed = true;
        break;
      }
      if (prev == key) break;
    }
#endif
    h = (h + 1) & mask;
  }
  atomicAdd(reinterpret_cast<int32_t*>(table + h) + 1, f);
  *row = h;
  return claimed;
}

// A block's state: its claimed rows, their number, its poisoned words.
struct BlockClaims {
  int32_t rows[kBlockSlots];
  int32_t n, poison, base;
};

// Records this warp's claims (every lane calls it).
__device__ __forceinline__ void record_claims(BlockClaims& bc, bool claimed, uint32_t row,
                                              int lane, int32_t* __restrict__ rows,
                                              int32_t* __restrict__ head) {
  const unsigned cm = __ballot_sync(kFull, claimed);
  if (!cm) return;
  const int leader = __ffs(cm) - 1;
  int b0 = 0;
#if K19_CLAIM && !K19_WALK  // a word's claims can outnumber a block's slots
  if (lane == leader) b0 = atomicAdd(&bc.n, __popc(cm));
  b0 = __shfl_sync(kFull, b0, leader);
  if (claimed) bc.rows[b0 + __popc(cm & ((1u << lane) - 1u))] = (int32_t)row;
#else
  if (lane == leader) b0 = atomicAdd(head, __popc(cm));
  b0 = __shfl_sync(kFull, b0, leader);
  if (claimed) rows[b0 + __popc(cm & ((1u << lane) - 1u))] = (int32_t)row;
#endif
}

// Appends the block's claims to the list and adds its poisoned words.
__device__ __forceinline__ void flush_claims(BlockClaims& bc, int32_t* __restrict__ rows,
                                             int32_t* __restrict__ head) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (bc.n) bc.base = atomicAdd(head, bc.n);
    if (bc.poison) atomicAdd(head + 1, bc.poison);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bc.n; i += kThreads) rows[bc.base + i] = bc.rows[i];
}

#if K19_AGG
// Adds f to key's row of the block's own table.
__device__ __forceinline__ void agg_add(int2* agg, int32_t key, int32_t f) {
  uint32_t h = mix_hash((uint32_t)key, 0u) & (kAggRows - 1);
  while (true) {
    int32_t* kp = reinterpret_cast<int32_t*>(agg + h);
    const int32_t k = *reinterpret_cast<volatile int32_t*>(kp);
    if (k == key) break;
    if (k == -1) {
      const int32_t prev = atomicCAS(kp, -1, key);
      if (prev == -1 || prev == key) break;
    }
    h = (h + 1) & (kAggRows - 1);
  }
  atomicAdd(reinterpret_cast<int32_t*>(agg + h) + 1, f);
}
#endif

// One warp's kSteps steps of 32 slots from base0 (< N): each pair to the
// global table (its claims into bc) or, with K19_AGG, to the block's agg.
__device__ __forceinline__ void warp_pairs(
    int base0, int lane, const int32_t* __restrict__ out, int N, const int32_t* __restrict__ offs,
    const int32_t* __restrict__ freqs, const int32_t* __restrict__ poison, int B,
    int2* __restrict__ table, uint32_t mask, int32_t* __restrict__ rows,
    int32_t* __restrict__ head, BlockClaims& bc, int2* agg) {
  int32_t sv[kSteps];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int p = base0 + 32 * k + lane;
    sv[k] = p < N ? __ldg(out + p) : -1;
  }
  int c0 = base0 - 32;
  int32_t v = c0 >= 0 ? __ldg(out + c0 + lane) : -1;
  int wc = warp_word_of(offs, B, base0, lane);
  int ws0 = __ldg(offs + wc);
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
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int base = base0 + 32 * k;
    if (base >= N) break;
    const int p = base + lane;
    const int32_t s = sv[k];
    const int32_t nxt = wc + 1 + lane <= B ? __ldg(offs + wc + 1 + lane) : 0x7FFFFFFF;
    int cnt = 0;
#pragma unroll
    for (int j = 16; j >= 1; j >>= 1) {
      const int32_t o = __shfl_sync(kFull, nxt, cnt + j - 1);
      if (o <= p) cnt += j;
    }
    const int32_t o31 = __shfl_sync(kFull, nxt, 31);
    if (cnt == 31 && o31 <= p) cnt = 32;
    const int32_t o_prev = __shfl_sync(kFull, nxt, max(cnt - 1, 0));
    int w = wc + cnt;
    int wstart = cnt > 0 ? o_prev : ws0;
    if (o31 <= base + 31) {
      w = lane_word_of(offs, B, p);
      wstart = __ldg(offs + w);
    }
    const bool live = s >= 0;
    const unsigned m = __ballot_sync(kFull, live);
    const unsigned below = m & ((1u << lane) - 1u);
    const int src = below ? 31 - __clz(below) : 0;
    const int32_t a_in = __shfl_sync(kFull, s, src);
    const int q = below ? base + src : cq;
    const int32_t a = below ? a_in : ca;
    int32_t f = 0;
    if (live && w < B && q >= wstart && __ldg(poison + w) == 0) f = __ldg(freqs + w);
#if K19_DEDUP
    {
      const unsigned peers = __match_any_sync(kFull, f > 0 ? (a << 16) | s : -1 - lane);
      const int32_t sum = __reduce_add_sync(peers, f);
      f = lane == __ffs(peers) - 1 ? sum : 0;
    }
#endif
#if K19_AGG
    if (f > 0) agg_add(agg, (a << 16) | s, f);
#else
    uint32_t row = 0;
    const bool claimed = f > 0 && insert_pair(table, mask, (a << 16) | s, f, &row);
    record_claims(bc, claimed, row, lane, rows, head);
#endif
    // the next step: its first word is this step's last slot's, the
    // symbol before it this step's last
    wc = __shfl_sync(kFull, w, 31);
    ws0 = __shfl_sync(kFull, wstart, 31);
    if (m) {
      cq = base + 31 - __clz(m);
      ca = __shfl_sync(kFull, s, 31 - __clz(m));
    }
  }
}

// The block's poisoned words (words blockIdx.x * kThreads + t, striding
// over the grid) into bc.poison.
__device__ __forceinline__ void block_poison(const int32_t* __restrict__ poison, int B,
                                             BlockClaims& bc, int lane) {
  int np = 0;
  for (int w = blockIdx.x * kThreads + threadIdx.x; w < B; w += gridDim.x * kThreads)
    np += __ldg(poison + w) != 0;
  np = __reduce_add_sync(kFull, np);
  if (lane == 0 && np) atomicAdd(&bc.poison, np);
}

__global__ void __launch_bounds__(kThreads)
pair_insert_kernel(const int32_t* __restrict__ out, int N, const int32_t* __restrict__ offs,
                   const int32_t* __restrict__ freqs, const int32_t* __restrict__ poison, int B,
                   int2* __restrict__ table, uint32_t mask, int32_t* __restrict__ rows,
                   int32_t* __restrict__ head) {
#if K19_PDL
  asm volatile("griddepcontrol.launch_dependents;");
#endif
  __shared__ BlockClaims bc;
#if K19_AGG
  __shared__ int2 agg[kAggRows];
  for (int i = threadIdx.x; i < kAggRows; i += kThreads) agg[i] = make_int2(-1, 0);
#else
  int2* agg = nullptr;
#endif
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    bc.n = 0;
    bc.poison = 0;
  }
  __syncthreads();
  block_poison(poison, B, bc, lane);
  const int base0 = ((blockIdx.x * kThreads + threadIdx.x) >> 5) * (32 * kSteps);
  if (base0 < N)
    warp_pairs(base0, lane, out, N, offs, freqs, poison, B, table, mask, rows, head, bc, agg);
#if K19_AGG
  __syncthreads();
  for (int i = threadIdx.x; i < kAggRows; i += kThreads) {
    const int2 kc = agg[i];
    uint32_t row = 0;
    const bool claimed = kc.x != -1 && insert_pair(table, mask, kc.x, kc.y, &row);
    record_claims(bc, claimed, row, lane, rows, head);
  }
#endif
  flush_claims(bc, rows, head);
}

#if K19_WALK
// A thread a word, its slots one after another (the parent's walk).
__global__ void __launch_bounds__(kThreads)
pair_walk_kernel(const int32_t* __restrict__ out, const int32_t* __restrict__ offs,
                 const int32_t* __restrict__ freqs, const int32_t* __restrict__ poison, int B,
                 int2* __restrict__ table, uint32_t mask, int32_t* __restrict__ rows,
                 int32_t* __restrict__ head) {
#if K19_PDL
  asm volatile("griddepcontrol.launch_dependents;");
#endif
  __shared__ BlockClaims bc;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    bc.n = 0;
    bc.poison = 0;
  }
  __syncthreads();
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const bool in = w < B;
  const bool pz = in && __ldg(poison + w) != 0;
  const int np = __reduce_add_sync(kFull, (int)pz);
  if (lane == 0 && np) atomicAdd(&bc.poison, np);
  const int32_t f = in && !pz ? __ldg(freqs + w) : 0;
  int p = f > 0 ? __ldg(offs + w) : 0;
  const int end = f > 0 ? __ldg(offs + w + 1) : 0;
  int32_t prev = -1;
  // every lane loops as long as the warp's longest word, claims recorded a
  // pair at a time
  while (__any_sync(kFull, p < end)) {
    bool claimed = false;
    uint32_t row = 0;
    if (p < end) {
      const int32_t s = __ldg(out + p);
      if (s >= 0) {
        if (prev >= 0) claimed = insert_pair(table, mask, (prev << 16) | s, f, &row);
        prev = s;
      }
      ++p;
    }
    record_claims(bc, claimed, row, lane, rows, head);
  }
  flush_claims(bc, rows, head);
}
#endif

// Writes the listed rows out and empties them; the last block to finish
// zeroes the head.
__device__ __forceinline__ void compact(int2* __restrict__ table, const int32_t* __restrict__ rows,
                                        int32_t* __restrict__ head, int32_t* __restrict__ res) {
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
    if (atomicAdd(head + 2, 1) == (int)gridDim.x - 1) {
      head[0] = 0;
      head[1] = 0;
      head[2] = 0;
      head[3] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
pair_compact_kernel(int2* __restrict__ table, const int32_t* __restrict__ rows,
                    int32_t* __restrict__ head, int32_t* __restrict__ res) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  compact(table, rows, head, res);
}

#if K19_FUSED
// The insert striding over the slots a block's 256 at a time, a grid
// barrier (head[3] counts the blocks past it: every block is resident, the
// launch being cooperative), then the compaction.
__global__ void __launch_bounds__(kThreads)
pair_fused_kernel(const int32_t* __restrict__ out, int N, const int32_t* __restrict__ offs,
                  const int32_t* __restrict__ freqs, const int32_t* __restrict__ poison, int B,
                  int2* __restrict__ table, uint32_t mask, int32_t* __restrict__ rows,
                  int32_t* __restrict__ head, int32_t* __restrict__ res) {
  __shared__ BlockClaims bc;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    bc.n = 0;
    bc.poison = 0;
  }
  __syncthreads();
  block_poison(poison, B, bc, lane);
  for (int g = blockIdx.x; g * kBlockSlots < N; g += gridDim.x) {
    const int base0 = g * kBlockSlots + (threadIdx.x >> 5) * (32 * kSteps);
    if (base0 < N)
      warp_pairs(base0, lane, out, N, offs, freqs, poison, B, table, mask, rows, head, bc,
                 nullptr);
    flush_claims(bc, rows, head);
    __syncthreads();
    if (threadIdx.x == 0) {
      bc.n = 0;
      bc.poison = 0;
    }
    __syncthreads();
  }
  __threadfence();  // every thread's list entries, before the barrier
  __syncthreads();
  if (threadIdx.x == 0) {
    if (bc.poison) atomicAdd(head + 1, bc.poison);  // a block that took no slots
    __threadfence();
    atomicAdd(head + 3, 1);
    while (*reinterpret_cast<volatile int32_t*>(head + 3) < (int)gridDim.x) {
    }
    __threadfence();
  }
  __syncthreads();
  compact(table, rows, head, res);
}

int fused_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pair_fused_kernel, kThreads, 0);
    blocks = sms * per_sm;
  }
  return blocks;
}
#endif

}  // namespace

extern "C" {

int ctok_pair_count(const void* out, int N, const void* offs, const void* freqs,
                    const void* poison, int B, void* table, int T, void* rows, void* head,
                    void* res, void* stream) {
  if (N < 0 || B < 0 || T < 64 || (T & (T - 1)) != 0 || (int64_t)2 * N > T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int2* tab = static_cast<int2*>(table);
  int32_t* hd = static_cast<int32_t*>(head);
#if K19_FUSED
  {
    const int32_t* out_ = static_cast<const int32_t*>(out);
    const int32_t* offs_ = static_cast<const int32_t*>(offs);
    const int32_t* freqs_ = static_cast<const int32_t*>(freqs);
    const int32_t* poison_ = static_cast<const int32_t*>(poison);
    uint32_t mask = (uint32_t)(T - 1);
    int32_t* rows_ = static_cast<int32_t*>(rows);
    int32_t* res_ = static_cast<int32_t*>(res);
    void* kargs[] = {&out_, &N, &offs_, &freqs_, &poison_, &B, &tab, &mask, &rows_, &hd, &res_};
    const int blocks = max(1, min(fused_blocks(), (int)((N + kBlockSlots - 1) / kBlockSlots)));
    return (int)cudaLaunchCooperativeKernel((const void*)pair_fused_kernel, dim3(blocks),
                                            dim3(kThreads), kargs, 0, s);
  }
#endif
  if (N > 0 || B > 0) {
#if K19_WALK
    pair_walk_kernel<<<max(blocks_for(B), 1), kThreads, 0, s>>>(
        static_cast<const int32_t*>(out), static_cast<const int32_t*>(offs),
        static_cast<const int32_t*>(freqs), static_cast<const int32_t*>(poison), B, tab,
        (uint32_t)(T - 1), static_cast<int32_t*>(rows), hd);
#else
    pair_insert_kernel<<<max((int)((N + kBlockSlots - 1) / kBlockSlots), 1), kThreads, 0, s>>>(
        static_cast<const int32_t*>(out), N, static_cast<const int32_t*>(offs),
        static_cast<const int32_t*>(freqs), static_cast<const int32_t*>(poison), B, tab,
        (uint32_t)(T - 1), static_cast<int32_t*>(rows), hd);
#endif
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(min(max(blocks_for(N), 1), kCompactMaxBlocks));
#if K19_PDL
  return (int)ctok::launch_dependent(pair_compact_kernel, grid, dim3(kThreads), 0, s, tab,
                                     static_cast<const int32_t*>(rows), hd,
                                     static_cast<int32_t*>(res));
#else
  pair_compact_kernel<<<grid, kThreads, 0, s>>>(tab, static_cast<const int32_t*>(rows), hd,
                                                static_cast<int32_t*>(res));
  return (int)cudaGetLastError();
#endif
}

}  // extern "C"
