// K7: the device batch decode's gather and compaction, hand-written for
// Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// complexity_tokenizer_tpu_torch/utils/cuda_build.py; no PyTorch headers.
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() of its launch.
//
// Replaces DecodePipeline._decode_fn of the JAX package
// (complexity_tokenizer_tpu/ops/decode.py:71-95), which XLA compiled for
// the TPU: it pads the batch to [B, T], gathers every id's bytes from a
// padded [V, W] table into [B, T, W], masks them by length and sorts each
// row's [T * W] bytes to compact them.  That layout grows with the longest
// token (W) and the longest row (T); at the corpus's 10,043 rows, one of
// them over 4,096 ids, it runs to gigabytes.  Here the ids come ragged (flat
// int32 ids, int64 row offsets), each id's bytes come from a byte arena
// (bytes plus int64 offsets [V + 1], the layout the native decoder takes),
// and the output is flat: the kept ids' bytes back to back, which is each
// row's concatenation in row order, and the row byte offsets.
//
// The function: id k is kept when 0 <= id < V and not (skip_special and
// special[id]); out bytes = the concatenation of arena[off[id]:off[id + 1]]
// over the kept ids in flat order; out_offsets[r] = the bytes of the kept
// ids before row r's first id.  Bound by bytes: ids in, the arena entries
// the ids touch, bytes out; there is no arithmetic to speak of.
//
// Design: two launches over tiles of 1,024 consecutive ids (one block a
// tile), so a long row spreads over many blocks and short rows share one.
//   1. ctok_decode_totals: each tile's kept bytes; the last block to finish
//      (a counter, zeroed by a memset node before the launch) scans the
//      tile totals into exclusive tile offsets, the last one the total.
//   2. ctok_decode_scatter: each tile again: its ids' arena starts and
//      lengths into shared memory, a block scan for each id's place in the
//      tile, the bytes copied id by id (neighbouring threads on neighbouring
//      ids; the first 8 bytes of a thread's four ids all loaded before any
//      is stored, so the loads' latencies overlap), and the offset of every
//      row that starts in the tile (two warps search the row offsets, 32
//      probes a step).
// The host reads the total between the two (to size the output by the live
// bytes); the output is one buffer, the B + 1 row offsets then the bytes, so
// that it goes back to the host in one copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// 64-bit values as long long, which every load intrinsic takes
using i64 = long long;
constexpr i64 kNoEnd = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // ids a block
constexpr int kStage = 8;  // bytes of an id copied through registers
constexpr uint32_t kAll = 0xFFFFFFFFu;

struct Table {
  const i64* off;          // [V + 1]
  const uint8_t* special;  // [V]
  int V;
  int skip_special;
};

// bytes of id that the output keeps (0 for a dropped id); *start gets the
// id's first byte in the arena
__device__ __forceinline__ int kept_len(const Table& t, int32_t id, i64* start) {
  *start = 0;
  if ((uint32_t)id >= (uint32_t)t.V) return 0;  // negative or past V
  if (t.skip_special && __ldg(t.special + id)) return 0;
  *start = __ldg(t.off + id);
  return (int)(__ldg(t.off + id + 1) - *start);
}

// exclusive block scan of one value a thread; *total gets the block's sum
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* total) {
  __shared__ T warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  T before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const T s = warp_sum[w];
    before += w < warp ? s : 0;
    sum += s;
  }
  __syncthreads();  // warp_sum may be reused by the next call
  *total = sum;
  return before + incl - v;
}

// first r in [0, B) with row_off[r] >= x (B when there is none), by one
// warp: 32 probes a step, so about log32(B) dependent loads instead of
// log2(B).  Every lane returns the answer.
__device__ __forceinline__ int warp_lower_bound(const i64* row_off, int B, i64 x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = B;  // row_off[r] < x for r < lo; hi == B or row_off[hi] >= x
  while (lo < hi) {
    const i64 span = hi - lo;
    const int p = lo + (int)(span * lane / 32);
    const unsigned below = __ballot_sync(kAll, row_off[p] < x);
    const int c = __popc(below);  // a prefix of the lanes where the rows are sorted
    const int new_lo = c > 0 ? lo + (int)(span * (c - 1) / 32) + 1 : lo;
    hi = c < 32 ? lo + (int)(span * c / 32) : hi;
    lo = new_lo;
  }
  return lo;
}

// launch 1: tile totals, then (last block) their exclusive scan into
// tile_off[0 .. n_tiles]; tile_off[n_tiles] is the total.
__global__ void __launch_bounds__(kThreads)
decode_totals_kernel(const int32_t* __restrict__ ids, i64 n, Table t,
                     i64* tile_off, unsigned int* done) {
  __shared__ bool is_last;
  const i64 base = (i64)blockIdx.x * kTile;
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const i64 j = base + threadIdx.x + k * kThreads;  // coalesced
    i64 start;
    if (j < n) sum += kept_len(t, ids[j], &start);
  }
  i64 tile_total;
  block_exclusive_scan<i64>(sum, &tile_total);
  if (threadIdx.x == 0) {
    tile_off[blockIdx.x + 1] = tile_total;
    __threadfence();  // the total is visible before the count says so
    is_last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int n_tiles = gridDim.x;
  i64 carry = 0;
  for (int c0 = 0; c0 < n_tiles; c0 += kThreads) {
    const int i = c0 + threadIdx.x;
    const i64 v = i < n_tiles ? __ldcg(tile_off + i + 1) : 0;  // past L1
    i64 chunk;
    const i64 excl = block_exclusive_scan<i64>(v, &chunk);
    if (i < n_tiles) tile_off[i + 1] = carry + excl + v;
    carry += chunk;
  }
  if (threadIdx.x == 0) tile_off[0] = 0;
}

// launch 2: the bytes and the row offsets.  out holds the B + 1 int64 row
// offsets, then tile_off[n_tiles] bytes.
__global__ void __launch_bounds__(kThreads)
decode_scatter_kernel(const int32_t* __restrict__ ids, i64 n,
                      const i64* __restrict__ row_off, int B, Table t,
                      const uint8_t* __restrict__ arena,
                      const i64* __restrict__ tile_off,
                      uint8_t* __restrict__ out) {
  __shared__ i64 s_start[kTile];
  __shared__ int32_t s_len[kTile];
  __shared__ int32_t s_pos[kTile];
  __shared__ int s_rows[2];
  const int tid = threadIdx.x;
  const i64 base = (i64)blockIdx.x * kTile;
  const bool last_tile = blockIdx.x == gridDim.x - 1;
  if (tid < 64) {
    // warps 0 and 1: the rows that start in this tile; the last tile also
    // takes the rows that start at n (empty rows at the end)
    const i64 x = tid < 32 ? base : (last_tile ? kNoEnd : base + kTile);
    const int r = warp_lower_bound(row_off, B, x);
    if ((tid & 31) == 0) s_rows[tid >> 5] = r;
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = tid + k * kThreads;
    const i64 j = base + i;
    i64 start;
    s_len[i] = kept_len(t, j < n ? ids[j] : -1, &start);
    s_start[i] = start;
  }
  __syncthreads();
  // each thread scans its four consecutive ids, then the block scans the
  // threads' sums
  int len4[kPerThread], sum = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    len4[k] = s_len[kPerThread * tid + k];
    sum += len4[k];
  }
  int tile_total;
  int pos = block_exclusive_scan<int>(sum, &tile_total);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    s_pos[kPerThread * tid + k] = pos;
    pos += len4[k];
  }
  __syncthreads();
  const i64 tile_base = tile_off[blockIdx.x];
  uint8_t* bytes = out + 8 * ((i64)B + 1);
  // each id's bytes: the first kStage of every id of the thread loaded
  // before any is stored (the loads do not wait on the stores), the rest of
  // a longer id byte by byte
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = tid + k * kThreads;
    const int len = s_len[i];
    const uint8_t* src = arena + s_start[i];
    uint8_t v[kStage];
#pragma unroll
    for (int b = 0; b < kStage; ++b) v[b] = b < len ? __ldg(src + b) : 0;
    const i64 dst = tile_base + s_pos[i];
#pragma unroll
    for (int b = 0; b < kStage; ++b)
      if (b < len) bytes[dst + b] = v[b];
    for (int b = kStage; b < len; ++b) bytes[dst + b] = __ldg(src + b);
  }
  const i64 total = tile_off[gridDim.x];
  i64* out_off = reinterpret_cast<i64*>(out);
  for (int r = s_rows[0] + tid; r < s_rows[1]; r += kThreads) {
    const i64 d = row_off[r] - base;
    out_off[r] = row_off[r] >= n ? total
                 : (d >= 0 && d < kTile ? tile_base + s_pos[d] : 0);
  }
  if (last_tile && tid == 0) out_off[B] = total;
}

}  // namespace

extern "C" {

// launch 1.  scratch: int64 [n_tiles + 2]; [0 .. n_tiles] the exclusive
// tile offsets (the last the total), [n_tiles + 1] the done counter.
int ctok_decode_totals(const void* ids, long long n, const void* arena,
                       const void* off, const void* special, int V,
                       int skip_special, void* scratch, void* stream) {
  if (n <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  auto* tile_off = static_cast<i64*>(scratch);
  auto* done = reinterpret_cast<unsigned int*>(tile_off + tiles + 1);
  const auto s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(done, 0, sizeof(unsigned int), s);
  if (e != cudaSuccess) return (int)e;
  const Table t{static_cast<const i64*>(off), static_cast<const uint8_t*>(special), V,
                skip_special};
  decode_totals_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      static_cast<const int32_t*>(ids), n, t, tile_off, done);
  return (int)cudaGetLastError();
}

// launch 2.  out: int64 [B + 1] row offsets, then the total bytes.
int ctok_decode_scatter(const void* ids, long long n, const void* row_off, int B,
                        const void* arena, const void* off, const void* special,
                        int V, int skip_special, const void* scratch, void* out,
                        void* stream) {
  if (n <= 0 || B < 0 || V <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const Table t{static_cast<const i64*>(off), static_cast<const uint8_t*>(special), V,
                skip_special};
  decode_scatter_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(ids), n, static_cast<const i64*>(row_off), B, t,
      static_cast<const uint8_t*>(arena), static_cast<const i64*>(scratch),
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
