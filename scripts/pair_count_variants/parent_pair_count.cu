// K19 as the package shipped it before its redesign (commit 65588a4,
// csrc/wordpiece_train.cu), for scripts/study_pair_count_variants.py and
// chip_smoke.py to time in turns with the package's: the launcher clears a
// table of T int32 keys (-1 empty) and counts and the result's head with
// three cudaMemsetAsync; a thread a word inserts its pairs (atomicCAS claims
// a key's row, atomicAdd sums its count, linear probing from mix_hash(key,
// 0)); a second pass, a thread a row of all T, writes the rows whose count
// is above 0 as (key, count) into res [2 + 2 cap] after res[0] = their
// number (a warp's rows claim their places with one atomic); res[1] counts
// the poisoned words.  Built alone with the package's nvcc flags and -I
// complexity_tokenizer_tpu_torch/csrc.  Its entry keeps that commit's C
// signature.

#include <cstdint>
#include <cuda_runtime.h>

#include "chd_hash.cuh"

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;

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

}  // namespace

extern "C" {

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

}  // extern "C"
