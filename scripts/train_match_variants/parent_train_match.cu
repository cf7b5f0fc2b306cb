// K18 as the package shipped it before its redesign (commit c29595f,
// csrc/wordpiece_train.cu), for scripts/study_train_match_variants.py and
// chip_smoke.py to time in turns with the package's: a thread a word, the
// candidate lengths of a start one after another (each length's two hashes
// grown a step, then its probe run of up to 16 rows, then the length guard's
// read of slot_meta), the exact check of the longest hit, the word's -1 fill
// by its thread.  Built alone with the package's nvcc flags and -I
// complexity_tokenizer_tpu_torch/csrc.  Its entry keeps that commit's
// arguments under a name of its own, ctok_train_match_parent.

#include <cstdint>
#include <cuda_runtime.h>

#include "chd_hash.cuh"

namespace {

constexpr uint32_t kB1 = 0x01000193u;
constexpr uint32_t kB2 = 0x0BADC0DFu;
constexpr uint32_t kSeed1 = 0x9E3779B9u;
constexpr uint32_t kSeed2 = 0x7F4A7C15u;
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

int blocks_for(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// chars [N], offs [B + 1], lens [B] int32; table [T] int4 (16-byte
// aligned), t_mask = T - 1; slot_meta [S] int2; slot_chars [S, 128]; fb_map
// [2, 0x110000]; lt_cap 1..128 -> out [N] int32, poison [B] int32
int ctok_train_match_parent(const void* chars, const void* offs, const void* lens, int B,
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

}  // extern "C"
