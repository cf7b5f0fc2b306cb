// Designs of K17 (csrc/unigram_train.cu's ctok_piece_hist) that the package
// does not ship, for scripts/study_hist_variants.py only.  Built alone with
// the package's nvcc flags, -I complexity_tokenizer_tpu_torch/csrc and one
// set of these macros; with none set, this is the package's K17 (a thread a
// text, its first K17_PREFETCH ids loaded before the wait for the clear):
// - K17_PREFETCH: the ids a thread loads before griddepcontrol.wait (the
//   package's 16; 0 is the first design's body behind the clear);
// - K17_THREADS: threads a block of that kernel (the package's 128);
// - K17_GIDX_LATE 1: a poisoned text's place loaded after the wait (the
//   package loads every text's before it);
// - K17_BODY 0: the first redesign, a warp 32 texts: their offsets,
//   frequencies and flags in registers, their slots in coalesced steps of
//   32, K17_BATCH steps (16) loaded and searched at once, a slot's text by
//   a shuffle search over the warp's offsets, the first batch before the
//   wait; with it
//   - K17_AGGREGATE 1: the lanes of a step holding one id add their summed
//     frequency with one atomic (__match_any_sync, __reduce_add_sync); 2:
//     the same, only in a step where two neighbouring lanes hold one id;
//   - K17_CLEAR 3: one cooperative launch: every block clears its share of
//     buf, loads, and waits at a grid barrier;
// - K17_CLEAR (either body): 0 the caller zeroes buf (the first design's
//   torch.zeros), 1 cudaMemsetAsync in the entry, 2 (the package) a clear
//   kernel with K17 as its programmatic dependent (hist_clear.cuh);
// - K17_FLAGS 1: every text writes its flag, 0 too (the package writes only
//   a poisoned text's 1 into the cleared buffer);
// - K17_ABLATE 1: the entry runs the clear alone (timed only).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "hist_clear.cuh"

#ifndef K17_BODY
#define K17_BODY 1
#endif
#ifndef K17_PREFETCH
#define K17_PREFETCH 16
#endif
#ifndef K17_THREADS
#define K17_THREADS 128
#endif
#ifndef K17_CLEAR
#define K17_CLEAR 2
#endif
#ifndef K17_AGGREGATE
#define K17_AGGREGATE 0
#endif
#ifndef K17_BATCH
#define K17_BATCH 16
#endif
#ifndef K17_FLAGS
#define K17_FLAGS 0
#endif
#ifndef K17_ABLATE
#define K17_ABLATE 0
#endif
#ifndef K17_GIDX_LATE
#define K17_GIDX_LATE 0
#endif

#if K17_CLEAR == 3
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
#endif

namespace {

constexpr uint32_t kAll = 0xFFFFFFFFu;

// ---------------------------------------------------------------------------
// The package's body: a thread a text
constexpr int kThreads = K17_THREADS;
constexpr int kPrefetch = K17_PREFETCH;

__global__ void __launch_bounds__(kThreads)
piece_hist_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ offs,
                  const int32_t* __restrict__ freqs, const int32_t* __restrict__ gidx, int B,
                  int N, int V, int32_t* __restrict__ buf) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool have = j < B;
  const bool poisoned = have && __ldg(res + N + B + j) != 0;
  const int32_t f = have ? __ldg(freqs + j) : 0;
#if !K17_GIDX_LATE
  const int g = have ? __ldg(gidx + j) : 0;
#endif
  const int start = have ? __ldg(offs + j) : 0;
  const int end = have ? __ldg(offs + j + 1) : 0;
  int32_t first[kPrefetch > 0 ? kPrefetch : 1];
#pragma unroll
  for (int u = 0; u < kPrefetch; ++u) first[u] = start + u < end ? __ldg(res + start + u) : -1;
  asm volatile("griddepcontrol.wait;" ::: "memory");
#if K17_GIDX_LATE
  const int g = have && (K17_FLAGS || poisoned) ? __ldg(gidx + j) : 0;
#endif
#if K17_FLAGS
  if (have) buf[V + g] = poisoned;
  if (poisoned) return;
#else
  if (poisoned) {
    buf[V + g] = 1;
    return;
  }
#endif
#pragma unroll
  for (int u = 0; u < kPrefetch; ++u)
    if (first[u] >= 0 && first[u] < V) atomicAdd(buf + first[u], f);
  for (int p = start + kPrefetch; p < end; ++p) {
    const int32_t id = __ldg(res + p);
    if (id >= 0 && id < V) atomicAdd(buf + id, f);
  }
}

// ---------------------------------------------------------------------------
// K17_BODY 0: a warp 32 texts
constexpr int kWarpThreads = 128;
constexpr int kBatch = K17_BATCH;

// A step of 32 slots from base: each lane's id and its text's frequency
// (0 where the slot is past the warp's texts, its id below 0 or at or past
// V, or its text poisoned).  The steps of a batch are independent, so their
// loads and searches are in flight together.
__device__ __forceinline__ void load_batch(const int32_t* __restrict__ res, int base, int end,
                                           int V, int off, int32_t f, int lane,
                                           int32_t (&ids)[kBatch], int32_t (&fv)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int p = base + 32 * u + lane;
    ids[u] = p < end ? __ldg(res + p) : -1;
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int p = base + 32 * u + lane;
    // the largest t with text t's first slot at or before p
    int t = 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      if (__shfl_sync(kAll, off, t + s) <= p) t += s;
    const int32_t ft = __shfl_sync(kAll, f, t);
    fv[u] = p < end && ids[u] >= 0 && ids[u] < V ? ft : 0;
  }
}

__device__ __forceinline__ void add_batch(int32_t* __restrict__ buf, int lane,
                                          const int32_t (&ids)[kBatch],
                                          const int32_t (&fv)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const bool valid = fv[u] != 0;
#if K17_AGGREGATE == 2
    // only a step where two neighbouring lanes hold one id (a hot id)
    const int32_t left = __shfl_up_sync(kAll, ids[u], 1);
    if (__any_sync(kAll, valid && lane > 0 && left == ids[u])) {
#endif
#if K17_AGGREGATE
      const unsigned grp = __match_any_sync(kAll, valid ? ids[u] : -1);
      const int32_t sum = (int32_t)__reduce_add_sync(grp, valid ? (uint32_t)fv[u] : 0u);
      if (valid && lane == __ffs(grp) - 1) atomicAdd(buf + ids[u], sum);
#endif
#if K17_AGGREGATE == 2
    } else if (valid) {
      atomicAdd(buf + ids[u], fv[u]);
    }
#elif !K17_AGGREGATE
    if (valid) atomicAdd(buf + ids[u], fv[u]);
#endif
  }
}

// What a warp holds of its 32 texts j0 .. j0 + 31: text j0 + t's slots are
// [off of lane t, off of lane t + 1) (a lane past B holds INT_MAX, which no
// slot reaches), the group's end, and its own text's frequency (0 when
// poisoned), flag and place in the corpus
struct Texts {
  int off, start, end, g;
  int32_t f, poisoned;
  bool have;
};

__device__ __forceinline__ Texts load_texts(const int32_t* __restrict__ res,
                                            const int32_t* __restrict__ offs,
                                            const int32_t* __restrict__ freqs,
                                            const int32_t* __restrict__ gidx, int B, int N,
                                            int j0, int lane) {
  Texts x;
  const int j = j0 + lane;
  x.have = j < B;
  x.off = x.have ? __ldg(offs + j) : INT_MAX;
  x.start = __shfl_sync(kAll, x.off, 0);
  x.end = __ldg(offs + min(j0 + 32, B));
  x.poisoned = x.have && __ldg(res + N + B + j) != 0;
  const int32_t f = x.have ? __ldg(freqs + j) : 0;  // not behind the flag's load
  x.f = x.poisoned ? 0 : f;
  x.g = (K17_FLAGS ? x.have : x.poisoned) ? __ldg(gidx + j) : 0;
  return x;
}

// A warp a group of 32 texts (the grid's warps walk the groups; with
// K17_CLEAR 3 the grid is what the card holds at once, and every block
// first clears its share of buf).  The first group's loads and searches
// come before the wait for the clear.
__global__ void __launch_bounds__(kWarpThreads)
piece_hist_warp_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ offs,
                       const int32_t* __restrict__ freqs, const int32_t* __restrict__ gidx, int B,
                       int N, int V, int64_t n_buf, int32_t* __restrict__ buf) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarpThreads;
#if K17_CLEAR == 3
  ctok_hist::clear_slice(buf, n_buf, (int64_t)blockIdx.x * kWarpThreads + threadIdx.x, stride);
#endif
  int64_t j0 = (int64_t)blockIdx.x * kWarpThreads + threadIdx.x - lane;  // the warp's first text
  Texts x{};
  int32_t ids[kBatch], fv[kBatch];
  if (j0 < B) {  // the whole warp
    x = load_texts(res, offs, freqs, gidx, B, N, (int)j0, lane);
    load_batch(res, x.start, x.end, V, x.off, x.f, lane, ids, fv);
  }
#if K17_CLEAR == 2
  // the clear (the launch before this one) has ended and its zeros are
  // visible: only the writes wait for it
  asm volatile("griddepcontrol.wait;" ::: "memory");
#elif K17_CLEAR == 3
  cg::this_grid().sync();  // every block's share of buf is zero
#endif
  for (bool first = true; j0 < B; j0 += stride, first = false) {
    if (!first) {
      x = load_texts(res, offs, freqs, gidx, B, N, (int)j0, lane);
      load_batch(res, x.start, x.end, V, x.off, x.f, lane, ids, fv);
    }
#if K17_FLAGS
    if (x.have) buf[V + x.g] = x.poisoned;
#else
    if (x.poisoned) buf[V + x.g] = 1;
#endif
    add_batch(buf, lane, ids, fv);
    for (int base = x.start + 32 * kBatch; base < x.end; base += 32 * kBatch) {
      load_batch(res, base, x.end, V, x.off, x.f, lane, ids, fv);
      add_batch(buf, lane, ids, fv);
    }
  }
}

}  // namespace

extern "C" {

// K17: res [N + 2B] int32 (K12's out, count, poison), offs [B + 1], freqs
// [B], gidx [B] int32 -> buf [V + n_global] int32 (cleared here unless
// K17_CLEAR is 0)
int ctok_piece_hist(const void* res, const void* offs, const void* freqs, const void* gidx,
                    int B, int N, int V, int n_global, void* buf, void* stream) {
  if (B < 0 || N < 0 || V < 1 || n_global < 0) return (int)cudaErrorInvalidValue;
  auto* out = static_cast<int32_t*>(buf);
  const auto s = (cudaStream_t)stream;
  const int64_t n_buf = (int64_t)V + n_global;
  cudaError_t err = cudaSuccess;
#if K17_CLEAR == 1
  err = cudaMemsetAsync(out, 0, sizeof(int32_t) * (size_t)n_buf, s);
#elif K17_CLEAR == 2
  err = ctok_hist::launch_clear(out, n_buf, s);
#endif
  if (err != cudaSuccess || K17_ABLATE || (B == 0 && K17_CLEAR != 3)) return (int)err;
  const auto* r = static_cast<const int32_t*>(res);
  const auto* o = static_cast<const int32_t*>(offs);
  const auto* f = static_cast<const int32_t*>(freqs);
  const auto* g = static_cast<const int32_t*>(gidx);
#if K17_BODY
  const dim3 grid((unsigned)((B + kThreads - 1) / kThreads));
#if K17_CLEAR == 2
  return (int)ctok::launch_dependent(piece_hist_kernel, grid, dim3(kThreads), 0, s, r, o, f,
                                          g, B, N, V, out);
#else
  piece_hist_kernel<<<grid, kThreads, 0, s>>>(r, o, f, g, B, N, V, out);
  return (int)cudaGetLastError();
#endif
#else
  int64_t blocks = ((int64_t)B + kWarpThreads - 1) / kWarpThreads;
#if K17_CLEAR == 2
  return (int)ctok::launch_dependent(piece_hist_warp_kernel, dim3((unsigned)blocks),
                                          dim3(kWarpThreads), 0, s, r, o, f, g, B, N, V, n_buf,
                                          out);
#elif K17_CLEAR == 3
  // a cooperative launch of no more blocks than the card holds at once
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, piece_hist_warp_kernel,
                                                        kWarpThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (blocks > (int64_t)sms * per_sm) blocks = (int64_t)sms * per_sm;
  if (blocks < 1) blocks = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kWarpThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, piece_hist_warp_kernel, r, o, f, g, B, N, V, n_buf, out);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
#else
  piece_hist_warp_kernel<<<(unsigned)blocks, kWarpThreads, 0, s>>>(r, o, f, g, B, N, V, n_buf,
                                                                   out);
  return (int)cudaGetLastError();
#endif
#endif
}

}  // extern "C"
