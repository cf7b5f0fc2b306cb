// Designs of K13 (csrc/train.cu's ctok_pair_hist) that the package does not
// ship, for scripts/study_hist_variants.py only.  Built alone with the
// package's nvcc flags, -I complexity_tokenizer_tpu_torch/csrc and one set of
// these macros:
// - K13_SLICED: past 241 ids, 2 (the package) the slices on blockIdx.y, a
//   block a slice reading the rows of its x; 1 the slices over a thread
//   block cluster's distributed shared memory, a block of the cluster a
//   slice, every block reading its own rows and adding into the slice that
//   holds the key;
// - K13_GRID > 0: that many blocks (or blocks along x) in place of the
//   plan's.
// With neither set, this is the package's K13.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "hist_clear.cuh"

#ifndef K13_SLICED
#define K13_SLICED 2
#endif
#ifndef K13_GRID
#define K13_GRID 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kAll = 0xFFFFFFFFu;

// ---------------------------------------------------------------------------
// K13 as csrc/train.cu writes it (see its comments), with the two switches.
constexpr int kHistThreads = 1024;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistStep = 128;              // slots a warp reads a step
constexpr int kHistSmemBytes = 232448;      // a block's shared memory on the H100 (opt-in)
constexpr int kHistSliceBins = kHistSmemBytes / 4;
constexpr int kHistMaxSlices = 8;           // the portable cluster size

// branch 0: a block's histogram; 1: in slices; 2: global atomics.  groups:
// blocks (branch 0), clusters or blocks along x (branch 1).
struct HistPlan {
  int branch, slices, slice_bins, groups;
};

HistPlan pair_hist_plan(int64_t slots, int v0, int sms) {
  const int64_t bins = (int64_t)v0 * v0;
  if (bins > (int64_t)kHistMaxSlices * kHistSliceBins) return {2, 0, 0, 0};
  const int slices = (int)((bins + kHistSliceBins - 1) / kHistSliceBins);
  const int64_t steps = (slots + kHistStep - 1) / kHistStep;
  int64_t groups = (steps + (int64_t)kHistWarps * slices - 1) / ((int64_t)kHistWarps * slices);
  const int64_t fill = sms / slices > 1 ? sms / slices : 1;
  if (groups > fill) groups = fill;
  if (groups < 1) groups = 1;
  if (K13_GRID > 0) groups = K13_GRID;
  return {slices > 1 ? 1 : 0, slices, (int)((bins + slices - 1) / slices), (int)groups};
}

// The pairs of the steps reader, reader + n_readers, ... (a warp each): the
// valid ones go to add(key, freq).
template <class Add>
__device__ __forceinline__ void hist_walk(const int32_t* __restrict__ words,
                                          const int32_t* __restrict__ freqs, int64_t slots,
                                          int W, int v0, int64_t reader, int64_t n_readers,
                                          Add add) {
  const int lane = threadIdx.x & 31;
  const int64_t n_keys = (int64_t)v0 * v0;
  const int64_t stride = n_readers * kHistStep;
  // the row and column of the lane's first slot, and their steps: a step
  // of the warp (stride slots) and of the lane's next load (32 slots)
  const int64_t first = reader * kHistStep + lane;
  int row = (int)(first / W), col = (int)(first - (int64_t)row * W);
  const int row_stride = (int)(stride / W), col_stride = (int)(stride % W);
  const int row32 = 32 / W, col32 = 32 % W;
  for (int64_t e0 = first; e0 - lane < slots; e0 += stride) {
    int32_t v[4], f[4], c[4];
    int r = row, cc = col;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t e = e0 + 32 * j;
      const bool in = e < slots;
      v[j] = in ? __ldg(words + e) : -1;
      f[j] = in ? __ldg(freqs + r) : 0;
      c[j] = cc;
      r += row32;
      cc += col32;
      if (cc >= W) {
        cc -= W;
        ++r;
      }
    }
    const int64_t e4 = e0 - lane + kHistStep;
    const int32_t v4 = lane == 0 && e4 < slots ? __ldg(words + e4) : -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int32_t next = __shfl_down_sync(kAll, v[j], 1);
      const int32_t wrap = __shfl_sync(kAll, j < 3 ? v[j + 1] : v4, 0);
      const int32_t rt = lane == 31 ? wrap : next;
      const int32_t l = v[j];
      if (c[j] + 1 < W && l >= 0 && rt >= 0) {
        const int64_t key = (int64_t)l * v0 + rt;
        if (key < n_keys) add((int)key, f[j]);
      }
    }
    row += row_stride;
    col += col_stride;
    if (col >= W) {
      col -= W;
      ++row;
    }
  }
}

// Branch 0 (gridDim.y 1, slice_bins v0 * v0) and branch 1 on blockIdx.y
// (kCluster false), or branch 1 over a cluster (kCluster true).
template <bool kCluster>
__global__ void __launch_bounds__(kHistThreads)
pair_hist_kernel(const int32_t* __restrict__ words, const int32_t* __restrict__ freqs,
                 int64_t slots, int W, int v0, int slice_bins, int32_t* __restrict__ hist) {
  extern __shared__ int32_t sh[];
  const int bins = v0 * v0;
  int slice;
  if constexpr (kCluster)
    slice = (int)cg::this_cluster().block_rank();
  else
    slice = blockIdx.y;
  const int lo = slice * slice_bins;
  const int n = min(slice_bins, bins - lo);
  for (int i = threadIdx.x; i < n; i += kHistThreads) sh[i] = 0;
  const int64_t reader = (int64_t)blockIdx.x * kHistWarps + (threadIdx.x >> 5);
  const int64_t n_readers = (int64_t)gridDim.x * kHistWarps;
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every slice of the cluster is zero
    hist_walk(words, freqs, slots, W, v0, reader, n_readers, [&](int key, int32_t f) {
      const int dst = key / slice_bins;
      atomicAdd(cluster.map_shared_rank(sh, dst) + (key - dst * slice_bins), f);
    });
    cluster.sync();  // every add into this block's slice has landed
  } else {
    __syncthreads();
    hist_walk(words, freqs, slots, W, v0, reader, n_readers, [&](int key, int32_t f) {
      const int k = key - lo;
      if (k >= 0 && k < n) atomicAdd(sh + k, f);
    });
    __syncthreads();
  }
  // the clear of hist (the launch before this one) has ended
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int i = threadIdx.x; i < n; i += kHistThreads) {
    const int32_t c = sh[i];
    if (c != 0) atomicAdd(hist + lo + i, c);
  }
}

// The first design, for a v0 past the plan's reach: a thread a slot pair,
// one global atomic a pair.
__global__ void __launch_bounds__(kThreads)
pair_hist_global_kernel(const int32_t* __restrict__ words, const int32_t* __restrict__ freqs,
                        int N, int W, int v0, int32_t* __restrict__ hist) {
  const int64_t pairs = (int64_t)N * (W - 1);
  const int64_t n_keys = (int64_t)v0 * v0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < pairs;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = i / (W - 1);
    const int64_t c = i - r * (W - 1);
    const int32_t l = words[r * W + c];
    const int32_t rt = words[r * W + c + 1];
    if (l < 0 || rt < 0) continue;
    const int64_t key = (int64_t)l * v0 + rt;
    if (key < n_keys) atomicAdd(&hist[key], freqs[r]);
  }
}

int blocks_for(int64_t n, int threads, int64_t cap) {
  int64_t g = (n + threads - 1) / threads;
  if (g > cap) g = cap;
  return (int)(g < 1 ? 1 : g);
}

// K13's kernels may take up to kHistSmemBytes of dynamic shared memory: the
// opt-in once a kernel and device (outside a CUDA graph's capture after a
// first call)
cudaError_t allow_hist_smem(void (*kernel)(const int32_t*, const int32_t*, int64_t, int, int,
                                           int, int32_t*),
                            bool cluster) {
  static unsigned done[2] = {0, 0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done[cluster] & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kHistSmemBytes);
  if (err == cudaSuccess) done[cluster] |= bit;
  return err;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

}  // namespace

extern "C" {

// K13: words [N, W], freqs [N] int32 -> hist [v0 * v0] int32, cleared here
int ctok_pair_hist(const int32_t* words, const int32_t* freqs, int N, int W, int v0,
                   int32_t* hist, cudaStream_t stream) {
  if (N < 0 || W < 0 || v0 < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = ctok_hist::launch_clear(hist, (int64_t)v0 * v0, stream);
  if (err != cudaSuccess || N == 0 || W < 2) return (int)err;
  const int64_t slots = (int64_t)N * W;
  const HistPlan p = pair_hist_plan(slots, v0, sm_count());
  if (p.branch == 2) {
    const int64_t pairs = (int64_t)N * (W - 1);
    pair_hist_global_kernel<<<blocks_for(pairs, kThreads, 132 * 16), kThreads, 0, stream>>>(
        words, freqs, N, W, v0, hist);
    return (int)cudaGetLastError();
  }
  const bool cluster = p.branch == 1 && K13_SLICED == 1;
  const auto kernel = cluster ? &pair_hist_kernel<true> : &pair_hist_kernel<false>;
  const size_t smem = sizeof(int32_t) * (size_t)p.slice_bins;
  err = allow_hist_smem(kernel, cluster);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = cluster ? dim3(p.groups * p.slices) : dim3(p.groups, p.slices);
  if (!cluster)
    return (int)ctok::launch_dependent(kernel, grid, dim3(kHistThreads), smem, stream,
                                            words, freqs, slots, W, v0, p.slice_bins, hist);
  // the clear's programmatic dependent, its blocks in clusters of p.slices
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kHistThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = (unsigned)p.slices;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, words, freqs, slots, W, v0, p.slice_bins, hist);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
