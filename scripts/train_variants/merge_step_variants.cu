// Designs of K14 (csrc/train.cu's ctok_merge_step) and of K16's launch
// (ctok_hist_update) that the package does not ship, for
// scripts/study_merge_variants.py only, with K15 (ctok_select_argmax,
// ctok_select_window) as the package has it.  The entries have the
// package's C signatures.  Built alone with the package's nvcc flags,
// -I complexity_tokenizer_tpu_torch/csrc and one set of these macros:
// - K14_THREADS: threads a block (the package 128);
// - K14_ROWS: rows a warp scans (the package 16; 32 and 8 measured);
// - K14_BATCH: loads of 32 slots a lane keeps in flight (the package 8);
// - K14_TILE: 1 (the package) the scan also stores the warp's rows in
//   shared memory (rows up to 64 slots) and the walk reads them there; 0
//   the walk reads the lines the scan brought into L1;
// - K14_PDL: 0 (the package) a plain launch on both routes; 1 with a
//   merge log (the device-resident steps) K14 is the programmatic
//   dependent of the kernel before it (K15) and waits for it before
//   reading, without one a plain launch; 3 the dependent launch on both
//   routes; 2 as 1, but with K14_TILE and a merge log the rows are loaded
//   into shared memory before the wait (right only when the kernel before
//   does not write the rows: K15);
// - K14_CLEAR: how `zero` is zeroed.  0 (the package) by K14 as it runs
//   (the per-merge route passes the other of two buffers that take turns);
//   1 by a clear kernel of its own launched before K14, K14 its
//   programmatic dependent scanning while it runs and waiting before its
//   first write (the route then passes the merge's own buffer: one buffer,
//   cleared before each merge); 2 as 1, K14 waiting for the clear before
//   it reads anything;
// - K16_PDL: 1 (the package) K16 is the programmatic dependent of the
//   kernel before it; 0 a plain launch.
// With none set, this is the package's K14, K15 and K16.

#include <cstdint>
#include <cuda_runtime.h>

#include "hist_clear.cuh"

#ifndef K14_THREADS
#define K14_THREADS 128
#endif
#ifndef K14_ROWS
#define K14_ROWS 16
#endif
#ifndef K14_BATCH
#define K14_BATCH 8
#endif
#ifndef K14_TILE
#define K14_TILE 1
#endif
#ifndef K14_PDL
#define K14_PDL 0
#endif
#ifndef K14_CLEAR
#define K14_CLEAR 0
#endif
#ifndef K16_PDL
#define K16_PDL 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWindowThreads = 1024;
constexpr int kMaxArgmaxBlocks = 132 * 4;
constexpr uint32_t kAll = 0xFFFFFFFFu;
constexpr int kMergeThreads = K14_THREADS;
constexpr int kMergeRows = K14_ROWS;
constexpr int kMergeBatch = K14_BATCH;
constexpr int kTileMaxW = 64;  // K14_TILE: the widest rows kept in shared memory

// ---------------------------------------------------------------------------
// K14, as csrc/train.cu writes it (see its comments), with the switches.
__device__ __forceinline__ int next_alive(const int32_t* t, int p, int W) {
  while (p < W && t[p] < 0) ++p;
  return p;
}

__device__ __forceinline__ void add_delta(int32_t* delta, int V, int x, int kind, int32_t f) {
  if (x < V) atomicAdd(&delta[x * 4 + kind], f);
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The row's merge, read from t and written to out (the same row in
// global memory, or t itself)
__device__ __forceinline__ int32_t merge_row(const int32_t* t, int32_t* out, int W, int32_t f,
                                             int a, int b, int new_id,
                                             int32_t* __restrict__ delta, int V) {
  int32_t row_minted = 0;
  int prev = -1;
  bool prev_partner = false;
  int pos = next_alive(t, 0, W);
  int v = pos < W ? t[pos] : -1;
  while (pos < W) {
    const int nx = next_alive(t, pos + 1, W);
    const int vn = nx < W ? t[nx] : -1;
    if (v == a && nx < W && vn == b) {
      const int yp = next_alive(t, nx + 1, W);
      const int y = yp < W ? t[yp] : -1;
      if (prev >= 0) {
        add_delta(delta, V, prev, 0, f);
        add_delta(delta, V, prev_partner ? new_id : prev, 2, f);
      }
      if (yp < W) {
        const int yn = next_alive(t, yp + 1, W);
        const bool y_taken = y == a && yn < W && t[yn] == b;
        if (!y_taken) {
          add_delta(delta, V, y, 1, f);
          add_delta(delta, V, y, 3, f);
        }
      }
      out[pos] = new_id;
      out[nx] = -1;
      row_minted += f;
      prev = b;
      prev_partner = true;
      pos = yp;
      v = y;
    } else {
      prev = v;
      prev_partner = false;
      pos = nx;
      v = vn;
    }
  }
  return row_minted;
}

__global__ void __launch_bounds__(kMergeThreads)
merge_step_kernel(int32_t* __restrict__ words, const int32_t* __restrict__ freqs, int N, int W,
                  const int32_t* __restrict__ ma, const int32_t* __restrict__ mb, int step,
                  int a, int b, int new_id, int32_t* __restrict__ delta, int V,
                  int32_t* __restrict__ minted, int32_t* __restrict__ zero, int64_t zero_n,
                  int after_clear) {
  extern __shared__ int32_t tile_all[];
  asm volatile("griddepcontrol.launch_dependents;");
  const bool tile = K14_TILE && W <= kTileMaxW;
  const bool early = K14_PDL == 2 && tile && ma != nullptr;
  const bool scan_first = (after_clear && K14_CLEAR == 1) || early;
  // the package's K14 (K14_PDL 0, no clear kernel) waits for nothing
  if ((K14_PDL != 0 || after_clear) && !scan_first) grid_dependency_wait();
  if (zero_n > 0)  // K14_CLEAR 0: zeroed by every thread of the grid
    ctok_hist::clear_slice(zero, zero_n, (int64_t)blockIdx.x * kMergeThreads + threadIdx.x,
                           (int64_t)gridDim.x * kMergeThreads);
  const int lane = threadIdx.x & 31;
  const int64_t row0 =
      (((int64_t)blockIdx.x * kMergeThreads + threadIdx.x) >> 5) * kMergeRows;
  const int rows = row0 >= N || W == 0 ? 0 : N - row0 < kMergeRows ? (int)(N - row0) : kMergeRows;
  const int64_t n = (int64_t)rows * W;
  const int32_t* src = words + row0 * W;
  int32_t* t_sh = tile_all + (threadIdx.x >> 5) * kMergeRows * W;
  if (early) {  // the rows into shared memory before the wait
    for (int64_t e = lane; e < n; e += 32) t_sh[e] = src[e];
    grid_dependency_wait();
  }
  if (ma != nullptr) {
    a = ma[step];
    b = mb[step];
    if (a < 0) return;
  }
  if (rows == 0) return;
  uint32_t has_a = 0, has_b = 0;
  int r = lane / W, c = lane % W;
  const int r32 = 32 / W, c32 = 32 % W;
  for (int64_t e0 = lane; e0 < n; e0 += 32 * kMergeBatch) {
    int32_t v[kMergeBatch];
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const int64_t e = e0 + 32 * j;
      v[j] = e < n ? (early ? t_sh[e] : src[e]) : -1;
    }
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const int64_t e = e0 + 32 * j;
      if (tile && !early && e < n) t_sh[e] = v[j];
      if (v[j] == a) has_a |= 1u << r;
      if (v[j] == b) has_b |= 1u << r;
      r += r32;
      c += c32;
      if (c >= W) {
        c -= W;
        ++r;
      }
    }
  }
  const uint32_t walk = __reduce_or_sync(kAll, has_a) & __reduce_or_sync(kAll, has_b);
  if (walk == 0) return;
  if (after_clear && K14_CLEAR == 1) grid_dependency_wait();
  if (tile) __syncwarp();
  int32_t row_minted = 0;
  if (lane < kMergeRows && ((walk >> lane) & 1u)) {
    int32_t* out = words + (row0 + lane) * W;
    row_minted = merge_row(tile ? t_sh + lane * W : out, out, W, freqs[row0 + lane], a, b,
                           new_id, delta, V);
  }
  const int32_t warp_minted = __reduce_add_sync(kAll, row_minted);
  if (lane == 0 && warp_minted != 0) atomicAdd(minted, warp_minted);
}

// K14_CLEAR 1 and 2: zero [n] cleared before K14, K14 the programmatic
// dependent
__global__ void __launch_bounds__(ctok_hist::kClearThreads)
merge_clear_kernel(int32_t* __restrict__ zero, int64_t n) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int64_t tid = (int64_t)blockIdx.x * ctok_hist::kClearThreads + threadIdx.x;
  ctok_hist::clear_slice(zero, n, tid, (int64_t)gridDim.x * ctok_hist::kClearThreads);
}

// ---------------------------------------------------------------------------
// K15, as csrc/train.cu has it.
__device__ __forceinline__ unsigned long long umax64(unsigned long long x, unsigned long long y) {
  return x > y ? x : y;
}

__global__ void __launch_bounds__(kThreads)
select_argmax_kernel(const int32_t* __restrict__ hist, int V,
                     unsigned long long* __restrict__ scratch, int step,
                     int32_t* __restrict__ ma, int32_t* __restrict__ mb) {
  const int64_t n = (int64_t)V * V;
  unsigned long long best = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const unsigned long long key =
        ((unsigned long long)(uint32_t)hist[i] << 32) | (uint32_t)(kAll - (uint32_t)i);
    best = umax64(best, key);
  }
  for (int o = 16; o > 0; o >>= 1) best = umax64(best, __shfl_xor_sync(kAll, best, o));
  __shared__ unsigned long long warp_best[kThreads / 32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long m = 0;
    for (int w = 0; w < kThreads / 32; ++w) m = umax64(m, warp_best[w]);
    atomicMax(&scratch[0], m);
    __threadfence();
    last = atomicAdd(&scratch[1], 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  const unsigned long long m = atomicAdd(&scratch[0], 0ull);
  const uint32_t count = (uint32_t)(m >> 32);
  const int64_t flat = (int64_t)(kAll - (uint32_t)(m & kAll));
  const bool take = count > 0;
  ma[step] = take ? (int32_t)(flat / V) : -1;
  mb[step] = take ? (int32_t)(flat % V) : -1;
  scratch[0] = 0;
  scratch[1] = 0;
}

__global__ void __launch_bounds__(kWindowThreads)
select_window_kernel(const int32_t* __restrict__ hist, int V, const int32_t* __restrict__ ca,
                     const int32_t* __restrict__ cb, int T, int n_cand,
                     int32_t* __restrict__ state, int step, int32_t* __restrict__ ma,
                     int32_t* __restrict__ mb) {
  __shared__ int first;
  if (threadIdx.x == 0) first = 0x7FFFFFFF;
  __syncthreads();
  const int last_pos = state[0];
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    if (t > last_pos && t < n_cand && hist[(int64_t)ca[t] * V + cb[t]] > 0) {
      atomicMin(&first, t);
      break;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const bool has = first != 0x7FFFFFFF;
  if (has && state[1] == 0) {
    ma[step] = ca[first];
    mb[step] = cb[first];
    state[0] = first;
  } else {
    ma[step] = -1;
    mb[step] = -1;
  }
  if (!has) state[1] = 1;
}

// ---------------------------------------------------------------------------
// K16, as csrc/train.cu has it (K16_PDL 0: the wait is a no-op).
__global__ void __launch_bounds__(kThreads)
hist_update_kernel(int32_t* __restrict__ hist, int V, int step,
                   const int32_t* __restrict__ ma, const int32_t* __restrict__ mb, int new_id,
                   const int32_t* __restrict__ delta) {
  grid_dependency_wait();
  const int a = ma[step];
  if (a < 0) return;
  const int b = mb[step];
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx > 4 * V) return;
  if (idx == 4 * V) {
    if (b != a && b != new_id && a != new_id) hist[(int64_t)a * V + b] = 0;
    return;
  }
  const int line = idx / V;
  const int x = idx - line * V;
  const int r = line == 0 ? x : line == 1 ? b : line == 2 ? x : new_id;
  const int c = line == 0 ? a : line == 1 ? x : line == 2 ? new_id : x;
  const bool in0 = c == a, in1 = r == b, in2 = c == new_id, in3 = r == new_id;
  const int owner = in0 ? 0 : in1 ? 1 : in2 ? 2 : 3;
  if (owner != line) return;
  int32_t d = 0;
  if (in0) d -= delta[r * 4 + 0];
  if (in1) d -= delta[c * 4 + 1];
  if (in2) d += delta[r * 4 + 2];
  if (in3) d += delta[c * 4 + 3];
  int32_t* cell = hist + (int64_t)r * V + c;
  const int32_t base = (r == a && c == b) ? 0 : *cell;
  const int32_t v = (int32_t)((uint32_t)base + (uint32_t)d);
  *cell = v < 0 ? 0 : v;
}

int blocks_for(int64_t n, int threads, int64_t cap) {
  int64_t g = (n + threads - 1) / threads;
  if (g > cap) g = cap;
  return (int)(g < 1 ? 1 : g);
}

template <typename... Params, typename... Args>
cudaError_t launch(bool dependent, void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (dependent) return ctok::launch_dependent(kernel, grid, block, smem, stream, args...);
  kernel<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ctok_merge_step(int32_t* words, const int32_t* freqs, int N, int W, const int32_t* ma,
                    const int32_t* mb, int step, int a, int b, int new_id, int32_t* delta, int V,
                    int32_t* minted, int32_t* zero, int64_t zero_n, cudaStream_t stream) {
  if (N < 0 || W < 0 || V < 0 || zero_n < 0) return (int)cudaErrorInvalidValue;
  const bool clear_kernel = K14_CLEAR != 0 && zero_n > 0;
  if (clear_kernel) {
    merge_clear_kernel<<<blocks_for(zero_n / 4, ctok_hist::kClearThreads,
                                    ctok_hist::kClearMaxBlocks),
                         ctok_hist::kClearThreads, 0, stream>>>(zero, zero_n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if ((N == 0 || W == 0) && (zero_n == 0 || clear_kernel)) return (int)cudaSuccess;
  const int64_t warps = ((int64_t)N + kMergeRows - 1) / kMergeRows;
  int blocks = blocks_for(warps * 32, kMergeThreads, 1 << 30);
  const int zero_blocks = clear_kernel ? 0 : blocks_for(zero_n / 4, kMergeThreads,
                                                        ctok_hist::kClearMaxBlocks);
  if (zero_blocks > blocks) blocks = zero_blocks;
  const size_t smem = K14_TILE && W <= kTileMaxW
                          ? sizeof(int32_t) * (kMergeThreads / 32) * kMergeRows * W : 0;
  const bool dependent = K14_PDL == 3 || (K14_PDL != 0 && ma != nullptr) || clear_kernel;
  return (int)launch(dependent, merge_step_kernel, dim3(blocks),
                     dim3(kMergeThreads), smem, stream, words, freqs, N, W, ma, mb, step, a, b,
                     new_id, delta, V, minted, zero, clear_kernel ? (int64_t)0 : zero_n,
                     clear_kernel ? 1 : 0);
}

int ctok_select_argmax(const int32_t* hist, int V, unsigned long long* scratch, int step,
                       int32_t* ma, int32_t* mb, cudaStream_t stream) {
  const int64_t n = (int64_t)V * V;
  select_argmax_kernel<<<blocks_for(n, kThreads * 8, kMaxArgmaxBlocks), kThreads, 0, stream>>>(
      hist, V, scratch, step, ma, mb);
  return (int)cudaGetLastError();
}

int ctok_select_window(const int32_t* hist, int V, const int32_t* ca, const int32_t* cb, int T,
                       int n_cand, int32_t* state, int step, int32_t* ma, int32_t* mb,
                       cudaStream_t stream) {
  select_window_kernel<<<1, kWindowThreads, 0, stream>>>(hist, V, ca, cb, T, n_cand, state, step,
                                                        ma, mb);
  return (int)cudaGetLastError();
}

int ctok_hist_update(int32_t* hist, int V, int step, const int32_t* ma, const int32_t* mb,
                     int new_id, const int32_t* delta, cudaStream_t stream) {
  return (int)launch(K16_PDL != 0, hist_update_kernel,
                     dim3(blocks_for(4 * (int64_t)V + 1, kThreads, 1 << 30)), dim3(kThreads), 0,
                     stream, hist, V, step, ma, mb, new_id, delta);
}

}  // extern "C"
