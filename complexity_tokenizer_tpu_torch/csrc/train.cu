// Hand-written CUDA kernels of the device trainer, for Hopper (sm_90a):
// K13 (the initial pair histogram), K14 (one merge step), K15 (the next
// pair, on the card) and K16 (the pair histogram's update).
// Plain C interface, loaded with ctypes by
// complexity_tokenizer_tpu_torch/utils/cuda_build.py; no PyTorch headers.
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() of its launch.
//
// They replace the XLA programs of the JAX package's parallel/trainer.py
// (none calls pl.pallas_call): make_initial_hist (:48), make_merge_step
// (:64), the selection inside make_k_merge_steps (:179) and
// make_inl_window_steps (:248), and the histogram update inside both
// (:220-228, :298-306).  The wrappers and plain versions are in
// complexity_tokenizer_tpu_torch/ops/trainer_device.py.
//
// Everything is int32, and every sum is an integer atomic: integer
// addition is associative, so any order of the atomics gives the same sums
// and each kernel equals its plain version bit for bit.
//
// What bounds them on this card: K13, K14 and K15 read their inputs once
// (the word rows, the [V, V] histogram) and are bound by those bytes and,
// at the trainer's sizes (a few MB), by their launch; K16 touches four
// lines of the histogram, a few tens of KB, and is launch-bound.  K15 is
// written to be simple and right: a grid-wide maximum finished by the last
// block.  K13 was redesigned for Hopper (a private histogram a block in
// shared memory, flushed with one atomic a nonzero bin), and so were K14 (a
// warp scans 16 rows with coalesced loads into shared memory and only the
// rows that hold the pair walk their chain) and K16 (a thread a cell of the four lines,
// launched behind K14 so that its launch overlaps K14's run): see each.

#include <cstdint>
#include <cuda_runtime.h>

#include "hist_clear.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWindowThreads = 1024;
constexpr int kMaxArgmaxBlocks = 132 * 4;
constexpr uint32_t kAll = 0xFFFFFFFFu;

// ---------------------------------------------------------------------------
// K13: hist[l * v0 + r] += freq[row] over adjacent slots (l, r) of a row that
// both hold a token (>= 0), as make_initial_hist (which also pairs adjacent
// slots, not the alive chain: the initial rows hold no tombstone inside a
// word).  The key is JAX's l * v0 + r, dropped only at >= v0 * v0, so a
// right id r >= v0 adds into line l + 1 as in JAX (not a 2-D [l][r] index
// with a bound on each coordinate).
//
// The first design (pair_hist_global_kernel, kept below for a v0 past the
// plan's reach) gave a thread a slot pair and a global atomic a pair: on
// the classic rows [48968,13] at v0 = 58 that is 587,616 atomics into 3,364
// bins, and a Zipf curve of letter pairs queues the hot bins' atomics at the
// same L2 addresses (0.0365 ms against a 0.00082 ms bytes bound).  Here:
// - a block keeps a private histogram in shared memory and counts with
//   shared-memory atomics; after its rows it adds each nonzero bin to hist
//   with one global atomic, so a bin takes at most a global atomic a block
//   (blocks x bins touched is the flush's cost; the plan sizes the grid to
//   the card, or to the steps when there are fewer);
// - a warp reads kHistStep consecutive slots of the flat rows a step, in
//   four coalesced loads of 32 (the slot after them is lane 0's fifth), and
//   shuffles give each slot its right neighbour; each slot's row and column
//   are kept up to date by additions, with no divide a slot;
// - hist is cleared by a kernel of its own, launched before K13, which is
//   its programmatic dependent (hist_clear.cuh): K13 waits for the clear
//   only before its flush, so the clear overlaps the counting.
// v0 past one block's shared memory (v0 <= 241: 232,448 B): the histogram
// in slices of at most kHistSliceBins bins, at most kHistMaxSlices of them
// (v0 <= 681), a block a slice on blockIdx.y, each reading the rows of its
// x and skipping the keys outside its slice.  On the classic rows with Zipf
// ids below 260 that took 0.0089 ms, and the slices over a thread block
// cluster's distributed shared memory 0.0124 (scripts/study_hist_variants.py
// and its scripts/hist_variants/pair_hist_variants.cu; PERF.md, section 6):
// a second read of the rows from L2 costs less than atomics into another
// SM's shared memory.  Past 681, the first design after the clear.
// pair_hist_plan (mirrored by ops/trainer_device.py:pair_hist_plan) picks
// the branch and the grid.
constexpr int kHistThreads = 1024;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistStep = 128;              // slots a warp reads a step
constexpr int kHistSmemBytes = 232448;      // a block's shared memory on the H100 (opt-in)
constexpr int kHistSliceBins = kHistSmemBytes / 4;
constexpr int kHistMaxSlices = 8;           // past them, global atomics

// branch 0: a block's histogram; 1: in slices; 2: global atomics.  groups:
// blocks (branch 0) or blocks along x (branch 1).
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

// Branch 0 (gridDim.y 1, slice_bins v0 * v0) and branch 1 (a slice a
// blockIdx.y).
__global__ void __launch_bounds__(kHistThreads)
pair_hist_kernel(const int32_t* __restrict__ words, const int32_t* __restrict__ freqs,
                 int64_t slots, int W, int v0, int slice_bins, int32_t* __restrict__ hist) {
  extern __shared__ int32_t sh[];
  const int lo = blockIdx.y * slice_bins;
  const int n = min(slice_bins, v0 * v0 - lo);
  for (int i = threadIdx.x; i < n; i += kHistThreads) sh[i] = 0;
  __syncthreads();
  const int64_t reader = (int64_t)blockIdx.x * kHistWarps + (threadIdx.x >> 5);
  hist_walk(words, freqs, slots, W, v0, reader, (int64_t)gridDim.x * kHistWarps,
            [&](int key, int32_t f) {
              const int k = key - lo;
              if (k >= 0 && k < n) atomicAdd(sh + k, f);
            });
  __syncthreads();
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

// ---------------------------------------------------------------------------
// K14: one merge (a, b) -> new_id over every row.
//
// make_merge_step selects, along each row's alive chain, the matches
// (a at j, b at the next alive slot) whose run of consecutive matches
// ending at j has odd length: occurrences 1st, 3rd, ... of a run.  Walking
// the chain left to right and taking a match unless the slot before was
// taken (the partner of a taken match is skipped) gives exactly that, the
// reference's sequential pass (trainer.rs:536-588), with no scan.
//
// The deltas are JAX's four histograms entry for entry (the INL window
// records them per step), with x and y the neighbours' values before the
// merge:
//   kind 0 [x] += f, x the alive token before a taken match;
//   kind 2 [x'] += f, x' = new_id when the previous taken match is
//     chain-adjacent (its partner is x), else x;
//   kinds 1 and 3 [y] += f, y the alive token after the partner, unless y
//     starts the next taken match (the one after a taken match is taken
//     whenever it matches: the slot between them is a partner).
// An index at or past V (delta's rows) is dropped, as JAX's scatter drops
// it.  When the pair comes from the merge log (ma != nullptr) and the step
// does nothing (ma[step] < 0), the launch leaves the rows, delta and minted
// unchanged, as JAX's jnp.where(do, out, words).
//
// The first design gave a thread a row walking its chain: 8-16 warps an
// SM, each load waiting on the one before, strided 52 B across the warp,
// and every row walked even when it holds no a, which after the first
// merges is nearly every row.  Here a warp takes kMergeRows consecutive
// rows, kMergeRows * W contiguous int32:
// - its lanes read them in coalesced steps of 32 slots, kMergeBatch steps'
//   loads in flight, note which rows hold a and which hold b (a bit a row,
//   OR-reduced over the warp) and keep the rows in the warp's shared
//   memory (rows of up to kTileMaxW slots; wider ones are walked from the
//   lines the scan brought into L1);
// - only the rows that hold both walk their chain, each in a lane, from
//   that copy; a warp with no such row ends there, so late in a run K14 is
//   one read of the rows;
// - a row's minted frequency is summed over the warp and added with one
//   atomic; the deltas are global atomics, as few as the taken matches
//   (the first merge of the classic 50,000 run, the most contended, adds
//   14,368 into 52 entries; by merge 10,000 a merge adds none).
// The walk never reads a slot it has written (it writes pos and nx behind
// the slots yp and yn it reads), and a lane writes only its own row.  16
// rows a warp (6.5 lines of 13-slot rows, 3,061 warps for the classic
// rows) measured faster than 32 and 8, and the walk from shared memory
// faster than from L1 on the device-resident steps, where early merges
// walk many rows (scripts/study_merge_variants.py; PERF.md, section 6).
//
// The per-merge route reads each merge's deltas back, so they must start
// from zero: K14 zeroes `zero` (zero_n int32, overlapping no other
// argument) as it runs.  The route keeps two buffers that take turns: K14
// adds into the one the merge before zeroed and zeroes the other, which
// the host has read back by then; so no launch of its own clears one.
//
// K14 is a plain launch on both routes: as the programmatic dependent of
// K15 (dependent_launch.cuh) it measured faster only on the INL windows,
// within the noise on the classic blocks, and slower on the per-merge
// route, where the merge before is read back first.  It triggers its own
// dependents as it starts: K16 after it is scheduled while K14 runs.
constexpr int kMergeThreads = 128;
constexpr int kMergeRows = 16;   // rows a warp
constexpr int kMergeBatch = 8;   // loads of 32 slots a lane keeps in flight
constexpr int kTileMaxW = 64;    // the widest rows kept in shared memory

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

// The row's merge in the reference's order, read from t (its copy in
// shared memory, or the row itself) and written to out (the row); returns
// the row's minted frequency
__device__ __forceinline__ int32_t merge_row(const int32_t* t, int32_t* out, int W, int32_t f,
                                             int a, int b, int new_id,
                                             int32_t* __restrict__ delta, int V) {
  int32_t row_minted = 0;
  int prev = -1;              // the value before pos on the chain (-1: none)
  bool prev_partner = false;  // ... and it is a taken match's partner
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
                  int32_t* __restrict__ minted, int32_t* __restrict__ zero, int64_t zero_n) {
  extern __shared__ int32_t tile_all[];  // kMergeRows * W a warp, when W <= kTileMaxW
  asm volatile("griddepcontrol.launch_dependents;");
  const int64_t tid = (int64_t)blockIdx.x * kMergeThreads + threadIdx.x;
  if (zero_n > 0) ctok_hist::clear_slice(zero, zero_n, tid, (int64_t)gridDim.x * kMergeThreads);
  if (ma != nullptr) {
    a = ma[step];
    b = mb[step];
    if (a < 0) return;
  }
  const int lane = threadIdx.x & 31;
  const int64_t row0 = (tid >> 5) * kMergeRows;
  if (W == 0 || row0 >= N) return;
  const int rows = N - row0 < kMergeRows ? (int)(N - row0) : kMergeRows;
  const int64_t n = (int64_t)rows * W;
  const int32_t* src = words + row0 * W;
  const bool tile = W <= kTileMaxW;
  int32_t* t_sh = tile_all + (threadIdx.x >> 5) * kMergeRows * W;
  // 1. the scan: slot e of the warp's rows is lane e % 32's load e / 32;
  // its row within the warp (r) and column (c) follow by additions
  uint32_t has_a = 0, has_b = 0;
  int r = lane / W, c = lane % W;
  const int r32 = 32 / W, c32 = 32 % W;
  for (int64_t e0 = lane; e0 < n; e0 += 32 * kMergeBatch) {
    int32_t v[kMergeBatch];
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const int64_t e = e0 + 32 * j;
      v[j] = e < n ? src[e] : -1;
    }
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      if (tile && e0 + 32 * j < n) t_sh[e0 + 32 * j] = v[j];
      // a slot past the rows holds -1, which is neither a nor b
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
  // 2. the rows that hold a and b walk
  if (tile) __syncwarp();  // the warp's rows are in shared memory
  int32_t row_minted = 0;
  if ((walk >> lane) & 1u) {
    int32_t* row = words + (row0 + lane) * W;
    row_minted = merge_row(tile ? t_sh + lane * W : row, row, W, freqs[row0 + lane], a, b,
                           new_id, delta, V);
  }
  const int32_t warp_minted = __reduce_add_sync(kAll, row_minted);
  if (lane == 0 && warp_minted != 0) atomicAdd(minted, warp_minted);
}

// ---------------------------------------------------------------------------
// K15, classic: the first maximum of hist [V, V] in flat order
// (jnp.argmax), written to the merge log as (a, b), or -1 when the maximum
// is 0 (an exhausted histogram: do = false).
//
// Each thread keeps the largest key (count << 32 | ~flat): the larger
// count first, on a tie the smaller flat index; counts are >= 0 (K16
// clamps).  A block reduces its keys with shuffles and one atomicMax on the
// running maximum; the last block to finish (a ticket) decodes it, writes
// the log and returns the scratch to zero for the next launch.
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

// K15, INL window: the first candidate position t past the cursor
// state[0], below n_cand, with hist[ca[t], cb[t]] > 0 (the host's walk of
// its stale order, skipping dead candidates).  Nothing when state[1]
// (stopped) is set or when there is none, which sets it.  One block; a
// shared atomicMin gives the first eligible position.
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
      break;  // this thread's later positions come after it
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
// K16: the update of the step's pair (a, b) = (ma[step], mb[step]):
// hist[a, b] = 0; column a -= delta[:, 0]; row b -= delta[:, 1];
// column new += delta[:, 2]; row new += delta[:, 3]; clamp at 0.
//
// The lines overlap ((b, a) is in column a and row b; (new, new) in column
// new and row new; when a == b the popped (a, a) is in column a and row
// b), and JAX adds all four updates before it clamps.  So a thread a cell
// of each line sums the deltas of every line that holds its cell and writes
// only if its line is the first (in the order above) to hold it: each cell
// has one writer and no thread reads another's cell.  The popped cell,
// when no line holds it, is one more thread's.  Clamping the touched cells
// equals JAX's clamp of the whole array: no other cell changed.  Nothing
// when the step does nothing (a < 0).
//
// It moves a few tens of KB and costs about a launch's latency, so it is
// launched as the programmatic dependent of the kernel before it (K14 in a
// device-resident step, which triggers it as it starts): its blocks are
// scheduled while K14 runs and wait for it before reading anything.  With
// more than one process the deltas' reduction comes between them, and the
// launch waits as a plain one.
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
  if (idx == 4 * V) {  // the popped cell
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
  const int32_t v = (int32_t)((uint32_t)base + (uint32_t)d);  // JAX's int32 wraps
  *cell = v < 0 ? 0 : v;
}

int blocks_for(int64_t n, int threads, int64_t cap) {
  int64_t g = (n + threads - 1) / threads;
  if (g > cap) g = cap;
  return (int)(g < 1 ? 1 : g);
}

// K13's kernel may take up to kHistSmemBytes of dynamic shared memory: the
// opt-in once a device (outside a CUDA graph's capture after a first call)
cudaError_t allow_hist_smem() {
  static unsigned done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(pair_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kHistSmemBytes);
  if (err == cudaSuccess) done |= bit;
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
  err = allow_hist_smem();
  if (err != cudaSuccess) return (int)err;
  return (int)ctok::launch_dependent(pair_hist_kernel, dim3(p.groups, p.slices),
                                          dim3(kHistThreads), sizeof(int32_t) * p.slice_bins,
                                          stream, words, freqs, slots, W, v0, p.slice_bins, hist);
}

// K13's plan and launch shape for rows [N, W] at v0: info gets the branch
// (0 a block's histogram, 1 in slices, 2 global atomics), slices, bins a
// slice, groups (blocks, or blocks along x), the SMs the plan saw, then the
// kernel's threads a block, registers a thread, static and dynamic shared
// bytes a block, local (spill) bytes a thread and resident blocks per SM
int ctok_pair_hist_info(int N, int W, int v0, int* info) {
  const int sms = sm_count();
  const HistPlan p = pair_hist_plan((int64_t)N * W, v0, sms);
  cudaFuncAttributes fa;
  int blocks = 0, threads = kHistThreads;
  size_t smem = sizeof(int32_t) * (size_t)p.slice_bins;
  cudaError_t err;
  if (p.branch == 2) {
    threads = kThreads;
    smem = 0;
    err = cudaFuncGetAttributes(&fa, pair_hist_global_kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pair_hist_global_kernel,
                                                          threads, 0);
  } else {
    err = allow_hist_smem();
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, pair_hist_kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pair_hist_kernel, threads,
                                                          smem);
  }
  if (err != cudaSuccess) return (int)err;
  const int shape[] = {p.branch, p.slices, p.slice_bins, p.groups, sms, threads, fa.numRegs,
                       (int)fa.sharedSizeBytes, (int)smem, (int)fa.localSizeBytes, blocks};
  for (int i = 0; i < 11; ++i) info[i] = shape[i];
  return (int)cudaSuccess;
}

// K14: words [N, W] merged in place, the deltas added into delta [V, 4] and
// the minted count into minted; the pair from the log (ma, mb at step; ma
// nullptr: a, b); zero [zero_n] zeroed as it runs (zero_n 0: nothing)
int ctok_merge_step(int32_t* words, const int32_t* freqs, int N, int W, const int32_t* ma,
                    const int32_t* mb, int step, int a, int b, int new_id, int32_t* delta, int V,
                    int32_t* minted, int32_t* zero, int64_t zero_n, cudaStream_t stream) {
  if (N < 0 || W < 0 || V < 0 || zero_n < 0) return (int)cudaErrorInvalidValue;
  if ((N == 0 || W == 0) && zero_n == 0) return (int)cudaSuccess;
  const int64_t warps = ((int64_t)N + kMergeRows - 1) / kMergeRows;
  int blocks = blocks_for(warps * 32, kMergeThreads, 1 << 30);
  const int zero_blocks = blocks_for(zero_n / 4, kMergeThreads, ctok_hist::kClearMaxBlocks);
  if (zero_blocks > blocks) blocks = zero_blocks;
  const size_t smem = W <= kTileMaxW ? sizeof(int32_t) * (kMergeThreads / 32) * kMergeRows * W : 0;
  merge_step_kernel<<<blocks, kMergeThreads, smem, stream>>>(
      words, freqs, N, W, ma, mb, step, a, b, new_id, delta, V, minted, zero, zero_n);
  return (int)cudaGetLastError();
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
  return (int)ctok::launch_dependent(hist_update_kernel,
                                     dim3(blocks_for(4 * (int64_t)V + 1, kThreads, 1 << 30)),
                                     dim3(kThreads), 0, stream, hist, V, step, ma, mb, new_id,
                                     delta);
}

}  // extern "C"
