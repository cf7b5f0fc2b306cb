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
// lines of the histogram, a few tens of KB, and is launch-bound.  Each is
// written to be simple and right: a thread a slot pair (K13), a thread a
// row walking its alive chain in the reference's order (K14), a grid-wide
// maximum finished by the last block (K15), a thread a cell of the four
// lines (K16).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindowThreads = 1024;
constexpr int kMaxArgmaxBlocks = 132 * 4;
constexpr uint32_t kAll = 0xFFFFFFFFu;

// ---------------------------------------------------------------------------
// K13: hist[l * v0 + r] += freq[row] over adjacent slots (l, r) that both
// hold a token, as make_initial_hist (which also pairs adjacent slots, not
// the alive chain: the initial rows hold no tombstone inside a word).  A
// key past the histogram is dropped, as JAX's scatter drops it.  A thread a
// slot pair, one int atomic a pair.
__global__ void __launch_bounds__(kThreads)
pair_hist_kernel(const int32_t* __restrict__ words, const int32_t* __restrict__ freqs,
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
// A thread a row; the row's minted frequency is summed in a register and
// added with one atomic.  An index at or past V (delta's rows) is dropped,
// as JAX's scatter drops it.  When the pair comes from the merge log
// (ma != nullptr) and the step does nothing (ma[step] < 0), the launch
// leaves every buffer unchanged, as JAX's jnp.where(do, out, words).
__device__ __forceinline__ int next_alive(const int32_t* t, int p, int W) {
  while (p < W && t[p] < 0) ++p;
  return p;
}

__device__ __forceinline__ void add_delta(int32_t* delta, int V, int x, int kind, int32_t f) {
  if (x < V) atomicAdd(&delta[x * 4 + kind], f);
}

__global__ void __launch_bounds__(kThreads)
merge_step_kernel(int32_t* __restrict__ words, const int32_t* __restrict__ freqs, int N, int W,
                  const int32_t* __restrict__ ma, const int32_t* __restrict__ mb, int step,
                  int a, int b, int new_id, int32_t* __restrict__ delta, int V,
                  int32_t* __restrict__ minted) {
  if (ma != nullptr) {
    a = ma[step];
    b = mb[step];
    if (a < 0) return;
  }
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  int32_t* t = words + (int64_t)r * W;
  const int32_t f = freqs[r];
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
      t[pos] = new_id;
      t[nx] = -1;
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
  if (row_minted != 0) atomicAdd(minted, row_minted);
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
__global__ void __launch_bounds__(kThreads)
hist_update_kernel(int32_t* __restrict__ hist, int V, int step,
                   const int32_t* __restrict__ ma, const int32_t* __restrict__ mb, int new_id,
                   const int32_t* __restrict__ delta) {
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

}  // namespace

extern "C" {

int ctok_pair_hist(const int32_t* words, const int32_t* freqs, int N, int W, int v0,
                   int32_t* hist, cudaStream_t stream) {
  const int64_t pairs = (int64_t)N * (W - 1);
  pair_hist_kernel<<<blocks_for(pairs, kThreads, 132 * 16), kThreads, 0, stream>>>(
      words, freqs, N, W, v0, hist);
  return (int)cudaGetLastError();
}

int ctok_merge_step(int32_t* words, const int32_t* freqs, int N, int W, const int32_t* ma,
                    const int32_t* mb, int step, int a, int b, int new_id, int32_t* delta, int V,
                    int32_t* minted, cudaStream_t stream) {
  merge_step_kernel<<<blocks_for(N, kThreads, 1 << 30), kThreads, 0, stream>>>(
      words, freqs, N, W, ma, mb, step, a, b, new_id, delta, V, minted);
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
  hist_update_kernel<<<blocks_for(4 * (int64_t)V + 1, kThreads, 1 << 30), kThreads, 0, stream>>>(
      hist, V, step, ma, mb, new_id, delta);
  return (int)cudaGetLastError();
}

}  // extern "C"
