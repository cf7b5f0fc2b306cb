// Hand-written CUDA kernels of the word path's fill, for Hopper (sm_90a):
// K3 (word ids from start bits) and K4 (compaction into the fused buffer;
// its phased mode after K20, kernels.cu, when CTOK_PHASE_N1 is set).
// With K1 (kernels.cu, the byte seed) and K2 or K5 (kernels.cu, the merge
// fixpoint) between them they make the fill in four launches.  The word
// path runs K6 (kernels.cu: K3, K1 and the fixpoint in one launch) and
// then K4; K3 stays as a piece of the JAX fill body and, in the four
// launches (ops/wordfill.py:word_fill_chain), as the yardstick of K6.
// Plain C interface, loaded with ctypes
// by complexity_tokenizer_tpu_torch/utils/cuda_build.py; no PyTorch headers.
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() of its launch.
//
// Both replace parts of the JAX fill body
// (complexity_tokenizer_tpu/ops/wordpath.py, DeviceWordEncoder.
// _local_fill_body), which XLA compiled for the TPU.  At the word path's
// packs ([64 | 256 | 1024, 128]) each moves well under a megabyte, so both
// are bound by their launch (about 1.5 us on an H100), not by bytes: they
// are written to be simple and right, one warp per 128-byte row, and K4's
// launch overlaps K6 (below).

#include <cstdint>
#include <cuda_runtime.h>

#include "dependent_launch.cuh"

namespace {

constexpr int kFillThreads = 256;                 // 8 warps, 8 rows a block
constexpr int kRowsPerBlock = kFillThreads / 32;
constexpr uint32_t kAll = 0xFFFFFFFFu;

// ---------------------------------------------------------------------------
// K3: start bits -> word ids.
//
// Replaces the start-bit unpack and the cumsum of the JAX fill body
// (wordpath.py:292-302): bit c of row r (byte c / 8, bit c % 8, little
// endian) marks a word start; wid[r, c] is the number of starts in row r at
// or before c, minus one, for c < row_len[r], and -1 from row_len[r] on.
//
// The JAX body counts starts over the whole flattened pack; this kernel
// counts within each row.  Both are exact for K2: K2 only asks whether two
// neighbouring positions of one row hold the same word id (its word
// boundaries are the positions where the id changes), and ctok_pack_seg
// packs each row densely from column 0, starting a word there, with no word
// spanning two rows.  Within a row the two counts then differ by the
// number of starts in the rows before it, a constant, so they have the
// same boundaries.  (tests/test_torch_wordfill.py checks that K2 gives the
// same output for both.)
//
// Design: one warp per row, 128 positions a warp step, 4 a lane (one nibble
// of the start bits), an inclusive warp scan of the lanes' counts, one int4
// store per lane.  Needs W % 8 == 0 (one start byte per 8 positions).
__global__ void __launch_bounds__(kFillThreads)
word_ids_kernel(const uint8_t* __restrict__ bits,
                const int32_t* __restrict__ row_len,
                int32_t* __restrict__ wid, int B, int W) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= B) return;
  const int len = row_len[r];
  const uint8_t* rb = bits + r * (W / 8);
  int32_t* out = wid + r * W;
  int carry = 0;  // starts in the steps before
  for (int c0 = 0; c0 < W; c0 += 128) {
    const int p = c0 + 4 * lane;
    const bool in_row = p < W;
    const uint32_t nib = in_row ? (rb[p >> 3] >> (p & 4)) & 0xFu : 0u;
    int s[4];
    int n = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s[k] = (p + k < len) && ((nib >> k) & 1u);
      n += s[k];
    }
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += y;
    }
    int run = carry + incl - n;  // starts before this lane's positions
    if (in_row) {
      int v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        run += s[k];
        v[k] = p + k < len ? run - 1 : -1;
      }
      *reinterpret_cast<int4*>(out + p) = make_int4(v[0], v[1], v[2], v[3]);
    }
    carry += __shfl_sync(kAll, incl, 31);
  }
}

// ---------------------------------------------------------------------------
// K4: compaction of the merged rows into the fused buffer.
//
// Replaces the alive mask, cumsum, sort_key_val compaction, packbits and
// total of the JAX fill body (wordpath.py:318-359), and writes its
// unphased layout byte for byte:
//   [cap ids (T = uint16 or int32) | B*W/8 alive bits | int32 total]
// ids: the live ids (merged >= 0) in flat [B*W] order, the first cap of
// them, then -1 (0xFFFF as uint16) up to cap, as the JAX sort leaves the
// dead lanes' tombstones there; alive bits: bit c % 8 of byte c / 8 of row r
// is merged[r, c] >= 0 (packbits, little endian); total: the number of live
// ids, also when it exceeds cap, so that the host sees the spill.
//
// The TPU sorted; here every row's output offset is the exclusive prefix
// sum of K2's per-row counts.  Each block sums the counts of the rows before
// its own (and of all rows, for the total and the tail) itself: at most a
// few thousand 4-byte loads a block from L2, no second launch.  Then one
// warp per row walks it 32 positions at a time: a ballot gives the alive
// bits of the 32 positions (4 bytes of the bitmap, stored by lanes 0-3) and,
// with a popcount, each live lane's slot.
//
// Bound: K4 moves at most a few hundred KB (0.00005-0.0002 ms at 3.35
// TB/s), so its launch bounds it: launched plainly it starts only after
// K6's last block has ended, and took 2.6-2.9 us of the fill's time beyond
// K6 alone.  So it is launched as a programmatic dependent of the kernel
// before it on the stream (cudaLaunchKernelEx with programmatic stream
// serialization): K6 triggers its dependents as it starts
// (griddepcontrol.launch_dependents), K4's blocks are then scheduled while
// K6 runs and wait at griddepcontrol.wait until K6 has ended and its rows
// and counts are visible.  After any other work on the stream (a copy, a
// kernel that triggers nothing) the wait returns at once and the launch
// waits as a plain one.  Times in PERF.md, section 6.
//
// The phased mode (kPhased) writes the phased fill's layout
// (wordpath.py:264-278, 303-361) from the [B, W] rows the fixpoint
// finished after K20 (kernels.cu; B here is half the pack's rows):
//   [cap ids | B*W/8 alive bits | B*W/8 word-start bits | int32 total]
// with the start bits of wid2's transitions (wid2[c] >= 0 and c == 0 or
// wid2[c] != wid2[c - 1]), and as the total the spill sentinel 2*B*W + 1
// (the pack's lanes plus one) when some input row kept more than W/2 lanes
// (kept [2B], K20's), the number of live ids otherwise.  The ids are
// written as in the plain mode, whatever the total says.
template <typename T, bool kPhased>
__global__ void __launch_bounds__(kFillThreads)
fill_compact_kernel(const int32_t* __restrict__ merged,
                    const int32_t* __restrict__ count,
                    const int32_t* __restrict__ wid2,
                    const int32_t* __restrict__ kept,
                    uint8_t* __restrict__ out, int B, int W, int64_t cap) {
  __shared__ int64_t red_before[kRowsPerBlock], red_all[kRowsPerBlock];
  __shared__ int64_t row_off[kRowsPerBlock];
  __shared__ int64_t s_total;
  __shared__ int s_spill;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * kRowsPerBlock;
  // launched as a programmatic dependent of K6: wait until K6 has finished
  // and its rows and counts are visible (at once after any other launch)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  int64_t before = 0, all = 0;
  for (int64_t k = tid; k < B; k += kFillThreads) {
    const int64_t v = count[k];
    all += v;
    before += k < r0 ? v : 0;
  }
  int spill = 0;
  if constexpr (kPhased)
    for (int64_t k = tid; k < 2 * (int64_t)B; k += kFillThreads) spill |= kept[k] > W / 2;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    before += __shfl_down_sync(kAll, before, o);
    all += __shfl_down_sync(kAll, all, o);
  }
  if (lane == 0) {
    red_before[warp] = before;
    red_all[warp] = all;
  }
  if constexpr (kPhased) {
    if (tid == 0) s_spill = 0;
    __syncthreads();
    if (__any_sync(kAll, spill) && lane == 0) atomicOr(&s_spill, 1);
  }
  __syncthreads();
  if (tid == 0) {
    int64_t b = 0, a = 0;
    for (int w = 0; w < kRowsPerBlock; ++w) {
      b += red_before[w];
      a += red_all[w];
    }
    for (int w = 0; w < kRowsPerBlock; ++w) {
      row_off[w] = b;
      if (r0 + w < B) b += count[r0 + w];
    }
    s_total = a;
  }
  __syncthreads();
  const int64_t total = s_total;
  T* ids = reinterpret_cast<T*>(out);
  uint8_t* alive_bits = out + cap * (int64_t)sizeof(T);
  uint8_t* start_bits = alive_bits + (int64_t)B * (W / 8);

  const int64_t r = r0 + warp;
  if (r < B) {
    const int32_t* row = merged + r * W;
    uint8_t* rbits = alive_bits + r * (W / 8);
    int64_t base = row_off[warp];
    const uint32_t lt = (1u << lane) - 1u;
    for (int c0 = 0; c0 < W; c0 += 32) {
      const int c = c0 + lane;
      const int32_t v = c < W ? row[c] : -1;
      const uint32_t m = __ballot_sync(kAll, v >= 0);
      const int64_t slot = base + __popc(m & lt);
      if (v >= 0 && slot < cap) ids[slot] = (T)v;
      if (lane < 4 && c0 + 8 * lane < W) rbits[c0 / 8 + lane] = (uint8_t)(m >> (8 * lane));
      base += __popc(m);
      if constexpr (kPhased) {
        const int32_t* wrow = wid2 + r * W;
        const int32_t wv = c < W ? wrow[c] : -1;
        int32_t left = __shfl_up_sync(kAll, wv, 1);
        if (lane == 0) left = c > 0 ? wrow[c - 1] : -2;
        const uint32_t sm = __ballot_sync(kAll, c < W && wv >= 0 && wv != left);
        if (lane < 4 && c0 + 8 * lane < W)
          start_bits[r * (W / 8) + c0 / 8 + lane] = (uint8_t)(sm >> (8 * lane));
      }
    }
  }
  // the slots past the live ids hold -1, as the TPU's sort leaves them
  const int64_t stride = (int64_t)gridDim.x * kFillThreads;
  for (int64_t j = total + (int64_t)blockIdx.x * kFillThreads + tid; j < cap; j += stride)
    ids[j] = (T)-1;
  if (blockIdx.x == 0 && tid < 4) {
    int64_t shown = total;
    uint8_t* tail = alive_bits + (int64_t)B * (W / 8);
    if constexpr (kPhased) {
      if (s_spill) shown = 2 * (int64_t)B * W + 1;
      tail = start_bits + (int64_t)B * (W / 8);
    }
    const uint32_t t = (uint32_t)(int32_t)shown;
    tail[tid] = (uint8_t)(t >> (8 * tid));
  }
}

// fill_compact_kernel<T, kPhased> as the programmatic dependent of the
// kernel before it on the stream (K6 triggers it early); after any other
// work the launch waits as usual
template <bool kPhased>
int launch_fill_compact(const void* merged, const void* count, const void* wid2,
                        const void* kept, void* out, int B, int W, long long cap, int itemsize,
                        void* stream) {
  if (B < 0 || W <= 0 || W % 8 || cap < 0) return (int)cudaErrorInvalidValue;
  // at least one block: block 0 writes the total
  const int blocks = B > 0 ? (B + kRowsPerBlock - 1) / kRowsPerBlock : 1;
  const auto* m = static_cast<const int32_t*>(merged);
  const auto* c = static_cast<const int32_t*>(count);
  const auto* w = static_cast<const int32_t*>(wid2);
  const auto* k = static_cast<const int32_t*>(kept);
  auto* o = static_cast<uint8_t*>(out);
  const auto s = (cudaStream_t)stream;
  if (itemsize == 2)
    return (int)ctok::launch_dependent(fill_compact_kernel<uint16_t, kPhased>, dim3(blocks),
                                       dim3(kFillThreads), 0, s, m, c, w, k, o, B, W,
                                       (int64_t)cap);
  if (itemsize == 4)
    return (int)ctok::launch_dependent(fill_compact_kernel<int32_t, kPhased>, dim3(blocks),
                                       dim3(kFillThreads), 0, s, m, c, w, k, o, B, W,
                                       (int64_t)cap);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int ctok_word_ids(const void* bits, const void* row_len, void* wid, int B,
                  int W, void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaSuccess;
  if (W % 8) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  word_ids_kernel<<<blocks, kFillThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(bits), static_cast<const int32_t*>(row_len),
      static_cast<int32_t*>(wid), B, W);
  return (int)cudaGetLastError();
}

int ctok_fill_compact(const void* merged, const void* count, void* out, int B,
                      int W, long long cap, int itemsize, void* stream) {
  return launch_fill_compact<false>(merged, count, nullptr, nullptr, out, B, W, cap, itemsize,
                                    stream);
}

// K4's phased mode: merged, count, wid2 of the [B, W] fused rows and kept
// [2B] of the pack's rows (K20's) -> the phased layout
int ctok_fill_compact_phased(const void* merged, const void* count, const void* wid2,
                             const void* kept, void* out, int B, int W, long long cap,
                             int itemsize, void* stream) {
  return launch_fill_compact<true>(merged, count, wid2, kept, out, B, W, cap, itemsize, stream);
}

}  // extern "C"
