// K17: the Unigram trainer's expected counts, for Hopper (sm_90a).  Plain C
// interface, loaded with ctypes by complexity_tokenizer_tpu_torch/utils/
// cuda_build.py; no PyTorch headers.  The entry point launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() of its launches.
//
// K17 replaces the histogram inside _counts_program
// (complexity_tokenizer_tpu/parallel/unigram_trainer.py:64-76), which runs
// after the Viterbi (K12 here) in one XLA program, and the all_gather of the
// poison flags beside it: over K12's result buffer res [N + 2B] int32 (out
// [N], count [B], poison [B]) of the texts offs [B + 1],
//   buf[id] += freqs[j]     for every id in 0..V-1 of text j's slots, when
//                           text j is not poisoned (fallbacks, -2, and -1
//                           add nothing);
//   buf[V + gidx[j]] = poison[j]
// into buf [V + n_global] int32, which the entry clears first.  It gives bit
// for bit piece_hist_plain (ops/unigram_device.py): int32 addition wraps and
// is associative, so the atomics give the same sums in any grouping and
// order.
//
// Bound: the bytes.  K12's ids and poison flags, the offsets, frequencies
// and corpus indices are read once, the [V + n_global] buffer written once
// (at the first E-step V is the seed's 722,683 pieces: the clear's 3 MB are
// most of the bytes).  What costs the time is not the bytes but two
// launches in a row, the loads each atomic waits for, and scattered stores.
// So:
// - buf is cleared by a kernel of its own whose programmatic dependent K17
//   is (hist_clear.cuh): a thread loads its text's flag, frequency, place
//   and offsets and its first kPrefetch ids before griddepcontrol.wait, so
//   only its writes wait for the clear;
// - an atomic a piece, and a store only for a poisoned text's flag (the
//   others' 0 is the clear's: each text has a place of its own).
// A thread a text is what measured fastest over the Unigram 32,000 run's 11
// E-steps (the caller orders the texts by length, so a warp's threads walk
// about as many slots).  The designs it was measured against (a warp 32
// texts with its slots in coalesced steps and a shuffle search, warp-
// aggregated atomics, the caller's torch.zeros, cudaMemsetAsync, one
// cooperative launch with a grid barrier, other prefetch depths and block
// sizes) are in scripts/hist_variants/piece_hist_variants.cu, timed by
// scripts/study_hist_variants.py (PERF.md, section 6).

#include <cstdint>
#include <cuda_runtime.h>

#include "hist_clear.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPrefetch = 16;  // a text's ids loaded before the wait (8.5 slots on average)

__global__ void __launch_bounds__(kThreads)
piece_hist_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ offs,
                  const int32_t* __restrict__ freqs, const int32_t* __restrict__ gidx, int B,
                  int N, int V, int32_t* __restrict__ buf) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool have = j < B;
  const bool poisoned = have && __ldg(res + N + B + j) != 0;
  const int32_t f = have ? __ldg(freqs + j) : 0;
  const int g = have ? __ldg(gidx + j) : 0;  // a load after the wait would hold its warp back
  const int start = have ? __ldg(offs + j) : 0;
  const int end = have ? __ldg(offs + j + 1) : 0;
  int32_t first[kPrefetch];
#pragma unroll
  for (int u = 0; u < kPrefetch; ++u) first[u] = start + u < end ? __ldg(res + start + u) : -1;
  // the clear (the launch before this one) has ended and its zeros are
  // visible: only the writes wait for it
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (poisoned) {
    buf[V + g] = 1;
    return;
  }
#pragma unroll
  for (int u = 0; u < kPrefetch; ++u)
    if (first[u] >= 0 && first[u] < V) atomicAdd(buf + first[u], f);
  for (int p = start + kPrefetch; p < end; ++p) {
    const int32_t id = __ldg(res + p);
    if (id >= 0 && id < V) atomicAdd(buf + id, f);
  }
}

}  // namespace

extern "C" {

// K17: res [N + 2B] int32 (K12's out, count, poison), offs [B + 1], freqs
// [B], gidx [B] int32 -> buf [V + n_global] int32, cleared here
int ctok_piece_hist(const void* res, const void* offs, const void* freqs, const void* gidx,
                    int B, int N, int V, int n_global, void* buf, void* stream) {
  if (B < 0 || N < 0 || V < 1 || n_global < 0) return (int)cudaErrorInvalidValue;
  auto* out = static_cast<int32_t*>(buf);
  const auto s = (cudaStream_t)stream;
  const cudaError_t err = ctok_hist::launch_clear(out, (int64_t)V + n_global, s);
  if (err != cudaSuccess || B == 0) return (int)err;
  return (int)ctok::launch_dependent(
      piece_hist_kernel, dim3((unsigned)((B + kThreads - 1) / kThreads)), dim3(kThreads), 0, s,
      static_cast<const int32_t*>(res), static_cast<const int32_t*>(offs),
      static_cast<const int32_t*>(freqs), static_cast<const int32_t*>(gidx), B, N, V, out);
}

// K17's launch shape: info gets threads a block, registers a thread, static
// shared bytes a block, local (spill) bytes a thread and resident blocks per
// SM
int ctok_piece_hist_info(int* info) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, piece_hist_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, piece_hist_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int shape[] = {kThreads, fa.numRegs, (int)fa.sharedSizeBytes, (int)fa.localSizeBytes,
                       blocks};
  for (int i = 0; i < 5; ++i) info[i] = shape[i];
  return (int)cudaSuccess;
}

}  // extern "C"
