// K17: the Unigram trainer's expected counts, for Hopper (sm_90a).  Plain C
// interface, loaded with ctypes by complexity_tokenizer_tpu_torch/utils/
// cuda_build.py; no PyTorch headers.  The entry point launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() of its launch.
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
// into buf [V + n_global] int32, zeroed by the caller.  It gives bit for bit
// piece_hist_plain (ops/unigram_device.py): int32 addition is associative,
// so the atomics give the same sums in any order.
//
// A thread a text: the caller orders the texts by length, so a warp's
// threads walk slots of about the same count.  The texts of a corpus are
// short (`▁word` pieces: 8.5 characters on average), so the walk is a few
// loads a thread and an atomic a piece.
//
// Bound: the bytes.  K12's ids and poison flags, the offsets, frequencies
// and corpus indices are read once, the [V + n_global] buffer written once;
// the atomics of the pieces that many texts choose queue on their bins.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
piece_hist_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ offs,
                  const int32_t* __restrict__ freqs, const int32_t* __restrict__ gidx, int B,
                  int N, int V, int32_t* __restrict__ buf) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B) return;
  const int32_t poisoned = res[N + B + j] != 0;
  buf[V + gidx[j]] = poisoned;
  if (poisoned) return;
  const int32_t f = freqs[j];
  const int end = offs[j + 1];
  for (int p = offs[j]; p < end; ++p) {
    const int32_t id = res[p];
    if (id >= 0 && id < V) atomicAdd(&buf[id], f);
  }
}

}  // namespace

extern "C" {

// K17: res [N + 2B] int32 (K12's out, count, poison), offs [B + 1], freqs
// [B], gidx [B] int32 -> buf [V + n_global] int32 (zeroed by the caller)
int ctok_piece_hist(const void* res, const void* offs, const void* freqs, const void* gidx,
                    int B, int N, int V, int n_global, void* buf, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (N < 0 || V < 1 || n_global < 0) return (int)cudaErrorInvalidValue;
  piece_hist_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(res), static_cast<const int32_t*>(offs),
      static_cast<const int32_t*>(freqs), static_cast<const int32_t*>(gidx), B, N, V,
      static_cast<int32_t*>(buf));
  return (int)cudaGetLastError();
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
