// The clear before an int32 histogram that is summed with atomics (K13 in
// train.cu, K17 in unigram_train.cu), whose kernel is launched as the
// clear's programmatic dependent (dependent_launch.cuh).
//
// The histogram kernel's blocks are scheduled while the clear runs (it
// triggers its dependents as it starts, griddepcontrol.launch_dependents),
// read their inputs, and wait in griddepcontrol.wait only before their first
// write into the buffer: the clear's time overlaps their loads instead of
// coming before them, as K4's after K6 (kernels.cu, wordfill.cu).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "dependent_launch.cuh"

// an unnamed namespace inside: each source that includes this has its own
// copy of the clear kernel, so the linked library holds no duplicate symbol
namespace ctok_hist {
namespace {

constexpr int kClearThreads = 256;
constexpr int kClearMaxBlocks = 132 * 2;  // the most blocks a clear takes

// buf[0, n) = 0 by the threads tid of stride: 16-byte stores from the first
// 16-byte boundary, 4-byte stores before it and after the last
__device__ __forceinline__ void clear_slice(int32_t* __restrict__ buf, int64_t n, int64_t tid,
                                            int64_t stride) {
  int64_t head = (int64_t)((16 - ((uintptr_t)buf & 15)) & 15) / 4;
  if (head > n) head = n;
  const int64_t n4 = (n - head) / 4;
  for (int64_t i = tid; i < head; i += stride) buf[i] = 0;
  int4* v = reinterpret_cast<int4*>(buf + head);
  for (int64_t i = tid; i < n4; i += stride) v[i] = make_int4(0, 0, 0, 0);
  for (int64_t i = head + 4 * n4 + tid; i < n; i += stride) buf[i] = 0;
}

__global__ void __launch_bounds__(kClearThreads) clear_kernel(int32_t* __restrict__ buf,
                                                              int64_t n) {
  asm volatile("griddepcontrol.launch_dependents;");
  clear_slice(buf, n, (int64_t)blockIdx.x * kClearThreads + threadIdx.x,
              (int64_t)gridDim.x * kClearThreads);
}

inline cudaError_t launch_clear(int32_t* buf, int64_t n, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  int64_t blocks = (n / 4 + kClearThreads - 1) / kClearThreads;
  if (blocks > kClearMaxBlocks) blocks = kClearMaxBlocks;
  if (blocks < 1) blocks = 1;
  clear_kernel<<<(int)blocks, kClearThreads, 0, stream>>>(buf, n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ctok_hist
