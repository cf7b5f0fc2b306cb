// The launch of a kernel as the programmatic dependent of the launch before
// it on the stream (cudaLaunchKernelEx with programmatic stream
// serialization): the kernel's blocks are scheduled once every block of the
// one before has run griddepcontrol.launch_dependents (or ended), and wait
// in griddepcontrol.wait until it has ended and its writes are visible.
// After any other work on the stream the launch waits as a plain one.  Used
// by K4 after K6 (wordfill.cu) and by K13 and K17 after their clear
// (hist_clear.cuh).
#pragma once

#include <cuda_runtime.h>

namespace ctok {
namespace {

template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace ctok
