// A lockstep emulation of a warp on 32 host threads, for running a
// warp-synchronous kernel's logic on a machine with no card
// (scripts/warp_emulator/emulate_k18.py): the CUDA keywords become nothing,
// __ldg a plain load, and every warp intrinsic a barrier of the 32 lanes, so
// a shuffle or a ballot that not every lane reaches aborts with each lane's
// source line instead of hanging.  Warps run one after another; no shared
// memory, no atomics.
#pragma once
#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
inline int2 make_int2(int a, int b) { return {a, b}; }
struct dim3 { unsigned x = 1, y = 1, z = 1; };
thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class T> T __ldg(const T* p) { return *p; }

int g_line[32];  // the source line of each lane's last warp intrinsic

// a barrier of the warp's 32 lanes that aborts after 3 s of waiting
struct WarpBarrier {
  std::atomic<int> count{0};
  std::atomic<int> gen{0};
  void arrive_and_wait() {
    const int g = gen.load();
    if (count.fetch_add(1) == 31) {
      count.store(0);
      gen.fetch_add(1);
      return;
    }
    const auto t0 = std::chrono::steady_clock::now();
    while (gen.load() == g) {
      std::this_thread::yield();
      if (std::chrono::steady_clock::now() - t0 > std::chrono::seconds(3)) {
        fprintf(stderr, "warp_emulator: a lane waits at a warp intrinsic; each lane's line:");
        for (int i = 0; i < 32; ++i) fprintf(stderr, " %d", g_line[i]);
        fprintf(stderr, "\n");
        abort();
      }
    }
  }
};

struct Warp {
  WarpBarrier bar;
  uint64_t v[32];
};
Warp* g_warp;

inline int lane_id() { return threadIdx.x & 31; }
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { g_warp->bar.arrive_and_wait(); }
inline unsigned __ballot_sync(unsigned, bool p) {
  g_warp->v[lane_id()] = p;
  g_warp->bar.arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (g_warp->v[i] ? 1u : 0u) << i;
  g_warp->bar.arrive_and_wait();
  return m;
}
inline int __any_sync(unsigned m, bool p) { return __ballot_sync(m, p) != 0; }
template <class T> T shfl_from(T x, int src) {
  g_warp->v[lane_id()] = (uint64_t)(uint32_t)x;
  g_warp->bar.arrive_and_wait();
  const T r = (T)(uint32_t)g_warp->v[src];
  g_warp->bar.arrive_and_wait();
  return r;
}
template <class T> T __shfl_sync(unsigned, T x, int src, int width = 32) {
  const int l = lane_id();
  return shfl_from(x, (l / width) * width + (src % width));
}
template <class T> T __shfl_up_sync(unsigned, T x, unsigned d, int width = 32) {
  const int l = lane_id();
  return shfl_from(x, (l % width) >= (int)d ? l - (int)d : l);
}
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }

// every warp of the grid, one after another, its 32 lanes on host threads
template <class F> void emu_launch(int grid, int threads, F body) {
  blockDim.x = threads;
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b)
    for (int w = 0; w < threads / 32; ++w) {
      Warp warp;
      g_warp = &warp;
      std::vector<std::thread> ts;
      for (int l = 0; l < 32; ++l)
        ts.emplace_back([&, l] {
          threadIdx.x = w * 32 + l;
          blockIdx.x = b;
          body();
        });
      for (auto& t : ts) t.join();
    }
}

// the intrinsics the kernel calls record their line first
#define __ballot_sync(m, p) (g_line[threadIdx.x & 31] = __LINE__, __ballot_sync(m, p))
#define __any_sync(m, p) (g_line[threadIdx.x & 31] = __LINE__, __any_sync(m, p))
#define __shfl_sync(...) (g_line[threadIdx.x & 31] = __LINE__, __shfl_sync(__VA_ARGS__))
#define __shfl_up_sync(...) (g_line[threadIdx.x & 31] = __LINE__, __shfl_up_sync(__VA_ARGS__))
