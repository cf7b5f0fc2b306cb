// K8: the device normalization check, for Hopper (sm_90a).  Plain C
// interface, loaded with ctypes by
// complexity_tokenizer_tpu_torch/utils/cuda_build.py; no PyTorch headers.
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch.
//
// Replaces DeviceNormChecker._fn (complexity_tokenizer_tpu/ops/
// normalize_device.py): bytes [B, L] uint8, lens [B] int32 and a stability
// bitmap [0x110000] uint8 -> stable [B] bool, true where no lead byte
// before lens[r] decodes to a codepoint the bitmap flags.  Bit for bit its
// plain twin norm_stable_rows_plain (ops/normalize_device.py): a lead byte
// is decoded arithmetically from itself and the next three bytes of the row
// (0 past L, whatever lens says), a continuation byte (10xxxxxx) is
// skipped, and the codepoint is clamped to 0x10FFFF.
//
// Bound: bytes.  The function needs each row's live bytes once (those
// before lens[r]; the kernel reads whole 128-byte chunks up to it) and 4 B
// of length, and writes one flag a row; the bitmap is 1.1 MB, read where a
// codepoint lands, and stays in the 50 MB L2.  The ASCII part of the bitmap
// (128 B) is staged in shared memory, so a byte below 0x80 costs no global
// read.
//
// Design: one warp per row, eight rows a block.  Each lane takes 4
// consecutive bytes of a 128-byte chunk with one 4-byte load where the row
// is aligned for it (L % 4 == 0 and a 4-byte-aligned base, else byte
// loads), and the three bytes after them with a shuffle from the next lane
// (the chunk's last lane reads them itself).  The row's flag is a ballot
// over its chunks; a warp stops at the first chunk that holds a flagged
// codepoint.  On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), warm:
// 0.0027-0.0031 ms for the benchmark corpus's [2352, 128] batch and
// 0.0073-0.0078 ms for its [7689, 512] one; its share of the live-bytes
// bound is in PERF.md, section 6.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNormWarps = 8;         // rows a block
constexpr uint32_t kMaxCp = 0x10FFFF;
constexpr uint32_t kFull = 0xFFFFFFFFu;

// The codepoint a lead byte b0 starts, from b0 and the next three bytes
// (JAX's arithmetic decode: 2-, 3- and 4-byte forms by b0 alone).
__device__ __forceinline__ uint32_t decode_cp(uint32_t b0, uint32_t b1, uint32_t b2,
                                              uint32_t b3) {
  uint32_t cp;
  if (b0 < 0x80u) {
    cp = b0;
  } else if (b0 < 0xE0u) {
    cp = ((b0 & 0x1Fu) << 6) | (b1 & 0x3Fu);
  } else if (b0 < 0xF0u) {
    cp = ((b0 & 0x0Fu) << 12) | ((b1 & 0x3Fu) << 6) | (b2 & 0x3Fu);
  } else {
    cp = ((b0 & 0x07u) << 18) | ((b1 & 0x3Fu) << 12) | ((b2 & 0x3Fu) << 6) | (b3 & 0x3Fu);
  }
  return min(cp, kMaxCp);
}

__global__ void __launch_bounds__(kNormWarps * 32)
norm_check_kernel(const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lens,
                  const uint8_t* __restrict__ bitmap, bool* __restrict__ stable, int B,
                  int L, bool aligned) {
  __shared__ uint8_t ascii[128];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 128) ascii[threadIdx.x] = __ldg(bitmap + threadIdx.x);
  __syncthreads();
  const int row = blockIdx.x * kNormWarps + (threadIdx.x >> 5);
  if (row >= B) return;
  const uint8_t* rb = bytes + (int64_t)row * L;
  const int len = min(__ldg(lens + row), L);
  bool flagged = false;
  for (int c0 = 0; c0 < len && !flagged; c0 += 128) {
    const int i0 = c0 + 4 * lane;
    // this lane's 4 bytes, little endian in a word (0 past L)
    uint32_t w = 0;
    if (aligned && i0 + 4 <= L) {
      w = __ldg(reinterpret_cast<const uint32_t*>(rb + i0));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + k < L) w |= (uint32_t)__ldg(rb + i0 + k) << (8 * k);
    }
    // the next 3 bytes: the next lane's word; the last lane reads its own
    uint32_t nxt = __shfl_down_sync(kFull, w, 1);
    if (lane == 31) {
      nxt = 0;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (i0 + 4 + k < L) nxt |= (uint32_t)__ldg(rb + i0 + 4 + k) << (8 * k);
    }
    const uint64_t seq = (uint64_t)w | ((uint64_t)nxt << 32);
    bool bad = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t b0 = (uint32_t)(seq >> (8 * k)) & 0xFFu;
      if (i0 + k >= len || (b0 & 0xC0u) == 0x80u) continue;
      const uint32_t cp = decode_cp(b0, (uint32_t)(seq >> (8 * k + 8)) & 0xFFu,
                                    (uint32_t)(seq >> (8 * k + 16)) & 0xFFu,
                                    (uint32_t)(seq >> (8 * k + 24)) & 0xFFu);
      bad |= (cp < 128u ? ascii[cp] : __ldg(bitmap + cp)) != 0;
    }
    flagged = __any_sync(kFull, bad);
  }
  if (lane == 0) stable[row] = !flagged;
}

}  // namespace

extern "C" {

// bytes [B, L] uint8, lens [B] int32, bitmap [0x110000] uint8 -> stable [B]
// bool (one byte each)
int ctok_norm_check(const void* bytes, const void* lens, const void* bitmap, void* stable,
                    int B, int L, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (L < 0) return (int)cudaErrorInvalidValue;
  const bool aligned = L % 4 == 0 && reinterpret_cast<uintptr_t>(bytes) % 4 == 0;
  const int blocks = (B + kNormWarps - 1) / kNormWarps;
  norm_check_kernel<<<blocks, kNormWarps * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(bytes), static_cast<const int32_t*>(lens),
      static_cast<const uint8_t*>(bitmap), static_cast<bool*>(stable), B, L, aligned);
  return (int)cudaGetLastError();
}

}  // extern "C"
