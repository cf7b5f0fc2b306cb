// K8: the device normalization check, for Hopper (sm_90a).  Plain C
// interface, loaded with ctypes by
// complexity_tokenizer_tpu_torch/utils/cuda_build.py; no PyTorch headers.
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch.
//
// Replaces DeviceNormChecker._fn (complexity_tokenizer_tpu/ops/
// normalize_device.py) on ragged rows: data [n_bytes] uint8 (the rows end
// to end, n_bytes a multiple of 16), offs [B + 1] int32 (row r is
// data[offs[r]:offs[r + 1]]), a stability bitmap [0x110000] uint8 -> stable
// [B] bool, cleared where a lead byte of the row decodes to a codepoint the
// bitmap flags (rows it does not flag keep what the caller put there: the
// host sends ones in the same copy as the rows, so no memset precedes the
// launch).  Bit for bit its plain twin norm_stable_rows_ragged_plain
// (ops/normalize_device.py), which is JAX's _fn on zero-padded rows: a lead
// byte is decoded arithmetically from itself and the next three bytes of
// its own row (a byte past the row's end reads as 0, although the next
// row's bytes follow it in data), a continuation byte (10xxxxxx) is
// skipped, and the codepoint is clamped to 0x10FFFF.
//
// Bound: bytes.  The function needs each row's bytes once, its offset (4
// B), one flag a row out and the bitmap's sectors that the rows'
// codepoints land in (the 1.1 MB bitmap stays in the 50 MB L2); the block
// index below adds 4 B a block.
//
// Design: one launch over all rows, no loop over chunks.  A block of 256
// threads takes a span of 4,096 bytes, each thread 16 consecutive bytes
// with one 16-byte load, and the three bytes after them from the next
// lane's load by a shuffle (the warp's last lane reads them itself).  A
// thread first marks, without its row, the bytes that need one: ASCII
// bytes the bitmap flags (a lookup in a 256-entry copy of the bitmap's
// ASCII part in shared memory, zero for bytes >= 0x80) and lead bytes of
// multi-byte forms (>= 0xC0, found four at a time by bit tricks on each
// 32-bit word).  Most threads mark none and are done.  The block stages
// the offsets of its span's rows, which the host's per-block row index
// names (ops/normalize_device.py:norm_block_rows, one np.searchsorted), in
// shared memory in one coalesced read issued with its bytes' read, before
// its one barrier; a marking thread finds its first byte's row there by a
// binary search and the rows that start among its 20 bytes, cuts each lead
// byte's look-ahead at its row's end, reads the bitmap entries of all its
// lead bytes at once, and walks on over the offsets to the rows of its
// flagged bytes.  So a block waits on two dependent reads: its bytes and
// rows' offsets (the row index before those), then the bitmap entries.
// Times are in PERF.md, section 6.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNormThreads = 256;
constexpr int kBytes = 16;                    // bytes a thread
constexpr int kSpan = kNormThreads * kBytes;  // bytes a block
constexpr int kCap = 1024;                    // row offsets a block stages
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

// Byte k (0..19) of the 20 bytes in w (little endian words).
__device__ __forceinline__ uint32_t byte_at(const uint32_t (&w)[5], int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
}

// Bit i set where byte i of w is >= 0xC0 (the lead of a multi-byte form).
__device__ __forceinline__ uint32_t lead_bits(uint32_t w) {
  const uint32_t m = (w & (w << 1)) & 0x80808080u;  // bits 7 and 6 of each byte
  return (((m >> 7) * 0x204081u) >> 21) & 0xFu;     // bits 0, 8, 16, 24 -> 0..3
}

__global__ void __launch_bounds__(kNormThreads)
norm_check_kernel(const uint8_t* __restrict__ data, int n_bytes,
                  const int32_t* __restrict__ offs, const int32_t* __restrict__ block_rows,
                  const uint8_t* __restrict__ bitmap, bool* __restrict__ stable, int B) {
  __shared__ uint32_t ascii[256];  // the bitmap's ASCII part as 0 / 1, 0 past 0x7F
  __shared__ int32_t s_offs[kCap];
  const int tid = threadIdx.x, lane = tid & 31;
  const int p0 = blockIdx.x * kSpan + kBytes * tid;
  // this thread's 16 bytes and the next three (0 past the data), the rows'
  // end, the ASCII part of the bitmap and the offsets of the span's rows (up
  // to kCap; more, as rows of a few bytes or runs of empty rows give, are
  // read from device memory): all loads issued before the one barrier
  uint4 q = make_uint4(0u, 0u, 0u, 0u);
  if (p0 < n_bytes) q = __ldg(reinterpret_cast<const uint4*>(data + p0));
  const int r0 = __ldg(block_rows + blockIdx.x);
  const int count = __ldg(block_rows + blockIdx.x + 1) - r0 + 2;  // offs[r0 .. r1 + 1]
  const int N = min(__ldg(offs + B), n_bytes);
  ascii[tid] = tid < 128 && __ldg(bitmap + tid) != 0;
  const bool staged = count <= kCap;
  if (staged)
    for (int i = tid; i < count; i += kNormThreads) s_offs[i] = __ldg(offs + r0 + i);
  uint32_t nxt = __shfl_down_sync(kFull, q.x, 1);
  if (lane == 31) {
    nxt = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (p0 + kBytes + k < n_bytes) nxt |= (uint32_t)__ldg(data + p0 + kBytes + k) << (8 * k);
  }
  __syncthreads();
  const uint32_t w[5] = {q.x, q.y, q.z, q.w, nxt};
  // the bytes that need their row: flagged ASCII bytes and multi-byte leads
  uint32_t lead = 0, flag = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lead |= lead_bits(w[j]) << (4 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i) flag |= ascii[byte_at(w, 4 * j + i)] << (4 * j + i);
  }
  const uint32_t live = p0 >= N ? 0u : N - p0 >= kBytes ? 0xFFFFu : (1u << (N - p0)) - 1u;
  lead &= live;
  flag &= live;
  if ((lead | flag) == 0) return;
  const int32_t* o = staged ? s_offs : offs + r0;  // o[i] = offs[r0 + i]
  // the row that holds byte p0: the last i with o[i] <= p0
  int lo = 0, hi = count - 2;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (o[mid] <= p0) lo = mid; else hi = mid - 1;
  }
  // the rows that start inside the 20 bytes: bit i for byte p0 + i
  uint32_t starts = 0;
  for (int i = lo + 1; i < count && o[i] < p0 + kBytes + 3; ++i) starts |= 1u << (o[i] - p0);
  // every lead byte's codepoint, its look-ahead cut where a row starts, and
  // its bitmap entry: the loads are independent and all go out before the
  // first is used
  uint32_t v[kBytes];
#pragma unroll
  for (int k = 0; k < kBytes; ++k) {
    const uint32_t next = starts >> (k + 1);
    const int n = next ? __ffs(next) : 4;  // bytes k + 1 .. k + n - 1 lie in byte k's row
    const uint32_t cp = decode_cp(byte_at(w, k), n > 1 ? byte_at(w, k + 1) : 0u,
                                  n > 2 ? byte_at(w, k + 2) : 0u, n > 3 ? byte_at(w, k + 3) : 0u);
    v[k] = (lead >> k) & 1u ? __ldg(bitmap + cp) : 0u;
  }
#pragma unroll
  for (int k = 0; k < kBytes; ++k) flag |= (uint32_t)(v[k] != 0) << k;
  // the rows of the flagged bytes
  int r = lo;
  int end = o[r + 1];
#pragma unroll
  for (int k = 0; k < kBytes; ++k) {
    if (!((flag >> k) & 1u)) continue;
    while (p0 + k >= end) end = o[++r + 1];  // past empty rows too
    stable[r0 + r] = false;
  }
}

}  // namespace

extern "C" {

// data [n_bytes] uint8 (16-byte aligned, n_bytes a multiple of 16), offs
// [B + 1] int32 (offs[B] <= n_bytes), block_rows [n_blocks + 1] int32 (for
// blocks of `span` bytes, which must be the kernel's), bitmap [0x110000]
// uint8, stable [B] bool (read and cleared) -> stable
int ctok_norm_check(const void* data, int n_bytes, const void* offs, const void* block_rows,
                    int n_blocks, const void* bitmap, void* stable, int B, int span,
                    void* stream) {
  if (B <= 0 || n_blocks <= 0) return (int)cudaSuccess;
  if (span != kSpan || n_bytes < 0 || n_bytes % 16 != 0 ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  norm_check_kernel<<<n_blocks, kNormThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(data), n_bytes, static_cast<const int32_t*>(offs),
      static_cast<const int32_t*>(block_rows), static_cast<const uint8_t*>(bitmap),
      static_cast<bool*>(stable), B);
  return (int)cudaGetLastError();
}

// K8's launch shape: threads a block, registers a thread, static shared
// bytes a block, local (spill) bytes a thread and resident blocks per SM
int ctok_norm_check_info(int* info) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, norm_check_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, norm_check_kernel, kNormThreads,
                                                      0);
  if (err != cudaSuccess) return (int)err;
  const int shape[] = {kNormThreads, fa.numRegs, (int)fa.sharedSizeBytes,
                       (int)fa.localSizeBytes, blocks};
  for (int i = 0; i < 5; ++i) info[i] = shape[i];
  return (int)cudaSuccess;
}

}  // extern "C"
