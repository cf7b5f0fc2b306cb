// Hand-written CUDA kernel of the text pipeline's pre-split, for Hopper
// (sm_90a): K21.  Plain C interface, loaded with ctypes by
// complexity_tokenizer_tpu_torch/utils/cuda_build.py; no PyTorch headers.
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch.
//
// K21 replaces the JAX package's presplit (complexity_tokenizer_tpu/ops/
// presplit.py:75-164), which XLA fused into the text pipeline's program,
// and the chain of torch ops of its plain twin presplit_plain
// (ops/presplit.py): bytes [B, L] uint8, lengths [B] int32 and the
// [0x110000] uint8 GPT-2 class table -> start [B, L] bool (a match begins
// at this byte), word_id [B, L] int32 (the row's running count of starts,
// minus one; -1 past the length) and valid [B, L] bool (column < length),
// bit for bit for any int32 length (above L: every column is valid; below
// 0: none).
//
// The rules (the module docstring of ops/presplit.py derives them):
//   valid[j]    = j < len
//   cls0[j]     = class_table[clip(cp, 0, 0x10FFFF)], cp decoded
//                 arithmetically from bytes j..j+3 as if j were a lead byte
//                 (0 past column L-1, but the row's real bytes past len)
//   cls[j]      = three steps of "a continuation byte takes the class of
//                 the byte before it" (CL_NONE before column 0), then
//                 CL_NONE where !valid[j].  So a continuation byte takes
//                 cls0 of the first non-continuation byte among j-1..j-3,
//                 and cls0[j-3] if all three are continuation bytes (a run
//                 of 4 or more, invalid UTF-8); CL_NONE where that byte
//                 lies before column 0.
//   absorbed[j] = valid, byte ' ', cls[j-1] != WS, cls[j+1] in {L, N, O}
//   qsm[j]      = valid, byte '\'', cls[j-1] in {L, N, NONE} or
//                 (WS and !absorbed[j-1])
//   contr2[j]   = qsm[j], valid[j+1], byte j+1 in s t m d
//   contr3[j]   = qsm[j], valid[j+2], bytes j+1, j+2 = re ve ll
//   start[i]    = valid, not a continuation byte, not inside a contraction
//                 (contr2[i-1], contr3[i-1], contr3[i-2]), and absorbed[i]
//                 or a contraction ended at i-1 (contr2[i-2], contr3[i-3])
//                 or (cls[i] != cls[i-1] and !absorbed[i-1]); every term
//                 before column 0 is false.
//
// The window.  start[i] reads contr3[i-3], whose qsm reads absorbed[i-4],
// whose cls[i-5] takes its class from cls0 at i-8 at the farthest, which
// decodes bytes i-8..i-5; on the right it reads absorbed[i], whose
// cls[i+1] decodes bytes i+1..i+4.  So the starts of columns [c0, c0 + 128)
// need the bytes [c0 - 8, c0 + 132) and nothing else, and the kernel reads
// no other byte (none of the row before, none of the next row).
//
// Design: a warp a 128-column step of a row.  The step's 140 bytes (0
// outside the row) go to the warp's slice of shared memory; four passes
// over that window, a __syncwarp apart, put beside them what the next rule
// reads: (1) cls0 and the continuation flag, (2) the propagated,
// length-masked class, (3) absorbed, (4) the contraction flags, each only
// over the part of the window the rules above still need.  A last pass
// computes the 128 starts, lane l taking the columns c0 + 32 k + l (k <
// 4), so that each store instruction writes 32 consecutive columns; the
// start and valid flags are stored at once, and a ballot of each 32
// starts is kept for the word ids.
//
// The steps of a row are independent but for the word ids' running count,
// so a row's steps go to g warps of one block at once (g = the row's steps,
// at most the block's warps; a block takes kWarps / g rows): each warp
// puts its step's ballots and its count of starts in shared memory, and
// after one barrier each warp adds the counts of the steps before its own
// (a warp reduction) to the row's count so far and stores its word ids.  A
// row of more than g steps takes them g at a time, in rounds.  Rows of up
// to 15 steps run in blocks of 8 warps (at 128 columns: a warp a row, 8
// rows a block, no barrier), longer rows in blocks of 32 (at 4,096
// columns: a row a block, one round).  A step wholly at or past the length
// writes (false, -1, false) and reads nothing.  The ASCII part of the class
// table (128 entries) sits in shared memory, staged once a block; other
// code points read the table through the read-only cache.
//
// A first design ran every row's steps one after another on one warp: a
// step takes about 2.7 us of dependent loads and passes, so the
// pipeline's [16, 4096] batch (16 warps of 32 steps) took 0.085 ms, where
// this one takes 0.006 ms; at [8192, 128] / [8192, 512] the first took
// 0.0055 / 0.0290 ms and this one 0.0063 / 0.0304, warm, in turns on an
// NVIDIA H100 80GB HBM3 at 700 W (scripts/study_k21_variants.py; PERF.md,
// section 6).
//
// Bound: bytes.  Each byte read once (with a 12-byte halo every 128) and 6
// bytes written a column: 7 B a column, 29.4 MB at the pipeline's [8192,
// 512] batch, 8.8 us at 3.35 TB/s; the smaller batches are launch-bound.
// Times in PERF.md, section 6.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStep = 128;             // columns a warp step
constexpr int kLeft = 8;               // the window's bytes before the step
constexpr int kRight = 4;              // and after it
constexpr int kWin = kLeft + kStep + kRight;
constexpr int kWinPad = 144;           // kWin rounded up to 16
constexpr int kWideSteps = 16;         // rows of this many steps take blocks of 32 warps
constexpr uint32_t kAll = 0xFFFFFFFFu;

// GPT-2 classes (utils/unicode_tables.py), and the out-of-text sentinel
constexpr uint8_t kOther = 0, kWs = 1, kLetter = 2, kNumber = 3, kNone = 4;
constexpr uint8_t kContBit = 0x80;  // in the first pass's array: byte is 10xxxxxx

__device__ __forceinline__ bool is_run(uint8_t c) {
  return c == kLetter || c == kNumber || c == kOther;
}

// The starts of the step at column c0 of a row with n valid columns, from
// the window of bytes [c0 - 8, c0 + 132) in shared memory (sb) and the four
// passes' arrays; stores the start and valid flags and the ballot of each
// 32 columns in mask[0..3].
__device__ __forceinline__ void step_starts(const uint8_t* __restrict__ row,
                                            const uint8_t* __restrict__ class_table,
                                            const uint8_t* s_ascii, uint8_t* win,
                                            uint32_t* mask, uint8_t* st, uint8_t* vd, int c0,
                                            int n, int L, int lane) {
  uint8_t* sb = win;
  uint8_t* sc0 = win + kWinPad;
  uint8_t* scl = win + 2 * kWinPad;
  uint8_t* sab = win + 3 * kWinPad;
  uint8_t* scx = win + 4 * kWinPad;
  const int j0 = c0 - kLeft;  // column of window slot 0
  // (0) the bytes
  for (int k = lane; k < kWin; k += 32) {
    const int j = j0 + k;
    sb[k] = j >= 0 && j < L ? __ldg(row + j) : 0;
  }
  __syncwarp();
  // (1) cls0 and the continuation flag, slots 0..136 (cls at slot 136,
  // column c0 + 128, is the last one read)
  for (int k = lane; k <= kLeft + kStep; k += 32) {
    const uint32_t b0 = sb[k], b1 = sb[k + 1], b2 = sb[k + 2], b3 = sb[k + 3];
    uint32_t cp;
    if (b0 < 0x80) {
      cp = b0;
    } else if (b0 < 0xE0) {
      cp = ((b0 & 0x1F) << 6) | (b1 & 0x3F);
    } else if (b0 < 0xF0) {
      cp = ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F);
    } else {
      cp = ((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6) | (b3 & 0x3F);
    }
    cp = cp > 0x10FFFF ? 0x10FFFF : cp;
    const uint8_t c = cp < 128 ? s_ascii[cp] : __ldg(class_table + cp);
    sc0[k] = c | ((b0 & 0xC0) == 0x80 ? kContBit : 0);
  }
  __syncwarp();
  // (2) cls, slots 3..136 (column c0 - 5 is the farthest left read)
  for (int k = 3 + lane; k <= kLeft + kStep; k += 32) {
    const int j = j0 + k;
    uint8_t c = kNone;
    if (j >= 0 && j < n) {
      const uint8_t v = sc0[k];
      c = v & ~kContBit;
      if (v & kContBit) {
        c = kNone;
#pragma unroll
        for (int d = 1; d <= 3; ++d) {
          if (j - d < 0) break;
          const uint8_t u = sc0[k - d];
          if (!(u & kContBit) || d == 3) {
            c = u & ~kContBit;
            break;
          }
        }
      }
    }
    scl[k] = c;
  }
  __syncwarp();
  // (3) absorbed, slots 4..135
  for (int k = 4 + lane; k < kLeft + kStep; k += 32) {
    const int j = j0 + k;
    sab[k] = j >= 0 && j < n && sb[k] == 0x20 && scl[k - 1] != kWs && is_run(scl[k + 1]);
  }
  __syncwarp();
  // (4) the contractions, slots 5..135
  for (int k = 5 + lane; k < kLeft + kStep; k += 32) {
    const int j = j0 + k;
    uint8_t x = 0;
    if (j >= 0 && j < n && sb[k] == 0x27) {
      const uint8_t p = scl[k - 1];
      const bool qsm = p == kLetter || p == kNumber || p == kNone || (p == kWs && !sab[k - 1]);
      if (qsm) {
        const uint8_t n1 = sb[k + 1], n2 = sb[k + 2];
        if (j + 1 < n && (n1 == 's' || n1 == 't' || n1 == 'm' || n1 == 'd')) x |= 1;
        if (j + 2 < n && ((n1 == 'r' && n2 == 'e') || (n1 == 'v' && n2 == 'e') ||
                          (n1 == 'l' && n2 == 'l')))
          x |= 2;
      }
    }
    scx[k] = x;
  }
  __syncwarp();
  // (5) the starts, columns c0 + 32 s + lane
#pragma unroll
  for (int s = 0; s < kStep / 32; ++s) {
    const int i = c0 + 32 * s + lane;
    const int k = kLeft + 32 * s + lane;
    const bool v = i < n;
    bool start = false;
    if (v && !(sc0[k] & kContBit)) {
      const bool interior = (scx[k - 1] & 3) || (scx[k - 2] & 2);
      const bool cend_prev = (scx[k - 2] & 1) || (scx[k - 3] & 2);
      const bool change = scl[k] != scl[k - 1] && !sab[k - 1];
      start = !interior && (sab[k] || cend_prev || change);
    }
    const uint32_t m = __ballot_sync(kAll, start);
    if (lane == 0) mask[s] = m;
    if (i < L) {
      st[i] = start;
      vd[i] = v;
    }
  }
  __syncwarp();  // the window is read before the warp's next step rewrites it
}

// g: the warps that take one row's steps together (at most kWarps); the
// block takes kWarps / g rows.
template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
presplit_kernel(const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lens,
                const uint8_t* __restrict__ class_table, uint8_t* __restrict__ start_out,
                int32_t* __restrict__ wid_out, uint8_t* __restrict__ valid_out, int B, int L,
                int g) {
  __shared__ uint8_t s_ascii[128];
  // a warp's window: bytes, cls0 | continuation bit, cls, absorbed, and
  // the contraction flags (bit 0: contr2, bit 1: contr3)
  __shared__ uint8_t s_win[kWarps][5 * kWinPad];
  // a warp's ballots of its step's starts, and the count of them, in two
  // buffers: a round's counts are read before any warp passes the next
  // round's barrier
  __shared__ uint32_t s_mask[kWarps][kStep / 32];
  __shared__ int s_count[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 128) s_ascii[tid] = __ldg(class_table + tid);
  __syncthreads();
  const int group = warp / g, member = warp - group * g;
  const int64_t r = (int64_t)blockIdx.x * (kWarps / g) + group;
  const bool live = group < kWarps / g && r < B;  // a warp without a row joins the barriers
  const int64_t base = live ? r * L : 0;
  const uint8_t* row = bytes + base;
  uint8_t* st = start_out + base;
  int32_t* wd = wid_out + base;
  uint8_t* vd = valid_out + base;
  const int len = live ? __ldg(lens + r) : 0;
  const int n = len < 0 ? 0 : (len < L ? len : L);  // the valid columns
  const uint32_t le = (2u << lane) - 1u;            // lanes <= this one
  const int steps = (L + kStep - 1) / kStep;
  uint32_t* mask = s_mask[warp];
  int carry = 0;  // the row's starts in the rounds before
  for (int t = 0, rounds = (steps + g - 1) / g; t < rounds; ++t) {
    const int c0 = (t * g + member) * kStep;
    const bool work = live && c0 < L;
    const bool any = work && c0 < n;
    if (any) {
      step_starts(row, class_table, s_ascii, s_win[warp], mask, st, vd, c0, n, L, lane);
    } else if (work) {  // nothing valid from here on
      for (int i = c0 + lane; i < L && i < c0 + kStep; i += 32) {
        st[i] = 0;
        wd[i] = -1;
        vd[i] = 0;
      }
    }
    int before = carry;  // the row's starts before this step
    if (g > 1) {  // the same for the whole launch
      int count = 0;
      if (any) {
#pragma unroll
        for (int s = 0; s < kStep / 32; ++s) count += __popc(mask[s]);
      }
      if (lane == 0) s_count[t & 1][warp] = count;
      __syncthreads();
      const int q = live && lane < g ? s_count[t & 1][group * g + lane] : 0;
      before += __reduce_add_sync(kAll, lane < member ? q : 0);
      carry += __reduce_add_sync(kAll, q);
    }
    if (any) {
#pragma unroll
      for (int s = 0; s < kStep / 32; ++s) {
        const uint32_t m = mask[s];
        const int i = c0 + 32 * s + lane;
        if (i < L) wd[i] = i < n ? before + __popc(m & le) - 1 : -1;
        before += __popc(m);
      }
    }
    __syncwarp();  // the ballots are read before the warp's next step rewrites them
  }
}

// The launch of K21 for rows of L columns: blocks of 8 warps, or of 32 for
// rows of kWideSteps steps or more; g warps a row.
struct Launch {
  int warps, g, rows_per_block;
};

Launch launch_for(int L) {
  const int steps = (L + kStep - 1) / kStep;
  const int warps = steps >= kWideSteps ? 32 : 8;
  const int g = steps < warps ? steps : warps;
  return {warps, g, warps / g};
}

}  // namespace

extern "C" {

// K21: bytes [B, L] uint8, lens [B] int32, class_table [0x110000] uint8 ->
// start [B, L] bool (1 byte), wid [B, L] int32, valid [B, L] bool.
int ctok_presplit(const void* bytes, const void* lens, const void* class_table, void* start,
                  void* wid, void* valid, int B, int L, void* stream) {
  if (B <= 0 || L <= 0) return (int)cudaSuccess;
  const Launch lc = launch_for(L);
  const unsigned grid = (unsigned)((B + lc.rows_per_block - 1) / lc.rows_per_block);
  const auto s = (cudaStream_t)stream;
  const auto* b = static_cast<const uint8_t*>(bytes);
  const auto* n = static_cast<const int32_t*>(lens);
  const auto* t = static_cast<const uint8_t*>(class_table);
  auto* st = static_cast<uint8_t*>(start);
  auto* wd = static_cast<int32_t*>(wid);
  auto* vd = static_cast<uint8_t*>(valid);
  if (lc.warps == 32)
    presplit_kernel<32><<<grid, 32 * 32, 0, s>>>(b, n, t, st, wd, vd, B, L, lc.g);
  else
    presplit_kernel<8><<<grid, 8 * 32, 0, s>>>(b, n, t, st, wd, vd, B, L, lc.g);
  return (int)cudaGetLastError();
}

// K21's launch for rows of L columns: info gets threads a block, registers
// a thread, static shared bytes a block, local (spill) bytes a thread,
// resident blocks per SM and the warps a row's steps go to (g).
int ctok_presplit_info(int L, int* info) {
  const Launch lc = launch_for(L < 1 ? 1 : L);
  const void* fn = lc.warps == 32 ? (const void*)presplit_kernel<32>
                                  : (const void*)presplit_kernel<8>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, lc.warps * 32, 0);
  if (err != cudaSuccess) return (int)err;
  const int shape[] = {lc.warps * 32, fa.numRegs, (int)fa.sharedSizeBytes,
                       (int)fa.localSizeBytes, blocks, lc.g};
  for (int i = 0; i < 6; ++i) info[i] = shape[i];
  return (int)cudaSuccess;
}

}  // extern "C"
