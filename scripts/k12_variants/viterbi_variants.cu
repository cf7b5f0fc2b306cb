// Designs of K12 (csrc/unigram.cu's ctok_viterbi) that the package does not
// ship, for scripts/study_k12_variants.py only: the package's Viterbi with
// the parts it was measured against behind K12_* switches.  Built alone with
// the package's nvcc flags, -I complexity_tokenizer_tpu_torch/csrc and one
// set of these macros (with none set, this is the package's K12):
// - K12_LAYOUT: the texts of [0, n16) 2 kTextLanes lanes each (the
//   package), 1 in lane groups of 8 and 16 lanes (4 and 2 texts a warp,
//   with spaces of their texts' width, the layout tried first), 0 a warp
//   each;
// - K12_TRUE_CAND: in groups and warps, 1 (the package) only the real
//   (end, length <= end) candidates, 0 every (end, length <= maxcand) slot;
// - K12_SERIAL_DP: in groups and warps, 1 (the package) a lane takes a DP
//   step's candidates, 0 three reductions over the group;
// - K12_BATCH: candidates a lane probes together (the package 2);
// - K12_TEXT_LANES: lanes a text in the lanes' layout, 1, 2, 4 (the
//   package) or 8;
// - K12_ABLATE: a part taken out, timed only (its ids are wrong): 1 the
//   probes, 2 the DP, 3 the check, 4 the backtrack.
// See csrc/unigram.cu for the design and its bound.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "chd_hash.cuh"

// the texts of [0, n16): 2 kTextLanes lanes each, 1 lane groups of 8 and 16, 0 a warp each
#ifndef K12_LAYOUT
#define K12_LAYOUT 2
#endif
// groups and warps: 1 only the (e, l <= e) candidates, 0 every (e, l <= maxcand) slot
#ifndef K12_TRUE_CAND
#define K12_TRUE_CAND 1
#endif
// groups and warps: 1 a lane takes a DP step's candidates, 0 three reductions
#ifndef K12_SERIAL_DP
#define K12_SERIAL_DP 1
#endif
#ifndef K12_BATCH  // candidates a lane probes together
#define K12_BATCH 2
#endif
#ifndef K12_TEXT_LANES  // the lanes' layout: lanes a text (1, 2, 4 or 8)
#define K12_TEXT_LANES 4
#endif
#ifndef K12_ABLATE  // a part taken out (timed only): 1 probe, 2 DP, 3 check, 4 backtrack
#define K12_ABLATE 0
#endif

namespace {

constexpr uint32_t kB1 = 0x01000193u;
constexpr uint32_t kB2 = 0x0BADC0DFu;
constexpr int32_t kInfRank = 0x3FFFFFFF;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kMaxW = 128;          // characters a text
constexpr int kPowLen = kMaxW + 1;  // a row of the powers table
// warps a block: 2 where a warp's space is 12.7 KB (a lane a text), else 4
constexpr int kVitWarps = K12_LAYOUT == 2 && K12_TEXT_LANES == 1 ? 2 : 4;
constexpr int kVitMinBlocks = 8;  // the launch bound, resident blocks an SM (6 and 10 time alike)
constexpr int kLaneW = 16;          // characters of a text of the lanes' layout
constexpr int kTextLanes = K12_TEXT_LANES;  // lanes a text there
constexpr int kTexts = 32 / kTextLanes;     // texts a warp there
static_assert(kTextLanes == 1 || kTextLanes == 2 || kTextLanes == 4 || kTextLanes == 8,
              "K12_TEXT_LANES: 1, 2, 4 or 8");
constexpr int kBigCand = 128;       // candidates a chunk of a warp's text
constexpr int kBatch = K12_BATCH;
constexpr float kNeg = -1e30f;      // ops/unigram_device.py's _NEG
constexpr float kHalfNeg = kNeg * 0.5f;
constexpr float kEps = 1e-4f;
constexpr int32_t kFbTag = INT32_MIN;  // a candidate that is the fallback

struct Pieces {
  const int32_t* __restrict__ disp;
  const int4* __restrict__ rows;
  uint32_t size_mask;
  uint32_t bucket_mask;
  const int32_t* __restrict__ chars;   // [V, Lt]
  const int32_t* __restrict__ lens;    // [V]
  const float* __restrict__ scores;    // [V]
  int Lt;
};

struct Texts {
  const int32_t* __restrict__ chars;  // [N]
  const int32_t* __restrict__ offs;   // [B + 1]
  const int32_t* __restrict__ lens;   // [B]
  int32_t* __restrict__ out;          // [N]
  int32_t* __restrict__ count;        // [B]
  int32_t* __restrict__ poison;       // [B]
  float fb;                           // the fallback score
  int maxcand;                        // 1..128
  int32_t fb_id;                      // the fallback marker
};

// A text's space: C characters, K candidates a chunk
template <int C, int K>
struct Space {
  uint32_t P1[C + 1];
  uint32_t P2[C + 1];
  float best[C + 1];  // the DP's best total at each end
  int32_t text[C];    // the characters
  int32_t tid[C];     // end e's chosen id (at e - 1): -1 none
  int32_t len[C];     // its length: -1 a fallback, 0 none
  float csc[K];       // a chunk's candidates: score
  int32_t ctid[K];    // and id (kFbTag: the fallback)
};

template <int G>
using GroupSpace = Space<G, G * (G + 1) / 2>;  // every candidate of G characters

// A warp's space for kTexts texts of at most kLaneW characters, kTextLanes
// lanes each: [position][text], so that the texts' accesses to one position
// fall in different banks; every lane of a text writes the same values to
// its text's column and reads only what it wrote itself, so no barrier
// orders them
struct LaneSpace {
  uint32_t P1[kLaneW + 1][kTexts];
  uint32_t P2[kLaneW + 1][kTexts];
  float best[kLaneW + 1][kTexts];
  int32_t text[kLaneW][kTexts];
  int32_t tid[kLaneW][kTexts];
  int32_t len[kLaneW][kTexts];
};

// A warp's space: kTexts texts of up to 16 characters, 4 of 8, 2 of 16, or
// one of 128
union WarpSpace {
#if K12_LAYOUT == 2
  LaneSpace lanes;
#endif
  GroupSpace<8> s8[4];
  GroupSpace<16> s16[2];
  Space<kMaxW, kBigCand> big;
};

template <int G>
__device__ __forceinline__ GroupSpace<G>& group_space(WarpSpace& ws, int g);
template <>
__device__ __forceinline__ GroupSpace<8>& group_space<8>(WarpSpace& ws, int g) { return ws.s8[g]; }
template <>
__device__ __forceinline__ GroupSpace<16>& group_space<16>(WarpSpace& ws, int g) {
  return ws.s16[g];
}

// Inclusive scan of the affine maps x -> x * m + v over each group of G
// lanes (in lane order): on return lane j of a group holds the composition
// of its lanes 0..j.
template <int G>
__device__ __forceinline__ void affine_scan(uint32_t& m, uint32_t& v, int gl, uint32_t gmask) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    const uint32_t pm = __shfl_up_sync(gmask, m, o, G);
    const uint32_t pv = __shfl_up_sync(gmask, v, o, G);
    if (gl >= o) {
      v = pv * m + v;
      m = pm * m;
    }
  }
}

template <int G>
__device__ __forceinline__ float group_max(float x, uint32_t gmask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(gmask, x, o, G));
  return x;
}

template <int G>
__device__ __forceinline__ int group_max(int x, uint32_t gmask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(gmask, x, o, G));
  return x;
}

// The index of candidate (e, 1) among a text's candidates of lengths
// 1..Lc, in order of end, then length (the real ones, l <= e; without
// K12_TRUE_CAND every (e, l <= Lc) slot)
__device__ __forceinline__ int cand_base(int e, int Lc) {
#if K12_TRUE_CAND
  return e <= Lc + 1 ? e * (e - 1) / 2 : Lc * (Lc + 1) / 2 + (e - Lc - 1) * Lc;
#else
  return (e - 1) * Lc;
#endif
}

// The candidate (e, l) of index k
__device__ __forceinline__ void cand_of(int k, int Lc, int& e, int& l) {
#if K12_TRUE_CAND
  const int tri = Lc * (Lc + 1) / 2;
  if (k < tri) {  // the triangle: end e holds lengths 1..e
    e = (int)((1.0f + __fsqrt_rn((float)(8 * k + 1))) * 0.5f);
    if (e * (e - 1) / 2 > k) --e;
    else if (e * (e + 1) / 2 <= k) ++e;
    l = k - e * (e - 1) / 2 + 1;
  } else {
    const int q = k - tri;
    e = Lc + 1 + q / Lc;
    l = q - (e - Lc - 1) * Lc + 1;
  }
#else
  e = k / Lc + 1;
  l = k - (e - 1) * Lc + 1;
#endif
}

// kBatch candidates of lengths l[] with keys (a, b), their reads in flight
// together (all displacements, then all rows, then the hits' lengths and
// scores) -> each one's score (-1e30: nothing) and id (-1 none, kFbTag the
// fallback).  A hit of
// another length scores nothing and is no fallback; a single character
// that is no piece falls back, its score the fallback score
__device__ __forceinline__ void probe_batch(const Pieces& pc, float fb, const uint32_t (&a)[kBatch],
                                            const uint32_t (&b)[kBatch], const int (&l)[kBatch],
                                            const bool (&real)[kBatch], float (&sc)[kBatch],
                                            int32_t (&id)[kBatch]) {
#if K12_ABLATE == 1
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {  // no probe: an id and a score from the key
    id[u] = real[u] && (a[u] & 3u) == 0 ? (int32_t)(b[u] & 1023u)
                                        : (real[u] && l[u] == 1 ? kFbTag : -1);
    sc[u] = id[u] == kFbTag ? fb : (id[u] >= 0 ? -(float)((a[u] >> 8) & 255u) - 1.0f : kNeg);
  }
#else
  uint32_t d[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    d[u] = real[u] ? (uint32_t)__ldg(pc.disp + (mix_hash(a[u], b[u]) & pc.bucket_mask)) : 0u;
  int4 r[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    r[u] = real[u] ? __ldg(pc.rows + ((mix_hash2(a[u], b[u]) + d[u]) & pc.size_mask))
                   : make_int4(0, 0, kInfRank, 0);
  int32_t plen[kBatch];
  float psc[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const bool hit = real[u] && r[u].x == (int32_t)a[u] && r[u].y == (int32_t)b[u] &&
                     r[u].z != kInfRank;
    id[u] = hit ? r[u].z : -1;
    plen[u] = hit ? __ldg(pc.lens + r[u].z) : 0;
    psc[u] = hit ? __ldg(pc.scores + r[u].z) : kNeg;
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    sc[u] = id[u] >= 0 && plen[u] == l[u] ? psc[u] : kNeg;
    if (id[u] < 0 && real[u] && l[u] == 1) {
      id[u] = kFbTag;
      sc[u] = fb;
    }
  }
#endif
}

// Scores the candidates [k0, k1) of a text into s.csc / s.ctid (from k0),
// kBatch a lane at a time with their reads in flight together
template <int G, int C, int K>
__device__ __forceinline__ void score_candidates(Space<C, K>& s, const Pieces& pc,
                                                 const uint32_t* spow, float fb, int Lc, int k0,
                                                 int k1, int gl) {
  for (int kb = k0 + gl; kb < k1; kb += kBatch * G) {
    uint32_t a[kBatch], b[kBatch];
    int cl[kBatch];
    bool live[kBatch], real[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = kb + u * G;
      live[u] = k < k1;
      int e, l;
      cand_of(live[u] ? k : k0, Lc, e, l);
      real[u] = live[u] && l <= e;
      const int s0 = real[u] ? e - l : 0;
      cl[u] = l;
      a[u] = s.P1[e] - s.P1[s0] * spow[l];
      b[u] = s.P2[e] - s.P2[s0] * spow[kPowLen + l];
    }
    int32_t id[kBatch];
    float sc[kBatch];
    probe_batch(pc, fb, a, b, cl, real, sc, id);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (live[u]) {
        s.csc[kb + u * G - k0] = sc[u];
        s.ctid[kb + u * G - k0] = id[u];
      }
    }
  }
}

// Records end e's decision: the best total, the chosen id and length
template <int C, int K>
__device__ __forceinline__ void record_end(Space<C, K>& s, int e, int cb, float m, int k,
                                           int32_t fb_id) {
  const bool valid = m > kHalfNeg;
  const int32_t ct = valid ? s.ctid[cb + k - 1] : -1;
  s.best[e] = valid ? m : kNeg;
  s.tid[e - 1] = valid ? (ct == kFbTag ? fb_id : ct) : -1;
  s.len[e - 1] = valid ? (ct == kFbTag ? -1 : k) : 0;
}

__device__ __forceinline__ bool ambiguous(float m, float runner) {
  return m > kHalfNeg && runner > kHalfNeg &&
         __fsub_rn(m, runner) < __fmul_rn(kEps, __fadd_rn(1.0f, fabsf(m)));
}

// One candidate folded into an end's running decision, in order of length:
// the maximum m, the largest length k reaching it and its candidate id kid,
// and m2, the best of the others (the one a tie displaces joins them)
__device__ __forceinline__ void fold(float tot, int l, int32_t ct, float& m, float& m2, int& k,
                                     int32_t& kid) {
  const bool ge = tot >= m;
  m2 = fmaxf(m2, ge ? m : tot);
  m = ge ? tot : m;
  k = ge ? l : k;
  kid = ge ? ct : kid;
}

// The DP over the ends [e0, e1] of a chunk whose candidates start at k0;
// returns whether a decision was ambiguous (in every lane, or in lane 0)
template <int G, int C, int K>
__device__ __forceinline__ bool dp_steps(Space<C, K>& s, int Lc, int e0, int e1, int k0,
                                         int32_t fb_id, int gl, uint32_t gmask) {
  bool amb = false;
#if K12_ABLATE == 2
  if (gl == 0)  // no DP: every end takes its length-1 candidate
    for (int e = e0; e <= e1; ++e) record_end(s, e, cand_base(e, Lc) - k0, 0.0f, 1, fb_id);
#elif K12_SERIAL_DP
  if (gl == 0) {
    for (int e = e0; e <= e1; ++e) {
      const int cb = cand_base(e, Lc) - k0;
      const int le = min(e, Lc);
      float m = -CUDART_INF_F, m2 = -CUDART_INF_F;
      int k = 0;
      int32_t kid = -1;
      for (int l = 1; l <= le; ++l) {
        const float sc = s.csc[cb + l - 1];
        fold(sc > kHalfNeg ? __fadd_rn(s.best[e - l], sc) : kNeg, l, 0, m, m2, k, kid);
      }
      // the lengths past e, and the chosen one, count as -1e30
      amb |= ambiguous(m, fmaxf(m2, kNeg));
      record_end(s, e, cb, m, k, fb_id);
    }
  }
#else
  constexpr int R = (C + G - 1) / G;  // lengths a lane takes
  for (int e = e0; e <= e1; ++e) {
    const int cb = cand_base(e, Lc) - k0;
    float tot[R];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int l = gl + 1 + G * r;
      tot[r] = -CUDART_INF_F;  // no candidate
      if (l <= Lc) {
        const float sc = l <= e ? s.csc[cb + l - 1] : kNeg;
        tot[r] = l <= e && sc > kHalfNeg ? __fadd_rn(s.best[e - l], sc) : kNeg;
        m = fmaxf(m, tot[r]);
      }
    }
    m = group_max<G>(m, gmask);
    int k = 0;  // the largest length reaching the maximum
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int l = gl + 1 + G * r;
      if (l <= Lc && tot[r] == m) k = l;
    }
    k = group_max<G>(k, gmask);
    float runner = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int l = gl + 1 + G * r;
      if (l <= Lc && l != k) runner = fmaxf(runner, tot[r]);
    }
    // the chosen lane counts as -1e30 among the others, as in the plain version
    runner = fmaxf(group_max<G>(runner, gmask), kNeg);
    amb |= ambiguous(m, runner);
    if (gl == 0) record_end(s, e, cb, m, k, fb_id);
    __syncwarp(gmask);
  }
#endif
  return amb;
}

// Text t (its characters at off, slots slots, n of them read) by a group of
// G lanes (lane gl, mask gmask) in the space s
template <int G, int C, int K>
__device__ __forceinline__ void run_text(Space<C, K>& s, const Texts& tx, const Pieces& pc,
                                         const uint32_t* spow, int t, int off, int slots, int n,
                                         int gl, uint32_t gmask) {
  // -1 in every slot; the ids are written after the __syncwarp below
  for (int i = gl; i < slots; i += G) tx.out[off + i] = -1;

  // 1. the characters and the prefix hashes, G at a time
  if (gl == 0) {
    s.P1[0] = 0;
    s.P2[0] = 0;
    s.best[0] = 0.0f;
  }
  uint32_t c1 = 0, c2 = 0;  // P[i0], the carry into the chunk
  for (int i0 = 0; i0 < n; i0 += G) {
    const int i = i0 + gl;
    const bool in = i < n;
    const int32_t c = in ? __ldg(tx.chars + off + i) : -1;
    if (in) s.text[i] = c;
    uint32_t m1 = in ? kB1 : 1u, v1 = in && c >= 0 ? (uint32_t)c + 1u : 0u;
    uint32_t m2 = in ? kB2 : 1u, v2 = v1;
    affine_scan<G>(m1, v1, gl, gmask);
    affine_scan<G>(m2, v2, gl, gmask);
    const uint32_t p1 = c1 * m1 + v1, p2 = c2 * m2 + v2;
    if (in) {
      s.P1[i + 1] = p1;
      s.P2[i + 1] = p2;
    }
    c1 = __shfl_sync(gmask, p1, G - 1, G);
    c2 = __shfl_sync(gmask, p2, G - 1, G);
  }
  __syncwarp(gmask);

  // 2-3. the candidates in chunks of K, each scored, then the DP over its
  // ends; a length never exceeds its end, so lengths stop at n
  const int Lc = max(1, min(tx.maxcand, n));
  const int total = cand_base(n + 1, Lc);
  bool amb = false;
  for (int e0 = 1; e0 <= n;) {
    const int k0 = cand_base(e0, Lc);
    const int e1 = total - k0 <= K ? n : min(n, e0 + K / Lc - 1);
    const int k1 = cand_base(e1 + 1, Lc);
    score_candidates<G>(s, pc, spow, tx.fb, Lc, k0, k1, gl);
    __syncwarp(gmask);
    amb |= dp_steps<G>(s, Lc, e0, e1, k0, tx.fb_id, gl, gmask);
    __syncwarp(gmask);
    e0 = e1 + 1;
  }

  // 4. the exact check of every end's chosen piece, a lane an end
  bool bad = false;
#if K12_ABLATE != 3
  for (int e = gl + 1; e <= n; e += G) {
    const int32_t id = s.tid[e - 1];
    const int L = s.len[e - 1];
    if (id >= 0 && L > 0) {
      const int32_t* pch = pc.chars + (int64_t)id * pc.Lt;
      for (int j = 0; j < L; ++j) bad |= __ldg(pch + j) != s.text[e - L + j];
    }
  }
#endif
  const bool poisoned = __any_sync(gmask, bad || amb);

  // 5. the backtrack: ids at their start positions
  if (gl == 0) {
    int emitted = 0;
#if K12_ABLATE != 4
    int pos = n;
    while (pos > 0) {
      const int32_t id = s.tid[pos - 1];
      const int L = s.len[pos - 1];
      const int start = pos - (L < 0 ? 1 : max(L, 1));
      tx.out[off + start] = id;
      emitted += id != -1;
      pos = start;
    }
#endif
    tx.count[t] = emitted;
    tx.poison[t] = poisoned ? 1 : 0;
  }
}

// Where text t's characters lie and how many are read
__device__ __forceinline__ void text_at(const Texts& tx, int t, int& off, int& slots, int& n) {
  off = __ldg(tx.offs + t);
  slots = __ldg(tx.offs + t + 1) - off;
  n = max(0, min(min(__ldg(tx.lens + t), slots), kMaxW));
}

// Two lanes' folds of one end's candidates (disjoint lengths) combined, as
// folding them in order of length would: the larger total, on a tie the
// larger length; the other's total joins the best of the others
__device__ __forceinline__ void combine(float& m, float& m2, int& k, int32_t& kid, int o,
                                        uint32_t gmask) {
  const float om = __shfl_xor_sync(gmask, m, o, kTextLanes);
  const float om2 = __shfl_xor_sync(gmask, m2, o, kTextLanes);
  const int ok = __shfl_xor_sync(gmask, k, o, kTextLanes);
  const int32_t okid = __shfl_xor_sync(gmask, kid, o, kTextLanes);
  const bool mine = m > om || (m == om && k > ok);
  m2 = fmaxf(fmaxf(m2, om2), mine ? om : m);
  m = mine ? m : om;
  k = mine ? k : ok;
  kid = mine ? kid : okid;
}

// Text t (n <= kLaneW characters at off) by the kTextLanes lanes of group
// g (lane gl of it): the prefix hashes; then, end by end, lane gl probes
// the lengths gl + 1, gl + 1 + kTextLanes, ... of the end's real candidates
// (kBatch with their reads in flight together), folds them in order, and
// the group's folds are combined, so every lane holds the end's decision;
// then the exact check (a lane an end) and the backtrack (lane 0).  The
// text's slots already hold -1.
__device__ __forceinline__ void lane_text(LaneSpace& ls, const Texts& tx, const Pieces& pc,
                                          const uint32_t* spow, int t, int off, int n, int g,
                                          int gl, uint32_t gmask) {
  // 1. the characters (all loads first) and the prefix hashes, in every
  // lane of the group
  int32_t c[kLaneW];
#pragma unroll
  for (int i = 0; i < kLaneW; ++i) c[i] = i < n ? __ldg(tx.chars + off + i) : -1;
  ls.P1[0][g] = 0;
  ls.P2[0][g] = 0;
  ls.best[0][g] = 0.0f;
  uint32_t p1 = 0, p2 = 0;
#pragma unroll
  for (int i = 0; i < kLaneW; ++i) {
    if (i < n) {
      const uint32_t v = c[i] >= 0 ? (uint32_t)c[i] + 1u : 0u;
      p1 = p1 * kB1 + v;
      p2 = p2 * kB2 + v;
      ls.P1[i + 1][g] = p1;
      ls.P2[i + 1][g] = p2;
      ls.text[i][g] = c[i];
    }
  }

  const int Lc = max(1, min(tx.maxcand, n));
  bool amb = false;
  // 2-3. the candidates and the DP, end by end
  for (int e = 1; e <= n; ++e) {
    const int le = min(e, Lc);
    const uint32_t pe1 = ls.P1[e][g], pe2 = ls.P2[e][g];
    float m = -CUDART_INF_F, m2 = -CUDART_INF_F;
    int k = 0;
    int32_t kid = -1;
    for (int l0 = gl + 1; l0 <= le; l0 += kTextLanes * kBatch) {
      uint32_t a[kBatch], b[kBatch];
      int cl[kBatch];
      bool real[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int l = l0 + u * kTextLanes;
        real[u] = l <= le;
        cl[u] = l;
        const int s0 = real[u] ? e - l : 0;
        a[u] = pe1 - ls.P1[s0][g] * spow[real[u] ? l : 0];
        b[u] = pe2 - ls.P2[s0][g] * spow[kPowLen + (real[u] ? l : 0)];
      }
      int32_t id[kBatch];
      float sc[kBatch];
      probe_batch(pc, tx.fb, a, b, cl, real, sc, id);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (real[u]) {
#if K12_ABLATE == 2
          if (cl[u] == 1) {  // no DP: every end takes its length-1 candidate
            m = 0.0f;
            k = 1;
            kid = id[u];
          }
#else
          fold(sc[u] > kHalfNeg ? __fadd_rn(ls.best[e - cl[u]][g], sc[u]) : kNeg, cl[u], id[u],
               m, m2, k, kid);
#endif
        }
      }
    }
#pragma unroll
    for (int o = 1; o < kTextLanes; o <<= 1) combine(m, m2, k, kid, o, gmask);
    const bool valid = m > kHalfNeg;
    ls.best[e][g] = valid ? m : kNeg;
    ls.tid[e - 1][g] = valid ? (kid == kFbTag ? tx.fb_id : kid) : -1;
    ls.len[e - 1][g] = valid ? (kid == kFbTag ? -1 : k) : 0;
    // the lengths past e, and the chosen one, count as -1e30
    amb |= ambiguous(m, fmaxf(m2, kNeg));
  }

  // 4. the exact check of every end's chosen piece, a lane an end
  bool bad = false;
#if K12_ABLATE != 3
  for (int e = gl + 1; e <= n; e += kTextLanes) {
    const int32_t id = ls.tid[e - 1][g];
    const int L = ls.len[e - 1][g];
    if (id >= 0 && L > 0) {
      const int32_t* pch = pc.chars + (int64_t)id * pc.Lt;
      for (int j = 0; j < L; ++j) bad |= __ldg(pch + j) != ls.text[e - L + j][g];
    }
  }
#endif
  const bool poisoned = __any_sync(gmask, bad) || amb;
  __syncwarp(gmask);  // every end's id and length, for lane 0

  // 5. the backtrack: ids at their start positions
  if (gl == 0) {
    int emitted = 0;
#if K12_ABLATE != 4
    int pos = n;
    while (pos > 0) {
      const int32_t id = ls.tid[pos - 1][g];
      const int L = ls.len[pos - 1][g];
      const int start = pos - (L < 0 ? 1 : max(L, 1));
      tx.out[off + start] = id;
      emitted += id != -1;
      pos = start;
    }
#endif
    tx.count[t] = emitted;
    tx.poison[t] = poisoned ? 1 : 0;
  }
}

// The texts [first, first + kTexts) of [.., last), kTextLanes lanes each
// (the warp first writes -1 in all their slots, which lie end to end);
// true in the lanes of a text longer than kLaneW (the warp takes it
// afterwards)
__device__ __forceinline__ bool lane_texts(LaneSpace& ls, const Texts& tx, const Pieces& pc,
                                           const uint32_t* spow, int first, int last,
                                           int lane) {
  const int o0 = __ldg(tx.offs + first), o1 = __ldg(tx.offs + min(first + kTexts, last));
  for (int i = o0 + lane; i < o1; i += 32) tx.out[i] = -1;
  __syncwarp();
  const int g = lane / kTextLanes, gl = lane % kTextLanes;
  const int t = first + g;
  if (t >= last) return false;
  int off, slots, n;
  text_at(tx, t, off, slots, n);
  if (n > kLaneW) return true;
  const uint32_t gmask =
      kTextLanes == 32 ? kFull : ((1u << kTextLanes) - 1u) << (g * kTextLanes);
  lane_text(ls, tx, pc, spow, t, off, n, g, gl, gmask);
  return false;
}

// The texts [first, first + 32 / G) of [.., last), a group of G lanes each;
// true in the lanes of a group whose text is longer than G (the warp takes
// it afterwards)
template <int G>
__device__ __forceinline__ bool group_texts(WarpSpace& ws, const Texts& tx, const Pieces& pc,
                                            const uint32_t* spow, int first, int last, int lane) {
  const int g = lane / G, gl = lane % G;
  const uint32_t gmask = ((1u << G) - 1u) << (g * G);
  const int t = first + g;
  if (t >= last) return false;
  int off, slots, n;
  text_at(tx, t, off, slots, n);
  if (n > G) return true;
  run_text<G>(group_space<G>(ws, g), tx, pc, spow, t, off, slots, n, gl, gmask);
  return false;
}

__global__ void __launch_bounds__(kVitWarps * 32, kVitMinBlocks)
viterbi_kernel(Texts tx, int n8, int n16, int B, int w8, int w16, Pieces pc,
               const uint32_t* __restrict__ pows) {
  __shared__ uint32_t s_pow[2 * kPowLen];  // base1^l, base2^l
  __shared__ WarpSpace s_warp[kVitWarps];
  for (int i = threadIdx.x; i < 2 * kPowLen; i += kVitWarps * 32) s_pow[i] = __ldg(pows + i);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kVitWarps + warp;
  WarpSpace& ws = s_warp[warp];
  // warps [0, w8) take texts of [0, n8), [w8, w8 + w16) of [n8, n16): 32
  // a warp, a lane each (or 4 and 2 a warp in groups of 8 and 16 lanes);
  // the rest one of [n16, B) each
  int first, G;
  bool whole;  // this lane's text (group's) is left to the whole warp
#if K12_LAYOUT == 2
  if (w < w8 + w16) {
    first = w < w8 ? kTexts * w : n8 + kTexts * (w - w8);
    G = kTextLanes;
    whole = lane_texts(ws.lanes, tx, pc, s_pow, first, w < w8 ? n8 : n16, lane);
  } else {
#else
  if (w < w8) {
    first = 4 * w;
    G = 8;
    whole = group_texts<8>(ws, tx, pc, s_pow, first, n8, lane);
  } else if (w < w8 + w16) {
    first = n8 + 2 * (w - w8);
    G = 16;
    whole = group_texts<16>(ws, tx, pc, s_pow, first, n16, lane);
  } else {
#endif
    first = n16 + (w - w8 - w16);
    G = 32;
    whole = first < B;
  }
  for (uint32_t todo = __ballot_sync(kFull, whole && lane % G == 0); todo; todo &= todo - 1) {
    __syncwarp();  // the groups' spaces, or the last text's, are free
    const int t = first + (__ffs(todo) - 1) / G;
    int off, slots, n;
    text_at(tx, t, off, slots, n);
    run_text<32>(ws.big, tx, pc, s_pow, t, off, slots, n, lane, kFull);
  }
}

}  // namespace

extern "C" {

// K12: chars [N] int32, offs [B + 1] int32, lens [B] int32, the lane groups
// (n8, n16: 0 <= n8 <= n16 <= B), the CHD table (rows 16-byte aligned), the
// piece tables, the fallback score, the longest candidate (1..128), the
// fallback marker and the powers [4, 129] uint32 -> res [N + 2B] int32
// (out, count, poison)
int ctok_viterbi(const void* chars, const void* offs, const void* lens, int n8, int n16, int B,
                 const void* disp, const void* rows, unsigned size_mask, unsigned bucket_mask,
                 const void* piece_chars, const void* piece_lens, const void* piece_scores,
                 int Lt, float fallback_score, int maxcand, int fallback_id, const void* pows,
                 void* res, int N, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Lt <= 0 || Lt > kMaxW || maxcand < 1 || maxcand > kMaxW || N < 0 || n8 < 0 ||
      n16 < n8 || B < n16)
    return (int)cudaErrorInvalidValue;
#if K12_LAYOUT == 0
  n8 = n16 = 0;
#endif
  // texts a warp takes in each class
  constexpr int k8 = K12_LAYOUT == 2 ? kTexts : 4, k16 = K12_LAYOUT == 2 ? kTexts : 2;
  const Pieces pc{static_cast<const int32_t*>(disp), static_cast<const int4*>(rows),
                  (uint32_t)size_mask, (uint32_t)bucket_mask,
                  static_cast<const int32_t*>(piece_chars), static_cast<const int32_t*>(piece_lens),
                  static_cast<const float*>(piece_scores), Lt};
  int32_t* out = static_cast<int32_t*>(res);
  const Texts tx{static_cast<const int32_t*>(chars), static_cast<const int32_t*>(offs),
                 static_cast<const int32_t*>(lens), out, out + N, out + N + B,
                 fallback_score, maxcand, (int32_t)fallback_id};
  const int w8 = (n8 + k8 - 1) / k8, w16 = (n16 - n8 + k16 - 1) / k16;
  const int64_t warps = (int64_t)w8 + w16 + (B - n16);
  const int blocks = (int)((warps + kVitWarps - 1) / kVitWarps);
  viterbi_kernel<<<blocks, kVitWarps * 32, 0, (cudaStream_t)stream>>>(
      tx, n8, n16, B, w8, w16, pc, static_cast<const uint32_t*>(pows));
  return (int)cudaGetLastError();
}

// K12's launch shape: info gets threads a block, registers a thread, static
// shared bytes a block, local (spill) bytes a thread and resident blocks per
// SM
int ctok_viterbi_info(int* info) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, viterbi_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, viterbi_kernel, kVitWarps * 32, 0);
  if (err != cudaSuccess) return (int)err;
  const int shape[] = {kVitWarps * 32, fa.numRegs, (int)fa.sharedSizeBytes,
                       (int)fa.localSizeBytes, blocks};
  for (int i = 0; i < 5; ++i) info[i] = shape[i];
  return (int)cudaSuccess;
}

}  // extern "C"
