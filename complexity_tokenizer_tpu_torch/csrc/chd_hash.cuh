// The two 32-bit mixes of the pair tables, shared by the kernels that probe
// them (kernels.cu, wordpiece.cu): bit for bit ops/hashtable.py's mix_hash
// (the cuckoo table's first slot, the CHD table's bucket) and mix_hash2 (the
// second slot, the CHD base slot), as the numpy tables of both packages are
// built.
#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t mix_hash(uint32_t a, uint32_t b) {
  uint32_t h = (a * 0x85EBCA6Bu) ^ (b * 0xC2B2AE35u);
  h ^= h >> 15;
  h *= 0x27D4EB2Fu;
  h ^= h >> 13;
  return h;
}

__device__ __forceinline__ uint32_t mix_hash2(uint32_t a, uint32_t b) {
  uint32_t g = (a * 0x9E3779B1u) ^ (b * 0x7FEB352Du);
  g ^= g >> 16;
  g *= 0x45D9F3Bu;
  return g;
}

}  // namespace
