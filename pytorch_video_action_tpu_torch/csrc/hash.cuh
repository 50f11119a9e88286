// The counter-hash dropout stream of ops/hashmask.py, shared by every kernel
// under csrc/ that draws it (the flash, conv and GRU layer kernels): the
// murmur3 finalizer and the stream key of a uint32 seed.

#pragma once

#include <stdint.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The stream key of a uint32 seed, ops/hashmask.py::stream_key.
__host__ __device__ __forceinline__ uint32_t stream_key(uint32_t seed) {
  return fmix32(seed + kGolden);
}

}  // namespace
