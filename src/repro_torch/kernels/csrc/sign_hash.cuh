// The CountSketch sign of column `pos` under a uint32 key: the
// reference's xorshift-multiply hash (src/repro/kernels/ref.py:18,
// hash_signs_ref), low bit -> +1, else -1.  Shared by every kernel that
// sketches (gram.cu, sketch.cu, fused_step.cu), so their tables use one
// definition of the sign, bit for bit.
#pragma once
#include <stdint.h>

__device__ __forceinline__ float hash_sign(uint32_t pos, uint32_t key) {
  uint32_t h = pos * 2654435761u + key;
  h ^= h >> 16;
  h *= 2246822519u;
  h ^= h >> 13;
  return (h & 1u) ? 1.0f : -1.0f;
}
