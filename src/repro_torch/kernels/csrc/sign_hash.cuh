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

// The same sign as the bit that negates an f32: 0x80000000 where
// hash_sign(pos, key) is -1, else 0.  With y = h * 2246822519u, the
// sign's bit is bit 0 of y ^ (y >> 13), which is bit 31 of
// y * (2^31 + 2^18) (mod 2^32: bit 0 of y shifted to 31 plus bits 0-13
// shifted to 18-31, no carry into 31), so one multiply by the folded
// constant takes the place of the last shift, xor and test.
__device__ __forceinline__ uint32_t hash_sign_flip(uint32_t pos,
                                                   uint32_t key) {
  uint32_t h = pos * 2654435761u + key;
  h ^= h >> 16;
  return ~(h * (2246822519u * 0x80040000u)) & 0x80000000u;
}
