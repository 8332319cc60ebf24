// Batched pairwise replica agreement for Hopper (sm_90a):
//   rel[b, i, j] = max_t |x_i[t] - x_j[t]| / (1 + min(|x_i[t]|, |x_j[t]|))
// over the R replicas of every trial b, the input of the reactive 2f+1
// majority vote.
//
// Replaces the TPU kernel src/repro/kernels/majority_vote.py:63
// (_agree_kernel_batched, reached from pairwise_relmax_batched at :79
// through the pl.pallas_call at :91), and at B = 1 the single form
// src/repro/kernels/majority_vote.py:30 (_agree_kernel, from
// pairwise_relmax at :46 through :53).
//
// What bounds it on the H100.  At the engine's main-path shape
// (B = 32 trials, R = 8 workers, d = k = 256 sketch symbols) the input
// is 262 KB and the work B*R*R*d = 524K divisions: the bound is well
// under a microsecond and the launch itself dominates.  At large d the
// kernel reads each input byte once (bytes bound: R*d*4 per trial
// against R*R*d divisions, about 2 divisions per byte at R = 8).
//
// What the design does about it.  The TPU kernel revisits one (R, R)
// accumulator across a sequential d-grid.  Here the d axis is cut into
// chunks, one block per (chunk, trial); a block stages a (R x 128)
// tile in shared memory so every replica column is read from device
// memory once and reused by all R*R pairs, each warp keeps the running
// maxima of up to 8 pairs in registers, reduces them across its lanes
// with shuffles, and merges them into the output with atomicMax on the
// int bits.  The values are non-negative (or NaN, kept as the canonical
// positive NaN, which orders above +inf), so the int order is the float
// order; max is exact in any order, so the result is bit-reproducible.
// The division is IEEE f32 (never --use_fast_math), as in the reference.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TW = 128;                // columns staged per tile
constexpr int PPT = 8;                 // pairs per warp per pass
constexpr long long CHUNK = 4096;      // columns per block

__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || v != v) ? v : m;    // NaN-propagating, like jnp.maximum
}

__global__ void __launch_bounds__(THREADS)
relmax_kernel(const float* __restrict__ x, int R, long long d,
              int* __restrict__ out) {
  extern __shared__ float sh[];        // (R, TW)
  const int b = blockIdx.y;
  const long long lo = (long long)blockIdx.x * CHUNK;
  const long long hi = lo + CHUNK < d ? lo + CHUNK : d;
  const float* xb = x + (long long)b * R * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P = R * R;

  for (int pass0 = 0; pass0 < P; pass0 += WARPS * PPT) {
    float m[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) m[j] = 0.0f;
    for (long long c0 = lo; c0 < hi; c0 += TW) {
      for (int e = threadIdx.x; e < R * TW; e += THREADS) {
        const int r = e / TW, q = e % TW;
        const long long p = c0 + q;
        sh[e] = p < hi ? xb[(long long)r * d + p] : 0.0f;  // zero pad: rel 0
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int pr = pass0 + warp + j * WARPS;
        if (pr < P) {
          const float* xi = sh + (pr / R) * TW;
          const float* xj = sh + (pr % R) * TW;
#pragma unroll
          for (int q = lane; q < TW; q += 32) {
            const float a = xi[q], c = xj[q];
            const float rel = fabsf(a - c) / (1.0f + fminf(fabsf(a), fabsf(c)));
            m[j] = max_nan(m[j], rel);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int pr = pass0 + warp + j * WARPS;
      float v = m[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0 && pr < P) {
        const int bits = (v != v) ? 0x7fffffff : __float_as_int(v);
        atomicMax(out + (long long)b * P + pr, bits);
      }
    }
  }
}

}  // namespace

extern "C" {

// out (B, R, R) f32, zero-filled by the caller, from x (B, R, d) f32.
// Returns cudaGetLastError().
int relmax_batched(const float* x, int B, int R, long long d, float* out,
                   void* stream) {
  dim3 grid((unsigned)((d + CHUNK - 1) / CHUNK), B);
  const size_t smem = (size_t)R * TW * sizeof(float);
  relmax_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, R, d, reinterpret_cast<int*>(out));
  return (int)cudaGetLastError();
}

const char* relmax_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int relmax_max_replicas() { return (48 * 1024) / (TW * (int)sizeof(float)); }

}  // extern "C"
