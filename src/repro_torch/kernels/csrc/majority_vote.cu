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
// What bounds it on the H100.  At the engine's vote shape (B = 32
// trials, R = 8 workers, d = 256 sketch symbols) the input is 262 KB
// and the work 1.2M f32 divisions (one per unordered pair and column):
// well under a microsecond of bytes or operations, so the launch and
// the host's call set the time.  At the single form's (R = 7, d = 1e5)
// it reads 2.8 MB once, 0.8 us at 3.35 TB/s.  The card is bound by
// filling it at all: the design must reach every SM with little work.
//
// What the design does about it.  Replicas are cut into row tiles of
// 8; a block of 256 threads takes one tile pair (ti <= tj) of one trial
// over one chunk of d.  The chunks per trial are chosen from B, the tile
// pairs and d so that the grid gives about two blocks per SM wherever d
// allows (at least 1024 columns a chunk); at the engine's d = 256 one
// block covers a trial, one column a thread.  Each thread reads its
// columns of the tile pair's 8 (or 16) replicas straight into
// registers, coalesced, with no shared-memory staging and no barrier in
// the column loop, and keeps the running maxima of the tile pair's
// pairs in registers: each unordered pair is computed once (|a - c| and
// min(|a|, |c|) are symmetric, so rel[i, j] = rel[j, i] bit for bit) and
// written to both entries; the diagonal is |a - a|, which is what the
// formula gives (0, or NaN for a NaN or +-inf input).  The maxima are
// reduced over a warp with redux.sync on the int bits and across warps
// in shared memory: the values are non-negative, or NaN kept as the
// canonical 0x7fffffff, which orders above +inf, so the int order is the
// NaN-propagating float order and max is exact in any order.  One chunk
// per trial writes the outputs directly; several merge with atomicMax
// into an output that the entry point zeroes first with
// cudaMemsetAsync: one kernel launch per call either way, and every
// rerun gives the same bits.  The division is IEEE f32 (never
// --use_fast_math), as in the reference; it is what a thread's time
// goes to (28 divisions a column at R = 8).
//
// ptxas (sm_90a): see build/kernels/majority_vote.log after a build;
// the figures measured on the card are in PERF.md (no spills).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RT = 8;                  // replicas per row tile
constexpr int MAX_R = 96;
constexpr long long MIN_CHUNK = 1024;  // columns per block, at least

__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || v != v) ? v : m;    // NaN-propagating, like jnp.maximum
}

__device__ __forceinline__ float rel(float a, float c) {
  return fabsf(a - c) / (1.0f + fminf(fabsf(a), fabsf(c)));
}

// index of the pair i <= j among the 36 of one tile, row by row
__host__ __device__ constexpr int pidx(int i, int j) {
  return i * RT - i * (i - 1) / 2 + (j - i);
}

__device__ __forceinline__ unsigned bits(float v) {
  return (v != v) ? 0x7fffffffu : (unsigned)__float_as_int(v);
}

// One block: the pairs of row tile ti (rows i0..i0+ni) and row tile tj
// (rows j0..j0+nj) of trial b over columns [lo, hi).  DIAG: ti == tj,
// the pairs i <= j of one tile (36 maxima), else all 64.
template <bool DIAG>
__device__ __forceinline__ void tile_pair(const float* __restrict__ xb, int R,
                                          long long d, long long lo,
                                          long long hi, int i0, int ni,
                                          int j0, int nj, bool direct,
                                          float* __restrict__ outb) {
  constexpr int NP = DIAG ? RT * (RT + 1) / 2 : RT * RT;
  __shared__ unsigned red[WARPS][NP];
  float m[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) m[q] = 0.0f;
  const float* xi = xb + (long long)i0 * d;
  const float* xj = xb + (long long)j0 * d;
  for (long long p = lo + threadIdx.x; p < hi; p += THREADS) {
    float a[RT], c[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) a[r] = r < ni ? xi[(long long)r * d + p] : 0.0f;
    if (!DIAG) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
        c[r] = r < nj ? xj[(long long)r * d + p] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      if (DIAG) {
        m[pidx(i, i)] = max_nan(m[pidx(i, i)], fabsf(a[i] - a[i]));
#pragma unroll
        for (int j = i + 1; j < RT; ++j)
          if (j < ni) m[pidx(i, j)] = max_nan(m[pidx(i, j)], rel(a[i], a[j]));
      } else {
#pragma unroll
        for (int j = 0; j < RT; ++j)
          if (i < ni && j < nj)
            m[i * RT + j] = max_nan(m[i * RT + j], rel(a[i], c[j]));
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const unsigned v = __reduce_max_sync(0xffffffffu, bits(m[q]));
    if (lane == 0) red[warp][q] = v;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < NP; q += THREADS) {
    unsigned v = red[0][q];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v = red[w][q] > v ? red[w][q] : v;
    int i = q / RT, j = q % RT;        // q -> (i, j) of the tile pair
    if (DIAG) {
      i = 0;
      int rem = q;
      while (rem >= RT - i) rem -= RT - i++;
      j = i + rem;
    }
    if (i >= ni || j >= nj) continue;
    const int gi = i0 + i, gj = j0 + j;
    if (direct) {
      outb[gi * R + gj] = __int_as_float((int)v);
      outb[gj * R + gi] = __int_as_float((int)v);
    } else {
      int* o = reinterpret_cast<int*>(outb);
      atomicMax(o + gi * R + gj, (int)v);
      if (gi != gj) atomicMax(o + gj * R + gi, (int)v);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
relmax_kernel(const float* __restrict__ x, int R, long long d, int nchunk,
              long long chunk, float* __restrict__ out) {
  const int b = blockIdx.y;
  const int pair = blockIdx.x / nchunk, ch = blockIdx.x % nchunk;
  const int nt = (R + RT - 1) / RT;
  int ti = 0, rem = pair;              // pair -> (ti, tj), ti <= tj
  while (rem >= nt - ti) rem -= nt - ti++;
  const int tj = ti + rem;
  const long long lo = (long long)ch * chunk;
  const long long hi = lo + chunk < d ? lo + chunk : d;
  const int i0 = ti * RT, j0 = tj * RT;
  const int ni = R - i0 < RT ? R - i0 : RT, nj = R - j0 < RT ? R - j0 : RT;
  const float* xb = x + (long long)b * R * d;
  float* outb = out + (long long)b * R * R;
  if (ti == tj)
    tile_pair<true>(xb, R, d, lo, hi, i0, ni, j0, nj, nchunk == 1, outb);
  else
    tile_pair<false>(xb, R, d, lo, hi, i0, ni, j0, nj, nchunk == 1, outb);
}

}  // namespace

extern "C" {

// out (B, R, R) f32 from x (B, R, d) f32, d > 0, R <= MAX_R, B <= 65535;
// the output needs no fill.  Returns cudaGetLastError() (or the fill's
// error).
int relmax_batched(const float* x, int B, int R, long long d, float* out,
                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int nt = (R + RT - 1) / RT;
  const long long pairs = (long long)nt * (nt + 1) / 2;
  const long long want = (2LL * sm_count() + B * pairs - 1) / (B * pairs);
  long long nchunk = (d + MIN_CHUNK - 1) / MIN_CHUNK;
  if (nchunk > want) nchunk = want;
  if (nchunk < 1) nchunk = 1;
  long long chunk = (d + nchunk - 1) / nchunk;
  chunk = (chunk + 31) / 32 * 32;      // warps start on 128-byte lines
  nchunk = (d + chunk - 1) / chunk;
  if (nchunk > 1) {
    const cudaError_t e =
        cudaMemsetAsync(out, 0, sizeof(float) * B * R * R, s);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)(pairs * nchunk), B);
  relmax_kernel<<<grid, THREADS, 0, s>>>(x, R, d, (int)nchunk, chunk, out);
  return (int)cudaGetLastError();
}

const char* relmax_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int relmax_max_replicas() { return MAX_R; }

}  // extern "C"
