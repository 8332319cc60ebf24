// Gram-plane precompute for Hopper (sm_90a): the per-step CountSketch
// tables SK[t] = CountSketch_k(R) under keys[t], and the products
// G = R R^T and S0 = W0 R^T.
//
// Replaces the TPU kernel src/repro/kernels/gram.py:45
// (_gram_factors_kernel, reached from gram_factors at :93 through the
// pl.pallas_call at :142).
//
// What bounds it on the H100.  At the engine's main-path shape
// (R = 66 x 2^20 f32, T = 120, k = 256) the sketch tables are
// T*Ie*d = 8.3e9 signed adds.  At the card's 33.5e12 f32 adds/s (half
// of the 67 TFLOP/s FMA rate) that is about 0.25 ms, while reading R
// once (277 MB at 3.35 TB/s) takes about 83 us: the tables are bound by
// operations, not bytes.  The sign of column p under key t is one
// 32-bit hash of (p, t), shared by every row of R.
//
// What the design does about it.  The TPU kernel revisits one
// (T, Ie_p, k) accumulator across a sequential d-grid; CUDA blocks run
// in parallel, so there is no such accumulator and no float atomics.
// Each thread owns outputs SK[t, i, c] for TPT keys and IT rows in
// registers and loops over all d/k slabs itself, so every sum runs in
// one fixed order and is bit-reproducible from run to run.  A block
// stages an (IT x 32) tile of R per slab in shared memory (coalesced
// 128-byte rows), and each thread hashes (t, column) once per slab for
// its TPT keys and applies that sign to all IT rows: the hash is paid
// once per IT rows, not once per row.  Blocks of other key groups
// re-read the same slab while it is still in the 50 MB L2.  Columns
// past d read as zero (the reference's zero padding).
//
// G and S0 are not on the engine's path (the engine forms G on the host
// side in f64-summed chunks and starts from W0 = 0); they run in a
// separate launch only when asked: each block reduces a 16 x 16 output
// tile over one span of columns in f32, and a second kernel sums the
// spans in f64 in a fixed order (no atomics).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: the hash compare is exact).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CW = 32;        // bucket columns per block, one per lane
constexpr int TL = 8;         // key lanes per block (threadIdx.y)
constexpr int TPT = 2;        // keys per thread
constexpr int KB = TL * TPT;  // keys per block
constexpr int IT = 16;        // rows of R per block
constexpr int SPT = 4;        // slabs staged per shared-memory tile

__device__ __forceinline__ float hash_sign(uint32_t pos, uint32_t key) {
  uint32_t h = pos * 2654435761u + key;
  h ^= h >> 16;
  h *= 2246822519u;
  h ^= h >> 13;
  return (h & 1u) ? 1.0f : -1.0f;
}

__global__ void __launch_bounds__(CW * TL)
sketch_tables_kernel(const float* __restrict__ rows, int Ie, long long d,
                     const uint32_t* __restrict__ keys, int T, int k,
                     float* __restrict__ sk) {
  __shared__ float tile[SPT][IT][CW];
  const int lane = threadIdx.x;
  const int tl = threadIdx.y;
  const int c = blockIdx.x * CW + lane;  // bucket column
  const int t0 = blockIdx.y * KB;
  const int i0 = blockIdx.z * IT;

  uint32_t key[TPT];
#pragma unroll
  for (int j = 0; j < TPT; ++j) {
    const int t = t0 + tl + j * TL;
    key[j] = t < T ? keys[t] : 0u;
  }
  float acc[TPT][IT];
#pragma unroll
  for (int j = 0; j < TPT; ++j)
#pragma unroll
    for (int r = 0; r < IT; ++r) acc[j][r] = 0.0f;

  const long long nslab = (d + k - 1) / k;
  for (long long s0 = 0; s0 < nslab; s0 += SPT) {
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const long long p = (s0 + s) * k + c;
      const bool ok = c < k && s0 + s < nslab && p < d;
#pragma unroll
      for (int rr = 0; rr < IT / TL; ++rr) {
        const int r = tl + rr * TL;
        const int i = i0 + r;
        tile[s][r][lane] = (ok && i < Ie) ? rows[(long long)i * d + p] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const uint32_t pos = (uint32_t)((s0 + s) * k + c);
      float sg[TPT];
#pragma unroll
      for (int j = 0; j < TPT; ++j) sg[j] = hash_sign(pos, key[j]);
#pragma unroll
      for (int r = 0; r < IT; ++r) {
        const float v = tile[s][r][lane];
#pragma unroll
        for (int j = 0; j < TPT; ++j) acc[j][r] = fmaf(sg[j], v, acc[j][r]);
      }
    }
    __syncthreads();
  }
  if (c >= k) return;
#pragma unroll
  for (int j = 0; j < TPT; ++j) {
    const int t = t0 + tl + j * TL;
    if (t >= T) continue;
#pragma unroll
    for (int r = 0; r < IT; ++r) {
      const int i = i0 + r;
      if (i < Ie) sk[((long long)t * Ie + i) * k + c] = acc[j][r];
    }
  }
}

constexpr int GT = 16;  // output tile edge of the row-product kernel
constexpr int GK = 32;  // columns staged per step

// part[z, a, b] = sum over columns p of span z of X[a, p] * Y[b, p]
__global__ void __launch_bounds__(GT * GT)
rowdot_partial_kernel(const float* __restrict__ X, int nx,
                      const float* __restrict__ Y, int ny, long long d,
                      long long span, float* __restrict__ part) {
  __shared__ float xs[GT][GK + 1];
  __shared__ float ys[GT][GK + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * GT + tx;
  const int a0 = blockIdx.y * GT, b0 = blockIdx.x * GT;
  const long long lo = (long long)blockIdx.z * span;
  const long long hi = lo + span < d ? lo + span : d;
  float acc = 0.0f;
  for (long long p0 = lo; p0 < hi; p0 += GK) {
    for (int e = tid; e < GT * GK; e += GT * GT) {
      const int r = e / GK, q = e % GK;
      const long long p = p0 + q;
      xs[r][q] = (a0 + r < nx && p < hi) ? X[(long long)(a0 + r) * d + p] : 0.0f;
      ys[r][q] = (b0 + r < ny && p < hi) ? Y[(long long)(b0 + r) * d + p] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < GK; ++q) acc = fmaf(xs[ty][q], ys[tx][q], acc);
    __syncthreads();
  }
  const int a = a0 + ty, b = b0 + tx;
  if (a < nx && b < ny) part[((long long)blockIdx.z * nx + a) * ny + b] = acc;
}

// out[e] = sum_z part[z, e], summed in f64 in the order z = 0, 1, ...
__global__ void reduce_spans_kernel(const float* __restrict__ part,
                                    int nsplit, int n,
                                    float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  double s = 0.0;
  for (int z = 0; z < nsplit; ++z) s += (double)part[(long long)z * n + e];
  out[e] = (float)s;
}

}  // namespace

extern "C" {

// SK (T, Ie, k) f32 from rows (Ie, d) f32 row-major and keys (T,) given
// as the int32 bit-view of the uint32 keys.  Returns cudaGetLastError().
int gram_sketch_tables(const float* rows, int Ie, long long d,
                       const int* keys, int T, int k, float* sk,
                       void* stream) {
  dim3 block(CW, TL);
  dim3 grid((k + CW - 1) / CW, (T + KB - 1) / KB, (Ie + IT - 1) / IT);
  sketch_tables_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      rows, Ie, d, reinterpret_cast<const uint32_t*>(keys), T, k, sk);
  return (int)cudaGetLastError();
}

// out (nx, ny) = X (nx, d) @ Y (ny, d)^T through nsplit column spans;
// part is caller-allocated (nsplit, nx, ny) scratch.
int gram_rowdot(const float* X, int nx, const float* Y, int ny, long long d,
                int nsplit, float* part, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long span = (d + nsplit - 1) / nsplit;
  span = (span + GK - 1) / GK * GK;
  dim3 block(GT, GT);
  dim3 grid((ny + GT - 1) / GT, (nx + GT - 1) / GT, nsplit);
  rowdot_partial_kernel<<<grid, block, 0, s>>>(X, nx, Y, ny, d, span, part);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int n = nx * ny;
  reduce_spans_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, nsplit, n, out);
  return (int)cudaGetLastError();
}

const char* gram_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
