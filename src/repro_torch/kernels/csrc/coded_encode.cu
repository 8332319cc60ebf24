// Batched linear encode for Hopper (sm_90a):
//   out[b, s, p] = sum_{j=0}^{m-1} c[b, s, j] * g[b, j, p]
// (B, n_sym, m) @ (B, m, d) -> (B, n_sym, d), f32, the sum over j taken
// in the fixed order j = 0, 1, ..., m-1.  The single form
// (n_sym, m) @ (m, d) is the same kernel at B = 1.
//
// Replaces the TPU kernels src/repro/kernels/coded_encode.py:51
// (_encode_kernel_batched, reached from coded_encode_batched at :58
// through the pl.pallas_call at :73) and
// src/repro/kernels/coded_encode.py:21 (_encode_kernel, from
// coded_encode at :28 through :37).
//
// What bounds it on the H100.  A skinny product: m and n_sym are small,
// d is large.  On the engine's per-problem path (B = 8 trials, one
// symbol, m = 64 rows, d = 2^20) it reads 2.15 GB of g for 1.07 GFLOP:
// 0.64 ms at 3.35 TB/s against 0.016 ms at 67 TFLOP/s.  Bound by bytes.
// The single form at the reference bench's (4, 4) @ (4, 2e5) moves 6.4
// MB, 0.0019 ms at 3.35 TB/s: there a launch and the wrapper's host
// work cost more than the bytes.
//
// What the design does about it.  Each thread owns 4 adjacent output
// columns p (one 16-byte vector) when every row of g and out starts on a
// 16-byte boundary (d a multiple of 4, aligned pointers), else one
// column (a scalar tail would not rescue a d that is not a multiple of
// 4: row j then starts j * d floats in, so no 4 columns are 16-byte
// aligned in every row): the block's coefficients (SG symbols x m) sit
// in shared memory and are read as broadcasts, g streams through once
// with each warp reading 512 (or 128) contiguous bytes per row, and the
// m loads of a column are independent, so the unrolled loop keeps
// several in flight while the FMAs chain in registers.  SG, the
// symbols per block, is the smallest of 1, 2, 4, 8 that holds n_sym (so
// the single form's 4 symbols fill their accumulators); blocks tile (d,
// B, n_sym / SG).
// Each output is written by one thread with one FMA chain in the order
// j = 0..m-1: no atomics, bit-reproducible, and the vector and scalar
// bodies give the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// VEC = 4: float4 columns (d % 4 == 0, 16-byte-aligned rows); VEC = 1:
// scalar columns
template <int SG, int VEC>
__global__ void __launch_bounds__(THREADS)
encode_kernel(const float* __restrict__ c, const float* __restrict__ g,
              int n_sym, int m, long long d, float* __restrict__ out) {
  extern __shared__ float cs[];        // (SG, m)
  const int b = blockIdx.y;
  const int s0 = blockIdx.z * SG;
  const int ns = n_sym - s0 < SG ? n_sym - s0 : SG;
  for (int e = threadIdx.x; e < SG * m; e += THREADS) {
    const int s = e / m, j = e % m;
    cs[e] = s < ns ? c[((long long)b * n_sym + s0 + s) * m + j] : 0.0f;
  }
  __syncthreads();
  const float* gb = g + (long long)b * m * d;
  const long long nv = d / VEC;        // vectors per row
  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < nv;
       p += (long long)gridDim.x * THREADS) {
    float acc[SG][VEC];
#pragma unroll
    for (int s = 0; s < SG; ++s)
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[s][u] = 0.0f;
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      float v[VEC];
      if constexpr (VEC == 4) {
        const float4 w =
            __ldg(reinterpret_cast<const float4*>(gb + (long long)j * d) + p);
        v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
      } else {
        v[0] = gb[(long long)j * d + p];
      }
#pragma unroll
      for (int s = 0; s < SG; ++s)
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          acc[s][u] = fmaf(cs[s * m + j], v[u], acc[s][u]);
    }
#pragma unroll
    for (int s = 0; s < SG; ++s) {
      if (s >= ns) continue;
      float* row = out + ((long long)b * n_sym + s0 + s) * d;
      if constexpr (VEC == 4)
        reinterpret_cast<float4*>(row)[p] =
            make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
      else
        row[p] = acc[s][0];
    }
  }
}

template <int SG, int VEC>
int launch(const float* c, const float* g, int B, int n_sym, int m,
           long long d, float* out, cudaStream_t s) {
  const size_t smem = (size_t)SG * m * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        encode_kernel<SG, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  long long xb = (d / VEC + THREADS - 1) / THREADS;
  if (xb > 65535) xb = 65535;          // the loop strides over the rest
  if (xb < 1) xb = 1;
  dim3 grid((unsigned)xb, B, (n_sym + SG - 1) / SG);
  encode_kernel<SG, VEC><<<grid, THREADS, smem, s>>>(c, g, n_sym, m, d, out);
  return (int)cudaGetLastError();
}

template <int SG>
int launch_sg(const float* c, const float* g, int B, int n_sym, int m,
              long long d, float* out, cudaStream_t s) {
  const bool vec = d % 4 == 0 && ((uintptr_t)g % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0;
  return vec ? launch<SG, 4>(c, g, B, n_sym, m, d, out, s)
             : launch<SG, 1>(c, g, B, n_sym, m, d, out, s);
}

}  // namespace

extern "C" {

// Largest m the kernel takes (its coefficients must fit shared memory).
int encode_max_m() { return (227 * 1024) / (8 * (int)sizeof(float)); }

// out (B, n_sym, d) f32 from c (B, n_sym, m) f32 and g (B, m, d) f32,
// all row-major.  Returns cudaGetLastError() (or the attribute error).
int coded_encode_batched(const float* c, const float* g, int B, int n_sym,
                         int m, long long d, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_sym == 1) return launch_sg<1>(c, g, B, n_sym, m, d, out, s);
  if (n_sym == 2) return launch_sg<2>(c, g, B, n_sym, m, d, out, s);
  if (n_sym <= 4) return launch_sg<4>(c, g, B, n_sym, m, d, out, s);
  return launch_sg<8>(c, g, B, n_sym, m, d, out, s);
}

const char* encode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
