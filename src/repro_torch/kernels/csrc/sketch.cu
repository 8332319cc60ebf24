// Batched CountSketch for Hopper (sm_90a):
//   out[b, c] = sum_q sign(q*k + c, key) * g[b, q*k + c]
// for B flat vectors under one shared key (bucket = column % k; columns
// past d count as zero, the reference's zero padding).  The single
// form (d,) -> (k,) is the same kernel at B = 1.
//
// Replaces the TPU kernels src/repro/kernels/sketch.py:77
// (_sketch_kernel_batched, reached from sketch_batched at :99 through
// the pl.pallas_call at :116) and src/repro/kernels/sketch.py:25
// (_sketch_kernel, from sketch at :47 through :63).
//
// What bounds it on the H100.  One signed add per input element, and
// each element is read once: at the unfused plane's shape (66 x 2^20
// f32, once per step) that is 277 MB, 0.083 ms at 3.35 TB/s, against
// 69e6 adds (2 us at 33.5e12 adds/s) and one 32-bit hash per column.
// The kernel is bound by bytes.
//
// What the design does about it.  The TPU kernel revisits one (1, k)
// accumulator across a sequential grid; CUDA blocks run in parallel, so
// the d axis is cut into spans of whole k-column slabs, one block per
// (span, group of RB rows).  Thread c owns bucket c of its RB rows in
// registers and walks the span's slabs in order: each warp reads 128
// contiguous bytes per row and slab, RB independent loads are in flight
// per step, and the sign of a column is hashed once for RB rows.  Each
// block writes its (RB, k) partial; span_sum.cuh adds the spans in f64
// in a fixed order.  No float atomics, so the result is the same on
// every run.  Partials cost (spans x B x k) floats, under 1% of the
// input at the engine's shapes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: the hash compare is exact).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sign_hash.cuh"
#include "span_sum.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RB = 8;                  // rows per block
constexpr int TARGET_BLOCKS = 4 * 132; // about four blocks per SM

// part[s, b, c] = sum over slabs q of span s of sign(q*k + c) * g[b, q*k + c]
__global__ void __launch_bounds__(THREADS)
sketch_partial_kernel(const float* __restrict__ g, int B, long long d, int k,
                      long long nslab, long long sps, uint32_t key,
                      float* __restrict__ part) {
  const int span = blockIdx.x;
  const int r0 = blockIdx.y * RB;
  const int nr = B - r0 < RB ? B - r0 : RB;
  const long long q0 = (long long)span * sps;
  const long long q1 = q0 + sps < nslab ? q0 + sps : nslab;
  for (int c = threadIdx.x; c < k; c += THREADS) {
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
    for (long long q = q0; q < q1; ++q) {
      const long long p = q * k + c;
      if (p >= d) break;               // p grows with q: the rest is padding
      const float sg = hash_sign((uint32_t)p, key);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < nr) acc[r] = fmaf(sg, g[(long long)(r0 + r) * d + p], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < nr) part[((long long)span * B + r0 + r) * k + c] = acc[r];
  }
}

}  // namespace

extern "C" {

// Spans the wrapper must allocate (spans, B, k) partials for.
int sketch_num_spans(int B, long long d, int k) {
  const long long nslab = (d + k - 1) / k;
  if (nslab == 0) return 1;
  const int groups = (B + RB - 1) / RB;
  long long want = (TARGET_BLOCKS + groups - 1) / groups;
  if (want < 1) want = 1;
  if (want > nslab) want = nslab;
  const long long sps = (nslab + want - 1) / want;
  return (int)((nslab + sps - 1) / sps);
}

// out (B, k) f32 from g (B, d) f32 row-major under `key`; part is
// caller-allocated (sketch_num_spans(B, d, k), B, k) scratch.
// Returns cudaGetLastError().
int sketch_batched(const float* g, int B, long long d, int k,
                   unsigned int key, float* part, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long nslab = (d + k - 1) / k;
  const int nspan = sketch_num_spans(B, d, k);
  const long long sps = nslab == 0 ? 1 : (nslab + nspan - 1) / nspan;
  dim3 grid(nspan, (B + RB - 1) / RB);
  sketch_partial_kernel<<<grid, THREADS, 0, s>>>(g, B, d, k, nslab, sps,
                                                 (uint32_t)key, part);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_span_sum(part, nspan, (long long)B * k, out, s);
}

const char* sketch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
