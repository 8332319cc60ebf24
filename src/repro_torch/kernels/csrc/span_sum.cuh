// The fixed-order second pass of a split reduction: kernels that cut a
// long axis into spans write one f32 partial per span, and
// out[e] = sum_z part[z, e] is then summed in f64 in the order
// z = 0, 1, ... (no float atomics, so reruns are bit-reproducible).
#pragma once
#include <cuda_runtime.h>

__global__ void span_sum_kernel(const float* __restrict__ part, int nsplit,
                                long long n, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  double s = 0.0;
  for (int z = 0; z < nsplit; ++z) s += (double)part[(long long)z * n + e];
  out[e] = (float)s;
}

// Launch span_sum_kernel over n outputs; returns cudaGetLastError().
static inline int launch_span_sum(const float* part, int nsplit, long long n,
                                  float* out, cudaStream_t s) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  span_sum_kernel<<<blocks, 256, 0, s>>>(part, nsplit, n, out);
  return (int)cudaGetLastError();
}
