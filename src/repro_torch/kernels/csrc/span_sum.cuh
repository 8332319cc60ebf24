// The fixed-order second pass of a split reduction: kernels that cut a
// long axis into spans write one f32 partial per span, and
// out[e] = sum_z part[z, e] is then summed in f64 in the order
// z = 0, 1, ... (no float atomics, so reruns are bit-reproducible).  One
// launch can finish two such sums (a kernel with two split outputs).
#pragma once
#include <cuda_runtime.h>

__global__ void span_sum_kernel(const float* __restrict__ p0, int s0,
                                long long n0, float* __restrict__ o0,
                                const float* __restrict__ p1, int s1,
                                long long n1, float* __restrict__ o1) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float* part = p0;
  int nsplit = s0;
  long long n = n0;
  float* out = o0;
  if (e >= n0) {
    e -= n0;
    if (e >= n1) return;
    part = p1;
    nsplit = s1;
    n = n1;
    out = o1;
  }
  double s = 0.0;
  int z = 0;
  for (; z + 32 <= nsplit; z += 32) {  // 32 loads in flight, added in order
    float v[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) v[u] = part[(long long)(z + u) * n + e];
#pragma unroll
    for (int u = 0; u < 32; ++u) s += (double)v[u];
  }
  for (; z < nsplit; ++z) s += (double)part[(long long)z * n + e];
  out[e] = (float)s;
}

// Launch span_sum_kernel over n0 outputs of (p0, s0 splits) and n1 of
// (p1, s1); returns cudaGetLastError().
static inline int launch_span_sum2(const float* p0, int s0, long long n0,
                                   float* o0, const float* p1, int s1,
                                   long long n1, float* o1, cudaStream_t s) {
  const long long n = n0 + n1;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + 127) / 128);
  span_sum_kernel<<<blocks, 128, 0, s>>>(p0, s0, n0, o0, p1, s1, n1, o1);
  return (int)cudaGetLastError();
}

static inline int launch_span_sum(const float* part, int nsplit, long long n,
                                  float* out, cudaStream_t s) {
  return launch_span_sum2(part, nsplit, n, out, nullptr, 0, 0, nullptr, s);
}
