// CountSketch for Hopper (sm_90a):
//   out[b, c] = sum_q sign(q*k + c, key) * g[b, q*k + c]
// for B flat vectors under one shared key (bucket = column % k; columns
// past d count as zero, the reference's zero padding), and the single
// form (d,) -> (k,).
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
// The kernel is bound by bytes.  The single form moves 4 MB at the
// bench's d = 1e6 (1.2 us) and 2 MB at the serving audit's 4 x 128256
// logits: there the launch, the load latency and the cross-block sum
// are the cost, not the bytes.
//
// The batched design.  The TPU kernel revisits one (1, k) accumulator
// across a sequential grid; CUDA blocks run in parallel, so the d axis
// is cut into spans of whole k-column slabs, one block per (span, group
// of RB rows).  Thread c owns bucket c of its RB rows in registers and
// walks the span's slabs in order: each warp reads 128 contiguous bytes
// per row and slab, RB independent loads are in flight per step, and
// the sign of a column is hashed once for RB rows.  Each block writes
// its (RB, k) partial; span_sum.cuh adds the spans in f64 in a fixed
// order.  No float atomics, so the result is the same on every run.
// Partials cost (spans x B x k) floats, under 1% of the input at the
// engine's shapes.
//
// The single design: one launch.  A thread owns 4 neighbouring buckets
// of a slab (16-byte loads; 1 bucket where k is not a multiple of 4 or
// the vector is not 16-byte aligned), one hash per column, and walks its
// block's slabs with 8 loads in flight; the lanes of a block are added
// in a fixed order in shared memory, and each block writes its partial.
// The last block to finish (an integer ticket taken after
// __threadfence(), reset by that block for the next call) adds the
// partials in f64 in a fixed order and writes out.  Blocks: about one an
// SM.  The caller gives each stream its own ticket and partials.
//
// The shard form: a block of a row-major leaf, (rows, cols) of its
// (rows, C_full) view starting at column c0, sketched under the FULL
// leaf's flat index p = r * C_full + c0 + c (bucket p % k, sign
// hash(p)), so the ranks' partial sketches of a leaf split over the
// model axis sum to the whole leaf's sketch (a split on dim 0 is the
// view with one row and c0 the shard's offset).  Thread b owns bucket b;
// each block takes a run of the block's elements in local row-major
// order and, row segment by row segment, walks the global positions of
// its bucket (stride k): the lanes of a warp read consecutive floats.
// The blocks' partials are added by the last block in f64 in a fixed
// order (the single form's ticket), so reruns are bitwise.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: the hash compare is exact).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sign_hash.cuh"
#include "span_sum.cuh"
#include "sm_count.cuh"

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

constexpr int S_THREADS = 256;
constexpr int S_UNROLL = 8;            // loads in flight per thread
constexpr int S_SLABS = 4;             // slabs per lane a block aims at

// One block's partial over slabs [q0, q1) into part[blockIdx.x, 0..kp);
// the last block adds all partials into out.  V columns per thread.
template <int V>
__global__ void __launch_bounds__(S_THREADS)
sketch_single_kernel(const float* __restrict__ g, long long d, int k,
                     long long spb, uint32_t key, float* __restrict__ part,
                     int kp, unsigned* __restrict__ ticket,
                     float* __restrict__ out) {
  __shared__ float red[S_THREADS * 4];
  __shared__ double dsum[S_THREADS * 4];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int U = (k + V - 1) / V;                   // units per slab
  const int per = U < S_THREADS ? U : S_THREADS;   // threads per slab row
  const int L = S_THREADS / per;                   // slab lanes
  const int lane = tid / per, ut = tid % per;
  const long long nslab = (d + k - 1) / k;
  const long long q0 = (long long)blockIdx.x * spb;
  const long long q1 = q0 + spb < nslab ? q0 + spb : nslab;
  float* mine = part + (long long)blockIdx.x * kp;

  if (lane < L) {
    for (int u = ut; u < U; u += per) {
      const int cu = u * V;
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.0f;
      for (long long qb = q0 + lane; qb < q1; qb += (long long)S_UNROLL * L) {
        float x[S_UNROLL][V];
#pragma unroll
        for (int j = 0; j < S_UNROLL; ++j) {
          const long long q = qb + (long long)j * L;
          const long long p = q * k + cu;
          if constexpr (V == 4) {
            if (q < q1 && p + 3 < d) {
              const float4 f = __ldcs(reinterpret_cast<const float4*>(g + p));
              x[j][0] = f.x;
              x[j][1] = f.y;
              x[j][2] = f.z;
              x[j][3] = f.w;
              continue;
            }
          }
#pragma unroll
          for (int v = 0; v < V; ++v)
            x[j][v] = (q < q1 && p + v < d) ? __ldcs(g + p + v) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < S_UNROLL; ++j) {
          const uint32_t p = (uint32_t)((qb + (long long)j * L) * k + cu);
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[v] = fmaf(hash_sign(p + v, key), x[j][v], acc[v]);
        }
      }
      if (L == 1) {
#pragma unroll
        for (int v = 0; v < V; ++v) mine[cu + v] = acc[v];
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) red[lane * U * V + cu + v] = acc[v];
      }
    }
  }
  if (L > 1) {                       // lanes added in order 0, 1, ...
    __syncthreads();
    for (int c = tid; c < k; c += S_THREADS) {
      float s = 0.0f;
      for (int l = 0; l < L; ++l) s += red[l * U * V + c];
      mine[c] = s;
    }
  }
  if (tid < kp - k) mine[k + tid] = 0.0f;   // the quads' padding

  // the last block to finish adds the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) *ticket = 0u;          // every block has taken its ticket
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int nb = gridDim.x;
  const int QN = kp / 4;                           // bucket quads
  const int qper = QN < S_THREADS ? QN : S_THREADS;
  const int S = S_THREADS / qper;                  // block subsets
  const int sub = tid / qper, qt = tid % qper;
  constexpr int BATCH = 16;
  if (sub < S) {
    for (int qd = qt; qd < QN; qd += qper) {
      double s[4] = {0.0, 0.0, 0.0, 0.0};
      for (int b0 = sub; b0 < nb; b0 += BATCH * S) {
        float4 f[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int b = b0 + j * S;
          f[j] = b < nb ? __ldcg(reinterpret_cast<const float4*>(
                              part + (long long)b * kp) + qd)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          s[0] += (double)f[j].x;
          s[1] += (double)f[j].y;
          s[2] += (double)f[j].z;
          s[3] += (double)f[j].w;
        }
      }
      if (S == 1) {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (4 * qd + v < k) out[4 * qd + v] = (float)s[v];
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) dsum[sub * kp + 4 * qd + v] = s[v];
      }
    }
  }
  if (S > 1) {                       // subsets added in order 0, 1, ...
    __syncthreads();
    for (int c = tid; c < k; c += S_THREADS) {
      double s = 0.0;
      for (int q = 0; q < S; ++q) s += dsum[q * kp + c];
      out[c] = (float)s;
    }
  }
}

constexpr int B_THREADS = 256;

// part[blockIdx.x, b] = sum over this block's elements e in [e0, e1) of
// the (rows, cols) block whose global position p has p % k == b of
// sign(p) * g[e]; the last block adds the partials into out.
__global__ void __launch_bounds__(B_THREADS)
sketch_block_kernel(const float* __restrict__ g, long long rows,
                    long long cols, long long cfull, long long c0, int k,
                    long long per_block, uint32_t key,
                    float* __restrict__ part, int kp,
                    unsigned* __restrict__ ticket, float* __restrict__ out) {
  __shared__ bool last;
  const int tid = threadIdx.x;
  const long long n = rows * cols;
  const long long e0 = (long long)blockIdx.x * per_block;
  const long long e1 = e0 + per_block < n ? e0 + per_block : n;
  float* mine = part + (long long)blockIdx.x * kp;
  for (int b = tid; b < k; b += B_THREADS) {
    float acc = 0.0f;
    long long e = e0;
    while (e < e1) {
      const long long r = e / cols, c = e - r * cols;
      const long long len = cols - c < e1 - e ? cols - c : e1 - e;
      const long long gbase = r * cfull + c0;   // global position of col 0
      const long long lo = gbase + c, hi = lo + len;
      long long p = lo + (((long long)b - lo % k) % k + k) % k;
      const float* row = g + r * cols;
      // batches of 8 loads in flight, then their adds in order
      for (; p + 7LL * k < hi; p += 8LL * k) {
        float x[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          x[j] = __ldcs(row + (p + (long long)j * k - gbase));
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc = fmaf(hash_sign((uint32_t)(p + (long long)j * k), key), x[j],
                     acc);
      }
      for (; p < hi; p += k)
        acc = fmaf(hash_sign((uint32_t)p, key), __ldcs(row + (p - gbase)),
                   acc);
      e += len;
    }
    mine[b] = acc;
  }
  for (int b = k + tid; b < kp; b += B_THREADS) mine[b] = 0.0f;

  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) *ticket = 0u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int b = tid; b < k; b += B_THREADS) {
    double s = 0.0;
    for (unsigned q = 0; q < gridDim.x; ++q)
      s += (double)__ldcg(part + (long long)q * kp + b);
    out[b] = (float)s;
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

// The most blocks sketch_single uses: its partials are (blocks, kp) f32
// with kp = k rounded up to a multiple of 4.
int sketch_single_max_blocks() { return 1024; }

// out (k,) f32 from g (d,) f32 under `key`, one launch.  part is
// (sketch_single_max_blocks(), kp) f32 scratch and ticket one unsigned
// int that is 0 before the first call (the kernel leaves it 0); calls
// that may overlap (other streams) need their own part and ticket.
// Returns cudaGetLastError().
int sketch_single(const float* g, long long d, int k, unsigned int key,
                  float* part, unsigned int* ticket, float* out,
                  void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const int kp = (k + 3) / 4 * 4;
  const bool vec = k % 4 == 0 && ((uintptr_t)g & 15) == 0;
  const int U = vec ? k / 4 : k;
  const int L = U < S_THREADS ? S_THREADS / U : 1;
  const long long nslab = (d + k - 1) / k;
  const long long per_block = (long long)L * S_SLABS;
  long long nb = (nslab + per_block - 1) / per_block;
  const long long cap = sm_count() < 1024 ? sm_count() : 1024;
  if (nb > cap) nb = cap;
  if (nb < 1) nb = 1;
  long long spb = (nslab + nb - 1) / nb;
  if (spb < 1) spb = 1;
  nb = nslab > 0 ? (nslab + spb - 1) / spb : 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    sketch_single_kernel<4><<<(unsigned)nb, S_THREADS, 0, s>>>(
        g, d, k, spb, (uint32_t)key, part, kp, ticket, out);
  else
    sketch_single_kernel<1><<<(unsigned)nb, S_THREADS, 0, s>>>(
        g, d, k, spb, (uint32_t)key, part, kp, ticket, out);
  return (int)cudaGetLastError();
}

// out (k,) f32: the sketch of a (rows, cols) block of a row-major leaf
// viewed as (rows, cfull), starting at column c0, under the full leaf's
// flat index (see the header); g is the block, contiguous.  part and
// ticket as sketch_single's (the same workspace serves both forms on
// one stream).  Returns cudaGetLastError().
int sketch_block(const float* g, long long rows, long long cols,
                 long long cfull, long long c0, int k, unsigned int key,
                 float* part, unsigned int* ticket, float* out,
                 void* stream) {
  if (k < 1 || cols < 0 || rows < 0 || c0 < 0 || c0 + cols > cfull)
    return (int)cudaErrorInvalidValue;
  const int kp = (k + 3) / 4 * 4;
  const long long n = rows * cols;
  // about four blocks an SM, each at least 32 buckets' worth of elements
  const long long floor_elems = 32LL * k;
  long long nb = 4LL * sm_count() < 1024 ? 4LL * sm_count() : 1024;
  if (n / floor_elems < nb) nb = n / floor_elems;
  if (nb < 1) nb = 1;
  long long per_block = (n + nb - 1) / nb;
  if (per_block < 1) per_block = 1;
  nb = n > 0 ? (n + per_block - 1) / per_block : 1;
  sketch_block_kernel<<<(unsigned)nb, B_THREADS, 0, (cudaStream_t)stream>>>(
      g, cols > 0 ? rows : 0, cols > 0 ? cols : 1, cfull, c0, k, per_block,
      (uint32_t)key,
      part, kp, ticket, out);
  return (int)cudaGetLastError();
}

const char* sketch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
