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
// hash(p), p truncated to 32 bits as the reference's uint32 iota), so
// the ranks' partial sketches of a leaf split over the model axis sum
// to the whole leaf's sketch (a split on dim 0 is the view with one row
// and c0 the shard's offset).  It reads the leaf in its own dtype, f32
// or bf16 (widened in registers, exactly), so a bf16 gradient moves 2
// bytes an element and nothing is copied first: at llama3.2-1b's
// embedding shard at model 2 (131,334,144 elements) 263 MB, 0.078 ms at
// 3.35 TB/s (f32: 0.157 ms).  Per element it does one hash (two
// multiplies, a shift and an xor: hash_sign_flip), one xor into the
// sign bit and one add, about 6 integer operations for 2 bytes: the
// H100's integer pipes take that at about 1.5x the byte rate, so the
// kernel stays bound by bytes as long as the loads keep coming.
//
// The shard design.  A thread owns 8 neighbouring buckets (1 where k
// is not a multiple of 8) and walks slabs of k global positions: 16
// bytes a slab (two 16-byte loads for f32, one for bf16) where its 8
// elements lie in the row and the row's vectors are 16-byte aligned,
// masked scalar loads otherwise (a row's ends, a misaligned row).  f32
// and bf16 walk alike, so a bf16 block sums bit for bit as its f32
// cast.  Each batch of loads (128 bytes a thread) is issued before the
// previous batch's hashes and adds, by double-buffering registers;
// where a whole batch lies inside one aligned row (the long rows), one
// test admits it and its loads go out at a fixed stride, without the
// per-slab bounds and alignment tests of the general walk.  A
// block takes whole rows, or a span of whole slabs of one row (the long
// rows of a dim-0 split or an expert shard), two blocks an SM in one
// wave; its lanes (the threads that cover one slab together) stride
// over the block's slabs, or, where rows have fewer slabs than there
// are lanes, each lane takes every L-th row whole.  A row's global
// start, its bucket offset and its slab count are stepped by addition
// from row to row: no 64-bit division after a thread's start.  The
// lanes are added in a fixed order in shared memory and each block
// writes its partial; the last block adds the partials in f64 in a fixed
// order, with the single form's batched tail (sum_partials).  No float
// atomics: reruns are bitwise.
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

// The end of both one-launch forms: the last block to finish (an
// integer ticket taken after __threadfence(), reset by that block for the
// next call) adds the blocks' partials part[0..gridDim.x) (kp floats
// each, kp a multiple of 4) in f64 in a fixed order, 16 quads in flight
// a thread, and writes out (k,).  Blocks of S_THREADS threads.
__device__ __forceinline__ void sum_partials(const float* part, int kp,
                                             int k, unsigned* ticket,
                                             float* out) {
  __shared__ double dsum[S_THREADS * 4];
  __shared__ bool last;
  const int tid = threadIdx.x;
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

// One block's partial over slabs [q0, q1) into part[blockIdx.x, 0..kp);
// the last block adds all partials into out.  V columns per thread.
template <int V>
__global__ void __launch_bounds__(S_THREADS)
sketch_single_kernel(const float* __restrict__ g, long long d, int k,
                     long long spb, uint32_t key, float* __restrict__ part,
                     int kp, unsigned* __restrict__ ticket,
                     float* __restrict__ out) {
  __shared__ float red[S_THREADS * 4];
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

  sum_partials(part, kp, k, ticket, out);
}

constexpr int B_THREADS = 256;
constexpr int B_V = 8;                 // buckets a thread, k a multiple of 8

// the most blocks a one-launch form uses: the rows of its partials
// (sketch_single_max_blocks())
constexpr int MAX_BLOCKS = 1024;
static_assert(B_THREADS == S_THREADS, "the forms share sum_partials");

// What a block of the shard form walks: the (rows, cols) block of the
// leaf's (rows, cfull) view from column c0, bucketed by k, its
// elements f32 (or bf16 when BF16), V neighbouring buckets a thread.
struct BlockArgs {
  const void* g;
  long long rows, cols, cfull, c0;
  int k;
  uint32_t key;
  int A, B;          // cols = A k + B, 0 <= B < k
  int cm;            // cfull % k: the bucket step from a row to the next
  int lm;            // (L cfull) % k: the step over L rows (the ROWS walk)
  int spr, spb;      // spans a row, slabs a span (spr > 1: one row a block)
  long long rpb;     // rows a block (spr == 1)
  int a0;            // (address of g / element size) % (16-byte vector)
  float* part;
  int kp;
  unsigned* ticket;
  float* out;
};

// The raw bits of the V elements a thread loads from one slab: f32 as
// they are, bf16 two to a word.
template <bool BF16, int V>
struct Raw {
  static constexpr int W = BF16 ? (V + 1) / 2 : V;
  uint32_t w[W];
};

// element v of x as f32 bits: a bf16 is the high half of its f32, so
// the widening is exact
template <bool BF16, int V>
__device__ __forceinline__ uint32_t f32_bits(const Raw<BF16, V>& x, int v) {
  if constexpr (BF16) {
    const uint32_t w = x.w[v / 2];
    return (v & 1) ? (w & 0xFFFF0000u) : (w << 16);
  } else {
    return x.w[v];
  }
}

// Where a thread's walk stands: row r with its global start P (the
// position of column 0, r cfull + c0), P % k, the slabs of k it
// touches, and slab j of it; p the global position of the thread's
// first element there, o its index in the block.  Rows are entered by
// addition: no 64-bit division after the start.
struct Walk {
  long long r, P, end, shift;   // shift = r cols - P: index minus position
  long long p, o;
  int m, n, j;
  bool vec;                     // the row's 16-byte vectors are aligned
};

__device__ __forceinline__ int row_slabs(const BlockArgs& a, int m) {
  const int t = m + a.B;
  return a.A + (t > a.k ? 2 : (t > 0 ? 1 : 0));
}

template <int NV>
__device__ __forceinline__ void enter_row(const BlockArgs& a, Walk& w,
                                          int uv) {
  w.end = w.P + a.cols;
  w.n = row_slabs(a, w.m);
  w.vec = ((w.shift + a.a0) & (NV - 1)) == 0;
  w.p = w.P - w.m + (long long)w.j * a.k + uv;
  w.o = w.p + w.shift;
}

// the slab's V elements of this thread into x (zero past the row's
// ends): 16-byte loads (two for f32) where they lie whole in the row and
// the row's vectors are aligned
template <bool BF16, int V>
__device__ __forceinline__ void load_slab(const BlockArgs& a, const Walk& w,
                                          Raw<BF16, V>& x) {
  constexpr int E = BF16 ? 2 : 4;
  if constexpr (V == B_V) {
    if (w.vec && w.p >= w.P && w.p + V <= w.end) {
      const uint4* q = reinterpret_cast<const uint4*>(
          static_cast<const char*>(a.g) + w.o * E);
#pragma unroll
      for (int h = 0; h < V * E / 16; ++h) {
        const uint4 f = __ldcs(q + h);
        x.w[4 * h] = f.x;
        x.w[4 * h + 1] = f.y;
        x.w[4 * h + 2] = f.z;
        x.w[4 * h + 3] = f.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < Raw<BF16, V>::W; ++i) x.w[i] = 0u;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const long long q = w.p + v;
    if (q >= w.P && q < w.end) {
      if constexpr (BF16)
        x.w[v / 2] |= (uint32_t)__ldcs(
            reinterpret_cast<const unsigned short*>(a.g) + w.o + v)
            << (16 * (v & 1));
      else
        x.w[v] = __ldcs(reinterpret_cast<const unsigned int*>(a.g) + w.o + v);
    }
  }
}

// acc[v] += sign(pos + v) * x[v], the sign as the f32's sign bit
template <bool BF16, int V>
__device__ __forceinline__ void add_slab(float (&acc)[V],
                                         const Raw<BF16, V>& x, uint32_t pos,
                                         uint32_t key) {
#pragma unroll
  for (int v = 0; v < V; ++v)
    acc[v] += __uint_as_float(f32_bits<BF16, V>(x, v) ^
                              hash_sign_flip(pos + v, key));
}

// part[blockIdx.x, b] = sum over the block's elements whose global
// position p has p % k == b of sign(p) * g[e]; the last block adds the
// partials into out.  ROWS: each lane walks whole rows (every L-th of
// the block's), slab by slab; else the lanes take every L-th slab of the
// block's run of slabs (whole rows, or a span of one row when spr > 1).
// Each batch's loads (128 bytes a thread) are issued before the
// previous batch's hashes and adds (register double buffering).  f32
// and bf16 walk alike, so a bf16 block sums as its f32 cast, bit for
// bit.
template <bool BF16, int V, bool ROWS>
__global__ void __launch_bounds__(B_THREADS, 2)
sketch_block_kernel(const BlockArgs a) {
  constexpr int E = BF16 ? 2 : 4;                  // bytes an element
  constexpr int NV = 16 / E;                       // elements a 16-byte load
  constexpr int BATCH = V == 1 ? 16 : 128 / (V * E);
  __shared__ float red[B_THREADS * B_V];
  const int tid = threadIdx.x;
  const int k = a.k;
  const int U = k / V;                             // units per slab
  const int per = U < B_THREADS ? U : B_THREADS;   // threads per slab
  const int L = B_THREADS / per;                   // lanes
  const int lane = tid / per, ut = tid % per;
  long long r0, r1;
  int j0, j1;
  if (a.spr > 1) {
    r0 = blockIdx.x / a.spr;
    r1 = r0 + 1;
    j0 = (int)(blockIdx.x % a.spr) * a.spb;
    j1 = j0 + a.spb;
  } else {
    r0 = (long long)blockIdx.x * a.rpb;
    r1 = r0 + a.rpb < a.rows ? r0 + a.rpb : a.rows;
    j0 = 0;
    j1 = 0x7FFFFFFF;
  }
  const long long dshift = a.cols - a.cfull;       // shift from a row to the next
  const long long lk = (long long)L * k;
  float* mine = a.part + (long long)blockIdx.x * a.kp;

  if (lane < L) {
    for (int u = ut; u < U; u += per) {
      const int uv = u * V;
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.0f;
      Walk w;
      w.r = ROWS ? r0 + lane : r0;
      w.j = ROWS ? 0 : j0 + lane;
      w.P = w.r * a.cfull + a.c0;
      w.m = (int)(w.P % k);
      w.shift = w.r * a.cols - w.P;
      w.n = row_slabs(a, w.m);
      if (!ROWS) {                   // lanes past the first row's end
        while (w.j >= w.n && w.r < r1) {
          w.j -= w.n;
          ++w.r;
          w.P += a.cfull;
          w.shift += dshift;
          w.m += a.cm;
          if (w.m >= k) w.m -= k;
          w.n = row_slabs(a, w.m);
        }
      }
      enter_row<NV>(a, w, uv);
      // the next slab of this thread's walk
      // the walk `count` slabs on (ROWS: one)
      auto step = [&](int count) {
        if (ROWS) {
          ++w.j;
          w.p += k;
          w.o += k;
          if (w.j >= w.n) {
            w.j = 0;
            w.r += L;
            w.P += (long long)L * a.cfull;
            w.shift += (long long)L * dshift;
            w.m += a.lm;
            if (w.m >= k) w.m -= k;
            enter_row<NV>(a, w, uv);
          }
        } else {
          w.j += count * L;
          w.p += count * lk;
          w.o += count * lk;
          if (w.j >= w.n) {
            do {
              w.j -= w.n;
              ++w.r;
              w.P += a.cfull;
              w.shift += dshift;
              w.m += a.cm;
              if (w.m >= k) w.m -= k;
              w.n = row_slabs(a, w.m);
            } while (w.j >= w.n && w.r < r1);
            enter_row<NV>(a, w, uv);
          }
        }
      };
      auto load_batch = [&](Raw<BF16, V> (&x)[BATCH],
                            uint32_t (&pos)[BATCH]) {
        if constexpr (!ROWS && V == B_V) {
          // the whole batch inside one aligned row: one test, then
          // BATCH loads at a fixed stride
          const int last = w.j + (BATCH - 1) * L;
          if (w.vec && w.r < r1 && last < w.n && last < j1 &&
              w.p >= w.P && w.p + (BATCH - 1) * lk + V <= w.end) {
            const uint4* q = reinterpret_cast<const uint4*>(
                static_cast<const char*>(a.g) + w.o * E);
            const long long stride = lk * E / 16;   // in 16-byte vectors
#pragma unroll
            for (int i = 0; i < BATCH; ++i) {
#pragma unroll
              for (int h = 0; h < V * E / 16; ++h) {
                const uint4 f = __ldcs(q + i * stride + h);
                x[i].w[4 * h] = f.x;
                x[i].w[4 * h + 1] = f.y;
                x[i].w[4 * h + 2] = f.z;
                x[i].w[4 * h + 3] = f.w;
              }
              pos[i] = (uint32_t)w.p + (uint32_t)(i * lk);
            }
            step(BATCH);
            return;
          }
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          if (w.r < r1 && w.j < j1) {
            load_slab<BF16, V>(a, w, x[i]);
            pos[i] = (uint32_t)w.p;  // the reference's uint32 index
            step(1);
          } else {
#pragma unroll
            for (int t = 0; t < Raw<BF16, V>::W; ++t) x[i].w[t] = 0u;
            pos[i] = 0u;
          }
        }
      };
      auto add_batch = [&](const Raw<BF16, V> (&x)[BATCH],
                           const uint32_t (&pos)[BATCH]) {
#pragma unroll
        for (int i = 0; i < BATCH; ++i)
          add_slab<BF16, V>(acc, x[i], pos[i], a.key);
      };
      Raw<BF16, V> xa[BATCH], xb[BATCH];
      uint32_t pa[BATCH], pb[BATCH];
      load_batch(xa, pa);
      for (;;) {
        if (!(w.r < r1 && w.j < j1)) {
          add_batch(xa, pa);
          break;
        }
        load_batch(xb, pb);
        add_batch(xa, pa);
        if (!(w.r < r1 && w.j < j1)) {
          add_batch(xb, pb);
          break;
        }
        load_batch(xa, pa);
        add_batch(xb, pb);
      }
      if (L == 1) {
#pragma unroll
        for (int v = 0; v < V; ++v) mine[uv + v] = acc[v];
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) red[lane * k + uv + v] = acc[v];
      }
    }
  }
  if (L > 1) {                       // lanes added in order 0, 1, ...
    __syncthreads();
    for (int c = tid; c < k; c += B_THREADS) {
      float s = 0.0f;
      for (int l = 0; l < L; ++l) s += red[l * k + c];
      mine[c] = s;
    }
  }
  if (tid < a.kp - k) mine[k + tid] = 0.0f;   // the quads' padding
  sum_partials(a.part, a.kp, k, a.ticket, a.out);
}

// Plan and launch one shard-form call (see sketch_block below).
template <bool BF16, int V, bool ROWS>
static int launch_block(BlockArgs a, cudaStream_t s) {
  // one wave: two blocks an SM (__launch_bounds__ holds each to half the
  // register file), the same plan for f32 and bf16
  long long want = 2LL * sm_count();
  if (want > MAX_BLOCKS) want = MAX_BLOCKS;
  const long long nmax = a.A + 2;    // slabs a row touches, at most
  long long nb;
  a.spr = 1;
  a.spb = 0;
  a.rpb = 1;
  if (!ROWS && a.rows > 0 && a.rows < want && want / a.rows > 1) {
    long long spr = want / a.rows;
    const long long spb = (nmax + spr - 1) / spr;
    spr = (nmax + spb - 1) / spb;
    a.spr = (int)spr;
    a.spb = (int)spb;
    nb = a.rows * spr;
  } else {
    a.rpb = a.rows > want ? (a.rows + want - 1) / want : 1;
    nb = a.rows > 0 ? (a.rows + a.rpb - 1) / a.rpb : 1;
  }
  sketch_block_kernel<BF16, V, ROWS><<<(unsigned)nb, B_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool BF16>
static int sketch_block_any(const void* g, long long rows, long long cols,
                            long long cfull, long long c0, int k,
                            unsigned int key, float* part,
                            unsigned int* ticket, float* out, void* stream) {
  constexpr int E = BF16 ? 2 : 4;
  if (k < 1 || cols < 0 || rows < 0 || c0 < 0 || c0 + cols > cfull ||
      cols / k + 2 > 0x7FFFFFFF || ((uintptr_t)g % E) != 0)
    return (int)cudaErrorInvalidValue;
  BlockArgs a;
  a.g = g;
  a.rows = cols > 0 ? rows : 0;      // an empty block: one block, zeros
  a.cols = cols;
  a.cfull = cfull;
  a.c0 = c0;
  a.k = k;
  a.key = (uint32_t)key;
  a.A = (int)(cols / k);
  a.B = (int)(cols % k);
  a.cm = (int)(cfull % k);
  a.part = part;
  a.kp = (k + 3) / 4 * 4;
  a.ticket = ticket;
  a.out = out;
  const bool vec = k % B_V == 0;
  const int V = vec ? B_V : 1;
  const int U = k / V;
  const int L = U < B_THREADS ? B_THREADS / U : 1;
  a.lm = (int)(((long long)L * (cfull % k)) % k);
  a.a0 = (int)(((uintptr_t)g / E) % (16 / E));
  // a lane strides L slabs: through the block's run of slabs where a
  // row has at least L of them, else row by row
  const bool rows_walk = a.A < L;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    return rows_walk ? launch_block<BF16, B_V, true>(a, s)
                     : launch_block<BF16, B_V, false>(a, s);
  return rows_walk ? launch_block<BF16, 1, true>(a, s)
                   : launch_block<BF16, 1, false>(a, s);
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
int sketch_single_max_blocks() { return MAX_BLOCKS; }

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
// flat index (see the header); g is the block, contiguous, f32.  part and
// ticket are sketch_single's (the same workspace serves both forms on one
// stream).  Returns cudaGetLastError().
int sketch_block(const float* g, long long rows, long long cols,
                 long long cfull, long long c0, int k, unsigned int key,
                 float* part, unsigned int* ticket, float* out,
                 void* stream) {
  return sketch_block_any<false>(g, rows, cols, cfull, c0, k, key, part,
                                 ticket, out, stream);
}

// The same on a bf16 block (g: its raw 16-bit values), each value
// widened to f32 in registers: the sketch of the block's f32 cast.
int sketch_block_bf16(const void* g, long long rows, long long cols,
                      long long cfull, long long c0, int k, unsigned int key,
                      float* part, unsigned int* ticket, float* out,
                      void* stream) {
  return sketch_block_any<true>(g, rows, cols, cfull, c0, k, key, part,
                                ticket, out, stream);
}

const char* sketch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
