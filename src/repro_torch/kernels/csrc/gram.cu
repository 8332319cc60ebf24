// Gram-plane precompute for Hopper (sm_90a): the per-step CountSketch
// tables SK[t] = CountSketch_k(R) under keys[t], and the products
// G = R R^T and S0 = W0 R^T.
//
// Replaces the TPU kernel src/repro/kernels/gram.py:45
// (_gram_factors_kernel, reached from gram_factors at :93 through the
// pl.pallas_call at :142).
//
// The sketch tables are, for each bucket c < k, one matrix product
//   SK[:, :, c] = S_c R_c^T,  S_c[t, m] = sign(m k + c, keys[t]),
//                             R_c[i, m] = R[i, m k + c],  m < M = ceil(d/k)
// (columns past d are zero, the reference's padding).  At the engine's
// main-path shape (R = 66 x 2^20 f32, T = 120 keys, k = 256) that is 256
// products of (120 x 4096) (4096 x 66).
//
// What bounds it on the H100.  Reading R once and writing SK once is
// 284.9 MB: 0.085 ms at 3.35 TB/s.  On the f32 CUDA cores the 8.3e9
// signed adds take 0.25 ms at 33.5e12 adds/s, so an FMA kernel is bound
// by operations.  On the tensor cores the three bf16 passes below are
// 5.0e10 operations, 0.050 ms at 989e12 a second: the bound is the bytes.
//
// Split precision.  A sign is +-1, exact in bf16.  Each R value x is cut
// into three bf16 pieces, hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid): each difference is exact in f32 (Sterbenz),
// and what is left after two 8-bit pieces has at most 8 significant bits,
// so hi + mid + lo = x exactly (for normal x).  Every product sign x piece
// is then exact, and three bf16 passes give the f32 sum.  One piece would
// leave a per-term error of about 2^-9 |x| (about 0.1 at |SK| ~ 64,
// against the 1e-3 gate); two leave 2^-17 |x|, marginal after 4096
// terms; TF32 hi + lo would take two passes at half the bf16 rate, i.e.
// more tensor time than three bf16 passes.  The tensor cores add with
// truncation, so a long chain of adds into one accumulator drifts toward
// zero: each thread's accumulators take 16 slab steps (256 slabs, 48 adds)
// and are then added into f32 sums in shared memory, rounded to nearest.
//
// The design.  One block of two warpgroups per (group of 4 buckets, 128
// keys, 72 rows, half of the slabs); the two halves of the slabs are the
// two blocks of a cluster, which add their sums through distributed
// shared memory at the end (one f32 add, the same on every run), so one
// launch writes SK and there are no float atomics.  At the main shape
// that is 64 x 2 = 128 blocks, one an SM.  Warpgroup wg owns buckets
// 2 wg and 2 wg + 1, each against two halves of 64 keys: 4 jobs of
// wgmma m64n72k16 (64 keys x all 72 rows), 144 f32 accumulators a
// thread.  Per step of 16 slabs:
//   - R's tile (72 rows x 16 slabs x the 4 buckets, f32) comes through a
//     ring of 3 stages filled by cp.async, one 16-byte copy per (row,
//     slab) (4-byte copies where d, k or R's address are not multiples
//     of 4 floats);
//   - the block cuts the tile into its 3 bf16 pieces once, into a
//     [bucket][piece][row][slab] buffer in wgmma's K-major layout with
//     the 32-byte swizzle, which the tensor cores read directly;
//   - the sign operand A is made in registers from the hash
//     (sign_hash.cuh's function, bit for bit): 8 hashes a thread per
//     job, each used for 72 rows x 3 pieces, never stored;
//   - 12 wgmma a warpgroup (4 jobs x 3 pieces), then one wait.
// Rows past Ie, keys past T and slabs past the span are zero or dropped;
// any Ie, T, d >= 0 and k >= 1 runs (more than 72 rows or 128 keys take
// more blocks).  Reruns give the same bits: every sum has a fixed order.
// What still holds it back (PERF.md, scripts/gram_ablation.py): the
// copies, the split and the products run in turn between barriers with
// two warps a scheduler, so they add up rather than overlap; a second
// pieces buffer would let the split of one step run beside the products
// of the last, but the 147 KB of f32 sums leave no shared memory for it.
//
// G and S0 are not on the engine's path (the engine forms G itself and
// starts from W0 = 0); they run in a separate launch only when asked:
// each block reduces a 16 x 16 output tile over one span of columns in
// f32, and a second kernel (span_sum.cuh) sums the spans in f64 in a
// fixed order (no atomics).
//
// ptxas (sm_90a): see build/kernels/gram.log after a build; the figures
// measured on the card are in PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: the hash compare is exact).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sign_hash.cuh"
#include "span_sum.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int SK_THREADS = 256;              // two warpgroups
constexpr int SK_CB = 4;                       // buckets per block
constexpr int SK_KEYS = 128;                   // keys per block: 2 x m64
constexpr int SK_ROWS = 72;                    // rows per block: wgmma n72
constexpr int SK_SL = 16;                      // slabs per stage (one k16)
constexpr int SK_JOBS = 4;                     // (bucket, 64 keys) a warpgroup
constexpr int SK_DACC = SK_ROWS / 2;           // f32 a thread per job
constexpr int SK_STAGES = 3;
constexpr int SK_FLUSH = 16;                   // stages per accumulator chain
constexpr int SK_ACC = SK_JOBS * SK_DACC;      // accumulators a thread
// a stage of R: [row][slab][bucket] f32, one 16-byte copy per (row, slab)
constexpr int SK_STAGE = SK_ROWS * SK_SL * SK_CB;          // words
// R's pieces: [bucket][piece][row][slab] bf16, 32-byte rows
constexpr int SK_PIECES = SK_CB * 3 * SK_ROWS * SK_SL / 2;  // words
constexpr int SK_MAIN = (SK_THREADS / 32) * SK_ACC * 32;   // f32 sums
constexpr size_t SK_SMEM =
    (size_t)(SK_MAIN + SK_STAGES * SK_STAGE + SK_PIECES) * 4 + 256;
constexpr uint32_t HASH_MUL1 = 2654435761u;

__device__ __forceinline__ void sk_cp16(float* dst, const float* src,
                                        bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void sk_cp4(float* dst, const float* src,
                                       bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void sk_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void sk_wait() {   // SK_STAGES - 2 groups open
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// makes the threads' shared-memory stores visible to wgmma's reads (the
// async proxy); each storing thread runs it before the barrier
__device__ __forceinline__ void sk_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void sk_wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void sk_wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void sk_wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of the accumulators
// and the A registers across the asynchronous wgmma (and from reusing
// the A registers before it is done)
__device__ __forceinline__ void sk_fence_acc(float (&d)[SK_DACC]) {
#pragma unroll
  for (int i = 0; i < SK_DACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void sk_fence_a(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}
// wgmma descriptor of a K-major bf16 operand in the 32-byte swizzle: rows
// of 32 bytes (16 slabs), 8-row groups 256 bytes apart
__device__ __forceinline__ uint64_t sk_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
}
// d (64 keys x 72 rows, the warpgroup's) += A (signs, registers) B (desc)
__device__ __forceinline__ void sk_wgmma(float (&d)[SK_DACC],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// hash_sign's arithmetic up to its last multiply, from pm = pos * MUL1
__device__ __forceinline__ uint32_t sk_mix(uint32_t pm, uint32_t key) {
  uint32_t h = pm + key;
  h ^= h >> 16;
  return h * 2246822519u;
}

// two bf16 signs in one register (lo: the lower column): hash_sign is +1
// where bit 0 of h ^ (h >> 13) is set, i.e. where bit 0 ^ bit 13 of the
// last product is 1, and bf16 +1 / -1 differ only in the sign bit
__device__ __forceinline__ uint32_t sk_signs(uint32_t pm_lo, uint32_t pm_hi,
                                             uint32_t key) {
  const uint32_t a = sk_mix(pm_lo, key), b = sk_mix(pm_hi, key);
  return 0xBF80BF80u ^ (((a << 15) ^ (a << 2)) & 0x8000u) ^
         (((b << 31) ^ (b << 18)) & 0x80000000u);
}

// an f32 pair (lo, hi) cut into three exact bf16x2 pieces
__device__ __forceinline__ void sk_split(float x0, float x1, uint32_t& hi,
                                         uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// byte offset of the 16-byte half `hf` (slabs 8 hf .. 8 hf + 7) of row r
// of a piece: the halves swap every 4 rows, wgmma's 32-byte swizzle of a
// K-major operand (rows of 32 bytes, 8-row groups of 256)
__device__ __forceinline__ int sk_half(int r, int hf) {
  return r * 32 + ((hf ^ ((r >> 2) & 1)) << 4);
}

// grid: (bucket groups, key groups, row blocks x 2 halves of the slabs);
// the two halves of a (bucket group, key group, row block) are a cluster.
// V16: 16-byte copies (d, k and R's address multiples of 4 floats).
template <bool V16>
__global__ void __cluster_dims__(1, 1, 2) __launch_bounds__(SK_THREADS, 1)
sketch_tables_kernel(const float* __restrict__ rows, int Ie, long long d,
                     const uint32_t* __restrict__ keys, int T, int k,
                     float* __restrict__ sk) {
  extern __shared__ __align__(16) float smem[];
  float* sums = smem;                      // [warp][accumulator][lane]
  float* ring = smem + SK_MAIN;            // [stage][row][slab][bucket]
  // the pieces' tiles start 256-aligned (the 32-byte swizzle's period)
  unsigned char* pieces =
      reinterpret_cast<unsigned char*>(ring + SK_STAGES * SK_STAGE);
  pieces += (256 - ((uint32_t)__cvta_generic_to_shared(pieces) & 255)) & 255;
  cg::cluster_group cluster = cg::this_cluster();
  const int half = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wg = w >> 2, wq = w & 3;       // warpgroup, warp in it
  const int c0 = blockIdx.x * SK_CB;
  const int t0 = blockIdx.y * SK_KEYS;
  const int r0 = (blockIdx.z >> 1) * SK_ROWS;

  const long long nslab = (d + k - 1) / k;
  const long long hlen = ((nslab + 1) / 2 + SK_SL - 1) / SK_SL * SK_SL;
  const long long m_lo = half * hlen;
  const long long m_hi = m_lo + hlen < nslab ? m_lo + hlen : nslab;
  const int nstage = m_hi > m_lo ? (int)((m_hi - m_lo + SK_SL - 1) / SK_SL)
                                 : 0;

  // a stage's copies: V16, 16 bytes (4 buckets) of (row, slab) for
  // c = tid + 256 u; else 4 bytes of (row, slab, bucket) for
  // e = tid + 256 u (bucket tid & 3, slab (tid >> 2) & 15, rows
  // tid >> 6 + 4 u).  Both write word (row * 16 + slab) * 4 + bucket.
  auto load = [&](int st) {
    const long long m0 = m_lo + (long long)st * SK_SL;
    float* dst = ring + (st % SK_STAGES) * SK_STAGE;
    if constexpr (V16) {
#pragma unroll
      for (int u = 0; u < (SK_ROWS * SK_SL + SK_THREADS - 1) / SK_THREADS;
           ++u) {
        const int cidx = tid + u * SK_THREADS;
        if (cidx >= SK_ROWS * SK_SL) break;
        const int r = cidx >> 4;
        const long long m = m0 + (cidx & 15);
        const bool ok = r0 + r < Ie && m < m_hi && m * k + c0 < d;
        sk_cp16(dst + cidx * 4,
                ok ? rows + (long long)(r0 + r) * d + m * k + c0 : rows, ok);
      }
    } else {
      const int lb = tid & 3, ls = (tid >> 2) & 15, lr = tid >> 6;
      const long long m = m0 + ls;
      const bool ok = c0 + lb < k && m < m_hi && m * k + c0 + lb < d;
#pragma unroll
      for (int u = 0; u < SK_ROWS / 4; ++u) {
        const bool in = ok && r0 + lr + 4 * u < Ie;
        sk_cp4(dst + tid + u * SK_THREADS,
               in ? rows + (long long)(r0 + lr + 4 * u) * d + m * k + c0 + lb
                  : rows,
               in);
      }
    }
  };

  for (int j = tid; j < SK_MAIN; j += SK_THREADS) sums[j] = 0.0f;
#pragma unroll
  for (int st = 0; st < SK_STAGES - 1; ++st) {
    if (st < nstage) load(st);
    sk_commit();
  }

  // warpgroup wg's jobs j: bucket 2 wg + (j >> 1), key half j & 1, of
  // which warp wq holds keys 16 wq + g and 16 wq + g + 8 (its A rows);
  // past T any key will do, their rows are dropped
  uint32_t key[2][2];
#pragma unroll
  for (int kh = 0; kh < 2; ++kh)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + kh * 64 + wq * 16 + g + 8 * h;
      key[kh][h] = t < T ? keys[t] : 0u;
    }
  // pos * MUL1 (mod 2^32) of the lane's A columns: slabs 2tq, 2tq + 1,
  // 2tq + 8, 2tq + 9 of the step, buckets c0 + 2 wg + (0, 1)
  uint32_t pm[2][4];
#pragma unroll
  for (int bi = 0; bi < 2; ++bi)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t m = (uint32_t)m_lo + 2 * tq + (j & 1) + 8 * (j >> 1);
      pm[bi][j] = (m * (uint32_t)k + (uint32_t)(c0 + 2 * wg + bi)) *
                  HASH_MUL1;
    }
  const uint32_t pm_step = (uint32_t)(SK_SL * k) * HASH_MUL1;

  float acc[SK_JOBS][SK_DACC];
#pragma unroll
  for (int j = 0; j < SK_JOBS; ++j)
#pragma unroll
    for (int e = 0; e < SK_DACC; ++e) acc[j][e] = 0.0f;

  for (int st = 0; st < nstage; ++st) {
    sk_wait();
    __syncthreads();                 // stage st is in; stage st - 1 is done
    if (st + SK_STAGES - 1 < nstage) load(st + SK_STAGES - 1);
    sk_commit();

    // R's pieces: unit (row, slab pair) of the stage, all 4 buckets
    const float* tile = ring + (st % SK_STAGES) * SK_STAGE;
    for (int u = tid; u < SK_ROWS * SK_SL / 2; u += SK_THREADS) {
      const int r = u >> 3, pr = u & 7;
      const float4 x0 = *reinterpret_cast<const float4*>(
          tile + (r * SK_SL + 2 * pr) * 4);
      const float4 x1 = *reinterpret_cast<const float4*>(
          tile + (r * SK_SL + 2 * pr + 1) * 4);
      const float lo4[4] = {x0.x, x0.y, x0.z, x0.w};
      const float hi4[4] = {x1.x, x1.y, x1.z, x1.w};
      const int off = sk_half(r, pr >> 2) + (pr & 3) * 4;
#pragma unroll
      for (int cb = 0; cb < SK_CB; ++cb) {
        uint32_t p3[3];
        sk_split(lo4[cb], hi4[cb], p3[0], p3[1], p3[2]);
#pragma unroll
        for (int pc = 0; pc < 3; ++pc)
          *reinterpret_cast<uint32_t*>(
              pieces + (cb * 3 + pc) * SK_ROWS * 32 + off) = p3[pc];
      }
    }
    sk_proxy_fence();

    uint32_t a[SK_JOBS][4];
#pragma unroll
    for (int j = 0; j < SK_JOBS; ++j) {
      const uint32_t* p = pm[j >> 1];
      a[j][0] = sk_signs(p[0], p[1], key[j & 1][0]);
      a[j][1] = sk_signs(p[0], p[1], key[j & 1][1]);
      a[j][2] = sk_signs(p[2], p[3], key[j & 1][0]);
      a[j][3] = sk_signs(p[2], p[3], key[j & 1][1]);
    }
#pragma unroll
    for (int bi = 0; bi < 2; ++bi)
#pragma unroll
      for (int j = 0; j < 4; ++j) pm[bi][j] += pm_step;
    __syncthreads();                 // the pieces are in

#pragma unroll
    for (int j = 0; j < SK_JOBS; ++j) sk_fence_acc(acc[j]);
    sk_wg_fence();
#pragma unroll
    for (int j = 0; j < SK_JOBS; ++j)
#pragma unroll
      for (int pc = 0; pc < 3; ++pc)
        sk_wgmma(acc[j], a[j],
                 sk_desc(pieces + ((2 * wg + (j >> 1)) * 3 + pc) * SK_ROWS *
                                      32));
    sk_wg_commit();
    sk_wg_wait();
#pragma unroll
    for (int j = 0; j < SK_JOBS; ++j) {
      sk_fence_acc(acc[j]);
      sk_fence_a(a[j]);
    }

    if ((st + 1) % SK_FLUSH == 0 || st + 1 == nstage) {
      float* mine = sums + w * SK_ACC * 32 + lane;
#pragma unroll
      for (int j = 0; j < SK_JOBS; ++j)
#pragma unroll
        for (int e = 0; e < SK_DACC; ++e) {
          mine[(j * SK_DACC + e) * 32] += acc[j][e];
          acc[j][e] = 0.0f;
        }
    }
  }

  // both halves' sums are complete: each block writes half of the tile,
  // adding its own sum and its partner's (the same f32 add either way).
  // Output (bucket eb, key et, row ei) is warp 4 (eb >> 1) + (et & 63) / 16
  // of job (eb & 1, et >> 6), element 4 (ei / 8) + 2 ((et & 15) / 8) +
  // (ei & 1) of lane 4 (et & 7) + (ei & 7) / 2 (wgmma's accumulator layout)
  cluster.sync();
  const float* other = cluster.map_shared_rank(sums, half ^ 1);
  constexpr int TILE = SK_KEYS * SK_ROWS * SK_CB;
  for (int e = half * (TILE / 2) + tid; e < (half + 1) * (TILE / 2);
       e += SK_THREADS) {
    const int eb = e & 3, ei = (e >> 2) % SK_ROWS, et = (e >> 2) / SK_ROWS;
    const int t = t0 + et, i = r0 + ei, cc = c0 + eb;
    if (t >= T || i >= Ie || cc >= k) continue;
    const int rr = et & 15, col = ei & 7;
    const int j = ((eb & 1) << 1) | (et >> 6);
    const int ej = (ei >> 3) * 4 + (rr >> 3) * 2 + (col & 1);
    const int word = (((eb >> 1) * 4 + ((et & 63) >> 4)) * SK_ACC +
                      j * SK_DACC + ej) * 32 + (rr & 7) * 4 + (col >> 1);
    sk[((long long)t * Ie + i) * k + cc] = sums[word] + other[word];
  }
  cluster.sync();   // the partner may still be reading this block's sums
}

template <bool V16>
int launch_sketch_tables(const float* rows, int Ie, long long d,
                         const uint32_t* keys, int T, int k, float* sk,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sketch_tables_kernel<V16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SK_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((k + SK_CB - 1) / SK_CB, (T + SK_KEYS - 1) / SK_KEYS,
            2 * ((Ie + SK_ROWS - 1) / SK_ROWS));
  sketch_tables_kernel<V16><<<grid, SK_THREADS, SK_SMEM, stream>>>(
      rows, Ie, d, keys, T, k, sk);
  return (int)cudaGetLastError();
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

}  // namespace

extern "C" {

// SK (T, Ie, k) f32 from rows (Ie, d) f32 row-major and keys (T,) given
// as the int32 bit-view of the uint32 keys.  Returns cudaGetLastError().
int gram_sketch_tables(const float* rows, int Ie, long long d,
                       const int* keys, int T, int k, float* sk,
                       void* stream) {
  if (T <= 0 || Ie <= 0 || k <= 0) return 0;
  const uint32_t* ukeys = reinterpret_cast<const uint32_t*>(keys);
  cudaStream_t s = (cudaStream_t)stream;
  if (d % 4 == 0 && k % 4 == 0 && ((uintptr_t)rows & 15) == 0)
    return launch_sketch_tables<true>(rows, Ie, d, ukeys, T, k, sk, s);
  return launch_sketch_tables<false>(rows, Ie, d, ukeys, T, k, sk, s);
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
  return launch_span_sum(part, nsplit, (long long)nx * ny, out, s);
}

const char* gram_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
