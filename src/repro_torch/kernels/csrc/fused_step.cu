// The fused protocol step for Hopper (sm_90a), one pass over d:
//   W'    = W - cw @ rows          (B, d), written over W
//   resid = W' @ rows^T            (B, Ie)
//   sk    = CountSketch_k(rows)    (Ie, k) under the step's key
// with rows (Ie, d) stored f32 or bf16 (widened on the card, exactly);
// every product and sum is an f32 FMA on the CUDA cores (no TF32, no
// tensor cores).
//
// Replaces the TPU kernel src/repro/kernels/fused_step.py:50
// (_fused_step_kernel, reached from fused_step at :93 through the
// pl.pallas_call at :128).
//
// What bounds it on the H100.  At the fused_sweep chunk (B = 64 trials,
// Ie = 66 extended rows, d = 2^20) one call moves 0.81 GB (rows once,
// W read and written once): 0.24 ms at 3.35 TB/s.  The two products are
// 2 * 2*B*Ie*d = 17.7 GFLOP of f32 FMA: 0.27 ms at 67 TFLOP/s.  Bound by
// operations, by a small margin over bytes, so the kernel has to keep
// the FMA pipes busy while it streams at nearly the memory's rate.
//
// What the design does about it.  d is cut into spans of whole k-column
// slabs, one block of 128 threads per (span, group of 64 trials), two
// blocks per SM (so that one block's loads, barriers and epilogues
// overlap the other's FMAs).  A block walks its span in tiles of TC = 64
// columns (32 when k is not a multiple of 64), bucket group by bucket
// group, so a tile's columns are one group of TC buckets.  Tiles go
// through a ring of stages in shared memory (two per block at the main
// shape) filled by cp.async (16-byte copies where rows are 16-byte
// aligned, else 4-byte copies that zero-fill past the edge; bf16 rows at
// a ragged d are copied by the threads, and bf16 tiles are widened to
// f32 once in shared memory): while tile j is computed, tile j + 1's
// copies are in flight.  Per tile:
//   (a) W' = W - cw @ rows: each thread owns 8 trials x 4 columns (4 x 4
//       at TC = 32) of W, one FMA chain over the rows per element, cw and
//       the rows read as float4 broadcasts (32 FMAs per 3 shared loads),
//       8 rows in flight; W' goes back to device memory in place, with
//       streaming stores (each W element is read and written by the one
//       thread that owns it, as the reference aliases W), and into the
//       tile's W stage for (b);
//   (b) resid: each thread owns 8 trials x 9 rows of the span's resid
//       partial in registers for the whole span (288 FMAs per 17 float4
//       loads, back-to-back FMAs on different accumulators), over half
//       the tile's columns; Ie is padded to the 72 rows of a row block,
//       and the two column halves are added in a fixed order once, at
//       the end of the span;
//   (c) the sketch: the exact hash sign, bucket = column mod k, each
//       thread adding one column of the signed rows into its buckets'
//       partials in shared memory (loads of a batch before its stores),
//       written out once per bucket group.
// More than 72 rows: a first pass over the span does (a) alone, row
// block by row block (cw staged with each), then one pass per row block
// does (b) and (c) on the W' it wrote.  The span partials of resid and
// sk go to device memory and span_sum.cuh adds them in f64 in a fixed
// order, both in one launch: no float atomics, so every output is the
// same on every run.  A zero cw row leaves its W row bitwise unchanged
// (W - 0).  Partials cost (spans x (B + k) x Ie) floats, 2.7% of the
// call's bytes here.  What still holds it back is in PERF.md (the FMA
// phases run at about 70% of the issue rate, and the loads, stores and
// sketch add to them rather than hide behind them).
//
// ptxas (sm_90a): see build/kernels/fused_step.log after a build; the
// figures measured on the card are in PERF.md (no spills).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: the hash compare is exact).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sign_hash.cuh"
#include "span_sum.cuh"
#include "sm_count.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BLOCKS_PER_SM = 2;
constexpr int WARPS = THREADS / 32;
constexpr int BG = 64;                 // trials per block
constexpr int NTB = 8;                 // (b): trials per thread
constexpr int TGB = BG / NTB;          // (b): trial groups (lanes)
constexpr int NR = 9;                  // (b): rows per thread
constexpr int IC = 8 * NR;             // rows per row block
constexpr int KS = WARPS * 4 / TGB;    // (b): column splits
constexpr int MAX_STAGES = 4;
constexpr size_t SMEM_MAX = 227 * 1024;
// the shared memory that lets BLOCKS_PER_SM blocks share an SM (228 KB
// an SM, 1 KB of it reserved per block)
constexpr size_t SMEM_FIT = 228 * 1024 / BLOCKS_PER_SM - 1024;

enum Pass { PASS_AB = 0, PASS_A = 1, PASS_B = 2 };

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` (0..2) of the newest copy groups are open
__device__ __forceinline__ void cp_wait(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// Shared memory of one instantiation, in bytes.  A stage holds a row
// block's tile (IC x RS elements of RowT), the W tile (BG x WS f32) and,
// in the (a)-only pass, the row block's cw (IC x BG f32); behind the
// ring come the f32 rows tile (bf16 rows only), the resident cw (one row
// block) and the sketch partials (IC x TC).
template <typename RowT, int TC>
struct Geo {
  static constexpr bool BF16 = sizeof(RowT) == 2;
  static constexpr int VEC = 16 / (int)sizeof(RowT);   // elements per copy
  static constexpr int RS = TC + VEC;                  // staged row stride
  static constexpr int RS32 = TC + 4;                  // f32 row stride
  static constexpr int WS = TC + 4;                    // W row stride
  static constexpr size_t ROWS_B = (size_t)IC * RS * sizeof(RowT);
  static constexpr size_t W_B = (size_t)BG * WS * 4;
  static constexpr size_t CW_B = (size_t)IC * BG * 4;
  static constexpr size_t SCR_B = (size_t)KS * BG * IC * 4;
  static constexpr size_t R32_B = BF16 ? (size_t)IC * RS32 * 4 : 0;
  static constexpr size_t SKS_B = (size_t)IC * TC * 4;

  __host__ __device__ static size_t stage_b(int nc) {
    return ROWS_B + W_B + (nc > 1 ? CW_B : 0);
  }
  __host__ __device__ static size_t ring_b(int nc, int stages) {
    const size_t r = stages * stage_b(nc);
    return r > SCR_B ? r : SCR_B;
  }
  __host__ __device__ static size_t total_b(int nc, int stages) {
    return ring_b(nc, stages) + R32_B + (nc == 1 ? CW_B : 0) + SKS_B;
  }
};

// Spans for a call: BLOCKS_PER_SM blocks per SM over the (span, trial
// group) grid.
void plan_spans(int B, long long d, int k, int* nspan, long long* sps) {
  const long long nslab = (d + k - 1) / k;
  const int groups = B > 0 ? (B + BG - 1) / BG : 1;
  long long want = ((long long)BLOCKS_PER_SM * sm_count() + groups - 1) /
                   groups;
  if (want > nslab) want = nslab;
  if (want < 1) want = 1;
  const long long per = nslab == 0 ? 1 : (nslab + want - 1) / want;
  *sps = per;
  *nspan = nslab == 0 ? 1 : (int)((nslab + per - 1) / per);
}

template <typename RowT, int TC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
fused_step_kernel(const RowT* __restrict__ rows, int Ie, long long d,
                  float* W, const float* __restrict__ cw, int B, int k,
                  long long nslab, long long sps, uint32_t key, int nc,
                  int stages, int vec_rows, int vec_w,
                  float* __restrict__ part_r, float* __restrict__ part_sk) {
  using G = Geo<RowT, TC>;
  constexpr int CG = TC / 4;           // (a): column groups of 4
  constexpr int CGW = CG / 8;          //      warps across the columns
  constexpr int TBA = BG * CG / THREADS;   // (a): trials per thread
  constexpr int SSTEP = THREADS / TC;  // (c): rows between a thread's
  constexpr int SN = IC / SSTEP;       //      sketch elements, and their count
  constexpr int SB = 9;                // (c): elements per batch
  static_assert(TBA % 4 == 0 && IC % SSTEP == 0 && SN % SB == 0,
                "tile shapes");
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t stage_b = G::stage_b(nc);
  unsigned char* ring = smem;
  float* rows32 = reinterpret_cast<float*>(smem + G::ring_b(nc, stages));
  float* cwres = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(
      rows32) + G::R32_B);
  float* sks = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(
      cwres) + (nc == 1 ? G::CW_B : 0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = blockIdx.x;
  const int b0 = blockIdx.y * BG;
  const int nb = B - b0 < BG ? B - b0 : BG;
  const bool do_sk = blockIdx.y == 0;
  const long long q0 = (long long)span * sps;
  const long long q1 = q0 + sps < nslab ? q0 + sps : nslab;
  const int nsl = (int)(q1 - q0);
  const int ntile = (k / TC) * nsl;

  // (a) roles: 4 trial groups x 8 column groups per warp
  const int cg = (lane & 7) + 8 * (warp % CGW);
  const int tga = (lane >> 3) + 4 * (warp / CGW);
  // (b) roles: trials tg + TGB j, rows rg + 8r, column split ks
  const int ks = warp % KS, tg = lane % TGB;
  const int rg = lane / TGB + (32 / TGB) * (warp / KS);
  // (c) roles: column sc, rows si0 + SSTEP n
  const int sc = tid % TC, si0 = tid / TC;
  // tile copies: rows vi + VSTEP m at vector column vc; W trials
  // wi + WSTEP m at 4-float column wc
  constexpr int VPR = TC / G::VEC, VSTEP = THREADS / VPR;
  constexpr int WSTEP = THREADS / CG;
  const int vc = tid % VPR, vi = tid / VPR;
  const int wc = tid % CG, wi = tid / CG;
  static_assert(THREADS % VPR == 0 && THREADS % CG == 0 && BG % WSTEP == 0,
                "copy layout");

  if (nc == 1) {
    for (int e = tid; e < IC * BG; e += THREADS) {
      const int i = e / BG, b = e % BG;
      cwres[e] = (b < nb && i < Ie) ? cw[(long long)(b0 + b) * Ie + i] : 0.0f;
    }
  }
  for (int e = tid; e < IC * TC; e += THREADS) sks[e] = 0.0f;
  __syncthreads();

  // the tile and row block of item n of a pass
  auto item = [&](int kind, int chB, int n, long long* col0, int* ch) {
    const int t = kind == PASS_A ? n / nc : n;
    *ch = kind == PASS_A ? n % nc : chB;
    *col0 = (q0 + t % nsl) * k + (long long)(t / nsl) * TC;
  };

  auto issue = [&](int kind, int chB, int n, int slot) {
    long long col0;
    int ch;
    item(kind, chB, n, &col0, &ch);
    unsigned char* st = ring + slot * stage_b;
    RowT* rs = reinterpret_cast<RowT*>(st);
    float* ws = reinterpret_cast<float*>(st + G::ROWS_B);
    float* cs = reinterpret_cast<float*>(st + G::ROWS_B + G::W_B);
    const long long r0 = (long long)ch * IC;
    if (vec_rows) {
      // thread: vector column vc of rows vi, vi + VSTEP, ... (addresses
      // stepped, not recomputed)
      const long long col = col0 + (long long)vc * G::VEC;
      const RowT* src = rows + (r0 + vi) * d + col;
      RowT* dst = rs + vi * G::RS + vc * G::VEC;
#pragma unroll
      for (int m = 0; m < (IC + VSTEP - 1) / VSTEP; ++m) {
        const int i = vi + m * VSTEP;
        const bool ok = i < IC && r0 + i < Ie && col < d;
        if (i < IC) cp16(dst, ok ? src : rows, ok);
        src += (long long)VSTEP * d;
        dst += VSTEP * G::RS;
      }
    } else {
      for (int e = tid; e < IC * TC; e += THREADS) {
        const int i = e / TC, c = e % TC;
        const long long col = col0 + c;
        const bool ok = r0 + i < Ie && col < d;
        if constexpr (G::BF16)
          rs[i * G::RS + c] = ok ? rows[(r0 + i) * d + col] : __float2bfloat16(0.0f);
        else
          cp4(rs + i * G::RS + c, ok ? rows + (r0 + i) * d + col : rows, ok);
      }
    }
    if (kind != PASS_A || ch == nc - 1) {
      if (vec_w) {
        const long long col = col0 + 4LL * wc;
        const float* src = W + (long long)(b0 + wi) * d + col;
        float* dst = ws + wi * G::WS + 4 * wc;
#pragma unroll
        for (int m = 0; m < BG / WSTEP; ++m) {
          const bool ok = wi + m * WSTEP < nb && col < d;
          cp16(dst, ok ? src : W, ok);
          src += (long long)WSTEP * d;
          dst += WSTEP * G::WS;
        }
      } else {
        for (int e = tid; e < BG * TC; e += THREADS) {
          const int b = e / TC, c = e % TC;
          const long long col = col0 + c;
          const bool ok = b < nb && col < d;
          cp4(ws + b * G::WS + c, ok ? W + (long long)(b0 + b) * d + col : W,
              ok);
        }
      }
    }
    if (kind == PASS_A) {
      for (int e = tid; e < IC * BG; e += THREADS) {
        const int i = e / BG, b = e % BG;
        const bool ok = b < nb && r0 + i < Ie;
        cp4(cs + e, ok ? cw + (long long)(b0 + b) * Ie + r0 + i : cw, ok);
      }
    }
  };

  const int npass = nc == 1 ? 1 : nc + 1;
  for (int pass = 0; pass < npass; ++pass) {
    const int kind = nc == 1 ? PASS_AB : (pass == 0 ? PASS_A : PASS_B);
    const int chB = nc == 1 ? 0 : pass - 1;
    const int nitems = kind == PASS_A ? ntile * nc : ntile;
    float acc[NTB][NR];
#pragma unroll
    for (int j = 0; j < NTB; ++j)
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[j][r] = 0.0f;
    float u[TBA][4];

    for (int s = 0; s < stages - 1; ++s) {
      if (s < nitems) issue(kind, chB, s, s);
      cp_commit();
    }
    for (int n = 0; n < nitems; ++n) {
      cp_wait(stages - 2);
      __syncthreads();
      {
        const int m = n + stages - 1;
        if (m < nitems) issue(kind, chB, m, m % stages);
        cp_commit();
      }
      long long col0;
      int ch;
      item(kind, chB, n, &col0, &ch);
      unsigned char* st = ring + (n % stages) * stage_b;
      float* ws = reinterpret_cast<float*>(st + G::ROWS_B);
      const float* R32;
      if constexpr (G::BF16) {
        const __nv_bfloat16* rs = reinterpret_cast<const __nv_bfloat16*>(st);
        for (int v = tid; v < IC * (TC / 8); v += THREADS) {
          const int i = v / (TC / 8), cv = v % (TC / 8);
          const uint4 raw =
              *reinterpret_cast<const uint4*>(rs + i * G::RS + 8 * cv);
          float4* dst = reinterpret_cast<float4*>(rows32 + i * G::RS32 + 8 * cv);
          dst[0] = make_float4(__uint_as_float(raw.x << 16),
                               __uint_as_float(raw.x & 0xffff0000u),
                               __uint_as_float(raw.y << 16),
                               __uint_as_float(raw.y & 0xffff0000u));
          dst[1] = make_float4(__uint_as_float(raw.z << 16),
                               __uint_as_float(raw.z & 0xffff0000u),
                               __uint_as_float(raw.w << 16),
                               __uint_as_float(raw.w & 0xffff0000u));
        }
        __syncthreads();
        R32 = rows32;
      } else {
        R32 = reinterpret_cast<const float*>(st);
      }
      const int nrow = Ie - ch * IC < IC ? Ie - ch * IC : IC;

      if (kind != PASS_B) {
        // (a) u += cw[:, block rows] @ rows tile, W' at the last row block
        const float* cwb = nc == 1
            ? cwres
            : reinterpret_cast<const float*>(st + G::ROWS_B + G::W_B);
        if (ch == 0) {
#pragma unroll
          for (int j = 0; j < TBA; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) u[j][c] = 0.0f;
        }
#pragma unroll 8
        for (int i = 0; i < nrow; ++i) {
          float cv[TBA];
          const float* cp = cwb + i * BG + TBA * tga;
#pragma unroll
          for (int h = 0; h < TBA; h += 4) {
            const float4 t = *reinterpret_cast<const float4*>(cp + h);
            cv[h] = t.x; cv[h + 1] = t.y; cv[h + 2] = t.z; cv[h + 3] = t.w;
          }
          const float4 r =
              *reinterpret_cast<const float4*>(R32 + i * G::RS32 + 4 * cg);
#pragma unroll
          for (int j = 0; j < TBA; ++j) {
            u[j][0] = fmaf(cv[j], r.x, u[j][0]);
            u[j][1] = fmaf(cv[j], r.y, u[j][1]);
            u[j][2] = fmaf(cv[j], r.z, u[j][2]);
            u[j][3] = fmaf(cv[j], r.w, u[j][3]);
          }
        }
        if (ch == nc - 1) {
          const long long col = col0 + 4 * cg;
#pragma unroll
          for (int j = 0; j < TBA; ++j) {
            const int t = TBA * tga + j;
            float4* wp = reinterpret_cast<float4*>(ws + t * G::WS + 4 * cg);
            const float4 w = *wp;
            const float4 wn = make_float4(w.x - u[j][0], w.y - u[j][1],
                                          w.z - u[j][2], w.w - u[j][3]);
            if (t < nb) {
              float* g = W + (long long)(b0 + t) * d + col;
              if (vec_w) {
                if (col < d) __stcs(reinterpret_cast<float4*>(g), wn);
              } else {
                if (col < d) g[0] = wn.x;
                if (col + 1 < d) g[1] = wn.y;
                if (col + 2 < d) g[2] = wn.z;
                if (col + 3 < d) g[3] = wn.w;
              }
            }
            if (kind == PASS_AB) *wp = wn;
          }
        }
        if (kind == PASS_AB) __syncthreads();
      }

      if (kind != PASS_A) {
        // (b) acc[j][r] += sum over the split's columns of W'[tg + 8j]
        // * rows[rg + 8r]
#pragma unroll
        for (int s = 0; s < TC / (4 * KS); ++s) {
          const int c = ks * (TC / KS) + 4 * s;
          // all 17 loads first, then the FMAs one column at a time, so
          // that back-to-back FMAs update different accumulators
          float4 rv[NR], wv[NTB];
#pragma unroll
          for (int r = 0; r < NR; ++r)
            rv[r] = *reinterpret_cast<const float4*>(R32 + (rg + 8 * r) * G::RS32 + c);
#pragma unroll
          for (int j = 0; j < NTB; ++j)
            wv[j] = *reinterpret_cast<const float4*>(ws + (tg + TGB * j) * G::WS + c);
#pragma unroll
          for (int j = 0; j < NTB; ++j)
#pragma unroll
            for (int r = 0; r < NR; ++r) acc[j][r] = fmaf(wv[j].x, rv[r].x, acc[j][r]);
#pragma unroll
          for (int j = 0; j < NTB; ++j)
#pragma unroll
            for (int r = 0; r < NR; ++r) acc[j][r] = fmaf(wv[j].y, rv[r].y, acc[j][r]);
#pragma unroll
          for (int j = 0; j < NTB; ++j)
#pragma unroll
            for (int r = 0; r < NR; ++r) acc[j][r] = fmaf(wv[j].z, rv[r].z, acc[j][r]);
#pragma unroll
          for (int j = 0; j < NTB; ++j)
#pragma unroll
            for (int r = 0; r < NR; ++r) acc[j][r] = fmaf(wv[j].w, rv[r].w, acc[j][r]);
        }
        // (c) the tile's share of the sketch (bucket = column mod k),
        // loads of a batch before its stores
        if (do_sk) {
          const float sg = hash_sign((uint32_t)(col0 + sc), key);
#pragma unroll
          for (int e0 = 0; e0 < SN; e0 += SB) {
            float rv[SB], sv[SB];
#pragma unroll
            for (int e = 0; e < SB; ++e) {
              const int i = si0 + SSTEP * (e0 + e);
              rv[e] = R32[i * G::RS32 + sc];
              sv[e] = sks[i * TC + sc];
            }
#pragma unroll
            for (int e = 0; e < SB; ++e)
              sks[(si0 + SSTEP * (e0 + e)) * TC + sc] = fmaf(sg, rv[e], sv[e]);
          }
          if ((n % nsl) == nsl - 1) {      // the bucket group's last slab
            const long long bk = col0 % k + sc;
#pragma unroll
            for (int e = 0; e < SN; ++e) {
              const int i = si0 + SSTEP * e;
              if (i < nrow)
                part_sk[((long long)span * Ie + ch * IC + i) * k + bk] =
                    sks[i * TC + sc];
              sks[i * TC + sc] = 0.0f;
            }
          }
        }
      }
    }
    cp_wait(0);
    __threadfence_block();
    __syncthreads();
    if (kind != PASS_A) {
      // the four column quarters of resid, added in a fixed order
      float* scr = reinterpret_cast<float*>(ring);
#pragma unroll
      for (int j = 0; j < NTB; ++j)
#pragma unroll
        for (int r = 0; r < NR; ++r)
          scr[(ks * BG + tg + TGB * j) * IC + rg + 8 * r] = acc[j][r];
      __syncthreads();
      const int r0 = chB * IC;
      for (int e = tid; e < BG * IC; e += THREADS) {
        const int b = e / IC, i = e % IC;
        if (b < nb && r0 + i < Ie) {
          float s = scr[e];
#pragma unroll
          for (int q = 1; q < KS; ++q) s += scr[q * BG * IC + e];
          part_r[((long long)span * B + b0 + b) * Ie + r0 + i] = s;
        }
      }
      __syncthreads();
    }
  }
}

template <typename RowT, int TC>
int launch_t(const RowT* rows, int Ie, long long d, float* W, const float* cw,
             int B, int k, uint32_t key, float* part_r, float* part_sk,
             float* resid, float* sk, cudaStream_t s) {
  using G = Geo<RowT, TC>;
  int nspan;
  long long sps;
  plan_spans(B, d, k, &nspan, &sps);
  const int nc = (Ie + IC - 1) / IC;
  int stages = MAX_STAGES;
  while (stages > 2 && G::total_b(nc, stages) > SMEM_FIT) --stages;
  const size_t smem = G::total_b(nc, stages);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  // the opt-in, once per instantiation and device
  static bool sized[KERNEL_MAX_DEVICES] = {};
  const cudaError_t e =
      opt_in_smem(sized, fused_step_kernel<RowT, TC>, (int)SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  const int vec_rows = d % G::VEC == 0 &&
                       reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const int vec_w = d % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  const long long nslab = (d + k - 1) / k;
  const int groups = B > 0 ? (B + BG - 1) / BG : 1;
  dim3 grid(nspan, groups);
  fused_step_kernel<RowT, TC><<<grid, THREADS, smem, s>>>(
      rows, Ie, d, W, cw, B, k, nslab, sps, key, nc, stages, vec_rows, vec_w,
      part_r, part_sk);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_span_sum2(part_r, nspan, (long long)B * Ie, resid, part_sk,
                          nspan, (long long)Ie * k, sk, s);
}

template <typename RowT>
int launch(const RowT* rows, int Ie, long long d, float* W, const float* cw,
           int B, int k, uint32_t key, float* part_r, float* part_sk,
           float* resid, float* sk, cudaStream_t s) {
  if (k <= 0 || k % 32 != 0 || Ie <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  if (k % 64 == 0)
    return launch_t<RowT, 64>(rows, Ie, d, W, cw, B, k, key, part_r, part_sk,
                              resid, sk, s);
  return launch_t<RowT, 32>(rows, Ie, d, W, cw, B, k, key, part_r, part_sk,
                            resid, sk, s);
}

}  // namespace

extern "C" {

// Spans of a call (the wrapper allocates (spans, B, Ie) and
// (spans, Ie, k) partials).
int fused_step_num_spans(int B, int Ie, long long d, int k) {
  int nspan;
  long long sps;
  plan_spans(B, d, k, &nspan, &sps);
  return nspan;
}

// rows (Ie, d) f32 | bf16, W (B, d) f32 (overwritten with W'), cw (B, Ie)
// f32 -> resid (B, Ie), sk (Ie, k); Ie > 0, d > 0, k a multiple of 32.
// Returns cudaGetLastError() (or the launch-configuration error).
int fused_step_f32(const float* rows, int Ie, long long d, float* W,
                   const float* cw, int B, int k, unsigned int key,
                   float* part_r, float* part_sk, float* resid, float* sk,
                   void* stream) {
  return launch<float>(rows, Ie, d, W, cw, B, k, (uint32_t)key, part_r,
                       part_sk, resid, sk, (cudaStream_t)stream);
}

int fused_step_bf16(const void* rows, int Ie, long long d, float* W,
                    const float* cw, int B, int k, unsigned int key,
                    float* part_r, float* part_sk, float* resid, float* sk,
                    void* stream) {
  return launch<__nv_bfloat16>(
      reinterpret_cast<const __nv_bfloat16*>(rows), Ie, d, W, cw, B, k,
      (uint32_t)key, part_r, part_sk, resid, sk, (cudaStream_t)stream);
}

const char* fused_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
