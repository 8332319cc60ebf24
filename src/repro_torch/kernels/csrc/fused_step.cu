// The fused protocol step for Hopper (sm_90a), one pass over d:
//   W'    = W - cw @ rows          (B, d), written over W
//   resid = W' @ rows^T            (B, Ie)
//   sk    = CountSketch_k(rows)    (Ie, k) under the step's key
// with rows (Ie, d) stored f32 or bf16 (read as __nv_bfloat16 and
// widened with __bfloat162float); every product and sum is f32.
//
// Replaces the TPU kernel src/repro/kernels/fused_step.py:50
// (_fused_step_kernel, reached from fused_step at :93 through the
// pl.pallas_call at :128).
//
// What bounds it on the H100.  At the fused_sweep chunk (B = 64 trials,
// Ie = 66 extended rows, d = 2^20) one call moves 0.81 GB (rows once,
// W read and written once): 0.24 ms at 3.35 TB/s.  The two products are
// 2 * 2*B*Ie*d = 17.7 GFLOP of f32 FMA outside the tensor cores (TF32
// stays off for the 1e-4 value contract): 0.27 ms at 67 TFLOP/s.  The
// kernel is bound by operations, by a small margin over bytes.
//
// What the design does about it.  The TPU kernel walks d-blocks in
// order and revisits the (B, Ie) and (Ie, k) accumulators; CUDA blocks
// run in parallel, so d is cut into spans of whole k-column slabs, one
// block per (span, group of up to 64 trials).  A block walks its span
// in 32-column sub-tiles (bucket group by bucket group, so the sketch
// partial of 32 buckets stays in shared memory) and per sub-tile:
//   - stages the rows tile in shared memory (f32, padded rows: no bank
//     conflicts either way it is read) while each warp loads its 8
//     trials' W columns into registers;
//   - (a) warp w, lane c: W'[8 trials, c] from an Ie-long FMA chain,
//     cw read as float4 broadcasts; W' goes back to device memory in
//     place (each W element is read and written by the one thread that
//     owns it, as the reference aliases W) and, transposed, to shared
//     memory for (b);
//   - (c) the signed rows accumulate into the 32 buckets' partials;
//   - (b) lane i, warp unit (rows block, 8 trials): a 32-long FMA
//     chain per (trial, row), added to the span's resid partial in
//     shared memory.
// Register tiling gives 8 FMAs per 3 shared loads in (a) and (b).  The
// span partials of resid and sk go to device memory and span_sum.cuh
// adds them in f64 in a fixed order: no float atomics, and W' is one
// FMA chain per element, so every output is the same on every run.  A
// zero cw row leaves its W row bitwise unchanged (W - 0).  Partials cost
// (spans x (B + k) x Ie) floats, about 4% of the call's bytes here.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: the hash compare is exact).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sign_hash.cuh"
#include "span_sum.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TC = 32;                 // columns per sub-tile, one per lane
constexpr int LD = TC + 1;             // padded row stride of the rows tile
constexpr int BQ = 8;                  // trials per warp unit
constexpr int BG_MAX = BQ * WARPS;     // trials per block
constexpr int TARGET_BLOCKS = 3 * 132; // about three blocks per SM
constexpr size_t SMEM_MAX = 227 * 1024;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Shared memory, in floats: rs [Ie][LD] (start rounded to 4 floats for
// the float4 regions after it), wsT [TC][BG + 4], csT [Ie][BG],
// acc [BG][Ie], sks [Ie][TC].
__host__ __device__ inline size_t rs_floats(int Ie) {
  return ((size_t)Ie * LD + 3) / 4 * 4;
}
size_t smem_bytes(int Ie, int BG) {
  return sizeof(float) * (rs_floats(Ie) + (size_t)TC * (BG + 4) +
                          2 * (size_t)Ie * BG + (size_t)Ie * TC);
}

// Trials per block and spans for a call; false if no block fits.
bool plan(int B, int Ie, long long d, int k, int* bg, int* nspan,
          long long* sps) {
  int BG = ((B > 0 ? B : 1) + BQ - 1) / BQ * BQ;
  if (BG > BG_MAX) BG = BG_MAX;
  while (BG > BQ && smem_bytes(Ie, BG) > SMEM_MAX) BG -= BQ;
  if (smem_bytes(Ie, BG) > SMEM_MAX) return false;
  const long long nslab = (d + k - 1) / k;
  const int groups = B > 0 ? (B + BG - 1) / BG : 1;
  long long want = (TARGET_BLOCKS + groups - 1) / groups;
  if (want > nslab) want = nslab;
  if (want < 1) want = 1;
  const long long per = nslab == 0 ? 1 : (nslab + want - 1) / want;
  *bg = BG;
  *sps = per;
  *nspan = nslab == 0 ? 1 : (int)((nslab + per - 1) / per);
  return true;
}

template <typename RowT>
__global__ void __launch_bounds__(THREADS)
fused_step_kernel(const RowT* __restrict__ rows, int Ie, long long d,
                  float* W, const float* __restrict__ cw, int B, int BG,
                  int k, long long nslab, long long sps, uint32_t key,
                  float* __restrict__ part_r, float* __restrict__ part_sk) {
  extern __shared__ __align__(16) float smem[];
  const int BGS = BG + 4;
  float* rs = smem;
  float* wsT = rs + rs_floats(Ie);
  float* csT = wsT + TC * BGS;
  float* acc = csT + Ie * BG;
  float* sks = acc + BG * Ie;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = blockIdx.x;
  const int b0 = blockIdx.y * BG;
  const int nb = B - b0 < BG ? B - b0 : BG;
  const bool do_sk = blockIdx.y == 0;
  const long long q0 = (long long)span * sps;
  const long long q1 = q0 + sps < nslab ? q0 + sps : nslab;

  for (int e = tid; e < Ie * BG; e += THREADS) {
    const int i = e / BG, bl = e % BG;
    csT[e] = bl < nb ? cw[(long long)(b0 + bl) * Ie + i] : 0.0f;
    acc[e] = 0.0f;
  }
  for (int e = tid; e < Ie * TC; e += THREADS) sks[e] = 0.0f;
  __syncthreads();

  const int nbg = BG / BQ;               // trial units (<= WARPS)
  const int nib = (Ie + 31) / 32;        // row blocks of 32 for (b)
  const bool has_unit = warp < nbg;
  const int tb0 = warp * BQ;             // the warp's first trial in (a)

  for (int grp = 0; grp < k / TC; ++grp) {
    for (long long q = q0; q < q1; ++q) {
      const long long p = q * k + grp * TC + lane;
      const bool ok = p < d;
      float w[BQ];
      if (has_unit) {
#pragma unroll
        for (int j = 0; j < BQ; ++j)
          w[j] = (ok && tb0 + j < nb) ? W[(long long)(b0 + tb0 + j) * d + p]
                                      : 0.0f;
      }
      for (int i = warp; i < Ie; i += WARPS)
        rs[i * LD + lane] = ok ? load_f32(rows + (long long)i * d + p) : 0.0f;
      __syncthreads();

      // (a) W' = W - cw @ rows: column `lane`, the warp's BQ trials
      if (has_unit) {
        float u[BQ];
#pragma unroll
        for (int j = 0; j < BQ; ++j) u[j] = 0.0f;
        for (int i = 0; i < Ie; ++i) {
          const float r = rs[i * LD + lane];
          const float4 c0 = *reinterpret_cast<const float4*>(csT + i * BG + tb0);
          const float4 c1 =
              *reinterpret_cast<const float4*>(csT + i * BG + tb0 + 4);
          u[0] = fmaf(c0.x, r, u[0]);
          u[1] = fmaf(c0.y, r, u[1]);
          u[2] = fmaf(c0.z, r, u[2]);
          u[3] = fmaf(c0.w, r, u[3]);
          u[4] = fmaf(c1.x, r, u[4]);
          u[5] = fmaf(c1.y, r, u[5]);
          u[6] = fmaf(c1.z, r, u[6]);
          u[7] = fmaf(c1.w, r, u[7]);
        }
        float wn[BQ];
#pragma unroll
        for (int j = 0; j < BQ; ++j) {
          wn[j] = w[j] - u[j];
          if (ok && tb0 + j < nb) W[(long long)(b0 + tb0 + j) * d + p] = wn[j];
        }
        *reinterpret_cast<float4*>(wsT + lane * BGS + tb0) =
            make_float4(wn[0], wn[1], wn[2], wn[3]);
        *reinterpret_cast<float4*>(wsT + lane * BGS + tb0 + 4) =
            make_float4(wn[4], wn[5], wn[6], wn[7]);
      }
      // (c) the sub-tile's share of the sketch (bucket = grp*TC + lane)
      if (do_sk) {
        const float sg = hash_sign((uint32_t)p, key);
        for (int i = warp; i < Ie; i += WARPS)
          sks[i * TC + lane] = fmaf(sg, rs[i * LD + lane], sks[i * TC + lane]);
      }
      __syncthreads();

      // (b) resid partials: acc[b][i] += sum_c W'[b][c] * rows[i][c]
      for (int unit = warp; unit < nib * nbg; unit += WARPS) {
        const int ib = unit / nbg, bg = unit % nbg;
        const int i = ib * 32 + lane;
        if (i >= Ie) continue;
        float s[BQ];
#pragma unroll
        for (int j = 0; j < BQ; ++j) s[j] = 0.0f;
#pragma unroll 8
        for (int c = 0; c < TC; ++c) {
          const float r = rs[i * LD + c];
          const float4 w0 =
              *reinterpret_cast<const float4*>(wsT + c * BGS + bg * BQ);
          const float4 w1 =
              *reinterpret_cast<const float4*>(wsT + c * BGS + bg * BQ + 4);
          s[0] = fmaf(w0.x, r, s[0]);
          s[1] = fmaf(w0.y, r, s[1]);
          s[2] = fmaf(w0.z, r, s[2]);
          s[3] = fmaf(w0.w, r, s[3]);
          s[4] = fmaf(w1.x, r, s[4]);
          s[5] = fmaf(w1.y, r, s[5]);
          s[6] = fmaf(w1.z, r, s[6]);
          s[7] = fmaf(w1.w, r, s[7]);
        }
#pragma unroll
        for (int j = 0; j < BQ; ++j) acc[(bg * BQ + j) * Ie + i] += s[j];
      }
      __syncthreads();
    }
    if (do_sk) {                         // block-uniform branch
      for (int e = tid; e < Ie * TC; e += THREADS) {
        part_sk[((long long)span * Ie + e / TC) * k + grp * TC + e % TC] =
            sks[e];
        sks[e] = 0.0f;
      }
      __syncthreads();
    }
  }
  for (int e = tid; e < nb * Ie; e += THREADS)
    part_r[((long long)span * B + b0) * Ie + e] = acc[e];
}

template <typename RowT>
int launch(const RowT* rows, int Ie, long long d, float* W, const float* cw,
           int B, int k, uint32_t key, float* part_r, float* part_sk,
           float* resid, float* sk, cudaStream_t s) {
  int BG, nspan;
  long long sps;
  if (!plan(B, Ie, d, k, &BG, &nspan, &sps)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Ie, BG);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_step_kernel<RowT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long nslab = (d + k - 1) / k;
  const int groups = B > 0 ? (B + BG - 1) / BG : 1;
  dim3 grid(nspan, groups);
  fused_step_kernel<RowT><<<grid, THREADS, smem, s>>>(
      rows, Ie, d, W, cw, B, BG, k, nslab, sps, key, part_r, part_sk);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = launch_span_sum(part_r, nspan, (long long)B * Ie, resid, s);
  if (err != 0) return err;
  return launch_span_sum(part_sk, nspan, (long long)Ie * k, sk, s);
}

}  // namespace

extern "C" {

// Spans of a call (the wrapper allocates (spans, B, Ie) and
// (spans, Ie, k) partials); 0 if the kernel cannot take Ie.
int fused_step_num_spans(int B, int Ie, long long d, int k) {
  int BG, nspan;
  long long sps;
  return plan(B, Ie, d, k, &BG, &nspan, &sps) ? nspan : 0;
}

// rows (Ie, d) f32 | bf16, W (B, d) f32 (overwritten with W'), cw (B, Ie)
// f32 -> resid (B, Ie), sk (Ie, k); k must be a multiple of 32.
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
