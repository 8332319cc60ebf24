// GQA flash-attention forward for Hopper (sm_90a):
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / G]) v[b, j, h / G]
// over the keys j that query i may see: causal (j <= i + Sk - Sq, the
// queries aligned to the end of the keys), optionally inside a sliding
// window (j > i + Sk - Sq - window).  q (B, Sq, H, hd); k, v (B, Sk, K,
// hd) with G = H / K query heads per kv head; f32 or bf16 in, the same
// type out, every sum in f32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:33
// (_flash_kernel, reached from flash_attention at :94 through the
// pl.pallas_call at :117).  Its numerics are those of the blockwise
// attention the reference's prefill runs
// (src/repro/models/attention.py:142): running (m, l, acc) from
// (-inf, 0, 0), masked logits at the finite sentinel -1e30, the result
// acc / max(l, 1e-30).  A row with no visible key (causal with Sq > Sk)
// gets the mean of all values, as the reference's naive oracle (and the
// blockwise version when Sk <= 1024) gives; the Pallas kernel gives
// another value there.
//
// What bounds it on the H100.  At the llama3.2-1b prefill shape (B = 4,
// S = 4096, 32 query and 8 kv heads, hd = 64, causal) the two products
// are 4 * B * H * hd * (S (S + 1) / 2) = 2.7e11 operations, 0.28 ms at
// the 989 TFLOP/s bf16 tensor-core peak, against 67 MB of q, k, v and o
// (0.02 ms at 3.35 TB/s): the kernel is bound by operations, so the
// design is about keeping the tensor cores fed.
//
// Which body runs:
// - bf16 at hd 64, 128, 256 (the served decoders at full width):
//   flash_hopper_kernel.  Warp-specialized blocks: a producer warpgroup
//   (one thread issues TMA loads, the warpgroup gives its registers to
//   the others with setmaxnreg) and consumer warpgroups of 64 query rows
//   each, three at hd 64 (more warps to interleave the softmax with the
//   products), two at hd 128 and 256 (their O takes the registers).  Q
//   is loaded once, K and V tile by tile into a ring of shared-memory
//   stages (hd 64: 128-key tiles, 4 stages; hd 128: 128 keys, 2 stages;
//   hd 256: 64 keys, 2 stages), each stage with mbarriers for "K
//   landed", "V landed", "K free" and "V free", so loads run ahead of
//   the products.  The TMA maps are 4-D over the (B, S, heads, hd)
//   layout with the tensors' own strides (strided views need no copy),
//   128-byte swizzled as wgmma's descriptors expect (at hd 256 a row
//   arrives as four 64-column boxes), and fill zeros past Sq / Sk.
//   S = Q K^T runs on wgmma with both operands in shared memory
//   (K-major); O += P V on wgmma with P in registers (the f32 accumulator
//   layout of S, rounded to bf16, is wgmma's register A layout) and V
//   read through the transpose bit.  The softmax works in the log2
//   domain: on a key tile that every row of the warpgroup sees whole, one
//   FMA folds scale * log2(e) into the exponent of ex2; only tiles that
//   cross the causal diagonal, the window's lower edge or Sk take the
//   masked path.  Blocks are (query tile, head, batch) items, per
//   head the heaviest causal tiles first (heaviest first across all
//   heads spreads the running blocks over every kv head; it measured no
//   faster, and slower at hd 128 in some runs); where the items do not
//   fill the SMs once (gemma3-1b: B * H = 4), each query tile's key
//   range is cut into chunks of about the even share of key tiles per
//   SM, each chunk parks its (m, l, acc) in scratch, and the last of
//   them to finish (an integer count) combines them in chunk order: no
//   float atomics, so reruns stay bitwise equal.
//   What holds it back now (the design's stages timed one by one on the
//   H100 80GB HBM3 at 700 W, PERF.md § 6): at hd 64 the softmax's
//   per-logit work (ex2 alone runs at 16 a clock per SM) costs about as
//   much as the two products, and each warpgroup runs them in turn; the
//   consumer warpgroups overlap them only through the warp schedulers'
//   interleaving.
// - bf16 at hd 16 and 32 (the reduced configs and the tests only):
//   flash_bf16_kernel, 4 warps and 64 x 64 tiles on mma.sync m16n8k16
//   with ldmatrix, loads through registers.
// - f32: flash_f32_kernel, 8 warps, 32 x 32 tiles, both products as f32
//   FMAs on the CUDA cores (exact to the f32 contract, 2e-5).
// Common to all: a block visits only the key tiles of its causal /
// window range (the blockwise version's trip counts,
// attention.py:189-196; the Pallas kernel fetches every tile); kv is
// never expanded; P is rounded to bf16 for P V in the bf16 bodies and l
// sums the rounded values, so the weights applied sum to one; no float
// atomics: every block owns its output rows, so reruns are bitwise equal
// (the serving audit replays a decode step and compares).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: the f32 body's expf and the
// divisions are IEEE).  cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint, so no -lcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace {

constexpr float NEG_BIG = -1e30f;   // the reference's mask sentinel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;                           // (B, Sq, H, hd), contiguous
  int B, Sq, Sk, H, G;
  long long qb, qs, qh;              // strides, in elements
  long long kb, ks, kh;
  long long vb, vs, vh;
  float scale;
  int causal;
  int window;                        // <= 0: no window
};

// Key tiles [lo, hi] a query tile [q0, q0 + qn) visits.
template <class P>
__host__ __device__ __forceinline__ void tile_range(const P& p, int q0,
                                                    int qn, int bk, int* lo,
                                                    int* hi) {
  const int offs = p.Sk - p.Sq;
  int hi_pos = p.causal ? q0 + qn - 1 + offs : p.Sk - 1;
  hi_pos = hi_pos < 0 ? 0 : (hi_pos > p.Sk - 1 ? p.Sk - 1 : hi_pos);
  // a row with no visible key averages all values: visit every tile
  if (p.causal && q0 + offs < 0) hi_pos = p.Sk - 1;
  const int lo_pos =
      p.window > 0 && q0 + offs - p.window + 1 > 0 ? q0 + offs - p.window + 1
                                                   : 0;
  *lo = lo_pos / bk;
  *hi = hi_pos / bk;
}

// The scaled logit, or the sentinel where the mask hides it; keys past
// Sk do not exist (-inf: they weigh nothing, even in a row with no key).
__device__ __forceinline__ float masked(const Params& p, float s, int qpos,
                                        int kpos) {
  if (kpos >= p.Sk) return -INFINITY;
  const int lim = qpos + p.Sk - p.Sq;
  if (p.causal && kpos > lim) return NEG_BIG;
  if (p.window > 0 && kpos <= lim - p.window) return NEG_BIG;
  return s * p.scale;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int M_BQ = 64, M_BK = 64, M_THREADS = 128;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* ptr) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(ptr);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* ptr) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(ptr);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi,
                                              float* sum) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  *sum += __low2float(v) + __high2float(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [0, n) of a (n_rows, HD) tile from global rows `stride` apart into
// shared rows LD apart, in 16-byte pieces; rows n.. are zero
template <int HD, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long stride, int n) {
  constexpr int CPR = HD / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n)
      val = *reinterpret_cast<const uint4*>(src + (long long)r * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(M_THREADS)
flash_bf16_kernel(const Params p) {
  constexpr int LD = HD + 8;         // shared row pitch (16-byte pad)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + M_BQ * LD;
  __nv_bfloat16* Vs = Ks + M_BK * LD;

  const int nq = (p.Sq + M_BQ - 1) / M_BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * M_BQ;
  const int qn = min(M_BQ, p.Sq - q0);
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.G;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                           b * p.qb + h * p.qh + (long long)q0 * p.qs;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) +
                           b * p.kb + kvh * p.kh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) +
                           b * p.vb + kvh * p.vh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16 + g;    // this thread's rows: row0, row0 + 8
  // ldmatrix: lane L gives the address of row L % 8 of matrix L / 8
  const int lm = lane >> 3, lr = lane & 7;

  load_tile_bf16<HD, LD, M_BQ, M_THREADS>(Qs, q, p.qs, qn);

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  int t_lo, t_hi;
  tile_range(p, q0, qn, M_BK, &t_lo, &t_hi);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * M_BK;
    const int kn = min(M_BK, p.Sk - k0);
    __syncthreads();                 // the last tile's reads are done
    load_tile_bf16<HD, LD, M_BK, M_THREADS>(Ks, k + (long long)k0 * p.ks,
                                            p.ks, kn);
    load_tile_bf16<HD, LD, M_BK, M_THREADS>(Vs, v + (long long)k0 * p.vs,
                                            p.vs, kn);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, eight n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (warp * 16 + (lm & 1) * 8 + lr) * LD + kk * 16 +
                     (lm >> 1) * 8);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bf[4];              // n-tiles j, j+1; k halves 0, 1
        ldsm_x4(bf, Ks + ((j + (lm >> 1)) * 8 + lr) * LD + kk * 16 +
                        (lm & 1) * 8);
        mma_bf16(s[j], a, bf[0], bf[1]);
        mma_bf16(s[j + 1], a, bf[2], bf[3]);
      }
    }

    // mask, online softmax (rows row0 and row0 + 8; a row's 64 values
    // lie on the 4 lanes of one quad)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        s[j][e] = masked(p, s[j][e], q0 + row0 + hr * 8,
                         k0 + j * 8 + 2 * t4 + (e & 1));
        mx[hr] = fmaxf(mx[hr], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = expf(m[hr] - m_new);
      m[hr] = m_new;
    }
    uint32_t pa[8][2];               // P in bf16: [n-tile][row half]
    float ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pa[j][0] = pack_bf16(expf(s[j][0] - m[0]), expf(s[j][1] - m[0]), &ls[0]);
      pa[j][1] = pack_bf16(expf(s[j][2] - m[1]), expf(s[j][3] - m[1]), &ls[1]);
    }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A layout of the next mma
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                             pa[2 * kk + 1][1]};
#pragma unroll
      for (int n = 0; n < HD / 8; n += 2) {
        uint32_t bf[4];              // key halves 0, 1; hd tiles n, n+1
        ldsm_x4_trans(bf, Vs + (kk * 16 + (lm & 1) * 8 + lr) * LD +
                              (n + (lm >> 1)) * 8);
        mma_bf16(o[n], a, bf[0], bf[1]);
        mma_bf16(o[n + 1], a, bf[2], bf[3]);
      }
    }
  }

  // l: the quad's partial sums share alpha, so they add up
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + hr * 8;
    if (r >= qn) continue;
    const float den = fmaxf(l[hr], 1e-30f);
    __nv_bfloat16* orow =
        out + (((long long)b * p.Sq + q0 + r) * p.H + h) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][2 * hr] / den, o[n][2 * hr + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_BQ = 32, F_BK = 32, F_THREADS = 256;

template <int HD>
__global__ void __launch_bounds__(F_THREADS)
flash_f32_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // [F_BQ][HD + 1]
  float* Kt = Qs + F_BQ * (HD + 1);              // [HD][F_BK + 1]
  float* Vs = Kt + HD * (F_BK + 1);              // [F_BK][HD]
  float* Ps = Vs + F_BK * HD;                    // [F_BQ][F_BK + 1]

  const int nq = (p.Sq + F_BQ - 1) / F_BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * F_BQ;
  const int qn = min(F_BQ, p.Sq - q0);
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.G;
  const float* q = static_cast<const float*>(p.q) + b * p.qb + h * p.qh +
                   (long long)q0 * p.qs;
  const float* k = static_cast<const float*>(p.k) + b * p.kb + kvh * p.kh;
  const float* v = static_cast<const float*>(p.v) + b * p.vb + kvh * p.vh;
  // thread: query row r of the tile; keys cl + 8 j, hd columns cl + 8 i
  const int r = threadIdx.x >> 3, cl = threadIdx.x & 7;

  for (int i = threadIdx.x; i < F_BQ * HD; i += F_THREADS) {
    const int rr = i / HD, d = i % HD;
    Qs[rr * (HD + 1) + d] = rr < qn ? q[(long long)rr * p.qs + d] : 0.0f;
  }
  float acc[HD / 8];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) acc[i] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  int t_lo, t_hi;
  tile_range(p, q0, qn, F_BK, &t_lo, &t_hi);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * F_BK;
    __syncthreads();
    for (int i = threadIdx.x; i < F_BK * HD; i += F_THREADS) {
      const int c = i / HD, d = i % HD;
      const bool in = k0 + c < p.Sk;
      Kt[d * (F_BK + 1) + c] = in ? k[(long long)(k0 + c) * p.ks + d] : 0.0f;
      Vs[c * HD + d] = in ? v[(long long)(k0 + c) * p.vs + d] : 0.0f;
    }
    __syncthreads();

    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qv = Qs[r * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[j] = fmaf(qv, Kt[d * (F_BK + 1) + cl + 8 * j], s[j]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = masked(p, s[j], q0 + r, k0 + cl + 8 * j);
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    m = m_new;
    float ls = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float pj = expf(s[j] - m);
      Ps[r * (F_BK + 1) + cl + 8 * j] = pj;
      ls += pj;
    }
    l = l * alpha + ls;              // this lane's part; lanes share alpha
    __syncwarp();                    // the row's 8 lanes share one warp
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int c = 0; c < F_BK; ++c) {
      const float pc = Ps[r * (F_BK + 1) + c];
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        acc[i] = fmaf(pc, Vs[c * HD + cl + 8 * i], acc[i]);
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l += __shfl_xor_sync(0xffffffffu, l, 4);
  if (r < qn) {
    float* orow = static_cast<float*>(p.o) +
                  (((long long)b * p.Sq + q0 + r) * p.H + h) * HD;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) orow[cl + 8 * i] = acc[i] / den;
  }
}

template <int HD>
constexpr int bf16_smem() {
  return 3 * 64 * (HD + 8) * 2;
}

template <int HD>
constexpr int f32_smem() {
  return (F_BQ * (HD + 1) + HD * (F_BK + 1) + F_BK * HD + F_BQ * (F_BK + 1)) *
         4;
}

template <int HD>
cudaError_t launch(const Params& p, int bf16, cudaStream_t stream) {
  // the dynamic shared memory cap is raised once per instantiation and
  // device
  static bool raised_bf16[KERNEL_MAX_DEVICES] = {};
  static bool raised_f32[KERNEL_MAX_DEVICES] = {};
  if (bf16) {
    // bf16 at hd >= 64 runs flash_hopper_kernel
    if constexpr (HD > 32) {
      return cudaErrorInvalidValue;
    } else {
      const int smem = bf16_smem<HD>();
      const cudaError_t e =
          opt_in_smem(raised_bf16, flash_bf16_kernel<HD>, smem);
      if (e != cudaSuccess) return e;
      const dim3 grid((p.Sq + M_BQ - 1) / M_BQ, p.H, p.B);
      flash_bf16_kernel<HD><<<grid, M_THREADS, smem, stream>>>(p);
    }
  } else {
    const int smem = f32_smem<HD>();
    const cudaError_t e = opt_in_smem(raised_f32, flash_f32_kernel<HD>, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((p.Sq + F_BQ - 1) / F_BQ, p.H, p.B);
    flash_f32_kernel<HD><<<grid, F_THREADS, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at hd 64, 128, 256: TMA ring, wgmma, warp-specialized (Hopper)
// ---------------------------------------------------------------------------
//
// Block: NC + 1 warpgroups.  Warpgroup 0 is the producer: one thread
// issues the TMA loads (Q once, then K and V tile by tile into a ring of
// ST stages) and the warpgroup gives up registers (setmaxnreg).
// Warpgroups 1 .. NC are consumers, 64 query rows each (BQ = 64 NC rows
// a block): S = Q K^T and O += P V on wgmma, the softmax in registers.
// Each stage has four mbarriers: K landed, V landed (TMA transaction
// counts), K free and V free (one arrival per consumer warp).

// registers a thread after setmaxnreg: the producer warpgroup gives its
// share to NC consumer warpgroups (65536 a block, multiples of 8)
constexpr int H_PRODUCER_REGS = 24;
template <int NC>
__host__ __device__ constexpr int consumer_regs() {
  return NC == 2 ? 240 : 160;
}

struct HParams {
  CUtensorMap tq, tk, tv;            // 4-D maps over (hd, heads, S, B)
  __nv_bfloat16* o;                  // (B, Sq, H, hd), contiguous
  int B, Sq, Sk, H, G, nq;
  int bq;                            // query rows a block: 64 a consumer
  float scale;                       // softmax scale
  float scale_log2;                  // scale * log2(e)
  int causal, window;
  // balancing (cap > 0): a query tile's key range is cut into chunks of
  // at most `cap` key tiles; each chunk's block parks its (m, l, acc) in
  // `part`, and the last of them to finish (an integer count in
  // `counters`, zero before the launch and after it) combines them in
  // chunk order
  int cap;
  float* part;
  int* counters;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one (64 columns x 1 head x rows x 1 batch) box of a 4-D map into shared
// memory, 128-byte swizzled, counted on `bar`; rows past the tensor's end
// arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO); `lbo` is the distance
// between 64-column blocks (read only for the transposed operand)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups are in flight (they retire in order)
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator
// registers across the asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int scale_d);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    o[4 * n + 0] *= alpha[0];
    o[4 * n + 1] *= alpha[0];
    o[4 * n + 2] *= alpha[1];
    o[4 * n + 3] *= alpha[1];
  }
}

// Is the key tile [k0, k0 + bk) visible to every query row of
// [r0, r0 + 64)?  Then no logit of the tile needs a mask.
__device__ __forceinline__ bool tile_visible(const HParams& p, int r0, int k0,
                                             int bk) {
  const int offs = p.Sk - p.Sq;
  if (k0 + bk > p.Sk) return false;
  if (p.causal && k0 + bk - 1 > r0 + offs) return false;
  if (p.window > 0 && k0 <= r0 + 63 + offs - p.window) return false;
  return true;
}

// The online softmax over one S tile held in the accumulator layout
// (s[4 j + e]: row row_a + 8 (e >> 1), key k0 + 8 j + 2 t4 + (e & 1)),
// in place: P, rounded to bf16, leaves as packed pairs in s[4 j] (row
// row_a) and s[4 j + 2] (row row_a + 8), read back by unpack_p; l sums
// the rounded values; alpha is what O must be scaled by.  Logits live in
// the log2 domain: scale * log2(e) is folded into one FMA in the
// exponent of ex2 on the unmasked path.  MASK: the tile crosses the
// causal diagonal, the window's lower edge or Sk.
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_tile(const HParams& p,
                                             float (&s)[BK / 2], float m[2],
                                             float l[2], float (&alpha)[2],
                                             int row_a, int k0, int t4) {
  constexpr bool RAW = !MASK;          // s stays unscaled
  const float sc = p.scale_log2;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1;
      float x = s[4 * j + e];
      if (!RAW) {
        const int qpos = row_a + 8 * hr, kpos = k0 + 8 * j + 2 * t4 + (e & 1);
        const int lim = qpos + p.Sk - p.Sq;
        if (kpos >= p.Sk)
          x = -INFINITY;
        else if ((p.causal && kpos > lim) ||
                 (p.window > 0 && kpos <= lim - p.window))
          x = NEG_BIG;
        else
          x *= sc;
        s[4 * j + e] = x;
      }
      mx[hr] = fmaxf(mx[hr], x);
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    // max(s) * c == max(s * c) for c > 0: the raw maximum, scaled once
    const float m_new = fmaxf(m[hr], RAW ? mx[hr] * sc : mx[hr]);
    alpha[hr] = ex2(m[hr] - m_new);
    m[hr] = m_new;
  }
  float ls[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    float e4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mm = m[e >> 1];
      e4[e] = RAW ? ex2(fmaf(s[4 * j + e], sc, -mm)) : ex2(s[4 * j + e] - mm);
    }
    s[4 * j] = __uint_as_float(pack_bf16(e4[0], e4[1], &ls[0]));
    s[4 * j + 2] = __uint_as_float(pack_bf16(e4[2], e4[3], &ls[1]));
  }
  l[0] = l[0] * alpha[0] + ls[0];
  l[1] = l[1] * alpha[1] + ls[1];
}

// The softmax of one tile, unmasked where every row of the warpgroup
// sees the whole tile.  Not between a wgmma's issue and its wait: ptxas
// serializes wgmma around a divergent branch there.
template <int BK>
__device__ __forceinline__ void softmax_any(const HParams& p,
                                            float (&s)[BK / 2], float m[2],
                                            float l[2], float (&alpha)[2],
                                            int r0, int row_a, int k0,
                                            int t4) {
  if (tile_visible(p, r0, k0, BK))
    softmax_tile<BK, false>(p, s, m, l, alpha, row_a, k0, t4);
  else
    softmax_tile<BK, true>(p, s, m, l, alpha, row_a, k0, t4);
}

// P from softmax_tile's packed pairs to wgmma's register A layout
template <int BK>
__device__ __forceinline__ void unpack_p(const float (&s)[BK / 2],
                                         uint32_t (&pa)[BK / 8][2]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    pa[j][0] = __float_as_uint(s[4 * j]);
    pa[j][1] = __float_as_uint(s[4 * j + 2]);
  }
}

// S = Q K^T for the warpgroup's 64 rows (qa) against a key tile (kb)
template <int HD, int BK, int BQ>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t qa,
                                        uint32_t kb) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<BK>(s, sw128_desc(qa + c * BQ * 128 + kk * 32, 16),
                   sw128_desc(kb + c * BK * 128 + kk * 32, 16), c | kk);
}

// O += P V: P in registers, V [key][hd] the transposed (hd-major) B
// operand; 16 keys are 2048 bytes, the 64-column blocks BK * 128 apart
template <int HD, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pa)[BK / 8][2],
                                         uint32_t vb) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                           pa[2 * kk + 1][1]};
    wgmma_rs<HD>(o, a, sw128_desc(vb + kk * 2048, BK * 128));
  }
}

// What one block computes: query tile qt of head h, batch b, over key
// tiles [t_lo, t_hi]: chunk c of nc of the tile's range (nc = 1 without
// balancing); slot0 is the block index of the tile's chunk 0.
struct Item {
  int qt, h, b, t_lo, t_hi, c, nc, slot0;
};

// Key tiles a chunk of query tile qt visits, and how many chunks.
template <int BK>
__host__ __device__ __forceinline__ int chunks_of(const HParams& p, int qt,
                                                  int* lo, int* hi) {
  const int q0 = qt * p.bq;
  tile_range(p, q0, p.Sq - q0 < p.bq ? p.Sq - q0 : p.bq, BK, lo, hi);
  return p.cap > 0 ? (*hi - *lo + p.cap) / p.cap : 1;
}

// block `item` -> its work: per head, the heaviest causal tiles first
// (with chunks: the tiles heaviest first, each over every head).
template <int BK>
__device__ __forceinline__ Item item_of(const HParams& p, int item) {
  const int BH = p.B * p.H;
  Item it;
  int hb, lo, hi;
  if (p.cap > 0) {                   // walk the tiles, heaviest first
    int rem = item;
    for (int qi = 0;; ++qi) {
      it.qt = p.causal ? p.nq - 1 - qi : qi;
      it.nc = chunks_of<BK>(p, it.qt, &lo, &hi);
      if (rem < it.nc * BH || qi == p.nq - 1) break;
      rem -= it.nc * BH;
    }
    hb = rem / it.nc;
    it.c = rem % it.nc;
    it.slot0 = item - it.c;
  } else {
    const int qi = item % p.nq;
    hb = item / p.nq;
    it.qt = p.causal ? p.nq - 1 - qi : qi;
    it.nc = chunks_of<BK>(p, it.qt, &lo, &hi);
    it.c = 0;
    it.slot0 = item;
  }
  it.h = hb % p.H;
  it.b = hb / p.H;
  const int n = hi - lo + 1;
  it.t_lo = lo + it.c * n / it.nc;
  it.t_hi = lo + (it.c + 1) * n / it.nc - 1;
  return it;
}

// The finished rows of one consumer thread: acc / max(l, 1e-30) in bf16
// (rows row_a and row_a + 8, columns 8 n + 2 t4 + {0, 1}).
template <int HD>
__device__ __forceinline__ void write_rows(const HParams& p,
                                           const float (&o)[HD / 2],
                                           const float l[2], int row_a,
                                           int t4, int b, int h) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row_a + hr * 8;
    if (r >= p.Sq) continue;
    const float den = fmaxf(l[hr], 1e-30f);
    __nv_bfloat16* orow =
        p.o + (((long long)b * p.Sq + r) * p.H + h) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[4 * n + 2 * hr] / den,
                                o[4 * n + 2 * hr + 1] / den);
  }
}

// A chunk's (m, l, acc) in its slot of p.part, thread-major (element i of
// consumer thread ct at i * ctn + ct, ctn = 2 bq consumer threads), so
// they write and read contiguously; l already summed over the quad.
__host__ __device__ constexpr long long slot_size(int hd, int ctn) {
  return (long long)ctn * (hd / 2 + 4);
}

template <int HD, int CTN>
__device__ __forceinline__ void park_partial(const HParams& p, int slot,
                                             int ct, const float (&o)[HD / 2],
                                             const float m[2],
                                             const float l[2]) {
  constexpr int ctn = CTN;
  float* mine = p.part + (size_t)slot * slot_size(HD, ctn);
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) mine[i * ctn + ct] = o[i];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mine[(HD / 2 + hr) * ctn + ct] = m[hr];
    mine[(HD / 2 + 2 + hr) * ctn + ct] = l[hr];
  }
}

// The last chunk's block ends a balanced query tile: each thread combines
// its own elements of the tile's nc slots in chunk order (the running max
// first, then the rescaled sums), so the result does not depend on which
// chunk finished last.  Loads go 8 at a time behind a compiler barrier:
// with all HD / 2 in flight beside O, ptxas spills at hd 256.
template <int HD, int CTN>
__device__ __forceinline__ void combine_chunks(const HParams& p, int slot0,
                                               int nc, int ct,
                                               float (&o)[HD / 2],
                                               float l[2]) {
  constexpr int ctn = CTN;
  const float* part = p.part + (size_t)slot0 * slot_size(HD, ctn);
  float M[2] = {-INFINITY, -INFINITY};
  for (int c = 0; c < nc; ++c)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      M[hr] = fmaxf(M[hr], __ldcg(part + c * slot_size(HD, ctn) +
                                  (HD / 2 + hr) * ctn + ct));
  l[0] = l[1] = 0.0f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const float* s = part + c * slot_size(HD, ctn);
    float w[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      w[hr] = ex2(__ldcg(s + (HD / 2 + hr) * ctn + ct) - M[hr]);
      l[hr] = fmaf(__ldcg(s + (HD / 2 + 2 + hr) * ctn + ct), w[hr], l[hr]);
    }
#pragma unroll
    for (int g = 0; g < HD / 2; g += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __ldcg(s + (g + u) * ctn + ct);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        o[g + u] = fmaf(v[u], w[((g + u) >> 1) & 1], o[g + u]);
      asm volatile("" ::: "memory");
    }
  }
}

// mbarrier `kind` (0 K landed, 1 V landed, 2 K free, 3 V free) of ring
// stage st; bars + 0 is Q's
template <int ST>
__device__ __forceinline__ uint32_t ring_bar(uint32_t bars, int kind,
                                             int st) {
  return bars + 8u * (1 + kind * ST + st);
}

template <int HD, int BK, int ST, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_hopper_kernel(const __grid_constant__ HParams p) {
  constexpr int CB = HD / 64;                       // 64-column blocks
  constexpr int BQ = 64 * NC;                       // query rows a block
  constexpr uint32_t Q_BYTES = BQ * HD * 2, KV_BYTES = BK * HD * 2;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start 1024-aligned
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + Q_BYTES, sV = sK + ST * KV_BYTES;
  const uint32_t bars = sV + ST * KV_BYTES;
  const uint32_t bar_q = bars;
  // per stage: K landed, V landed (TMA bytes); K free, V free (one
  // arrival per consumer warp)
  auto full_k = [&](int st) { return ring_bar<ST>(bars, 0, st); };
  auto full_v = [&](int st) { return ring_bar<ST>(bars, 1, st); };
  auto free_k = [&](int st) { return ring_bar<ST>(bars, 2, st); };
  auto free_v = [&](int st) { return ring_bar<ST>(bars, 3, st); };

  const Item it = item_of<BK>(p, blockIdx.x);
  const int h = it.h, b = it.b, t_lo = it.t_lo, t_hi = it.t_hi;
  const int q0 = it.qt * BQ, kvh = h / p.G;
  __shared__ int last_chunk;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(free_k(st), 4 * NC);               // one per consumer warp
      mbar_init(free_v(st), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        H_PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
#pragma unroll
      for (int c = 0; c < CB; ++c)
        tma_load(sQ + c * BQ * 128, &p.tq, bar_q, c * 64, h, q0, b);
      for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
        const int st = i % ST;
        const uint32_t free_ph = ((i / ST) & 1) ^ 1;
        mbar_wait(free_k(st), free_ph);
        mbar_expect_tx(full_k(st), KV_BYTES);
#pragma unroll
        for (int c = 0; c < CB; ++c)
          tma_load(sK + st * KV_BYTES + c * BK * 128, &p.tk, full_k(st),
                   c * 64, kvh, t * BK, b);
        mbar_wait(free_v(st), free_ph);
        mbar_expect_tx(full_v(st), KV_BYTES);
#pragma unroll
        for (int c = 0; c < CB; ++c)
          tma_load(sV + st * KV_BYTES + c * BK * 128, &p.tv, full_v(st),
                   c * 64, kvh, t * BK, b);
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        consumer_regs<NC>()));
    const int cw = (threadIdx.x >> 7) - 1;         // consumer 0 .. NC-1
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = q0 + cw * 64;                   // this warpgroup's rows
    const int row_a = r0 + warp * 16 + g;          // and row_a + 8
    const uint32_t qa = sQ + cw * 64 * 128;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);             // this warp is done
    };

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    mbar_wait(bar_q, 0);

    for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
      const int st = i % ST;
      const uint32_t ph = (i / ST) & 1;
      const uint32_t kb = sK + st * KV_BYTES, vb = sV + st * KV_BYTES;
      float s[BK / 2], alpha[2];
      mbar_wait(full_k(st), ph);
      wgmma_fence();
      issue_s<HD, BK, BQ>(s, qa, kb);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      release(free_k(st));

      uint32_t pa[BK / 8][2];
      softmax_any<BK>(p, s, m, l, alpha, r0, row_a, t * BK, t4);
      unpack_p<BK>(s, pa);
      rescale<HD>(o, alpha);

      mbar_wait(full_v(st), ph);
      wgmma_fence();
      issue_pv<HD, BK>(o, pa, vb);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release(free_v(st));
    }

    // the quad's partial sums of l share alpha, so they add up
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    }
    if (it.nc > 1) {
      // a chunk: park it; the last of the tile's chunks to finish (the
      // count, read after every consumer thread's writes are fenced)
      // combines them
      const int ct = cw * 128 + tid;
      park_partial<HD, 128 * NC>(p, blockIdx.x, ct, o, m, l);
      __threadfence();
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NC) : "memory");
      if (ct == 0) {
        int* count = p.counters + (it.qt * p.B + b) * p.H + h;
        const int done = atomicAdd(count, 1);
        last_chunk = done == it.nc - 1;
        if (last_chunk) *count = 0;    // zero again for the next launch
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NC) : "memory");
      if (!last_chunk) return;
      __threadfence();
      combine_chunks<HD, 128 * NC>(p, it.slot0, it.nc, ct, o, l);
    }
    write_rows<HD>(p, o, l, row_a, t4, b, h);
  }
}

// key tile rows, ring stages, consumer warpgroups: three at hd 64 (more
// warps to interleave the softmax with the products), two at hd 128 and
// 256 (their O takes the registers)
template <int HD>
struct HopperShape;
template <>
struct HopperShape<64> {
  static constexpr int BK = 128, ST = 4, NC = 3;
};
template <>
struct HopperShape<128> {
  static constexpr int BK = 128, ST = 2, NC = 2;
};
template <>
struct HopperShape<256> {
  static constexpr int BK = 64, ST = 2, NC = 2;
};

template <int HD>
cudaError_t launch_hopper(const HParams& hp, int items,
                          cudaStream_t stream) {
  constexpr int BK = HopperShape<HD>::BK, ST = HopperShape<HD>::ST,
                NC = HopperShape<HD>::NC;
  constexpr int smem = 1024 + 64 * NC * HD * 2 + 2 * ST * BK * HD * 2 +
                       8 * (1 + 4 * ST);
  static_assert(smem <= 232448, "shared memory");
  static bool raised[KERNEL_MAX_DEVICES] = {};   // once per device
  const cudaError_t e =
      opt_in_smem(raised, flash_hopper_kernel<HD, BK, ST, NC>, smem);
  if (e != cudaSuccess) return e;
  flash_hopper_kernel<HD, BK, ST, NC>
      <<<(unsigned)items, 128 * (NC + 1), smem, stream>>>(hp);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A (hd, heads, S, B) map over a bf16 tensor with element strides (sb,
// ss, sh) and unit stride on hd; boxes of 64 columns x `rows` rows,
// 128-byte swizzled, zeros past the end.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int batch, int seq,
                     int heads, int hd, long long sb, long long ss,
                     long long sh, int rows) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int hopper_bk(int hd) {
  return hd == 64    ? HopperShape<64>::BK
         : hd == 128 ? HopperShape<128>::BK
                     : HopperShape<256>::BK;
}

// query rows a block: 64 a consumer warpgroup
int hopper_bq(int hd) {
  return 64 * (hd == 64    ? HopperShape<64>::NC
               : hd == 128 ? HopperShape<128>::NC
                           : HopperShape<256>::NC);
}

// The shape part of the parameters, and the balancing plan: when the
// (query tile, head, batch) items do not fill the card's SMs once, cut
// the key ranges into chunks of at most `cap` tiles, `cap` the even
// share of all tiles per SM (at least 4); sets hp->cap and returns the
// number of blocks.
int hopper_plan(const Params& p, int hd, HParams* hp) {
  const int bq = hopper_bq(hd);
  hp->B = p.B; hp->Sq = p.Sq; hp->Sk = p.Sk; hp->H = p.H; hp->G = p.G;
  hp->bq = bq;
  hp->nq = (p.Sq + bq - 1) / bq;
  hp->causal = p.causal; hp->window = p.window;
  hp->cap = 0;
  const int bk = hopper_bk(hd), BH = p.B * p.H, sms = sm_count();
  const long long items0 = (long long)hp->nq * BH;
  if (items0 >= sms) return (int)items0;
  long long total = 0;
  for (int qt = 0; qt < hp->nq; ++qt) {
    int lo, hi;
    tile_range(*hp, qt * bq, p.Sq - qt * bq < bq ? p.Sq - qt * bq : bq, bk,
               &lo, &hi);
    total += (long long)(hi - lo + 1) * BH;
  }
  int cap = (int)((total + sms - 1) / sms);
  if (cap < 4) cap = 4;
  long long items = 0;
  for (int qt = 0; qt < hp->nq; ++qt) {
    int lo, hi;
    tile_range(*hp, qt * bq, p.Sq - qt * bq < bq ? p.Sq - qt * bq : bq, bk,
               &lo, &hi);
    items += (long long)((hi - lo + cap) / cap) * BH;
  }
  if (items == items0) return (int)items0;
  hp->cap = cap;
  return (int)items;
}

cudaError_t hopper_params(const Params& p, int K, int hd, void* part,
                          void* counters, HParams* hp, int* items) {
  *items = hopper_plan(p, hd, hp);
  if (hp->cap > 0 && (part == nullptr || counters == nullptr))
    return cudaErrorInvalidValue;
  const int bk = hopper_bk(hd);
  cudaError_t e = make_map(&hp->tq, p.q, p.B, p.Sq, p.H, hd, p.qb, p.qs,
                           p.qh, hp->bq);
  if (e == cudaSuccess)
    e = make_map(&hp->tk, p.k, p.B, p.Sk, K, hd, p.kb, p.ks, p.kh, bk);
  if (e == cudaSuccess)
    e = make_map(&hp->tv, p.v, p.B, p.Sk, K, hd, p.vb, p.vs, p.vh, bk);
  hp->o = static_cast<__nv_bfloat16*>(p.o);
  hp->scale = p.scale;
  hp->scale_log2 = p.scale * 1.4426950408889634f;
  hp->part = static_cast<float*>(part);
  hp->counters = static_cast<int*>(counters);
  return e;
}

cudaError_t run_hopper(const Params& p, int K, int hd, void* part,
                       void* counters, cudaStream_t stream) {
  HParams hp;
  int items = 0;
  const cudaError_t e = hopper_params(p, K, hd, part, counters, &hp, &items);
  if (e != cudaSuccess) return e;
  switch (hd) {
    case 64: return launch_hopper<64>(hp, items, stream);
    case 128: return launch_hopper<128>(hp, items, stream);
    case 256: return launch_hopper<256>(hp, items, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace {

Params make_params(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int K, long long qb,
                   long long qs, long long qh, long long kb, long long ks,
                   long long kh, long long vb, long long vs, long long vh,
                   float scale, int causal, int window) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.G = H / K;
  p.qb = qb; p.qs = qs; p.qh = qh;
  p.kb = kb; p.ks = ks; p.kh = kh;
  p.vb = vb; p.vs = vs; p.vh = vh;
  p.scale = scale; p.causal = causal; p.window = window;
  return p;
}

bool bad_shape(int B, int Sq, int Sk, int H, int K) {
  return B < 1 || Sq < 1 || Sk < 1 || H < 1 || K < 1 || H % K != 0 ||
         B > 65535 || H > 65535;
}

bool hopper_hd(int hd) { return hd == 64 || hd == 128 || hd == 256; }

}  // namespace

extern "C" {

// Scratch a call needs, for the caller to allocate: `part` floats of
// partial results and `counters` ints that must be zero (the kernel
// leaves them zero); both 0 when the call does not balance (f32, hd 16
// and 32, or enough (query tile, head, batch) blocks to fill the card).
int flash_attention_plan(int bf16, int B, int Sq, int Sk, int H, int K,
                         int hd, int causal, int window, long long* part,
                         long long* counters) {
  *part = *counters = 0;
  if (bad_shape(B, Sq, Sk, H, K)) return (int)cudaErrorInvalidValue;
  if (!bf16 || !hopper_hd(hd)) return 0;
  const Params p = make_params(nullptr, nullptr, nullptr, nullptr, B, Sq, Sk,
                               H, K, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1.0f, causal,
                               window);
  HParams hp;
  const int items = hopper_plan(p, hd, &hp);
  if (hp.cap > 0) {
    *part = items * slot_size(hd, 2 * hp.bq);
    *counters = (long long)hp.nq * B * H;
  }
  return 0;
}

// q (B, Sq, H, hd), k / v (B, Sk, K, hd) with element strides (b, s, head)
// and a unit stride on hd; o (B, Sq, H, hd) contiguous, of q's type.
// bf16 = 1: __nv_bfloat16 (q, k, v strides positive multiples of 8,
// 16-byte aligned: what TMA reads), 0: float.  hd in {16, 32, 64, 128,
// 256}; window <= 0: none.  part, counters: the scratch
// flash_attention_plan asks for (null when it asks for none).  Returns a
// cudaError_t
// (cudaErrorInvalidValue for a shape it does not take); B, Sq, Sk, H >= 1.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int bf16, int B, int Sq, int Sk, int H, int K, int hd,
                        long long qb, long long qs, long long qh,
                        long long kb, long long ks, long long kh,
                        long long vb, long long vs, long long vh, float scale,
                        int causal, int window, void* part, void* counters,
                        void* stream) {
  if (bad_shape(B, Sq, Sk, H, K)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, B, Sq, Sk, H, K, qb, qs, qh, kb,
                               ks, kh, vb, vs, vh, scale, causal, window);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16 && hopper_hd(hd))
    return (int)run_hopper(p, K, hd, part, counters, st);
  switch (hd) {
    case 16: return (int)launch<16>(p, bf16, st);
    case 32: return (int)launch<32>(p, bf16, st);
    case 64: return (int)launch<64>(p, bf16, st);
    case 128: return (int)launch<128>(p, bf16, st);
    case 256: return (int)launch<256>(p, bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
