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
// (0.02 ms at 3.35 TB/s): the kernel is bound by operations.
//
// What the design does about it.
// - Grid: one block per (query tile, head, batch), the causal tiles with
//   the most work first.  A block visits only the key tiles inside its
//   causal / window range (the blockwise version's exact trip counts,
//   attention.py:189-196); the Pallas kernel fetches every tile.  KV
//   head = h / G: kv is never expanded.  q, k and v are read in their
//   (B, S, heads, hd) layout through strides; nothing is transposed or
//   padded in device memory.
// - bf16: 4 warps, 64 queries x 64 keys per tile.  Both products run on
//   the tensor cores (mma.sync m16n8k16, bf16 operands, f32 sums), with
//   the operands brought from shared memory by ldmatrix.  Q.K^T is exact
//   in its products; the probabilities are rounded to bf16 for P.V (as
//   the reference's decode rounds p to the cache type), and l sums the
//   rounded values, so the weights that are applied sum to one.  Rows
//   are padded by 16 bytes in shared memory, so ldmatrix reads without
//   bank conflicts.  hd = 256 takes 101 KB of shared memory.
// - f32: 8 warps, 32 x 32 tiles, both products as f32 FMAs on the CUDA
//   cores (exact to the f32 contract, 2e-5); K is stored transposed and
//   the Q rows padded by one word, so the inner loops are conflict-free.
// - No float atomics: every block owns its output rows, so reruns are
//   bitwise equal (the serving audit replays a decode step and compares).
// Not yet: wgmma, TMA, a ring of tiles in flight (the next PRs).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: expf and the division are IEEE).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
__device__ __forceinline__ void tile_range(const Params& p, int q0, int qn,
                                           int bk, int* lo, int* hi) {
  const int offs = p.Sk - p.Sq;
  int hi_pos = p.causal ? q0 + qn - 1 + offs : p.Sk - 1;
  hi_pos = min(max(hi_pos, 0), p.Sk - 1);
  // a row with no visible key averages all values: visit every tile
  if (p.causal && q0 + offs < 0) hi_pos = p.Sk - 1;
  const int lo_pos = p.window > 0 ? max(0, q0 + offs - p.window + 1) : 0;
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
  // the dynamic shared memory cap is raised once per instantiation
  static bool raised[2] = {false, false};
  if (bf16) {
    const int smem = bf16_smem<HD>();
    if (!raised[1]) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return e;
      raised[1] = true;
    }
    const dim3 grid((p.Sq + M_BQ - 1) / M_BQ, p.H, p.B);
    flash_bf16_kernel<HD><<<grid, M_THREADS, smem, stream>>>(p);
  } else {
    const int smem = f32_smem<HD>();
    if (!raised[0]) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return e;
      raised[0] = true;
    }
    const dim3 grid((p.Sq + F_BQ - 1) / F_BQ, p.H, p.B);
    flash_f32_kernel<HD><<<grid, F_THREADS, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k / v (B, Sk, K, hd) with element strides (b, s, head)
// and a unit stride on hd; o (B, Sq, H, hd) contiguous, of q's type.
// bf16 = 1: __nv_bfloat16 (q, k, v strides multiples of 8, 16-byte
// aligned), 0: float.  hd in {16, 32, 64, 128, 256}; window <= 0: none.
// Returns a cudaError_t (cudaErrorInvalidValue for a shape it does not
// take); B, Sq, Sk, H >= 1.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int bf16, int B, int Sq, int Sk, int H, int K, int hd,
                        long long qb, long long qs, long long qh,
                        long long kb, long long ks, long long kh,
                        long long vb, long long vs, long long vh, float scale,
                        int causal, int window, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || K < 1 || H % K != 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.G = H / K;
  p.qb = qb; p.qs = qs; p.qh = qh;
  p.kb = kb; p.ks = ks; p.kh = kh;
  p.vb = vb; p.vs = vs; p.vh = vh;
  p.scale = scale; p.causal = causal; p.window = window;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
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
