// K8: flash-attention backward. Replaces the Pallas kernel
// repro/kernels/flash_attention.py::_flash_bwd (_bwd_kernel).
//
// q, o, do: (BH, Sq, d), k, v: (BH, Sk, d) in bf16 or f32; lse: (BH, Sq) f32
// from the forward (K4). Outputs dq: (BH, Sq, d), dk, dv: (BH, Sk, d), all
// f32 (the wrapper casts them to the inputs' types), and the scratch delta:
// (BH, Sq) f32. Causal masking and a sliding window (a runtime int; <= 0
// means full attention) on positions q_pos = row, k_pos = column, as K4.
//
//   s = q k^T scale, p = exp(s - lse) (0 where masked), delta = sum(do o),
//   dp = do v^T, ds = p (dp - delta) scale,
//   dv = p^T do, dk = ds^T q, dq = ds k
//
// The TPU kernel walks a (bh, key block, query block) grid in order and adds
// each step's dq into the same output block (lines 174-186, 212-213): that
// relies on the sequential grid, and on the card it would be a race. Here
// two deterministic passes, no atomics, so a result does not change from run
// to run or with the batch. Rows past Sq and keys past Sk are loaded as
// zeros and masked, so they add exactly 0. p and ds stay f32 (the
// reference's backward keeps p in f32, line 168).
//
// bf16 (training), on the tensor cores (mma.sync m16n8k16, f32
// accumulation), four warps a CTA, 16 rows a warp:
//   1. dq: one CTA per (bh, 64-query block). Its prologue forms delta for
//      its rows (written for pass 2). It walks the key blocks the mask and
//      the window leave, STEP keys at a time through a double-buffered
//      cp.async ring: s = q k^T and dp = do v^T from bf16 operands as they
//      are (products of bf16 values are exact in f32), p and ds in
//      registers, dq += ds k.
//   2. dk/dv: one CTA per (bh, 64-key block) walks the query blocks:
//      s^T = k q^T, dp^T = v do^T, dv += p^T do, dk += ds^T q.
// The products with an f32 operand (p or ds) split it into hi + lo bf16
// (hi = bf16(x), lo = bf16(x - hi)) and issue two MMAs: the residual is
// below 2^-16 of x, inside the bar of the f32 version, where one bf16
// rounding of p (as FlashAttention-2 does) is not. The passes are templated
// on (D, DV), the widths of q/k and of v, instantiated at 32, 64 and 128; a
// narrower d runs zero-padded to the next one.
//
// f32 keeps the CUDA-core passes: delta per row, then dk/dv (one CTA per
// 64-key block walking 32-row query blocks, four threads a key), then dq
// (one CTA per 64-query block walking 32-key blocks); operands in shared
// memory in f32, products summed in a fixed order.
//
// Bound: 10 d flops per kept (q, k) pair (s, dp, dv, dk, dq) at the
// tensor-core peak, or the bytes of q, k, v, o, do, lse in and dq, dk, dv
// out; at training shapes (S 256, d 64) the bytes. The bf16 passes issue 20
// d a pair (s and dp twice, the split products twice).
#include <math.h>

#include "flash_tc.cuh"

namespace {

using ftc::kept;

// ---------------------------------------------------------------------------
// f32: the CUDA-core passes
// ---------------------------------------------------------------------------
namespace f32 {


constexpr int THREADS = 256;
constexpr int DMAX = 128;
constexpr int KV_BLK = 64;    // dk/dv pass: keys per CTA (4 threads a key)
constexpr int Q_STEP = 32;    // dk/dv pass: query rows per iteration
constexpr int Q_BLK = 64;     // dq pass: query rows per CTA (4 threads a row)
constexpr int KV_STEP = 32;   // dq pass: keys per iteration

__device__ __forceinline__ void load_rows(float* dst, int ld_dst,
                                          const float* __restrict__ src,
                                          int row0, int rows, int n_rows,
                                          int d) {
  for (int idx = threadIdx.x; idx < rows * d; idx += THREADS) {
    const int r = idx / d, c = idx % d;
    dst[r * ld_dst + c] =
        row0 + r < n_rows ? src[(long long)(row0 + r) * d + c] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const float* __restrict__ o,
                       const float* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int d) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= rows) return;
  float acc = 0.f;
  for (int c = 0; c < d; ++c) acc += dout[i * d + c] * o[i * d + c];
  delta[i] = acc;
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int Sq, int Sk, int d,
                      int window, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldr = d + 1;                       // pad: no bank conflicts
  float* Ks = smem;                            // KV_BLK x (d+1)
  float* Vs = Ks + KV_BLK * ldr;               // KV_BLK x (d+1)
  float* Qs = Vs + KV_BLK * ldr;               // Q_STEP x (d+1)
  float* dOs = Qs + Q_STEP * ldr;              // Q_STEP x (d+1)
  float* Ps = dOs + Q_STEP * ldr;              // Q_STEP x (KV_BLK+1)
  float* dSs = Ps + Q_STEP * (KV_BLK + 1);     // Q_STEP x (KV_BLK+1)
  float* lse_s = dSs + Q_STEP * (KV_BLK + 1);  // Q_STEP
  float* delta_s = lse_s + Q_STEP;             // Q_STEP

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * KV_BLK;
  const int t = threadIdx.x;
  const int j = t >> 2, sub = t & 3;           // this thread's key row
  const long long qbase = (long long)bh * Sq * d;
  const long long kbase = (long long)bh * Sk * d;
  const int k_last = min(k0 + KV_BLK, Sk) - 1;

  load_rows(Ks, ldr, k + kbase, k0, KV_BLK, Sk, d);
  load_rows(Vs, ldr, v + kbase, k0, KV_BLK, Sk, d);

  float acc_dk[DMAX / 4], acc_dv[DMAX / 4];
#pragma unroll
  for (int jd = 0; jd < DMAX / 4; ++jd) acc_dk[jd] = acc_dv[jd] = 0.f;

  // query blocks that can keep a key of this block
  const int q_begin = causal ? (k0 / Q_STEP) * Q_STEP : 0;
  const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;
  for (int q0 = q_begin; q0 < q_end; q0 += Q_STEP) {
    __syncthreads();   // the previous block's reads are done
    load_rows(Qs, ldr, q + qbase, q0, Q_STEP, Sq, d);
    load_rows(dOs, ldr, dout + qbase, q0, Q_STEP, Sq, d);
    if (t < Q_STEP) {
      const bool in = q0 + t < Sq;
      lse_s[t] = in ? lse[(long long)bh * Sq + q0 + t] : 0.f;
      delta_s[t] = in ? delta[(long long)bh * Sq + q0 + t] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int m = 0; m < Q_STEP / 4; ++m) {
      const int i = sub + 4 * m;
      const float* qr = Qs + i * ldr;
      const float* dor = dOs + i * ldr;
      const float* kr = Ks + j * ldr;
      const float* vr = Vs + j * ldr;
      float s = 0.f, dp = 0.f;
      for (int e = 0; e < d; ++e) {
        s += qr[e] * kr[e];
        dp += dor[e] * vr[e];
      }
      float p = 0.f;
      if (kept(q0 + i, k0 + j, Sq, Sk, window, causal))
        p = expf(s * scale - lse_s[i]);
      Ps[i * (KV_BLK + 1) + j] = p;
      dSs[i * (KV_BLK + 1) + j] = p * (dp - delta_s[i]) * scale;
    }
    __syncthreads();
#pragma unroll
    for (int jd = 0; jd < DMAX / 4; ++jd) {
      const int c = sub + 4 * jd;
      if (c < d) {
        float a_v = 0.f, a_k = 0.f;
        for (int i = 0; i < Q_STEP; ++i) {
          a_v += Ps[i * (KV_BLK + 1) + j] * dOs[i * ldr + c];
          a_k += dSs[i * (KV_BLK + 1) + j] * Qs[i * ldr + c];
        }
        acc_dv[jd] += a_v;
        acc_dk[jd] += a_k;
      }
    }
  }
  if (k0 + j < Sk) {
    const long long row = kbase + (long long)(k0 + j) * d;
#pragma unroll
    for (int jd = 0; jd < DMAX / 4; ++jd) {
      const int c = sub + 4 * jd;
      if (c < d) {
        dk[row + c] = acc_dk[jd];
        dv[row + c] = acc_dv[jd];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Sq, int Sk, int d, int window, int causal,
                    float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldr = d + 1;
  float* Qs = smem;                            // Q_BLK x (d+1)
  float* dOs = Qs + Q_BLK * ldr;               // Q_BLK x (d+1)
  float* Ks = dOs + Q_BLK * ldr;               // KV_STEP x (d+1)
  float* Vs = Ks + KV_STEP * ldr;              // KV_STEP x (d+1)
  float* dSs = Vs + KV_STEP * ldr;             // Q_BLK x (KV_STEP+1)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * Q_BLK;
  const int t = threadIdx.x;
  const int i = t >> 2, sub = t & 3;           // this thread's query row
  const int qp = q0 + i;
  const long long qbase = (long long)bh * Sq * d;
  const long long kbase = (long long)bh * Sk * d;
  const int q_last = min(q0 + Q_BLK, Sq) - 1;

  load_rows(Qs, ldr, q + qbase, q0, Q_BLK, Sq, d);
  load_rows(dOs, ldr, dout + qbase, q0, Q_BLK, Sq, d);
  const bool row_in = qp < Sq;
  const float lse_i = row_in ? lse[(long long)bh * Sq + qp] : 0.f;
  const float delta_i = row_in ? delta[(long long)bh * Sq + qp] : 0.f;

  float acc[DMAX / 4];
#pragma unroll
  for (int jd = 0; jd < DMAX / 4; ++jd) acc[jd] = 0.f;

  // key blocks that a row of this block can keep
  const int k_begin =
      window > 0 ? (max(0, q0 - window + 1) / KV_STEP) * KV_STEP : 0;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  for (int k0 = k_begin; k0 < k_end; k0 += KV_STEP) {
    __syncthreads();
    load_rows(Ks, ldr, k + kbase, k0, KV_STEP, Sk, d);
    load_rows(Vs, ldr, v + kbase, k0, KV_STEP, Sk, d);
    __syncthreads();
#pragma unroll 1
    for (int m = 0; m < KV_STEP / 4; ++m) {
      const int jj = sub + 4 * m;
      const float* qr = Qs + i * ldr;
      const float* dor = dOs + i * ldr;
      const float* kr = Ks + jj * ldr;
      const float* vr = Vs + jj * ldr;
      float s = 0.f, dp = 0.f;
      for (int e = 0; e < d; ++e) {
        s += qr[e] * kr[e];
        dp += dor[e] * vr[e];
      }
      float p = 0.f;
      if (kept(qp, k0 + jj, Sq, Sk, window, causal))
        p = expf(s * scale - lse_i);
      dSs[i * (KV_STEP + 1) + jj] = p * (dp - delta_i) * scale;
    }
    __syncwarp();   // the row's four threads share dSs[i]
#pragma unroll
    for (int jd = 0; jd < DMAX / 4; ++jd) {
      const int c = sub + 4 * jd;
      if (c < d) {
        float a = 0.f;
        for (int jj = 0; jj < KV_STEP; ++jj)
          a += dSs[i * (KV_STEP + 1) + jj] * Ks[jj * ldr + c];
        acc[jd] += a;
      }
    }
    __syncwarp();   // dSs[i] is rewritten by the next block
  }
  if (row_in) {
    const long long row = qbase + (long long)qp * d;
#pragma unroll
    for (int jd = 0; jd < DMAX / 4; ++jd) {
      const int c = sub + 4 * jd;
      if (c < d) dq[row + c] = acc[jd];
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       float* delta, float* dq, float* dk, float* dv, int BH,
                       int Sq, int Sk, int d, int window, int causal,
                       float scale, cudaStream_t stream) {
  const long long rows = (long long)BH * Sq;
  flash_bwd_delta_kernel
      <<<(unsigned)((rows + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
          (const float*)o, (const float*)dout, delta, rows, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem_kv =
      sizeof(float) * ((size_t)(2 * KV_BLK + 2 * Q_STEP) * (d + 1) +
                       2 * Q_STEP * (KV_BLK + 1) + 2 * Q_STEP);
  e = allow_smem(flash_bwd_dkdv_kernel, smem_kv);
  if (e != cudaSuccess) return e;
  dim3 grid_kv((Sk + KV_BLK - 1) / KV_BLK, BH);
  flash_bwd_dkdv_kernel<<<grid_kv, THREADS, smem_kv, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, dk, dv, Sq, Sk, d, window, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem_q =
      sizeof(float) * ((size_t)(2 * Q_BLK + 2 * KV_STEP) * (d + 1) +
                       Q_BLK * (KV_STEP + 1));
  e = allow_smem(flash_bwd_dq_kernel, smem_q);
  if (e != cudaSuccess) return e;
  dim3 grid_q((Sq + Q_BLK - 1) / Q_BLK, BH);
  flash_bwd_dq_kernel<<<grid_q, THREADS, smem_q, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, dq, Sq, Sk, d, window, causal, scale);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: the tensor-core passes
// ---------------------------------------------------------------------------
namespace tcb {

using ftc::bf16;
using ftc::frag_a;
using ftc::load_tile;
using ftc::mma_nk;
using ftc::pack;
using ftc::pitch;
constexpr int BLK = 64;       // queries (dq pass) or keys (dk/dv pass) a CTA
constexpr int WARPS = BLK / 16;
constexpr int THREADS = 32 * WARPS;

// Rows of the inner block: 64, or 32 at d 128 to keep the accumulators in
// registers.
template <int D, int DV>
__host__ __device__ constexpr int step() {
  return D <= 64 && DV <= 64 ? 64 : 32;
}

// n_rows f32 values from src + row0 into dst[0 .. ROWS), zero past n_rows.
template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst,
                                         const float* __restrict__ src,
                                         int row0, int n_rows) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS) {
    const bool ok = row0 + i < n_rows;
    rt::cp_async4(dst + i, ok ? (const void*)(src + row0 + i)
                              : (const void*)src, ok);
  }
}

// The A fragments (16 x 16) of hi = bf16(x) and lo = bf16(x - hi) for an f32
// 16 x 16 block held as two n8 accumulator tiles c0 (columns 0-7) and c1
// (columns 8-15): the accumulator layout of m16n8 is the A layout of
// m16n8k16, two tiles at a time.
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  hi = pack(x0, x1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = pack(x0 - __low2float(h), x1 - __high2float(h));
}

__device__ __forceinline__ void split(const float (&c0)[4],
                                      const float (&c1)[4], unsigned (&hi)[4],
                                      unsigned (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);   // row g, columns 2t, 2t + 1
  split2(c0[2], c0[3], hi[1], lo[1]);   // row g + 8
  split2(c1[0], c1[1], hi[2], lo[2]);   // row g, columns 8 + 2t, 9 + 2t
  split2(c1[2], c1[3], hi[3], lo[3]);   // row g + 8
}

// acc += (hi + lo) . B, B taken from a row-major (rows = k, columns = n)
// tile: dv = p^T do reads do's rows as B's k.
template <int W>
__device__ __forceinline__ void mma_kn2(float (&c0)[4], float (&c1)[4],
                                        const unsigned (&hi)[4],
                                        const unsigned (&lo)[4],
                                        const unsigned char* tile, int k0,
                                        int n0, int lane) {
  unsigned b[4];
  rt::ldsm_x4_t(b, tile + (k0 + (lane & 15)) * pitch(W) +
                       (n0 + (lane >> 4) * 8) * 2);
  rt::mma(c0, hi, b[0], b[1]);
  rt::mma(c0, lo, b[0], b[1]);
  rt::mma(c1, hi, b[2], b[3]);
  rt::mma(c1, lo, b[2], b[3]);
}

// s (or s^T) and dp (or dp^T) of one warp's 16 rows against N rows of the
// other side: rows of x and dx (q and do, or k and v) in shared tiles X, dX
// at row0; columns from Y, dY (k and v, or q and do).
template <int D, int DV, int N>
__device__ __forceinline__ void scores(float (&s)[N / 8][4],
                                       float (&dp)[N / 8][4],
                                       const unsigned char* X,
                                       const unsigned char* dX,
                                       const unsigned char* Y,
                                       const unsigned char* dY, int row0,
                                       int lane) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned a[4];
    frag_a<D>(a, X, row0, kk * 16, lane);
#pragma unroll
    for (int nb = 0; nb < N / 16; ++nb)
      mma_nk<D>(s[2 * nb], s[2 * nb + 1], a, Y, nb * 16, kk * 16, lane);
  }
#pragma unroll
  for (int kk = 0; kk < DV / 16; ++kk) {
    unsigned a[4];
    frag_a<DV>(a, dX, row0, kk * 16, lane);
#pragma unroll
    for (int nb = 0; nb < N / 16; ++nb)
      mma_nk<DV>(dp[2 * nb], dp[2 * nb + 1], a, dY, nb * 16, kk * 16, lane);
  }
}

struct Args {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;
  float *delta, *dq, *dk, *dv;
  int Sq, Sk, d, dv_w, window, causal;
  float scale;
  int vec;   // d, dv % 8 == 0 and 16-byte bases: cp.async rows
};

// Pass 1: dq (and delta) of one 64-query block.
template <int D, int DV>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_tc_kernel(Args p) {
  constexpr int STEP = step<D, DV>();
  constexpr int Q_BYTES = BLK * pitch(D), DO_BYTES = BLK * pitch(DV);
  constexpr int K_BYTES = STEP * pitch(D), V_BYTES = STEP * pitch(DV);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* dOs = Qs + Q_BYTES;
  unsigned char* ring = dOs + DO_BYTES;               // 2 x (K, V)
  float* lse_s = (float*)(ring + 2 * (K_BYTES + V_BYTES));
  float* delta_s = lse_s + BLK;

  const int bh = blockIdx.y, q0 = blockIdx.x * BLK;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4;
  const bf16* qb = p.q + (long long)bh * p.Sq * p.d;
  const bf16* ob = p.o + (long long)bh * p.Sq * p.dv_w;
  const bf16* dob = p.dout + (long long)bh * p.Sq * p.dv_w;
  const bf16* kb = p.k + (long long)bh * p.Sk * p.d;
  const bf16* vb = p.v + (long long)bh * p.Sk * p.dv_w;
  const int q_last = min(q0 + BLK, p.Sq) - 1;
  // key blocks that a row of this block can keep
  const int k_begin = p.window > 0
                          ? (max(0, q0 - p.window + 1) / STEP) * STEP : 0;
  const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int nsteps = k_end > k_begin ? (k_end - k_begin + STEP - 1) / STEP
                                     : 0;
  auto issue = [&](int t) {
    if (t < nsteps) {
      unsigned char* r = ring + (t % 2) * (K_BYTES + V_BYTES);
      const int k0 = k_begin + t * STEP;
      load_tile<STEP, D, THREADS>(r, kb, k0, p.Sk, p.d, p.vec);
      load_tile<STEP, DV, THREADS>(r + K_BYTES, vb, k0, p.Sk, p.dv_w, p.vec);
    }
    rt::cp_async_commit();
  };

  load_tile<BLK, D, THREADS>(Qs, qb, q0, p.Sq, p.d, p.vec);
  load_tile<BLK, DV, THREADS>(dOs, dob, q0, p.Sq, p.dv_w, p.vec);
  load_vec<BLK>(lse_s, p.lse + (long long)bh * p.Sq, q0, p.Sq);
  issue(0);

  // delta of this block's rows: two threads a row, halves of the row
  {
    const int r = tid / 2, h = tid % 2;
    const int half = (p.dv_w + 1) / 2;
    const int c0 = h * half, c1 = min(p.dv_w, c0 + half);
    float acc = 0.f;
    if (q0 + r < p.Sq) {
      const long long row = (long long)(q0 + r) * p.dv_w;
      for (int c = c0; c < c1; ++c)
        acc = fmaf(__bfloat162float(dob[row + c]),
                   __bfloat162float(ob[row + c]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (h == 0) {
      delta_s[r] = acc;
      if (q0 + r < p.Sq) p.delta[(long long)bh * p.Sq + q0 + r] = acc;
    }
  }

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[n][c] = 0.f;

  const int row0 = warp * 16;
  for (int t = 0; t < nsteps; ++t) {
    issue(t + 1);
    rt::cp_async_wait<1>();
    __syncthreads();
    const unsigned char* Ks = ring + (t % 2) * (K_BYTES + V_BYTES);
    const unsigned char* Vs = Ks + K_BYTES;
    const int k0 = k_begin + t * STEP;
    float s[STEP / 8][4], ds[STEP / 8][4];
    scores<D, DV, STEP>(s, ds, Qs, dOs, Ks, Vs, row0, lane);
#pragma unroll
    for (int n = 0; n < STEP / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = row0 + g + 8 * (c >> 1);
        const int kp = k0 + n * 8 + 2 * tq + (c & 1);
        const float pv = kept(q0 + r, kp, p.Sq, p.Sk, p.window, p.causal)
                             ? expf(s[n][c] * p.scale - lse_s[r])
                             : 0.f;
        ds[n][c] = pv * (ds[n][c] - delta_s[r]) * p.scale;
      }
#pragma unroll
    for (int kk = 0; kk < STEP / 16; ++kk) {
      unsigned hi[4], lo[4];
      split(ds[2 * kk], ds[2 * kk + 1], hi, lo);
#pragma unroll
      for (int nb = 0; nb < D / 16; ++nb)
        mma_kn2<D>(dq[2 * nb], dq[2 * nb + 1], hi, lo, Ks, kk * 16, nb * 16,
                   lane);
    }
    __syncthreads();   // the ring slot is refilled next
  }
  rt::cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = q0 + row0 + g + 8 * (c >> 1);
      const int col = n * 8 + 2 * tq + (c & 1);
      if (row < p.Sq && col < p.d)
        p.dq[((long long)bh * p.Sq + row) * p.d + col] = dq[n][c];
    }
}

// Pass 2: dk and dv of one 64-key block.
template <int D, int DV>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_tc_kernel(Args p) {
  constexpr int STEP = step<D, DV>();
  constexpr int K_BYTES = BLK * pitch(D), V_BYTES = BLK * pitch(DV);
  constexpr int Q_BYTES = STEP * pitch(D), DO_BYTES = STEP * pitch(DV);
  constexpr int SLOT = Q_BYTES + DO_BYTES + 2 * STEP * (int)sizeof(float);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + K_BYTES;
  unsigned char* ring = Vs + V_BYTES;       // 2 x (q, do, lse, delta)

  const int bh = blockIdx.y, k0 = blockIdx.x * BLK;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4;
  const bf16* qb = p.q + (long long)bh * p.Sq * p.d;
  const bf16* dob = p.dout + (long long)bh * p.Sq * p.dv_w;
  const bf16* kb = p.k + (long long)bh * p.Sk * p.d;
  const bf16* vb = p.v + (long long)bh * p.Sk * p.dv_w;
  const float* lseb = p.lse + (long long)bh * p.Sq;
  const float* deltab = p.delta + (long long)bh * p.Sq;
  const int k_last = min(k0 + BLK, p.Sk) - 1;
  // query blocks that can keep a key of this block
  const int q_begin = p.causal ? (k0 / STEP) * STEP : 0;
  const int q_end = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;
  const int nsteps = q_end > q_begin ? (q_end - q_begin + STEP - 1) / STEP
                                     : 0;
  auto issue = [&](int t) {
    if (t < nsteps) {
      unsigned char* r = ring + (t % 2) * SLOT;
      const int q0 = q_begin + t * STEP;
      float* lv = (float*)(r + Q_BYTES + DO_BYTES);
      load_tile<STEP, D, THREADS>(r, qb, q0, p.Sq, p.d, p.vec);
      load_tile<STEP, DV, THREADS>(r + Q_BYTES, dob, q0, p.Sq, p.dv_w, p.vec);
      load_vec<STEP>(lv, lseb, q0, p.Sq);
      load_vec<STEP>(lv + STEP, deltab, q0, p.Sq);
    }
    rt::cp_async_commit();
  };

  load_tile<BLK, D, THREADS>(Ks, kb, k0, p.Sk, p.d, p.vec);
  load_tile<BLK, DV, THREADS>(Vs, vb, k0, p.Sk, p.dv_w, p.vec);
  issue(0);

  float dk[D / 8][4], dv[DV / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = 0.f;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dv[n][c] = 0.f;

  const int row0 = warp * 16;
  for (int t = 0; t < nsteps; ++t) {
    issue(t + 1);
    rt::cp_async_wait<1>();
    __syncthreads();
    const unsigned char* Qs = ring + (t % 2) * SLOT;
    const unsigned char* dOs = Qs + Q_BYTES;
    const float* lse_s = (const float*)(dOs + DO_BYTES);
    const float* delta_s = lse_s + STEP;
    const int q0 = q_begin + t * STEP;
    float pt[STEP / 8][4], dst[STEP / 8][4];    // p^T and ds^T
    scores<D, DV, STEP>(pt, dst, Ks, Vs, Qs, dOs, row0, lane);
#pragma unroll
    for (int n = 0; n < STEP / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + row0 + g + 8 * (c >> 1);
        const int qi = n * 8 + 2 * tq + (c & 1);
        const float pv = kept(q0 + qi, kp, p.Sq, p.Sk, p.window, p.causal)
                             ? expf(pt[n][c] * p.scale - lse_s[qi])
                             : 0.f;
        dst[n][c] = pv * (dst[n][c] - delta_s[qi]) * p.scale;
        pt[n][c] = pv;
      }
#pragma unroll
    for (int kk = 0; kk < STEP / 16; ++kk) {
      unsigned hi[4], lo[4];
      split(pt[2 * kk], pt[2 * kk + 1], hi, lo);
#pragma unroll
      for (int nb = 0; nb < DV / 16; ++nb)
        mma_kn2<DV>(dv[2 * nb], dv[2 * nb + 1], hi, lo, dOs, kk * 16,
                    nb * 16, lane);
      split(dst[2 * kk], dst[2 * kk + 1], hi, lo);
#pragma unroll
      for (int nb = 0; nb < D / 16; ++nb)
        mma_kn2<D>(dk[2 * nb], dk[2 * nb + 1], hi, lo, Qs, kk * 16, nb * 16,
                   lane);
    }
    __syncthreads();   // the ring slot is refilled next
  }
  rt::cp_async_wait<0>();

  const int row_g = k0 + row0 + g;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int row = row_g + 8 * (c >> 1);
    if (row >= p.Sk) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * tq + (c & 1);
      if (col < p.d)
        p.dk[((long long)bh * p.Sk + row) * p.d + col] = dk[n][c];
    }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int col = n * 8 + 2 * tq + (c & 1);
      if (col < p.dv_w)
        p.dv[((long long)bh * p.Sk + row) * p.dv_w + col] = dv[n][c];
    }
  }
}

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D, int DV>
cudaError_t launch(const Args& p, int BH, cudaStream_t stream) {
  constexpr int STEP = step<D, DV>();
  constexpr int SMEM_DQ = BLK * (pitch(D) + pitch(DV)) +
                          2 * STEP * (pitch(D) + pitch(DV)) +
                          2 * BLK * (int)sizeof(float);
  constexpr int SMEM_KV = BLK * (pitch(D) + pitch(DV)) +
                          2 * (STEP * (pitch(D) + pitch(DV)) +
                               2 * STEP * (int)sizeof(float));
  cudaError_t e = opt_in(flash_bwd_dq_tc_kernel<D, DV>, SMEM_DQ);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_tc_kernel<D, DV>
      <<<dim3((p.Sq + BLK - 1) / BLK, BH), THREADS, SMEM_DQ, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = opt_in(flash_bwd_dkdv_tc_kernel<D, DV>, SMEM_KV);
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_tc_kernel<D, DV>
      <<<dim3((p.Sk + BLK - 1) / BLK, BH), THREADS, SMEM_KV, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tcb
}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v, o and do share it; lse, delta, dq, dk
// and dv are f32).
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* lse,
                                const void* dout, void* delta, void* dq,
                                void* dk, void* dv, int BH, int Sq, int Sk,
                                int d, int window, int causal, float scale,
                                int dtype, void* stream) {
  if (BH < 1 || BH > 65535 || Sq < 1 || Sk < 1 || d < 1 || d > f32::DMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)f32::launch_f32(q, k, v, o, (const float*)lse, dout,
                                (float*)delta, (float*)dq, (float*)dk,
                                (float*)dv, BH, Sq, Sk, d, window, causal,
                                scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  using tcb::bf16;
  const void* ptrs[] = {q, k, v, o, dout};
  bool aligned = d % 8 == 0;
  for (const void* ptr : ptrs) aligned = aligned && (uintptr_t)ptr % 16 == 0;
  tcb::Args p{(const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
              (const bf16*)dout, (const float*)lse, (float*)delta,
              (float*)dq, (float*)dk, (float*)dv, Sq, Sk, d, d, window,
              causal, scale, (int)aligned};
  if (d <= 32) return (int)tcb::launch<32, 32>(p, BH, s);
  if (d <= 64) return (int)tcb::launch<64, 64>(p, BH, s);
  return (int)tcb::launch<128, 128>(p, BH, s);
}
