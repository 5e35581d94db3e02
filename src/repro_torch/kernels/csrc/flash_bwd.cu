// K8: flash-attention backward. Replaces the Pallas kernel
// repro/kernels/flash_attention.py::_flash_bwd (_bwd_kernel).
//
// q, o, do: (BH, Sq, d), k, v: (BH, Sk, d) in f32 or bf16; lse: (BH, Sq) f32
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
// three deterministic passes, no atomics, so a result does not change from
// run to run or with the batch:
//   1. delta per row (one thread a row, d products in order);
//   2. dk/dv: one CTA per (bh, 64-key block) walks the 32-row query blocks
//      that the causal mask and the window leave, recomputes s and p from
//      lse, and keeps its keys' dk and dv rows in f32 registers (four
//      threads a key, d/4 columns each);
//   3. dq: one CTA per (bh, 64-query block) walks the 32-key blocks, and
//      keeps its rows' dq in registers.
// Rows past Sq and keys past Sk are loaded as zeros and masked, so they add
// exactly 0. p is not rounded to v's type (the reference's backward keeps it
// in f32). Operands live in shared memory in f32; products are summed on the
// CUDA cores in a fixed order.
//
// Bound: 10 d flops per kept (q, k) pair (s, dp, dv, dk, dq; s is computed
// twice here, once per pass) at the tensor-core peak, or the bytes of q, k,
// v, o, do, lse in and dq, dk, dv out; at training shapes the operations.
// This first kernel runs on the CUDA cores, far from that bound; tensor-core
// tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int DMAX = 128;
constexpr int KV_BLK = 64;    // dk/dv pass: keys per CTA (4 threads a key)
constexpr int Q_STEP = 32;    // dk/dv pass: query rows per iteration
constexpr int Q_BLK = 64;     // dq pass: query rows per CTA (4 threads a row)
constexpr int KV_STEP = 32;   // dq pass: keys per iteration

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ bool kept(int qp, int kp, int Sq, int Sk,
                                     int window, int causal) {
  bool ok = qp < Sq && kp < Sk;
  if (causal) ok = ok && qp >= kp;
  return ok && (window <= 0 || qp - kp < window);
}

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld_dst,
                                          const T* __restrict__ src, int row0,
                                          int rows, int n_rows, int d) {
  for (int idx = threadIdx.x; idx < rows * d; idx += THREADS) {
    const int r = idx / d, c = idx % d;
    dst[r * ld_dst + c] =
        row0 + r < n_rows ? ld(src + (long long)(row0 + r) * d + c) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int d) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= rows) return;
  float acc = 0.f;
  for (int c = 0; c < d; ++c) acc += ld(dout + i * d + c) * ld(o + i * d + c);
  delta[i] = acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dout, float* delta, float* dq,
                   float* dk, float* dv, int BH, int Sq, int Sk, int d,
                   int window, int causal, float scale, cudaStream_t stream) {
  const long long rows = (long long)BH * Sq;
  flash_bwd_delta_kernel<T>
      <<<(unsigned)((rows + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
          (const T*)o, (const T*)dout, delta, rows, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem_kv =
      sizeof(float) * ((size_t)(2 * KV_BLK + 2 * Q_STEP) * (d + 1) +
                       2 * Q_STEP * (KV_BLK + 1) + 2 * Q_STEP);
  e = allow_smem(flash_bwd_dkdv_kernel<T>, smem_kv);
  if (e != cudaSuccess) return e;
  dim3 grid_kv((Sk + KV_BLK - 1) / KV_BLK, BH);
  flash_bwd_dkdv_kernel<T><<<grid_kv, THREADS, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, dk,
      dv, Sq, Sk, d, window, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem_q =
      sizeof(float) * ((size_t)(2 * Q_BLK + 2 * KV_STEP) * (d + 1) +
                       Q_BLK * (KV_STEP + 1));
  e = allow_smem(flash_bwd_dq_kernel<T>, smem_q);
  if (e != cudaSuccess) return e;
  dim3 grid_q((Sq + Q_BLK - 1) / Q_BLK, BH);
  flash_bwd_dq_kernel<T><<<grid_q, THREADS, smem_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, dq,
      Sq, Sk, d, window, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v, o and do share it; lse, delta, dq, dk
// and dv are f32).
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* lse,
                                const void* dout, void* delta, void* dq,
                                void* dk, void* dv, int BH, int Sq, int Sk,
                                int d, int window, int causal, float scale,
                                int dtype, void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || d < 1 || d > DMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, (const float*)lse, dout,
                              (float*)delta, (float*)dq, (float*)dk,
                              (float*)dv, BH, Sq, Sk, d, window, causal, scale,
                              s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, (const float*)lse, dout,
                                      (float*)delta, (float*)dq, (float*)dk,
                                      (float*)dv, BH, Sq, Sk, d, window,
                                      causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
