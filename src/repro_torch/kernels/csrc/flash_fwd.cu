// K4: flash-attention forward (FlashAttention-2 online softmax). Replaces the
// Pallas kernel repro/kernels/flash_attention.py::_flash_fwd (_fwd_kernel).
//
// q: (BH, Sq, d), k/v: (BH, Sk, d) -> o: (BH, Sq, d) in q's type, lse: (BH, Sq)
// f32. Causal masking and a sliding window (a runtime int; <= 0 means full
// attention) on positions q_pos = row, k_pos = column, as the reference.
//
// Design: one CTA per (bh, 32-row q block), looping over 32-key blocks in
// order; q, the k/v block and the probabilities live in shared memory, the
// running max m, sum l and the (row, d/4) output slice in registers. Four
// threads share a row. p is zeroed after exp wherever masked and l is
// clamped at 1e-30, so a fully masked row gives exactly 0 (reference lines
// 58-62, 74); p is rounded to v's type before the PV product (line 66). Key
// blocks wholly above the diagonal or wholly outside the window are skipped,
// which is exact. Scores never reach device memory, so the kernel is bound by
// its operations at prefill lengths (bytes: q, k, v, o once each).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;
constexpr int BKV = 32;
constexpr int THREADS = 128;   // 4 threads per q row
constexpr int DMAX = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int d, int window,
                 int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ld_qk = d + 1;                       // pad: no bank conflicts
  float* Qs = smem;                              // BQ x (d+1)
  float* Ks = Qs + BQ * ld_qk;                   // BKV x (d+1)
  float* Vs = Ks + BKV * ld_qk;                  // BKV x d
  float* Ps = Vs + BKV * d;                      // BQ x (BKV+1)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int t = threadIdx.x;
  const int r = t >> 2, sub = t & 3;
  const long long qbase = (long long)bh * Sq * d;
  const long long kbase = (long long)bh * Sk * d;

  for (int idx = t; idx < BQ * d; idx += THREADS) {
    int rr = idx / d, c = idx % d;
    Qs[rr * ld_qk + c] =
        (q0 + rr < Sq) ? ld(q + qbase + (long long)(q0 + rr) * d + c) : 0.f;
  }

  float m = NEG_INF, l = 0.f;
  float acc[DMAX / 4];
#pragma unroll
  for (int jd = 0; jd < DMAX / 4; ++jd) acc[jd] = 0.f;
  const int qp = q0 + r;
  const int q_last = min(q0 + BQ, Sq) - 1;

  const int n_kb = (Sk + BKV - 1) / BKV;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BKV;
    const int k_last = min(k0 + BKV, Sk) - 1;
    if (causal && k0 > q_last) break;                  // above the diagonal
    if (window > 0 && q0 - k_last >= window) continue; // left of the window
    __syncthreads();   // previous block's K/V/P reads are done
    for (int idx = t; idx < BKV * d; idx += THREADS) {
      int rr = idx / d, c = idx % d;
      bool ok = k0 + rr < Sk;
      long long g = kbase + (long long)(k0 + rr) * d + c;
      Ks[rr * ld_qk + c] = ok ? ld(k + g) : 0.f;
      Vs[rr * d + c] = ok ? ld(v + g) : 0.f;
    }
    __syncthreads();

    float s[BKV / 4];
    bool keep[BKV / 4];
    float mx = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < BKV / 4; ++jj) {
      const int c = sub + 4 * jj;
      const int kp = k0 + c;
      float dot = 0.f;
      for (int e = 0; e < d; ++e) dot += Qs[r * ld_qk + e] * Ks[c * ld_qk + e];
      bool ok = kp < Sk;
      if (causal) ok = ok && (qp >= kp);
      ok = ok && (window <= 0 || qp - kp < window);
      keep[jj] = ok;
      s[jj] = ok ? dot * scale : NEG_INF;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < BKV / 4; ++jj) {
      float p = keep[jj] ? __expf(s[jj] - m_new) : 0.f;
      psum += p;
      Ps[r * (BKV + 1) + sub + 4 * jj] = round_to(p, v);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = __expf(m - m_new);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();   // the row's four threads share Ps[r]
#pragma unroll
    for (int jd = 0; jd < DMAX / 4; ++jd) {
      const int c = sub + 4 * jd;
      if (c < d) {
        float pv = 0.f;
        for (int kk = 0; kk < BKV; ++kk)
          pv += Ps[r * (BKV + 1) + kk] * Vs[kk * d + c];
        acc[jd] = acc[jd] * alpha + pv;
      }
    }
  }

  if (qp < Sq) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int jd = 0; jd < DMAX / 4; ++jd) {
      const int c = sub + 4 * jd;
      if (c < d) st(o + qbase + (long long)qp * d + c, acc[jd] / lc);
    }
    if (sub == 0) lse[(long long)bh * Sq + qp] = m + logf(lc);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int Sq, int Sk, int d, int window,
                   int causal, float scale, cudaStream_t stream) {
  size_t smem = sizeof(float) *
                ((size_t)BQ * (d + 1) + BKV * (d + 1) + BKV * d + BQ * (BKV + 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Sq, Sk, d, window,
      causal, scale);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and o share it; lse is f32).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int BH, int Sq, int Sk,
                                int d, int window, int causal, float scale,
                                int dtype, void* stream) {
  if (d < 1 || d > DMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(q, k, v, o, (float*)lse, BH, Sq, Sk, d, window, causal,
                      scale, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(q, k, v, o, (float*)lse, BH, Sq, Sk, d, window,
                              causal, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
