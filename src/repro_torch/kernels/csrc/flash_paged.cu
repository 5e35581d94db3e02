// K5: paged flash attention, the attention of paged decode and chunked
// prefill. Replaces the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention_paged (_paged_fwd_kernel).
//
// q: (B, H, Sq, d), k_pool: (P, ps, KV, d), v_pool: (P, ps, KV, dv),
// page_table: (B, max_pages) int32, lengths and q_start: (B,) int32
// -> o: (B, H, Sq, dv) in q's type. Query head h reads kv head h / (H / KV);
// key j * ps + t of sequence b lives at pool[page_table[b, j], t]. A key is
// kept when k_pos < lengths[b], q_pos >= k_pos (causal) and q_pos - k_pos <
// window (window > 0), where q_pos = q_start[b] + q row.
//
// Design: one CTA per (block of 16 q rows, kv head, sequence). A CTA's rows
// are the (group head, q row) pairs that read its kv head, so a GQA group
// reads each K/V row once. The CTA walks the sequence in 16-key tiles up to
// lengths[b]: it reads each key's page id from the table and gathers the
// key's K and V rows into shared memory as f32. Rows at or past lengths[b]
// load as zeros, so unwritten pool rows never reach the arithmetic (the
// reference meets them with p = 0). Online softmax on the CUDA cores: eight
// threads share a q row for the scores (two keys each); every thread owns
// fixed entries of the (16, dv) output accumulator, in registers, for the PV
// product. Scores in f32, masked entries -1e30 with p zeroed after exp, p
// rounded to v's type for PV (reference lines 311-319), l clamped at 1e-30 so
// a row with no valid key gives exactly 0 (line 329). A row's arithmetic does
// not depend on which block or chunk it sits in. Tiles wholly above the
// causal diagonal or left of the window are skipped, which is exact (alpha
// stays 1, p stays 0).
//
// Bound on the H100: the bytes of the valid K/V rows (plus q and o) at decode
// and at chunked prefill alike. This first version keeps one tile in flight
// per CTA, so the per-tile load latency sets its time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int RB = 16;               // q rows per CTA
constexpr int KT = 16;               // keys per tile
constexpr int THREADS = 128;
constexpr int TPR = THREADS / RB;    // threads per q row in the score phase
constexpr int KPT = KT / TPR;        // keys per thread in the score phase
constexpr int DMAX = 576;
constexpr int DVMAX = 512;
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

// NACC = RB * dv_max / THREADS accumulator entries per thread.
template <typename T, int NACC>
__global__ void __launch_bounds__(THREADS)
flash_paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool, const int* __restrict__ pt,
                   const int* __restrict__ lengths,
                   const int* __restrict__ q_start, T* __restrict__ o, int H,
                   int Sq, int d, int dv, int P, int ps, int KV, int max_pages,
                   int window, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = d + 1;                  // pad: no bank conflicts
  float* Qs = smem;                       // RB x (d+1)
  float* Ks = Qs + RB * ldk;              // KT x (d+1)
  float* Vs = Ks + KT * ldk;              // KT x dv
  float* Ps = Vs + KT * dv;               // RB x (KT+1)
  float* alpha_s = Ps + RB * (KT + 1);    // RB
  float* l_s = alpha_s + RB;              // RB

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int R = G * Sq;                   // rows of this kv head
  const int r0 = blockIdx.x * RB;
  const int t = threadIdx.x;
  const int k_end = min(lengths[b], max_pages * ps);
  const int qs0 = q_start[b];
  const long long pt_row = (long long)b * max_pages;

  // row r -> (group head g = r / Sq, q row s = r % Sq)
  for (int idx = t; idx < RB * d; idx += THREADS) {
    const int rr = idx / d, e = idx % d, r = r0 + rr;
    float val = 0.f;
    if (r < R) {
      const int g = r / Sq, s = r % Sq;
      val = ld(q + (((long long)b * H + kvh * G + g) * Sq + s) * d + e);
    }
    Qs[rr * ldk + e] = val;
  }
  int s_lo = Sq, s_hi = -1;               // q rows spanned by this block
  for (int rr = 0; rr < RB && r0 + rr < R; ++rr) {
    const int s = (r0 + rr) % Sq;
    s_lo = min(s_lo, s);
    s_hi = max(s_hi, s);
  }
  const int qp_lo = qs0 + s_lo, qp_hi = qs0 + s_hi;

  const int row = t / TPR, sub = t % TPR;  // score-phase role
  const bool row_ok = r0 + row < R;
  const int qp = qs0 + (row_ok ? (r0 + row) % Sq : 0);
  float m = NEG_INF, l = 0.f;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  const int n_tiles = k_end > 0 ? (k_end + KT - 1) / KT : 0;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * KT;
    const int k_last = min(k0 + KT, k_end) - 1;
    if (causal && k0 > qp_hi) break;                    // above the diagonal
    if (window > 0 && qp_lo - k_last >= window) continue;  // left of window
    __syncthreads();   // the previous tile's Ks/Vs/Ps reads are done
    for (int idx = t; idx < KT * d; idx += THREADS) {
      const int kk = idx / d, e = idx % d, kp = k0 + kk;
      float val = 0.f;
      if (kp < k_end) {
        const int page = pt[pt_row + kp / ps];
        if ((unsigned)page < (unsigned)P)
          val = ld(k_pool + (((long long)page * ps + kp % ps) * KV + kvh) * d
                   + e);
      }
      Ks[kk * ldk + e] = val;
    }
    for (int idx = t; idx < KT * dv; idx += THREADS) {
      const int kk = idx / dv, e = idx % dv, kp = k0 + kk;
      float val = 0.f;
      if (kp < k_end) {
        const int page = pt[pt_row + kp / ps];
        if ((unsigned)page < (unsigned)P)
          val = ld(v_pool + (((long long)page * ps + kp % ps) * KV + kvh) * dv
                   + e);
      }
      Vs[kk * dv + e] = val;
    }
    __syncthreads();

    float sc[KPT];
    bool keep[KPT];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int c = sub + TPR * j;
      const int kp = k0 + c;
      float dot = 0.f;
      for (int e = 0; e < d; ++e) dot += Qs[row * ldk + e] * Ks[c * ldk + e];
      bool ok = row_ok && kp < k_end;
      if (causal) ok = ok && qp >= kp;
      if (window > 0) ok = ok && qp - kp < window;
      keep[j] = ok;
      sc[j] = ok ? dot * scale : NEG_INF;
      mx = fmaxf(mx, sc[j]);
    }
    // the row's TPR threads are neighbouring lanes of one warp
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float m_new = fmaxf(m, mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = keep[j] ? expf(sc[j] - m_new) : 0.f;
      psum += p;
      Ps[row * (KT + 1) + sub + TPR * j] = round_to(p, v_pool);
    }
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, w);
    const float alpha = expf(m - m_new);
    l = alpha * l + psum;
    m = m_new;
    if (sub == 0) alpha_s[row] = alpha;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int idx = t + i * THREADS;
      if (idx < RB * dv) {
        const int rr = idx / dv, c = idx % dv;
        float pv = 0.f;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          pv += Ps[rr * (KT + 1) + kk] * Vs[kk * dv + c];
        acc[i] = acc[i] * alpha_s[rr] + pv;
      }
    }
  }

  if (sub == 0) l_s[row] = fmaxf(l, 1e-30f);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int idx = t + i * THREADS;
    if (idx < RB * dv) {
      const int rr = idx / dv, c = idx % dv, r = r0 + rr;
      if (r < R) {
        const int g = r / Sq, s = r % Sq;
        st(o + (((long long)b * H + kvh * G + g) * Sq + s) * dv + c,
           acc[i] / l_s[rr]);
      }
    }
  }
}

template <typename T, int NACC>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* pt, const int* lengths, const int* q_start,
                   void* o, int B, int H, int Sq, int d, int dv, int P, int ps,
                   int KV, int max_pages, int window, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)(RB + KT) * (d + 1) + (size_t)KT * dv + RB * (KT + 1) + 2 * RB);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_paged_kernel<T, NACC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = (H / KV) * Sq;
  dim3 grid((rows + RB - 1) / RB, KV, B);
  flash_paged_kernel<T, NACC><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, pt, lengths, q_start,
      (T*)o, H, Sq, d, dv, P, ps, KV, max_pages, window, causal, scale);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_dv(const void* q, const void* k_pool, const void* v_pool,
                      const int* pt, const int* lengths, const int* q_start,
                      void* o, int B, int H, int Sq, int d, int dv, int P,
                      int ps, int KV, int max_pages, int window, int causal,
                      float scale, cudaStream_t s) {
#define FP_LAUNCH(N)                                                        \
  return launch<T, N>(q, k_pool, v_pool, pt, lengths, q_start, o, B, H, Sq, \
                      d, dv, P, ps, KV, max_pages, window, causal, scale, s)
  if (dv <= 64) FP_LAUNCH(RB * 64 / THREADS);
  if (dv <= 128) FP_LAUNCH(RB * 128 / THREADS);
  if (dv <= 256) FP_LAUNCH(RB * 256 / THREADS);
  FP_LAUNCH(RB * DVMAX / THREADS);
#undef FP_LAUNCH
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, both pools and o share it). window <= 0 means
// full attention; causal is 0 or 1.
extern "C" int flash_paged_launch(const void* q, const void* k_pool,
                                  const void* v_pool, const void* page_table,
                                  const void* lengths, const void* q_start,
                                  void* o, int B, int H, int Sq, int d, int dv,
                                  int P, int ps, int KV, int max_pages,
                                  int window, int causal, float scale,
                                  int dtype, void* stream) {
  if (B < 1 || Sq < 1 || d < 1 || d > DMAX || dv < 1 || dv > DVMAX ||
      KV < 1 || H < KV || H % KV || P < 1 || ps < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* pt = (const int*)page_table;
  const int* ln = (const int*)lengths;
  const int* qs = (const int*)q_start;
  cudaError_t e;
  if (dtype == 0)
    e = launch_dv<float>(q, k_pool, v_pool, pt, ln, qs, o, B, H, Sq, d, dv, P,
                         ps, KV, max_pages, window, causal, scale, s);
  else if (dtype == 1)
    e = launch_dv<__nv_bfloat16>(q, k_pool, v_pool, pt, ln, qs, o, B, H, Sq,
                                 d, dv, P, ps, KV, max_pages, window, causal,
                                 scale, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
