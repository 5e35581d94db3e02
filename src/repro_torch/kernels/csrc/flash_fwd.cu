// K4: flash-attention forward (FlashAttention-2 online softmax). Replaces the
// Pallas kernel repro/kernels/flash_attention.py::_flash_fwd (_fwd_kernel).
//
// q: (BH, Sq, d), k/v: (BH, Sk, d) -> o: (BH, Sq, d) in q's type, lse: (BH, Sq)
// f32. Causal masking and a sliding window (a runtime int; <= 0 means full
// attention) on positions q_pos = row, k_pos = column, as the reference.
// Masked scores are -1e30 and their p is zeroed after exp, and l is clamped
// at 1e-30, so a fully masked row gives exactly 0 (reference lines 58-62,
// 74); lse = m + log(l). Key blocks wholly above the diagonal or wholly
// outside the window are skipped, which is exact (they would leave m, l and
// the output as they are). Scores never reach device memory: q, k, v and o
// cross it once each, and at the served and trained shapes (S 16-256, d 64)
// those bytes bound the kernel.
//
// bf16 (serving and training), on the tensor cores: the reference's own
// function, both products bf16 x bf16 into f32 (mma.sync m16n8k16). One CTA
// takes 16 query rows a warp (4 warps, or 1-2 when Sq is 16-32) and walks the
// key blocks its rows can keep, 64 keys at a time, K and V in a cp.async
// double buffer in shared memory. A warp loads its q fragments once
// (ldmatrix), forms s = q k^T in registers, keeps the online softmax (m, and
// each thread's share of l, summed from the unrounded f32 p) in registers,
// rounds p to bf16 as the reference does before PV (line 66) and feeds the
// accumulator registers straight into the A fragments of PV, with v's
// fragments by ldmatrix.trans. Only the summation order differs from the
// plain version. Templated on (D, DV), the widths of q/k and of v in shared
// memory (v's width passed apart from q's), instantiated at (64, 64) and
// (128, 128): a narrower d runs zero-filled to the next, which is exact
// (zero columns add nothing to s, and o's extra columns are not written).
//
// f32 keeps the CUDA-core kernel, the only exact-f32 route (no TF32): one
// CTA per (bh, 32-row q block), 32-key blocks, q, the k/v block and p in
// shared memory, four threads a row.
#include <math.h>

#include "flash_tc.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BQ = 32;
constexpr int BKV = 32;
constexpr int THREADS = 128;   // 4 threads per q row
constexpr int DMAX = 128;

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
        (q0 + rr < Sq) ? q[qbase + (long long)(q0 + rr) * d + c] : 0.f;
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
      Ks[rr * ld_qk + c] = ok ? k[g] : 0.f;
      Vs[rr * d + c] = ok ? v[g] : 0.f;
    }
    __syncthreads();

    float s[BKV / 4];
    bool keep[BKV / 4];
    float mx = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < BKV / 4; ++jj) {
      const int c = sub + 4 * jj;
      float dot = 0.f;
      for (int e = 0; e < d; ++e) dot += Qs[r * ld_qk + e] * Ks[c * ld_qk + e];
      const int kp = k0 + c;
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
      Ps[r * (BKV + 1) + sub + 4 * jj] = p;
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
      if (c < d) o[qbase + (long long)qp * d + c] = acc[jd] / lc;
    }
    if (sub == 0) lse[(long long)bh * Sq + qp] = m + logf(lc);
  }
}

cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int BH, int Sq, int Sk, int d, int window,
                   int causal, float scale, cudaStream_t stream) {
  size_t smem = sizeof(float) *
                ((size_t)BQ * (d + 1) + BKV * (d + 1) + BKV * d + BQ * (BKV + 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_fwd_kernel<<<grid, THREADS, smem, stream>>>(q, k, v, o, lse, Sq, Sk,
                                                    d, window, causal, scale);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------
namespace tc {

using ftc::bf16;
using ftc::pitch;
constexpr int BKV = 64;       // keys a step

struct Args {
  const bf16 *q, *k, *v;
  bf16* o;
  float* lse;
  int Sq, Sk, d, dv_w, window, causal;
  float scale;
  int vec;   // d, dv % 8 == 0 and 16-byte bases: cp.async rows
};

template <int D, int DV, int WARPS>
constexpr int smem_bytes() {
  return 16 * WARPS * pitch(D) + 2 * BKV * (pitch(D) + pitch(DV));
}

template <int D, int DV, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
flash_fwd_tc_kernel(Args p) {
  constexpr int THREADS = 32 * WARPS, BQ = 16 * WARPS;
  constexpr int K_BYTES = BKV * pitch(D), SLOT = K_BYTES + BKV * pitch(DV);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* ring = Qs + BQ * pitch(D);        // 2 x (K, V)

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4;
  const bf16* qb = p.q + (long long)bh * p.Sq * p.d;
  const bf16* kb = p.k + (long long)bh * p.Sk * p.d;
  const bf16* vb = p.v + (long long)bh * p.Sk * p.dv_w;
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  // key blocks that a row of this block can keep
  const int k_begin =
      p.window > 0 ? (max(0, q0 - p.window + 1) / BKV) * BKV : 0;
  const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int nsteps = k_end > k_begin ? (k_end - k_begin + BKV - 1) / BKV : 0;
  auto issue = [&](int t) {
    if (t < nsteps) {
      unsigned char* r = ring + (t % 2) * SLOT;
      const int k0 = k_begin + t * BKV;
      ftc::load_tile<BKV, D, THREADS>(r, kb, k0, p.Sk, p.d, p.vec);
      ftc::load_tile<BKV, DV, THREADS>(r + K_BYTES, vb, k0, p.Sk, p.dv_w,
                                       p.vec);
    }
    rt::cp_async_commit();
  };

  ftc::load_tile<BQ, D, THREADS>(Qs, qb, q0, p.Sq, p.d, p.vec);
  issue(0);                      // q and the first K/V block: one group

  const int row0 = warp * 16;
  const int rows[2] = {q0 + row0 + g, q0 + row0 + g + 8};
  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};       // this thread's share of each row's l
  unsigned qf[D / 16][4];

  for (int t = 0; t < nsteps; ++t) {
    issue(t + 1);
    rt::cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ftc::frag_a<D>(qf[kk], Qs, row0, kk * 16, lane);
    }
    const unsigned char* Ks = ring + (t % 2) * SLOT;
    const unsigned char* Vs = Ks + K_BYTES;
    const int k0 = k_begin + t * BKV;

    // s = q k^T (f32), scaled; masked entries -1e30
    float s[BKV / 8][4];
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < BKV / 16; ++nb)
        ftc::mma_nk<D>(s[2 * nb], s[2 * nb + 1], qf[kk], Ks, nb * 16,
                       kk * 16, lane);
    unsigned keep = 0;             // bit n * 4 + c: entry kept
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + n * 8 + 2 * tq + (c & 1);
        const bool ok =
            ftc::kept(rows[c >> 1], kp, p.Sq, p.Sk, p.window, p.causal);
        keep |= (unsigned)ok << (n * 4 + c);
        s[n][c] = ok ? s[n][c] * p.scale : NEG_INF;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
      }
    // the rows' new maxima: each row's 64 entries lie on a quad of lanes
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = __expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
    // p = exp(s - m), 0 where masked; l from the f32 p
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pv =
            (keep >> (n * 4 + c)) & 1u ? __expf(s[n][c] - m[c >> 1]) : 0.f;
        s[n][c] = pv;
        l[c >> 1] += pv;
      }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] *= alpha[c >> 1];
    // o += bf16(p) v: two accumulator tiles of p are one A fragment
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const unsigned a[4] = {ftc::pack(s[2 * kk][0], s[2 * kk][1]),
                             ftc::pack(s[2 * kk][2], s[2 * kk][3]),
                             ftc::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             ftc::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nb = 0; nb < DV / 16; ++nb) {
        unsigned b[4];
        rt::ldsm_x4_t(b, Vs + (kk * 16 + (lane & 15)) * pitch(DV) +
                             (nb * 16 + (lane >> 4) * 8) * 2);
        rt::mma(o[2 * nb], a, b[0], b[1]);
        rt::mma(o[2 * nb + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();   // the ring slot is refilled next
  }
  rt::cp_async_wait<0>();

  float lc[2];                   // l, clamped at 1e-30
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    lc[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= p.Sq) continue;
    bf16* orow = p.o + ((long long)bh * p.Sq + row) * p.dv_w;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int col = n * 8 + 2 * tq;
      const float x0 = o[n][2 * h] / lc[h], x1 = o[n][2 * h + 1] / lc[h];
      if (col + 1 < p.dv_w && p.vec)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      else {
        if (col < p.dv_w) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < p.dv_w) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
    if (tq == 0) p.lse[(long long)bh * p.Sq + row] = m[h] + logf(lc[h]);
  }
}

template <int D, int DV, int WARPS>
cudaError_t launch_tc(const Args& p, int BH, cudaStream_t stream) {
  constexpr int SMEM = smem_bytes<D, DV, WARPS>();
  if (SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<D, DV, WARPS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((p.Sq + 16 * WARPS - 1) / (16 * WARPS), BH);
  flash_fwd_tc_kernel<D, DV, WARPS><<<grid, 32 * WARPS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

// Warps a CTA by Sq: 16 rows a warp, so Sq 16 and 32 (the shortest served
// buckets) leave no warp without a row.
template <int D, int DV>
cudaError_t launch_d(const Args& p, int BH, cudaStream_t stream) {
  if (p.Sq <= 16) return launch_tc<D, DV, 1>(p, BH, stream);
  if (p.Sq <= 32) return launch_tc<D, DV, 2>(p, BH, stream);
  return launch_tc<D, DV, 4>(p, BH, stream);
}

}  // namespace tc
}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and o share it; lse is f32).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int BH, int Sq, int Sk,
                                int d, int window, int causal, float scale,
                                int dtype, void* stream) {
  if (d < 1 || d > f32::DMAX || BH < 1 || BH > 65535 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)f32::launch((const float*)q, (const float*)k, (const float*)v,
                            (float*)o, (float*)lse, BH, Sq, Sk, d, window,
                            causal, scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, o};
  bool aligned = d % 8 == 0;
  for (const void* ptr : ptrs) aligned = aligned && (uintptr_t)ptr % 16 == 0;
  tc::Args p{(const ftc::bf16*)q, (const ftc::bf16*)k, (const ftc::bf16*)v,
             (ftc::bf16*)o, (float*)lse, Sq, Sk, d, d, window, causal,
             scale, (int)aligned};
  if (d <= 64) return (int)tc::launch_d<64, 64>(p, BH, s);
  return (int)tc::launch_d<128, 128>(p, BH, s);
}
