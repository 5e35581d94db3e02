// The CUDA-core tile body of f32 K1 (baseline_gemm.cu) and of K7's baseline
// (conv_gemm.cu), never TF32. bf16 and int8 K1 run on the tensor cores
// (tc_gemm.cuh); K2, K3 and K7's FIP and FFIP run on the pipelined pair body
// (fip_body.cuh). The kernel is instantiated with the loader of its A
// operand: DenseA reads a row-major (M, K) matrix, ConvA gathers the implicit
// im2col matrix of a conv from the padded NHWC input (Algorithm 1).
// Everything after the A tile is in shared memory is the same code, so for
// f32 K7's baseline sums exactly what K1 sums over the materialised A, in
// the same order: the two give the same bits. int8 K7 and int8 K1 also give
// the same bits, on different bodies: integer sums are exact in any order.
//
// A row's sums never depend on how many rows share its launch (batch
// invariance): the body sums all of K in one in-order sweep of k-tiles, as
// the reference's Pallas kernel does.
#pragma once
#include "common.cuh"

namespace rt {

struct Plan {
  int M, N, K;        // rows of A; output columns of one group; K of B
  int ldo;            // row stride of the output
  long long b_group;  // elements between the groups of B
};

// ---------------------------------------------------------------------------
// A-operand loaders. Each thread always loads column threadIdx.x % BK of the
// tile (THREADS is a multiple of BK), rows threadIdx.x / BK + 8 i.
// ---------------------------------------------------------------------------

template <typename In>
struct DenseParams {
  const In* a;   // row-major (M, K)
  int M, K;
};

template <typename In, int ROWS>
struct DenseA {
  using Params = DenseParams<In>;
  const In* a;
  int M, K, m0;
  __device__ DenseA(const Params& p, int m0_, int /*group*/)
      : a(p.a), M(p.M), K(p.K), m0(m0_) {}
  template <typename Acc>
  __device__ __forceinline__ void load(Acc (*As)[BK + 1], int k0,
                                       int k_end) const {
    load_a_tile<ROWS, BK + 1>(As, a, M, K, k_end, m0, k0);
  }
};

// Conv geometry: the input is NHWC, already spatially padded to (h, w);
// M = batch * oh * ow output pixels (the batch is folded into M); the A
// column k < k_real is (kh, kw, c) = the group's channel c at kernel offset
// (kh, kw); columns from k_real on (the evenized K) read as zero.
template <typename In>
struct ConvParams {
  const In* x;
  int M, h, w, cin, cin_g, kw, sh, sw, oh, ow, k_real;
};

// Algorithm 1's multi-digit counter, split as the hardware splits it: the
// address is (row base of the output pixel) + (column offset of k). A thread
// computes the bases of its tile rows once per CTA and the offset of its
// column once per k-tile, so no division runs per element.
template <typename In, int ROWS>
struct ConvA {
  using Params = ConvParams<In>;
  static constexpr int RPT = ROWS * BK / THREADS;   // rows per thread
  const In* x;
  int cin, cin_g, kw, w, g_off, k_real;
  int base[RPT];   // -1 for rows past M
  __device__ ConvA(const Params& p, int m0, int group)
      : x(p.x), cin(p.cin), cin_g(p.cin_g), kw(p.kw), w(p.w),
        g_off(group * p.cin_g), k_real(p.k_real) {
    const int per_img = p.oh * p.ow;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int m = m0 + threadIdx.x / BK + (THREADS / BK) * i;
      if (m < p.M) {
        const int b = m / per_img, r = m - b * per_img;
        const int oh = r / p.ow, ow = r - oh * p.ow;
        base[i] = ((b * p.h + oh * p.sh) * p.w + ow * p.sw) * p.cin;
      } else {
        base[i] = -1;
      }
    }
  }
  template <typename Acc>
  __device__ __forceinline__ void load(Acc (*As)[BK + 1], int k0,
                                       int k_end) const {
    const int c = threadIdx.x % BK, k = k0 + c;
    const bool kv = k < k_end && k < k_real;
    int off = 0;
    if (kv) {
      const int row_len = kw * cin_g;
      const int kh_i = k / row_len, rem = k - kh_i * row_len;
      const int kw_i = rem / cin_g;
      off = (kh_i * w + kw_i) * cin + g_off + (rem - kw_i * cin_g);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = threadIdx.x / BK + (THREADS / BK) * i;
      As[r][c] = (kv && base[i] >= 0) ? cvt<Acc, In>(x[base[i] + off])
                                      : Acc(0);
    }
  }
};

// ---------------------------------------------------------------------------
// The body: one CTA per (64-column, BM-row) output tile and group; all its
// k-tiles run in order through shared memory, each thread keeping a TM x 4
// accumulator in registers.
// ---------------------------------------------------------------------------

// The minimum of one block per SM lets ptxas keep the body's 16 accumulators
// and the hoisted tile loads in registers (72 at TM = 4); without it, it
// picks 40 and spills, and K1 at M = 512 runs up to 1.6x slower on the H100.
template <typename In, typename Acc, int TM, template <typename, int> class AL>
__global__ void __launch_bounds__(THREADS, 1)
baseline_kernel(typename AL<In, TY * TM>::Params ap, const In* __restrict__ B,
                Acc* __restrict__ out, Plan pl) {
  constexpr int BM = TY * TM;
  __shared__ Acc As[BM][BK + 1];
  __shared__ Acc Bs[BK][BN];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int g = blockIdx.z;
  const In* Bg = B + (long long)g * pl.b_group;
  const AL<In, BM> A(ap, m0, g);

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < pl.K; k0 += BK) {
    A.load(As, k0, pl.K);
    load_b_tile(Bs, Bg, pl.K, pl.N, k0, n0);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      Acc a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[ty + TY * i][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  Acc* o = out + (long long)g * pl.N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + TY * i;
    if (gm >= pl.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + TX * j;
      if (gn < pl.N) o[(long long)gm * pl.ldo + gn] = acc[i][j];
    }
  }
}

template <typename In, typename Acc, template <typename, int> class AL>
cudaError_t launch_mac(const typename AL<In, TY>::Params& ap, const In* b,
                       Acc* out, const Plan& pl, int groups, int tm,
                       cudaStream_t stream) {
  if (tm != 1 && tm != 4) return cudaErrorInvalidValue;
  const int bm = TY * tm;
  const long long m_blocks = (pl.M + bm - 1) / bm;
  if (m_blocks > 65535 || groups > 65535) return cudaErrorInvalidValue;
  dim3 grid((pl.N + BN - 1) / BN, (unsigned)m_blocks, groups);
  if (tm == 4)
    baseline_kernel<In, Acc, 4, AL><<<grid, THREADS, 0, stream>>>(ap, b, out,
                                                                 pl);
  else
    baseline_kernel<In, Acc, 1, AL><<<grid, THREADS, 0, stream>>>(ap, b, out,
                                                                 pl);
  return cudaGetLastError();
}

}  // namespace rt
