// The CUDA-core tile bodies of the fused conv K7 (conv_gemm.cu: baseline,
// FIP and FFIP) and of f32 K1 (baseline_gemm.cu). bf16 and int8 K1 run on
// the tensor cores (tc_gemm.cuh); K2 and K3 have their own pipelined pair
// body (fip_body.cuh). A kernel is instantiated with the loader of its A
// operand: DenseA reads a row-major (M, K) matrix, ConvA gathers the
// implicit im2col matrix of a conv from the padded NHWC input (Algorithm 1).
// Everything after the A tile is in shared memory is the same code, so for
// f32 K7's baseline sums exactly what K1 sums over the materialised A, in
// the same order: the two give the same bits. int8 K7 and int8 K1 also give
// the same bits, on different bodies: integer sums are exact in any order.
//
// A row's sums never depend on how many rows share its launch (batch
// invariance):
//   - The baseline and FIP bodies sum all of K in one in-order sweep of
//     k-tiles, as the reference's Pallas kernels do.
//   - The FFIP body splits K by a plan that depends on K only
//     (kernels/conv_gemm.py::split_rows): splits of `rows` rows (16, half a
//     k-tile), each summing its half tiles in k order; consecutive splits
//     form groups whose total sums the splits' partials in order, and the
//     result sums the group totals in order. A CTA ("unit") takes one split
//     or one whole group; that choice is the launch's (small M: one split
//     each, to fill the card; large M: a group each, to save the workspace)
//     and leaves the arithmetic as it is: reduce_units (common.cuh) sums the
//     slots in the same nesting.
#pragma once
#include "common.cuh"

namespace rt {

struct Plan {
  int M, N, K;        // rows of A; output columns of one group; K of B / y
  int ldo;            // row stride of the output and of each workspace slot
  long long b_group;  // elements between the groups of B (or y)
  int fold_beta;
  int rows;           // FFIP: k rows per split
  int spu;            // FFIP: splits per unit (CTA), 1 or a whole group
  int units;          // FFIP: units along K; > 1 means the output is workspace
  long long slot;     // FFIP: elements between workspace slots (M * ldo)
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
// Baseline and FIP bodies: one CTA per (64-column, BM-row) output tile and
// group; all its k-tiles run in order through shared memory, each thread
// keeping a TM x 4 accumulator in registers.
// ---------------------------------------------------------------------------

template <typename In, typename Acc, int TM, bool FIP,
          template <typename, int> class AL>
__device__ __forceinline__ void mac_cta(
    const typename AL<In, TY * TM>::Params& ap, const In* __restrict__ B,
    Acc* __restrict__ out, const Plan& pl) {
  constexpr int BM = TY * TM;
  __shared__ Acc As[BM][BK + 1];
  __shared__ Acc Bs[BK][BN];
  __shared__ Acc alpha_s[BM];
  __shared__ Acc beta_s[BN];
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
    if constexpr (FIP) {
      // Eq. (3) alpha row and Eq. (4) beta column of this tile
      const int t = threadIdx.x;
      if (t < BM) {
        Acc sum = Acc(0);
#pragma unroll 4
        for (int p = 0; p < BK / 2; ++p)
          sum += As[t][2 * p] * As[t][2 * p + 1];
        alpha_s[t] = sum;
      } else if (t < BM + BN) {
        const int c = t - BM;
        Acc sum = Acc(0);
        if (!pl.fold_beta) {
#pragma unroll 4
          for (int p = 0; p < BK / 2; ++p)
            sum += Bs[2 * p][c] * Bs[2 * p + 1][c];
        }
        beta_s[c] = sum;
      }
      __syncthreads();
      Acc cross[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) cross[i][j] = Acc(0);
#pragma unroll 4
      for (int p = 0; p < BK / 2; ++p) {
        Acc ao[TM], ae[TM], bo[TN], be[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          ao[i] = As[ty + TY * i][2 * p];       // a_{i,2k-1}
          ae[i] = As[ty + TY * i][2 * p + 1];   // a_{i,2k}
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          bo[j] = Bs[2 * p][tx + TX * j];       // b_{2k-1,j}
          be[j] = Bs[2 * p + 1][tx + TX * j];   // b_{2k,j}
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            cross[i][j] += (ao[i] + be[j]) * (ae[i] + bo[j]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] +=
              (cross[i][j] - alpha_s[ty + TY * i]) - beta_s[tx + TX * j];
    } else {
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

// The minimum of one block per SM lets ptxas keep the body's 16 accumulators
// and the hoisted tile loads in registers (72 at TM = 4); without it, it
// picks 40 and spills, and K1 at M = 512 runs up to 1.6x slower on the H100.
// (The FIP body is faster as it is.)
template <typename In, typename Acc, int TM, template <typename, int> class AL>
__global__ void __launch_bounds__(THREADS, 1)
baseline_kernel(typename AL<In, TY * TM>::Params ap, const In* __restrict__ B,
                Acc* __restrict__ out, Plan pl) {
  mac_cta<In, Acc, TM, false, AL>(ap, B, out, pl);
}

template <typename In, typename Acc, int TM, template <typename, int> class AL>
__global__ void __launch_bounds__(THREADS)
fip_kernel(typename AL<In, TY * TM>::Params ap, const In* __restrict__ B,
           Acc* __restrict__ out, Plan pl) {
  mac_cta<In, Acc, TM, true, AL>(ap, B, out, pl);
}

// ---------------------------------------------------------------------------
// FFIP body (from the Eq. 9 deltas y). One CTA owns the whole N sweep of
// an (m-block, unit) stripe: it walks the 64-column tiles left to right and
// keeps the prefix carry of each of its k rows in shared memory (a CUDA grid
// runs in no order, so the carry cannot cross CTAs as Pallas carries it
// across its in-order grid). Within a tile each row's prefix is a warp scan,
// b = carry + cumsum(y_tile); then the g terms, the Eq. 7 product-sum minus
// alpha (minus beta unless folded). Half-tile splits (rows = BK / 2) close
// after each 16-row half, so decode (M = slots) has K / 16 units to fill the
// card with; only the half a unit owns is computed.
// ---------------------------------------------------------------------------

// Inclusive warp scan (lane order) of one value.
template <typename Acc>
__device__ __forceinline__ Acc warp_scan(Acc v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Acc u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

template <typename In, typename Acc, int TM, template <typename, int> class AL>
__global__ void __launch_bounds__(THREADS)
ffip_kernel(typename AL<In, TY * TM>::Params ap, const Acc* __restrict__ Y,
            Acc* __restrict__ out, Plan pl) {
  constexpr int BM = TY * TM;
  constexpr int WARPS = THREADS / 32;
  constexpr int ROWS_PER_WARP = BK / WARPS;
  __shared__ Acc As[BM][BK + 1];
  __shared__ Acc Bs[BK][BN];
  __shared__ Acc alpha_s[2][BM];
  __shared__ Acc beta_s[2][BN];
  extern __shared__ __align__(16) unsigned char carry_raw[];
  Acc* carry = reinterpret_cast<Acc*>(carry_raw);   // one per k row of unit

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = blockIdx.x * BM, u = blockIdx.y, g = blockIdx.z;
  const Acc* Yg = Y + (long long)g * pl.b_group;
  const AL<In, BM> A(ap, m0, g);
  const int splits = (pl.K + pl.rows - 1) / pl.rows;
  const int s0 = u * pl.spu, s1 = min(s0 + pl.spu, splits);
  const int k_lo = s0 * pl.rows, k_hi = min(s1 * pl.rows, pl.K);
  const int nseg = pl.rows < BK ? 2 : 1;            // splits closing per tile
  const int seg_pairs = BK / 2 / nseg;
  const int carry_rows = (k_hi - k_lo + BK - 1) / BK * BK;
  Acc* o = out + (long long)u * pl.slot + (long long)g * pl.N;

  for (int r = threadIdx.x; r < carry_rows; r += THREADS) carry[r] = Acc(0);
  __syncthreads();

  for (int n0 = 0; n0 < pl.N; n0 += BN) {     // the in-order N sweep
    Acc acc[TM][TN], tot[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = tot[i][j] = Acc(0);
    bool first = true;

    for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
      // free-pipeline reconstruction of this (BK x BN) weight tile: first
      // the y loads of every row this warp rebuilds, all in flight at once
      Acc y0[ROWS_PER_WARP], y1[ROWS_PER_WARP];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int gk = k0 + warp + WARPS * i;
        y0[i] = Acc(0);
        y1[i] = Acc(0);
        if (gk < k_hi) {
          const long long row = (long long)gk * pl.N;
          if (n0 + lane < pl.N) y0[i] = Yg[row + n0 + lane];
          if (n0 + 32 + lane < pl.N) y1[i] = Yg[row + n0 + 32 + lane];
        }
      }
      A.load(As, k0, k_hi);
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int r = warp + WARPS * i;
        Acc s0v = warp_scan(y0[i], lane);
        Acc s1v = warp_scan(y1[i], lane) + __shfl_sync(0xffffffffu, s0v, 31);
        Acc* c = &carry[k0 - k_lo + r];
        const Acc base = *c;
        Bs[r][lane] = base + s0v;
        Bs[r][32 + lane] = base + s1v;
        __syncwarp();
        if (lane == 31) *c = base + s1v;   // prefix for the next N tile
      }
      __syncthreads();
      const int t = threadIdx.x;
      if (t < BM) {
        for (int h = 0; h < nseg; ++h) {
          Acc sum = Acc(0);
#pragma unroll 4
          for (int q = 0; q < seg_pairs; ++q) {
            const int p = h * seg_pairs + q;
            sum += As[t][2 * p] * As[t][2 * p + 1];
          }
          alpha_s[h][t] = sum;
        }
      } else if (t < BM + BN) {
        const int c = t - BM;
        for (int h = 0; h < nseg; ++h) {
          Acc sum = Acc(0);
          if (!pl.fold_beta) {
#pragma unroll 4
            for (int q = 0; q < seg_pairs; ++q) {
              const int p = h * seg_pairs + q;
              sum += Bs[2 * p][c] * Bs[2 * p + 1][c];
            }
          }
          beta_s[h][c] = sum;
        }
      }
      __syncthreads();

      for (int h = 0; h < nseg; ++h) {
        const int k_seg = k0 + 2 * seg_pairs * h;
        if (k_seg >= k_hi) break;              // a half past the unit's end
        Acc cross[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) cross[i][j] = Acc(0);
#pragma unroll 4
        for (int q = 0; q < seg_pairs; ++q) {
          const int p = h * seg_pairs + q;
          Acc ao[TM], ae[TM], bo[TN], be[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            ao[i] = As[ty + TY * i][2 * p];
            ae[i] = As[ty + TY * i][2 * p + 1];
          }
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            bo[j] = Bs[2 * p][tx + TX * j];
            be[j] = Bs[2 * p + 1][tx + TX * j];
          }
          // g_{i,2k-1} = a_{i,2k} + b_{2k-1,j};
          // g_{i,2k} = a_{i,2k-1} + b_{2k,j}
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              cross[i][j] += (ae[i] + bo[j]) * (ao[i] + be[j]);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] += (cross[i][j] - alpha_s[h][ty + TY * i]) -
                         beta_s[h][tx + TX * j];
        const int k_end = k_seg + 2 * seg_pairs;
        if (k_end % pl.rows == 0 || k_end >= k_hi) {   // a split closes
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              tot[i][j] = first ? acc[i][j] : tot[i][j] + acc[i][j];
              acc[i][j] = Acc(0);
            }
          first = false;
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty + TY * i;
      if (gm >= pl.M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx + TX * j;
        if (gn < pl.N) o[(long long)gm * pl.ldo + gn] = tot[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host-side launchers (the kernel, then the split reduction when the output
// went to workspace slots).
// ---------------------------------------------------------------------------

inline int plan_units(int K, int rows, int spu) {
  const int splits = (K + rows - 1) / rows;
  return (splits + spu - 1) / spu;
}

template <typename In, typename Acc, bool FIP,
          template <typename, int> class AL>
cudaError_t launch_mac(const typename AL<In, TY>::Params& ap, const In* b,
                       Acc* out, const Plan& pl, int groups, int tm,
                       cudaStream_t stream) {
  if (tm != 1 && tm != 4) return cudaErrorInvalidValue;
  const int bm = TY * tm;
  const long long m_blocks = (pl.M + bm - 1) / bm;
  if (m_blocks > 65535 || groups > 65535) return cudaErrorInvalidValue;
  dim3 grid((pl.N + BN - 1) / BN, (unsigned)m_blocks, groups);
  if (tm == 4) {
    if constexpr (FIP)
      fip_kernel<In, Acc, 4, AL><<<grid, THREADS, 0, stream>>>(ap, b, out, pl);
    else
      baseline_kernel<In, Acc, 4, AL><<<grid, THREADS, 0, stream>>>(ap, b,
                                                                   out, pl);
  } else {
    if constexpr (FIP)
      fip_kernel<In, Acc, 1, AL><<<grid, THREADS, 0, stream>>>(ap, b, out, pl);
    else
      baseline_kernel<In, Acc, 1, AL><<<grid, THREADS, 0, stream>>>(ap, b,
                                                                   out, pl);
  }
  return cudaGetLastError();
}

template <typename In, typename Acc, int TM,
          template <typename, int> class AL>
static cudaError_t launch_ffip_tm(dim3 grid, size_t smem, cudaStream_t stream,
                                  const typename AL<In, TY>::Params& ap,
                                  const Acc* y, Acc* dst, const Plan& pl) {
  auto kern = ffip_kernel<In, Acc, TM, AL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, THREADS, smem, stream>>>(ap, y, dst, pl);
  return cudaGetLastError();
}

template <typename In, typename Acc, template <typename, int> class AL>
cudaError_t launch_ffip(const typename AL<In, TY>::Params& ap, const Acc* y,
                        Acc* ws, Acc* out, Plan pl, int groups, int tm,
                        int red_gsz, cudaStream_t stream) {
  if (!(pl.rows == BK / 2 || (pl.rows > 0 && pl.rows % BK == 0)) ||
      pl.spu <= 0 || (tm != 1 && tm != 4) || groups > 65535)
    return cudaErrorInvalidValue;
  pl.units = plan_units(pl.K, pl.rows, pl.spu);
  pl.slot = (long long)pl.M * pl.ldo;
  if (pl.units > 65535) return cudaErrorInvalidValue;
  const int bm = TY * tm;
  Acc* dst = pl.units > 1 ? ws : out;
  dim3 grid((pl.M + bm - 1) / bm, pl.units, groups);
  const size_t smem =
      (size_t)((pl.spu * pl.rows + BK - 1) / BK * BK) * sizeof(Acc);
  cudaError_t e =
      tm == 4 ? launch_ffip_tm<In, Acc, 4, AL>(grid, smem, stream, ap, y, dst,
                                               pl)
              : launch_ffip_tm<In, Acc, 1, AL>(grid, smem, stream, ap, y, dst,
                                               pl);
  if (e != cudaSuccess) return e;
  launch_reduce<Acc>(ws, out, pl.units, red_gsz, pl.slot, stream);
  return cudaGetLastError();
}

}  // namespace rt
