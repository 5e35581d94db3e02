// K3: FFIP GEMM from the Eq. 9 weight deltas y (f32 for float weights, int32
// for int8). Replaces the Pallas kernel repro/kernels/ffip_gemm.py::ffip_gemm_y
// (_kernel, ffip_tile).
//
// FFIP rebuilds the weights by a column prefix sum of y carried across the N
// sweep: b_{k,j} = b_{k,j-1} + y_{k,j} (Eq. 8c). Pallas carries that prefix in
// a (bk, 1) VMEM scratch and relies on the TPU running the grid in order. A
// CUDA grid gives no order, so here ONE CTA owns the whole N sweep of an
// (m-block, k-split) stripe: it walks the 64-column tiles left to right and
// keeps the carry of each of its k rows in shared memory. Within a tile each
// row's prefix is a warp scan, b = carry + cumsum(y_tile) as ffip_tile forms
// it; then the g terms (Eqs. 8a/8b: pair-swapped a plus b), the Eq. 7
// product-sum, minus alpha (minus beta unless folded). The kernel reads y
// only, never B. The k-splits write partials that a second small pass sums in
// split order (no float atomics, so results are deterministic).
// Bound on this card: bytes of y at decode (y is f32: twice the bf16 weight
// bytes), CUDA-core operations at prefill. At decode the N sweep is serial,
// so its per-tile latency sets the time: a k-split may be as short as 16 rows
// (half a tile; rows past the split's end load as zero, which is exact) so
// that decode (M = slots) still has enough CTAs to fill the card, and each
// warp issues the y loads of all its tile rows before scanning any.
#include "common.cuh"

using namespace rt;

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

template <typename In, typename Acc, int TM>
__global__ void __launch_bounds__(THREADS)
ffip_kernel(const In* __restrict__ A, const Acc* __restrict__ Y,
            Acc* __restrict__ out, int M, int N, int K, int k_per_split,
            int fold_beta) {
  constexpr int BM = TY * TM;
  constexpr int WARPS = THREADS / 32;
  constexpr int ROWS_PER_WARP = BK / WARPS;
  __shared__ Acc As[BM][BK + 1];
  __shared__ Acc Bs[BK][BN];
  __shared__ Acc alpha_s[BM];
  __shared__ Acc beta_s[BN];
  extern __shared__ __align__(16) unsigned char carry_raw[];
  Acc* carry = reinterpret_cast<Acc*>(carry_raw);   // one per k row of split

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = blockIdx.x * BM;
  const int k_lo = blockIdx.y * k_per_split;        // even: whole pairs
  const int k_hi = min(k_lo + k_per_split, K);
  const int carry_rows = (k_hi - k_lo + BK - 1) / BK * BK;
  Acc* o = out + (long long)blockIdx.y * M * N;

  for (int r = threadIdx.x; r < carry_rows; r += THREADS) carry[r] = Acc(0);
  __syncthreads();

  for (int n0 = 0; n0 < N; n0 += BN) {     // the in-order N sweep
    Acc acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

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
          const long long row = (long long)gk * N;
          if (n0 + lane < N) y0[i] = Y[row + n0 + lane];
          if (n0 + 32 + lane < N) y1[i] = Y[row + n0 + 32 + lane];
        }
      }
      load_a_tile<BM, BK + 1>(As, A, M, K, k_hi, m0, k0);
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int r = warp + WARPS * i;
        Acc s0 = warp_scan(y0[i], lane);
        Acc s1 = warp_scan(y1[i], lane) + __shfl_sync(0xffffffffu, s0, 31);
        Acc* c = &carry[k0 - k_lo + r];
        const Acc base = *c;
        Bs[r][lane] = base + s0;
        Bs[r][32 + lane] = base + s1;
        __syncwarp();
        if (lane == 31) *c = base + s1;   // prefix for the next N tile
      }
      __syncthreads();
      const int t = threadIdx.x;
      if (t < BM) {
        Acc s = Acc(0);
#pragma unroll 4
        for (int p = 0; p < BK / 2; ++p) s += As[t][2 * p] * As[t][2 * p + 1];
        alpha_s[t] = s;
      } else if (t < BM + BN) {
        const int c = t - BM;
        Acc s = Acc(0);
        if (!fold_beta) {
#pragma unroll 4
          for (int p = 0; p < BK / 2; ++p) s += Bs[2 * p][c] * Bs[2 * p + 1][c];
        }
        beta_s[c] = s;
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
          ao[i] = As[ty + TY * i][2 * p];
          ae[i] = As[ty + TY * i][2 * p + 1];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          bo[j] = Bs[2 * p][tx + TX * j];
          be[j] = Bs[2 * p + 1][tx + TX * j];
        }
        // g_{i,2k-1} = a_{i,2k} + b_{2k-1,j}; g_{i,2k} = a_{i,2k-1} + b_{2k,j}
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
          acc[i][j] +=
              (cross[i][j] - alpha_s[ty + TY * i]) - beta_s[tx + TX * j];
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      int gm = m0 + ty + TY * i;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        int gn = n0 + tx + TX * j;
        if (gn < N) o[(long long)gm * N + gn] = acc[i][j];
      }
    }
  }
}

template <typename In, typename Acc, int TM>
static cudaError_t launch_tm(dim3 grid, size_t smem, cudaStream_t stream,
                             const void* a, const void* y, Acc* dst, int M,
                             int N, int K, int k_per_split, int fold_beta) {
  auto kern = ffip_kernel<In, Acc, TM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, THREADS, smem, stream>>>((const In*)a, (const Acc*)y, dst, M, N,
                                        K, k_per_split, fold_beta);
  return cudaSuccess;
}

template <typename In, typename Acc>
static cudaError_t launch(const void* a, const void* y, void* ws, void* out,
                          int M, int N, int K, int k_per_split, int tm,
                          int fold_beta, cudaStream_t stream) {
  if (k_per_split < 2 || k_per_split % 2) return cudaErrorInvalidValue;
  const int splits = (K + k_per_split - 1) / k_per_split;
  Acc* dst = splits > 1 ? (Acc*)ws : (Acc*)out;
  const int bm = TY * tm;
  dim3 grid((M + bm - 1) / bm, splits);
  size_t smem = (size_t)((k_per_split + BK - 1) / BK * BK) * sizeof(Acc);
  cudaError_t e =
      tm == 4 ? launch_tm<In, Acc, 4>(grid, smem, stream, a, y, dst, M, N, K,
                                      k_per_split, fold_beta)
              : launch_tm<In, Acc, 1>(grid, smem, stream, a, y, dst, M, N, K,
                                      k_per_split, fold_beta);
  if (e != cudaSuccess) return e;
  launch_reduce<Acc>((const Acc*)ws, (Acc*)out, splits, (long long)M * N,
                     stream);
  return cudaSuccess;
}

// dtype: 0 = f32 a with f32 y, 1 = bf16 a with f32 y, 2 = int8 a with int32 y.
// k_per_split (even) rows of K per CTA; ws holds the (splits, M, N) partials.
extern "C" int ffip_gemm_launch(const void* a, const void* y, void* ws,
                                void* out, int M, int N, int K,
                                int k_per_split, int dtype, int tm,
                                int fold_beta, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (dtype == 0)
    e = launch<float, float>(a, y, ws, out, M, N, K, k_per_split, tm,
                             fold_beta, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16, float>(a, y, ws, out, M, N, K, k_per_split,
                                     tm, fold_beta, s);
  else if (dtype == 2)
    e = launch<int8_t, int>(a, y, ws, out, M, N, K, k_per_split, tm,
                            fold_beta, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
