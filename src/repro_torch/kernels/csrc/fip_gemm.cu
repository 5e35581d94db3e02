// K2: FIP GEMM (Eq. 2, Winograd 1968). Replaces the Pallas kernel
// repro/kernels/fip_gemm.py::fip_gemm (_kernel, fip_tile).
//
// Per (BM x 32) x (32 x 64) tile, exactly as fip_tile: the pair product-sum
//   cross_ij = sum_k (a_{i,2k-1} + b_{2k,j}) (a_{i,2k} + b_{2k-1,j}),
// then part = cross - alpha_i (- beta_j unless fold_beta), then out += part.
// The pre-add couples i and j, so it has no tensor-core mapping: this is a
// CUDA-core kernel that walks the pairs in registers and never builds the
// (bm, bk/2, bn) cross tensor. alpha (Eq. 3) and beta (Eq. 4) of the tile are
// computed once per tile into shared memory. Accumulates in f32 for bf16/f32
// operands and in int32 for int8 (exact). Bound on this card: CUDA-core
// operations (2 pre-adds + 1 multiply + 1 add per pair) at prefill, bytes at
// decode. A split-K grid plus a deterministic second pass fills the card at
// small M.
#include "common.cuh"

using namespace rt;

template <typename In, typename Acc, int TM>
__global__ void __launch_bounds__(THREADS)
fip_kernel(const In* __restrict__ A, const In* __restrict__ B,
           Acc* __restrict__ out, int M, int N, int K, int tiles_per_split,
           int fold_beta) {
  constexpr int BM = TY * TM;
  __shared__ Acc As[BM][BK + 1];
  __shared__ Acc Bs[BK][BN];
  __shared__ Acc alpha_s[BM];
  __shared__ Acc beta_s[BN];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_tiles = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, k_tiles);

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int kt = kt0; kt < kt1; ++kt) {
    load_a_tile<BM, BK + 1>(As, A, M, K, K, m0, kt * BK);
    load_b_tile(Bs, B, K, N, kt * BK, n0);
    __syncthreads();
    // Eq. (3) alpha row and Eq. (4) beta column of this tile
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
        acc[i][j] += (cross[i][j] - alpha_s[ty + TY * i]) - beta_s[tx + TX * j];
    __syncthreads();
  }

  Acc* o = out + (long long)blockIdx.z * M * N;
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

template <typename In, typename Acc>
static void launch(const void* a, const void* b, void* ws, void* out, int M,
                   int N, int K, int tiles_per_split, int tm, int fold_beta,
                   cudaStream_t stream) {
  const int k_tiles = (K + BK - 1) / BK;
  const int splits = (k_tiles + tiles_per_split - 1) / tiles_per_split;
  Acc* dst = splits > 1 ? (Acc*)ws : (Acc*)out;
  const int bm = TY * tm;
  dim3 grid((N + BN - 1) / BN, (M + bm - 1) / bm, splits);
  if (tm == 4)
    fip_kernel<In, Acc, 4><<<grid, THREADS, 0, stream>>>(
        (const In*)a, (const In*)b, dst, M, N, K, tiles_per_split, fold_beta);
  else
    fip_kernel<In, Acc, 1><<<grid, THREADS, 0, stream>>>(
        (const In*)a, (const In*)b, dst, M, N, K, tiles_per_split, fold_beta);
  launch_reduce<Acc>((const Acc*)ws, (Acc*)out, splits, (long long)M * N,
                     stream);
}

// dtype: 0 = f32, 1 = bf16 (both accumulate in f32), 2 = int8 (int32).
extern "C" int fip_gemm_launch(const void* a, const void* b, void* ws,
                               void* out, int M, int N, int K,
                               int tiles_per_split, int dtype, int tm,
                               int fold_beta, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    launch<float, float>(a, b, ws, out, M, N, K, tiles_per_split, tm,
                         fold_beta, s);
  else if (dtype == 1)
    launch<__nv_bfloat16, float>(a, b, ws, out, M, N, K, tiles_per_split, tm,
                                 fold_beta, s);
  else if (dtype == 2)
    launch<int8_t, int>(a, b, ws, out, M, N, K, tiles_per_split, tm,
                        fold_beta, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
