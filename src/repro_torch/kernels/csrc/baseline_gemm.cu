// K1: baseline blocked GEMM, (M, K) x (K, N) -> (M, N) in the accumulation
// type. Replaces the Pallas kernel repro/kernels/baseline_gemm.py::baseline_gemm
// (_kernel). bf16 and f32 operands accumulate in f32 on the CUDA cores (never
// TF32), int8 in int32.
//
// Design: one CTA per (64-column, BM-row) output tile and k-split; the k-tiles
// of its split run in order through shared memory, each thread keeping a
// TM x 4 accumulator in registers. A split-K grid keeps the card full when
// M x N alone gives too few tiles (decode: M = slots); the splits are summed
// by a second, deterministic pass. Bound on this card: bytes at decode (each
// weight byte is used M times), CUDA-core operations at prefill.
#include "common.cuh"

using namespace rt;

template <typename In, typename Acc, int TM>
__global__ void __launch_bounds__(THREADS)
baseline_kernel(const In* __restrict__ A, const In* __restrict__ B,
                Acc* __restrict__ out, int M, int N, int K,
                int tiles_per_split) {
  constexpr int BM = TY * TM;
  __shared__ Acc As[BM][BK + 1];
  __shared__ Acc Bs[BK][BN];
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
                   int N, int K, int tiles_per_split, int tm,
                   cudaStream_t stream) {
  const int k_tiles = (K + BK - 1) / BK;
  const int splits = (k_tiles + tiles_per_split - 1) / tiles_per_split;
  Acc* dst = splits > 1 ? (Acc*)ws : (Acc*)out;
  const int bm = TY * tm;
  dim3 grid((N + BN - 1) / BN, (M + bm - 1) / bm, splits);
  if (tm == 4)
    baseline_kernel<In, Acc, 4><<<grid, THREADS, 0, stream>>>(
        (const In*)a, (const In*)b, dst, M, N, K, tiles_per_split);
  else
    baseline_kernel<In, Acc, 1><<<grid, THREADS, 0, stream>>>(
        (const In*)a, (const In*)b, dst, M, N, K, tiles_per_split);
  launch_reduce<Acc>((const Acc*)ws, (Acc*)out, splits, (long long)M * N,
                     stream);
}

// dtype: 0 = f32 x f32 -> f32, 1 = bf16 x bf16 -> f32, 2 = int8 x int8 -> int32.
// ws holds (splits, M, N) partials when the k-axis is split, else unused.
extern "C" int baseline_gemm_launch(const void* a, const void* b, void* ws,
                                    void* out, int M, int N, int K,
                                    int tiles_per_split, int dtype, int tm,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    launch<float, float>(a, b, ws, out, M, N, K, tiles_per_split, tm, s);
  else if (dtype == 1)
    launch<__nv_bfloat16, float>(a, b, ws, out, M, N, K, tiles_per_split, tm, s);
  else if (dtype == 2)
    launch<int8_t, int>(a, b, ws, out, M, N, K, tiles_per_split, tm, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
