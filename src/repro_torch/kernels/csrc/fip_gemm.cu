// K2: FIP GEMM (Eq. 2, Winograd 1968). Replaces the Pallas kernel
// repro/kernels/fip_gemm.py::fip_gemm (_kernel, fip_tile).
//
// Per (BM x 32) x (32 x 64) tile, exactly as fip_tile: the pair product-sum
//   cross_ij = sum_k (a_{i,2k-1} + b_{2k,j}) (a_{i,2k} + b_{2k-1,j}),
// then part = cross - alpha_i (- beta_j unless fold_beta), then out += part
// (the body is gemm_kernels.cuh::mac_cta, shared with K7). The pre-add
// couples i and j, so it has no tensor-core mapping: this is a CUDA-core
// kernel that walks the pairs in registers and never builds the
// (bm, bk/2, bn) cross tensor. alpha (Eq. 3) and beta (Eq. 4) of the tile are
// computed once per tile into shared memory. Accumulates in f32 for bf16/f32
// operands and in int32 for int8 (exact). Bound on this card: CUDA-core
// operations (2 pre-adds + 1 multiply + 1 add per pair) at prefill, bytes at
// decode. K is never split, as in K1 (baseline_gemm.cu): batch-invariant.
#include "gemm_kernels.cuh"

using namespace rt;

template <typename In, typename Acc>
static int launch(const void* a, const void* b, void* out, int M, int N,
                  int K, int tm, int fold_beta, cudaStream_t stream) {
  DenseParams<In> ap{(const In*)a, M, K};
  Plan pl{M, N, K, N, 0, fold_beta, 0, 0, 0, 0};
  return (int)launch_mac<In, Acc, true, DenseA>(ap, (const In*)b, (Acc*)out,
                                                pl, 1, tm, stream);
}

// dtype: 0 = f32, 1 = bf16 (both accumulate in f32), 2 = int8 (int32).
extern "C" int fip_gemm_launch(const void* a, const void* b, void* out, int M,
                               int N, int K, int dtype, int tm, int fold_beta,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, float>(a, b, out, M, N, K, tm, fold_beta, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, float>(a, b, out, M, N, K, tm, fold_beta, s);
  if (dtype == 2)
    return launch<int8_t, int>(a, b, out, M, N, K, tm, fold_beta, s);
  return (int)cudaErrorInvalidValue;
}
