// K1: baseline blocked GEMM, (M, K) x (K, N) -> (M, N) in the accumulation
// type. Replaces the Pallas kernel repro/kernels/baseline_gemm.py::baseline_gemm
// (_kernel). bf16 and f32 operands accumulate in f32 on the CUDA cores (never
// TF32), int8 in int32.
//
// Design (gemm_kernels.cuh, shared with K7): one CTA per (64-column, BM-row)
// output tile; all k-tiles run in order through shared memory, each thread
// keeping a TM x 4 accumulator in registers. K is never split, as in the
// reference: a row's sum is the same one in-order sweep at any M (batch
// invariance), with no workspace and no second pass; the price is decode
// (M = slots), where only N / 64 CTAs run. Bound on this card: bytes at
// decode (each weight byte is used M times), CUDA-core operations at prefill.
#include "gemm_kernels.cuh"

using namespace rt;

template <typename In, typename Acc>
static int launch(const void* a, const void* b, void* out, int M, int N,
                  int K, int tm, cudaStream_t stream) {
  DenseParams<In> ap{(const In*)a, M, K};
  Plan pl{M, N, K, N, 0, 0, 0, 0, 0, 0};
  return (int)launch_mac<In, Acc, false, DenseA>(ap, (const In*)b,
                                                 (Acc*)out, pl, 1, tm, stream);
}

// dtype: 0 = f32 x f32 -> f32, 1 = bf16 x bf16 -> f32,
// 2 = int8 x int8 -> int32.
extern "C" int baseline_gemm_launch(const void* a, const void* b, void* out,
                                    int M, int N, int K, int dtype, int tm,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float, float>(a, b, out, M, N, K, tm, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, float>(a, b, out, M, N, K, tm, s);
  if (dtype == 2) return launch<int8_t, int>(a, b, out, M, N, K, tm, s);
  return (int)cudaErrorInvalidValue;
}
