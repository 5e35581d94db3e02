// K1: baseline GEMM, (M, K) x (K, N) -> (M, N) in the accumulation type.
// Replaces the Pallas kernel repro/kernels/baseline_gemm.py::baseline_gemm
// (_kernel: a jnp.dot a k-tile on the MXU, f32 or int32 accumulation, the
// k-tiles in order).
//
// bf16 and int8 run on the tensor cores (tc_gemm.cuh): mma.sync m16n8k16
// bf16 -> f32 and m16n8k32 s8 -> s32, a ring of 128-byte k-tiles in shared
// memory (filled by 2D TMA copies for bf16 with 16-byte-aligned rows, by
// cp.async otherwise), ldmatrix fragments, accumulators in registers, one
// write an output. The tile geometry is chosen by M and N
// (kernels/baseline_gemm.py::tc_blocks): 16 x 64 at decode (M <= 16),
// 128 x 128 or 64 x 64 above. Every geometry and loader runs the same
// k-step chain an output element, over all of K in order with no split:
// batch invariance by construction.
//
// f32 keeps the CUDA-core body (gemm_kernels.cuh, launch_mac; never TF32),
// which K7's baseline shares.
//
// Bound on this card: the weight bytes at decode (each byte serves M rows);
// at prefill the tensor cores' peak (989 TFLOP/s bf16, 1979 TOP/s int8).
#include "gemm_kernels.cuh"
#include "tc_gemm.cuh"

using namespace rt;

template <typename In, typename Acc>
static int launch_cuda_cores(const void* a, const void* b, void* out, int M,
                             int N, int K, int tm, cudaStream_t stream) {
  DenseParams<In> ap{(const In*)a, M, K};
  Plan pl{M, N, K, N, 0, 0, 0, 0, 0, 0};
  return (int)launch_mac<In, Acc, false, DenseA>(ap, (const In*)b,
                                                 (Acc*)out, pl, 1, tm, stream);
}

// dtype: 0 = f32 x f32 -> f32 (tile: rows a thread, 1 or 4), 1 = bf16 x
// bf16 -> f32, 2 = int8 x int8 -> int32 (tile: the tensor-core geometry,
// 0-2, tc_gemm.cuh::launch_tc).
extern "C" int baseline_gemm_launch(const void* a, const void* b, void* out,
                                    int M, int N, int K, int dtype, int tile,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  tc::Args p{a, b, out, M, N, K, 0, 0};
  if (dtype == 0)
    return launch_cuda_cores<float, float>(a, b, out, M, N, K, tile, s);
  if (dtype == 1) return (int)tc::launch_tc<__nv_bfloat16>(p, tile, s);
  if (dtype == 2) return (int)tc::launch_tc<int8_t>(p, tile, s);
  return (int)cudaErrorInvalidValue;
}
