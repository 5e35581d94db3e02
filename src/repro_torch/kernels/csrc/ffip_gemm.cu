// K3: FFIP GEMM from the Eq. 9 weight deltas y (f32 for float weights, int32
// for int8). Replaces the Pallas kernel repro/kernels/ffip_gemm.py::ffip_gemm_y
// (_kernel, ffip_tile).
//
// FFIP rebuilds the weights by a column prefix sum of y carried across the N
// sweep: b_{k,j} = b_{k,j-1} + y_{k,j} (Eq. 8c). Pallas carries that prefix in
// a (bk, 1) VMEM scratch and relies on the TPU running the grid in order. A
// CUDA grid gives no order, so here ONE CTA owns the whole N sweep of an
// (m-block, unit) stripe and keeps the carry of each of its k rows in shared
// memory (gemm_kernels.cuh::ffip_kernel, shared with K7). The kernel reads y
// only, never B. K is split in 16-row halves of a k-tile, grouped into at
// most 24 groups, whatever M is: at decode (M = slots) each CTA takes one
// half, K / 16 CTAs that fill the card, and a second pass sums the halves in
// plan order; at prefill each CTA sums one group itself, with the same bits.
// Bound on this card: bytes of y at decode (y is f32: twice the bf16 weight
// bytes), CUDA-core operations at prefill. At decode the N sweep is serial,
// so its per-tile latency sets the time: each warp issues the y loads of all
// its tile rows before scanning any.
#include "gemm_kernels.cuh"

using namespace rt;

template <typename In, typename Acc>
static int launch(const void* a, const void* y, void* ws, void* out, int M,
                  int N, int K, int rows, int spu, int red_gsz, int tm,
                  int fold_beta, cudaStream_t stream) {
  DenseParams<In> ap{(const In*)a, M, K};
  Plan pl{M, N, K, N, 0, fold_beta, rows, spu, 0, 0};
  return (int)launch_ffip<In, Acc, DenseA>(ap, (const Acc*)y, (Acc*)ws,
                                          (Acc*)out, pl, 1, tm, red_gsz,
                                          stream);
}

// dtype: 0 = f32 a with f32 y, 1 = bf16 a with f32 y, 2 = int8 a with int32 y.
// rows: k rows per split (16, or a multiple of 32); spu: splits per CTA;
// red_gsz: slots per group in the reduction; ws holds the (units, M, N)
// partials when there is more than one unit.
extern "C" int ffip_gemm_launch(const void* a, const void* y, void* ws,
                                void* out, int M, int N, int K, int rows,
                                int spu, int red_gsz, int dtype, int tm,
                                int fold_beta, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, float>(a, y, ws, out, M, N, K, rows, spu, red_gsz,
                                tm, fold_beta, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, float>(a, y, ws, out, M, N, K, rows, spu,
                                        red_gsz, tm, fold_beta, s);
  if (dtype == 2)
    return launch<int8_t, int>(a, y, ws, out, M, N, K, rows, spu, red_gsz, tm,
                               fold_beta, s);
  return (int)cudaErrorInvalidValue;
}
