// K2: FIP GEMM (Eq. 2, Winograd 1968). Replaces the Pallas kernel
// repro/kernels/fip_gemm.py::fip_gemm (_kernel, fip_tile).
//
// Per 32-row k-tile, exactly as fip_tile: the pair product-sum
//   cross_ij = sum_k (a_{i,2k-1} + b_{2k,j}) (a_{i,2k} + b_{2k-1,j}),
// then part = cross - alpha_i (- beta_j unless fold_beta), then out += part.
// The pre-add couples i and j, so it has no tensor-core mapping: this is a
// CUDA-core kernel that walks the pairs in registers and never builds the
// (bm, bk/2, bn) cross tensor. The body is fip_body.cuh's pipelined pair body,
// shared with K3: cp.async tile ring, a transform stage that converts A and B
// to f32 (int32 for int8) and forms the tile's alpha and beta, and a TM x TN
// register tile, one barrier per k-tile. Bound on this card: the CUDA cores'
// issue slots at prefill (2 FADD + 1 FFMA per pair and output), the bytes of
// B at decode. K is summed in splits of a K-only plan (batch-invariant);
// where the output grid would leave the card idle (decode, a narrow N), each
// CTA takes one split and a second pass adds the splits in order.
#include "fip_body.cuh"

template <typename In, typename Acc>
static int launch(const fb::PairArgs& p, int geom, void* out, void* ws,
                  cudaStream_t stream) {
  return (int)fb::launch_pair<In, In, Acc, false>(p, geom, (Acc*)out,
                                                  (Acc*)ws, stream);
}

// dtype: 0 = f32, 1 = bf16 (both accumulate in f32), 2 = int8 (int32).
// geom: 0 decode (16 x 32), 1 mid (64 x 64), 2 wide (128 x 128) tiles.
// split_rows: rows of one split of K; split_cta: one split a CTA into the
// (splits, M, N) workspace ws, then the in-order reduction into out.
extern "C" int fip_gemm_launch(const void* a, const void* b, void* ws,
                               void* out, int M, int N, int K, int geom,
                               int split_rows, int split_cta, int dtype,
                               int fold_beta, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  fb::PairArgs p{a, b, nullptr, out, M, N, K, split_rows, split_cta,
                 fold_beta, 0, 0};
  if (dtype == 0) return launch<float, float>(p, geom, out, ws, s);
  if (dtype == 1) return launch<__nv_bfloat16, float>(p, geom, out, ws, s);
  if (dtype == 2) return launch<int8_t, int>(p, geom, out, ws, s);
  return (int)cudaErrorInvalidValue;
}
