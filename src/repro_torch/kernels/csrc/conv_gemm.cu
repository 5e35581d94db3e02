// K7: fused implicit-im2col convolution (Algorithm 1 inside the GEMM).
// Replaces the Pallas kernel repro/kernels/conv_gemm.py::_fused_flat (bodies
// _conv_kernel_mac, _conv_kernel_ffip; gather _gather_tile).
//
// NHWC conv as a GEMM per group: M = batch * OH * OW output pixels (the batch
// folded into M, so 7x7 layers still fill the tiles), K = KH * KW * Cin_g
// (evenized for FIP/FFIP), N = Cout / groups. The A matrix never exists: each
// (BM x 32) A stage is gathered from the padded input in global memory / L2
// straight into shared memory, the multi-digit counter split into a per-row
// base (computed once per CTA) and a per-column offset (once per k-tile).
// The Pallas kernel kept a whole padded image in VMEM per grid step; that
// does not fit shared memory (ResNet-50's padded 230 x 230 x 3 f32 input
// alone is 635 KB), and L2 (50 MB) holds the input of every layer here at
// batch 8.
//
// FIP and FFIP run on K2's and K3's pipelined pair body (fip_body.cuh) with
// its ConvRows loader: 16-byte cp.async copies where Cin_g is a whole number
// of 16-byte chunks (no chunk then crosses a (kh, kw) tap), plain loads
// otherwise (ResNet-50's and AlexNet's conv1, Cin 3). FFIP reads y and a
// carry table per group (kernels/ffip_gemm.py::carry_table of each group's
// y, derived once per weight), as K3 does, so no CTA sweeps N. The groups
// are folded into grid.x, the split plan and launch plan are K2's and K3's
// (kernels/fip_gemm.py::split_plan, launch_plan: 512-row splits from K
// only), and the transform, pair products and epilogue are theirs. So K7's
// FIP and FFIP sum what K2 and K3 sum over the materialised A, in the same
// nesting, at every K: the same bits, and an image's output does not depend
// on the batch it came in or on the tile geometry.
//
// The baseline keeps the CUDA-core body of f32 K1 (gemm_kernels.cuh,
// launch_mac with the ConvA loader): the f32 baseline conv gives the bits of
// f32 K1 over the materialised A (int8 those of int8 K1, which runs on the
// tensor cores: integer sums are exact in any order). The output is written
// straight into NHWC: group g's columns are g * N .. g * N + N - 1 of each
// pixel's Cout.
//
// Bound on this card: the CUDA cores' issue slots for FIP/FFIP (the pre-add
// has no tensor-core mapping: 2 adds and 1 multiply-add a pair and output),
// the f32 CUDA cores' FMA rate for the f32 baseline (no TF32); int8
// baseline's bound is the int8 tensor-core rate, which this CUDA-core body
// does not reach. Inputs f32 (accumulate f32) or int8 (accumulate int32,
// exact).
#include "fip_body.cuh"
#include "gemm_kernels.cuh"

template <typename In, typename Acc>
static int launch(int algo, const fb::PairArgs& p, int geom, int tm,
                  void* ws, cudaStream_t stream) {
  if (algo == 0) {
    const fb::ConvShape& c = p.conv;
    rt::ConvParams<In> ap{(const In*)p.a, p.M, c.h,  c.w,  c.cin,
                          c.cin_g,        c.kw, c.sh, c.sw, c.oh,
                          c.ow,           c.k_real};
    rt::Plan pl{p.M, p.N, p.K, p.ldo, (long long)p.K * p.N};
    return (int)rt::launch_mac<In, Acc, rt::ConvA>(
        ap, (const In*)p.b, (Acc*)p.out, pl, p.groups, tm, stream);
  }
  if (algo == 1)
    return (int)fb::launch_pair<In, In, Acc, false, fb::ConvRows>(
        p, geom, (Acc*)p.out, (Acc*)ws, stream);
  if (algo == 2)
    return (int)fb::launch_pair<In, Acc, Acc, true, fb::ConvRows>(
        p, geom, (Acc*)p.out, (Acc*)ws, stream);
  return (int)cudaErrorInvalidValue;
}

// x: (batch, h, w, cin) padded input; b: (groups, K, N) weights (baseline,
// FIP) or y deltas (FFIP, in the accumulation type); carry: FFIP's (groups,
// K, ceil(N / 32)) carry table; out: (batch * oh * ow, groups * N). algo: 0
// baseline, 1 FIP, 2 FFIP. dtype: 0 f32, 2 int8. tm: the baseline body's
// rows a thread (1 or 4); geom, split_rows, split_cta (FIP/FFIP): the pair
// body's tile geometry and K2's and K3's split and launch plans, ws the
// (splits, M, groups * N) partials when split_cta.
extern "C" int conv_gemm_launch(const void* x, const void* b,
                                const void* carry, void* ws, void* out,
                                int batch, int h, int w, int cin, int groups,
                                int kw, int sh, int sw, int oh, int ow,
                                int k_real, int N, int K, int algo, int dtype,
                                int tm, int geom, int split_rows,
                                int split_cta, int fold_beta, void* stream) {
  if (groups <= 0 || cin % groups || batch < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  const int M = batch * oh * ow;
  fb::PairArgs p{x, b, carry, out, M, N, K, groups, groups * N, split_rows,
                 split_cta, fold_beta, 0, 0,
                 fb::ConvShape{h, w, cin, cin / groups, kw, sh, sw, oh, ow,
                               k_real}};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float, float>(algo, p, geom, tm, ws, s);
  if (dtype == 2) return launch<int8_t, int>(algo, p, geom, tm, ws, s);
  return (int)cudaErrorInvalidValue;
}
