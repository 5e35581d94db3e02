// K7: fused implicit-im2col convolution (Algorithm 1 inside the GEMM).
// Replaces the Pallas kernel repro/kernels/conv_gemm.py::_fused_flat (bodies
// _conv_kernel_mac, _conv_kernel_ffip; gather _gather_tile).
//
// NHWC conv as a GEMM per group: M = batch * OH * OW output pixels (the batch
// folded into M, so 7x7 layers still fill the tiles), K = KH * KW * Cin_g
// (evenized for FIP/FFIP), N = Cout / groups. The A matrix never exists: each
// (BM x 32) A tile is gathered from the padded input in global memory / L2
// straight into shared memory by gemm_kernels.cuh::ConvA, the multi-digit
// counter split into a per-row base (computed once per CTA) and a per-column
// offset (once per k-tile). The Pallas kernel kept a whole padded image in
// VMEM per grid step; that does not fit shared memory (ResNet-50's padded
// 230 x 230 x 3 f32 input alone is 635 KB), and L2 (50 MB) holds the input
// of every layer here at batch 8.
//
// Everything after the gather is the dense kernels' code (baseline, FIP with
// the pair algebra, FFIP rebuilding the weights from the y deltas by a carry
// across the N sweep, reset per group), with the dense kernels' k order (one
// in-order sweep for baseline and FIP; FFIP's k-split plan, a function of K
// only). So a fused conv gives the same bits as K1-K3 run over the
// materialised A, and an image's output does not depend on the batch it came
// in. The output is written straight into NHWC: group g's
// columns are g * N .. g * N + N - 1 of each pixel's Cout.
//
// Bound on this card: CUDA-core operations (f32 without TF32, and every
// FIP/FFIP body: the pre-add has no tensor-core mapping); int8 baseline's
// bound is the int8 tensor-core rate, which this CUDA-core kernel does not
// reach. Inputs f32 (accumulate f32) or int8 (accumulate int32, exact).
#include "gemm_kernels.cuh"

using namespace rt;

template <typename In, typename Acc>
static int launch(int algo, const void* x, const void* b, void* ws, void* out,
                  const ConvParams<In>& ap, int N, int K, int groups,
                  int rows, int spu, int red_gsz, int tm, int fold_beta,
                  cudaStream_t stream) {
  Plan pl{ap.M, N, K, groups * N, (long long)K * N, fold_beta, rows, spu,
          0, 0};
  cudaError_t e;
  if (algo == 0)
    e = launch_mac<In, Acc, false, ConvA>(ap, (const In*)b, (Acc*)out, pl,
                                          groups, tm, stream);
  else if (algo == 1)
    e = launch_mac<In, Acc, true, ConvA>(ap, (const In*)b, (Acc*)out, pl,
                                         groups, tm, stream);
  else if (algo == 2)
    e = launch_ffip<In, Acc, ConvA>(ap, (const Acc*)b, (Acc*)ws, (Acc*)out,
                                    pl, groups, tm, red_gsz, stream);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

// x: (batch, h, w, cin) padded input; b: (groups, K, N) weights (baseline,
// FIP) or y deltas (FFIP, in the accumulation type); out: (batch * oh * ow,
// groups * N). algo: 0 baseline, 1 FIP, 2 FFIP. dtype: 0 f32, 2 int8.
// rows / spu / red_gsz (FFIP only): the k-split plan and launch grouping, as
// for K3; ws holds the partials when there is more than one unit.
extern "C" int conv_gemm_launch(const void* x, const void* b, void* ws,
                                void* out, int batch, int h, int w, int cin,
                                int groups, int kh, int kw, int sh, int sw,
                                int oh, int ow, int k_real, int N, int K,
                                int rows, int spu, int red_gsz, int algo,
                                int dtype, int tm, int fold_beta,
                                void* stream) {
  (void)kh;   // k_real = kh * kw * cin_g carries it
  cudaStream_t s = (cudaStream_t)stream;
  if (groups <= 0 || cin % groups) return (int)cudaErrorInvalidValue;
  const int M = batch * oh * ow;
  const int cin_g = cin / groups;
  if (dtype == 0) {
    ConvParams<float> ap{(const float*)x, M,  h,  w,  cin,   cin_g,
                         kw,              sh, sw, oh, ow,    k_real};
    return launch<float, float>(algo, x, b, ws, out, ap, N, K, groups, rows,
                                spu, red_gsz, tm, fold_beta, s);
  }
  if (dtype == 2) {
    ConvParams<int8_t> ap{(const int8_t*)x, M,  h,  w,  cin,   cin_g,
                          kw,               sh, sw, oh, ow,    k_real};
    return launch<int8_t, int>(algo, x, b, ws, out, ap, N, K, groups, rows,
                               spu, red_gsz, tm, fold_beta, s);
  }
  return (int)cudaErrorInvalidValue;
}
