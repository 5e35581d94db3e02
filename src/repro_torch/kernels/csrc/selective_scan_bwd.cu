// K9: the Mamba1 selective scan, backward. Replaces the Pallas kernel
// repro/kernels/selective_scan.py::selective_scan_bwd (_bwd_kernel).
//
// All operands f32 (the wrapper casts): x, dt, dy: (B, S, di); b, c:
// (B, S, N); a: (di, N); h_starts: (B, S / chunk, di, N), the state entering
// each chunk, from the forward (K6). Outputs dx, ddt: (B, S, di); db_part,
// dc_part: (B, S, ceil(di / 32), N), one partial per 32-channel block that
// the wrapper sums; da_part: (B, di, N), summed over the batch by the
// wrapper. The gradient into h0 is zero (training starts from h0 = 0).
//
// Per step t, in reverse, with h_{t-1} recomputed and dh the adjoint carried
// from step t + 1:
//   da = exp(dt a), coef = dt x, h_t = da h_{t-1} + coef b_t,
//   dh_t = dh + dy_t c_t,
//   dc_t += h_t dy_t and db_t += dh_t coef (summed over channels),
//   sb = sum_n dh_t b_t, dx_t = sb dt, ddt_t = sb x + sum_n dh_t da h_{t-1} a,
//   dA += dh_t da h_{t-1} dt, dh = da dh_t.
//
// The TPU kernel runs its sequence grid axis reversed and in order on one
// core, carrying dh and dA in VMEM scratch from one chunk to the next. Here
// one CTA owns a (batch row, 32-channel block) for the whole sequence, K6's
// geometry: four threads a channel, N/4 states each, dh and dA in
// registers, the chunks walked in reverse inside the CTA. Within a chunk the
// steps go in sub-tiles of TS (32 at N <= 16): each sub-tile's start state
// is recomputed forward from the chunk's h_starts entry, then the sub-tile
// runs forward once more storing h_{t-1} per step in shared memory
// (TS x 32 channels x N states x 4 B = 64 KB at N = 16; a whole 128-step
// chunk would be 256 KB), and then backward. The forward recompute repeats
// K6's arithmetic (accurate expf, products and sums rounded one by one), so
// h_{t-1} equals the forward's bit for bit. Sums over N are taken in K6's
// order (each thread's N/4 states in order, then (0 + 1) + (2 + 3) by two
// shuffles); sums over the block's 32 channels by three shuffles within a
// warp (a pairwise tree over its 8 channels) and then the four warps as
// (0 + 1) + (2 + 3); selective_scan_bwd_plain repeats both orders.
//
// Bound: the S di N exponentials the function needs on the special-function
// units (one exp(dt A) per (t, d, n) serves both the recomputed h_t and the
// adjoint's dh_{t-1}), or the bytes of the inputs and outputs, whichever is
// larger; at falcon-mamba-7b's training shape the bytes. This kernel takes
// each exponential twice (forward recompute, backward step), and more with
// the sub-tile recompute: keeping exp(dt A) beside h_{t-1} in shared memory
// would save the second.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CH = 32;                 // channels per CTA
constexpr int LANES = 4;               // threads per channel
constexpr int THREADS = CH * LANES;    // 128
constexpr int WARPS = THREADS / 32;    // 4

template <int SPT>
struct Geometry {
  static constexpr int N = SPT * LANES;
  static constexpr int TS = SPT <= 4 ? 32 : 128 / SPT;   // steps a sub-tile
  // shared memory, in floats
  static constexpr int HS = TS * SPT * THREADS;          // h_{t-1} per step
  static constexpr int XS = TS * CH;                     // x, dt, dy, dx, ddt
  static constexpr int BS = TS * N;                      // b, c
  static constexpr int RED = TS * WARPS * N;             // db, dc per warp
  static constexpr size_t BYTES =
      sizeof(float) * ((size_t)HS + 5 * XS + 2 * BS + 2 * RED);
};

template <int SPT>
__global__ void __launch_bounds__(THREADS)
selective_scan_bwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ bmat,
                          const float* __restrict__ cmat,
                          const float* __restrict__ a,
                          const float* __restrict__ h_starts,
                          const float* __restrict__ dy,
                          float* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ db_part,
                          float* __restrict__ dc_part,
                          float* __restrict__ da_part, int S, int di,
                          int chunk) {
  using G = Geometry<SPT>;
  constexpr int N = G::N;
  constexpr int TS = G::TS;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                   // [TS][SPT][THREADS]
  float* xs = hs + G::HS;             // [TS][CH]
  float* dts = xs + G::XS;
  float* dys = dts + G::XS;
  float* dxs = dys + G::XS;
  float* ddts = dxs + G::XS;
  float* bs = ddts + G::XS;           // [TS][N]
  float* cs = bs + G::BS;
  float* dbw = cs + G::BS;            // [TS][WARPS][N]
  float* dcw = dbw + G::RED;

  const int bi = blockIdx.y;
  const int blk = blockIdx.x;
  const int n_blk = gridDim.x;
  const int ch0 = blk * CH;
  const int tid = threadIdx.x;
  const int cl = tid / LANES;          // channel within the block
  const int q = tid % LANES;           // which N/4 states
  const int warp = tid / 32;
  const int ch = ch0 + cl;
  const bool valid = ch < di;
  const int n0 = q * SPT;
  const int n_chunks = S / chunk;
  const long long xbase = (long long)bi * S * di;
  const long long bbase = (long long)bi * S * N;

  float av[SPT], dh[SPT], dacc[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    av[j] = valid ? a[(long long)ch * N + n0 + j] : 0.f;
    dh[j] = 0.f;
    dacc[j] = 0.f;
  }

  // Stage steps [t0, t0 + tn) of x, dt, b (and c, dy) in shared memory.
  auto stage = [&](int t0, int tn, bool adjoint) {
    __syncthreads();   // the previous tile's reads are done
    for (int i = tid; i < TS * CH; i += THREADS) {
      const int r = i / CH, gc = ch0 + i % CH;
      const bool in = r < tn && gc < di;
      const long long off = xbase + (long long)(t0 + r) * di + gc;
      xs[i] = in ? x[off] : 0.f;
      dts[i] = in ? dt[off] : 0.f;
      if (adjoint) dys[i] = in ? dy[off] : 0.f;
    }
    for (int i = tid; i < TS * N; i += THREADS) {
      const bool in = i / N < tn;
      const long long off = bbase + (long long)t0 * N + i;
      bs[i] = in ? bmat[off] : 0.f;
      if (adjoint) cs[i] = in ? cmat[off] : 0.f;
    }
    __syncthreads();
  };

  // One forward step (K6's arithmetic) at staged row r.
  auto step = [&](float* h, int r) {
    const float d = dts[r * CH + cl];
    const float dxv = __fmul_rn(d, xs[r * CH + cl]);
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const float da = expf(__fmul_rn(d, av[j]));
      const float dbx = __fmul_rn(dxv, bs[r * N + n0 + j]);
      h[j] = __fadd_rn(__fmul_rn(da, h[j]), dbx);
    }
  };

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int c0 = k * chunk;
    const int n_sub = (chunk + TS - 1) / TS;
    for (int u = n_sub - 1; u >= 0; --u) {
      const int t0 = c0 + u * TS;
      const int tn = min(TS, c0 + chunk - t0);
      float h[SPT];
      const float* hsrc = h_starts +
                          (((long long)bi * n_chunks + k) * di + ch) * N + n0;
#pragma unroll
      for (int j = 0; j < SPT; ++j) h[j] = valid ? hsrc[j] : 0.f;
      // the sub-tile's start state, recomputed from the chunk start
      for (int tf = c0; tf < t0; tf += TS) {
        stage(tf, TS, false);
        for (int r = 0; r < TS; ++r) step(h, r);
      }
      stage(t0, tn, true);
      for (int r = 0; r < tn; ++r) {
#pragma unroll
        for (int j = 0; j < SPT; ++j) hs[(r * SPT + j) * THREADS + tid] = h[j];
        step(h, r);
      }
      // the adjoint, in reverse
      for (int r = tn - 1; r >= 0; --r) {
        const float d = dts[r * CH + cl];
        const float xv = xs[r * CH + cl];
        const float coef = __fmul_rn(d, xv);
        const float dyv = dys[r * CH + cl];
        float sb = 0.f, s2 = 0.f, pb[SPT], pc[SPT];
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          const float hp = hs[(r * SPT + j) * THREADS + tid];
          const float bv = bs[r * N + n0 + j];
          const float da = expf(__fmul_rn(d, av[j]));
          const float ht = __fadd_rn(__fmul_rn(da, hp), __fmul_rn(coef, bv));
          const float dht = __fadd_rn(dh[j], __fmul_rn(dyv, cs[r * N + n0 + j]));
          pc[j] = __fmul_rn(ht, dyv);
          pb[j] = __fmul_rn(dht, coef);
          sb = __fadd_rn(sb, __fmul_rn(dht, bv));
          const float g = __fmul_rn(__fmul_rn(dht, da), hp);
          s2 = __fadd_rn(s2, __fmul_rn(g, av[j]));
          dacc[j] = __fadd_rn(dacc[j], __fmul_rn(g, d));
          dh[j] = __fmul_rn(da, dht);
        }
        sb = __fadd_rn(sb, __shfl_xor_sync(0xffffffffu, sb, 1));
        sb = __fadd_rn(sb, __shfl_xor_sync(0xffffffffu, sb, 2));
        s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, 1));
        s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, 2));
        if (q == 0) {
          dxs[r * CH + cl] = __fmul_rn(sb, d);
          ddts[r * CH + cl] = __fadd_rn(__fmul_rn(sb, xv), s2);
        }
        // over the warp's 8 channels: a pairwise tree
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            pb[j] = __fadd_rn(pb[j], __shfl_xor_sync(0xffffffffu, pb[j], m));
            pc[j] = __fadd_rn(pc[j], __shfl_xor_sync(0xffffffffu, pc[j], m));
          }
        }
        if ((tid & 31) < LANES) {
#pragma unroll
          for (int j = 0; j < SPT; ++j) {
            dbw[(r * WARPS + warp) * N + n0 + j] = pb[j];
            dcw[(r * WARPS + warp) * N + n0 + j] = pc[j];
          }
        }
      }
      __syncthreads();   // every step of the sub-tile is done
      for (int i = tid; i < tn * CH; i += THREADS) {
        const int r = i / CH, gc = ch0 + i % CH;
        if (gc < di) {
          const long long off = xbase + (long long)(t0 + r) * di + gc;
          dx[off] = dxs[i];
          ddt[off] = ddts[i];
        }
      }
      for (int i = tid; i < tn * N; i += THREADS) {
        const int r = i / N, n = i % N;
        const float* wb = dbw + r * WARPS * N + n;
        const float* wc = dcw + r * WARPS * N + n;
        const long long off =
            (((long long)bi * S + t0 + r) * n_blk + blk) * N + n;
        db_part[off] = __fadd_rn(__fadd_rn(wb[0], wb[N]),
                                 __fadd_rn(wb[2 * N], wb[3 * N]));
        dc_part[off] = __fadd_rn(__fadd_rn(wc[0], wc[N]),
                                 __fadd_rn(wc[2 * N], wc[3 * N]));
      }
    }
  }
  if (valid) {
    float* dst = da_part + ((long long)bi * di + ch) * N + n0;
#pragma unroll
    for (int j = 0; j < SPT; ++j) dst[j] = dacc[j];
  }
}

template <int SPT>
cudaError_t launch(const float* x, const float* dt, const float* b,
                   const float* c, const float* a, const float* h_starts,
                   const float* dy, float* dx, float* ddt, float* db_part,
                   float* dc_part, float* da_part, int B, int S, int di,
                   int chunk, cudaStream_t stream) {
  const size_t smem = Geometry<SPT>::BYTES;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        selective_scan_bwd_kernel<SPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((di + CH - 1) / CH, B);
  selective_scan_bwd_kernel<SPT><<<grid, THREADS, smem, stream>>>(
      x, dt, b, c, a, h_starts, dy, dx, ddt, db_part, dc_part, da_part, S, di,
      chunk);
  return cudaGetLastError();
}

}  // namespace

// All pointers f32. N must be 4, 8, 16, 32 or 64; chunk must divide S.
extern "C" int selective_scan_bwd_launch(
    const void* x, const void* dt, const void* b, const void* c,
    const void* a, const void* h_starts, const void* dy, void* dx, void* ddt,
    void* db_part, void* dc_part, void* da_part, int B, int S, int di, int N,
    int chunk, void* stream) {
  if (B < 1 || S < 1 || di < 1 || chunk < 1 || S % chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define K9_ARGS                                                             \
  (const float*)x, (const float*)dt, (const float*)b, (const float*)c,     \
      (const float*)a, (const float*)h_starts, (const float*)dy,           \
      (float*)dx, (float*)ddt, (float*)db_part, (float*)dc_part,           \
      (float*)da_part, B, S, di, chunk, s
  switch (N) {
    case 4: return (int)launch<1>(K9_ARGS);
    case 8: return (int)launch<2>(K9_ARGS);
    case 16: return (int)launch<4>(K9_ARGS);
    case 32: return (int)launch<8>(K9_ARGS);
    case 64: return (int)launch<16>(K9_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K9_ARGS
}
