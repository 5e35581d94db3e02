// K6: the Mamba1 selective scan, forward. Replaces the Pallas kernel
// repro/kernels/selective_scan.py::selective_scan (_kernel).
//
// x, dt: (B, S, di) and b, c: (B, S, N) in f32 or bf16; a: (di, N) and
// h0: (B, di, N) f32. Outputs y: (B, S, di) in x's type, h_final: (B, di, N)
// f32 and h_starts: (B, S / chunk, di, N) f32, the state entering each chunk.
//
//   h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t,   y_t = sum_n h_t c_t
//
// The TPU kernel runs its grid's sequence axis in order on one core and
// carries h in VMEM scratch between grid steps. Here one CTA owns a (batch
// row, 32-channel block) for the whole sequence and keeps h in registers:
// four threads a channel, each with N/4 states, y summed over N by two
// shuffles within the four. x/dt tiles (32 steps x 32 channels) and the
// (32 steps x N) rows of b and c, shared by every channel, are staged in
// shared memory with coalesced loads and converted to f32 once; the next
// tile's loads are issued into registers before the current tile's steps
// run, so their latency hides behind the recurrence. y is staged there too
// and stored coalesced, rounded to its type once.
//
// Bound: the S di N exponentials on the special-function units (16 per SM
// per clock); bytes (each input and output once) are about half of that at
// the served prefill shape. Each step's exp(dt a) and (dt x) b do not depend
// on h and are issued ahead of the h chain; the N/4 chains of a thread are
// independent. expf is the accurate one (no fast math), and products and sums
// are rounded one by one (__fmul_rn / __fadd_rn, no FMA contraction), in the
// plain version's order (y's sum over N included: each thread's N/4 states
// in order, then (0 + 1) + (2 + 3)), so the kernel repeats its arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CH = 32;                 // channels per CTA
constexpr int LANES = 4;               // threads per channel
constexpr int THREADS = CH * LANES;    // 128
constexpr int TT = 32;                 // steps staged per tile
constexpr int NMAX = 64;
constexpr int XPT = TT * CH / THREADS;  // x (and dt) values a thread loads

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int SPT>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const T* __restrict__ bmat, const T* __restrict__ cmat,
                      const float* __restrict__ a, const float* __restrict__ h0,
                      T* __restrict__ y, float* __restrict__ h_final,
                      float* __restrict__ h_starts, int S, int di, int chunk) {
  constexpr int N = SPT * LANES;
  constexpr int BPT = (TT * N + THREADS - 1) / THREADS;  // b (and c) values
  static_assert(N <= NMAX, "N too large");
  __shared__ float xs[TT][CH];
  __shared__ float dts[TT][CH];
  __shared__ float ys[TT][CH];
  __shared__ float bs[TT][N];
  __shared__ float cs[TT][N];

  const int bi = blockIdx.y;
  const int ch0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int cl = tid / LANES;          // channel within the block
  const int q = tid % LANES;           // which N/4 states
  const int ch = ch0 + cl;
  const bool valid = ch < di;
  const int n0 = q * SPT;
  const int n_chunks = S / chunk;

  float av[SPT], h[SPT];
  const long long hoff = ((long long)bi * di + ch) * N + n0;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    av[j] = valid ? a[(long long)ch * N + n0 + j] : 0.f;
    h[j] = valid ? h0[hoff + j] : 0.f;
  }
  const long long xbase = (long long)bi * S * di;
  const long long bbase = (long long)bi * S * N;

  // one tile's operands in registers, all loads issued before any is used
  float xv[XPT], dv[XPT], bv[BPT], cv[BPT];
  auto load_tile = [&](int t0) {
#pragma unroll
    for (int k = 0; k < XPT; ++k) {
      const int i = tid + k * THREADS, r = i / CH, gc = ch0 + i % CH;
      const bool in = t0 + r < S && gc < di;
      const long long off = xbase + (long long)(t0 + r) * di + gc;
      xv[k] = in ? ld(x + off) : 0.f;
      dv[k] = in ? ld(dt + off) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < BPT; ++k) {
      const int i = tid + k * THREADS, r = i / N;
      const bool in = i < TT * N && t0 + r < S;
      const long long off = bbase + (long long)t0 * N + i;
      bv[k] = in ? ld(bmat + off) : 0.f;
      cv[k] = in ? ld(cmat + off) : 0.f;
    }
  };

  load_tile(0);
  for (int t0 = 0; t0 < S; t0 += TT) {
    const int tn = min(TT, S - t0);
#pragma unroll
    for (int k = 0; k < XPT; ++k) {
      const int i = tid + k * THREADS;
      xs[i / CH][i % CH] = xv[k];
      dts[i / CH][i % CH] = dv[k];
    }
#pragma unroll
    for (int k = 0; k < BPT; ++k) {
      const int i = tid + k * THREADS;
      if (i < TT * N) {
        bs[i / N][i % N] = bv[k];
        cs[i / N][i % N] = cv[k];
      }
    }
    __syncthreads();
    if (t0 + TT < S) load_tile(t0 + TT);   // in flight during the steps
#pragma unroll 4
    for (int r = 0; r < tn; ++r) {
      const int t = t0 + r;
      if (t % chunk == 0 && valid) {   // chunk-start checkpoint
        float* dst = h_starts +
                     (((long long)bi * n_chunks + t / chunk) * di + ch) * N + n0;
#pragma unroll
        for (int j = 0; j < SPT; ++j) dst[j] = h[j];
      }
      const float d = dts[r][cl];
      const float dx = __fmul_rn(d, xs[r][cl]);
      float da[SPT], dbx[SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        da[j] = expf(__fmul_rn(d, av[j]));
        dbx[j] = __fmul_rn(dx, bs[r][n0 + j]);
      }
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        h[j] = __fadd_rn(__fmul_rn(da[j], h[j]), dbx[j]);
        acc = __fadd_rn(acc, __fmul_rn(h[j], cs[r][n0 + j]));
      }
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
      if (q == 0) ys[r][cl] = acc;
    }
    __syncthreads();                   // every step of the tile is done
    for (int i = tid; i < tn * CH; i += THREADS) {
      const int r = i / CH, cc = i % CH, gc = ch0 + cc;
      if (gc < di) st(y + xbase + (long long)(t0 + r) * di + gc, ys[r][cc]);
    }
  }
  if (valid) {
#pragma unroll
    for (int j = 0; j < SPT; ++j) h_final[hoff + j] = h[j];
  }
}

template <typename T, int SPT>
cudaError_t launch(const void* x, const void* dt, const void* b, const void* c,
                   const float* a, const float* h0, void* y, float* h_final,
                   float* h_starts, int B, int S, int di, int chunk,
                   cudaStream_t stream) {
  dim3 grid((di + CH - 1) / CH, B);
  selective_scan_kernel<T, SPT><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (const T*)dt, (const T*)b, (const T*)c, a, h0, (T*)y,
      h_final, h_starts, S, di, chunk);
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* b,
                     const void* c, const float* a, const float* h0, void* y,
                     float* h_final, float* h_starts, int B, int S, int di,
                     int N, int chunk, cudaStream_t s) {
  switch (N) {
    case 4:
      return launch<T, 1>(x, dt, b, c, a, h0, y, h_final, h_starts, B, S, di,
                          chunk, s);
    case 8:
      return launch<T, 2>(x, dt, b, c, a, h0, y, h_final, h_starts, B, S, di,
                          chunk, s);
    case 16:
      return launch<T, 4>(x, dt, b, c, a, h0, y, h_final, h_starts, B, S, di,
                          chunk, s);
    case 32:
      return launch<T, 8>(x, dt, b, c, a, h0, y, h_final, h_starts, B, S, di,
                          chunk, s);
    case 64:
      return launch<T, 16>(x, dt, b, c, a, h0, y, h_final, h_starts, B, S, di,
                           chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x, dt, b, c and y share it; a, h0, h_final and
// h_starts are f32). N must be 4, 8, 16, 32 or 64; chunk must divide S.
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* b, const void* c,
                                     const void* a, const void* h0, void* y,
                                     void* h_final, void* h_starts, int B,
                                     int S, int di, int N, int chunk,
                                     int dtype, void* stream) {
  if (B < 1 || S < 1 || di < 1 || chunk < 1 || S % chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (dtype == 0)
    e = dispatch<float>(x, dt, b, c, (const float*)a, (const float*)h0, y,
                        (float*)h_final, (float*)h_starts, B, S, di, N, chunk,
                        s);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(x, dt, b, c, (const float*)a,
                                (const float*)h0, y, (float*)h_final,
                                (float*)h_starts, B, S, di, N, chunk, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
