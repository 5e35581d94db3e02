// Shared pieces of the port's hand-written Hopper GEMM kernels (K1-K3, K7):
// operand conversion into the accumulation type, K1's and K7's tile geometry
// and dense tile loads, and the deterministic split-K reduction pass.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// Output tile geometry of K1 and K7 (see kernels/ops.py::mac_blocks):
// 256 threads as a 16 x 16 grid, each thread owning TM rows x TN columns
// strided by 16, so neighbouring threads touch neighbouring columns.
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int TN = 4;
constexpr int BN = TX * TN;   // 64
constexpr int BK = 32;        // even: whole (odd, even) pairs per k-tile
constexpr int THREADS = TX * TY;

template <typename Acc, typename In>
__device__ __forceinline__ Acc cvt(In v);
template <>
__device__ __forceinline__ float cvt<float, float>(float v) { return v; }
template <>
__device__ __forceinline__ float cvt<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ int cvt<int, int8_t>(int8_t v) { return (int)v; }
template <>
__device__ __forceinline__ int cvt<int, int>(int v) { return v; }

// The split-K reduction, in the order the plan fixes (gemm_kernels.cuh):
// the partials of each group of `gsz` consecutive slots are summed in slot
// order, then the group totals in group order. No atomics, so a float result
// does not change from run to run; and a CTA that summed a whole group
// itself (gsz = 1 here) leaves the same bits.
template <typename Acc>
__global__ void reduce_units(const Acc* __restrict__ ws, Acc* __restrict__ out,
                             int units, int gsz, long long mn) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  Acc total = Acc(0);
  for (int g0 = 0; g0 < units; g0 += gsz) {
    Acc t = ws[(long long)g0 * mn + i];
    const int g1 = min(g0 + gsz, units);
    for (int p = g0 + 1; p < g1; ++p) t += ws[(long long)p * mn + i];
    total = g0 == 0 ? t : total + t;
  }
  out[i] = total;
}

template <typename Acc>
inline void launch_reduce(const Acc* ws, Acc* out, int units, int gsz,
                          long long mn, cudaStream_t stream) {
  if (units <= 1) return;
  int threads = 256;
  long long blocks = (mn + threads - 1) / threads;
  reduce_units<Acc><<<(unsigned)blocks, threads, 0, stream>>>(ws, out, units,
                                                              gsz, mn);
}

// Load a (ROWS x BK) tile of a row-major (M, K) operand into shared memory in
// the accumulation type; elements at rows >= M or columns >= k_end are zero
// (the reference's zero-padding, which is exact for baseline products and
// the FIP algebra). k_end is K, or the end of a CTA's k-split.
template <int ROWS, int LD, typename In, typename Acc>
__device__ __forceinline__ void load_a_tile(Acc (*As)[LD], const In* __restrict__ A,
                                            int M, int K, int k_end, int m0,
                                            int k0) {
  for (int idx = threadIdx.x; idx < ROWS * BK; idx += THREADS) {
    int r = idx / BK, c = idx % BK;
    int gm = m0 + r, gk = k0 + c;
    As[r][c] = (gm < M && gk < k_end) ? cvt<Acc, In>(A[(long long)gm * K + gk])
                                      : Acc(0);
  }
}

// Load a (BK x BN) tile of a row-major (K, N) operand.
template <typename In, typename Acc>
__device__ __forceinline__ void load_b_tile(Acc (*Bs)[BN], const In* __restrict__ B,
                                            int K, int N, int k0, int n0) {
  for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
    int r = idx / BN, c = idx % BN;
    int gk = k0 + r, gn = n0 + c;
    Bs[r][c] = (gk < K && gn < N) ? cvt<Acc, In>(B[(long long)gk * N + gn])
                                  : Acc(0);
  }
}

}  // namespace rt
