// Shared pieces of the port's hand-written Hopper kernels: the cp.async,
// ldmatrix and mma.sync wrappers of the pipelined bodies (K1's tensor-core
// body, K2/K3's pair body, K8), operand conversion into the accumulation
// type, K7's (and f32 K1's) tile geometry and dense tile loads, and the
// deterministic split-K reduction pass.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// -- asynchronous copies into shared memory (zero-filled where !valid) -------
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -- tensor-core fragments ----------------------------------------------------
// Four 8 x 8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8. With .trans each matrix arrives transposed.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b on the tensor cores: m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Output tile geometry of K7 and f32 K1 (see kernels/ops.py::mac_blocks):
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
