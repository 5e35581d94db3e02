// K3: FFIP GEMM from the Eq. 9 weight deltas y (f32 for float weights, int32
// for int8). Replaces the Pallas kernel repro/kernels/ffip_gemm.py::ffip_gemm_y
// (_kernel, ffip_tile).
//
// FFIP rebuilds the weights by a column prefix sum of y: b_{k,j} = b_{k,j-1}
// + y_{k,j} (Eq. 8c). Pallas carries that prefix in a (bk, 1) VMEM scratch
// across its in-order grid; a CUDA grid runs in no order. Here the prefix of
// each row before every 32-column group is a carry table C (K x ceil(N/32)),
// derived once per weight from y and memoized beside it
// (kernels/ffip_gemm.py::carry_table). Each CTA rebuilds its own (32 x BN)
// weight tile from y and C in shared memory, b = C[k][t] + the serial prefix
// sum of y within the group, so no CTA sweeps N and K3 has K2's grid.
// Everything after the rebuild is K2's pipelined pair body (fip_body.cuh):
// the g terms (a_{i,2k} + b_{2k-1,j}) (a_{i,2k-1} + b_{2k,j}) summed over the
// pairs, minus alpha (minus beta unless folded), per k-tile. The kernel
// reads y and C, never B. Bound on this card: the CUDA cores' issue slots at
// prefill, the bytes of y at decode (y is f32: twice the bf16 weight bytes).
#include "fip_body.cuh"

template <typename In, typename Acc>
static int launch(const fb::PairArgs& p, int geom, void* out, void* ws,
                  cudaStream_t stream) {
  return (int)fb::launch_pair<In, Acc, Acc, true>(p, geom, (Acc*)out,
                                                  (Acc*)ws, stream);
}

// dtype: 0 = f32 a with f32 y, 1 = bf16 a with f32 y, 2 = int8 a with int32
// y; carry: the (K, ceil(N / 32)) table in y's type. geom, split_rows,
// split_cta and ws as for fip_gemm_launch.
// The carry table C of y (K x T, T = ceil(N / 32)) on the card, in the order
// of kernels/ffip_gemm.py::carry_table_plain: C[k][0] = 0; C[k][t + 1] the
// total of group t, y[k][32t] + y[k][32t + 1] + ... + y[k][32t + 31] added
// left to right; then the totals chained left to right, C[k][t + 1] =
// C[k][t] + total_t. Two passes: one thread a (row, group) forms a group's
// total (coalesced writes), then one thread a row chains its T - 1 totals in
// place. The same adds in the same order as the plain version: the same
// bits in f32, exact in int32.
template <typename T>
__global__ void carry_totals_kernel(const T* __restrict__ y,
                                    T* __restrict__ c, int K, int N, int Tn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)K * Tn) return;
  const int k = (int)(i / Tn), t = (int)(i % Tn);
  if (t == 0) {
    c[i] = T(0);
    return;
  }
  const T* g = y + (long long)k * N + 32LL * (t - 1);
  T total = __ldg(g);
#pragma unroll
  for (int j = 1; j < 32; ++j) total = total + __ldg(g + j);
  c[i] = total;
}

template <typename T>
__global__ void carry_chain_kernel(T* __restrict__ c, int K, int Tn) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K || Tn < 3) return;
  T* row = c + (long long)k * Tn;
  T run = row[1];
  for (int t = 2; t < Tn; ++t) {
    run = run + row[t];
    row[t] = run;
  }
}

template <typename T>
static int carry_launch(const void* y, void* c, int K, int N,
                        cudaStream_t s) {
  const int Tn = (N + 31) / 32;
  const long long cells = (long long)K * Tn;
  carry_totals_kernel<T><<<(unsigned)((cells + 255) / 256), 256, 0, s>>>(
      (const T*)y, (T*)c, K, N, Tn);
  carry_chain_kernel<T><<<(K + 127) / 128, 128, 0, s>>>((T*)c, K, Tn);
  return (int)cudaGetLastError();
}

// y: (K, N) f32 (is_int 0) or int32 (is_int 1); carry: (K, ceil(N / 32)).
extern "C" int carry_table_launch(const void* y, void* carry, int K, int N,
                                  int is_int, void* stream) {
  if (K <= 0 || N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_int ? carry_launch<int>(y, carry, K, N, s)
                : carry_launch<float>(y, carry, K, N, s);
}

extern "C" int ffip_gemm_launch(const void* a, const void* y,
                                const void* carry, void* ws, void* out, int M,
                                int N, int K, int geom, int split_rows,
                                int split_cta, int dtype, int fold_beta,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  fb::PairArgs p{a, y, carry, out, M, N, K, split_rows, split_cta,
                 fold_beta, 0, 0};
  if (dtype == 0) return launch<float, float>(p, geom, out, ws, s);
  if (dtype == 1) return launch<__nv_bfloat16, float>(p, geom, out, ws, s);
  if (dtype == 2) return launch<int8_t, int>(p, geom, out, ws, s);
  return (int)cudaErrorInvalidValue;
}
