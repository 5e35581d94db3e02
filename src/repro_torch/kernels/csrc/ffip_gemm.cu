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

// The carry table C of y (K x T, T = ceil(N / 32)) on the card, in the order
// of kernels/ffip_gemm.py::carry_table_plain: C[k][0] = 0; C[k][t + 1] =
// C[k][t] + total_t, where total_t = y[k][32t] + y[k][32t + 1] + ... +
// y[k][32t + 31], added left to right (the ragged last group carries into
// nothing). One pass: a CTA owns CT_ROWS rows and walks their carrying
// columns in tiles of CT_GROUPS groups. Each tile arrives by 16-byte loads
// (coalesced; element by element only at a tile's misaligned edges),
// issued one tile ahead into registers, and is stored to shared memory with
// a group's 32 words at a stride of 33, so that the warp of one row's 32
// groups, one thread a group, reads conflict-free as each thread forms its
// group's total left to right; then one thread a row chains the tile's
// totals onto the row's running carry, left to right, and the (CT_ROWS x
// CT_GROUPS) block of carries is stored coalesced. The same adds in the
// same order as the plain version: the same bits in f32, exact in int32.
// Bound: the bytes of y, read once.
// 4 rows a CTA and registers capped for 5 CTAs an SM: the 576 CTAs of K
// 2304 run in one wave, each with a tile of 16-byte loads in flight
constexpr int CT_ROWS = 4;
constexpr int CT_GROUPS = 32;
constexpr int CT_W = 32 * CT_GROUPS;              // columns a tile
constexpr int CT_THREADS = CT_ROWS * CT_GROUPS;   // one (row, group) each
constexpr int CT_CPR = CT_W / 4 + 1;              // 16-byte chunks a row
constexpr int CT_ITEMS = (CT_ROWS * CT_CPR + CT_THREADS - 1) / CT_THREADS;

template <typename T>
__global__ void __launch_bounds__(CT_THREADS, 5)
carry_table_kernel(const T* __restrict__ y, T* __restrict__ c, int K, int N,
                   int Tn, int vec) {
  static_assert(sizeof(T) == 4, "f32 or int32");
  __shared__ T tile[CT_ROWS][CT_GROUPS * 33];
  // group totals, then the carries; rows of CT_GROUPS + 4 for 16-byte reads
  __shared__ __align__(16) T tot[CT_ROWS][CT_GROUPS + 4];
  __shared__ __align__(16) T car[CT_ROWS][CT_GROUPS + 4];
  const int k0 = blockIdx.x * CT_ROWS;
  const int tid = threadIdx.x;
  const int cols = 32 * (Tn - 1);     // the full groups that carry
  const int ntiles = (cols + CT_W - 1) / CT_W;
  if (tid < CT_ROWS && k0 + tid < K) c[(long long)(k0 + tid) * Tn] = T(0);

  union Chunk {
    uint4 u;
    T e[4];
  };
  uint4 raw[CT_ITEMS];
  // item it of a tile: row it / CT_CPR, 16-byte chunk it % CT_CPR counted
  // from the aligned element at or before the tile's first in that row:
  // element `at`, its first column `off` from the tile's (-3 .. CT_W), and
  // `lim`, the tile's columns in this row
  auto span = [&](int it, int c0, long long& at, int& off,
                  int& lim) -> bool {
    const int r = it / CT_CPR;
    if (r >= CT_ROWS || k0 + r >= K) return false;
    const long long e0 = (long long)(k0 + r) * N + c0;
    lim = min(CT_W, cols - c0);
    off = 4 * (it % CT_CPR) - (int)(e0 & 3);
    at = e0 + off;
    return off < lim;
  };
  auto load = [&](int c0) {
#pragma unroll
    for (int i = 0; i < CT_ITEMS; ++i) {
      long long at;
      int off, lim;
      Chunk v;
      v.u = make_uint4(0, 0, 0, 0);
      if (span(tid + i * CT_THREADS, c0, at, off, lim)) {
        if (vec && off >= 0 && off + 4 <= lim) {
          // with a 256-byte L2 prefetch: a tile's row is 4 KB in a run
          asm volatile(
              "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, "
              "[%4];"
              : "=r"(v.u.x), "=r"(v.u.y), "=r"(v.u.z), "=r"(v.u.w)
              : "l"(y + at));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (off + e >= 0 && off + e < lim) v.e[e] = y[at + e];
        }
      }
      raw[i] = v.u;
    }
  };
  auto stage = [&](int c0) {
#pragma unroll
    for (int i = 0; i < CT_ITEMS; ++i) {
      const int it = tid + i * CT_THREADS;
      long long at;
      int off, lim;
      if (!span(it, c0, at, off, lim)) continue;
      Chunk v;
      v.u = raw[i];
      T* row = tile[it / CT_CPR];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = off + e;
        if (col >= 0 && col < lim) row[(col >> 5) * 33 + (col & 31)] = v.e[e];
      }
    }
  };

  const int r = tid / CT_GROUPS, g = tid % CT_GROUPS;
  static_assert(CT_GROUPS % 4 == 0, "the chain reads 16 bytes of totals");
  T run = T(0);                       // row tid's carry (tid < CT_ROWS)
  if (ntiles > 0) load(0);
  for (int i = 0; i < ntiles; ++i) {
    const int c0 = i * CT_W;
    const int ng = min(CT_GROUPS, Tn - 1 - c0 / 32);   // groups that carry
    stage(c0);
    __syncthreads();                  // the tile is in shared memory
    if (i + 1 < ntiles) load(c0 + CT_W);   // in flight over the sums
    if (g < ng) {
      const T* grp = tile[r] + g * 33;
      T total = grp[0];
#pragma unroll
      for (int j = 1; j < 32; ++j) total = total + grp[j];
      tot[r][g] = total;
    }
    __syncthreads();                  // the tile's totals
    if (tid < CT_ROWS) {
#pragma unroll 4
      for (int j0 = 0; j0 < ng; j0 += 4) {
        Chunk v, o;
        v.u = *reinterpret_cast<const uint4*>(&tot[tid][j0]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j0 + e < ng)
            run = (i == 0 && j0 + e == 0) ? v.e[0] : run + v.e[e];
          o.e[e] = run;
        }
        *reinterpret_cast<uint4*>(&car[tid][j0]) = o.u;
      }
    }
    __syncthreads();                  // the tile's carries
    if (g < ng && k0 + r < K)
      c[(long long)(k0 + r) * Tn + c0 / 32 + g + 1] = car[r][g];
  }
}

template <typename T>
static int carry_launch(const void* y, void* c, int K, int N,
                        cudaStream_t s) {
  const int Tn = (N + 31) / 32;
  const int vec = ((uintptr_t)y & 15) == 0;
  carry_table_kernel<T><<<(K + CT_ROWS - 1) / CT_ROWS, CT_THREADS, 0, s>>>(
      (const T*)y, (T*)c, K, N, Tn, vec);
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

// dtype: 0 = f32 a with f32 y, 1 = bf16 a with f32 y, 2 = int8 a with int32
// y; carry: the (K, ceil(N / 32)) table in y's type. geom, split_rows,
// split_cta and ws as for fip_gemm_launch.
extern "C" int ffip_gemm_launch(const void* a, const void* y,
                                const void* carry, void* ws, void* out, int M,
                                int N, int K, int geom, int split_rows,
                                int split_cta, int dtype, int fold_beta,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  fb::PairArgs p{a, y, carry, out, M, N, K, 1, N, split_rows,
                 split_cta, fold_beta, 0, 0, {}};
  if (dtype == 0) return launch<float, float>(p, geom, out, ws, s);
  if (dtype == 1) return launch<__nv_bfloat16, float>(p, geom, out, ws, s);
  if (dtype == 2) return launch<int8_t, int>(p, geom, out, ws, s);
  return (int)cudaErrorInvalidValue;
}
