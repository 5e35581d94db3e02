// K1's tensor-core bodies: (M, K) x (K, N) -> (M, N) for bf16 -> f32
// (mma.sync m16n8k16) and int8 -> int32 (mma.sync m16n8k32). f32 operands
// keep the CUDA-core body of gemm_kernels.cuh (no TF32).
//
// One CTA computes one BM x BN output tile over all of K, in k-tiles of 128
// bytes a row (64 bf16 or 128 int8 values: four mma k-steps), through a ring
// of NS stages in shared memory. Each warp owns a WM x WN piece of the
// tile: its A fragments come from ldmatrix, its B fragments from
// ldmatrix.trans on the row-major (K, N) tile, and its accumulators stay in
// registers until the epilogue writes each output element once. Two
// loaders fill the ring:
//   - TMA (bf16 whose rows are 16-byte aligned, the served case): one
//     thread issues one 2D tensor-map copy for the A tile and one for each
//     64-column slice of the B tile per stage, into 128-byte-swizzled rows,
//     completing on the stage's mbarrier; edges read zero. On an H100 it
//     feeds the tensor cores 1.5-2.5x faster than cp.async, whose 16-byte
//     copies in flight bound every tile shape tried.
//   - cp.async (int8, and rows not 16-byte aligned): 16-byte copies issued
//     NS - 1 tiles ahead by every thread (plain loads, zero-filled, where a
//     row is not aligned) into rows padded to an odd number of 16-byte
//     chunks, so ldmatrix is conflict-free.
//
// int8 has no 8-bit transposing ldmatrix. The cp.async ring stores the B
// tile's k rows permuted within each 16 (rows 0-7 hold k 0 1 4 5 8 9 12 13,
// rows 8-15 the rest), so that ldmatrix.trans on b16 pairs of columns hands
// lane (g, t) k 4t..4t+3 of columns 2g and 2g+1 in two registers; two byte
// permutes make the fragments of the even and of the odd columns. The mma
// of the "even" fragment writes columns 0, 2, .., 14 of the 16-column
// block, the "odd" one columns 1, 3, .., 15.
//
// Batch invariance by construction: every geometry and either loader issue
// the same mma for an output element, with the same k-step chain acc =
// mma(a_k, b_k, acc) over all of K in order from zero (zero-filled past K),
// and no split of K. A row's result does not depend on the tile, the warp,
// the loader or the rows beside it. (int8 sums are exact in any order.)
#pragma once
#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace tc {

using rt::cp_async16;
using rt::cp_async_commit;
using rt::cp_async_wait;

constexpr int KB = 128;                // bytes of k a tile row
constexpr int KSTEPS = KB / 32;        // 32-byte mma k-steps a tile
constexpr int SMEM_MAX = 227 * 1024;

// Row pitch of a cp.async tile: an odd number of 16-byte chunks, so the
// eight rows of an ldmatrix land on eight different bank quads.
__host__ __device__ constexpr int odd_pitch(int bytes) {
  return (bytes / 16) % 2 ? bytes + 32 : bytes + 16;
}

template <typename In> struct Ty;
template <> struct Ty<__nv_bfloat16> {
  using Acc = float;
  using Bits = unsigned short;
};
template <> struct Ty<int8_t> {
  using Acc = int;
  using Bits = unsigned char;
};

// A BM x BN tile, warps of WM x WN outputs, NS stages.
template <int BM_, int BN_, int WM_, int WN_, int NS_>
struct Geom {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, NS = NS_;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * (BM / WM) * WARPS_N;
  static constexpr int MF = WM / 16;   // m16 fragments a warp
  static constexpr int NJ = WN / 16;   // 16-column blocks a warp
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BN % 64 == 0, "tiles");
};

// kernels/baseline_gemm.py::TC_GEOMS: decode (M <= 16) at 16 x 64 (two
// warps, an 8-deep ring); 64 x 64 and 128 x 128 above.
using GDecode = Geom<16, 64, 16, 32, 8>;
using GMid = Geom<64, 64, 32, 32, 4>;
using GWide = Geom<128, 128, 64, 32, 3>;

// acc[mf][j][f]: m16 fragment mf, 16-column block j, its n8 half f.
template <class G, typename Acc>
using Frags = Acc[G::MF][G::NJ][2][4];

// The four mma k-steps of one k-tile. Ad(row, chunk) is the address of the
// 16-byte chunk of A tile row `row`; Bd(k, n) that of the 16 bytes from
// column n of B tile row k (bf16), or of B tile row k at byte column n
// (int8: `k` is the ldmatrix row, permuted as the cp.async ring stores it).
template <class G, typename In, typename AAddr, typename BAddr>
__device__ __forceinline__ void mma_ktile(
    Frags<G, typename Ty<In>::Acc>& acc, AAddr Ad, BAddr Bd, int lane,
    int wm, int wn) {
  constexpr int MF = G::MF, NJ = G::NJ;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    unsigned a[MF][4];
#pragma unroll
    for (int i = 0; i < MF; ++i)
      rt::ldsm_x4(a[i], Ad(wm * G::WM + i * 16 + (lane & 15),
                           ks * 2 + (lane >> 4)));
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = wn * G::WN + j * 16;       // first column of block
      unsigned r[4], b[2][2];
      if constexpr (sizeof(In) == 2) {
        rt::ldsm_x4_t(r, Bd(ks * 16 + (lane & 15), col + (lane >> 4) * 8));
        b[0][0] = r[0]; b[0][1] = r[1];          // columns 0-7
        b[1][0] = r[2]; b[1][1] = r[3];          // columns 8-15
      } else {
        rt::ldsm_x4_t(r, Bd(ks * 32 + lane, col));
        b[0][0] = __byte_perm(r[0], r[1], 0x6420);   // even columns
        b[0][1] = __byte_perm(r[2], r[3], 0x6420);
        b[1][0] = __byte_perm(r[0], r[1], 0x7531);   // odd columns
        b[1][1] = __byte_perm(r[2], r[3], 0x7531);
      }
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int f = 0; f < 2; ++f)
          rt::mma(acc[i][j][f], a[i], b[f][0], b[f][1]);
    }
  }
}

// Lane (g, t) holds rows g and g + 8 of each fragment.
template <class G, typename In>
__device__ __forceinline__ void store_tile(
    const Frags<G, typename Ty<In>::Acc>& acc, void* out_, int M, int N,
    int m0, int n0, int lane, int wm, int wn) {
  using Acc = typename Ty<In>::Acc;
  Acc* out = (Acc*)out_;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < G::MF; ++i)
#pragma unroll
    for (int j = 0; j < G::NJ; ++j)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = m0 + wm * G::WM + i * 16 + g + 8 * (c >> 1);
          const int cb = n0 + wn * G::WN + j * 16;
          const int col = sizeof(In) == 2 ? cb + 8 * f + 2 * tq + (c & 1)
                                          : cb + 4 * tq + 2 * (c & 1) + f;
          if (row < M && col < N)
            out[(long long)row * N + col] = acc[i][j][f][c];
        }
}

struct Args {
  const void* a;   // (M, K) row-major
  const void* b;   // (K, N) row-major
  void* out;       // (M, N) row-major, f32 or int32
  int M, N, K;
  int a_vec, b_vec;   // rows 16-byte aligned: cp.async, else plain loads
};

// ---------------------------------------------------------------------------
// The cp.async ring (int8; bf16 rows that are not 16-byte aligned)
// ---------------------------------------------------------------------------

template <class G, typename In>
struct Layout {
  static constexpr int BK = KB / (int)sizeof(In);   // k rows of a B tile
  static constexpr int A_PITCH = odd_pitch(KB);
  static constexpr int B_PITCH = odd_pitch(G::BN * (int)sizeof(In));
  static constexpr int A_BYTES = G::BM * A_PITCH;
  static constexpr int STAGE = A_BYTES + BK * B_PITCH;
  static constexpr int SMEM = G::NS * STAGE;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

// Shared row of B tile row r (int8: permuted within each 16, see above).
template <typename In>
__device__ __forceinline__ int b_row(int r) {
  if constexpr (sizeof(In) == 1) {
    const int q = r & 15;
    return (r & ~15) + ((q & 2) << 2) + ((q >> 2) << 1) + (q & 1);
  } else {
    return r;
  }
}

template <class G, typename In>
__device__ __forceinline__ void tc_body(const Args& p) {
  using L = Layout<G, In>;
  using Acc = typename Ty<In>::Acc;
  using Bits = typename Ty<In>::Bits;
  constexpr int BM = G::BM, BN = G::BN, NS = G::NS, BK = L::BK;
  constexpr int THREADS = G::THREADS;
  constexpr int EPC = 16 / (int)sizeof(In);          // elements a chunk
  constexpr int CB = BN / EPC;                        // B chunks a row
  constexpr int CA = KB / 16;                         // A chunks a row
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / G::WARPS_N, wn = warp % G::WARPS_N;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nt = (p.K + BK - 1) / BK;
  const int rows_m = min(BM, p.M - m0);    // A rows below M
  const In* A = (const In*)p.a;
  const In* B = (const In*)p.b;

  // A rows past M are zero in every stage, written once here: at decode
  // (M = slots) most of the tile's rows, which then cost no copies.
  for (int i = tid; i < NS * (BM - rows_m) * CA; i += THREADS) {
    const int s = i / ((BM - rows_m) * CA), r = i % ((BM - rows_m) * CA);
    *(uint4*)(smem + s * L::STAGE + (rows_m + r / CA) * L::A_PITCH +
              (r % CA) * 16) = make_uint4(0, 0, 0, 0);
  }

  auto issue = [&](int t) {
    if (t < nt) {
      unsigned char* sa = smem + (t % NS) * L::STAGE;
      unsigned char* sb = sa + L::A_BYTES;
      const int k0 = t * BK;
      for (int i = tid; i < rows_m * CA; i += THREADS) {
        const int row = i / CA, c = i % CA;
        const int gm = m0 + row, gk = k0 + c * EPC;
        unsigned char* dst = sa + row * L::A_PITCH + c * 16;
        if (p.a_vec) {
          const bool ok = gk < p.K;
          cp_async16(dst, ok ? (const void*)(A + (long long)gm * p.K + gk)
                             : p.a, ok);
        } else {
          Bits v[EPC];
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            v[e] = gk + e < p.K
                       ? ((const Bits*)A)[(long long)gm * p.K + gk + e]
                       : Bits(0);
#pragma unroll
          for (int e = 0; e < EPC; ++e) ((Bits*)dst)[e] = v[e];
        }
      }
      for (int i = tid; i < BK * CB; i += THREADS) {
        const int r = i / CB, c = i % CB;
        const int gk = k0 + r, gn = n0 + c * EPC;
        unsigned char* dst = sb + b_row<In>(r) * L::B_PITCH + c * 16;
        if (p.b_vec) {
          const bool ok = gk < p.K && gn < p.N;
          cp_async16(dst, ok ? (const void*)(B + (long long)gk * p.N + gn)
                             : p.b, ok);
        } else {
          Bits v[EPC];
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            v[e] = gk < p.K && gn + e < p.N
                       ? ((const Bits*)B)[(long long)gk * p.N + gn + e]
                       : Bits(0);
#pragma unroll
          for (int e = 0; e < EPC; ++e) ((Bits*)dst)[e] = v[e];
        }
      }
    }
    cp_async_commit();
  };

  Frags<G, Acc> acc;
#pragma unroll
  for (int i = 0; i < G::MF; ++i)
#pragma unroll
    for (int j = 0; j < G::NJ; ++j)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][f][c] = Acc(0);

  for (int s = 0; s < NS - 1; ++s) issue(s);

  for (int t = 0; t < nt; ++t) {
    // tile t has landed, and every warp is done with the slot refilled next
    cp_async_wait<NS - 2>();
    __syncthreads();
    issue(t + NS - 1);
    const unsigned char* sa = smem + (t % NS) * L::STAGE;
    const unsigned char* sb = sa + L::A_BYTES;
    mma_ktile<G, In>(
        acc,
        [&](int row, int chunk) { return sa + row * L::A_PITCH + chunk * 16; },
        [&](int k, int n) {
          return sb + k * L::B_PITCH + n * (int)sizeof(In);
        },
        lane, wm, wn);
  }
  cp_async_wait<0>();
  store_tile<G, In>(acc, p.out, p.M, p.N, m0, n0, lane, wm, wn);
}

// 512 / THREADS blocks an SM at least: ptxas keeps a thread within 128
// registers, so two wide CTAs (or four mid ones) share an SM.
template <class G, typename In>
__global__ void __launch_bounds__(G::THREADS, 512 / G::THREADS)
baseline_tc_kernel(Args p) {
  tc_body<G, In>(p);
}

// ---------------------------------------------------------------------------
// The TMA ring (bf16, rows 16-byte aligned): per stage an A box of BM rows
// x 64 values and BN / 64 B boxes of 64 rows x 64 values, each row 128
// bytes with the 16-byte chunks of row r at chunk ^ (r % 8) (the tensor
// map's 128-byte swizzle), so ldmatrix is conflict-free.
// ---------------------------------------------------------------------------

template <class G>
struct TmaLayout {
  static constexpr int A_BYTES = G::BM * 128;
  static constexpr int STAGE = A_BYTES + 64 * G::BN * 2;
  // 1024 bytes to align the ring to the swizzle's 1024-byte pattern
  static constexpr int SMEM = 1024 + G::NS * STAGE + 8 * G::NS;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared.b64 [%0], 1;\n" ::"r"(rt::smem_u32(bar)));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared.b64 st, [%0], %1;\n}\n" ::"r"(
          rt::smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(rt::smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The box of `map` at (inner c0, outer c1) into dst, completing on bar.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(rt::smem_u32(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(rt::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

template <class G>
__global__ void __launch_bounds__(G::THREADS, 1)
baseline_tc_tma_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb,
                       float* __restrict__ out, int M, int N, int K) {
  using L = TmaLayout<G>;
  constexpr int NS = G::NS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (rt::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = (uint64_t*)(smem + NS * L::STAGE);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / G::WARPS_N, wn = warp % G::WARPS_N;
  const int n0 = blockIdx.x * G::BN, m0 = blockIdx.y * G::BM;
  const int nt = (K + 63) / 64;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(full + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one thread fills slot t % NS with k-tile t (out-of-range reads zero)
  auto issue = [&](int t) {
    if (t >= nt) return;
    unsigned char* sa = smem + (t % NS) * L::STAGE;
    unsigned char* sb = sa + L::A_BYTES;
    mbar_expect(full + t % NS, L::STAGE);
    tma_2d(sa, &ta, t * 64, m0, full + t % NS);
#pragma unroll
    for (int h = 0; h < G::BN / 64; ++h)
      tma_2d(sb + h * 8192, &tb, n0 + h * 64, t * 64, full + t % NS);
  };

  Frags<G, float> acc;
#pragma unroll
  for (int i = 0; i < G::MF; ++i)
#pragma unroll
    for (int j = 0; j < G::NJ; ++j)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][f][c] = 0.f;

  if (tid == 0)
    for (int s = 0; s < NS; ++s) issue(s);
  for (int t = 0; t < nt; ++t) {
    mbar_wait(full + t % NS, (t / NS) & 1);
    const unsigned char* sa = smem + (t % NS) * L::STAGE;
    const unsigned char* sb = sa + L::A_BYTES;
    mma_ktile<G, __nv_bfloat16>(
        acc, [&](int row, int chunk) { return sa + swz(row, chunk); },
        [&](int k, int n) {
          return sb + (n >> 6) * 8192 + swz(k, (n & 63) >> 3);
        },
        lane, wm, wn);
    __syncthreads();             // every warp is done with slot t % NS
    if (tid == 0) issue(t + NS);
  }
  store_tile<G, __nv_bfloat16>(acc, out, M, N, m0, n0, lane, wm, wn);
}

// A 2D bf16 tensor map over a row-major (outer, inner) matrix, boxes of
// box_outer rows x 64 values, 128-byte swizzle, zero past the edges.
inline cudaError_t bf16_map(CUtensorMap* map, const void* base, int inner,
                            int outer, int box_outer) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", (void**)&encode, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (encode == nullptr) return cudaErrorSymbolNotFound;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  const cuuint32_t steps[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                      const_cast<void*>(base), dims, strides, box, steps,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Lets kernel Kern take `bytes` of dynamic shared memory, once.
template <auto Kern>
cudaError_t opt_in(int bytes) {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

template <class G, typename In>
cudaError_t launch_geom(const Args& p, cudaStream_t stream) {
  const long long m_blocks = (p.M + G::BM - 1) / G::BM;
  if (m_blocks > 65535) return cudaErrorInvalidValue;
  dim3 grid((p.N + G::BN - 1) / G::BN, (unsigned)m_blocks);
  if constexpr (sizeof(In) == 2) {
    if (p.a_vec && p.b_vec) {
      CUtensorMap ta, tb;
      cudaError_t e = bf16_map(&ta, p.a, p.K, p.M, G::BM);
      if (e == cudaSuccess) e = bf16_map(&tb, p.b, p.N, p.K, 64);
      if (e == cudaSuccess)
        e = opt_in<baseline_tc_tma_kernel<G>>(TmaLayout<G>::SMEM);
      if (e != cudaSuccess) return e;
      baseline_tc_tma_kernel<G><<<grid, G::THREADS, TmaLayout<G>::SMEM,
                                  stream>>>(ta, tb, (float*)p.out, p.M, p.N,
                                            p.K);
      return cudaGetLastError();
    }
  }
  cudaError_t e = opt_in<baseline_tc_kernel<G, In>>(Layout<G, In>::SMEM);
  if (e != cudaSuccess) return e;
  baseline_tc_kernel<G, In><<<grid, G::THREADS, Layout<G, In>::SMEM,
                              stream>>>(p);
  return cudaGetLastError();
}

// geom: 0 decode 16 x 64, 1 mid 64 x 64, 2 wide 128 x 128.
template <typename In>
cudaError_t launch_tc(Args p, int geom, cudaStream_t stream) {
  constexpr int EPC = 16 / (int)sizeof(In);
  p.a_vec = p.K % EPC == 0 && (uintptr_t)p.a % 16 == 0;
  p.b_vec = p.N % EPC == 0 && (uintptr_t)p.b % 16 == 0;
  if (geom == 0) return launch_geom<GDecode, In>(p, stream);
  if (geom == 1) return launch_geom<GMid, In>(p, stream);
  if (geom == 2) return launch_geom<GWide, In>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tc
