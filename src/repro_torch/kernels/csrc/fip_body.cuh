// The pipelined pair body of K2 (FIP, fip_gemm.cu), K3 (FFIP from the Eq. 9
// deltas y, ffip_gemm.cu) and K7's FIP and FFIP (conv_gemm.cu) on Hopper's
// CUDA cores. The pre-add (a_{i,2k-1} + b_{2k,j})(a_{i,2k} + b_{2k-1,j})
// couples i and j, so the pair product has no tensor-core mapping: each pair
// costs an output 2 FADD + 1 FFMA (int: 2 IADD + 1 IMAD), and that issue rate
// bounds the kernels at prefill; at decode the bytes of B (K3: of y) bound
// them.
//
// One CTA computes one (BM x BN) output tile of one group over a range of K,
// in 32-row k-tiles (16 whole pairs), through
//   - a ring of NS raw stages in shared memory filled by 16-byte cp.async
//     copies (4-byte for the carry table; plain loads where a row is not
//     16-byte aligned), issued NS tiles ahead of the tile computed. The A
//     stage comes from the kernel's A loader: DenseRows copies rows of a
//     row-major (M, K) matrix (K2, K3); ConvRows gathers the implicit im2col
//     matrix of a conv straight from the padded NHWC input (K7, Algorithm
//     1's multi-digit counter split into a per-row base, computed once per
//     CTA, and a per-column offset, once per k-tile);
//   - a transform of each raw stage into a double-buffered f32 / int32 tile,
//     one tile ahead of the compute: the first warps convert A (one thread
//     a row, stored k-major, with the row's alpha), the next BN / 32 warps
//     convert B or, for FFIP, rebuild it from y (one warp a 32-column group,
//     one lane a k row, a serial prefix sum), then, behind a barrier of
//     their own, each lane forms its column's beta;
//   - the pair products in a TM x TN register tile fed by 128-bit fragment
//     loads;
// with one barrier per k-tile. Groups (K7's grouped convs) are folded into
// grid.x: group g's B (or y and carry table) is the g-th (K, N) slice, and
// its output columns are g * N .. g * N + N - 1 of rows of stride ldo.
//
// FFIP rebuilds b without any sweep over N: b[k][32t + c] = C[k][t] + s_c,
// s_c = (((y[k][32t] + y[k][32t + 1]) + ...) + y[k][32t + c]), where C
// (K x ceil(N/32)) is the carry table (kernels/ffip_gemm.py::carry_table):
// the prefix of row k before column 32t, derived offline from y by chaining
// the same serial group totals. So a CTA rebuilds any tile alone, the
// rebuilt b does not depend on the tile width, and K3 has K2's grid.
//
// Sums, the same at every M, every tile geometry and either A loader (batch
// invariance; K7 equal to K2/K3 over the materialised A): per k-tile, in
// pair order, cross = sum (a_o + b_e)(a_e + b_o), alpha = sum a_o a_e,
// beta = sum b_o b_e; the tile's part (cross - alpha) - beta (Eqs. 2-4, 7)
// goes into the split's running sum in k order. K is cut into splits of
// `split_rows` rows, a function of K only (kernels/fip_gemm.py::split_plan):
// a row's result is the splits' sums added in split order. A CTA either
// sums every split itself (the running total in shared memory) or, where
// the grid would not fill the card, computes one split into a workspace
// slot, and reduce_units (common.cuh) adds the slots in the same order: the
// same bits either way.
#pragma once
#include <type_traits>

#include "common.cuh"

namespace fb {

constexpr int BK = 32;                       // k rows per tile
constexpr int PAIRS = BK / 2;
constexpr int SMEM_MAX = 227 * 1024;

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

using rt::cp_async16;
using rt::cp_async4;
using rt::cp_async_commit;
using rt::cp_async_wait;

// acc + x * y, one rounding for floats (the same instruction in every
// instantiation, so every geometry rounds alike).
__device__ __forceinline__ float mad(float x, float y, float acc) {
  return __fmaf_rn(x, y, acc);
}
__device__ __forceinline__ int mad(int x, int y, int acc) {
  return x * y + acc;
}

// Tile geometry: a BM x BN output tile, TM x TN outputs a thread. A thread's
// rows are ty * 4 + i (TM 4), with BM / 2 more for i >= 4 (TM 8), or ty
// (TM 1); its columns tx * 4 + j, with BN / 2 more for j >= 4 (TN 8).
template <int BM_, int BN_, int TM_, int TN_, int NSMAX_>
struct Geom {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int NSMAX = NSMAX_;
  static constexpr int TY = BM / TM, TX = BN / TN;
  static constexpr int THREADS = TX * TY;
  static constexpr int GROUPS = BN / 32;      // 32-column carry groups
  static constexpr int A_WARPS = (BM + 31) / 32;
  static_assert(A_WARPS + GROUPS <= THREADS / 32, "transform warps");
  static_assert(TM == 1 || (TM % 4 == 0 && BM == TY * 4 * (TM / 4)), "rows");
  static_assert(TN % 4 == 0 && BN == TX * 4 * (TN / 4), "columns");
  __device__ static __forceinline__ int row(int ty, int i) {
    return TM == 1 ? ty : (i / 4) * (BM / 2) + ty * 4 + (i % 4);
  }
  __device__ static __forceinline__ int col(int tx, int j) {
    return (j / 4) * (BN / 2) + tx * 4 + (j % 4);
  }
};

// Decode (M <= 16), mid (M <= 64) and wide tiles;
// kernels/fip_gemm.py::PAIR_GEOMS.
using GDecode = Geom<16, 32, 1, 4, 4>;
using GMid = Geom<64, 64, 4, 8, 3>;
using GWide = Geom<128, 128, 8, 8, 3>;

// The most raw stages (at least 2) that fit beside `rest` bytes.
constexpr int stages_fitting(int ns, int raw, int rest) {
  return (ns <= 2 || ns * raw + rest <= SMEM_MAX)
             ? ns
             : stages_fitting(ns - 1, raw, rest);
}

// 16 raw bytes of A or B -> their values in the accumulation type (bf16 ->
// f32 is exact: the bits moved up 16).
template <typename In> struct Raw;
template <> struct Raw<float> {
  static constexpr int PER = 4;
  __device__ static __forceinline__ void get(uint4 w, float* v) {
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  }
};
template <> struct Raw<__nv_bfloat16> {
  static constexpr int PER = 8;
  __device__ static __forceinline__ void get(uint4 w, float* v) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};
template <> struct Raw<int> {
  static constexpr int PER = 4;
  __device__ static __forceinline__ void get(uint4 w, int* v) {
    v[0] = (int)w.x;
    v[1] = (int)w.y;
    v[2] = (int)w.z;
    v[3] = (int)w.w;
  }
};
template <> struct Raw<int8_t> {
  static constexpr int PER = 16;
  __device__ static __forceinline__ void get(uint4 w, int* v) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[4 * i + q] = (int)(u[i] << (24 - 8 * q)) >> 24;
  }
};

template <typename T>
__device__ __forceinline__ T zero() {
  T v;
  memset(&v, 0, sizeof(T));
  return v;
}

// Shared-memory layout of one instantiation. Raw rows of A and B and the
// rows of the B tile are padded by 16 bytes, so the transform's threads,
// one a row, read and write them without bank conflicts; AUX bytes of the A
// loader's state follow; the tot region exists only in a launch whose CTAs
// sum more than one split.
template <class G, typename In, typename BIn, typename Acc, bool FFIP,
          int AUX = 0>
struct Layout {
  static constexpr int A_LD = BK * (int)sizeof(In) + 16;      // bytes
  static constexpr int A_RAW = G::BM * A_LD;
  static constexpr int B_RS = G::BN * (int)sizeof(BIn) + 16;  // bytes
  static constexpr int B_RAW = BK * B_RS;
  static constexpr int C_RAW = FFIP ? BK * G::GROUPS * (int)sizeof(Acc) : 0;
  static constexpr int RAW = A_RAW + B_RAW + C_RAW;
  static constexpr int T_AT = BK * G::BM * (int)sizeof(Acc);
  static constexpr int BTS = G::BN + 4;                       // elements
  static constexpr int T_BT = BK * BTS * (int)sizeof(Acc);
  static constexpr int T = T_AT + T_BT + (G::BM + G::BN) * (int)sizeof(Acc);
  static constexpr int TOT = G::BM * G::BN * (int)sizeof(Acc);
  static constexpr int NS = stages_fitting(G::NSMAX, RAW, 2 * T + AUX + TOT);
  static constexpr int BASE = NS * RAW + 2 * T;      // the loader's state
  static constexpr int TOT_AT = BASE + AUX;
  static_assert(TOT_AT + TOT <= SMEM_MAX, "shared memory");
};

// A conv's geometry (K7): the NHWC input, already spatially padded to
// (h, w); M = batch * oh * ow output pixels; A column k < k_real is (kh, kw,
// c), the group's channel c at kernel offset (kh, kw).
struct ConvShape {
  int h, w, cin, cin_g, kw, sh, sw, oh, ow, k_real;
};

struct PairArgs {
  const void* a;      // (M, K) row-major, In; K7: the padded NHWC input
  const void* b;      // (groups, K, N) row-major: B (In) or y (FFIP, Acc)
  const void* carry;  // FFIP: (groups, K, ceil(N / 32)) carry table, Acc
  void* out;          // (M, ldo), or the (splits, M, ldo) workspace
  int M, N, K;        // N: a group's columns
  int groups, ldo;    // ldo = groups * N
  int split_rows;     // rows of one split (a multiple of BK)
  int split_cta;      // 1: blockIdx.z is the split; 0: a CTA sums all
  int fold_beta;
  int a_vec, b_vec;   // rows 16-byte aligned: cp.async, else plain loads
  ConvShape conv;     // ConvRows only
};

// -- A loaders: the (BM x BK) raw A stage of the k-tile at k0 ----------------
// Elements at rows past M, at columns from k_hi (K, or the split's end) and,
// for a conv, from k_real (the evenized K's zero column) are zero: the
// reference's zero padding, exact in the pair algebra. Both loaders put the
// same values in the stage for the same A, so K7 sums what K2 and K3 sum
// over the materialised im2col matrix.
template <class G, typename In>
struct DenseRows {
  static constexpr int AUX = 0;
  __device__ DenseRows(const PairArgs&, int, int, int*) {}
  static bool vec(const PairArgs& p) {
    return p.K % (16 / (int)sizeof(In)) == 0 && (uintptr_t)p.a % 16 == 0;
  }
  __device__ __forceinline__ void load(const PairArgs& p, unsigned char* r,
                                       int a_ld, int m0, int k0,
                                       int k_hi) const {
    constexpr int BM = G::BM, THREADS = G::THREADS;
    const int tid = threadIdx.x;
    const In* A = (const In*)p.a;
    constexpr int EA = 16 / (int)sizeof(In);       // elements a chunk
    constexpr int CA = BK / EA;                      // chunks a row
    if (p.a_vec) {
      for (int i = tid; i < BM * CA; i += THREADS) {
        const int row = i / CA, c = i % CA;
        const int gm = m0 + row, gk = k0 + c * EA;
        const bool ok = gm < p.M && gk < k_hi;
        cp_async16(r + row * a_ld + c * 16,
                   ok ? (const void*)(A + (long long)gm * p.K + gk) : p.a,
                   ok);
      }
    } else {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int row = i / BK, c = i % BK;
        const int gm = m0 + row, gk = k0 + c;
        In v = zero<In>();
        if (gm < p.M && gk < k_hi) v = A[(long long)gm * p.K + gk];
        ((In*)(r + row * a_ld))[c] = v;
      }
    }
  }
};

// Algorithm 1's multi-digit counter, split as the hardware splits it: the
// address of A[m][k] is base(m) + offset(k). The bases of the tile's rows
// (the window corner of each output pixel, -1 past M) are computed once per
// CTA into shared memory; each thread keeps one chunk column (one column
// with plain loads) of the stage, so it forms one offset a k-tile. A 16-byte
// chunk never crosses a (kh, kw) tap: cp.async only where cin_g is a whole
// number of chunks (4 f32, 16 int8) and the input is 16-byte aligned.
template <class G, typename In>
struct ConvRows {
  static constexpr int AUX = G::BM * (int)sizeof(int);
  const int* base;
  int g_off;          // the group's first input channel
  __device__ ConvRows(const PairArgs& p, int m0, int group, int* aux)
      : base(aux), g_off(group * p.conv.cin_g) {
    const ConvShape& c = p.conv;
    const int per_img = c.oh * c.ow;
    for (int r = threadIdx.x; r < G::BM; r += G::THREADS) {
      const int m = m0 + r;
      int b = -1;
      if (m < p.M) {
        const int img = m / per_img, rem = m - img * per_img;
        const int oh = rem / c.ow, ow = rem - oh * c.ow;
        b = ((img * c.h + oh * c.sh) * c.w + ow * c.sw) * c.cin;
      }
      aux[r] = b;
    }
  }
  static bool vec(const PairArgs& p) {
    return p.conv.cin_g % (16 / (int)sizeof(In)) == 0 &&
           (uintptr_t)p.a % 16 == 0;
  }
  // the input offset of A column k: the tap (kh, kw), the group's channel
  __device__ __forceinline__ int offset(const PairArgs& p, int k) const {
    const ConvShape& c = p.conv;
    const int row_len = c.kw * c.cin_g;
    const int kh_i = k / row_len, rem = k - kh_i * row_len;
    const int kw_i = rem / c.cin_g;
    return (kh_i * c.w + kw_i) * c.cin + g_off + (rem - kw_i * c.cin_g);
  }
  __device__ __forceinline__ void load(const PairArgs& p, unsigned char* r,
                                       int a_ld, int /*m0*/, int k0,
                                       int k_hi) const {
    constexpr int BM = G::BM, THREADS = G::THREADS;
    const int tid = threadIdx.x;
    const In* X = (const In*)p.a;
    if (p.a_vec) {
      // k_real is a whole number of chunks and K = k_real: a chunk is in
      // or out
      constexpr int EA = 16 / (int)sizeof(In), CA = BK / EA;
      static_assert(THREADS % CA == 0, "one chunk column a thread");
      const int c = tid % CA, k = k0 + c * EA;
      const bool kv = k < k_hi;
      const int off = kv ? offset(p, k) : 0;
      for (int i = tid; i < BM * CA; i += THREADS) {
        const int row = i / CA, b = base[row];
        const bool ok = kv && b >= 0;
        cp_async16(r + row * a_ld + c * 16,
                   ok ? (const void*)(X + b + off) : p.a, ok);
      }
    } else {
      static_assert(THREADS % BK == 0, "one column a thread");
      const int c = tid % BK, k = k0 + c;
      const bool kv = k < k_hi && k < p.conv.k_real;
      const int off = kv ? offset(p, k) : 0;
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int row = i / BK, b = base[row];
        In v = zero<In>();
        if (kv && b >= 0) v = X[b + off];
        ((In*)(r + row * a_ld))[c] = v;
      }
    }
  }
};

template <class G, typename In, typename BIn, typename Acc, bool FFIP,
          template <class, typename> class AL>
__device__ __forceinline__ void pair_body(const PairArgs& p) {
  using Loader = AL<G, In>;
  using L = Layout<G, In, BIn, Acc, FFIP, Loader::AUX>;
  using V4 = typename Vec4<Acc>::type;
  constexpr int BM = G::BM, BN = G::BN, TM = G::TM, TN = G::TN;
  constexpr int NS = L::NS, THREADS = G::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % G::TX, ty = tid / G::TX;
  const int n_blocks = (p.N + BN - 1) / BN;
  const int grp = blockIdx.x / n_blocks;
  const int n0 = (blockIdx.x - grp * n_blocks) * BN, m0 = blockIdx.y * BM;
  const int splits = (p.K + p.split_rows - 1) / p.split_rows;
  const int s_lo = p.split_cta ? blockIdx.z : 0;
  const int s_hi = p.split_cta ? blockIdx.z + 1 : splits;
  const int k_lo = s_lo * p.split_rows;
  const int k_hi = min(s_hi * p.split_rows, p.K);
  const int nt = (k_hi - k_lo + BK - 1) / BK;
  const bool multi = s_hi - s_lo > 1;
  const bool live = m0 + G::row(ty, 0) < p.M;
  const int ngroups = (p.N + 31) / 32;
  const BIn* B = (const BIn*)p.b + (long long)grp * p.K * p.N;
  const Acc* Cy =
      FFIP ? (const Acc*)p.carry + (long long)grp * p.K * ngroups : nullptr;

  auto raw = [&](int slot) { return smem + slot * L::RAW; };
  auto tbuf = [&](int slot) { return smem + NS * L::RAW + slot * L::T; };
  Acc* tot = (Acc*)(smem + L::TOT_AT);
  const Loader a_rows(p, m0, grp, (int*)(smem + L::BASE));
  if constexpr (Loader::AUX > 0) __syncthreads();   // the loader's state

  // -- issue the copies of k-tile t into raw slot t % NS ---------------------
  auto issue = [&](int t) {
    if (t < nt) {
      unsigned char* r = raw(t % NS);
      const int k0 = k_lo + t * BK;
      a_rows.load(p, r, L::A_LD, m0, k0, k_hi);
      // B or y: BK rows x BN columns
      unsigned char* rb = r + L::A_RAW;
      constexpr int EB = 16 / (int)sizeof(BIn);
      constexpr int CB = BN / EB;
      if (p.b_vec) {
        for (int i = tid; i < BK * CB; i += THREADS) {
          const int row = i / CB, c = i % CB;
          const int gk = k0 + row, gn = n0 + c * EB;
          const bool ok = gk < k_hi && gn < p.N;
          cp_async16(rb + row * L::B_RS + c * 16,
                     ok ? (const void*)(B + (long long)gk * p.N + gn) : p.b,
                     ok);
        }
      } else {
        for (int i = tid; i < BK * BN; i += THREADS) {
          const int row = i / BN, c = i % BN;
          const int gk = k0 + row, gn = n0 + c;
          BIn v = zero<BIn>();
          if (gk < k_hi && gn < p.N) v = B[(long long)gk * p.N + gn];
          ((BIn*)(rb + row * L::B_RS))[c] = v;
        }
      }
      if constexpr (FFIP) {
        Acc* rc = (Acc*)(rb + L::B_RAW);
        for (int i = tid; i < BK * G::GROUPS; i += THREADS) {
          const int row = i / G::GROUPS, g = i % G::GROUPS;
          const int gk = k0 + row, gt = n0 / 32 + g;
          const bool ok = gk < k_hi && gt < ngroups;
          cp_async4(rc + i,
                    ok ? (const void*)(Cy + (long long)gk * ngroups + gt)
                       : p.carry,
                    ok);
        }
      }
    }
    cp_async_commit();
  };

  // -- raw slot of k-tile t -> f32 / int32 tile buffer t % 2 -----------------
  auto transform = [&](int t) {
    const unsigned char* r = raw(t % NS);
    unsigned char* tb = tbuf(t % 2);
    Acc* At = (Acc*)tb;                               // [BK][BM]
    Acc* Bt = (Acc*)(tb + L::T_AT);                   // [BK][BTS]
    Acc* alpha = (Acc*)(tb + L::T_AT + L::T_BT);      // [BM]
    Acc* beta = alpha + BM;                           // [BN]
    if (tid < BM) {
      // one A row: convert, store k-major, Eq. 3 alpha in pair order
      const uint4* src = (const uint4*)(r + tid * L::A_LD);
      Acc v[BK];
#pragma unroll
      for (int c = 0; c < BK / Raw<In>::PER; ++c)
        Raw<In>::get(src[c], v + c * Raw<In>::PER);
      Acc al = Acc(0);
#pragma unroll
      for (int q = 0; q < PAIRS; ++q) al = mad(v[2 * q], v[2 * q + 1], al);
#pragma unroll
      for (int k = 0; k < BK; ++k) At[k * BM + tid] = v[k];
      alpha[tid] = al;
    } else if (warp >= G::A_WARPS && warp < G::A_WARPS + G::GROUPS) {
      // one k row (the lane) of one 32-column group (the warp): b, for K3
      // rebuilt from y by a serial prefix sum on the row's carry
      const int g = warp - G::A_WARPS;
      const uint4* src = (const uint4*)(r + L::A_RAW + lane * L::B_RS +
                                        g * 32 * (int)sizeof(BIn));
      Acc v[32];
#pragma unroll
      for (int c = 0; c < 32 / Raw<BIn>::PER; ++c)
        Raw<BIn>::get(src[c], v + c * Raw<BIn>::PER);
      if constexpr (FFIP) {
        const Acc base =
            ((const Acc*)(r + L::A_RAW + L::B_RAW))[lane * G::GROUPS + g];
        Acc s = v[0];
        v[0] = base + s;
#pragma unroll
        for (int c = 1; c < 32; ++c) {
          s = s + v[c];
          v[c] = base + s;
        }
      }
      Acc* dst = Bt + lane * L::BTS + g * 32;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *(V4*)(dst + 4 * c) = V4{v[4 * c], v[4 * c + 1], v[4 * c + 2],
                                 v[4 * c + 3]};
      // the group's rows are in place: Eq. 4 beta of column g * 32 + lane,
      // in pair order
      asm volatile("bar.sync 1, %0;\n" ::"r"(G::GROUPS * 32) : "memory");
      const int col = g * 32 + lane;
      Acc be = Acc(0);
#pragma unroll
      for (int q = 0; q < PAIRS; ++q)
        be = mad(Bt[(2 * q) * L::BTS + col], Bt[(2 * q + 1) * L::BTS + col],
                 be);
      beta[col] = p.fold_beta ? Acc(0) : be;
    }
  };

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);
  bool first = true;

  for (int t = 0; t < NS; ++t) issue(t);
  cp_async_wait<NS - 1>();
  __syncthreads();
  transform(0);

  for (int t = 0; t < nt; ++t) {
    // tile t + 1 has landed, and every thread is done with raw slot t % NS
    // (transformed last iteration) and with tile buffer (t + 1) % 2
    cp_async_wait<NS - 2>();
    __syncthreads();
    issue(t + NS);
    if (t + 1 < nt) transform(t + 1);

    // the pair products of tile t, by threads that own a row below M (at
    // decode, M = slots: whole warps of padding rows skip them)
    if (live) {
      const unsigned char* tb = tbuf(t % 2);
      const Acc* At = (const Acc*)tb;
      const Acc* Bt = (const Acc*)(tb + L::T_AT);
      const Acc* alpha = (const Acc*)(tb + L::T_AT + L::T_BT);
      const Acc* beta = alpha + BM;
      Acc cross[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) cross[i][j] = Acc(0);
#pragma unroll
      for (int q = 0; q < PAIRS; ++q) {
        Acc ao[TM], ae[TM], bo[TN], be[TN];
        if constexpr (TM == 1) {
          ao[0] = At[(2 * q) * BM + ty];
          ae[0] = At[(2 * q + 1) * BM + ty];
        } else {
#pragma unroll
          for (int h = 0; h < TM / 4; ++h) {
            const V4 o = *(const V4*)&At[(2 * q) * BM + G::row(ty, 4 * h)];
            const V4 e = *(const V4*)&At[(2 * q + 1) * BM + G::row(ty, 4 * h)];
            ao[4 * h] = o.x; ao[4 * h + 1] = o.y;
            ao[4 * h + 2] = o.z; ao[4 * h + 3] = o.w;
            ae[4 * h] = e.x; ae[4 * h + 1] = e.y;
            ae[4 * h + 2] = e.z; ae[4 * h + 3] = e.w;
          }
        }
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const V4 o = *(const V4*)&Bt[(2 * q) * L::BTS + G::col(tx, 4 * h)];
          const V4 e =
              *(const V4*)&Bt[(2 * q + 1) * L::BTS + G::col(tx, 4 * h)];
          bo[4 * h] = o.x; bo[4 * h + 1] = o.y;
          bo[4 * h + 2] = o.z; bo[4 * h + 3] = o.w;
          be[4 * h] = e.x; be[4 * h + 1] = e.y;
          be[4 * h + 2] = e.z; be[4 * h + 3] = e.w;
        }
        // (a_{i,2k-1} + b_{2k,j}) (a_{i,2k} + b_{2k-1,j})
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            cross[i][j] = mad(ao[i] + be[j], ae[i] + bo[j], cross[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const Acc al = alpha[G::row(ty, i)];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += (cross[i][j] - al) - beta[G::col(tx, j)];
      }
    }

    // a split closes: its sum joins the running total (split order)
    const int k_end = k_lo + (t + 1) * BK;
    if (multi && (k_end % p.split_rows == 0 || t + 1 == nt)) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          Acc* s = &tot[(i * TN + j) * THREADS + tid];
          *s = first ? acc[i][j] : *s + acc[i][j];
          acc[i][j] = Acc(0);
        }
      first = false;
    }
  }
  cp_async_wait<0>();

  Acc* o = (Acc*)p.out + (long long)grp * p.N +
           (p.split_cta ? (long long)blockIdx.z * p.M * p.ldo : 0LL);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + G::row(ty, i);
    if (gm >= p.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + G::col(tx, j);
      if (gn < p.N)
        o[(long long)gm * p.ldo + gn] =
            multi ? tot[(i * TN + j) * THREADS + tid] : acc[i][j];
    }
  }
}

// K2's, K3's and K7's kernels: the same body, four names (profiles tell
// them apart; kernels/conv_gemm.py's are grouped by their conv_ prefix).
template <class G, typename In, typename Acc>
__global__ void __launch_bounds__(G::THREADS) fip_pair_kernel(PairArgs p) {
  pair_body<G, In, In, Acc, false, DenseRows>(p);
}

template <class G, typename In, typename Acc>
__global__ void __launch_bounds__(G::THREADS) ffip_pair_kernel(PairArgs p) {
  pair_body<G, In, Acc, Acc, true, DenseRows>(p);
}

template <class G, typename In, typename Acc>
__global__ void __launch_bounds__(G::THREADS)
conv_fip_pair_kernel(PairArgs p) {
  pair_body<G, In, In, Acc, false, ConvRows>(p);
}

template <class G, typename In, typename Acc>
__global__ void __launch_bounds__(G::THREADS)
conv_ffip_pair_kernel(PairArgs p) {
  pair_body<G, In, Acc, Acc, true, ConvRows>(p);
}

template <class G, typename In, typename BIn, typename Acc, bool FFIP,
          template <class, typename> class AL>
cudaError_t launch_geom(const PairArgs& p, Acc* out, Acc* ws,
                        cudaStream_t stream) {
  constexpr bool CONV = std::is_same_v<AL<G, In>, ConvRows<G, In>>;
  using L = Layout<G, In, BIn, Acc, FFIP, AL<G, In>::AUX>;
  void (*kern)(PairArgs);
  if constexpr (CONV && FFIP)
    kern = conv_ffip_pair_kernel<G, In, Acc>;
  else if constexpr (CONV)
    kern = conv_fip_pair_kernel<G, In, Acc>;
  else if constexpr (FFIP)
    kern = ffip_pair_kernel<G, In, Acc>;
  else
    kern = fip_pair_kernel<G, In, Acc>;
  const int splits = (p.K + p.split_rows - 1) / p.split_rows;
  const bool multi = !p.split_cta && splits > 1;
  const int smem = L::TOT_AT + (multi ? L::TOT : 0);
  static bool opted_in = false;     // once per instantiation
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::TOT_AT + L::TOT);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const long long m_blocks = (p.M + G::BM - 1) / G::BM;
  const long long n_blocks = (long long)(p.N + G::BN - 1) / G::BN * p.groups;
  if (m_blocks > 65535 || splits > 65535 || n_blocks >= (1LL << 31))
    return cudaErrorInvalidValue;
  dim3 grid((unsigned)n_blocks, (unsigned)m_blocks, p.split_cta ? splits : 1);
  PairArgs q = p;
  q.out = p.split_cta && splits > 1 ? (void*)ws : (void*)out;
  kern<<<grid, G::THREADS, smem, stream>>>(q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (p.split_cta && splits > 1)
    rt::launch_reduce<Acc>(ws, out, splits, (long long)p.M * p.ldo, stream);
  return cudaGetLastError();
}

// geom: 0 decode (16 x 32), 1 mid (64 x 64), 2 wide (128 x 128). AL: the A
// loader, DenseRows (K2, K3) or ConvRows (K7).
template <typename In, typename BIn, typename Acc, bool FFIP,
          template <class, typename> class AL = DenseRows>
cudaError_t launch_pair(PairArgs p, int geom, Acc* out, Acc* ws,
                        cudaStream_t stream) {
  if (p.split_rows <= 0 || p.split_rows % BK || p.groups < 1 ||
      p.ldo < p.groups * p.N)
    return cudaErrorInvalidValue;
  const int eb = 16 / (int)sizeof(BIn);
  p.a_vec = AL<GDecode, In>::vec(p);
  p.b_vec = p.N % eb == 0 && (uintptr_t)p.b % 16 == 0;
  if (geom == 0)
    return launch_geom<GDecode, In, BIn, Acc, FFIP, AL>(p, out, ws, stream);
  if (geom == 1)
    return launch_geom<GMid, In, BIn, Acc, FFIP, AL>(p, out, ws, stream);
  if (geom == 2)
    return launch_geom<GWide, In, BIn, Acc, FFIP, AL>(p, out, ws, stream);
  return cudaErrorInvalidValue;
}

}  // namespace fb
