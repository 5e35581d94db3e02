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
// carries h in VMEM scratch between grid steps. Here every state's
// recurrence is one thread's serial loop over t, h in registers; nothing
// carries between CTAs.
//
// Geometry (kernels/selective_scan.py::scan_plan is its mirror, and
// selective_scan_plan below reports it): a CTA is 128 threads, LANES =
// N / SPT threads a channel, each with SPT consecutive states, and
// CH = 128 / LANES channels. SPT is the largest of the choices for N that
// still puts 24 warps on each of the 132 SMs, else the smallest: at falcon
// prefill (B 1, di 8192, N 16) one state a thread, 1024 CTAs of 8
// channels, 31 warps an SM in one wave (four times the 7.75 of the
// four-threads-a-channel design before it); at B 2, two states a thread.
//
// A tile is TT = 16 / SPT steps. Its operands arrive by 16-byte loads, one
// tile ahead, into registers, and are converted to f32 once into a
// two-slot shared ring: (dt, dt x) for each channel (the product every lane
// of the channel needs, formed once) and (b, c) for each lane's states (the
// rows every channel shares), each laid out so that one 16-byte shared
// load serves two steps. In the step loop a thread updates its states and
// writes the rounded products h_t c_t into a shared (TT x CH x N) tile,
// swizzled so that neither its writes nor the row reads below conflict.
// After the tile's steps one thread a (step, channel) sums its N products
// and writes y, coalesced, rounded to its type once. So the loop carries no
// shuffle and no y store, and where chunk is a multiple of TT (every served
// and trained case) the h_starts checkpoint is written at tile starts, out
// of the loop; other chunks take a variant that checks each step.
//
// Bound: issue slots, then the special-function units, then bytes. Each
// (t, d, n) takes ~15 instructions in the step loop (the accurate expf's 8,
// dt a, (dt x) b, the h update's multiply and add, h c, its shared store,
// half a shared load) and ~1.4 in the sum (chip_smoke.py's
// scan_fwd_issue_ms), against one exponential on the SFUs and ~8 MB of
// inputs and outputs at the served shape.
//
// The bits equal selective_scan_plain's: expf is the accurate one (no fast
// math), products and sums are rounded one by one (__fmul_rn / __fadd_rn,
// no FMA contraction), each state's h is sequential in t, and y's sum over N
// is _sum_states's order: four partials of N/4 consecutive states, each
// left to right, then (0 + 1) + (2 + 3).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 8;           // 1024 CTAs of B 1, di 8192 in a wave
constexpr int SMS = 132;
constexpr int WARPS_PER_SM = 24;        // the plan's target

template <typename T, int N, int SPT>
struct Geo {
  static constexpr int LANES = N / SPT;          // threads a channel
  static constexpr int CH = THREADS / LANES;     // channels a CTA
  static constexpr int TT = 16 / SPT;            // steps a tile
  static constexpr int V = 16 / (int)sizeof(T);  // elements a 16-byte load
  static constexpr int XCH = TT * CH / V;        // x (and dt) loads a tile
  static constexpr int BCH = TT * N / V;         // b (and c) loads a tile
  static constexpr int ITEMS = (XCH + BCH + THREADS - 1) / THREADS;
  static constexpr int DDS = 2 * TT + 4;         // a channel's (dt, dt x) row
  static constexpr int BCS = 2 * TT * SPT + 4;   // a lane's (b, c) row
  static constexpr int QR = N / 4;               // 16-byte quads a P row
  static constexpr int DD = CH * DDS;
  static constexpr int BC = LANES * BCS;
  static constexpr int P = TT * CH * N;          // products, row (step, ch)
  static constexpr int FLOATS = 2 * DD + 2 * BC + P;
  static_assert(CH % V == 0 && (TT * N) % V == 0 && TT % 2 == 0, "geometry");
};

// The quad swizzle of P row `row`: eight consecutive rows read at one quad
// index land on eight distinct bank quads.
template <int QR>
__device__ __forceinline__ int swz(int row) {
  return QR >= 8 ? (row & 7) : (((row * QR) >> 3) & (QR - 1));
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// An element's bits: the staging registers hold raw 16-byte chunks, read
// back as f32 exactly (a bf16 is the high half of its f32).
template <typename T>
struct Bits {
  using type = uint32_t;
  static __device__ __forceinline__ float f32(uint32_t b) {
    return __uint_as_float(b);
  }
};
template <>
struct Bits<__nv_bfloat16> {
  using type = uint16_t;
  static __device__ __forceinline__ float f32(uint16_t b) {
    return __uint_as_float((uint32_t)b << 16);
  }
};

template <typename T, int V>
union Chunk {
  uint4 u;
  typename Bits<T>::type e[V];
};

template <bool B>
struct Whole {
  static constexpr bool value = B;
};

// One 16-byte load of p and of q at element off, or element by element for
// the first `n` (the rest zero) where the chunk is short or misaligned.
template <typename T, int V>
__device__ __forceinline__ void load2(const T* __restrict__ p,
                                      const T* __restrict__ q, long long off,
                                      int n, bool vec, uint4& u, uint4& w) {
  if (vec && n == V) {
    u = __ldg(reinterpret_cast<const uint4*>(p + off));
    w = __ldg(reinterpret_cast<const uint4*>(q + off));
    return;
  }
  using B = typename Bits<T>::type;
  const B* pb = reinterpret_cast<const B*>(p) + off;
  const B* qb = reinterpret_cast<const B*>(q) + off;
  Chunk<T, V> a, b;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    a.e[e] = e < n ? pb[e] : B(0);
    b.e[e] = e < n ? qb[e] : B(0);
  }
  u = a.u;
  w = b.u;
}

template <typename T, int N, int SPT, bool CKPT_IN_LOOP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const T* __restrict__ bmat, const T* __restrict__ cmat,
                      const float* __restrict__ a, const float* __restrict__ h0,
                      T* __restrict__ y, float* __restrict__ h_final,
                      float* __restrict__ h_starts, int S, int di, int chunk,
                      int vec_x, int vec_b) {
  using G = Geo<T, N, SPT>;
  constexpr int CH = G::CH, TT = G::TT, V = G::V;
  __shared__ __align__(16) float smem[G::FLOATS];
  float* const dd = smem;                  // [2][CH][DDS]
  float* const bc = smem + 2 * G::DD;      // [2][LANES][BCS]
  float* const pt = bc + 2 * G::BC;        // [TT * CH][N], swizzled quads

  const int bi = blockIdx.y;
  const int ch0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int cl = tid / G::LANES;           // channel within the CTA
  const int q = tid % G::LANES;            // which SPT states
  const int ch = ch0 + cl;
  const bool valid = ch < di;
  const int n0 = q * SPT;
  const int n_chunks = S / chunk;
  const int ntiles = (S + TT - 1) / TT;

  float av[SPT], h[SPT];
  const long long hoff = ((long long)bi * di + ch) * N + n0;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    av[j] = valid ? a[(long long)ch * N + n0 + j] : 0.f;
    h[j] = valid ? h0[hoff + j] : 0.f;
  }
  const long long xbase = (long long)bi * S * di;
  const long long bbase = (long long)bi * S * N;

  // one tile's operands in registers: item i < XCH is the x and dt chunk of
  // (step i / (CH / V), channels V (i % (CH / V)) ...); the rest the b and
  // c chunks of the tile's contiguous (TT x N) block
  uint4 ru[G::ITEMS], rw[G::ITEMS];
  auto load = [&](int t0) {
#pragma unroll
    for (int k = 0; k < G::ITEMS; ++k) {
      const int i = tid + k * THREADS;
      if (i < G::XCH) {
        const int r = i / (CH / V), c = (i % (CH / V)) * V;
        const int n = t0 + r < S ? min(V, max(0, di - ch0 - c)) : 0;
        load2<T, V>(x, dt, xbase + (long long)(t0 + r) * di + ch0 + c, n,
                    vec_x, ru[k], rw[k]);
      } else if (i < G::XCH + G::BCH) {
        const int e = (i - G::XCH) * V;
        const int n = min(V, max(0, min(TT, S - t0) * N - e));
        load2<T, V>(bmat, cmat, bbase + (long long)t0 * N + e, n, vec_b,
                    ru[k], rw[k]);
      }
    }
  };
  // the registers, converted once, into ring slot `slot`
  auto store = [&](int slot) {
#pragma unroll
    for (int k = 0; k < G::ITEMS; ++k) {
      const int i = tid + k * THREADS;
      Chunk<T, V> u, w;
      u.u = ru[k];
      w.u = rw[k];
      if (i < G::XCH) {
        const int r = i / (CH / V), c = (i % (CH / V)) * V;
        float* row = dd + slot * G::DD + 2 * r;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = Bits<T>::f32(w.e[e]);
          *reinterpret_cast<float2*>(row + (c + e) * G::DDS) =
              make_float2(d, __fmul_rn(d, Bits<T>::f32(u.e[e])));
        }
      } else if (i < G::XCH + G::BCH) {
        const int e0 = (i - G::XCH) * V;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int r = (e0 + e) / N, n = (e0 + e) % N;
          *reinterpret_cast<float2*>(bc + slot * G::BC + (n / SPT) * G::BCS +
                                     2 * (r * SPT + n % SPT)) =
              make_float2(Bits<T>::f32(u.e[e]), Bits<T>::f32(w.e[e]));
        }
      }
    }
  };
  auto checkpoint = [&](int t) {
    if (!valid) return;
    float* dst = h_starts +
                 (((long long)bi * n_chunks + t / chunk) * di + ch) * N + n0;
#pragma unroll
    for (int j = 0; j < SPT; ++j) dst[j] = h[j];
  };

  int next_ck = 0;                     // the next chunk start (general path)
  // The tile's steps from ring slot `slot`; WHOLE (tn == TT) drops the step
  // guards.
  auto steps = [&](auto whole, int slot, int t0, int tn) {
    constexpr bool WHOLE = decltype(whole)::value;
    const float* ddr = dd + slot * G::DD + cl * G::DDS;
    const float* bcr = bc + slot * G::BC + q * G::BCS;
#pragma unroll
    for (int r2 = 0; r2 < TT; r2 += 2) {
      const float4 d4 = *reinterpret_cast<const float4*>(ddr + 2 * r2);
      float bv[4 * SPT];
#pragma unroll
      for (int k = 0; k < SPT; ++k)
        *reinterpret_cast<float4*>(bv + 4 * k) =
            *reinterpret_cast<const float4*>(bcr + 2 * SPT * r2 + 4 * k);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int r = r2 + s;
        if (!WHOLE && r >= tn) continue;
        if constexpr (CKPT_IN_LOOP) {
          if (t0 + r == next_ck) {
            checkpoint(t0 + r);
            next_ck += chunk;
          }
        }
        const float d = s ? d4.z : d4.x;
        const float dxv = s ? d4.w : d4.y;
        float pv[SPT];
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          const float da = expf(__fmul_rn(d, av[j]));
          h[j] = __fadd_rn(__fmul_rn(da, h[j]),
                           __fmul_rn(dxv, bv[2 * (s * SPT + j)]));
          pv[j] = __fmul_rn(h[j], bv[2 * (s * SPT + j) + 1]);
        }
        const int row = r * CH + cl;
        float* dst = pt + row * N + 4 * ((n0 / 4) ^ swz<G::QR>(row)) + n0 % 4;
        if constexpr (SPT == 1) {
          *dst = pv[0];
        } else if constexpr (SPT == 2) {
          *reinterpret_cast<float2*>(dst) = make_float2(pv[0], pv[1]);
        } else {
          *reinterpret_cast<float4*>(dst) =
              make_float4(pv[0], pv[1], pv[2], pv[3]);
        }
      }
    }
  };
  // y of the tile's (step, channel) pairs, summed in _sum_states's order
  auto sum_y = [&](int t0, int tn) {
    constexpr int QN = N / 4;
    for (int i = tid; i < TT * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      if (r >= tn || ch0 + c >= di) continue;
      const float* prow = pt + i * N;
      const int f = swz<G::QR>(i);
      float e[N];
#pragma unroll
      for (int k = 0; k < G::QR; ++k)
        *reinterpret_cast<float4*>(e + 4 * k) =
            *reinterpret_cast<const float4*>(prow + 4 * (k ^ f));
      float part[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        part[p] = e[p * QN];
#pragma unroll
        for (int j = 1; j < QN; ++j) part[p] = __fadd_rn(part[p], e[p * QN + j]);
      }
      st(y + xbase + (long long)(t0 + r) * di + ch0 + c,
         __fadd_rn(__fadd_rn(part[0], part[1]), __fadd_rn(part[2], part[3])));
    }
  };

  load(0);
  store(0);
  __syncthreads();
  if (ntiles > 1) load(TT);
  for (int i = 0; i < ntiles; ++i) {
    const int t0 = i * TT, tn = min(TT, S - t0), slot = i & 1;
    if constexpr (!CKPT_IN_LOOP) {
      if (t0 % chunk == 0) checkpoint(t0);
    }
    if (tn == TT)
      steps(Whole<true>{}, slot, t0, tn);
    else
      steps(Whole<false>{}, slot, t0, tn);
    if (i + 1 < ntiles) store(slot ^ 1);
    __syncthreads();                   // products written, next slot ready
    if (i + 2 < ntiles) load(t0 + 2 * TT);   // in flight over two phases
    sum_y(t0, tn);
    __syncthreads();                   // products read
  }
  if (valid) {
#pragma unroll
    for (int j = 0; j < SPT; ++j) h_final[hoff + j] = h[j];
  }
}

// The launch plan: states a thread, lanes a channel, channels a CTA, CTAs
// along di (the grid is (that, B)). The choices for N, fewest threads first.
struct Plan {
  int spt, lanes, ch, grid_x;
};

Plan make_plan(int B, int di, int N) {
  int choices[2] = {0, 0};
  switch (N) {
    case 4: choices[0] = 1; break;
    case 8: choices[0] = 2; choices[1] = 1; break;
    case 16: choices[0] = 2; choices[1] = 1; break;
    case 32: choices[0] = 2; break;
    case 64: choices[0] = 4; break;
    default: return Plan{0, 0, 0, 0};
  }
  Plan p{0, 0, 0, 0};
  for (int spt : choices) {
    if (spt == 0) break;
    p.spt = spt;
    p.lanes = N / spt;
    p.ch = THREADS / p.lanes;
    p.grid_x = (di + p.ch - 1) / p.ch;
    if ((long long)B * p.grid_x * (THREADS / 32) >=
        (long long)WARPS_PER_SM * SMS)
      break;
  }
  return p;
}

template <typename T, int N, int SPT>
cudaError_t launch(const void* x, const void* dt, const void* b, const void* c,
                   const float* a, const float* h0, void* y, float* h_final,
                   float* h_starts, int B, int S, int di, int chunk, int grid_x,
                   cudaStream_t stream) {
  constexpr int V = Geo<T, N, SPT>::V;
  auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec_x = al(x) && al(dt) && di % V == 0;
  const int vec_b = al(b) && al(c) && ((long long)S * N) % V == 0;
  dim3 grid(grid_x, B);
  if (chunk % Geo<T, N, SPT>::TT == 0)
    selective_scan_kernel<T, N, SPT, false><<<grid, THREADS, 0, stream>>>(
        (const T*)x, (const T*)dt, (const T*)b, (const T*)c, a, h0, (T*)y,
        h_final, h_starts, S, di, chunk, vec_x, vec_b);
  else
    selective_scan_kernel<T, N, SPT, true><<<grid, THREADS, 0, stream>>>(
        (const T*)x, (const T*)dt, (const T*)b, (const T*)c, a, h0, (T*)y,
        h_final, h_starts, S, di, chunk, vec_x, vec_b);
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* b,
                     const void* c, const float* a, const float* h0, void* y,
                     float* h_final, float* h_starts, int B, int S, int di,
                     int N, int chunk, cudaStream_t s) {
  const Plan p = make_plan(B, di, N);
#define SCAN_CASE(NN, SS)                                                    \
  if (N == NN && p.spt == SS)                                                \
    return launch<T, NN, SS>(x, dt, b, c, a, h0, y, h_final, h_starts, B, S, \
                             di, chunk, p.grid_x, s);
  SCAN_CASE(4, 1)
  SCAN_CASE(8, 2)
  SCAN_CASE(8, 1)
  SCAN_CASE(16, 2)
  SCAN_CASE(16, 1)
  SCAN_CASE(32, 2)
  SCAN_CASE(64, 4)
#undef SCAN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// The plan selective_scan_launch takes for (B, di, N): out = (states a
// thread, lanes a channel, channels a CTA, grid x). Returns 0, or
// cudaErrorInvalidValue for an N the kernel is not built for.
extern "C" int selective_scan_plan(int B, int di, int N, int* out) {
  const Plan p = make_plan(B, di, N);
  if (p.spt == 0) return (int)cudaErrorInvalidValue;
  out[0] = p.spt;
  out[1] = p.lanes;
  out[2] = p.ch;
  out[3] = p.grid_x;
  return 0;
}

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
