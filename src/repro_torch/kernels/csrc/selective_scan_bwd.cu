// K9: the Mamba1 selective scan, backward. Replaces the Pallas kernel
// repro/kernels/selective_scan.py::selective_scan_bwd (_bwd_kernel).
//
// All operands f32 (the wrapper casts): x, dt, dy: (B, S, di); b, c:
// (B, S, N); a: (di, N); h_starts: (B, S / chunk, di, N), the state entering
// each chunk, from the forward (K6). Outputs dx, ddt: (B, S, di); db_part,
// dc_part: (B, S, ceil(di / 32), N), one partial per 32-channel block that
// the wrapper sums (the reference sums its per-d-block partials outside the
// kernel too); da_part: (B, di, N), summed over the batch by the wrapper.
// The gradient into h0 is zero (training starts from h0 = 0). Scratch:
// starts: (B, ceil(di / 32), ceil(chunk / TS), N / 4, 128).
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
// one CTA owns a (batch row, 32-channel block) for the whole sequence:
// four threads a channel, N/4 states each, dh and dA in
// registers, the chunks walked in reverse inside the CTA. Within a chunk the
// steps go in sub-tiles of TS = 128 / N steps (8 at N = 16), so that a
// sub-tile's h_{t-1} and exp(dt A), TS x N/4 of each a thread, fit in
// registers. For each chunk:
//   1. one forward pass from the chunk's h_starts entry computes the state
//      entering every sub-tile once and keeps it in the starts scratch
//      (L2-resident: 32 KB a CTA at N = 16);
//   2. then, sub-tile by sub-tile in reverse, one forward pass from that
//      state keeps h_{t-1} and exp(dt A) of each step in registers (h_t is
//      the next step's h_{t-1}), and the adjoint runs back over them with
//      no second exponential.
// That is the chunk's forward steps twice (less the last sub-tile's in
// pass 1) and S di N exponentials in the adjoint's place, where the
// previous design recomputed each sub-tile's start from the chunk start
// (2.5x the forward) and took every exponential again in the adjoint. Each
// sub-tile's x, dt, b (and dy, c) arrive by cp.async into a two-slot ring,
// one sub-tile ahead of the one computed, and the next start state by a
// register load issued one sub-tile ahead. The forward repeats K6's
// arithmetic (accurate expf, products and sums rounded one by one), so
// h_{t-1} equals the forward's bit for bit, and the adjoint reuses the very
// exp(dt A) the forward rounded. Sums over N are taken in K6's order (each
// thread's N/4 states in order, then (0 + 1) + (2 + 3) by two shuffles);
// sums over the block's 32 channels as a pairwise tree over a warp's 8
// channels (three xor rounds that halve the values a lane keeps while it
// holds more than one, a reduce-scatter) and then the four warps as
// (0 + 1) + (2 + 3); selective_scan_bwd_plain repeats both orders.
//
// Bound: the S di N exponentials the function needs on the special-function
// units (one exp(dt A) per (t, d, n) serves both h_t and the adjoint's
// dh_{t-1}), or the bytes of the inputs and outputs, whichever is larger; at
// falcon-mamba-7b's training shape the bytes. What holds the kernel is
// issue slots and latency: about 47 instructions a (t, d, n), the accurate
// expf of passes 1 and 2 among them (chip_smoke.py's scan_bwd_issue_ms
// counts them), on B x di x 4 threads, too few warps to hide each one's
// latency. 128 registers a thread (64 of them the sub-tile's h and
// exp(dt A)) and 12 KB of shared memory at N = 16 let 4 CTAs share an SM,
// so the 512 CTAs of B 2 x 256 channel blocks run in one wave.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int CH = 32;                 // channels per CTA
constexpr int LANES = 4;               // threads per channel
constexpr int THREADS = CH * LANES;    // 128
constexpr int WARPS = THREADS / 32;    // 4
constexpr unsigned FULL = 0xffffffffu;

template <int SPT>
struct Geometry {
  static constexpr int N = SPT * LANES;
  static constexpr int TS = 32 / SPT;        // steps a sub-tile
  // one ring slot, in floats: x, dt, dy (TS x CH), b, c (TS x N)
  static constexpr int XS = TS * CH;
  static constexpr int BS = TS * N;
  static constexpr int SLOT = 3 * XS + 2 * BS;
  static constexpr int RED = TS * WARPS * N;  // db, dc per warp
  static constexpr size_t BYTES = sizeof(float) * (2 * SLOT + 2 * RED);
  // registers: h_{t-1} and exp(dt A) of a sub-tile are 64 a thread
  static constexpr int MIN_BLOCKS = SPT <= 4 ? 4 : (SPT == 8 ? 2 : 1);
};

__host__ __device__ constexpr int max1(int v) { return v > 1 ? v : 1; }

template <bool B>
struct Whole {
  static constexpr bool value = B;
};

// One round of the channel tree over lanes lane ^ mask. With K > 1 values
// a lane keeps half (the upper half where its mask bit is set) and adds the
// partner's matching half; with K = 1 both lanes end with the pair's sum,
// and the lane whose bit is set no longer owns it. Each add joins the same
// two channel groups in either lane: the plain version's pairwise tree.
template <int K>
__device__ __forceinline__ void tree_round(float* v, int lane, int mask,
                                           int& off, bool& own) {
  if constexpr (K == 1) {
    v[0] = __fadd_rn(v[0], __shfl_xor_sync(FULL, v[0], mask));
    own = own && !(lane & mask);
  } else {
    const bool hi = lane & mask;
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const float send = hi ? v[i] : v[i + K / 2];
      const float keep = hi ? v[i + K / 2] : v[i];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, mask));
    }
    if (hi) off += K / 2;
  }
}

// v[SPT] summed over the warp's 8 channels (lane bits 2-4, channel pairs
// first): the lane keeps max(1, SPT / 8) sums, states off .. of its own.
template <int SPT>
__device__ __forceinline__ void channel_tree(float (&v)[SPT], int lane,
                                             int& off, bool& own) {
  off = 0;
  own = true;
  tree_round<SPT>(v, lane, 4, off, own);
  tree_round<max1(SPT / 2)>(v, lane, 8, off, own);
  tree_round<max1(SPT / 4)>(v, lane, 16, off, own);
}

template <int SPT>
__global__ void __launch_bounds__(THREADS, Geometry<SPT>::MIN_BLOCKS)
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
                          float* __restrict__ da_part,
                          float* __restrict__ starts, int S, int di,
                          int chunk) {
  using G = Geometry<SPT>;
  constexpr int N = G::N;
  constexpr int TS = G::TS;
  constexpr int KF = max1(SPT / 8);   // channel sums a lane keeps
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                  // 2 x SLOT
  float* dbw = ring + 2 * G::SLOT;     // [TS][WARPS][N]
  float* dcw = dbw + G::RED;

  const int bi = blockIdx.y;
  const int blk = blockIdx.x;
  const int n_blk = gridDim.x;
  const int ch0 = blk * CH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cl = tid / LANES;          // channel within the block
  const int q = tid % LANES;           // which N/4 states
  const int warp = tid / 32;
  const int ch = ch0 + cl;
  const bool valid = ch < di;
  const int n0 = q * SPT;
  const int n_chunks = S / chunk;
  const int n_sub = (chunk + TS - 1) / TS;
  // per chunk: n_sub - 1 forward items (pass 1), then n_sub adjoint items
  const int per_chunk = 2 * n_sub - 1;
  const int n_items = n_chunks * per_chunk;
  const long long xbase = (long long)bi * S * di;
  const long long bbase = (long long)bi * S * N;
  // this thread's start states, [sub-tile][state][thread]
  float* my_starts =
      starts + ((long long)bi * n_blk + blk) * n_sub * SPT * THREADS + tid;

  float av[SPT], dh[SPT], dacc[SPT], h[SPT], pre[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    av[j] = valid ? a[(long long)ch * N + n0 + j] : 0.f;
    dh[j] = 0.f;
    dacc[j] = 0.f;
    h[j] = 0.f;
    pre[j] = 0.f;
  }

  struct Item {
    int k, u;    // chunk, sub-tile
    bool adj;    // pass 2 + adjoint, else pass 1
  };
  auto item = [&](int i) {
    Item it;
    it.k = n_chunks - 1 - i / per_chunk;
    const int w = i % per_chunk;
    it.adj = w >= n_sub - 1;
    it.u = it.adj ? per_chunk - 1 - w : w;
    return it;
  };
  // The state entering item i, where it is not carried in h: the chunk's
  // h_starts entry at sub-tile 0, else pass 1's (scratch) for the adjoint.
  auto fetch_start = [&](int i) {
    if (i >= n_items) return;
    const Item it = item(i);
    if (it.u == 0) {
      const float* src =
          h_starts + (((long long)bi * n_chunks + it.k) * di + ch) * N + n0;
#pragma unroll
      for (int j = 0; j < SPT; ++j) pre[j] = valid ? src[j] : 0.f;
    } else if (it.adj && it.u < n_sub - 1) {
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        pre[j] = my_starts[(it.u * SPT + j) * THREADS];
    }
  };
  // Stage item i's steps of x, dt, b (and dy, c for the adjoint) into ring
  // slot i % 2.
  auto issue = [&](int i) {
    if (i < n_items) {
      const Item it = item(i);
      float* xs = ring + (i & 1) * G::SLOT;
      float* dts = xs + G::XS;
      float* dys = dts + G::XS;
      float* bs = dys + G::XS;
      float* cs = bs + G::BS;
      const int t0 = it.k * chunk + it.u * TS;
      const int tn = min(TS, (it.k + 1) * chunk - t0);
      for (int e = tid; e < TS * CH; e += THREADS) {
        const int r = e / CH, gc = ch0 + e % CH;
        const bool in = r < tn && gc < di;
        const long long off = in ? xbase + (long long)(t0 + r) * di + gc : 0;
        rt::cp_async4(xs + e, x + off, in);
        rt::cp_async4(dts + e, dt + off, in);
        if (it.adj) rt::cp_async4(dys + e, dy + off, in);
      }
      for (int e = tid; e < TS * N; e += THREADS) {
        const bool in = e / N < tn;
        const long long off = in ? bbase + (long long)t0 * N + e : 0;
        rt::cp_async4(bs + e, bmat + off, in);
        if (it.adj) rt::cp_async4(cs + e, cmat + off, in);
      }
    }
    rt::cp_async_commit();
  };

  // Pass 2 and the adjoint of one sub-tile of tn steps at t0, from the
  // start state in h. WHOLE (tn == TS, every sub-tile but a short chunk's)
  // drops the step guards, so the unrolled steps form one block the
  // compiler can interleave.
  auto adjoint = [&](auto whole, const float* xs, const float* dts,
                     const float* dys, const float* bs, const float* cs,
                     int t0, int tn) {
    constexpr bool WHOLE = decltype(whole)::value;
    // pass 2: h_{t-1} and exp(dt A) of each step, in registers
    float hp[TS][SPT], eda[TS][SPT];
#pragma unroll
    for (int r = 0; r < TS; ++r) {
      if (WHOLE || r < tn) {
        const float d = dts[r * CH + cl];
        const float dxv = __fmul_rn(d, xs[r * CH + cl]);
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          hp[r][j] = h[j];
          eda[r][j] = expf(__fmul_rn(d, av[j]));
          h[j] = __fadd_rn(__fmul_rn(eda[r][j], h[j]),
                           __fmul_rn(dxv, bs[r * N + n0 + j]));
        }
      }
    }
    // the adjoint, in reverse; h_t is the next step's h_{t-1}, or h
#pragma unroll
    for (int r = TS - 1; r >= 0; --r) {
      if (!WHOLE && r >= tn) continue;
      const float d = dts[r * CH + cl];
      const float xv = xs[r * CH + cl];
      const float coef = __fmul_rn(d, xv);
      const float dyv = dys[r * CH + cl];
      const bool last = r + 1 >= (WHOLE ? TS : tn);
      float sb = 0.f, s2 = 0.f, pb[SPT], pc[SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float ht = last ? h[j] : hp[r + 1 < TS ? r + 1 : r][j];
        const float hpj = hp[r][j], da = eda[r][j];
        const float bv = bs[r * N + n0 + j];
        const float dht =
            __fadd_rn(dh[j], __fmul_rn(dyv, cs[r * N + n0 + j]));
        pc[j] = __fmul_rn(ht, dyv);
        pb[j] = __fmul_rn(dht, coef);
        sb = __fadd_rn(sb, __fmul_rn(dht, bv));
        const float g = __fmul_rn(__fmul_rn(dht, da), hpj);
        s2 = __fadd_rn(s2, __fmul_rn(g, av[j]));
        dacc[j] = __fadd_rn(dacc[j], __fmul_rn(g, d));
        dh[j] = __fmul_rn(da, dht);
      }
      sb = __fadd_rn(sb, __shfl_xor_sync(FULL, sb, 1));
      sb = __fadd_rn(sb, __shfl_xor_sync(FULL, sb, 2));
      s2 = __fadd_rn(s2, __shfl_xor_sync(FULL, s2, 1));
      s2 = __fadd_rn(s2, __shfl_xor_sync(FULL, s2, 2));
      if (q == 0 && valid) {
        const long long off = xbase + (long long)(t0 + r) * di + ch;
        dx[off] = __fmul_rn(sb, d);
        ddt[off] = __fadd_rn(__fmul_rn(sb, xv), s2);
      }
      int off_b, off_c;
      bool own_b, own_c;
      channel_tree<SPT>(pb, lane, off_b, own_b);
      channel_tree<SPT>(pc, lane, off_c, own_c);
      if (own_b) {
#pragma unroll
        for (int i2 = 0; i2 < KF; ++i2) {
          dbw[(r * WARPS + warp) * N + n0 + off_b + i2] = pb[i2];
          dcw[(r * WARPS + warp) * N + n0 + off_c + i2] = pc[i2];
        }
      }
    }
  };

  fetch_start(0);
  issue(0);
  for (int i = 0; i < n_items; ++i) {
    const Item it = item(i);
    // this item's start state: pass 1 carries h from one sub-tile to the
    // next, and into the adjoint's first (the chunk's last) sub-tile
    const bool carried = it.u > 0 && (!it.adj || it.u == n_sub - 1);
    if (!carried) {
#pragma unroll
      for (int j = 0; j < SPT; ++j) h[j] = pre[j];
    }
    fetch_start(i + 1);
    issue(i + 1);
    rt::cp_async_wait<1>();
    __syncthreads();   // item i staged; item i - 1's reads of dbw/dcw done
    const float* xs = ring + (i & 1) * G::SLOT;
    const float* dts = xs + G::XS;
    const float* dys = dts + G::XS;
    const float* bs = dys + G::XS;
    const float* cs = bs + G::BS;
    const int t0 = it.k * chunk + it.u * TS;
    const int tn = min(TS, (it.k + 1) * chunk - t0);

    if (!it.adj) {
      // pass 1: one full sub-tile forward (K6's arithmetic)
#pragma unroll
      for (int r = 0; r < TS; ++r) {
        const float d = dts[r * CH + cl];
        const float dxv = __fmul_rn(d, xs[r * CH + cl]);
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          const float da = expf(__fmul_rn(d, av[j]));
          h[j] = __fadd_rn(__fmul_rn(da, h[j]),
                           __fmul_rn(dxv, bs[r * N + n0 + j]));
        }
      }
      if (it.u + 1 < n_sub - 1) {        // the last start is carried
#pragma unroll
        for (int j = 0; j < SPT; ++j)
          my_starts[((it.u + 1) * SPT + j) * THREADS] = h[j];
      }
    } else if (tn == TS) {
      adjoint(Whole<true>{}, xs, dts, dys, bs, cs, t0, tn);
    } else {
      adjoint(Whole<false>{}, xs, dts, dys, bs, cs, t0, tn);
    }
    __syncthreads();   // every step of the item is done
    if (it.adj) {
      for (int e = tid; e < tn * N; e += THREADS) {
        const int r = e / N, n = e % N;
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
  rt::cp_async_wait<0>();
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
                   float* dc_part, float* da_part, float* starts, int B,
                   int S, int di, int chunk, cudaStream_t stream) {
  const size_t smem = Geometry<SPT>::BYTES;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        selective_scan_bwd_kernel<SPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((di + CH - 1) / CH, B);
  selective_scan_bwd_kernel<SPT><<<grid, THREADS, smem, stream>>>(
      x, dt, b, c, a, h_starts, dy, dx, ddt, db_part, dc_part, da_part,
      starts, S, di, chunk);
  return cudaGetLastError();
}

}  // namespace

// All pointers f32. N must be 4, 8, 16, 32 or 64; chunk must divide S.
// starts: at least B * ceil(di / 32) * ceil(chunk / (128 / N)) * N * 32
// floats of scratch.
extern "C" int selective_scan_bwd_launch(
    const void* x, const void* dt, const void* b, const void* c,
    const void* a, const void* h_starts, const void* dy, void* dx, void* ddt,
    void* db_part, void* dc_part, void* da_part, void* starts, int B, int S,
    int di, int N, int chunk, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || di < 1 || chunk < 1 || S % chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define K9_ARGS                                                             \
  (const float*)x, (const float*)dt, (const float*)b, (const float*)c,     \
      (const float*)a, (const float*)h_starts, (const float*)dy,           \
      (float*)dx, (float*)ddt, (float*)db_part, (float*)dc_part,           \
      (float*)da_part, (float*)starts, B, S, di, chunk, s
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
