// K5: paged flash attention, the attention of paged decode and chunked
// prefill. Replaces the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention_paged (_paged_fwd_kernel).
//
// q: (B, H, Sq, d), k_pool: (P, ps, KV, d), v_pool: (P, ps, KV, dv),
// page_table: (B, max_pages) int32, lengths and q_start: (B,) int64
// -> o: (B, H, Sq, dv) in q's type. Query head h reads kv head h / (H / KV);
// key j * ps + t of sequence b lives at pool[page_table[b, j], t]. A key is
// kept when k_pos < lengths[b], q_pos >= k_pos (causal) and q_pos - k_pos <
// window (window > 0), where q_pos = q_start[b] + q row. The reference's
// arithmetic: scores in f32, masked entries -1e30 and their p zeroed after
// exp, l summed from the unrounded f32 p, p rounded to v's type for PV
// (reference lines 311-319), l clamped at 1e-30 so that a row with no valid
// key gives exactly 0 (line 329).
//
// Bound on the H100: the bytes of the valid K/V rows (plus q and o), at
// decode and at chunked prefill alike. At the served shapes those are a few
// MB, so the kernel is held by its chain of dependent memory round trips:
// the page ids, then the K/V rows they point at. What the design does:
// - Split-KV in a cluster. A sequence's keys go in splits of `kps` keys
//   counted from key 0 (64, widened so that there are at most 8 splits of
//   max_pages * ps keys: the host's plan, flash_paged.py::split_plan). The
//   grid is (block of 16 rows, kv head, sequence x split), so a decode step
//   at 4 x 36 heads and 256 keys runs 576 CTAs instead of 144, and the
//   longest sequence no longer sets the time alone. A CTA's rows are the
//   (group head, q row) pairs that read its kv head, so a GQA group reads
//   each K/V row once. The splits of one (row block, kv head, sequence) are
//   one thread-block cluster: each CTA leaves its f32 partial (m, l,
//   acc[dv]) in its shared memory, and after a cluster barrier every CTA
//   merges a share of the rows' columns over the splits, read through
//   distributed shared memory, in split order: o = sum(w acc) /
//   max(sum(w l), 1e-30), w = exp(m - max m). No workspace in device
//   memory, no atomics, one launch. A split with no kept key of a row gives
//   m = -1e30, l = 0, acc = 0, which the merge adds as exact zeros; splits
//   that start at or past lengths[b] compute nothing and are not read.
// - Copies by the page. A CTA issues the page ids of its split (cp.async
//   into shared memory) and its q rows before it reads lengths[b], so the
//   three arrive together. Then, per 16-key tile, sixteen lanes resolve one
//   key's pool row each (page id, row in the page) and the warp shares them
//   by shuffles; the K and V rows come in with 16-byte cp.async, into a
//   ring of 4 tiles (2 at d 576): a 64-key split is in flight at once. Rows
//   at or past lengths[b], and pages whose id lies outside [0, P), read as
//   zeros, so unwritten pool rows never reach the arithmetic. lengths and
//   q_start are read as int64, as the served path holds them: no cast runs
//   before the kernel.
// - bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulation): one warp
//   forms s = q k^T for the CTA's 16 rows and a 16-key tile, keeps the
//   online softmax in registers, and feeds p, rounded to bf16, from the
//   score accumulators straight into PV's A fragments (K4's path). Templated
//   on (D, DV), the padded widths of q/k and v: (64, 64), (128, 128),
//   gemma3's (256, 256) and the absorbed-MLA (576, 512); at the two wide
//   ones four warps share the rows, each forms the whole score tile and
//   takes a quarter of v's columns (64 or 128), and q's fragments are read
//   from shared memory each tile instead of held in registers. A 4-tile
//   ring up to d 256, 2 tiles at 576. At MHA decode a CTA fills 1 of the 16
//   MMA rows; decode is held by its memory round trips, so that costs
//   nothing.
// - f32 keeps the CUDA cores (no TF32) with the same loads, split plan and
//   merge: eight threads a row for the scores, every thread fixed entries
//   of the (16, dv) accumulator for PV.
//
// A row's arithmetic does not depend on Sq, B, the GQA group, or which
// block or chunk the row sits in, so a prompt gives the same bits in
// chunks of 64 rows, in one chunk, or a row at a time:
// - the split plan and the tiles depend on key positions alone (splits at
//   multiples of kps from key 0, tiles at multiples of 16 from a split's
//   start);
// - the body is chosen by (dtype, d, dv) alone, never by Sq, B, H / KV or
//   the lengths, and an MMA row's sums do not depend on the other rows;
// - tiles that no row of a block can keep are skipped, and tiles or splits
//   a row cannot keep leave its state exactly as it was (alpha is 1 where m
//   does not move, p is 0), so which neighbours a row has changes nothing;
// - the merge reads every split below lengths[b] in a fixed order, in
//   whichever CTA of the cluster merges that column.
//
// Left for a later PR: one warp of MMA rows per CTA at prefill (a 64-row
// chunk reads its K/V tiles from L2 four times), more splits for the f32
// CUDA-core body at d 576 (16 CTAs at the MLA decode shape), and TMA copies
// of whole pages.
#include <cooperative_groups.h>
#include <math.h>

#include "flash_tc.cuh"

namespace {

namespace cg = cooperative_groups;
using ftc::bf16;
using ftc::pitch;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int RB = 16;          // q rows a CTA
constexpr int KT = 16;          // keys a tile
constexpr int MAX_SPLITS = 8;   // the portable cluster size

struct Args {
  const void *q, *k, *v;
  void* o;
  const int* pt;
  const long long *lengths, *q_start;
  int B, H, Sq, d, dv, P, ps, KV, max_pages, window, causal, kps, n_splits;
  float scale;
  int vec;       // 16-byte rows: cp.async
};

// What one CTA does: its sequence, kv head, split and rows, and the 16-key
// tiles [lo, lo + 16 n_tiles) of its split that a row of the block can keep
// (keys at or past hi read as zeros). first_page: the page of key s0, the
// first id in shared memory. live: the split holds a key below lengths[b]
// (split 0 always: a sequence of length 0 still gets its rows, exact
// zeros).
struct Blk {
  int b, split, s0, kvh, G, R, r0, first_page, qs0, k_end, lo, hi, n_tiles;
  bool live;
};

// The CTA's place in the grid: no memory read.
__device__ __forceinline__ Blk locate(const Args& p) {
  Blk k;
  k.b = blockIdx.z / p.n_splits;
  k.split = blockIdx.z - k.b * p.n_splits;
  k.s0 = k.split * p.kps;
  k.kvh = blockIdx.y;
  k.G = p.H / p.KV;
  k.R = k.G * p.Sq;
  k.r0 = blockIdx.x * RB;
  k.first_page = k.s0 / p.ps;
  return k;
}

// The ids of the pages that hold the split's keys, into shared memory by
// cp.async (every one lies inside the table; those past lengths[b] are
// never used).
__device__ __forceinline__ void issue_page_ids(int* pid, const Args& p,
                                               const Blk& k, int threads) {
  const int last = (min(k.s0 + p.kps, p.max_pages * p.ps) - 1) / p.ps;
  const int* row = p.pt + (long long)k.b * p.max_pages;
  for (int i = threadIdx.x; i <= last - k.first_page; i += threads)
    rt::cp_async4(pid + i, row + k.first_page + i, true);
}

// Splits of the sequence that the merge reads.
__device__ __forceinline__ int live_splits(const Args& p, int k_end) {
  return k_end > 0 ? (k_end + p.kps - 1) / p.kps : 1;
}

// Reads lengths[b] and q_start[b] and fixes the tiles.
__device__ __forceinline__ void plan(const Args& p, Blk& k) {
  k.k_end = (int)min(p.lengths[k.b], (long long)p.max_pages * p.ps);
  k.live = k.split < live_splits(p, k.k_end);
  k.qs0 = (int)p.q_start[k.b];
  // the q rows this block spans (all of them where it wraps)
  const int nr = min(RB, k.R - k.r0);
  int s_lo = 0, s_hi = p.Sq - 1;
  if (nr < p.Sq) {
    const int f = k.r0 % p.Sq, l = (k.r0 + nr - 1) % p.Sq;
    if (f <= l) s_lo = f, s_hi = l;
  }
  int lo = k.s0, hi = min(k.s0 + p.kps, k.k_end);
  if (p.causal) hi = min(hi, k.qs0 + s_hi + 1);        // above the diagonal
  const int w_lo = k.qs0 + s_lo - p.window + 1;         // left of the window
  if (p.window > 0 && w_lo > k.s0) lo = k.s0 + (w_lo - k.s0) / KT * KT;
  k.lo = lo;
  k.hi = hi;
  k.n_tiles = k.live && hi > lo ? (hi - lo + KT - 1) / KT : 0;
}

// The pool row (in rows of w values: page * ps + slot, times KV, plus the
// kv head) of key k0 + (lane % 16), or -1 at or past hi and for a page id
// out of range; lane kk % 16 of each warp holds key kk's.
__device__ __forceinline__ long long tile_rows(const int* pid, const Args& p,
                                               const Blk& k, int k0) {
  const int kp = k0 + (threadIdx.x & 15);
  if (kp >= k.hi) return -1;
  const int page = pid[kp / p.ps - k.first_page];
  if ((unsigned)page >= (unsigned)p.P) return -1;
  return ((long long)page * p.ps + kp % p.ps) * p.KV + k.kvh;
}

__device__ __forceinline__ bool kept(const Args& p, const Blk& k, bool row_ok,
                                     int qp, int kp) {
  bool ok = row_ok && kp < k.k_end;
  if (p.causal) ok = ok && qp >= kp;
  return ok && (p.window <= 0 || qp - kp < p.window);
}

// Row r of the block -> its (b, h, s) index among B * H * Sq rows.
__device__ __forceinline__ long long row_index(const Args& p, const Blk& k,
                                               int r) {
  const int g = r / p.Sq, s = r - g * p.Sq;
  return ((long long)k.b * p.H + k.kvh * k.G + g) * p.Sq + s;
}

// Floats a row takes in a CTA's partial: acc[dv], m, l, padded to whole
// 16-byte chunks.
__host__ __device__ inline int part_row(int dv) { return (dv + 5) / 4 * 4; }

template <typename T>
__device__ __forceinline__ void store(T* p, float v);
template <>
__device__ __forceinline__ void store<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store<bf16>(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The cluster's merge. part: this CTA's partial, RB rows of part_row(dv)
// floats in shared memory, written for its valid rows. Every CTA of the
// cluster (the splits of one row block, kv head and sequence) takes every
// n_splits-th group of four columns and merges it over the live splits in
// split order.
template <typename T, int THREADS>
__device__ __forceinline__ void merge(const Args& p, const Blk& k,
                                      float* part) {
  __shared__ float wl[RB][MAX_SPLITS + 1];   // weights, then the clamped l
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();              // every split's partial is in place
  const int n = live_splits(p, k.k_end);
  const int wsd = part_row(p.dv);
  const int nr = min(RB, k.R - k.r0);
  const float* parts[MAX_SPLITS];
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s)
    parts[s] = s < n ? cluster.map_shared_rank(part, s) : part;
  for (int rr = threadIdx.x; rr < nr; rr += THREADS) {
    float mmax = NEG_INF;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < n) mmax = fmaxf(mmax, parts[s][rr * wsd + p.dv]);
    float L = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < n) {
        const float w = expf(parts[s][rr * wsd + p.dv] - mmax);
        wl[rr][s] = w;
        L = __fadd_rn(L, __fmul_rn(parts[s][rr * wsd + p.dv + 1], w));
      }
    }
    wl[rr][MAX_SPLITS] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  T* o = (T*)p.o;
  const int c4 = (p.dv + 3) / 4;
  for (int i = k.split * THREADS + threadIdx.x; i < nr * c4;
       i += p.n_splits * THREADS) {
    const int rr = i / c4, c = (i - rr * c4) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < n) {
        const float4 v = *(const float4*)(parts[s] + rr * wsd + c);
        const float w = wl[rr][s];
        acc[0] = __fadd_rn(acc[0], __fmul_rn(v.x, w));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(v.y, w));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(v.z, w));
        acc[3] = __fadd_rn(acc[3], __fmul_rn(v.w, w));
      }
    }
    const long long ri = row_index(p, k, k.r0 + rr);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < p.dv)
        store<T>(o + ri * p.dv + c + e, acc[e] / wl[rr][MAX_SPLITS]);
  }
  cluster.sync();              // no CTA leaves while its partial is read
}

template <typename Kernel>
cudaError_t launch_cluster(Kernel kernel, const Args& p, int threads,
                           size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int R = p.H / p.KV * p.Sq;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((R + RB - 1) / RB, p.KV, p.B * p.n_splits);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.n_splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------
namespace tc {

// The tile's 16 keys of a (ps, KV, w) bf16 pool into a (KT x W) tile;
// columns past w and keys without a row read zero. rows: tile_rows().
template <int W, int THREADS>
__device__ __forceinline__ void load_keys(unsigned char* dst,
                                          const bf16* __restrict__ pool,
                                          long long rows, const Args& p,
                                          int w) {
  constexpr int CH = W / 8;
  constexpr int ITERS = (KT * CH + THREADS - 1) / THREADS;
#pragma unroll
  for (int j = 0; j < ITERS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int kk = i / CH, c = i % CH;
    const long long row = __shfl_sync(FULL, rows, kk & 15);
    if (i >= KT * CH) continue;
    unsigned char* d = dst + kk * pitch(W) + c * 16;
    const bf16* src = row >= 0 ? pool + row * w : nullptr;
    if (p.vec) {
      const bool ok = src != nullptr && c * 8 < w;
      rt::cp_async16(d, ok ? (const void*)(src + c * 8) : (const void*)pool,
                     ok);
    } else {
      const unsigned short* s = (const unsigned short*)src;
      unsigned short v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = s != nullptr && c * 8 + e < w ? s[c * 8 + e] : 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) ((unsigned short*)d)[e] = v[e];
    }
  }
}

// The block's 16 q rows into a (RB x W) tile; rows past R read zero.
template <int W, int THREADS>
__device__ __forceinline__ void load_q(unsigned char* dst, const Args& p,
                                       const Blk& k) {
  constexpr int CH = W / 8;
  const bf16* q = (const bf16*)p.q;
  for (int i = threadIdx.x; i < RB * CH; i += THREADS) {
    const int rr = i / CH, c = i % CH, r = k.r0 + rr;
    unsigned char* d = dst + rr * pitch(W) + c * 16;
    const bf16* src = r < k.R ? q + row_index(p, k, r) * p.d : nullptr;
    if (p.vec) {
      const bool ok = src != nullptr && c * 8 < p.d;
      rt::cp_async16(d, ok ? (const void*)(src + c * 8) : p.q, ok);
    } else {
      const unsigned short* s = (const unsigned short*)src;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        ((unsigned short*)d)[e] =
            s != nullptr && c * 8 + e < p.d ? s[c * 8 + e] : 0;
    }
  }
}

template <int D, int DV, int WARPS>
struct Geo {
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NST = D > 256 ? 2 : 4;      // ring of key tiles
  static constexpr int Q_BYTES = RB * pitch(D);
  static constexpr int K_BYTES = KT * pitch(D);
  static constexpr int SLOT = K_BYTES + KT * pitch(DV);
  static constexpr int BYTES = Q_BYTES + NST * SLOT;   // + the page ids
  static_assert(NST * SLOT >= RB * (DV + 8) * 4, "the partial fits the ring");
};

template <int D, int DV, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
flash_paged_tc_kernel(Args p) {
  using G = Geo<D, DV, WARPS>;
  constexpr int THREADS = G::THREADS, NST = G::NST, DVW = DV / WARPS;
  constexpr bool CACHE_Q = D <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* ring = Qs + G::Q_BYTES;
  int* pid = (int*)(ring + NST * G::SLOT);

  Blk k = locate(p);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  const bf16* kpool = (const bf16*)p.k;
  const bf16* vpool = (const bf16*)p.v;

  // q, the page ids and lengths[b] in flight together
  load_q<D, THREADS>(Qs, p, k);
  issue_page_ids(pid, p, k, THREADS);
  rt::cp_async_commit();
  plan(p, k);
  rt::cp_async_wait<0>();
  __syncthreads();
  auto issue = [&](int t) {
    if (t < k.n_tiles) {
      unsigned char* r = ring + (t % NST) * G::SLOT;
      const long long rows = tile_rows(pid, p, k, k.lo + t * KT);
      load_keys<D, THREADS>(r, kpool, rows, p, p.d);
      load_keys<DV, THREADS>(r + G::K_BYTES, vpool, rows, p, p.dv);
    }
    rt::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) issue(t);

  bool row_ok[2];
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = k.r0 + g + 8 * h;
    row_ok[h] = r < k.R;
    qp[h] = k.qs0 + (row_ok[h] ? r % p.Sq : 0);
  }
  float o[DVW / 8][4];
#pragma unroll
  for (int n = 0; n < DVW / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};      // this thread's share of each row's l
  unsigned qf[CACHE_Q ? D / 16 : 1][4];

  for (int t = 0; t < k.n_tiles; ++t) {
    issue(t + NST - 1);
    rt::cp_async_wait<NST - 1>();
    __syncthreads();
    if (CACHE_Q && t == 0) {
#pragma unroll
      for (int kk = 0; kk < (CACHE_Q ? D / 16 : 0); ++kk)
        ftc::frag_a<D>(qf[kk], Qs, 0, kk * 16, lane);
    }
    const unsigned char* Ks = ring + (t % NST) * G::SLOT;
    const unsigned char* Vs = Ks + G::K_BYTES;
    const int k0 = k.lo + t * KT;

    // s = q k^T over the tile's 16 keys (two n8 tiles), f32
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if constexpr (CACHE_Q) {
        ftc::mma_nk<D>(s[0], s[1], qf[kk], Ks, 0, kk * 16, lane);
      } else {
        unsigned a[4];
        ftc::frag_a<D>(a, Qs, 0, kk * 16, lane);
        ftc::mma_nk<D>(s[0], s[1], a, Ks, 0, kk * 16, lane);
      }
    }
    unsigned keep = 0;          // bit n * 4 + c: entry kept
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c >> 1, kp = k0 + n * 8 + 2 * tq + (c & 1);
        const bool ok = kept(p, k, row_ok[h], qp[h], kp);
        keep |= (unsigned)ok << (n * 4 + c);
        s[n][c] = ok ? s[n][c] * p.scale : NEG_INF;
        mx[h] = fmaxf(mx[h], s[n][c]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {       // a row's 16 entries: a lane quad
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
      alpha[h] = mx[h] == m[h] ? 1.f : __expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
    // p = exp(s - m), 0 where masked; l from the f32 p
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pv =
            (keep >> (n * 4 + c)) & 1u ? __expf(s[n][c] - m[c >> 1]) : 0.f;
        s[n][c] = pv;
        l[c >> 1] += pv;
      }
#pragma unroll
    for (int n = 0; n < DVW / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] *= alpha[c >> 1];
    // o += bf16(p) v over this warp's DVW columns of v
    const unsigned a[4] = {ftc::pack(s[0][0], s[0][1]),
                           ftc::pack(s[0][2], s[0][3]),
                           ftc::pack(s[1][0], s[1][1]),
                           ftc::pack(s[1][2], s[1][3])};
#pragma unroll
    for (int nb = 0; nb < DVW / 16; ++nb) {
      unsigned b[4];
      rt::ldsm_x4_t(b, Vs + (lane & 15) * pitch(DV) +
                           (warp * DVW + nb * 16 + (lane >> 4) * 8) * 2);
      rt::mma(o[2 * nb], a, b[0], b[1]);
      rt::mma(o[2 * nb + 1], a, b[2], b[3]);
    }
    __syncthreads();   // the ring slot is refilled next
  }
  rt::cp_async_wait<0>();

  // the split's partial (unnormalised o, m and l) into the ring's memory
  float* part = (float*)ring;
  const int wsd = part_row(p.dv);
  if (k.live) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(FULL, l[h], 1);
      l[h] += __shfl_xor_sync(FULL, l[h], 2);
      float* dst = part + (g + 8 * h) * wsd;
#pragma unroll
      for (int n = 0; n < DVW / 8; ++n) {
        const int col = warp * DVW + n * 8 + 2 * tq;
        if (col < p.dv) dst[col] = o[n][2 * h];
        if (col + 1 < p.dv) dst[col + 1] = o[n][2 * h + 1];
      }
      if (warp == 0 && tq == 0) {
        dst[p.dv] = m[h];
        dst[p.dv + 1] = l[h];
      }
    }
  }
  merge<bf16, THREADS>(p, k, part);
}

template <int D, int DV, int WARPS>
cudaError_t launch(const Args& p, int pid_cap, cudaStream_t stream) {
  using G = Geo<D, DV, WARPS>;
  return launch_cluster(flash_paged_tc_kernel<D, DV, WARPS>, p, G::THREADS,
                        G::BYTES + 4 * pid_cap, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: the CUDA-core body
// ---------------------------------------------------------------------------
namespace cc {

constexpr int THREADS = 128;
constexpr int TPR = THREADS / RB;   // threads a q row in the score phase
constexpr int KPT = KT / TPR;       // keys a thread in the score phase

// Row pitch of K and q in shared memory: a multiple of 4 floats (16-byte
// chunks) and an odd number of them, so the eight keys of a score step fall
// in eight bank quads.
__host__ __device__ inline int ld_k(int d) {
  const int w = (d + 3) & ~3;
  return (w / 4) % 2 ? w : w + 4;
}
__host__ __device__ inline int ld_v(int dv) { return (dv + 3) & ~3; }

inline size_t smem_bytes(int d, int dv, int nst, int pid_cap) {
  return sizeof(float) * ((size_t)RB * ld_k(d) +
                          (size_t)nst * KT * (ld_k(d) + ld_v(dv)) +
                          RB * (KT + 1) + RB) +
         sizeof(int) * pid_cap;
}

// The tile's 16 keys of a (ps, KV, w) f32 pool into a (KT x ld) tile.
__device__ __forceinline__ void load_keys(float* dst,
                                          const float* __restrict__ pool,
                                          long long rows, const Args& p,
                                          int w, int ld) {
  const int ch = (w + 3) / 4;
  const int iters = (KT * ch + THREADS - 1) / THREADS;
  for (int j = 0; j < iters; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int kk = i / ch, c = i % ch;
    const long long row = __shfl_sync(FULL, rows, kk & 15);
    if (i >= KT * ch) continue;
    float* d = dst + kk * ld + c * 4;
    const float* src = row >= 0 ? pool + row * w : nullptr;
    if (p.vec) {
      rt::cp_async16(d, src ? (const void*)(src + c * 4) : (const void*)pool,
                     src != nullptr);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = src != nullptr && c * 4 + e < w ? src[c * 4 + e] : 0.f;
    }
  }
}

template <int NACC, int NST>
__global__ void __launch_bounds__(THREADS)
flash_paged_f32_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = ld_k(p.d), ldv = ld_v(p.dv);
  const int slot = KT * (ldk + ldv);
  float* Qs = smem;                        // RB x ldk
  float* ring = Qs + RB * ldk;             // NST x (K: KT x ldk, V: KT x ldv)
  float* Ps = ring + NST * slot;           // RB x (KT + 1)
  float* alpha_s = Ps + RB * (KT + 1);     // RB
  int* pid = (int*)(alpha_s + RB);

  Blk k = locate(p);
  const int t = threadIdx.x;
  const float* q = (const float*)p.q;
  const float* kpool = (const float*)p.k;
  const float* vpool = (const float*)p.v;

  {  // q, the page ids and lengths[b] in flight together
    const int ch = (p.d + 3) / 4;
    for (int i = t; i < RB * ch; i += THREADS) {
      const int rr = i / ch, c = i % ch, r = k.r0 + rr;
      float* d = Qs + rr * ldk + c * 4;
      const float* src = r < k.R ? q + row_index(p, k, r) * p.d : nullptr;
      if (p.vec) {
        rt::cp_async16(d, src ? (const void*)(src + c * 4) : p.q,
                       src != nullptr);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[e] = src != nullptr && c * 4 + e < p.d ? src[c * 4 + e] : 0.f;
      }
    }
  }
  issue_page_ids(pid, p, k, THREADS);
  rt::cp_async_commit();
  plan(p, k);
  rt::cp_async_wait<0>();
  __syncthreads();
  auto issue = [&](int tt) {
    if (tt < k.n_tiles) {
      float* r = ring + (tt % NST) * slot;
      const long long rows = tile_rows(pid, p, k, k.lo + tt * KT);
      load_keys(r, kpool, rows, p, p.d, ldk);
      load_keys(r + KT * ldk, vpool, rows, p, p.dv, ldv);
    }
    rt::cp_async_commit();
  };
#pragma unroll
  for (int tt = 0; tt < NST - 1; ++tt) issue(tt);

  const int row = t / TPR, sub = t % TPR;   // score-phase role
  const bool row_ok = k.r0 + row < k.R;
  const int qp = k.qs0 + (row_ok ? (k.r0 + row) % p.Sq : 0);
  float m = NEG_INF, l = 0.f;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  for (int tt = 0; tt < k.n_tiles; ++tt) {
    issue(tt + NST - 1);
    rt::cp_async_wait<NST - 1>();
    __syncthreads();
    const float* Ks = ring + (tt % NST) * slot;
    const float* Vs = Ks + KT * ldk;
    const int k0 = k.lo + tt * KT;
    float sc[KPT];
    bool keep[KPT];
    float mx = m;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int c = sub + TPR * j, kp = k0 + c;
      float dot = 0.f;
      for (int e = 0; e < p.d; ++e) dot += Qs[row * ldk + e] * Ks[c * ldk + e];
      keep[j] = kept(p, k, row_ok, qp, kp);
      sc[j] = keep[j] ? dot * p.scale : NEG_INF;
      mx = fmaxf(mx, sc[j]);
    }
    // the row's TPR threads are neighbouring lanes of one warp
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, w));
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float pv = keep[j] ? expf(sc[j] - mx) : 0.f;
      psum += pv;
      Ps[row * (KT + 1) + sub + TPR * j] = pv;
    }
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1)
      psum += __shfl_xor_sync(FULL, psum, w);
    const float alpha = mx == m ? 1.f : expf(m - mx);
    l = alpha * l + psum;
    m = mx;
    if (sub == 0) alpha_s[row] = alpha;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int idx = t + i * THREADS;
      if (idx < RB * p.dv) {
        const int rr = idx / p.dv, c = idx % p.dv;
        float pv = 0.f;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          pv += Ps[rr * (KT + 1) + kk] * Vs[kk * ldv + c];
        acc[i] = acc[i] * alpha_s[rr] + pv;
      }
    }
    __syncthreads();   // the ring slot and Ps are refilled next
  }
  rt::cp_async_wait<0>();

  // the split's partial (unnormalised o, m and l) into the ring's memory
  float* part = ring;
  const int wsd = part_row(p.dv);
  if (k.live) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int idx = t + i * THREADS;
      if (idx < RB * p.dv) {
        const int rr = idx / p.dv, c = idx % p.dv;
        part[rr * wsd + c] = acc[i];
      }
    }
    if (sub == 0) {
      part[row * wsd + p.dv] = m;
      part[row * wsd + p.dv + 1] = l;
    }
  }
  merge<float, THREADS>(p, k, part);
}

template <int NACC>
cudaError_t launch_n(const Args& p, int pid_cap, cudaStream_t stream) {
  const bool wide = p.d > 128 || p.dv > 128;
  const size_t smem = smem_bytes(p.d, p.dv, wide ? 2 : 4, pid_cap);
  return launch_cluster(wide ? flash_paged_f32_kernel<NACC, 2>
                             : flash_paged_f32_kernel<NACC, 4>,
                        p, THREADS, smem, stream);
}

cudaError_t launch(const Args& p, int pid_cap, cudaStream_t s) {
  if (p.dv <= 64) return launch_n<RB * 64 / THREADS>(p, pid_cap, s);
  if (p.dv <= 128) return launch_n<RB * 128 / THREADS>(p, pid_cap, s);
  if (p.dv <= 256) return launch_n<RB * 256 / THREADS>(p, pid_cap, s);
  return launch_n<RB * 512 / THREADS>(p, pid_cap, s);
}

}  // namespace cc
}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, both pools and o share it). lengths and
// q_start: int64. window <= 0 means full attention; causal is 0 or 1. kps
// and n_splits are the host's split plan: kps a multiple of 16, n_splits =
// ceil(max_pages * ps / kps) <= 8, the cluster size.
extern "C" int flash_paged_launch(const void* q, const void* k_pool,
                                  const void* v_pool, const void* page_table,
                                  const void* lengths, const void* q_start,
                                  void* o, int B, int H, int Sq, int d,
                                  int dv, int P, int ps, int KV,
                                  int max_pages, int window, int causal,
                                  int kps, int n_splits, float scale,
                                  int dtype, void* stream) {
  const long long max_keys = (long long)max_pages * ps;
  if (B < 1 || Sq < 1 || d < 1 || d > 576 || dv < 1 || dv > 512 || KV < 1 ||
      KV > 65535 || H < KV || H % KV || P < 1 || ps < 1 || max_pages < 1 ||
      kps < KT || kps % KT || n_splits < 1 || n_splits > MAX_SPLITS ||
      (long long)(n_splits - 1) * kps >= max_keys ||
      (long long)n_splits * kps < max_keys || (long long)B * n_splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Args p{q, k_pool, v_pool, o, (const int*)page_table,
         (const long long*)lengths, (const long long*)q_start, B, H, Sq, d,
         dv, P, ps, KV, max_pages, window, causal, kps, n_splits, scale, 0};
  const int pid_cap = kps / ps + 2;
  const void* ptrs[] = {q, k_pool, v_pool};
  bool aligned = true;
  for (const void* ptr : ptrs) aligned = aligned && (uintptr_t)ptr % 16 == 0;
  if (dtype == 0) {
    p.vec = aligned && d % 4 == 0 && dv % 4 == 0;
    return (int)cc::launch(p, pid_cap, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  p.vec = aligned && d % 8 == 0 && dv % 8 == 0;
  if (d <= 64 && dv <= 64) return (int)tc::launch<64, 64, 1>(p, pid_cap, s);
  if (d <= 128 && dv <= 128)
    return (int)tc::launch<128, 128, 1>(p, pid_cap, s);
  if (d <= 256 && dv <= 256)
    return (int)tc::launch<256, 256, 4>(p, pid_cap, s);
  return (int)tc::launch<576, 512, 4>(p, pid_cap, s);
}
