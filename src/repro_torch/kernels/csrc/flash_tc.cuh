// The tensor-core pieces of the flash kernels K4 (flash_fwd.cu) and K8
// (flash_bwd.cu): the mask, shared tiles of bf16 rows in a bank-conflict-free
// pitch filled by cp.async, and the mma.sync m16n8k16 fragments (bf16 in, f32
// accumulation) of the score product s = q k^T.
#pragma once
#include "common.cuh"

namespace ftc {

using bf16 = __nv_bfloat16;

// Whether query qp keeps key kp: inside the sequences, causal (qp >= kp)
// and the window (<= 0: full), on positions q_pos = row, k_pos = column.
__device__ __forceinline__ bool kept(int qp, int kp, int Sq, int Sk,
                                     int window, int causal) {
  bool ok = qp < Sq && kp < Sk;
  if (causal) ok = ok && qp >= kp;
  return ok && (window <= 0 || qp - kp < window);
}

// Row pitch of a shared tile of w bf16 values: an odd number of 16-byte
// chunks, so the eight rows of an ldmatrix land on eight bank quads.
__host__ __device__ constexpr int pitch(int w) {
  return (w / 8) % 2 ? 2 * w + 32 : 2 * w + 16;
}

// Load rows row0 .. row0 + ROWS of a row-major bf16 matrix of n_rows rows
// and row stride ld (in values), columns 0 .. w of each, into a (ROWS x W)
// shared tile; rows past n_rows and columns past w read zero. ld is w for a
// whole matrix, and its full width for a band of its columns (src then
// points at the band's first column).
template <int ROWS, int W, int THREADS>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const bf16* __restrict__ src,
                                          int row0, int n_rows, int w,
                                          bool vec, int ld) {
  constexpr int CH = W / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const int gr = row0 + r, gc = c * 8;
    unsigned char* d = dst + r * pitch(W) + c * 16;
    if (vec) {                       // w, ld % 8 == 0: a chunk is in or out
      const bool ok = gr < n_rows && gc < w;
      rt::cp_async16(d, ok ? (const void*)(src + (long long)gr * ld + gc)
                           : (const void*)src, ok);
    } else {
      const unsigned short* s = (const unsigned short*)src;
      unsigned short v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = gr < n_rows && gc + e < w ? s[(long long)gr * ld + gc + e] : 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) ((unsigned short*)d)[e] = v[e];
    }
  }
}

template <int ROWS, int W, int THREADS>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const bf16* __restrict__ src,
                                          int row0, int n_rows, int w,
                                          bool vec) {
  load_tile<ROWS, W, THREADS>(dst, src, row0, n_rows, w, vec, w);
}

__device__ __forceinline__ unsigned pack(float lo_col, float hi_col) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<unsigned*>(&h);
}

// acc[16 x 8 n] += A (16 x 16 k, a) . B, B taken from a row-major
// (rows = n, columns = k) tile: s = q k^T reads k's rows as B's columns.
// Covers 16 columns: tiles 2 nb and 2 nb + 1.
template <int W>
__device__ __forceinline__ void mma_nk(float (&c0)[4], float (&c1)[4],
                                       const unsigned (&a)[4],
                                       const unsigned char* tile, int n0,
                                       int k0, int lane) {
  unsigned b[4];
  rt::ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * pitch(W) +
                     (k0 + ((lane >> 3) & 1) * 8) * 2);
  rt::mma(c0, a, b[0], b[1]);
  rt::mma(c1, a, b[2], b[3]);
}

// The A fragment of rows row0 .. row0 + 15, columns k0 .. k0 + 15.
template <int W>
__device__ __forceinline__ void frag_a(unsigned (&a)[4],
                                       const unsigned char* tile, int row0,
                                       int k0, int lane) {
  rt::ldsm_x4(a, tile + (row0 + (lane & 15)) * pitch(W) +
                     (k0 + (lane >> 4) * 8) * 2);
}

}  // namespace ftc
