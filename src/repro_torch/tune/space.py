"""Search spaces for the kernel autotuner, counterpart of
``repro/tune/space.py``.

The reference's space is every power-of-two block within its TPU's VMEM
budget, because a Pallas kernel compiles for any block. The port's kernels
are compiled for a few tile geometries each, and any other block raises in
``kernel_tm`` / ``tc_geom`` / ``pair_geom``. So the axes here are only the
compiled tiles:

* K1 in bf16 and int8: ``baseline_gemm.TC_GEOMS`` x ``TC_BK[dtype]``;
* K1 in f32, and K7's baseline in f32 and int8: ``KERNEL_BMS`` x
  ``KERNEL_BN`` x ``KERNEL_BK`` (the CUDA-core body);
* K2 / K3, and K7's FIP / FFIP: ``fip_gemm.PAIR_GEOMS`` x ``PAIR_BK``;
* K4: the one tile its body runs for the dtype and Sq
  (``flash_attention.kernel_blocks``).

A tile whose rows or columns exceed the pow2-rounded problem (and the
smallest compiled tile) only computes padding and is left out, as the
reference leaves such blocks out.

Ordering contract, the reference's: the static default (what the code
ships with: ``ops.choose_blocks``, ``conv_gemm.conv_blocks``) is candidate
0, so a tuned schedule can only match or beat the default on the card that
measured it; the rest follow by log2 distance from it, ties by ascending
tuple. Every tile gives the default's results bit for bit (the k-step order
of an output element and K2/K3's split plan do not depend on the tile).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.kernels import conv_gemm, flash_attention, ops
from repro_torch.kernels.baseline_gemm import (KERNEL_BK, KERNEL_BMS,
                                               KERNEL_BN, TC_BK, TC_GEOMS)
from repro_torch.kernels.fip_gemm import PAIR_BK, PAIR_GEOMS

Blocks = Tuple[int, int, int]


def round_up_pow2(x: int, lo: int = 8) -> int:
    p = lo
    while p < x:
        p *= 2
    return p


def compiled_tiles(algo: str, dtype: torch.dtype) -> List[Blocks]:
    """Every (bm, bn, bk) the GEMM (and K7) kernels are compiled for under
    ``algo`` at operand ``dtype``."""
    if algo in ("fip", "ffip"):
        return [(bm, bn, PAIR_BK) for bm, bn in PAIR_GEOMS]
    if dtype in TC_BK:
        return [(bm, bn, TC_BK[dtype]) for bm, bn in TC_GEOMS]
    return [(bm, KERNEL_BN, KERNEL_BK) for bm in KERNEL_BMS]


def compiled_conv_tiles(algo: str) -> List[Blocks]:
    """Every (bm, bn, bk) K7 is compiled for under ``algo``: its FIP/FFIP
    on the pair body's tiles, its baseline on the CUDA-core body's (int8
    too: K7 has no tensor-core body)."""
    if algo in ("fip", "ffip"):
        return compiled_tiles(algo, torch.float32)
    return [(bm, KERNEL_BN, KERNEL_BK) for bm in KERNEL_BMS]


def _ordered(default: Blocks, tiles, m: int, n: int) -> List[Blocks]:
    smallest = min(tiles)
    bm_cap = max(round_up_pow2(m), smallest[0])
    bn_cap = max(round_up_pow2(n), min(t[1] for t in tiles))
    rest = [t for t in tiles
            if t != default and t[0] <= bm_cap and t[1] <= bn_cap]

    def dist(c):
        return sum(abs(x.bit_length() - d.bit_length())
                   for x, d in zip(c, default))

    return [default] + sorted(rest, key=lambda c: (dist(c), c))


def gemm_candidates(m: int, n: int, k: int, algo: str,
                    dtype: torch.dtype = torch.float32) -> List[Blocks]:
    """Deterministically ordered compiled tiles for an (m, k) x (k, n) GEMM
    in ``dtype``; the static default first."""
    default = tuple(ops.choose_blocks(m, n, k, algo, dtype))
    return _ordered(default, compiled_tiles(algo, dtype), m, n)


def conv_candidates(m: int, n: int, k: int, ckw: int, algo: str, *,
                    groups: int = 1) -> List[Blocks]:
    """Candidates for K7 at M output pixels (the whole batch's), N output
    channels a group and K = KH*KW*Cin_g. The reference prefers bk
    multiples of ``ckw`` = Cin_g*KW; the port's K7 has one bk a body, so
    ``ckw`` stays in the key (``tune.conv_key``) and the space is the
    compiled tiles, ``conv_gemm.conv_blocks``' first."""
    del ckw
    k_even = k + k % 2 if algo != "baseline" else k
    default = tuple(conv_gemm.conv_blocks(m, n, k_even, algo, groups))
    return _ordered(default, compiled_conv_tiles(algo), m, n)


def flash_candidates(sq: int, sk: int,
                     dtype: torch.dtype = torch.bfloat16
                     ) -> List[Tuple[int, int]]:
    """(bq, bk) candidates for K4: its one tile for ``dtype`` at ``sq``.
    The reference offers (64..256)^2 blocks with (128, 128) first; K4's
    tile is fixed per (D, DV) body (ROADMAP queue 2 section A)."""
    del sk
    return [flash_attention.kernel_blocks(dtype, sq)]
