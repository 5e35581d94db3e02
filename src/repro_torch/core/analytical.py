"""The paper's arithmetic-complexity / resource / throughput model (§3, §4, §6.2.1).
A copy of ``repro/core/analytical.py``; :class:`GemmShape` is the one in
:mod:`repro_torch.core.workloads`.

Pure-python analytical layer. Everything here is an equation from the paper:

  * Eq. (1) op counts, Eqs. (5)/(6) FIP/FFIP op counts,
  * Eqs. (17)-(19) PE register costs (Fig. 2),
  * Eqs. (22)-(30) throughput / throughput-per-compute-area roofs,
  * Eqs. (31a-c) evaluation metrics (GOPS, GOPS/multiplier, ops/mult/cycle),
  * a deterministic MXU cycle model (§4.3/§5: weight-stationary tiles,
    double-buffered weight loads, alpha row) used to reproduce Fig. 9 and
    Tables 1-3 — the paper itself uses such a model ("accurate throughput
    estimation ... predicts the actual model throughputs within 1%").

The frequency constants are calibrated to the paper's measured Fig. 9 /
Table 1-2 numbers (Arria 10, quartus results); they are MEASURED-BY-THE-PAPER
constants, not re-derived — flagged as such for honesty in benchmarks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Literal, Sequence, Tuple

from repro_torch.core.workloads import GemmShape

Algo = Literal["baseline", "fip", "ffip"]


# ---------------------------------------------------------------------------
# Eqs. (1), (5), (6): arithmetic complexity of C = A(MxK) @ B(KxN)
# ---------------------------------------------------------------------------

def baseline_mults(m: int, k: int, n: int) -> int:
    return m * n * k


def baseline_adds(m: int, k: int, n: int) -> int:
    return m * n * (k - 1)


def fip_mults(m: int, k: int, n: int) -> int:
    """Eq. (5), even K: (MNK + MK + NK) / 2."""
    assert k % 2 == 0
    return (m * n * k + m * k + n * k) // 2


def fip_adds(m: int, k: int, n: int) -> int:
    """Eq. (6): (3MNK + MK + NK)/2 - MN - M - N."""
    assert k % 2 == 0
    return (3 * m * n * k + m * k + n * k) // 2 - m * n - m - n


ffip_mults = fip_mults   # Eq. (7) has identical counts (§3.2)
ffip_adds = fip_adds


# ---------------------------------------------------------------------------
# Eqs. (17)-(19): PE register requirements (bits), Fig. 2
# ---------------------------------------------------------------------------

def clog2(x: int) -> int:
    return max(1, math.ceil(math.log2(max(x, 2))))


def fip_pe_registers(w: int, x: int) -> int:
    """Eq. (17): 6w + clog2(X) + 1."""
    return 6 * w + clog2(x) + 1


def fip_pe_registers_extra(w: int, x: int, d: int = 1) -> int:
    """Eq. (18): FIP PE + multiplier-input registers: 8w + 2d + clog2(X) + 1."""
    return 8 * w + 2 * d + clog2(x) + 1


def ffip_pe_registers(w: int, x: int, d: int = 1) -> int:
    """Eq. (19): 6w + 2d + clog2(X) + 3."""
    return 6 * w + 2 * d + clog2(x) + 3


def baseline_pe_registers(w: int, x: int) -> int:
    """Two baseline PEs (Fig. 1a) ~ comparable compute power: each holds
    a, b, and the 2w+clog2(X)+1 accumulator: 2*(2w + (2w+clog2(X)+1))."""
    return 2 * (2 * w + (2 * w + clog2(x) + 1))


def fig2_table(x: int = 64, d: int = 1, widths: Sequence[int] = tuple(range(2, 17))):
    """Reproduces Fig. 2's three curves."""
    return [
        dict(w=w,
             fip=fip_pe_registers(w, x),
             fip_extra=fip_pe_registers_extra(w, x, d),
             ffip=ffip_pe_registers(w, x, d))
        for w in widths
    ]


# ---------------------------------------------------------------------------
# §4.1 / §6: MXU resource model (multipliers / DSPs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MxuConfig:
    x: int                 # effective MAC columns (K-dim)
    y: int                 # effective MAC rows (N-dim)
    algo: Algo = "ffip"
    w_bits: int = 8        # input bitwidth
    mults_per_dsp: int = 2  # Arria 10: two 18x19 mults per DSP


def mxu_multipliers(cfg: MxuConfig) -> int:
    """Physical multipliers instantiated, §4.1 + post-GEMM rescale row (§6).

    baseline: X*Y MACs. (F)FIP: X/2 columns * (Y+1) rows (the +1 row is the
    alpha generator). All variants: + Y rescale multipliers in the post-GEMM
    unit (the paper: 'requires an additional Y multipliers').
    """
    if cfg.algo == "baseline":
        core = cfg.x * cfg.y
    else:
        core = (cfg.x // 2) * (cfg.y + 1)
    return core + cfg.y


def mxu_dsps(cfg: MxuConfig) -> int:
    return math.ceil(mxu_multipliers(cfg) / cfg.mults_per_dsp)


def mxu_effective_macs(cfg: MxuConfig) -> int:
    """Effective MACs/cycle (what throughput sees): X*Y for every algo."""
    return cfg.x * cfg.y


# ---------------------------------------------------------------------------
# Frequency model — constants measured by the paper (Fig. 9 / Tables 1-2).
# ---------------------------------------------------------------------------

_FMAX_MHZ = {
    # (algo, w_bits) -> (f at size 32, slope MHz per +8 PEs of size)
    ("baseline", 8): (440.0, -9.0),    # ~386 MHz at 64x64, Fig. 9 trend
    ("fip", 8): (310.0, -7.0),         # ~30% below baseline (paper §6.1)
    ("ffip", 8): (424.0, -9.0),        # 388 MHz at 64x64 (Table 1)
    ("baseline", 16): (392.0, -8.0),
    ("fip", 16): (274.0, -6.0),
    ("ffip", 16): (378.0, -8.0),       # 346 MHz at 64x64 (Table 2)
}


def mxu_fmax_mhz(cfg: MxuConfig) -> float:
    base, slope = _FMAX_MHZ[(cfg.algo, cfg.w_bits)]
    return base + slope * (cfg.x - 32) / 8.0


# ---------------------------------------------------------------------------
# Eqs. (22)-(30): roofs
# ---------------------------------------------------------------------------

def ops_roof(cfg: MxuConfig) -> float:
    """Eq. (24c)/(28c): 2*#mult*f (baseline) or 4*#mult*f ((F)FIP), ops/s."""
    f = mxu_fmax_mhz(cfg) * 1e6
    nmul = mxu_multipliers(cfg)
    factor = 2.0 if cfg.algo == "baseline" else 4.0
    return factor * nmul * f


def throughput_per_area_roof(cfg: MxuConfig) -> float:
    """Eq. (25)/(29): ops/s per multiplier."""
    return ops_roof(cfg) / mxu_multipliers(cfg)


def ops_per_mult_per_cycle_roof(cfg: MxuConfig) -> float:
    """Eq. (26)/(30): 2 (baseline) or 4 ((F)FIP)."""
    return 2.0 if cfg.algo == "baseline" else 4.0


# ---------------------------------------------------------------------------
# Deterministic MXU cycle model for GEMM workloads (§4.3, §5.2)
# ---------------------------------------------------------------------------

def gemm_cycles(shape: GemmShape, cfg: MxuConfig, *, pipeline_fill: bool = True) -> int:
    """Cycles to run one GEMM on the MXU, weight-stationary tiling (§4.3).

    B is tiled (X x Y); a tile stays in place while M rows of A stream
    through, one row/cycle. Weight loads are double-buffered and hidden iff
    the A-tile height >= weight-load cycles; (F)FIP loads weights every other
    cycle (§5.2) but K-tiles are X/2 deep, so the hide condition matches the
    paper's 'M_t >= 2*N_t' remark. Pipeline fill/drain: X (baseline) or
    X/2 ((F)FIP) cycles per K-tile column (§4.2: latency is X/2 fewer).
    """
    kx = cfg.x
    tiles_k = math.ceil(shape.k / kx)
    tiles_n = math.ceil(shape.n / cfg.y)
    stream = shape.m                     # one A row per cycle per tile
    fill = (kx if cfg.algo == "baseline" else kx // 2) if pipeline_fill else 0
    # weight-load stall per tile: load Y columns, every-other-cycle for FFIP
    load = cfg.y * (2 if cfg.algo != "baseline" else 1)
    stall = max(0, load - stream)        # hidden when A-stream is long enough
    per_tile = stream + stall
    return tiles_k * tiles_n * per_tile + fill * tiles_k


def model_performance(gemms: Iterable[GemmShape], cfg: MxuConfig) -> dict:
    """Runs the cycle model over a workload; returns the paper's metrics."""
    gemms = list(gemms)
    total_ops = sum(g.ops() for g in gemms)
    total_cycles = sum(gemm_cycles(g, cfg) for g in gemms)
    f_hz = mxu_fmax_mhz(cfg) * 1e6
    seconds = total_cycles / f_hz
    ops_s = total_ops / seconds
    nmul = mxu_multipliers(cfg)
    return dict(
        algo=cfg.algo,
        mxu=f"{cfg.x}x{cfg.y}",
        w_bits=cfg.w_bits,
        multipliers=nmul,
        dsps=mxu_dsps(cfg),
        fmax_mhz=mxu_fmax_mhz(cfg),
        cycles=total_cycles,
        gops=ops_s * 1e-9,                                   # Eq. (31a)
        gops_per_multiplier=ops_s * 1e-9 / nmul,             # Eq. (31b)
        ops_per_mult_per_cycle=ops_s / nmul / f_hz,          # Eq. (31c)
        utilization=total_ops / (2.0 * mxu_effective_macs(cfg) * total_cycles),
        roof_gops=ops_roof(cfg) * 1e-9,
    )


# ---------------------------------------------------------------------------
# The reference's TPU-side roofline constants (v5e-class targets; a TPU's,
# not the card's)
# ---------------------------------------------------------------------------

TPU_PEAK_FLOPS_BF16 = 197e12      # per chip
TPU_HBM_BW = 819e9                # bytes/s per chip
TPU_ICI_BW = 50e9                 # bytes/s per link


def tpu_roofline_terms(hlo_flops: float, hlo_bytes: float,
                       collective_bytes: float, chips: int) -> dict:
    compute = hlo_flops / (chips * TPU_PEAK_FLOPS_BF16)
    memory = hlo_bytes / (chips * TPU_HBM_BW)
    collective = collective_bytes / (chips * TPU_ICI_BW)
    terms = dict(compute_s=compute, memory_s=memory, collective_s=collective)
    terms["bottleneck"] = max(terms, key=lambda k: terms[k] if k.endswith("_s") else -1)
    return terms
