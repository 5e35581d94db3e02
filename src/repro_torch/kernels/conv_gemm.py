"""K7: the fused implicit-im2col conv, Algorithm 1 inside the GEMM. Replaces
the Pallas kernel ``repro/kernels/conv_gemm.py::_fused_flat``
(``_conv_kernel_mac``, ``_conv_kernel_ffip``, ``_gather_tile``) with the
CUDA C++ kernel ``csrc/conv_gemm.cu``; also the host half of that module.

The paper's memory subsystem never materialises an im2col matrix: the §5.1
multi-digit address counters generate the conv->GEMM gather addresses while
the array consumes the stream. On the card each (bm, 32) A tile is gathered
from the padded NHWC input in global memory / L2 into shared memory, and the
tile arithmetic after it is the CUDA-core tile body f32 K1 runs
(``csrc/gemm_kernels.cuh``: one in-order sweep for baseline and FIP; for
FFIP the half-tile k-split plan of :func:`split_rows`, a function of K
only). So the f32 baseline conv gives the same bits as K1 over the
materialised A (int8 too, though int8 K1 runs on the tensor cores: integer
sums are exact in any order), and the batch, folded into M (M = batch * OH
* OW), does not change an image's result. (K2 and K3 run their own
pipelined pair body; K7's FIP/FFIP sum the same products in another
nesting.) Bound on the H100: CUDA-core operations (f32 without TF32;
FIP/FFIP in issue slots).

The plain version (:func:`fused_conv_plain`) is the reference's own
contract: it gathers A with :func:`~repro_torch.core.im2col.conv_gemm_indices`
and runs the plain K1/K2/K3 per group in K7's blocks.

Int8 path (§3.3/§4.4): :func:`prepare_quantized_conv` quantizes the filter
per output channel on the flattened KH*KW*Cin_g axis and precomputes the
Eq. 15 folded beta and the colsums; :func:`quantized_conv_apply` quantizes
the padded input per tensor, runs the fused kernel on the raw int8 operands
and removes the zero-point terms with the Eq. 20 adjuster, the row sums from
an integer box sum over the input (:func:`conv_rowsums`), never from A.
Bit-exact against :func:`quantized_conv_reference`.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import fip, quant
from repro_torch.core.im2col import (Size2, as_pair, conv_gemm_indices,
                                     conv_out_hw)
from repro_torch.kernels import compat, ops
from repro_torch.kernels.baseline_gemm import (KERNEL_BK, acc_dtype_of,
                                               baseline_gemm_plain, int_mm,
                                               kernel_tm)
from repro_torch.kernels.ffip_gemm import ffip_gemm_y_plain
from repro_torch.kernels.fip_gemm import fip_gemm_plain

Tensor = torch.Tensor

counter = compat.launch_counter("conv_gemm")

_ALGO_CODES = {"baseline": 0, "fip": 1, "ffip": 2}
_DTYPE_CODES = {torch.float32: 0, torch.int8: 2}
_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 21 + [ctypes.c_void_p]
# Elements of the plain version's (M, pairs, N) temporaries per step.
_PLAIN_TEMP_ELEMS = 16 << 20
# K7's FFIP plan (FFIP_GROUPS, split_rows, unit_plan, workspace) serves its
# half-tile FFIP body only, and goes with K7's move onto the pair body
# (ROADMAP queue 2 §B). Groups of half-tile splits that one CTA of the FFIP
# body sums itself at large M.
FFIP_GROUPS = 24


def split_rows(k: int) -> Tuple[int, int]:
    """K7's FFIP k-split plan, from K only: ``(rows per split, splits per
    group)``. Splits are half a k-tile (16 rows, whole pairs), so a small M
    has K / 16 CTAs to fill the card with, its time being each CTA's serial
    N sweep; the splits form at most FFIP_GROUPS groups, which one CTA each
    sums at large M."""
    rows = KERNEL_BK // 2
    splits = -(-k // rows)
    return rows, -(-splits // FFIP_GROUPS)


def unit_plan(k: int, rows: int, group: int, ctas_per_unit: int,
              slot_bytes: int) -> Tuple[int, int, int]:
    """How a K7 FFIP launch runs the k-split plan: ``(splits per CTA, units,
    slots per reduction group)``. Either each CTA takes one split (while the
    card would otherwise hold fewer than SMS CTAs and the partials fit the
    workspace) and the reduction sums each group's slots, then the group
    totals; or each CTA sums one whole group itself and the reduction sums
    the group totals. Both sum in the plan's order: the same bits. Only
    this choice depends on M (through ``ctas_per_unit``, the CTAs one unit
    along K takes, and ``slot_bytes``, one partial's size)."""
    splits = -(-k // rows)
    groups = -(-splits // group)
    if (groups < splits and ctas_per_unit * groups < compat.SMS
            and splits * slot_bytes <= compat.WORKSPACE_BYTES):
        return 1, splits, group
    return group, groups, 1


def workspace(units: int, shape, dtype, device) -> Tensor:
    """The (units, *shape) partials buffer, or an empty stand-in when one
    unit writes the output directly."""
    if units <= 1:
        return torch.empty((0,), dtype=dtype, device=device)
    return torch.empty((units, *shape), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class ConvGeom:
    """Conv geometry of one call: the padded input's (h, w, cin), the
    kernel, strides and groups, and the output channels per group."""
    h: int          # padded input height
    w: int          # padded input width
    cin: int
    kh: int
    kw: int
    sh: int
    sw: int
    groups: int
    ng: int         # output channels per group

    @property
    def cin_g(self) -> int:
        return self.cin // self.groups

    @property
    def oh(self) -> int:
        return conv_out_hw(self.h, self.w, self.kh, self.kw,
                           (self.sh, self.sw))[0]

    @property
    def ow(self) -> int:
        return conv_out_hw(self.h, self.w, self.kh, self.kw,
                           (self.sh, self.sw))[1]

    @property
    def m(self) -> int:
        """Output pixels per image."""
        return self.oh * self.ow

    @property
    def k(self) -> int:
        """Gather-valid contraction length KH*KW*Cin_g (the weight stack
        may carry an extra zero row when K is odd: evenized for the pair
        algebra)."""
        return self.kh * self.kw * self.cin_g


def _kernel_to_stack(kernel: Tensor, groups: int) -> Tensor:
    """(KH, KW, Cin_g, Cout) -> (G, KH*KW*Cin_g, Cout/G): the per-group B
    operands on the flattened (kh, kw, cin) contraction axis."""
    kh, kw, cin_g, cout = kernel.shape
    if cout % groups:
        raise ValueError(f"cout={cout} not divisible by groups={groups}")
    ng = cout // groups
    b2 = kernel.reshape(kh * kw * cin_g, cout)
    return b2.reshape(kh * kw * cin_g, groups, ng).permute(1, 0,
                                                           2).contiguous()


def _evenize_k(bg: Tensor) -> Tensor:
    """Zero-pad the contraction axis to even length (the FIP pair algebra
    consumes K in pairs; a zero row pairs exactly)."""
    if bg.shape[1] % 2:
        bg = F.pad(bg, (0, 0, 0, 1))
    return bg


def _y_even(bg: Tensor) -> Tensor:
    """Evenize, then the Eq. 9 y deltas of each group's weights."""
    return torch.stack([fip.make_y(b) for b in _evenize_k(bg)])


def fused_conv_plain(x: Tensor, bg: Tensor, geom: ConvGeom, *, algo: str,
                     bm: int, bn: int, bk: int,
                     fold_beta: bool = False) -> Tensor:
    """K7's plain version. x: (B, Hp, Wp, Cin) padded; bg: (G, Ks, Ng) (y
    deltas for ffip). Per group: gather A (B*M, K) through the Algorithm-1
    indices, zero-pad it to Ks, run the plain K1/K2/K3 in (bm, bn, bk).
    Returns (B, OH, OW, G*Ng) in the accumulation dtype."""
    n_b = x.shape[0]
    flat = x.reshape(n_b, -1)
    ks = bg.shape[1]
    rows = n_b * geom.m
    # pairs per step of the FIP-family plain versions: their (rows, pairs,
    # Ng) temporaries stay near _PLAIN_TEMP_ELEMS (all 16 pairs of a bk=32
    # tile at small shapes, the same sums as k_chunk=0)
    k_chunk = max(1, min(bk // 2,
                         _PLAIN_TEMP_ELEMS // max(1, rows * geom.ng)))
    outs = []
    for g in range(geom.groups):
        idx = torch.from_numpy(conv_gemm_indices(
            geom.h, geom.w, geom.cin, geom.kh, geom.kw, (geom.sh, geom.sw),
            groups=geom.groups, group=g)).to(x.device)
        a = flat[:, idx].reshape(rows, geom.k)
        if geom.k < ks:
            a = F.pad(a, (0, ks - geom.k))
        if algo == "baseline":
            o = baseline_gemm_plain(a, bg[g], bm=bm, bn=bn, bk=bk)
        elif algo == "fip":
            o = fip_gemm_plain(a, bg[g], bm=bm, bn=bn, bk=bk,
                               fold_beta=fold_beta, k_chunk=k_chunk)
        else:
            o = ffip_gemm_y_plain(a, bg[g], bm=bm, bn=bn, bk=bk,
                                  fold_beta=fold_beta, k_chunk=k_chunk)
        outs.append(o)
    out = outs[0] if geom.groups == 1 else torch.cat(outs, dim=-1)
    return out.reshape(n_b, geom.oh, geom.ow, geom.groups * geom.ng)


def _fused_cuda(x: Tensor, bg: Tensor, geom: ConvGeom, *, algo: str,
                bm: int, bn: int, bk: int, fold_beta: bool) -> Tensor:
    """Launch K7 (images in chunks where the split partials would pass the
    workspace bound: an image's sums are the same in any chunk)."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"conv_gemm: input dtype {x.dtype} (f32 or int8)")
    acc = acc_dtype_of(x.dtype)
    want = acc if algo == "ffip" else x.dtype
    if bg.dtype != want:
        raise ValueError(f"conv_gemm: {algo} weights must be {want}, got "
                         f"{bg.dtype}")
    x = x.contiguous()
    bg = bg.contiguous()
    compat.require_cuda(x, bg)
    if x.numel() >= 2 ** 31:
        raise ValueError("conv_gemm: input too large for 32-bit addresses")
    tm = kernel_tm(bm, bn, bk)
    n_b = x.shape[0]
    _, ks, ng = bg.shape
    ldo = geom.groups * ng
    m = n_b * geom.m
    m_blocks = -(-m // bm)
    rows = spu = red = 0
    units = 1                  # baseline / FIP: one in-order sweep of K
    if algo == "ffip":
        rows, group = split_rows(ks)
        spu, units, red = unit_plan(ks, rows, group, m_blocks * geom.groups,
                                    m * ldo * 4)
    per_img = geom.m * ldo * 4
    chunk = n_b
    if units > 1 and units * n_b * per_img > compat.WORKSPACE_BYTES:
        chunk = max(1, compat.WORKSPACE_BYTES // (units * per_img))
    out = torch.empty((n_b, geom.oh, geom.ow, ldo), dtype=acc,
                      device=x.device)
    ws = workspace(units, (min(chunk, n_b) * geom.m, ldo), acc, x.device)
    lib = compat.load("conv_gemm", {"conv_gemm_launch": _SIG})
    for b0 in range(0, n_b, chunk):
        nb = min(chunk, n_b - b0)
        err = lib.conv_gemm_launch(
            x[b0].data_ptr(), bg.data_ptr(), ws.data_ptr(),
            out[b0].data_ptr(), nb, geom.h, geom.w, geom.cin, geom.groups,
            geom.kh, geom.kw, geom.sh, geom.sw, geom.oh, geom.ow, geom.k, ng,
            ks, rows, spu, red, _ALGO_CODES[algo], _DTYPE_CODES[x.dtype], tm,
            int(fold_beta), compat.stream_ptr(x))
        counter.bump()
        compat.check(err, "conv_gemm")
    return out


def fused_conv_raw(x: Tensor, bg: Tensor, *, kh: int, kw: int,
                   stride: Size2 = 1, groups: int = 1, algo: str = "ffip",
                   bm: int = 0, bn: int = 0, bk: int = 0,
                   fold_beta: bool = False) -> Tensor:
    """Raw fused conv on an already spatially padded input.

    x: (B, Hp, Wp, Cin) (f32 or int8 on the card, any dtype on the CPU);
    bg: (G, Ks, Ng) per-group weight stack on the flattened (kh, kw, cin_g)
    axis (Ks may be the evenized K). Returns (B, OH, OW, Cout) in the
    accumulation dtype (int32 for ints, float32 for floats). CPU tensors
    take :func:`fused_conv_plain`; CUDA tensors launch K7 (or raise)."""
    compat.refuse_grad("conv_gemm", x, bg)
    if algo not in _ALGO_CODES:
        raise ValueError(algo)
    n_b, h, w, cin = x.shape
    sh, sw = as_pair(stride)
    n_g, ks, ng = bg.shape
    if n_g != groups:
        raise ValueError(f"b-stack has {n_g} groups, expected {groups}")
    if cin % groups:
        raise ValueError(f"cin={cin} not divisible by groups={groups}")
    geom = ConvGeom(h=h, w=w, cin=cin, kh=kh, kw=kw, sh=sh, sw=sw,
                    groups=groups, ng=ng)
    if ks not in (geom.k, geom.k + geom.k % 2):
        raise ValueError(f"b-stack K={ks} does not match KH*KW*Cin_g={geom.k}")
    # the offline weight derivations (evenize, y deltas; §4.4) are memoised
    # per weight, as K3's y deltas are
    if algo == "ffip":
        bg = compat.current_derived().get("y_even", bg, _y_even)
    elif algo == "fip":
        bg = compat.current_derived().get("even", bg, _evenize_k)
    if not (bm and bn and bk):
        bm, bn, bk = ops.mac_blocks(n_b * geom.m)
    if algo in ("fip", "ffip") and bk % 2:
        raise ValueError(f"bk={bk} must be even for the FIP pair algebra")
    if x.device.type == "cpu":
        return fused_conv_plain(x, bg, geom, algo=algo, bm=bm, bn=bn, bk=bk,
                                fold_beta=fold_beta)
    return _fused_cuda(x, bg, geom, algo=algo, bm=bm, bn=bn, bk=bk,
                       fold_beta=fold_beta)


def conv_gemm_fused(x: Tensor, kernel: Tensor, *, stride: Size2 = 1,
                    pad: Size2 = 0, groups: int = 1, algo: str = "ffip",
                    bm: int = 0, bn: int = 0, bk: int = 0) -> Tensor:
    """NHWC conv through K7 (the float front door). x: (B, H, W, Cin);
    kernel: (KH, KW, Cin/groups, Cout). Drop-in for
    :func:`~repro_torch.core.im2col.conv2d_via_gemm`: the same (B, OH, OW,
    Cout) result, with A never built outside shared-memory tiles."""
    compat.refuse_grad("conv_gemm", x, kernel)
    ph, pw = as_pair(pad)
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    kh, kw, _, _ = kernel.shape
    bg = compat.current_derived().get(
        f"stack{groups}", kernel, lambda k_: _kernel_to_stack(k_, groups))
    out = fused_conv_raw(x, bg, kh=kh, kw=kw, stride=stride, groups=groups,
                         algo=algo, bm=bm, bn=bn, bk=bk)
    if not x.dtype.is_floating_point:
        return out                                   # int32 accumulator
    return out.to(torch.promote_types(x.dtype, kernel.dtype))


# ---------------------------------------------------------------------------
# Quantized conv (§3.3/§4.4 on the flattened KH*KW*Cin_g axis)
# ---------------------------------------------------------------------------

def prepare_quantized_conv(kernel: Tensor, *, groups: int = 1,
                           dtype=torch.int8) -> dict:
    """Offline filter quantization for the int8 conv path. kernel: (KH, KW,
    Cin/groups, Cout). Per output channel on the flattened KH*KW*Cin_g axis
    through :func:`~repro_torch.core.quant.prepare_quantized_dense` on the
    (G, K, Ng) stack (Eq. 15 folded beta and colsums included), with K
    zero-evenized for the pair algebra. Returns that dict plus the conv
    bookkeeping (k_real, kh, kw, groups), as Python ints."""
    kh, kw, cin_g, _ = kernel.shape
    bg = _evenize_k(_kernel_to_stack(kernel, groups))
    q = quant.prepare_quantized_dense(bg, dtype=dtype)
    q.update(k_real=kh * kw * cin_g, kh=kh, kw=kw, groups=groups)
    return q


def quantize_input_per_tensor(xp: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-tensor asymmetric int8 quantization of a spatially PADDED input
    (pad first: a real 0.0 then quantizes exactly to the zero point, so
    border windows stay faithful). Returns (xq int8, scale f32, zp i32)."""
    x32 = xp.to(torch.float32)
    xmin = torch.clamp_max(torch.amin(x32), 0.0)
    xmax = torch.clamp_min(torch.amax(x32), 0.0)
    scale = torch.clamp_min((xmax - xmin) / 255.0, 1e-12)
    zp = torch.clamp(torch.round(-128 - xmin / scale), -128, 127).to(
        torch.int32)
    xq = torch.clamp(torch.round(x32 / scale) + zp, -128, 127).to(torch.int8)
    return xq, scale, zp


def conv_rowsums(xq: Tensor, *, kh: int, kw: int, stride: Size2,
                 groups: int = 1) -> Tensor:
    """rowsum(A_q) of the implicit im2col matrix, per group, without A: sum
    the padded, quantized input over each group's channels, then box-sum
    over each kernel window, in int32 (exact). xq: (B, Hp, Wp, Cin) ->
    (B, OH, OW, G): the Eq. 20 adjuster's input."""
    sh, sw = as_pair(stride)
    n_b, h, w, cin = xq.shape
    xs = torch.sum(xq.to(torch.int32).reshape(n_b, h, w, groups,
                                              cin // groups),
                   dim=-1, dtype=torch.int32)
    win = xs.unfold(1, kh, sh).unfold(2, kw, sw)     # (B, OH, OW, G, kh, kw)
    return torch.sum(win, dim=(-2, -1), dtype=torch.int32)


def quantized_conv_apply(x: Tensor, q: dict, *, stride: Size2 = 1,
                         pad: Size2 = 0, algo: str = "ffip",
                         bm: int = 0, bn: int = 0, bk: int = 0) -> Tensor:
    """Int8 conv through offline-prepared weights and K7: raw (F)FIP on the
    quantized integers (both signed, d = 1, beta folded offline per Eq. 15),
    the zero-point terms removed with the Eq. 20 adjuster from the windowed
    row sums and the offline colsums. Returns float32 (B, OH, OW, Cout)."""
    ph, pw = as_pair(pad)
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    xq, a_scale, a_zp = quantize_input_per_tensor(x)
    fold = algo in ("fip", "ffip")
    raw = fused_conv_raw(xq, q["qw"], kh=q["kh"], kw=q["kw"], stride=stride,
                         groups=q["groups"], algo=algo, bm=bm, bn=bn, bk=bk,
                         fold_beta=fold)
    return _dequantize_conv(raw, xq, q, a_scale, a_zp, stride=stride,
                            fold_beta=fold)


def _dequantize_conv(raw: Tensor, xq: Tensor, q: dict, a_scale: Tensor,
                     a_zp: Tensor, *, stride: Size2,
                     fold_beta: bool) -> Tensor:
    """Shared epilogue: folded beta + zero-point corrections + rescale.
    raw: (B, OH, OW, Cout) int32 = A_q W_q (cross - alpha when
    fold_beta)."""
    groups, kh, kw = q["groups"], q["kh"], q["kw"]
    ng = q["qw"].shape[-1]
    n_b, oh, ow = raw.shape[0], raw.shape[1], raw.shape[2]
    acc = raw.reshape(n_b, oh, ow, groups, ng)
    if fold_beta:
        acc = acc + q["neg_beta"]                    # Eq. 15: + (-beta(W_q))
    rs = conv_rowsums(xq, kh=kh, kw=kw, stride=stride, groups=groups)
    acc = (acc
           - a_zp * q["colsum"]                      # za * colsum(W_q)
           - rs[..., None] * q["zp"]                 # Eq. 20: zb_j rowsum(A)_i
           + q["k_real"] * a_zp * q["zp"])
    out = acc.to(torch.float32) * (a_scale * q["scale"])
    return out.reshape(n_b, oh, ow, groups * ng)


def quantized_conv_reference(x: Tensor, q: dict, *, stride: Size2 = 1,
                             pad: Size2 = 0, algo: str = "ffip",
                             k_chunk: int = 0) -> Tensor:
    """Materialising oracle of :func:`quantized_conv_apply`: gathers the
    whole A_q through the Algorithm-1 indices and runs the same integer
    algebra through the ``core.fip`` closed forms (at most ``k_chunk``
    pairs at a time, a divisor of K/2, to bound their temporaries).
    Bit-identical to the fused path (int32 sums are exact)."""
    ph, pw = as_pair(pad)
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    xq, a_scale, a_zp = quantize_input_per_tensor(x)
    groups, kh, kw = q["groups"], q["kh"], q["kw"]
    n_b, h, w, cin = xq.shape
    sh, sw = as_pair(stride)
    oh, ow = conv_out_hw(h, w, kh, kw, (sh, sw))
    flat = xq.reshape(n_b, h * w * cin)
    ks = q["qw"].shape[1]
    zero_bias = torch.zeros((), dtype=torch.int32, device=x.device)
    pairs = ks // 2
    if 0 < k_chunk < pairs:
        k_chunk = max(d for d in range(1, k_chunk + 1) if pairs % d == 0)
    raws = []
    for g in range(groups):
        idx = torch.from_numpy(conv_gemm_indices(
            h, w, cin, kh, kw, (sh, sw), groups=groups, group=g)).to(x.device)
        aq = flat[:, idx].to(torch.int32)            # (B, M, K) materialised
        if aq.shape[-1] < ks:                        # evenized weight K
            aq = F.pad(aq, (0, ks - aq.shape[-1]))
        b32 = q["qw"][g].to(torch.int32)
        if algo == "baseline":
            raws.append(int_mm(aq, b32))
        elif algo == "ffip":
            raws.append(fip.fip_matmul_beta_folded(
                fip.pair_swap(aq), fip.pair_swap_rows(b32), zero_bias,
                k_chunk=k_chunk))
        else:
            raws.append(fip.fip_matmul_beta_folded(aq, b32, zero_bias,
                                                   k_chunk=k_chunk))
    raw = torch.stack(raws, dim=1)                   # (B, G, M, Ng)
    ng = q["qw"].shape[-1]
    raw = raw.permute(0, 2, 1, 3).reshape(n_b, oh, ow, groups * ng)
    return _dequantize_conv(raw, xq, q, a_scale, a_zp, stride=stride,
                            fold_beta=(algo != "baseline"))

