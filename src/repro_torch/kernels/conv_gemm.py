"""K7: the fused implicit-im2col conv, Algorithm 1 inside the GEMM. Replaces
the Pallas kernel ``repro/kernels/conv_gemm.py::_fused_flat``
(``_conv_kernel_mac``, ``_conv_kernel_ffip``, ``_gather_tile``) with the
CUDA C++ kernel ``csrc/conv_gemm.cu``; also the host half of that module.

The paper's memory subsystem never materialises an im2col matrix: the §5.1
multi-digit address counters generate the conv->GEMM gather addresses while
the array consumes the stream. On the card each (bm, 32) A stage is gathered
from the padded NHWC input in global memory / L2 straight into shared
memory (16-byte ``cp.async`` where Cin_g is a whole number of 16-byte
chunks, plain loads otherwise), and the tile arithmetic after it is K2's
and K3's: FIP and FFIP run on their pipelined pair body
(``csrc/fip_body.cuh``, its ``ConvRows`` loader), FFIP from y and a carry
table per group (:func:`carry_stack`, derived once per weight), with K2's
and K3's split and launch plans (``fip_gemm.split_plan``, ``launch_plan``)
and the groups folded into the grid. So K7's FIP and FFIP sum what K2 and
K3 sum over the materialised A, in the same nesting, at every K: the same
bits. The baseline keeps f32 K1's CUDA-core body (no TF32): the same bits
as f32 K1 over the materialised A (int8: integer sums are exact in any
order). The batch, folded into M (M = batch * OH * OW), changes neither the
splits nor the order of a row's sums, so it does not change an image's
result. The tile comes from M, N and K (:func:`conv_blocks`). Bound on the
H100: the CUDA cores' issue slots for FIP/FFIP (2 adds + 1 multiply-add a pair
and output), the f32 FMA rate for the f32 baseline.

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
from repro_torch.kernels.baseline_gemm import (acc_dtype_of,
                                               baseline_gemm_plain, int_mm,
                                               kernel_tm)
from repro_torch.kernels.ffip_gemm import carry_table, ffip_gemm_y_plain
from repro_torch.kernels.fip_gemm import (PAIR_BK, fip_gemm_plain,
                                          launch_plan, pair_geom, split_plan)
from repro_torch.obs import profile as _obs_profile

Tensor = torch.Tensor

counter = compat.launch_counter("conv_gemm")

_ALGO_CODES = {"baseline": 0, "fip": 1, "ffip": 2}
_DTYPE_CODES = {torch.float32: 0, torch.int8: 2}
_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 20 + [ctypes.c_void_p]
# Elements of the plain version's (M, pairs, N) temporaries per step.
_PLAIN_TEMP_ELEMS = 16 << 20
# CTAs a 128 x 128 launch needs to take that tile (as fip_gemm's launch plan
# counts a filled card).
_WIDE_FILL = compat.SMS * 9 // 10


def conv_blocks(m: int, n: int, k: int, algo: str,
                groups: int = 1) -> Tuple[int, int, int]:
    """K7's (bm, bn, bk) for M output pixels, N output channels a group and
    the (evenized) K. The baseline: the CUDA-core body's
    (:func:`~repro_torch.kernels.ops.mac_blocks`). FIP and FFIP: a tile of
    the pair body (``fip_gemm.PAIR_GEOMS``), where K2's and K3's
    ``pair_blocks`` looks at M only: 128 x 128 where N > 64 and its launch
    (one split a CTA where the grid alone would leave SMs idle,
    ``fip_gemm.launch_plan``) fills the card; else 64 x 64 (N <= 64, as
    ResNet-50's conv1 and stage 2, where a 128-column tile computes half
    zeros; ResNet-50's 1x1 convs of stages 4-5 at batch 8, whose grid is
    short and K one split). The tile never changes a row's sums (fixed
    k-tile order, the split plan from K only)."""
    if algo == "baseline":
        return ops.mac_blocks(m)
    ctas = -(-m // 128) * -(-n // 128) * groups
    if launch_plan(m, n, k, 128, 128, groups=groups):
        ctas *= split_plan(k)[1]
    if n <= 64 or ctas < _WIDE_FILL:
        return 64, 64, PAIR_BK
    return 128, 128, PAIR_BK


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


def carry_stack(y: Tensor) -> Tensor:
    """The (G, K, ceil(N / 32)) carry tables of a (G, K, N) y stack: each
    group's ``ffip_gemm.carry_table``, so K7's rebuilt weights are K3's."""
    return torch.stack([carry_table(yg) for yg in y])


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


def _fused_cuda(x: Tensor, bg: Tensor, carry, geom: ConvGeom, *,
                algo: str, bm: int, bn: int, bk: int,
                fold_beta: bool) -> Tensor:
    """Launch K7 on the whole batch: FIP/FFIP on the pair body in K2's and
    K3's split and launch plans, the baseline on the CUDA-core body."""
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
    n_b = x.shape[0]
    _, ks, ng = bg.shape
    ldo = geom.groups * ng
    m = n_b * geom.m
    tm = tile = rows = 0
    splits, split_cta = 1, False
    if algo == "baseline":
        tm = kernel_tm(bm, bn, bk)
    else:
        tile = pair_geom(bm, bn, bk)
        rows, splits = split_plan(ks)
        split_cta = launch_plan(m, ng, ks, bm, bn, groups=geom.groups)
    out = torch.empty((n_b, geom.oh, geom.ow, ldo), dtype=acc,
                      device=x.device)
    ws = (torch.empty((splits, m, ldo), dtype=acc, device=x.device)
          if split_cta else out)
    if x.device.type == "meta":
        compat.on_meta(counter, algo=algo, dtype=compat.DTYPE_NAMES[x.dtype],
                       x_numel=x.numel(), groups=geom.groups, ng=ng, m=m,
                       k=geom.k, fold_beta=bool(fold_beta))
        return out
    lib = compat.load("conv_gemm", {"conv_gemm_launch": _SIG})
    err = lib.conv_gemm_launch(
        x.data_ptr(), bg.data_ptr(),
        None if carry is None else carry.data_ptr(), ws.data_ptr(),
        out.data_ptr(), n_b, geom.h, geom.w, geom.cin, geom.groups, geom.kw,
        geom.sh, geom.sw, geom.oh, geom.ow, geom.k, ng, ks,
        _ALGO_CODES[algo], _DTYPE_CODES[x.dtype], tm, tile, rows,
        int(split_cta), int(fold_beta), compat.stream_ptr(x))
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
    take :func:`fused_conv_plain`; CUDA tensors launch K7 (or raise); meta
    tensors charge a costing trace."""
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
    # the offline weight derivations (evenize, y deltas and, on the card,
    # their carry tables; §4.4) are memoised per weight, as K3's are
    memo = compat.current_derived()
    carry = None
    if algo == "ffip":
        bg = memo.get("y_even", bg, _y_even)
        if bg.device.type == "cuda":
            carry = memo.get("carry_even", bg, carry_stack)
    elif algo == "fip":
        bg = memo.get("even", bg, _evenize_k)
    if not (bm and bn and bk):
        bm, bn, bk = conv_blocks(n_b * geom.m, ng, bg.shape[1], algo,
                                 groups)
    if algo in ("fip", "ffip") and bk % 2:
        raise ValueError(f"bk={bk} must be even for the FIP pair algebra")
    if x.device.type == "cpu":
        return fused_conv_plain(x, bg, geom, algo=algo, bm=bm, bn=bn, bk=bk,
                                fold_beta=fold_beta)
    return _fused_cuda(x, bg, carry, geom, algo=algo, bm=bm, bn=bn, bk=bk,
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
    sh, sw = as_pair(stride)
    _obs_profile.on_conv(x, kernel, oh=(x.shape[1] - kh) // sh + 1,
                         ow=(x.shape[2] - kw) // sw + 1, groups=groups,
                         algo=algo)
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
    scale = torch.clamp_min(quant.range_div(xmax - xmin, 255), 1e-12)
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

