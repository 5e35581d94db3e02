"""Hand-written CUDA kernels (K1-K9) against their plain PyTorch versions,
on the card. Marked ``cuda``; they skip where there is no card. This file
imports no JAX (the machine with the card has none).

Run there:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: int8 paths are exact (int32 ``assert_equal``). Float GEMMs sum
in another order than the plain tile loop (k splits, FMA contraction, K3's
carry-table rebuild), so they use the reference's f32 GEMM bar from
tests/test_kernels.py (rtol 1e-4, atol 1e-3 * max(1, K // 64)); flash uses
the reference flash bar (rtol = atol = 2e-3) on f32 o/lse, and the bf16
output rounding (2**-8 relative) on bf16 o; the paged kernel K5 the same
bars, with rows that have no valid key exactly 0. The fused conv K7 takes the
GEMM bars against its plain version (its K is KH*KW*Cin_g), and equals K1-K3
over the materialised A bit for bit (the same bodies, nesting and plans).
The selective scan K6 holds h_final and h_starts within rtol = atol = 1e-4
of the plain f32 values (the reference kernel's bar in
tests/test_selective_scan.py) and y within one bf16 ulp in bf16, 1e-4 in
f32, and, with the plain version's adds in its order, equals it bit for bit
at falcon-mamba-7b's width (and its launch plan is scan_plan's). The
flash backward K8 holds its f32 dq/dk/dv within rtol 1e-4, atol 1e-4 *
max|plain| (the same products summed in another block order) and, once
cast, one bf16 ulp beyond that atol; the scan backward K9 its five
gradients bit for bit. K5's rows are bit for bit the same whatever chunk
or batch they sit in. K3's carry-table kernel is bit for bit (the plain
version's adds in its order). Batch invariance is bit for bit
(``torch.equal``): a row's sums must not depend on the rows beside it.
``repro_torch.obs.profile`` counts a GEMM inside a CUDA graph capture as a
trace, not a dispatch, and one cell of the router's fault matrix ends
token-identical to its no-fault oracle on the card. The GEMM cases include
minicpm-2b's local shapes at tensor-parallel size 2, and the
tensor-parallel int8 layers equal the whole layer bit for bit on two
ranks sharing the card; K6 on one rank's half of d_inner equals the whole
K6's columns bit for bit; whisper's frontend entry on two ranks gives one
card's int8 tokens. A train step on two ranks sharing the card, at (1, 2)
and (2, 1), gives one card's loss (rtol 1e-5) and gradients (the CPU
tests' bar, rtol 1e-3, atol 1e-3 * max|leaf|), with K4 and K8 launched on
each rank's heads and batch rows, and K6 and K9 on its channels.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.im2col import conv2d_via_gemm
from repro_torch.kernels import compat, conv_gemm, ops
from repro_torch.kernels.baseline_gemm import baseline_gemm, baseline_gemm_plain
from repro_torch.kernels.ffip_gemm import (carry_table, carry_table_plain,
                                           ffip_gemm_y, ffip_gemm_y_plain,
                                           y_for)
from repro_torch.kernels.fip_gemm import fip_gemm, fip_gemm_plain
from repro_torch.kernels.flash_attention import _flash_fwd, _flash_fwd_plain
from repro_torch.kernels.flash_paged import (flash_attention_paged,
                                             flash_attention_paged_plain)
from repro_torch.kernels.selective_scan import (selective_scan,
                                                selective_scan_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    compat.build_all()
    for name, log in sorted(compat.build_log.items()):
        print(f"--- nvcc {name}\n{log}")
    return torch.device("cuda", 0)


def _operands(m, k, n, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.int8:
        a = torch.randint(-128, 128, (m, k), generator=g, device=dev)
        b = torch.randint(-128, 128, (k, n), generator=g, device=dev)
        return a.to(torch.int8), b.to(torch.int8)
    a = torch.randn((m, k), generator=g, device=dev).to(dtype)
    b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(dtype)
    return a, b


def _k_chunk(m, n):
    """Pairs per plain-version step so its (M, pairs, N) tensors stay small."""
    return max(1, min(16, (64 << 20) // max(1, m * n * 4)))


def _compare(got, want, dtype, k):
    got, want = got.cpu(), want.cpu()
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.double().numpy(), want.double().numpy(),
                                   rtol=1e-4, atol=1e-3 * max(1, k // 64))


# The served shapes, and ragged ones for each of K1's tensor-core tiles and
# loaders: M 1, 17 and 130 (under and over a tile), K not a multiple of the
# k-tile, N not a multiple of the tile. bf16 rows 16-byte aligned take the
# TMA loader: (1, 1032, 4104) the 16 x 64 tiles, (130, 1024, 1000) the
# 64 x 64 ones, (130, 520, 16400) the 128 x 128 ones. Rows that are not
# (K 100 or 1030, N 200, 257 or 1001; int8 N not a multiple of 16) take the
# cp.async loader with plain loads: (1, 130, 257), (17, 100, 200) and
# (130, 1030, 1001).
# minicpm-2b's local shapes at tp 2 (a rank's piece of wq/wo, up/gate and
# down): K 1152 and 2880, N 1152 and 2880.
SHAPES = [(4, 2304, 2304), (4, 5760, 2304), (100, 60, 36), (1, 130, 257),
          (64, 2304, 5760), (4, 8192, 288), (128, 256, 8192),
          (17, 100, 200), (130, 1030, 1001), (130, 520, 16400),
          (1, 1032, 4104), (130, 1024, 1000)] + [
    (m, k, n) for m in (4, 512) for k, n in ((2304, 1152), (2304, 2880),
                                             (1152, 2304), (2880, 2304))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_gemm_kernels_match_plain(dev, m, k, n, dtype):
    a, b = _operands(m, k, n, dtype, dev)
    bm, bn, bk = ops.choose_blocks(m, n, k, "baseline", dtype)
    kc = _k_chunk(m, n)
    _compare(baseline_gemm(a, b, bm=bm, bn=bn, bk=bk),
             baseline_gemm_plain(a, b, bm=bm, bn=bn, bk=bk), dtype, k)
    bm, bn, bk = ops.choose_blocks(m, n, k, "ffip")
    y = y_for(b)
    for fold in (False, True):
        _compare(fip_gemm(a, b, bm=bm, bn=bn, bk=bk, fold_beta=fold),
                 fip_gemm_plain(a, b, bm=bm, bn=bn, bk=bk, fold_beta=fold,
                                k_chunk=kc), dtype, k)
        _compare(ffip_gemm_y(a, y, bm=bm, bn=bn, bk=bk, fold_beta=fold),
                 ffip_gemm_y_plain(a, y, bm=bm, bn=bn, bk=bk, fold_beta=fold,
                                   k_chunk=kc), dtype, k)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("blocks", [(16, 32, 32), (64, 64, 32),
                                    (128, 128, 32)])
@pytest.mark.parametrize("m,k,n", [(130, 1030, 1001), (130, 1024, 1000),
                                   (9, 520, 257), (70, 96, 31)])
def test_pair_kernels_every_geometry_ragged(dev, m, k, n, blocks, dtype):
    """K2 and K3 at each tile geometry of the pair body, whatever M is, on
    ragged shapes: N not a multiple of the tile, of 32 or of 16 bytes (the
    plain-load path), K over one split (1030: three splits, the last
    ragged) and under one, M over and under a tile."""
    a, b = _operands(m, k, n, dtype, dev, seed=3)
    bm, bn, bk = blocks
    y = y_for(b)
    kc = _k_chunk(m, n)
    for fold in (False, True):
        _compare(fip_gemm(a, b, bm=bm, bn=bn, bk=bk, fold_beta=fold),
                 fip_gemm_plain(a, b, bm=bm, bn=bn, bk=bk, fold_beta=fold,
                                k_chunk=kc), dtype, k)
        _compare(ffip_gemm_y(a, y, bm=bm, bn=bn, bk=bk, fold_beta=fold),
                 ffip_gemm_y_plain(a, y, bm=bm, bn=bn, bk=bk, fold_beta=fold,
                                   k_chunk=kc), dtype, k)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("k,n", [(16, 288), (9, 257), (6, 31), (130, 32),
                                 (2304, 5760), (1, 5760), (7, 33),
                                 (9, 4097), (2304, 33), (2304, 1152),
                                 (2304, 2880)])
def test_carry_table_kernel_equals_plain(dev, k, n, dtype):
    """K3's carry table derived on the card equals the plain derivation bit
    for bit (the same adds in the same order; f32 and int32), ragged N and
    N under one group included, in one counted launch."""
    _, b = _operands(1, k, n, dtype, dev, seed=k + n)
    y = y_for(b)
    before = compat.launch_counts()["ffip_carry_table"]
    got = carry_table(y)
    assert compat.launch_counts()["ffip_carry_table"] == before + 1
    want = carry_table_plain(y)
    torch.cuda.synchronize()
    assert got.shape == (k, -(-n // 32)) and got.dtype == y.dtype
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,window,causal,d", [
    (128, 0, True, 64), (77, 0, True, 64), (100, 16, True, 64),
    (64, 0, False, 64),
    (256, 0, True, 64),      # the trained sequence
    (16, 0, True, 64),       # the shortest served bucket: one warp a CTA
    (128, 0, True, 128),     # K4's second tensor-core instantiation
    (77, 0, True, 40)])      # d 40 runs the d 64 body, zero-filled
def test_flash_kernel_matches_plain(dev, dtype, sq, window, causal, d):
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((8, sq, d), generator=g, device=dev).to(dtype)
               for _ in range(3))
    o, lse = _flash_fwd(q, k, v, window, causal=causal)
    o_ref, lse_ref = _flash_fwd_plain(q, k, v, window, causal=causal)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               o_ref.float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                               rtol=2e-3, atol=2e-3)


# (B, H, KV, Sq, d, dv, ps, max_pages, window, scale)
PAGED_CASES = [
    (4, 36, 36, 1, 64, 64, 16, 16, 0, None),        # decode
    (4, 36, 36, 4, 64, 64, 16, 16, 0, None),
    (1, 36, 36, 64, 64, 64, 16, 16, 0, None),       # prefill chunk
    (3, 16, 4, 5, 64, 64, 8, 8, 0, None),           # GQA group 4
    (3, 8, 8, 7, 64, 64, 16, 8, 20, None),          # window
    (2, 16, 1, 2, 576, 512, 16, 4, 0, 192 ** -0.5),  # absorbed-MLA shape
    (4, 8, 8, 1, 64, 64, 16, 32, 0, None),          # lengths 0, 64, 65, 512
    (2, 8, 4, 3, 128, 128, 16, 8, 0, None),         # d 128
    (3, 8, 8, 5, 40, 40, 16, 8, 0, None),           # d 40
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,sq,d,dv,ps,mp,window,scale", PAGED_CASES)
def test_paged_kernel_matches_plain(dev, dtype, b, h, kv, sq, d, dv, ps, mp,
                                    window, scale):
    g = torch.Generator(device=dev).manual_seed(2)
    n_pages = b * mp + 3
    q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((n_pages, ps, kv, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((n_pages, ps, kv, dv), generator=g, device=dev).to(dtype)
    pt = torch.randperm(n_pages, generator=g, device=dev)[:b * mp]
    pt = pt.reshape(b, mp).to(torch.int32)
    lengths = torch.randint(sq, ps * mp + 1, (b,), generator=g, device=dev)
    lengths[0] = 0                          # no valid key: exact zeros
    q_start = (lengths - sq).clamp_min(0)
    if sq == 64:
        lengths[:], q_start[:] = 128, 64    # the second chunk of a prompt
    if ps * mp == 512:
        # 8 splits of 64 keys: lengths on, just past and at the last split
        # boundary
        lengths = torch.tensor([0, 64, 65, 512], device=dev)
        q_start = (lengths - sq).clamp_min(0)
    o = flash_attention_paged(q, kp, vp, pt, lengths, q_start, window,
                              scale=scale)
    want = flash_attention_paged_plain(q, kp, vp, pt, lengths, q_start,
                                       window, scale=scale)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    if sq != 64:
        assert torch.count_nonzero(o[0]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 36])
def test_paged_kernel_unaligned_pools(dev, dtype, d):
    """Pools that start one element past a 16-byte boundary, and (d 36,
    bf16) rows that are not a whole number of 16-byte chunks, take the
    kernel's element-wise loaders: the same bar against the plain
    version."""
    g = torch.Generator(device=dev).manual_seed(5)
    b, h, kv, sq, ps, mp = 3, 8, 4, 2, 16, 8
    n_pages = b * mp
    q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dtype)
    pools = []
    for _ in range(2):
        flat = torch.randn(n_pages * ps * kv * d + 1, generator=g,
                           device=dev).to(dtype)
        pools.append(flat[1:].view(n_pages, ps, kv, d))
    kp, vp = pools
    assert kp.data_ptr() % 16 and vp.data_ptr() % 16
    pt = torch.randperm(n_pages, generator=g, device=dev).reshape(
        b, mp).to(torch.int32)
    lengths = torch.tensor([0, 37, 128], device=dev)
    q_start = (lengths - sq).clamp_min(0)
    o = flash_attention_paged(q, kp, vp, pt, lengths, q_start)
    want = flash_attention_paged_plain(q, kp, vp, pt, lengths, q_start)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    assert torch.count_nonzero(o[0]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv", [(8, 8), (8, 2)])
def test_paged_kernel_row_invariant(dev, dtype, h, kv):
    """A row's bits do not depend on the call it sits in: sequence 0's rows
    inside a 64-row chunk at B 4 equal the same rows in a chunk of 7, each
    row alone as a decode step (Sq 1, lengths = q_pos + 1), and the chunk
    at B 1. Sequence 0's keys span two of the four 64-key splits (lengths
    100 of 256), so its decode rows see one or two live splits."""
    g = torch.Generator(device=dev).manual_seed(4)
    b, d, ps, mp = 4, 64, 16, 16
    n_pages = b * mp
    q = torch.randn((b, h, 64, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((n_pages, ps, kv, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((n_pages, ps, kv, d), generator=g, device=dev).to(dtype)
    pt = torch.randperm(n_pages, generator=g, device=dev).reshape(
        b, mp).to(torch.int32)
    q_start = torch.tensor([36, 10, 150, 0], device=dev)
    chunk = flash_attention_paged(q, kp, vp, pt, q_start + 64, q_start)
    alone = flash_attention_paged(q[:1], kp, vp, pt[:1], q_start[:1] + 64,
                                  q_start[:1])
    assert torch.equal(alone[0], chunk[0])
    lo = 20
    seven = flash_attention_paged(q[:, :, lo:lo + 7].contiguous(), kp, vp,
                                  pt, q_start + lo + 7, q_start + lo)
    assert torch.equal(seven[0], chunk[0, :, lo:lo + 7])
    for s in (0, 27, 28, 63):
        pos = q_start + s
        one = flash_attention_paged(q[:, :, s:s + 1].contiguous(), kp, vp,
                                    pt, pos + 1, pos)
        assert torch.equal(one[0, :, 0], chunk[0, :, s]), s
    torch.cuda.synchronize()


def test_launch_counters_count_kernel_launches(dev):
    a, b = _operands(4, 64, 64, torch.bfloat16, dev)
    compat.reset_counters()
    ops.matmul(a, b, algo="fip")
    ops.matmul(a, b, algo="baseline")
    assert compat.launch_counts()["fip_gemm"] == 1
    assert compat.launch_counts()["baseline_gemm"] == 1
    ops.matmul(a.cpu(), b.cpu(), algo="fip")
    assert compat.launch_counts()["fip_gemm"] == 1


# (label, batch, h, w, cin, cout, kh, kw, stride, pad, groups): ResNet-50
# and AlexNet convs at their published widths
CONV_CASES = [
    ("resnet conv1", 1, 224, 224, 3, 64, 7, 7, 2, 3, 1),
    ("resnet s2b1.c2", 2, 56, 56, 64, 64, 3, 3, 1, 1, 1),
    ("resnet s5b3.c3", 2, 7, 7, 512, 2048, 1, 1, 1, 0, 1),
    ("alexnet conv2", 2, 27, 27, 96, 256, 5, 5, 1, 2, 2),
]


def _conv_operands(b, h, w, cin, cout, kh, kw, groups, dtype, dev, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.int8:
        x = torch.randint(-128, 128, (b, h, w, cin), generator=g, device=dev)
        k = torch.randint(-128, 128, (kh, kw, cin // groups, cout),
                          generator=g, device=dev)
        return x.to(torch.int8), k.to(torch.int8)
    x = torch.randn((b, h, w, cin), generator=g, device=dev)
    k = torch.randn((kh, kw, cin // groups, cout), generator=g, device=dev)
    return x, k / (kh * kw * cin // groups) ** 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv_kernel_matches_plain(dev, case, dtype):
    _, b, h, w, cin, cout, kh, kw, stride, pad, groups = case
    x, kern = _conv_operands(b, h, w, cin, cout, kh, kw, groups, dtype, dev)
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    stack = conv_gemm._kernel_to_stack(kern, groups)
    geom = conv_gemm.ConvGeom(h=h + 2 * pad, w=w + 2 * pad, cin=cin, kh=kh,
                              kw=kw, sh=stride, sw=stride, groups=groups,
                              ng=cout // groups)
    for algo in ("baseline", "fip", "ffip"):
        fold = dtype == torch.int8 and algo != "baseline"
        bg = {"baseline": stack, "fip": conv_gemm._evenize_k(stack),
              "ffip": conv_gemm._y_even(stack)}[algo]
        bm, bn, bk = conv_gemm.conv_blocks(b * geom.m, cout // groups,
                                           bg.shape[1], algo, groups)
        got = conv_gemm.fused_conv_raw(xp, stack, kh=kh, kw=kw,
                                       stride=stride, groups=groups,
                                       algo=algo, fold_beta=fold)
        want = conv_gemm.fused_conv_plain(xp, bg, geom, algo=algo, bm=bm,
                                          bn=bn, bk=bk, fold_beta=fold)
        torch.cuda.synchronize()
        _compare(got, want, dtype, geom.k)


def _cudnn_tf32_flags():
    cudnn = torch.backends.cudnn
    conv = getattr(cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        return (conv.fp32_precision, cudnn.rnn.fp32_precision,
                cudnn.allow_tf32)
    return (cudnn.allow_tf32,)


def test_baseline_conv_is_ieee_f32_under_default_flags(dev):
    """The baseline conv of the torch provider (``vision.layers._nchw_conv``,
    ``F.conv2d``) runs in IEEE f32 on the card under PyTorch's default
    flags, which let cuDNN run an f32 conv in TF32 (ROADMAP queue 3, F7):
    ResNet-50 s2b1.c2's geometry at batch 2 (3x3, 64 -> 64 channels, 56 x
    56, K 576) on unit-normal data, as the reference's GEMM tests draw
    theirs, within their f32 bar of the host's conv. TF32's 10-bit
    mantissa misses that bar there by several times. The caller's flags
    are the same after the call."""
    from repro_torch.core.gemm import GemmConfig, use_gemm
    from repro_torch.vision import layers as vl
    before = _cudnn_tf32_flags()
    assert before in (("tf32", "tf32", True), (True,)), before  # defaults
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 56, 56, 64), generator=g)
    p = {"w": torch.randn((3, 3, 64, 64), generator=g)}
    with torch.no_grad(), use_gemm(GemmConfig(algo="baseline",
                                              impl="torch")):
        want = vl.conv2d(x, p, pad=1)
        got = vl.conv2d(x.to(dev), {"w": p["w"].to(dev)}, pad=1)
    torch.cuda.synchronize()
    assert _cudnn_tf32_flags() == before
    _compare(got, want, torch.float32, 3 * 3 * 64)


@pytest.mark.parametrize("algo", ["baseline", "fip", "ffip"])
def test_conv_kernel_equals_gemm_on_materialised_a(dev, algo):
    """K7 sums what K1, K2 and K3 sum over the materialised A, in the same
    nesting, at K 162 (f32, two groups): the baseline on f32 K1's CUDA-core
    body, FIP and FFIP on K2's and K3's pair body with the conv loader (K3's
    carry table of each group's y, K2's and K3's split plan). So f32 is bit
    for bit for all three, and so is int8 FFIP (integer sums are exact in
    any nesting)."""
    x, kern = _conv_operands(2, 14, 14, 36, 72, 3, 3, 2, torch.float32, dev)
    got = conv_gemm.conv_gemm_fused(x, kern, stride=1, pad=1, groups=2,
                                    algo=algo)
    ref = conv2d_via_gemm(x, kern, stride=1, pad=1, groups=2,
                          gemm_fn=lambda a, b: ops.matmul(a, b, algo=algo))
    torch.cuda.synchronize()
    assert torch.equal(got, ref), float((got - ref).abs().max())
    if algo == "ffip":
        x, kern = _conv_operands(2, 14, 14, 36, 72, 3, 3, 2, torch.int8,
                                 dev)
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        got = conv_gemm.fused_conv_raw(xp, conv_gemm._kernel_to_stack(
            kern, 2), kh=3, kw=3, groups=2, algo=algo)
        ref = conv2d_via_gemm(x, kern, stride=1, pad=1, groups=2,
                              gemm_fn=lambda a, b: ops.matmul(a, b,
                                                              algo=algo))
        torch.cuda.synchronize()
        assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_conv_fip_equals_gemm_past_one_split(dev, dtype):
    """K7's FIP against K2 over the materialised A at K 648, over one
    512-row split of K2's plan: K7 takes K2's split plan, so both add the
    same two split totals in order; bit for bit in f32 and int8."""
    x, kern = _conv_operands(2, 14, 14, 72, 72, 3, 3, 1, dtype, dev)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    got = conv_gemm.fused_conv_raw(xp, conv_gemm._kernel_to_stack(kern, 1),
                                   kh=3, kw=3, groups=1, algo="fip")
    ref = conv2d_via_gemm(x, kern, stride=1, pad=1, groups=1,
                          gemm_fn=lambda a, b: ops.matmul(a, b, algo="fip"))
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m_full,k,n,ms", [
    (512, 2304, 5760, (4, 64, 256)), (512, 5760, 2304, (4, 64, 256)),
    (128, 4096, 16384, (1, 4, 16))])
def test_gemm_batch_invariant(dev, m_full, k, n, ms, dtype):
    """Rows 0-3 of a full call equal the same rows at smaller M, across the
    tile geometries and launches each M takes (falcon-mamba-7b's in_proj at
    M 128 runs the wide tiles with no partials; M 1-16 the decode tiles,
    one split a CTA)."""
    a, b = _operands(m_full, k, n, dtype, dev, seed=7)
    y = y_for(b)

    def blocks(m, algo):
        return dict(zip(("bm", "bn", "bk"), ops.choose_blocks(m, n, k,
                                                              algo, dtype)))
    kernels = {"baseline": lambda a_: baseline_gemm(
                   a_, b, **blocks(len(a_), "baseline")),
               "fip": lambda a_: fip_gemm(a_, b, **blocks(len(a_), "fip")),
               "ffip": lambda a_: ffip_gemm_y(a_, y,
                                              **blocks(len(a_), "ffip"))}
    for name, fn in kernels.items():
        full = fn(a)[:4]
        for m in ms:
            part = fn(a[:m].contiguous())[:4]
            assert torch.equal(part[:min(m, 4)], full[:min(m, 4)]), (name, m)


@pytest.mark.parametrize("m", [4, 130])
def test_gemm_loaders_agree_bit_for_bit(dev, m):
    """K1 bf16 fills its tiles by TMA where A's and B's rows are 16-byte
    aligned and by cp.async where they are not; both feed the same mma
    chain, so a misaligned copy of A gives the aligned call's bits."""
    a, b = _operands(m, 2304, 5760, torch.bfloat16, dev, seed=9)
    bm, bn, bk = ops.choose_blocks(m, 5760, 2304, "baseline", torch.bfloat16)
    shifted = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)[1:]
    shifted = shifted.view(a.shape).copy_(a)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(baseline_gemm(shifted, b, bm=bm, bn=bn, bk=bk),
                       baseline_gemm(a, b, bm=bm, bn=bn, bk=bk))


def test_conv_batch_invariant(dev):
    """Image 0 of a batch-8 K7 call equals the batch-1 call (s2b1.c2)."""
    x, kern = _conv_operands(8, 56, 56, 64, 64, 3, 3, 1, torch.float32, dev)
    for algo in ("baseline", "fip", "ffip"):
        full = conv_gemm.conv_gemm_fused(x, kern, pad=1, algo=algo)[:1]
        one = conv_gemm.conv_gemm_fused(x[:1].contiguous(), kern, pad=1,
                                        algo=algo)
        assert torch.equal(full, one), algo


def _scan_operands(bt, s, di, n, dtype, dev, seed=11, h0_scale=0.1):
    """Mamba1's distributions: softplus dt, A = -exp(normal * 0.3)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    x = rnd(bt, s, di).to(dtype)
    dt = torch.nn.functional.softplus(rnd(bt, s, di) - 1).to(dtype)
    b, c = rnd(bt, s, n).to(dtype), rnd(bt, s, n).to(dtype)
    a = -torch.exp(rnd(di, n) * 0.3)
    h0 = rnd(bt, di, n) * h0_scale
    return x, dt, b, c, a, h0


def _bf16_ulp(w):
    """The spacing of bf16 numbers at each value of ``w`` (8 significant
    bits: 2**(e - 7) for |w| in [2**e, 2**(e + 1)))."""
    _, e = torch.frexp(w.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(w, dtype=torch.float32), e - 8)


def _scan_close(got, want):
    y, h, starts = got
    y_ref, h_ref, starts_ref = want
    if y.dtype == torch.bfloat16:
        ulps = (y.float() - y_ref.float()).abs() / _bf16_ulp(y_ref)
        assert float(ulps.max()) <= 1.0, float(ulps.max())
    else:
        np.testing.assert_allclose(y.cpu().numpy(), y_ref.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)
    for a_, b_ in ((h, h_ref), (starts, starts_ref)):
        np.testing.assert_allclose(a_.cpu().numpy(), b_.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bt,s,di,n,chunk,h0_scale", [
    (1, 128, 8192, 16, 128, 0.0),     # falcon prefill, fresh state
    (2, 256, 8192, 16, 128, 0.1),     # two chunks, a running state
    (2, 32, 16, 8, 8, 0.1),           # the reference test's shapes
    (1, 40, 100, 4, 8, 0.1),          # ragged channel block, N 4
])
def test_selective_scan_matches_plain(dev, dtype, bt, s, di, n, chunk,
                                      h0_scale):
    args = _scan_operands(bt, s, di, n, dtype, dev, h0_scale=h0_scale)
    got = selective_scan(*args, chunk=chunk)
    want = selective_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert got[2].shape == (bt, s // chunk, di, n)
    _scan_close(got, want)


@pytest.mark.parametrize("bt,s,di,n,chunk,dtype", [
    *[(1, s, 8192, 16, 128, dt) for s in (17, 33, 64, 112, 128)
      for dt in (torch.bfloat16, torch.float32)],
    *[(1, 128, 8192, n, 128, torch.bfloat16) for n in (4, 8, 32, 64)],
    (1, 128, 100, 16, 128, torch.bfloat16),   # ragged di: unaligned rows
    (1, 112, 100, 16, 128, torch.float32),
    (2, 256, 8192, 16, 128, torch.bfloat16),  # two states a thread
    (2, 40, 96, 8, 8, torch.bfloat16),        # chunk 8: checkpoints in-loop
])
def test_selective_scan_bit_for_bit(dev, bt, s, di, n, chunk, dtype):
    """K6's y, h_final and h_starts equal the plain version's bit for bit:
    the same rounded products and sums, y's in _sum_states's order."""
    args = _scan_operands(bt, s, di, n, dtype, dev, seed=s + n)
    got = selective_scan(*args, chunk=chunk)
    want = selective_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w), float((g.float() - w.float()).abs().max())


@pytest.mark.parametrize("bt,di,n", [(1, 8192, 16), (2, 8192, 16),
                                     (1, 8192, 4), (1, 8192, 8),
                                     (1, 8192, 32), (1, 8192, 64),
                                     (1, 100, 16), (4, 8192, 16)])
def test_selective_scan_kernel_takes_its_plan(dev, bt, di, n):
    """The plan the kernel launches with is scan_plan's."""
    from repro_torch.kernels.selective_scan import kernel_plan, scan_plan
    plan = scan_plan(bt, di, n)
    assert kernel_plan(bt, di, n) == (plan.states, plan.lanes,
                                      plan.channels, plan.grid[0])


def test_selective_scan_state_carries_across_calls(dev):
    """Two calls, the second from the first's h_final, equal one call."""
    x, dt, b, c, a, h0 = _scan_operands(1, 256, 8192, 16, torch.bfloat16,
                                        dev)
    y, h, starts = selective_scan(x, dt, b, c, a, h0)
    y1, h1, s1 = selective_scan(x[:, :128].contiguous(),
                                dt[:, :128].contiguous(),
                                b[:, :128].contiguous(),
                                c[:, :128].contiguous(), a, h0)
    y2, h2, s2 = selective_scan(x[:, 128:].contiguous(),
                                dt[:, 128:].contiguous(),
                                b[:, 128:].contiguous(),
                                c[:, 128:].contiguous(), a, h1)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([y1, y2], 1), y)
    assert torch.equal(h2, h)
    assert torch.equal(torch.cat([s1, s2], 1), starts)


def test_selective_scan_counts_and_refuses(dev):
    args = _scan_operands(1, 16, 64, 16, torch.bfloat16, dev)
    compat.reset_counters()
    selective_scan(*args)
    assert compat.launch_counts()["selective_scan"] == 1
    selective_scan(*(t.cpu() for t in args))
    assert compat.launch_counts()["selective_scan"] == 1
    x, dt, b, c, a, h0 = args
    with pytest.raises(ValueError):
        selective_scan(x, dt, b[..., :12].contiguous(),
                       c[..., :12].contiguous(), a[:, :12].contiguous(),
                       h0[..., :12].contiguous())


# --- training: K8 (flash backward) and K9 (selective-scan backward) ----------

def _bf16_cast_ulps(got, want, atol):
    """bf16 ulps by which the casts of ``got`` and ``want`` differ beyond
    the f32 bar's ``atol``: a value that cancels to near 0 (dq of a row that
    keeps one key: dp - delta) is noise at that floor in either type."""
    g, w = got.to(torch.bfloat16).float(), want.to(torch.bfloat16)
    excess = ((g - w.float()).abs() - atol).clamp_min(0)
    return float((excess / _bf16_ulp(w)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,d,window,causal", [
    (2, 96, 32, 0, True),          # the CPU tests' shape, a ragged block
    (2, 96, 32, 32, True),
    (2, 64, 32, 0, False),
    (144, 256, 64, 0, True),       # minicpm-2b at training batch 4
    (8, 200, 128, 32, True),       # d 128, a ragged block and a window
    (8, 256, 128, 0, True),
    (8, 200, 64, 32, True),
])
def test_flash_bwd_kernel_matches_plain(dev, dtype, bh, s, d, window,
                                        causal):
    """K8's f32 dq/dk/dv within rtol 1e-4, atol 1e-4 * max|plain| (the same
    products summed in another block order), and once cast to bf16 within
    one bf16 ulp beyond that atol."""
    from repro_torch.kernels.flash_attention import (_flash_bwd,
                                                     _flash_bwd_plain)
    g = torch.Generator(device=dev).manual_seed(21)
    q, k, v, do = (torch.randn((bh, s, d), generator=g, device=dev).to(dtype)
                   for _ in range(4))
    o, lse = _flash_fwd(q, k, v, window, causal=causal)
    got = _flash_bwd(q, k, v, o, lse, do, window, causal=causal)
    want = _flash_bwd_plain(q, k, v, o, lse, do, window, causal=causal)
    torch.cuda.synchronize()
    for a_, b_ in zip(got, want):
        assert a_.dtype == torch.float32
        atol = 1e-4 * float(b_.abs().max())
        np.testing.assert_allclose(a_.cpu().numpy(), b_.cpu().numpy(),
                                   rtol=1e-4, atol=atol)
        assert _bf16_cast_ulps(a_, b_, atol) <= 1.0


@pytest.mark.parametrize("bt,s,di,n,chunk", [
    (2, 32, 16, 8, 8),             # the CPU tests' shape
    (1, 40, 100, 4, 8),            # ragged channel block, N 4
    (2, 256, 8192, 16, 128),       # falcon-mamba-7b at training batch 2
    (2, 64, 96, 32, 32),           # N 32: 4-step sub-tiles, two chunks
    (1, 48, 40, 64, 16),           # N 64: 2-step sub-tiles, ragged block
])
def test_selective_scan_bwd_kernel_matches_plain(dev, bt, s, di, n, chunk):
    """K9's dx, ddt, dB, dC and dA equal the plain f32 values bit for bit:
    both recompute h from K6's h_starts with K6's rounding and sum over N
    and over the channel blocks in the same orders."""
    from repro_torch.kernels.selective_scan import (selective_scan_bwd,
                                                    selective_scan_bwd_plain)
    x, dt, b, c, a, h0 = _scan_operands(bt, s, di, n, torch.float32, dev)
    _, _, starts = selective_scan(x, dt, b, c, a, h0, chunk=chunk)
    dy = torch.randn_like(x)
    got = selective_scan_bwd(x, dt, b, c, a, starts, dy, chunk=chunk)
    want = selective_scan_bwd_plain(x, dt, b, c, a, starts, dy, chunk=chunk)
    torch.cuda.synchronize()
    for name, a_, b_ in zip(("dx", "ddt", "dB", "dC", "dA"), got, want):
        assert torch.equal(a_, b_), name


def test_backward_functions_launch_k8_and_k9_once(dev):
    """One backward through each Function launches its backward kernel
    exactly once (and its forward kernel once, in the forward)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.selective_scan import selective_scan_trainable
    g = torch.Generator(device=dev).manual_seed(22)
    q, k, v = (torch.randn((4, 64, 32), generator=g, device=dev,
                           dtype=torch.bfloat16).requires_grad_(True)
               for _ in range(3))
    compat.reset_counters()
    flash_attention(q, k, v).float().sum().backward()
    torch.cuda.synchronize()
    counts = compat.launch_counts()
    assert (counts["flash_fwd"], counts["flash_bwd"]) == (1, 1)
    assert q.grad.dtype == torch.bfloat16 and q.grad.abs().sum() > 0
    args = [t.requires_grad_(True) for t in _scan_operands(
        2, 32, 64, 16, torch.bfloat16, dev)]
    compat.reset_counters()
    selective_scan_trainable(*args, 8, 64).float().sum().backward()
    torch.cuda.synchronize()
    counts = compat.launch_counts()
    assert (counts["selective_scan"], counts["selective_scan_bwd"]) == (1, 1)
    assert args[0].grad.dtype == torch.bfloat16
    assert not args[5].grad.any()


# --- MLA's widths: K4 and K8 at d 192 against dv 128 ------------------------

@pytest.mark.parametrize("bh,sq,causal", [
    (64, 16, True), (64, 128, True), (8, 77, True), (8, 512, True),
    (8, 100, False)])
def test_flash_kernel_mla_widths_match_plain(dev, bh, sq, causal):
    """K4's (192, 128) instantiation (deepseek-v2-lite-16b's prefill, bf16)
    against its plain version: o within one bf16 rounding, lse 2e-3."""
    g = torch.Generator(device=dev).manual_seed(31)
    q, k = (torch.randn((bh, sq, 192), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    v = torch.randn((bh, sq, 128), generator=g, device=dev).to(torch.bfloat16)
    o, lse = _flash_fwd(q, k, v, 0, causal=causal)
    o_ref, lse_ref = _flash_fwd_plain(q, k, v, 0, causal=causal)
    torch.cuda.synchronize()
    assert o.shape == (bh, sq, 128)
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               o_ref.float().cpu().numpy(), rtol=2 ** -7,
                               atol=2 ** -7)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("bh,s,causal", [(32, 256, True), (4, 200, True),
                                         (4, 96, False)])
def test_flash_bwd_kernel_mla_widths_match_plain(dev, bh, s, causal):
    """K8's (192, 128) instantiation (deepseek-v2-lite-16b's training, bf16):
    dq, dk (width 192) and dv (width 128) under K8's bars."""
    from repro_torch.kernels.flash_attention import (_flash_bwd,
                                                     _flash_bwd_plain)
    g = torch.Generator(device=dev).manual_seed(32)
    q, k = (torch.randn((bh, s, 192), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    v, do = (torch.randn((bh, s, 128), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    o, lse = _flash_fwd(q, k, v, 0, causal=causal)
    got = _flash_bwd(q, k, v, o, lse, do, 0, causal=causal)
    want = _flash_bwd_plain(q, k, v, o, lse, do, 0, causal=causal)
    torch.cuda.synchronize()
    assert [tuple(t.shape) for t in got] == [(bh, s, 192), (bh, s, 192),
                                            (bh, s, 128)]
    for a_, b_ in zip(got, want):
        atol = 1e-4 * float(b_.abs().max())
        np.testing.assert_allclose(a_.cpu().numpy(), b_.cpu().numpy(),
                                   rtol=1e-4, atol=atol)
        assert _bf16_cast_ulps(a_, b_, atol) <= 1.0


# --- gemma3's widths: K4 and K8 at (256, 256), K5's (256, 256) body --------

@pytest.mark.parametrize("bh,sq,window,causal,d", [
    (8, 128, 0, True, 256), (8, 2048, 1024, True, 256),
    (8, 200, 8, True, 256), (8, 77, 0, False, 256),
    (16, 100, 1024, True, 256), (4, 96, 0, True, 200)])
def test_flash_kernel_gemma3_widths_match_plain(dev, bh, sq, window, causal,
                                                d):
    """K4's (256, 256) instantiation (gemma3-4b's prefill, bf16: a local
    layer's window of 1024, a global layer's 0, a small window and a
    narrower d zero-padded to it) against its plain version: o within one
    bf16 rounding, lse 2e-3."""
    g = torch.Generator(device=dev).manual_seed(41)
    q, k, v = (torch.randn((bh, sq, d), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    compat.reset_counters()
    o, lse = _flash_fwd(q, k, v, window, causal=causal)
    assert compat.launch_counts()["flash_fwd"] == 1
    o_ref, lse_ref = _flash_fwd_plain(q, k, v, window, causal=causal)
    torch.cuda.synchronize()
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               o_ref.float().cpu().numpy(), rtol=2 ** -7,
                               atol=2 ** -7)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("bh,s,window,causal", [
    (8, 256, 0, True), (4, 200, 8, True), (2, 1100, 1024, True),
    (2, 96, 0, False)])
def test_flash_bwd_kernel_gemma3_widths_match_plain(dev, bh, s, window,
                                                    causal):
    """K8's (256, 256) passes (gemma3-4b's training, bf16; two CTAs a block,
    each half of the output columns) under K8's bars, windows 0, 8 and
    1024."""
    from repro_torch.kernels.flash_attention import (_flash_bwd,
                                                     _flash_bwd_plain)
    g = torch.Generator(device=dev).manual_seed(42)
    q, k, v, do = (torch.randn((bh, s, 256), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(4))
    o, lse = _flash_fwd(q, k, v, window, causal=causal)
    got = _flash_bwd(q, k, v, o, lse, do, window, causal=causal)
    want = _flash_bwd_plain(q, k, v, o, lse, do, window, causal=causal)
    torch.cuda.synchronize()
    for a_, b_ in zip(got, want):
        assert a_.shape == (bh, s, 256)
        atol = 1e-4 * float(b_.abs().max())
        np.testing.assert_allclose(a_.cpu().numpy(), b_.cpu().numpy(),
                                   rtol=1e-4, atol=atol)
        assert _bf16_cast_ulps(a_, b_, atol) <= 1.0


@pytest.mark.parametrize("h,kv,sq,d,window", [
    (8, 4, 1, 256, 1024),       # gemma3-4b decode, a local layer
    (8, 4, 4, 256, 0),          # a global layer, decode chunk 4
    (8, 4, 64, 256, 1024),      # a 64-row prefill chunk past the window
    (48, 8, 1, 128, 4096),      # mixtral-8x22b, GQA ratio 6
    (24, 2, 64, 128, 0),        # starcoder2-3b, GQA ratio 12
    (56, 8, 4, 128, 0)])        # deepseek-coder-33b, GQA ratio 7
def test_paged_kernel_family_widths_match_plain(dev, h, kv, sq, d, window):
    """K5 at the new families' shapes in bf16: gemma3's (256, 256) body
    with contexts past its window of 1024, and the (128, 128) body at the
    GQA ratios 6, 12 and 7, against the plain version; a sequence of length
    0 gives exact zeros."""
    g = torch.Generator(device=dev).manual_seed(43)
    b, ps, mp = 3, 16, 96 if window != 4096 else 288
    n_pages = b * mp + 2
    dt = torch.bfloat16
    q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dt)
    kp = torch.randn((n_pages, ps, kv, d), generator=g, device=dev).to(dt)
    vp = torch.randn((n_pages, ps, kv, d), generator=g, device=dev).to(dt)
    pt = torch.randperm(n_pages, generator=g, device=dev)[:b * mp]
    pt = pt.reshape(b, mp).to(torch.int32)
    lengths = torch.tensor([0, ps * mp - 37, window + 300 if window else 700],
                           device=dev)
    q_start = (lengths - sq).clamp_min(0)
    compat.reset_counters()
    o = flash_attention_paged(q, kp, vp, pt, lengths, q_start, window)
    assert compat.launch_counts()["flash_paged"] == 1
    want = flash_attention_paged_plain(q, kp, vp, pt, lengths, q_start,
                                       window)
    torch.cuda.synchronize()
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2 ** -7,
                               atol=2 ** -7)
    assert torch.count_nonzero(o[0]) == 0


def test_flash_kernels_refuse_past_gemma3_widths(dev):
    """bf16 d 320 and f32 d 256 raise naming ROADMAP queue 2 section A and
    launch nothing: never a fallback to the plain version."""
    from repro_torch.kernels.flash_attention import _flash_bwd
    compat.reset_counters()
    for w, dt in ((320, torch.bfloat16), (256, torch.float32)):
        x = torch.zeros((2, 16, w), device=dev, dtype=dt)
        lse = torch.zeros((2, 16), device=dev)
        with pytest.raises(ValueError, match="queue 2 section A"):
            _flash_fwd(x, x, x)
        with pytest.raises(ValueError, match="queue 2 section A"):
            _flash_bwd(x, x, x, x, lse, x)
    counts = compat.launch_counts()
    assert (counts["flash_fwd"], counts["flash_bwd"]) == (0, 0)


@pytest.mark.parametrize("d,dv", [(192, 128), (64, 32), (136, 136)])
def test_flash_f32_kernels_refuse_past_their_widths(dev, d, dv):
    """The f32 kernels take d <= 128 and dv == d: wider f32 operands raise
    (naming ROADMAP queue 2 section A) and launch nothing."""
    from repro_torch.kernels.flash_attention import _flash_bwd
    q = torch.zeros((2, 16, d), device=dev)
    v = torch.zeros((2, 16, dv), device=dev)
    lse = torch.zeros((2, 16), device=dev)
    compat.reset_counters()
    with pytest.raises(ValueError, match="queue 2 section A"):
        _flash_fwd(q, q, v)
    with pytest.raises(ValueError, match="queue 2 section A"):
        _flash_bwd(q, q, v, v, lse, v)
    counts = compat.launch_counts()
    assert (counts["flash_fwd"], counts["flash_bwd"]) == (0, 0)


@pytest.mark.parametrize("paged", [False, True])
def test_deepseek_smoke_serve_through_kernels(dev, paged):
    """The deepseek-v2-lite-16b smoke model in bf16, served on the card
    through ``gemm_impl="cuda"`` (K3 for the projections and routers, K4 at
    its MLA widths for contiguous prefill, K5 for paged attention), gives
    the tokens of the same server on the host, where every kernel wrapper
    runs its plain version."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(configs.smoke_config(configs.get_config(
        "deepseek-v2-lite-16b")), param_dtype="bfloat16")
    prompts = make_prompts(cfg.vocab, 6, np.random.default_rng(3), 3, 40,
                           shared_prefix=16 if paged else 0)
    kw = dict(max_new=6, batch_slots=2, max_len=64, gemm_algo="ffip",
              gemm_impl="cuda")
    if paged:
        kw.update(paged=True, page_size=16, prefill_chunk=32,
                  paged_attention="flash", decode_chunk=4)
    host = Model(cfg, device="cpu")
    host_params = host.init(0)
    _, want, _ = serve(host, host_params, prompts, **kw)
    compat.reset_counters()
    _, got, _ = serve(Model(cfg, device=dev), _to(host_params, dev), prompts,
                      **kw)
    counts = compat.launch_counts()
    assert ({r.rid: list(r.out_tokens) for r in got}
            == {r.rid: list(r.out_tokens) for r in want})
    assert counts["ffip_gemm_y"] > 0
    attn = "flash_paged" if paged else "flash_fwd"
    assert counts[attn] > 0
    assert counts["flash_paged" if not paged else "flash_fwd"] == 0


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# --- zamba2-1.2b: Mamba2 groups and one shared attention block ---------------

def _zamba2_smoke(dtype="bfloat16"):
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.smoke_config(configs.get_config(
        "zamba2-1.2b")), param_dtype=dtype)


@pytest.mark.parametrize("quantized", [False, True])
def test_zamba2_smoke_serve_through_kernels(dev, quantized):
    """The zamba2 smoke model (2 groups of 2 Mamba2 layers, each followed by
    the shared attention block, then a tail of 1), served on the card
    through ``gemm_impl="cuda"`` (K3 for every projection, K4 for the
    shared block's prompt: once per group and scatter prefill, never at
    decode), gives the tokens of the same server on the host, where every
    kernel wrapper runs its plain version; float and int8 FFIP, in bf16.
    The int8 case ran in f32 until ROADMAP queue 3's F6 was repaired: the
    per-token activation scale ``(xmax - xmin) / 255`` took PyTorch's CUDA
    path for a Python-number divisor (a multiply by the reciprocal), one
    f32 ulp off the host's quotient on some rows, which moved int8 codes
    from the first dense call on and served tokens 2-4 steps in
    (``tools/int8_probe.py``; ``core.quant.range_div`` divides on both
    devices alike)."""
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import Model
    cfg = _zamba2_smoke()
    n_groups = cfg.n_layers // cfg.hybrid_attn_period
    # one chunk of the smoke chunk 8 up to 15 tokens: the chunk contract
    prompts = make_prompts(cfg.vocab, 6, np.random.default_rng(5), 3, 16)
    kw = dict(max_new=6, batch_slots=2, max_len=32, gemm_algo="ffip",
              gemm_impl="cuda", quantized=quantized, decode_chunk=4)
    host = Model(cfg, device="cpu")
    host_params = host.init(0)
    _, want, _ = serve(host, host_params, prompts, **kw)
    compat.reset_counters()
    srv, got, _ = serve(Model(cfg, device=dev), _to(host_params, dev),
                        prompts, **kw)
    counts = compat.launch_counts()
    assert ({r.rid: list(r.out_tokens) for r in got}
            == {r.rid: list(r.out_tokens) for r in want})
    assert srv.stats["prefill_dispatches"] == len(prompts)
    assert counts["ffip_gemm_y"] > 0
    assert counts["flash_fwd"] == n_groups * len(prompts)
    for name in ("flash_paged", "flash_bwd", "selective_scan", "conv_gemm"):
        assert counts[name] == 0


def test_zamba2_smoke_train_step_launches_k4_and_k8_per_group(dev):
    """One training step's loss and gradients of the zamba2 smoke model on
    the card: K4 and K8 once per group (the shared block's gradients summed
    over its uses), no GEMM kernel (training runs torch.matmul), the loss
    that of the host's plain path and every gradient finite."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    cfg = _zamba2_smoke()
    n_groups = cfg.n_layers // cfg.hybrid_attn_period
    host = Model(cfg, device="cpu")
    params = host.init(0)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(DataConfig(
        global_batch=2, seq_len=32, vocab=cfg.vocab,
        seed=0)).batch_at(0).items()}
    with torch.no_grad():
        want = float(host.loss(params, batch))
    card = Model(cfg, device=dev)
    p = adamw.tree_map(lambda t: t.to(dev).requires_grad_(True), params)
    compat.reset_counters()
    loss = card.loss(p, {k: v.to(dev) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, adamw.tree_leaves(p))
    torch.cuda.synchronize()
    counts = compat.launch_counts()
    assert (counts["flash_fwd"], counts["flash_bwd"]) == (n_groups, n_groups)
    for name in ("baseline_gemm", "fip_gemm", "ffip_gemm_y"):
        assert counts[name] == 0
    assert all(torch.isfinite(g).all() for g in grads)
    assert abs(float(loss) - want) <= 1e-2 * abs(want)
    shared = p["shared_attn"]["attn"]["wq"]["w"]
    assert next(g for t, g in zip(adamw.tree_leaves(p), grads)
                if t is shared).abs().sum() > 0


# --- whisper-small's encoder and pixtral-12b's prefix ----------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,d,causal", [
    (12, 1500, 64, False),      # whisper-small's encoder: 1500 = 11 x 128 + 92
    (4, 1500, 64, True),        # the same ragged S under the causal mask
    (32, 384, 128, True),       # pixtral-12b's prefill: 256 patches + 128
    (8, 93, 64, False)])        # one ragged block each way
def test_flash_kernel_encdec_widths_match_plain(dev, dtype, bh, sq, d,
                                                causal):
    """K4 non-causal at whisper-small's ragged S 1500, where only the k_pos
    < Sk test hides the last key block's padded keys (no causal mask lies
    above them), and at pixtral-12b's d 128 prefill of a 256-patch prefix
    and a 128-token prompt, against its plain version under the flash bars:
    o within one bf16 rounding (2e-3 in f32), lse 2e-3."""
    g = torch.Generator(device=dev).manual_seed(51)
    q, k, v = (torch.randn((bh, sq, d), generator=g, device=dev).to(dtype)
               for _ in range(3))
    compat.reset_counters()
    o, lse = _flash_fwd(q, k, v, 0, causal=causal)
    assert compat.launch_counts()["flash_fwd"] == 1
    o_ref, lse_ref = _flash_fwd_plain(q, k, v, 0, causal=causal)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               o_ref.float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,causal", [(4, 1500, False), (2, 1500, True),
                                         (4, 93, False)])
def test_flash_bwd_kernel_encdec_widths_match_plain(dev, dtype, bh, s,
                                                    causal):
    """K8 non-causal at whisper-small's ragged S 1500 (its encoder trained,
    d 64) under K8's bars: f32 dq/dk/dv rtol 1e-4, atol 1e-4 * max|plain|,
    and once cast to bf16 one ulp beyond that atol."""
    from repro_torch.kernels.flash_attention import (_flash_bwd,
                                                     _flash_bwd_plain)
    g = torch.Generator(device=dev).manual_seed(52)
    q, k, v, do = (torch.randn((bh, s, 64), generator=g, device=dev).to(
        dtype) for _ in range(4))
    o, lse = _flash_fwd(q, k, v, 0, causal=causal)
    compat.reset_counters()
    got = _flash_bwd(q, k, v, o, lse, do, 0, causal=causal)
    assert compat.launch_counts()["flash_bwd"] == 1
    want = _flash_bwd_plain(q, k, v, o, lse, do, 0, causal=causal)
    torch.cuda.synchronize()
    for a_, b_ in zip(got, want):
        atol = 1e-4 * float(b_.abs().max())
        np.testing.assert_allclose(a_.cpu().numpy(), b_.cpu().numpy(),
                                   rtol=1e-4, atol=atol)
        assert _bf16_cast_ulps(a_, b_, atol) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq", [1, 4])
def test_paged_kernel_pixtral_widths_match_plain(dev, dtype, sq):
    """K5 at pixtral-12b's decode (H 32, KV 8: GQA 4, d 128) over contexts
    that count a 256-patch prefix, against its plain version; a sequence of
    length 0 gives exact zeros."""
    g = torch.Generator(device=dev).manual_seed(53)
    b, h, kv, d, ps, mp = 4, 32, 8, 128, 16, 32
    n_pages = b * mp + 2
    q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((n_pages, ps, kv, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((n_pages, ps, kv, d), generator=g, device=dev).to(dtype)
    pt = torch.randperm(n_pages, generator=g, device=dev)[:b * mp]
    pt = pt.reshape(b, mp).to(torch.int32)
    lengths = torch.tensor([0, 256 + 17, 256 + 128 + 16, ps * mp],
                           device=dev)
    q_start = (lengths - sq).clamp_min(0)
    compat.reset_counters()
    o = flash_attention_paged(q, kp, vp, pt, lengths, q_start, 0)
    assert compat.launch_counts()["flash_paged"] == 1
    want = flash_attention_paged_plain(q, kp, vp, pt, lengths, q_start, 0)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    assert torch.count_nonzero(o[0]) == 0


# --- repro_torch.obs and the router on the card ----------------------------

def test_matmul_in_graph_capture_counts_a_trace_not_a_dispatch(dev):
    """``obs.profile`` counts an eager ``ops.matmul`` on the card as a
    dispatch; the same call inside a CUDA graph capture runs its Python body
    once for every replay to come, so it counts as a trace (the reference's
    call under JAX tracing), and replays count nothing."""
    from repro_torch.obs import Registry
    from repro_torch.obs import profile as obs_profile
    prev = obs_profile.set_profiler(obs_profile.KernelProfiler(Registry()))
    on = obs_profile.enable(True)
    try:
        prof = obs_profile.get_profiler()
        a, b = _operands(16, 256, 384, torch.bfloat16, dev)
        lab = dict(kernel="gemm", algo="ffip", dtype="bfloat16")
        with torch.no_grad():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                want = ops.matmul(a, b, algo="ffip")     # eager, off capture
            torch.cuda.current_stream().wait_stream(side)
            assert prof.dispatches.labels(**lab).value == 1.0
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = ops.matmul(a, b, algo="ffip")
            for _ in range(3):
                graph.replay()
            torch.cuda.synchronize()
        assert prof.traces.labels(**lab).value == 1.0
        assert prof.dispatches.labels(**lab).value == 1.0
        assert torch.equal(got, want)
    finally:
        obs_profile.set_profiler(prev)
        obs_profile.enable(on)


def test_router_fault_case_on_card_matches_no_fault_oracle(dev):
    """One cell of the fault matrix on the card: the minicpm-2b smoke model
    in bf16, two float replicas through K3 and K4 under the ``raise`` plan
    of tests/test_serve_router.py, on a FakeClock. Every request ends DONE
    with the tokens of a no-fault single server on the card (K1-K3 are
    batch-invariant and greedy decode deterministic)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.serve import unplanned_failures
    from repro_torch.models.model import Model
    from repro_torch.obs import Registry
    from repro_torch.serve.batcher import BatchServer, Request
    from repro_torch.serve.faults import FakeClock, FaultPlan, FaultSpec
    from repro_torch.serve.router import ReplicaRouter, RouterConfig
    cfg = dataclasses.replace(configs.smoke_config(configs.get_config(
        "minicpm-2b")), param_dtype="bfloat16")
    model = Model(cfg, device=dev)
    params = model.init(0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(n,))
               for n in (3, 7, 5, 9, 4, 6)]
    kw = dict(batch_slots=2, max_len=48, gemm_algo="ffip", gemm_impl="cuda",
              device=dev, registry=Registry())

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=5, eos_id=-1)
                for i, p in enumerate(prompts)]

    solo = BatchServer(model, **kw)
    for r in reqs():
        solo.submit(r)
    want = {r.rid: list(r.out_tokens)
            for r in solo.run_until_drained(params)}
    plan = FaultPlan([FaultSpec(kind="raise", replica=0, at_dispatch=1,
                                duration=2)], seed=3)
    clock = FakeClock()
    compat.reset_counters()
    rt = ReplicaRouter([BatchServer(model, clock=clock, **kw)
                        for _ in range(2)], params, fault_plan=plan,
                       clock=clock, registry=kw["registry"],
                       cfg=RouterConfig(step_timeout_s=5.0, quarantine_s=0.2,
                                        max_retries=4))
    for r in reqs():
        rt.submit(r)
    rt.drive(max_ticks=2000)
    counts = compat.launch_counts()
    assert rt.outcome_counts() == {"done": len(prompts)}
    assert rt.stats["replica_failures"] >= 1
    assert unplanned_failures(rt.events) == []
    assert rt.completed_tokens() == want
    assert counts["ffip_gemm_y"] > 0 and counts["flash_fwd"] > 0


# --- the autotuner's space and prepared artifacts on the card ---------------

@pytest.mark.parametrize("algo,dtype", [("ffip", torch.bfloat16),
                                        ("fip", torch.int8),
                                        ("baseline", torch.float32),
                                        ("baseline", torch.bfloat16),
                                        ("ffip", torch.int8)])
def test_every_compiled_tile_equals_the_default(dev, algo, dtype,
                                               tmp_path):
    """Every tile ``repro_torch.tune.space`` may offer gives the static
    default's result bit for bit (ragged M, K and N, K past one split), and
    ``tune_gemm``'s own check agrees at the bucket shape."""
    from repro_torch import tune
    from repro_torch.tune import space
    a, b = _operands(300, 2304, 1000, dtype, dev)
    with torch.no_grad():
        want = ops.matmul(a, b, algo=algo)
        for bm, bn, bk in space.compiled_tiles(algo, dtype):
            got = ops.matmul(a, b, algo=algo, bm=bm, bn=bn, bk=bk)
            assert torch.equal(got, want), (bm, bn, bk)
    cache = tune.ScheduleCache(tmp_path / "schedules.json")
    entry = tune.tune_gemm(300, 1000, 2304, dtype, algo=algo, iters=1,
                           cache=cache, persist=False)
    assert entry["candidates"] == len(space.gemm_candidates(
        512, 1024, 4096, algo, dtype))


@pytest.mark.parametrize("algo,dtype", [("ffip", torch.float32),
                                        ("baseline", torch.int8)])
def test_every_conv_tile_equals_the_default(dev, algo, dtype):
    from repro_torch.tune import space
    x, kern = _conv_operands(2, 28, 28, 64, 64, 3, 3, 1, dtype, dev)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    stack = conv_gemm._kernel_to_stack(kern, 1)
    with torch.no_grad():
        want = conv_gemm.fused_conv_raw(xp, stack, kh=3, kw=3, algo=algo)
        for bm, bn, bk in space.compiled_conv_tiles(algo):
            got = conv_gemm.fused_conv_raw(xp, stack, kh=3, kw=3, algo=algo,
                                           bm=bm, bn=bn, bk=bk)
            assert torch.equal(got, want), (bm, bn, bk)


def test_prepared_server_derives_nothing_on_the_card(dev, tmp_path):
    """A ``repro_torch.prepare`` artifact of the minicpm-2b smoke model in
    bf16, int8 FFIP, written and loaded on the card (its carry tables built
    by the load), serves the unprepared server's tokens with
    ``recomputed == 0`` and launches no carry-table kernel while serving."""
    import dataclasses

    from repro_torch import configs, prepare
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(configs.smoke_config(configs.get_config(
        "minicpm-2b")), param_dtype="bfloat16")
    model = Model(cfg, device=dev)
    params = model.init(0)
    prompts = make_prompts(cfg.vocab, 6, np.random.default_rng(3), 3, 16)
    kw = dict(max_new=5, batch_slots=2, max_len=32, gemm_algo="ffip",
              gemm_impl="cuda", quantized=True)
    _, want, _ = serve(model, params, prompts, **kw)
    prepare.prepare_lm(params, quantized=True).save(tmp_path / "a")
    pm = prepare.load(tmp_path / "a")
    assert pm.built["carry"] > 0
    compat.reset_counters()
    _, got, _ = serve(model, None, prompts, prepared=pm, **kw)
    counts = compat.launch_counts()
    assert ({r.rid: r.out_tokens for r in got}
            == {r.rid: r.out_tokens for r in want})
    assert pm.recomputed == 0, pm.recompute_report()
    assert counts["ffip_carry_table"] == 0 and counts["ffip_gemm_y"] > 0


def test_tp_layers_equal_the_whole_layer_on_two_ranks(dev):
    """The tensor-parallel dense layers at minicpm-2b's widths on two ranks
    sharing the card (gloo on cuda:0 where there is one card): int8
    column- and row-parallel bit for bit, bf16 row-parallel within the f32
    GEMM bar, baseline, fip and ffip through the kernels
    (repro_torch.dist.parity)."""
    from repro_torch.dist import parity
    from repro_torch.launch import serve as launch_serve

    shapes = [(m, k, n) for m in (4, 512) for k, n in (
        (2304, 2304), (2304, 5760), (5760, 2304))]
    ranks = launch_serve.spawn_ranks(
        2, [(parity.layer_parity, dict(shapes=shapes, dtype="bf16"))],
        device="cuda", timeout_s=600)
    for (result,) in ranks:
        assert len(result) == len(shapes) * 3 * 3
        bad = {k: v for k, v in result.items() if not v["ok"]}
        assert not bad, bad


@pytest.mark.parametrize("rank", [0, 1])
def test_scan_on_a_rank_columns_equals_the_whole_scan(dev, rank):
    """K6 on one rank's half of falcon-mamba-7b's d_inner (8192 -> 4096 at
    tensor-parallel size 2) equals the whole K6's columns of y, h_final and
    h_starts bit for bit: every channel's recurrence reads its own channel
    alone (repro_torch.dist.parity.scan_columns, which needs only the
    rank's index)."""
    from repro_torch.dist import context as dctx
    from repro_torch.dist import parity

    mesh = dctx.Mesh((1, 2), ("data", "model"), rank=rank)
    result = parity.scan_columns(mesh, dev, di=8192, n=16,
                                 cases=[(1, 128), (2, 256), (1, 64)])
    assert len(result) == 3
    for label, rec in result.items():
        assert rec["ok"] and rec["max_abs_err"] == 0.0, (label, rec)


def test_frontend_entry_on_two_ranks_equals_one_card(dev):
    """whisper-small at its published widths and 2 + 2 layers, the frontend
    entry on two ranks sharing the card (repro_torch.dist.parity.
    frontend_run: the encoder through K4 non-causal on a rank's 6 heads
    over 1500 stub frames, the rank's cross K/V cached, then greedy decode
    steps): int8 FFIP gives one card's tokens (its products sum in int32
    and the cross attention keeps one card's batched shapes), float FFIP
    prefill logits within the float token bar (0.6 sd) of one card's; both
    ranks agree, and each launches K4 once a layer."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.dist import parity
    from repro_torch.launch import serve as launch_serve

    cfg = configs.get_config("whisper-small")
    cfg = dataclasses.replace(cfg, n_layers=2, encoder=dataclasses.replace(
        cfg.encoder, n_layers=2))
    kw = dict(cfg=cfg, rows=2, prompt=16, steps=4, seed=0)
    ranks = launch_serve.spawn_ranks(
        2, [(parity.frontend_run, dict(kw, quantized=q))
            for q in (False, True)], device="cuda", timeout_s=600)
    for i, quantized in enumerate((False, True)):
        single = parity.frontend_run(None, dev, quantized=quantized, **kw)
        r0, r1 = ranks[0][i], ranks[1][i]
        assert r1["tokens"] == r0["tokens"]
        assert r0["launches"]["flash_fwd"] == 4
        if quantized:
            assert r0["tokens"] == single["tokens"]
        else:
            ref = single["first"]
            assert float((r0["first"] - ref).abs().max() / ref.std()) < 0.6


@pytest.mark.parametrize("arch", ["minicpm-2b", "falcon-mamba-7b"])
def test_mesh_train_step_equals_one_card_on_two_ranks(dev, arch):
    """One AdamW step of 2 layers at the published widths in f32 (the
    CPU tests' bars hold) on two ranks sharing the card, at (1, 2) and
    (2, 1) (repro_torch.dist.parity.train_parity), against the same step
    on one card: the loss, every gradient gathered whole, and the flash
    pair (minicpm-2b) or the scan pair (falcon-mamba-7b) launched on each
    rank."""
    import dataclasses

    import torch_rank_jobs as jobs
    from repro_torch import configs
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(configs.get_config(arch), n_layers=2,
                              param_dtype="float32")
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab, (2, 128)).astype(np.int64)
             for k in ("tokens", "labels")}
    model = Model(cfg, device=dev)
    params = model.init(0)
    leaves = adamw.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, {k: torch.from_numpy(v).to(dev)
                               for k, v in batch.items()})
    want = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
    del params, leaves
    torch.cuda.empty_cache()
    pair = (("flash_fwd", "flash_bwd") if arch == "minicpm-2b"
            else ("selective_scan", "selective_scan_bwd"))
    ranks = launch_serve.spawn_ranks(2, [
        (jobs.train_on, dict(shape=shape, cfg=cfg, batch=batch))
        for shape in ((1, 2), (2, 1))], device="cuda", timeout_s=600)
    for rank in ranks:
        for r in rank:
            np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
            got = adamw.tree_leaves(r["grads"])
            for g, w in zip(got, want):
                torch.testing.assert_close(
                    g, w, rtol=1e-3, atol=1e-3 * float(w.abs().max()))
            assert all(r["launches"][k] == cfg.n_layers for k in pair), \
                r["launches"]

