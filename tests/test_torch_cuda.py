"""Hand-written CUDA kernels (K1-K7) against their plain PyTorch versions,
on the card. Marked ``cuda``; they skip where there is no card. This file
imports no JAX (the machine with the card has none).

Run there:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: int8 paths are exact (int32 ``assert_equal``). Float GEMMs sum
in another order than the plain tile loop (split-K partials, FMA
contraction), so they use the reference's f32 GEMM bar from
tests/test_kernels.py (rtol 1e-4, atol 1e-3 * max(1, K // 64)); flash uses
the reference flash bar (rtol = atol = 2e-3) on f32 o/lse, and the bf16
output rounding (2**-8 relative) on bf16 o; the paged kernel K5 the same
bars, with rows that have no valid key exactly 0. The fused conv K7 takes the
GEMM bars (its K is KH*KW*Cin_g). The selective scan K6 holds h_final and
h_starts within rtol = atol = 1e-4 of the plain f32 values (the reference
kernel's bar in tests/test_selective_scan.py) and y within one bf16 ulp
(the f32 sums differ in order, then round once) in bf16, 1e-4 in f32. Batch invariance is bit for bit
(``torch.equal``): a row's sums must not depend on the rows beside it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.im2col import conv2d_via_gemm
from repro_torch.kernels import compat, conv_gemm, ops
from repro_torch.kernels.baseline_gemm import baseline_gemm, baseline_gemm_plain
from repro_torch.kernels.ffip_gemm import ffip_gemm_y, ffip_gemm_y_plain, y_for
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


SHAPES = [(4, 2304, 2304), (4, 5760, 2304), (100, 60, 36), (1, 130, 257),
          (64, 2304, 5760), (4, 8192, 288), (128, 256, 8192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_gemm_kernels_match_plain(dev, m, k, n, dtype):
    a, b = _operands(m, k, n, dtype, dev)
    blocks = ops.choose_blocks(m, n, k, "ffip")
    bm, bn, bk = blocks
    kc = _k_chunk(m, n)
    _compare(baseline_gemm(a, b, bm=bm, bn=bn, bk=bk),
             baseline_gemm_plain(a, b, bm=bm, bn=bn, bk=bk), dtype, k)
    for fold in (False, True):
        _compare(fip_gemm(a, b, bm=bm, bn=bn, bk=bk, fold_beta=fold),
                 fip_gemm_plain(a, b, bm=bm, bn=bn, bk=bk, fold_beta=fold,
                                k_chunk=kc), dtype, k)
        y = y_for(b)
        _compare(ffip_gemm_y(a, y, bm=bm, bn=bn, bk=bk, fold_beta=fold),
                 ffip_gemm_y_plain(a, y, bm=bm, bn=bn, bk=bk, fold_beta=fold,
                                   k_chunk=kc), dtype, k)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,window,causal", [(128, 0, True), (77, 0, True),
                                              (100, 16, True),
                                              (64, 0, False)])
def test_flash_kernel_matches_plain(dev, dtype, sq, window, causal):
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((8, sq, 64), generator=g, device=dev).to(dtype)
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
    blocks = ops.choose_blocks(b * geom.m, geom.ng, geom.k, "ffip")
    bm, bn, bk = blocks
    for algo in ("baseline", "fip", "ffip"):
        fold = dtype == torch.int8 and algo != "baseline"
        bg = {"baseline": stack, "fip": conv_gemm._evenize_k(stack),
              "ffip": conv_gemm._y_even(stack)}[algo]
        got = conv_gemm.fused_conv_raw(xp, stack, kh=kh, kw=kw,
                                       stride=stride, groups=groups,
                                       algo=algo, fold_beta=fold)
        want = conv_gemm.fused_conv_plain(xp, bg, geom, algo=algo, bm=bm,
                                          bn=bn, bk=bk, fold_beta=fold)
        torch.cuda.synchronize()
        _compare(got, want, dtype, geom.k)


@pytest.mark.parametrize("algo", ["baseline", "fip", "ffip"])
def test_conv_kernel_equals_gemm_on_materialised_a(dev, algo):
    """K7 sums what K1-K3 sum over the materialised A, in the same order."""
    x, kern = _conv_operands(2, 14, 14, 36, 72, 3, 3, 2, torch.float32, dev)
    got = conv_gemm.conv_gemm_fused(x, kern, stride=1, pad=1, groups=2,
                                    algo=algo)
    ref = conv2d_via_gemm(x, kern, stride=1, pad=1, groups=2,
                          gemm_fn=lambda a, b: ops.matmul(a, b, algo=algo))
    torch.cuda.synchronize()
    assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(2304, 5760), (5760, 2304)])
def test_gemm_batch_invariant(dev, k, n, dtype):
    """Rows 0-3 of an M = 512 call equal the same rows at M = 4, 64, 256."""
    a, b = _operands(512, k, n, dtype, dev, seed=7)
    y = y_for(b)

    def blocks(m):
        return dict(zip(("bm", "bn", "bk"), ops.choose_blocks(m, n, k,
                                                              "ffip")))
    kernels = {"baseline": lambda a_: baseline_gemm(a_, b, **blocks(len(a_))),
               "fip": lambda a_: fip_gemm(a_, b, **blocks(len(a_))),
               "ffip": lambda a_: ffip_gemm_y(a_, y, **blocks(len(a_)))}
    for name, fn in kernels.items():
        full = fn(a)[:4]
        for m in (4, 64, 256):
            part = fn(a[:m].contiguous())[:4]
            assert torch.equal(part, full), (name, m)


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
