"""Hand-written CUDA kernels (K1-K4) against their plain PyTorch versions, on
the card. Marked ``cuda``; they skip where there is no card. This file
imports no JAX (the machine with the card has none).

Run there:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: int8 paths are exact (int32 ``assert_equal``). Float GEMMs sum
in another order than the plain tile loop (split-K partials, FMA
contraction), so they use the reference's f32 GEMM bar from
tests/test_kernels.py (rtol 1e-4, atol 1e-3 * max(1, K // 64)); flash uses
the reference flash bar (rtol = atol = 2e-3) on f32 o/lse, and the bf16
output rounding (2**-8 relative) on bf16 o.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import compat, ops
from repro_torch.kernels.baseline_gemm import baseline_gemm, baseline_gemm_plain
from repro_torch.kernels.ffip_gemm import ffip_gemm_y, ffip_gemm_y_plain, y_for
from repro_torch.kernels.fip_gemm import fip_gemm, fip_gemm_plain
from repro_torch.kernels.flash_attention import _flash_fwd, _flash_fwd_plain

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
          (64, 2304, 5760)]


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


def test_launch_counters_count_kernel_launches(dev):
    a, b = _operands(4, 64, 64, torch.bfloat16, dev)
    compat.reset_counters()
    ops.matmul(a, b, algo="fip")
    ops.matmul(a, b, algo="baseline")
    assert compat.launch_counts()["fip_gemm"] == 1
    assert compat.launch_counts()["baseline_gemm"] == 1
    ops.matmul(a.cpu(), b.cpu(), algo="fip")
    assert compat.launch_counts()["fip_gemm"] == 1
