"""Each kernel module's plain version (what a wrapper runs for CPU tensors)
against the reference's Pallas kernel in interpret mode, on the same numpy
inputs.

Bars: int8 -> int32 bit for bit; f32 the reference GEMM bar of
tests/test_kernels.py (rtol 1e-4, atol 1e-3 * max(1, K // 64)); bf16 inputs
are compared on the f32 accumulator the kernels return (both sides multiply
the same bf16 values exactly in f32), at the f32 bar. Flash: o and lse at
rtol = atol = 2e-3, the bar of tests/test_flash_attention.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ffip_gemm import ffip_gemm as j_ffip_gemm
from repro.kernels.fip_gemm import fip_gemm as j_fip_gemm
from repro.kernels.flash_attention import _flash_fwd as j_flash_fwd
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.kernels.ffip_gemm import ffip_gemm
from repro_torch.kernels.fip_gemm import fip_gemm
from repro_torch.kernels.flash_attention import _flash_fwd, flash_attention

SHAPES = [(16, 32, 16), (100, 60, 36), (1, 130, 257)]
DTYPES = ["float32", "bfloat16", "int8"]
ALGOS = ["baseline", "fip", "ffip"]


def _inputs(m, k, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return (rng.integers(-128, 128, (m, k)).astype(np.int8),
                rng.integers(-128, 128, (k, n)).astype(np.int8))
    return (rng.standard_normal((m, k), np.float32),
            rng.standard_normal((k, n), np.float32))


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "int8":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    j = jnp.asarray(x).astype(dtype)
    return j, bridge.params_from_numpy(np.asarray(j))


def _check(got: torch.Tensor, want, dtype: str, k: int):
    want = np.asarray(want)
    if dtype == "int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.to(torch.float64).numpy(),
                                   want.astype(np.float64), rtol=1e-4,
                                   atol=1e-3 * max(1, k // 64))


def _j_acc(a, b, algo, **kw):
    """The reference kernels' accumulator output (before ops' cast)."""
    if algo == "baseline":
        from repro.kernels.baseline_gemm import baseline_gemm
        return baseline_gemm(a, b, interpret=True)
    fn = j_fip_gemm if algo == "fip" else j_ffip_gemm
    return fn(a, b, interpret=True, **kw)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_matmul_matches_pallas(algo, dtype, m, k, n):
    a, b = _inputs(m, k, n, dtype)
    ja, ta = _pair(a, dtype)
    jb, tb = _pair(b, dtype)
    got = ops.matmul(ta, tb, algo=algo)
    want = jops.matmul(ja, jb, algo=algo, interpret=True)
    if dtype == "bfloat16":
        # ops casts back to bf16: compare the accumulators underneath
        bm, bn, bk = ops.choose_blocks(m, n, k, algo)
        from repro_torch.kernels.baseline_gemm import baseline_gemm
        fn = {"baseline": baseline_gemm, "fip": fip_gemm,
              "ffip": ffip_gemm}[algo]
        _check(fn(ta, tb, bm=bm, bn=bn, bk=bk), _j_acc(ja, jb, algo), dtype, k)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-2)
    else:
        _check(got, want, dtype, k)


@pytest.mark.parametrize("algo", ["fip", "ffip"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_fold_beta_matches_pallas(algo, dtype):
    m, k, n = 24, 64, 40
    a, b = _inputs(m, k, n, dtype, seed=3)
    ja, ta = _pair(a, dtype)
    jb, tb = _pair(b, dtype)
    fn = fip_gemm if algo == "fip" else ffip_gemm
    got = fn(ta, tb, fold_beta=True)
    want = _j_acc(ja, jb, algo, fold_beta=True)
    _check(got, want, dtype, k)


def _sum_tree(k, rows, spu, units, red):
    """The nesting a K3 launch sums a row's k range in: a tuple of groups
    (summed in order), each the k ranges of its splits (summed in order).
    A CTA sums ``spu`` splits itself; the reduction sums ``red`` slots a
    group, then the group totals."""
    splits = -(-k // rows)
    per_unit = [[(s * rows, min((s + 1) * rows, k))
                 for s in range(u * spu, min((u + 1) * spu, splits))]
                for u in range(units)]
    return tuple(tuple(r for unit in per_unit[g:g + red] for r in unit)
                 for g in range(0, units, red))


def test_ffip_split_rows_fill_the_card_at_decode():
    """K3's k-split plan depends on K only: at each (K, N) of the served
    path every M sums a row's k range in the same nesting, whichever launch
    grouping ``unit_plan`` picks for that M (one split a CTA, or one group
    a CTA; both are taken); and decode still puts at least one CTA on each
    of the 132 SMs at (4, 2304, 5760). (K1 and K2 never split K.)"""
    from repro_torch.kernels.ffip_gemm import SMS, split_rows, unit_plan
    for k, n in [(2304, 2304), (2304, 5760), (5760, 2304), (2304, 122753)]:
        trees, modes = set(), set()
        for m in (1, 4, 16, 64, 256, 512):
            bm = ops.choose_blocks(m, n, k, "ffip")[0]
            rows, group = split_rows(k)
            spu, units, red = unit_plan(k, rows, group, -(-m // bm),
                                        m * n * 4)
            trees.add(_sum_tree(k, rows, spu, units, red))
            modes.add(spu)
        assert len(trees) == 1, (k, n, trees)
        assert len(modes) == 2, (k, n)
    rows, group = split_rows(2304)
    spu, units, red = unit_plan(2304, rows, group, 1, 4 * 5760 * 4)
    assert (rows, spu, units, red) == (16, 1, 144, group)
    assert units >= SMS


def test_matmul_batch_dims():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 3, 8, 32), np.float32)
    b = rng.standard_normal((32, 24), np.float32)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b), algo="ffip")
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), algo="ffip",
                       interpret=True)
    assert got.shape == (2, 3, 8, 24)
    _check(got, want, "float32", 32)


FLASH_CASES = [
    # (sq, sk, causal, window)
    (128, 128, True, 0),
    (64, 64, False, 0),
    (100, 100, True, 0),     # Sq not a multiple of the block
    (96, 96, True, 16),      # sliding window
    (40, 40, True, 7),
]


@pytest.mark.parametrize("sq,sk,causal,window", FLASH_CASES)
def test_flash_fwd_matches_pallas(sq, sk, causal, window):
    rng = np.random.default_rng(sq + window)
    q, k, v = (rng.standard_normal((4, s, 16), np.float32)
               for s in (sq, sk, sk))
    o, lse = _flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), window, causal=causal)
    jo, jlse = j_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           window, causal=causal, bq=32, bk=32,
                           interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-3,
                               atol=2e-3)


def test_flash_fully_masked_row_is_zero():
    """Causal with a window of 2 over 4 keys: query rows 5.. see no key
    (they would need k in (q-2, q], beyond Sk), so o is exactly 0 there
    (reference lines 58-62 and 74) and lse matches the reference's."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 16, 16), np.float32)
    k = rng.standard_normal((2, 4, 16), np.float32)
    v = rng.standard_normal((2, 4, 16), np.float32)
    o, lse = _flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), 2, causal=True)
    assert torch.count_nonzero(o[:, 5:]) == 0
    assert torch.count_nonzero(o[:, :4]) > 0
    jo, jlse = j_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                           causal=True, bq=8, bk=8, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-3,
                               atol=2e-3)


def test_flash_attention_returns_o():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 12, 16), np.float32))
               for _ in range(3))
    assert torch.equal(flash_attention(q, k, v, 0, True),
                       _flash_fwd(q, k, v, 0, causal=True)[0])
