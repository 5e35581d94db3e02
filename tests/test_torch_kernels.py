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
from repro_torch.core import fip as fip_core
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


def _sum_tree(k, rows, split_cta):
    """The nesting a K2/K3 launch sums a row's k range in: a tuple of splits
    (added in order), each the k-tiles it sums in order. A CTA takes one
    split (``split_cta``; the reduction adds the slots in split order) or
    every split (its running total adds each split as it closes)."""
    splits = -(-k // rows)

    def tiles(s):
        return tuple((t, min(t + 32, k))
                     for t in range(s * rows, min((s + 1) * rows, k), 32))
    units = ([[s] for s in range(splits)] if split_cta
             else [list(range(splits))])
    return tuple(tiles(s) for unit in units for s in unit)


SERVED_KN = [(2304, 2304), (2304, 5760), (5760, 2304), (2304, 122753),
             (4096, 16384), (8192, 288), (256, 8192), (8192, 4096),
             (4096, 65024)]


def test_ffip_split_rows_fill_the_card_at_decode():
    """K2's and K3's k-split plan depends on K only: at each (K, N) of the
    served paths every M sums a row's k range in the same nesting, whichever
    tile geometry and launch (one split a CTA, or every split in one CTA)
    it takes; both launches and all three geometries are taken. Decode (M 4)
    puts at least one CTA on each of the 132 SMs at every served (K, N), and
    the prefill shapes whose grid fills the card write no partials."""
    from repro_torch.kernels.compat import SMS
    from repro_torch.kernels.fip_gemm import launch_plan, split_plan
    modes, geoms = set(), set()
    for k, n in SERVED_KN:
        trees = set()
        for m in (1, 4, 16, 17, 64, 128, 256, 512):
            bm, bn, bk = ops.choose_blocks(m, n, k, "ffip")
            assert bk == 32
            rows, _ = split_plan(k)
            split_cta = launch_plan(m, n, k, bm, bn)
            trees.add(_sum_tree(k, rows, split_cta))
            modes.add(split_cta)
            geoms.add((bm, bn))
        assert len(trees) == 1, (k, n)
        bm, bn, _ = ops.choose_blocks(4, n, k, "ffip")
        ctas = -(-4 // bm) * -(-n // bn)
        if launch_plan(4, n, k, bm, bn):
            ctas *= split_plan(k)[1]
        assert ctas >= SMS, (k, n, ctas)
    assert modes == {False, True}
    assert geoms == {(16, 32), (64, 64), (128, 128)}
    for m, k, n in [(128, 4096, 16384), (512, 2304, 5760)]:
        bm, bn, _ = ops.choose_blocks(m, n, k, "ffip")
        assert (bm, bn) == (128, 128)
        assert not launch_plan(m, n, k, bm, bn)
    assert split_plan(2304) == (512, 5)
    assert ops.choose_blocks(4, 5760, 2304, "fip") == (16, 32, 32)
    assert ops.choose_blocks(512, 5760, 2304, "baseline") == (64, 64, 32)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("bm,bn", [(16, 64), (64, 64), (128, 128)])
def test_baseline_plain_at_tensor_core_tiles_matches_pallas(bm, bn, dtype):
    """K1's plain version at each tensor-core tile (``TC_GEOMS``, with the
    dtype's 128-byte k-tile) against the reference's baseline kernel in
    interpret mode: M, K and N ragged against the tile (M a tile and 3, K
    two k-tiles and 7, N a tile and 5). int8 exactly, bf16 on the f32
    accumulator at the f32 bar. The wrapper takes exactly these blocks."""
    from repro_torch.kernels.baseline_gemm import (TC_BK, TC_GEOMS,
                                                   baseline_gemm, tc_geom)
    tdtype = getattr(torch, dtype)
    bk = TC_BK[tdtype]
    assert tc_geom(bm, bn, bk, tdtype) == TC_GEOMS[(bm, bn)]
    m, k, n = bm + 3, 2 * bk + 7, bn + 5
    a, b = _inputs(m, k, n, dtype, seed=bm + bn)
    ja, ta = _pair(a, dtype)
    jb, tb = _pair(b, dtype)
    got = baseline_gemm(ta, tb, bm=bm, bn=bn, bk=bk)
    _check(got, _j_acc(ja, jb, "baseline"), dtype, k)
    with pytest.raises(ValueError):
        tc_geom(bm, bn, bk // 2, tdtype)


def test_tensor_core_tiles_share_one_k_chain_at_every_m():
    """The invariance argument of K1 on the tensor cores, without a card.
    The body has no split of K: an output element is one chain of mma
    k-steps (16 bf16 or 32 int8 values, 32 bytes) over all of K in order
    from zero. So a row's sums cannot depend on M as long as every M takes
    a tile of the same dtype's k-tile, a whole number of k-steps deep: at
    each served (K, N) and dtype, every M does (whichever loader fills the
    tile: TMA or cp.async). The served shapes take all three tiles."""
    from repro_torch.kernels.baseline_gemm import TC_BK, TC_GEOMS
    geoms = set()
    for dtype, kstep in ((torch.bfloat16, 16), (torch.int8, 32)):
        assert TC_BK[dtype] * dtype.itemsize == 128
        assert TC_BK[dtype] % kstep == 0
        for k, n in SERVED_KN:
            for m in (1, 4, 16, 17, 64, 128, 512):
                bm, bn, bk = ops.choose_blocks(m, n, k, "baseline", dtype)
                assert (bm, bn) in TC_GEOMS and (bm <= 16) == (m <= 16)
                assert bk == TC_BK[dtype], (k, n, m, dtype)
                geoms.add((bm, bn))
    assert geoms == set(TC_GEOMS)
    assert ops.choose_blocks(512, 5760, 2304, "baseline",
                             torch.bfloat16) == (128, 128, 64)
    assert ops.choose_blocks(512, 2304, 5760, "baseline",
                             torch.bfloat16) == (64, 64, 64)
    assert ops.choose_blocks(4, 16384, 4096, "baseline",
                             torch.int8) == (16, 64, 128)


@pytest.mark.parametrize("k,n", [(16, 288), (9, 257), (10, 257), (6, 31)])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_carry_table_matches_reference_prefix(k, n, dtype):
    """K3's carry table (the prefix of each row before every 32-column
    group, derived offline from y) against the reference's y_to_b(make_y(b))
    at every 32-column start: int32 exactly, f32 within the GEMM bar. N 288,
    257 (ragged) and 31 (under one group); K 9 odd and 10 (the same rows
    evenized with a zero row). The plain rebuild (carry plus the group's own
    prefix) gives B back the same way."""
    from repro.core import fip as jfip
    from repro_torch.kernels.ffip_gemm import carry_table, rebuild_b
    _, b = _inputs(1, 9 if k == 10 else k, n, dtype, seed=n)
    if k == 10:
        b = np.concatenate([b, np.zeros((1, n), b.dtype)])
    jb, tb = _pair(b, dtype)
    want_b = np.asarray(jfip.y_to_b(jfip.make_y(jb)))
    want = np.concatenate([np.zeros((k, 1), want_b.dtype),
                           want_b[:, 31::32]], axis=1)[:, :-(-n // 32)]
    y = fip_core.make_y(tb)
    got = carry_table(y)
    assert got.shape == (k, -(-n // 32)) and got.dtype == y.dtype
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(rebuild_b(y).numpy(), want_b)
    else:
        _check(got, want, dtype, k)
        _check(rebuild_b(y), want_b, dtype, k)


def test_carry_table_cpu_takes_the_plain_version():
    """On a CPU tensor the carry-table wrapper is its plain version and
    launches nothing."""
    from repro_torch.kernels import compat
    from repro_torch.kernels.ffip_gemm import carry_table, carry_table_plain
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (5, 70)).astype(np.float32))
    before = compat.launch_counts()["ffip_carry_table"]
    assert torch.equal(carry_table(y), carry_table_plain(y))
    assert compat.launch_counts()["ffip_carry_table"] == before


@pytest.mark.parametrize("algo", ["fip", "ffip"])
@pytest.mark.parametrize("m,k,n,blocks", [
    (4, 96, 70, None),            # decode tiles, 16 x 32
    (72, 130, 80, None),          # 64 x 64
    (70, 64, 136, (128, 128, 32)),  # the wide tiles, ragged M and N
])
def test_pair_geometry_matches_pallas(algo, m, k, n, blocks):
    """ops.matmul for FIP/FFIP at the pair body's tile geometries
    (choose_blocks' decode and mid tiles, and the wide tiles) against the
    reference's ops.matmul in interpret mode: int8 exactly, f32 at the GEMM
    bar."""
    bm, bn, bk = blocks or ops.choose_blocks(m, n, k, algo)
    assert (bm, bn, bk) in {(16, 32, 32), (64, 64, 32), (128, 128, 32)}
    for dtype in ("int8", "float32"):
        a, b = _inputs(m, k, n, dtype, seed=m + n)
        ja, ta = _pair(a, dtype)
        jb, tb = _pair(b, dtype)
        got = ops.matmul(ta, tb, algo=algo, bm=bm, bn=bn, bk=bk)
        want = jops.matmul(ja, jb, algo=algo, interpret=True)
        _check(got, want, dtype, k)


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
