"""The port's conv path (``core/im2col.py``, ``kernels/conv_gemm.py``: K7's
plain version and the int8 host half) against the reference on the same
numpy inputs. The reference's fused conv runs its Pallas kernel in interpret
mode, as tests/test_conv_fused.py runs it on the CPU.

Bars: int8 conv outputs int32 bit for bit; f32 the reference GEMM bar (rtol
1e-4, atol 1e-3 * max(1, K / 64), K = KH*KW*Cin_g); quantized entries, row
sums and the quantized conv's f32 output exact (the integer sums are exact
and the epilogue is the same IEEE f32 operations in the same order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import im2col as j_im2col
from repro.kernels import conv_gemm as jcg
from repro_torch.core import im2col
from repro_torch.kernels import compat
from repro_torch.kernels import conv_gemm as cg
from repro_torch.kernels import ops

ALGOS = ["baseline", "fip", "ffip"]

# tests/test_conv_fused.py's property sweep: h, w, cin, cout, kh, kw,
# stride, pad, groups (odd K, asymmetric stride and pad, groups)
SWEEP = [
    (8, 8, 4, 8, 3, 3, 1, 0, 1),
    (8, 8, 4, 8, 3, 3, 2, 1, 1),
    (7, 7, 2, 4, 1, 1, 1, 0, 1),
    (9, 9, 3, 4, 5, 5, 2, 2, 1),
    (9, 7, 6, 9, 3, 2, (2, 1), (0, 1), 3),
    (12, 12, 8, 8, 3, 3, 1, 1, 2),
    (11, 11, 3, 8, 4, 4, (3, 2), (1, 0), 1),
]
QCASES = [
    (8, 8, 4, 8, 3, 3, 1, 1, 1),
    (9, 9, 3, 4, 5, 5, 2, 2, 1),
    (12, 12, 8, 16, 3, 3, 1, 1, 2),
    (9, 7, 6, 9, 3, 2, (2, 1), (0, 1), 3),
]


def _ids(cases):
    return [f"h{c[0]}w{c[1]}c{c[2]}k{c[4]}x{c[5]}s{c[6]}p{c[7]}g{c[8]}"
            for c in cases]


def _operands(h, w, cin, cout, kh, kw, groups, dtype, seed=0):
    """numpy operands as tests/test_conv_fused.py draws them."""
    rng = np.random.RandomState(seed)
    if dtype == "int8":
        x = rng.randint(-16, 16, size=(2, h, w, cin)).astype(np.int8)
        k = rng.randint(-16, 16, size=(kh, kw, cin // groups,
                                       cout)).astype(np.int8)
    else:
        x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
        k = rng.standard_normal((kh, kw, cin // groups,
                                 cout)).astype(np.float32)
    return x, k


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Algorithm 1: the counters and indices (tests/test_im2col.py's cases)
# ---------------------------------------------------------------------------

INDEX_CASES = [
    # h, w, cin, kh, kw, stride, groups
    (8, 8, 3, 3, 3, 1, 1), (12, 10, 2, 3, 3, 2, 1), (7, 7, 4, 1, 1, 1, 1),
    (9, 9, 3, 5, 5, 2, 1), (27, 27, 8, 5, 5, 1, 2), (13, 13, 12, 3, 3, 1, 4),
    (10, 12, 6, 3, 2, (2, 1), 3), (9, 9, 3, 2, 2, (2, 2), 1),
    (9, 11, 2, 3, 2, (2, 3), 1),
]


@pytest.mark.parametrize("h,w,cin,kh,kw,stride,groups", INDEX_CASES)
def test_conv_gemm_indices_match_reference(h, w, cin, kh, kw, stride,
                                           groups):
    for g in range(groups):
        got = im2col.conv_gemm_indices(h, w, cin, kh, kw, stride,
                                       groups=groups, group=g)
        want = j_im2col.conv_gemm_indices(h, w, cin, kh, kw, stride,
                                          groups=groups, group=g)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert im2col.conv_out_hw(h, w, kh, kw, stride, 1) == \
        j_im2col.conv_out_hw(h, w, kh, kw, stride, 1)


def test_counter_and_partitioning_match_reference():
    digits = [("a", 3, 40), ("b", 4, 7), ("c", 5, 1)]
    got = im2col.MultiDigitCounter(
        [im2col.Digit(*d) for d in digits]).addresses()
    want = j_im2col.MultiDigitCounter(
        [j_im2col.Digit(*d) for d in digits]).addresses()
    np.testing.assert_array_equal(got, want)
    stream = np.arange(37) % 13
    blocks = im2col.partition_blocks(stream, 2, 3)
    for a, b in zip(blocks, j_im2col.partition_blocks(stream, 2, 3)):
        np.testing.assert_array_equal(a, b)
    for order in (None, np.array([2, 0, 1])):
        np.testing.assert_array_equal(
            im2col.interleave_blocks(blocks, order),
            j_im2col.interleave_blocks(blocks, order))
    assert im2col.as_pair((2, 3)) == j_im2col.as_pair((2, 3))
    with pytest.raises(ValueError):
        im2col.as_pair((1, 2, 3))


# ---------------------------------------------------------------------------
# K7's plain version against the reference's fused Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SWEEP, ids=_ids(SWEEP))
@pytest.mark.parametrize("algo", ALGOS)
def test_fused_conv_matches_pallas_float(case, algo):
    h, w, cin, cout, kh, kw, stride, pad, groups = case
    x, k = _operands(h, w, cin, cout, kh, kw, groups, "float32")
    got = cg.conv_gemm_fused(_t(x), _t(k), stride=stride, pad=pad,
                             groups=groups, algo=algo)
    want = jcg.conv_gemm_fused(jnp.asarray(x), jnp.asarray(k), stride=stride,
                               pad=pad, groups=groups, algo=algo)
    assert got.dtype == torch.float32
    kk = kh * kw * cin // groups
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3 * max(1, kk / 64))


@pytest.mark.parametrize("case", SWEEP[:5], ids=_ids(SWEEP[:5]))
@pytest.mark.parametrize("algo", ALGOS)
def test_fused_conv_matches_pallas_int8(case, algo):
    h, w, cin, cout, kh, kw, stride, pad, groups = case
    x, k = _operands(h, w, cin, cout, kh, kw, groups, "int8")
    got = cg.conv_gemm_fused(_t(x), _t(k), stride=stride, pad=pad,
                             groups=groups, algo=algo)
    want = jcg.conv_gemm_fused(jnp.asarray(x), jnp.asarray(k), stride=stride,
                               pad=pad, groups=groups, algo=algo)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("algo", ALGOS)
def test_fused_equals_materialized_in_the_same_blocks(algo, dtype):
    """The reference's contract (tests/test_conv_fused.py): in the same
    blocks, the fused conv and ``conv2d_via_gemm`` through the same GEMM
    give the same bits; the gather is the only difference."""
    x, k = _operands(9, 9, 4, 8, 3, 3, 1, dtype)
    for bm, bn, bk in [(16, 8, 8), (64, 64, 32)]:
        got = cg.conv_gemm_fused(_t(x), _t(k), stride=2, pad=1, algo=algo,
                                 bm=bm, bn=bn, bk=bk)
        ref = im2col.conv2d_via_gemm(
            _t(x), _t(k), stride=2, pad=1,
            gemm_fn=lambda a, b: ops.matmul(a, b, algo=algo, bm=bm, bn=bn,
                                            bk=bk))
        assert torch.equal(got, ref), (bm, bn, bk)


# The pair body's tiles, which K7's FIP/FFIP take on the card (conv_blocks
# picks 64 x 64 or 128 x 128; explicit blocks may name any of them)
PAIR_TILES = [(16, 32, 32), (64, 64, 32), (128, 128, 32)]
# a grouped conv (AlexNet's conv2 pattern) and a Cin 3 conv (the stems:
# plain loads on the card), both with an odd K
TILE_CASES = [
    (11, 9, 6, 12, 3, 3, 1, 1, 3),
    (13, 13, 3, 8, 5, 5, 2, 2, 1),
]


@pytest.mark.parametrize("bm,bn,bk", PAIR_TILES)
@pytest.mark.parametrize("case", TILE_CASES, ids=_ids(TILE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("algo", ["fip", "ffip"])
def test_fused_conv_plain_at_pair_tiles_matches_pallas(algo, dtype, case, bm,
                                                       bn, bk):
    """K7's plain version in each tile the card runs FIP/FFIP in (the pair
    body's, chosen by :func:`conv_blocks`) against the reference's fused
    kernel in interpret mode: f32 at the GEMM bar, int8 exactly."""
    h, w, cin, cout, kh, kw, stride, pad, groups = case
    x, k = _operands(h, w, cin, cout, kh, kw, groups, dtype, seed=bm)
    got = cg.conv_gemm_fused(_t(x), _t(k), stride=stride, pad=pad,
                             groups=groups, algo=algo, bm=bm, bn=bn, bk=bk)
    want = np.asarray(jcg.conv_gemm_fused(
        jnp.asarray(x), jnp.asarray(k), stride=stride, pad=pad,
        groups=groups, algo=algo))
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        kk = kh * kw * cin // groups
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-3 * max(1, kk / 64))


# (M, N a group, evenized K, groups) of the card checks' convs at batch 8:
# ResNet-50's conv1, s2b1.c2, s3b1.c1, s4b2.c2, s5b3.c3 and AlexNet's conv1,
# conv2
CARD_CONVS = [(8 * 112 * 112, 64, 148, 1), (8 * 56 * 56, 64, 576, 1),
              (8 * 28 * 28, 128, 256, 1), (8 * 14 * 14, 256, 2304, 1),
              (8 * 7 * 7, 2048, 512, 1), (8 * 55 * 55, 96, 364, 1),
              (8 * 27 * 27, 128, 1200, 2)]


def test_conv_blocks_are_pair_tiles():
    """For FIP and FFIP :func:`conv_blocks` picks a tile the pair body is
    compiled for at every conv the card checks (and at batch 1), never a
    128-column tile where N <= 64, and 128 x 128 only where its launch
    (split one a CTA where K2's and K3's launch plan splits) fills the card;
    the baseline keeps the CUDA-core body's blocks."""
    from repro_torch.kernels.fip_gemm import (PAIR_GEOMS, launch_plan,
                                              pair_geom, split_plan)
    for m8, n, k, groups in CARD_CONVS:
        for m in (m8, m8 // 8):
            for algo in ("fip", "ffip"):
                bm, bn, bk = cg.conv_blocks(m, n, k, algo, groups)
                assert pair_geom(bm, bn, bk) == PAIR_GEOMS[(bm, bn)]
                if n <= 64:
                    assert bn < 128, (m, n)
                if (bm, bn) == (128, 128):
                    ctas = -(-m // 128) * -(-n // 128) * groups
                    if launch_plan(m, n, k, 128, 128, groups=groups):
                        ctas *= split_plan(k)[1]
                    assert ctas >= compat.SMS * 9 // 10, (m, n, k)
            assert cg.conv_blocks(m, n, k, "baseline") == ops.mac_blocks(m)
    assert cg.conv_blocks(8 * 56 * 56, 64, 576, "ffip") == (64, 64, 32)
    assert cg.conv_blocks(8 * 55 * 55, 96, 364, "fip") == (128, 128, 32)
    assert cg.conv_blocks(8 * 7 * 7, 2048, 512, "ffip") == (64, 64, 32)
    # the grid alone is 26 CTAs; its five splits a CTA fill the card
    assert cg.conv_blocks(8 * 14 * 14, 256, 2304, "fip") == (128, 128, 32)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_conv_carry_stack_is_each_groups_carry_table(dtype):
    """K7's FFIP reads one carry table a group: ``carry_stack`` of the
    (G, K, N) y stack is ``carry_table_plain`` of each group's y, and each
    32-column group's carry plus its own prefix sum rebuilds that group's
    weights (exactly, for int8)."""
    from repro_torch.kernels.ffip_gemm import carry_table_plain, rebuild_b
    _, k = _operands(5, 5, 6, 150, 3, 3, 3, dtype, seed=5)
    stack = cg._kernel_to_stack(_t(k), 3)            # (3, 18, 50)
    y = cg._y_even(stack)
    carry = cg.carry_stack(y)
    assert carry.shape == (3, 18, 2) and carry.dtype == y.dtype
    for g in range(3):
        assert torch.equal(carry[g], carry_table_plain(y[g]))
        b = rebuild_b(y[g])
        if dtype == "int8":
            assert torch.equal(b, stack[g].to(torch.int32))
        else:
            np.testing.assert_allclose(b.numpy(), stack[g].numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_weight_derivations_memoized():
    """The group stack and the Eq. 9 y deltas are derived once per weight;
    a second forward only hits the memo."""
    x, k = _operands(8, 8, 4, 8, 3, 3, 1, "float32")
    memo = compat.DerivedCache()
    with compat.use_derived(memo):
        first = cg.conv_gemm_fused(_t(x), kt := _t(k), algo="ffip")
        computed = memo.stats["computed"]
        assert computed == 2 and len(memo) == 2   # stack + y_even
        second = cg.conv_gemm_fused(_t(x), kt, algo="ffip")
    assert memo.stats["computed"] == computed and memo.stats["hits"] == 2
    assert torch.equal(first, second)


def test_fused_conv_rejects_bad_shapes():
    x, k = _operands(8, 8, 4, 8, 3, 3, 1, "float32")
    with pytest.raises(ValueError):
        cg.conv_gemm_fused(_t(x), _t(k), groups=3)          # cout % groups
    with pytest.raises(ValueError):
        cg.conv_gemm_fused(_t(x), _t(k), algo="fip", bm=8, bn=8, bk=3)


# ---------------------------------------------------------------------------
# Quantized conv
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=QCASES, ids=_ids(QCASES))
def qcase(request):
    h, w, cin, cout, kh, kw, stride, pad, groups = request.param
    x, k = _operands(h, w, cin, cout, kh, kw, groups, "float32")
    k = k * np.float32(0.2)
    jq = jcg.prepare_quantized_conv(jnp.asarray(k), groups=groups)
    q = cg.prepare_quantized_conv(_t(k), groups=groups)
    return dict(x=x, stride=stride, pad=pad, jq=jq, q=q)


def test_prepare_quantized_conv_matches_reference(qcase):
    q, jq = qcase["q"], qcase["jq"]
    assert set(q) == set(jq)
    for key in ("qw", "zp", "neg_beta", "colsum"):
        np.testing.assert_array_equal(q[key].numpy(), np.asarray(jq[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(q["scale"].numpy().view(np.uint32),
                                  np.asarray(jq["scale"]).view(np.uint32))
    for key in ("k_real", "kh", "kw", "groups"):
        assert type(q[key]) is int and q[key] == jq[key], key


def test_quantized_conv_apply_matches_reference(qcase):
    """The port's fused int8 conv equals the reference's (Pallas, interpret
    mode) exactly, and its own materialising reference bit for bit, for
    every algo."""
    x, q, jq = _t(qcase["x"]), qcase["q"], qcase["jq"]
    kw = dict(stride=qcase["stride"], pad=qcase["pad"])
    want = np.asarray(jcg.quantized_conv_apply(jnp.asarray(qcase["x"]), jq,
                                               algo="ffip", **kw))
    for algo in ALGOS:
        got = cg.quantized_conv_apply(x, q, algo=algo, **kw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=algo)
        ref = cg.quantized_conv_reference(x, q, algo=algo, **kw)
        assert torch.equal(got, ref), algo


def test_conv_rowsums_match_reference():
    rng = np.random.RandomState(0)
    xq = rng.randint(-128, 128, size=(2, 9, 9, 6)).astype(np.int8)
    for kh, kw, groups, stride in [(3, 3, 2, (2, 1)), (1, 1, 1, 1),
                                   (5, 4, 3, (1, 2))]:
        got = cg.conv_rowsums(_t(xq), kh=kh, kw=kw, stride=stride,
                              groups=groups)
        want = jcg.conv_rowsums(jnp.asarray(xq), kh=kh, kw=kw, stride=stride,
                                groups=groups)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_input_matches_reference():
    rng = np.random.RandomState(4)
    for x in (rng.standard_normal((2, 5, 5, 3)).astype(np.float32),
              np.abs(rng.standard_normal((1, 4, 4, 2))).astype(np.float32)):
        got = cg.quantize_input_per_tensor(_t(x))
        want = jcg.quantize_input_per_tensor(jnp.asarray(x))
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
