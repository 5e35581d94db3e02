"""repro_torch.core.{fip,quant,gemm} against repro.core on the same numpy
inputs. Integer paths bit for bit (int32 assert_array_equal); f32 paths at
the reference GEMM bar of tests/test_kernels.py (rtol 1e-4,
atol 1e-3 * max(1, K // 64))."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fip as jfip
from repro.core import quant as jquant
from repro_torch.core import fip, quant
from repro_torch.core.gemm import GemmConfig, gemm, use_gemm, current_config

M, K, N = 12, 48, 20


def _f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _i8(seed, *shape):
    return np.random.default_rng(seed).integers(-128, 128, shape).astype(
        np.int8)


def _close(got, want, k=K):
    np.testing.assert_allclose(got.numpy().astype(np.float64),
                               np.asarray(want, np.float64), rtol=1e-4,
                               atol=1e-3 * max(1, k // 64))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", ["fip_matmul", "ffip_matmul",
                                  "baseline_matmul"])
@pytest.mark.parametrize("k_chunk", [0, 4])
def test_matmuls(name, k_chunk):
    a, b = _f32(0, M, K), _f32(1, K, N)
    ai, bi = _i8(2, M, K), _i8(3, K, N)
    kw = {} if name == "baseline_matmul" else {"k_chunk": k_chunk}
    jfn, tfn = getattr(jfip, name), getattr(fip, name)
    _close(tfn(_t(a), _t(b), **kw), jfn(jnp.asarray(a), jnp.asarray(b), **kw))
    got = tfn(_t(ai), _t(bi), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfn(jnp.asarray(ai), jnp.asarray(bi), **kw)))


def test_alpha_beta_fold_and_cross():
    ai, bi = _i8(4, M, K), _i8(5, K, N)
    ja, jb = jnp.asarray(ai), jnp.asarray(bi)
    ta, tb = _t(ai), _t(bi)
    for tv, jv in [(fip.fip_alpha(ta), jfip.fip_alpha(ja)),
                   (fip.fip_beta(tb), jfip.fip_beta(jb)),
                   (fip.fold_beta_into_bias(tb), jfip.fold_beta_into_bias(jb)),
                   (fip.fip_cross_term(ta, tb, k_chunk=6),
                    jfip.fip_cross_term(ja, jb, k_chunk=6)),
                   (fip.fip_matmul_beta_folded(
                       ta, tb, fip.fold_beta_into_bias(tb)),
                    jfip.fip_matmul_beta_folded(
                        ja, jb, jfip.fold_beta_into_bias(jb)))]:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_y_encoding_pair_swap_and_scan():
    b, a = _f32(6, K, N), _f32(7, M, K)
    bi = _i8(8, K, N)
    np.testing.assert_array_equal(fip.make_y(_t(bi)).numpy(),
                                  np.asarray(jfip.make_y(jnp.asarray(bi))))
    np.testing.assert_array_equal(
        fip.y_to_b(fip.make_y(_t(bi))).numpy(), bi.astype(np.int32))
    np.testing.assert_array_equal(fip.pair_swap(_t(a)).numpy(),
                                  np.asarray(jfip.pair_swap(jnp.asarray(a))))
    np.testing.assert_array_equal(
        fip.pair_swap_rows(_t(b)).numpy(),
        np.asarray(jfip.pair_swap_rows(jnp.asarray(b))))
    y = fip.make_y(_t(b))
    _close(fip.ffip_matmul_scan(_t(a), y, beta=fip.fip_beta(_t(b))),
           jfip.ffip_matmul_scan(jnp.asarray(a), jfip.make_y(jnp.asarray(b)),
                                 beta=jfip.fip_beta(jnp.asarray(b))))


def test_odd_k_rejected():
    with pytest.raises(ValueError):
        fip.fip_alpha(torch.zeros((2, 3)))


@pytest.mark.parametrize("algo", ["fip", "ffip"])
def test_int_gemm_ffip_zero_points(algo):
    aq, bq = _i8(9, M, K), _i8(10, K, N)
    za, zb = 3, np.arange(N, dtype=np.int32) - 5
    got = quant.int_gemm_ffip(_t(aq), _t(bq), za, _t(zb), algo=algo)
    want = jquant.int_gemm_ffip(jnp.asarray(aq), jnp.asarray(bq), za,
                                jnp.asarray(zb), algo=algo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), quant.int_gemm_baseline(_t(aq), _t(bq), za,
                                             _t(zb)).numpy())


@pytest.mark.parametrize("symmetric", [False, True])
def test_prepare_quantized_dense_bit_exact(symmetric):
    w = _f32(11, 2, K, N)          # a stacked pair of layers
    got = quant.prepare_quantized_dense(_t(w), symmetric=symmetric)
    want = jquant.prepare_quantized_dense(jnp.asarray(w), symmetric=symmetric)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("algo", ["baseline", "fip", "ffip"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_quantized_dense_apply_bit_exact(algo, impl):
    """impl="cuda" on CPU tensors runs the kernels' plain versions; the int32
    accumulator, and so the dequantized output, is identical either way."""
    x, w = _f32(12, M, K), _f32(13, K, N)
    q = quant.prepare_quantized_dense(_t(w))
    jq = jquant.prepare_quantized_dense(jnp.asarray(w))
    got = quant.quantized_dense_apply(_t(x), q, algo=algo, impl=impl)
    want = jquant.quantized_dense_apply(jnp.asarray(x), jq, algo=algo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_attach_quantized_weights_tree():
    tree = {"embed": {"table": torch.zeros(8, 4)},
            "layers": {"wq": {"w": _t(_f32(14, 2, K, N))},
                       "odd": {"w": torch.zeros(3, 5)}},
            "unembed": {"w": _t(_f32(15, K, N))}}
    out = quant.attach_quantized_weights(tree)
    assert "q" in out["layers"]["wq"] and "q" not in out["layers"]["odd"]
    assert "q" not in out["unembed"]
    assert out["layers"]["wq"]["q"]["qw"].shape == (2, K, N)


@pytest.mark.parametrize("algo", ["baseline", "fip", "ffip"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_gemm_provider(algo, impl):
    a, b = _f32(16, 3, M, K + 1), _f32(17, K + 1, N)     # odd K pads
    with use_gemm(GemmConfig(algo=algo, impl=impl)):
        assert current_config().algo == algo
        got = gemm(_t(a), _t(b))
    assert current_config() == GemmConfig()
    _close(got, np.asarray(a, np.float64) @ np.asarray(b, np.float64), K + 1)


def test_gemm_block_validation(tmp_path, monkeypatch):
    """A malformed block is a ValueError; "auto" (the tuned schedule)
    resolves through the repro_torch.tune cache: on an empty cache a miss,
    counted, and the static default's result bit for bit."""
    from repro_torch import tune
    with pytest.raises(ValueError):
        gemm(torch.zeros(2, 4), torch.zeros(4, 2),
             GemmConfig(algo="fip", impl="cuda", block=(8, 8)))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "sched.json"))
    tune.reset_stats()
    a, b = _t(_f32(5, 3, 4)), _t(_f32(6, 4, 6))
    got = gemm(a, b, GemmConfig(algo="fip", impl="cuda", block="auto"))
    want = gemm(a, b, GemmConfig(algo="fip", impl="cuda"))
    assert torch.equal(got, want)
    assert tune.stats == {"hits": 0, "misses": 1}