"""The reference's quantization API (QuantParams, calibrate, quantize,
dequantize, the §4.1/§4.4 bit widths, quantized_dense_ffip, uint16), the
§3.2.1 proof-replay helpers of core/fip.py, and the LM path's
``block="auto"`` refusal, against repro.core on the same numpy inputs.
Integer results and the dequantized floats bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fip as jfip
from repro.core import quant as jquant
from repro_torch.core import fip, quant
from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.models import layers as L

DTYPES = [(torch.int8, jnp.int8), (torch.uint8, jnp.uint8),
          (torch.int16, jnp.int16), (torch.uint16, jnp.uint16)]


def _f32(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape, np.float32)
            * np.float32(scale))


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(t):
    """A port tensor as numpy; uint16 through int32 (numpy has it, torch's
    numpy bridge does not)."""
    if t.dtype == torch.uint16:
        return t.to(torch.int32).numpy().astype(np.uint16)
    return t.numpy()


def _same_qp(got, want):
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.zero_point.numpy(),
                                  np.asarray(want.zero_point))
    assert got.zero_point.dtype == torch.int32
    assert got.axis == want.axis


def test_d_bit_growth():
    for a, b in [(True, True), (False, False), (True, False), (False, True)]:
        assert quant.d_bit_growth(a, b) == jquant.d_bit_growth(a, b)
        assert quant.preadd_bits(8, a, b) == jquant.preadd_bits(8, a, b)
    assert quant.preadd_bits(8, True, True) == 9
    assert quant.preadd_bits(8, True, False) == 10


@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda d: str(d[0]))
@pytest.mark.parametrize("symmetric", [True, False])
def test_quant_roundtrip_bit_exact(dtypes, symmetric):
    tdt, jdt = dtypes
    x = _f32(0, 64, 32, scale=3.0)
    qp = quant.calibrate(_t(x), tdt, symmetric=symmetric)
    jqp = jquant.calibrate(jnp.asarray(x), jdt, symmetric=symmetric)
    _same_qp(qp, jqp)
    q = quant.quantize(_t(x), qp)
    jq = jquant.quantize(jnp.asarray(x), jqp)
    assert q.dtype == tdt
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    deq = quant.dequantize(q, qp)
    np.testing.assert_array_equal(deq.numpy(),
                                  np.asarray(jquant.dequantize(jq, jqp)))
    assert float((deq - _t(x)).abs().max()) <= float(qp.scale.max()) * 1.01


def test_per_channel_quant():
    x = _f32(1, 16, 8) * np.arange(1, 9, dtype=np.float32)
    qp = quant.calibrate(_t(x), torch.int8, axis=1)
    jqp = jquant.calibrate(jnp.asarray(x), jnp.int8, axis=1)
    assert tuple(qp.scale.shape) == (8,)
    _same_qp(qp, jqp)
    q = quant.quantize(_t(x), qp)
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jquant.quantize(jnp.asarray(x), jqp)))
    err = (quant.dequantize(q, qp) - _t(x)).abs()
    assert float((err / qp.scale.clamp_min(1e-9)).max()) <= 1.01


@pytest.mark.parametrize("algo", ["fip", "ffip"])
def test_quantized_dense_ffip_bit_exact(algo):
    """The full float -> int (F)FIP -> float layer equals the reference's
    bit for bit, and stays within the reference's error budget of x @ w."""
    x, w = _f32(3, 32, 64), _f32(4, 64, 16, scale=0.1)
    bias = _f32(5, 16, scale=0.01)
    xq = quant.calibrate(_t(x), torch.int8, symmetric=False)
    wq = quant.calibrate(_t(w), torch.int8, symmetric=True)
    got = quant.quantized_dense_ffip(_t(x), _t(w), _t(bias), xq, wq,
                                     algo=algo)
    jxq = jquant.calibrate(jnp.asarray(x), jnp.int8, symmetric=False)
    jwq = jquant.calibrate(jnp.asarray(w), jnp.int8, symmetric=True)
    want = jquant.quantized_dense_ffip(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(bias), jxq, jwq, algo=algo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rms = float(torch.sqrt(torch.mean((got - (_t(x) @ _t(w) + _t(bias)))
                                      ** 2)))
    assert rms < 0.05, rms


def test_quantized_dense_ffip_odd_k_rejected():
    x, w = _t(_f32(6, 4, 5)), _t(_f32(7, 5, 3))
    qp = quant.calibrate(x, torch.int8)
    with pytest.raises(ValueError):
        quant.quantized_dense_ffip(x, w, None, qp, quant.calibrate(w))


def test_quantized_ffip_equals_quantized_baseline_bitexact():
    x, w = _f32(8, 8, 32), _f32(9, 32, 8)
    xq = quant.calibrate(_t(x), torch.int8, symmetric=False)
    wq = quant.calibrate(_t(w), torch.int8, symmetric=False)
    aq, bq = quant.quantize(_t(x), xq), quant.quantize(_t(w), wq)
    base = quant.int_gemm_baseline(aq, bq, xq.zero_point, wq.zero_point)
    ffip = quant.int_gemm_ffip(aq, bq, xq.zero_point, wq.zero_point)
    np.testing.assert_array_equal(base.numpy(), ffip.numpy())
    jxq = jquant.calibrate(jnp.asarray(x), jnp.int8, symmetric=False)
    jwq = jquant.calibrate(jnp.asarray(w), jnp.int8, symmetric=False)
    want = jquant.int_gemm_baseline(
        jquant.quantize(jnp.asarray(x), jxq),
        jquant.quantize(jnp.asarray(w), jwq), jxq.zero_point, jwq.zero_point)
    np.testing.assert_array_equal(base.numpy(), np.asarray(want))


@pytest.mark.parametrize("symmetric", [False, True])
def test_prepare_quantized_dense_uint16(symmetric):
    """uint16 weights (KeyError before the port had it) equal the
    reference's bit for bit, every leaf."""
    w = _f32(10, 2, 24, 12)
    got = quant.prepare_quantized_dense(_t(w), dtype=torch.uint16,
                                        symmetric=symmetric)
    want = jquant.prepare_quantized_dense(jnp.asarray(w), dtype=jnp.uint16,
                                          symmetric=symmetric)
    assert set(got) == set(want)
    assert got["qw"].dtype == torch.uint16
    for key in want:
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("j", [0, 3, 9])
def test_h_and_g_terms_exact(j):
    """Eqs. (11)/(12) and the Eq. (8) recurrence, int32 exact; g^{(j)}
    equals h^{(j)} up to the pre-swap of the first column (the induction
    the reference's algebra test replays)."""
    rng = np.random.default_rng(11)
    a = rng.integers(-128, 128, (6, 16)).astype(np.int8)
    b = rng.integers(-128, 128, (16, 10)).astype(np.int8)
    h = fip.h_terms(_t(a), _t(b), j)
    g = fip.g_terms_by_recurrence(_t(a), _t(b), j)
    assert h.dtype == g.dtype == torch.int32
    np.testing.assert_array_equal(
        h.numpy(), np.asarray(jfip.h_terms(jnp.asarray(a), jnp.asarray(b), j)))
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(jfip.g_terms_by_recurrence(
            jnp.asarray(a), jnp.asarray(b), j)))
    np.testing.assert_array_equal(g.numpy(), h.numpy())


def test_block_auto_raises_on_the_lm_path(tmp_path, monkeypatch):
    """GemmConfig(block="auto") on the LM path (models.layers.dense), float
    and int8, resolves through the repro_torch.tune cache: on an empty
    cache one miss a call, counted, and the static default's output bit for
    bit (it raised NotImplementedError naming ROADMAP item 14 until the
    tuner was ported)."""
    from repro_torch import tune
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "sched.json"))
    tune.reset_stats()
    g = torch.Generator().manual_seed(0)
    p = {"w": torch.randn(8, 4, generator=g)}
    p["q"] = quant.prepare_quantized_dense(p["w"])
    x = torch.randn(2, 8, generator=g)
    for quantized in (False, True):
        outs = []
        for block in ("auto", None):
            with use_gemm(GemmConfig(algo="ffip", impl="cuda", block=block,
                                     quantized=quantized)):
                outs.append(L.dense(x, p))
        assert torch.equal(*outs)
    assert tune.stats == {"hits": 0, "misses": 2}
