"""The port's Model against the reference's on the minicpm-2b smoke config,
with the reference's weights carried across by repro_torch.bridge.

Compared: full-sequence hidden states, prefill logits, then decode_step
logits at per-slot positions (a (B,) pos vector), under the default
provider and under FFIP through the kernels (plain versions on CPU) against
the reference's Pallas FFIP, float and int8 (attach_quantized_weights).
Bars: f32 logits within rtol = atol = 1e-4 (different but equally exact
summation orders over two layers); int8 within rtol = atol = 5e-2: the
integer GEMMs are bit-exact, but the float ops between them (rsqrt, exp,
sums) round differently in XLA and PyTorch, and an activation that lands
on a quantization boundary then rounds one int8 step apart, which moves
its products by one activation step times the weight (up to ~3e-2 here).
Greedy argmax is identical everywhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import quant as jquant
from repro.core.gemm import GemmConfig as JGemm
from repro.core.gemm import use_gemm as j_use_gemm
from repro.models import transformer as JT
from repro.models.model import build_model as j_build
from repro_torch import bridge, configs
from repro_torch.core import quant
from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.models import transformer as T
from repro_torch.models.model import Model

B, S, MAX_LEN = 2, 8, 16


@pytest.fixture(scope="module")
def setup():
    jc = jcfg.smoke_config(jcfg.get_config("minicpm-2b"))
    jm = j_build(jc)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    assert cfg == configs.smoke_config(configs.get_config("minicpm-2b"))
    m = Model(cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, jc.vocab, (B, S))
    return jc, jm, jparams, cfg, m, tokens


def _np(x):
    return np.asarray(x, np.float64)


CASES = {
    "default": (dict(), dict(), 1e-4),
    "ffip-kernels": (dict(algo="ffip", impl="pallas"),
                     dict(algo="ffip", impl="cuda"), 1e-4),
    "int8-ffip": (dict(algo="ffip", impl="pallas", quantized=True),
                  dict(algo="ffip", impl="cuda", quantized=True), 5e-2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_logits(setup, case):
    jc, jm, jparams, cfg, m, tokens = setup
    jkw, tkw, tol = CASES[case]
    if jkw.get("quantized"):
        jparams = jquant.attach_quantized_weights(jparams)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    if tkw.get("quantized"):
        # the port's own preparation is bit-exact with the reference's
        mine = quant.attach_quantized_weights(
            bridge.params_from_numpy(jax.tree.map(
                np.asarray, jm.init(jax.random.PRNGKey(0)))))
        for key in ("qw", "zp", "scale", "neg_beta", "colsum"):
            np.testing.assert_array_equal(
                mine["layers"]["ffn"]["up"]["q"][key].numpy(),
                params["layers"]["ffn"]["up"]["q"][key].numpy())
    pos = np.array([S, S - 3], np.int32)
    nxt = np.array([[5], [7]], np.int64)

    with j_use_gemm(JGemm(**jkw)):
        jcache, jlog = jm.prefill(jparams, jnp.asarray(tokens),
                                  jm.init_cache(B, MAX_LEN))
        _, jdec = jm.decode_step(jparams, jnp.asarray(nxt, jnp.int32),
                                 jcache, jnp.asarray(pos))
    with use_gemm(GemmConfig(**tkw)), torch.no_grad():
        cache, log = m.prefill(params, torch.from_numpy(tokens),
                               m.init_cache(B, MAX_LEN))
        np.testing.assert_allclose(
            cache["layers"]["k"].numpy(), np.asarray(jcache["layers"]["k"]),
            rtol=tol, atol=tol)
        _, dec = m.decode_step(params, torch.from_numpy(nxt), cache,
                               torch.from_numpy(pos))
    for got, want in ((log, jlog), (dec, jdec)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))


def test_decode_from_bridged_reference_cache(setup):
    """A cache the reference prefilled, carried across by the bridge, decodes
    in the port to the reference's logits."""
    jc, jm, jparams, cfg, m, tokens = setup
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    pos = np.array([S, S - 3], np.int32)
    nxt = np.array([[5], [7]], np.int64)
    jcache, _ = jm.prefill(jparams, jnp.asarray(tokens),
                           jm.init_cache(B, MAX_LEN))
    _, jdec = jm.decode_step(jparams, jnp.asarray(nxt, jnp.int32), jcache,
                             jnp.asarray(pos))
    cache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache))
    with torch.no_grad():
        _, dec = m.decode_step(params, torch.from_numpy(nxt), cache,
                               torch.from_numpy(pos))
    np.testing.assert_allclose(_np(dec), _np(jdec), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("attention_impl", ["flash", "naive"])
def test_forward_hidden(setup, attention_impl):
    import dataclasses
    jc, jm, jparams, cfg, m, tokens = setup
    jc = dataclasses.replace(jc, attention_impl=attention_impl)
    cfg = dataclasses.replace(cfg, attention_impl=attention_impl)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    jh, _, _ = JT.forward(jparams, jnp.asarray(tokens), jc)
    with torch.no_grad():
        h, _, _ = T.forward(params, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(_np(h), _np(jh), rtol=1e-4, atol=1e-4)


def test_sample_steps_freeze_matches_stepping(setup):
    """The fused chunk with a slot that finishes mid-chunk leaves the same
    tokens and cache as stepping one token at a time."""
    jc, jm, jparams, cfg, m, tokens = setup
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    with torch.no_grad():
        cache, _ = m.prefill(params, torch.from_numpy(tokens),
                             m.init_cache(B, MAX_LEN))
        c1 = {k: {kk: vv.clone() for kk, vv in v.items()}
              for k, v in cache.items()}
        tok = torch.tensor([3, 4])
        pos = torch.tensor([S, S])
        live = torch.tensor([True, True])
        rem = torch.tensor([4, 2])
        eos = torch.tensor([-1, -1])
        c1, fused = m.sample_steps(params, tok, c1, pos, live, rem, eos,
                                   steps=4)
        toks = []
        for j in range(4):
            cache, nxt = m.sample_step(params, tok[:, None], cache, pos)
            toks.append(nxt)
            alive = torch.tensor([j < 3, j < 1])
            pos = torch.where(alive, pos + 1, pos)
            tok = torch.where(alive, nxt, tok)
    assert torch.equal(fused, torch.stack(toks))
    assert torch.equal(c1["layers"]["k"], cache["layers"]["k"])


def test_init_params_tree_matches_reference_layout(setup):
    jc, jm, jparams, cfg, m, tokens = setup
    mine = m.init(0)
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    want = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in jflat}

    def flat(t, prefix=""):
        out = {}
        for k, v in t.items():
            key = f"{prefix}['{k}']"
            out.update(flat(v, key) if isinstance(v, dict)
                       else {key: tuple(v.shape)})
        return out

    assert flat(mine) == want
    assert mine["layers"]["attn"]["wq"]["w"].dtype == torch.float32
