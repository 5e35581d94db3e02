"""The four LM families served beside minicpm-2b: gemma3-4b (5:1 local:global
sliding windows, a per-layer rope theta, gelu, tied), mixtral-8x22b (GQA +
MoE without shared experts, a sliding window on every layer),
starcoder2-3b (layernorm, gelu, a qkv bias) and deepseek-coder-33b (dense
llama), each on its smoke config against the reference's, on the same
numpy inputs and the reference's weights carried across by
repro_torch.bridge (JAX on the CPU, Pallas in interpret mode).

The smoke configs keep the family's structure at small widths: window 8,
local:global period 2 (layer 0 local at theta 1e4, layer 1 global at 1e6),
head_dim 16, 4 heads over 2 kv heads, MoE 4 experts top-2 at capacity
factor 2 (lossless). Every prompt here is longer than the window of 8, so
the window masks of K4, K5 and the decode path all cut keys. The bias,
layernorm and norm-scale leaves are drawn at random (both sides get the
same numbers), so a leaf that does not reach its layer shows.

* The configs: field for field equal to the reference's, full and smoke;
  ``window_theta_arrays`` equal to the reference's at every full config.
* The full forward: hidden states (flash and naive), logits and the aux
  loss, at tests/test_kernels.py:40's f32 tolerances (rtol 1e-4, atol 1e-3
  * max(1, k // 64)).
* Prefill then decode steps at per-slot positions, through the flash
  prefill, equal to the full forward's logits at each position, and the
  same steps through FFIP and int8 FFIP (the kernels' plain versions)
  against the reference's Pallas ones.
* One step's loss and every gradient leaf against ``jax.value_and_grad``
  (loss rtol 1e-5, each leaf rtol 1e-3, atol 1e-3 * max|leaf|, as
  tests/test_torch_train.py holds the dense model).
* The launchers take each ``--arch``.

tests/test_torch_serve_families.py and tests/test_torch_paged_families.py
hold the port's ``BatchServer`` to the reference's on the same setups.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core.gemm import GemmConfig as JGemm
from repro.core.gemm import use_gemm as j_use_gemm
from repro.models import transformer as JT
from repro.models.model import build_model as j_build
from repro_torch import bridge, configs
from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

ARCHS = ("gemma3-4b", "mixtral-8x22b", "starcoder2-3b", "deepseek-coder-33b")
B, S, MAX_LEN = 2, 20, 48
_SETUPS = {}


def _np(x):
    return np.asarray(x, np.float64)


def _bar(got, want, k=64):
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                               atol=1e-3 * max(1, k // 64))


def _perturbed(tree, rng):
    """The tree with every bias, layernorm bias and norm scale drawn at
    random (they start at 0 and 1), so each must reach its layer."""
    if isinstance(tree, dict):
        return {k: (rng.normal(1.0, 0.2, np.shape(v)).astype(np.float32)
                    if k == "scale" and not isinstance(v, dict) else
                    rng.normal(0.0, 0.2, np.shape(v)).astype(np.float32)
                    if k in ("b", "bias") else _perturbed(v, rng))
                for k, v in tree.items()}
    return tree


def _setup(arch, impl="flash"):
    """(reference config, model, params; port config, model, params) on the
    smoke config with attention_impl ``impl``."""
    key = (arch, impl)
    if key not in _SETUPS:
        jc = dataclasses.replace(jcfg.smoke_config(jcfg.get_config(arch)),
                                 attention_impl=impl)
        tc = dataclasses.replace(configs.smoke_config(configs.get_config(
            arch)), attention_impl=impl)
        jm = j_build(jc)
        base = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        leaves = _perturbed(base, np.random.default_rng(3))
        jp = jax.tree.map(jnp.asarray, leaves)
        tp = bridge.params_from_numpy(leaves)
        _SETUPS[key] = (jc, jm, jp, tc, M.Model(tc, device="cpu"), tp)
    return _SETUPS[key]


def _tokens(vocab, seed=0, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (B, s))


# --- configs ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """Every field of the full and the smoke config equals the
    reference's (the dtype field is compared by name)."""
    for tc, jc in ((configs.get_config(arch), jcfg.get_config(arch)),
                   (configs.smoke_config(configs.get_config(arch)),
                    jcfg.smoke_config(jcfg.get_config(arch)))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
    assert arch in configs.ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_window_theta_arrays_match_reference_at_full_depth(arch):
    """Each layer's window and rope theta, by the global layer index, for
    every group of the full config's layer plan."""
    tc, jc = configs.get_config(arch), jcfg.get_config(arch)
    offset = 0
    for (name, kind, n), (jname, jkind, jn) in zip(T.layer_plan(tc),
                                                   JT.layer_plan(jc)):
        assert (name, kind, n) == (jname, jkind, jn)
        win, theta = T.window_theta_arrays(tc, n, offset)
        jwin, jtheta = JT.window_theta_arrays(jc, n, offset)
        np.testing.assert_array_equal(win, np.asarray(jwin))
        np.testing.assert_array_equal(theta, np.asarray(jtheta))
        offset += n
    if arch == "gemma3-4b":            # 5 local : 1 global, 34 layers
        win, theta = T.window_theta_arrays(tc, tc.n_layers)
        assert list(win[:6]) == [1024] * 5 + [0]
        assert (win == 0).sum() == 5 and theta[5] == 1e6 and theta[0] == 1e4
    if arch == "mixtral-8x22b":
        assert (T.window_theta_arrays(tc, tc.n_layers)[0] == 4096).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference_layout(arch):
    """The port's own init has the reference's leaves and shapes, biases and
    layernorm leaves included, and the bridge carries every leaf."""
    jc, jm, jp, tc, tm, tp = _setup(arch)

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            out.update(shapes(v, key) if isinstance(v, dict)
                       else {key: tuple(v.shape)})
        return out

    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in flat}
    assert shapes(tm.init(0)) == want
    assert shapes(tp) == want
    assert shapes(tm.init_cache(3, 12)) == shapes(
        jax.tree.map(np.asarray, jm.init_cache(3, 12)))
    names = set(want)
    if tc.qkv_bias:
        assert "['layers']['attn']['wk']['b']" in names
    if tc.norm == "layernorm":
        assert "['layers']['ln1']['bias']" in names
    if tc.moe is not None:
        assert {"['layers']['ffn']['w_gate']", "['layers']['ffn']['router']"
                "['w']"} <= names and not any("shared" in n for n in names)


# --- the model ----------------------------------------------------------------

@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_logits_and_aux_match_reference(arch, impl):
    jc, jm, jp, tc, tm, tp = _setup(arch, impl)
    tokens = _tokens(jc.vocab)
    jh, jaux, _ = JT.forward(jp, jnp.asarray(tokens), jc)
    with torch.no_grad():
        h, aux, _ = T.forward(tp, torch.from_numpy(tokens), tc)
        logits = T.logits_fn(tp, h, tc)
    _bar(h, jh)
    _bar(logits, JT.logits_fn(jp, jh, jc), k=tc.d_model)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-7)
    assert (float(aux) > 0) == (tc.moe is not None)


CASES = {
    "default": (dict(), dict(), 1e-4),
    "ffip-kernels": (dict(algo="ffip", impl="pallas"),
                     dict(algo="ffip", impl="cuda"), 1e-4),
    # int8 as tests/test_torch_model.py holds it: the integer GEMMs are
    # bit-exact, the float ops between them round differently
    "int8-ffip": (dict(algo="ffip", impl="pallas", quantized=True),
                  dict(algo="ffip", impl="cuda", quantized=True), 5e-2),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, case):
    """Prefill (flash, into the cache) and three decode steps at per-slot
    positions past the window, against the reference's under the same GEMM
    provider; under the default provider each step's logits also equal the
    port's own full forward over the prompt and the fed tokens."""
    from repro.core import quant as jquant
    from repro_torch.core import quant

    jc, jm, jp, tc, tm, tp = _setup(arch)
    jkw, tkw, tol = CASES[case]
    if jkw.get("quantized"):
        jp = jquant.attach_quantized_weights(jp)
        tp = quant.attach_quantized_weights(tp)
    tokens = _tokens(jc.vocab, 1)
    feed = np.random.default_rng(2).integers(0, jc.vocab, (B, 3))
    pos = np.array([S, S], np.int32)
    with j_use_gemm(JGemm(**jkw)):
        jcache, jlog = jm.prefill(jp, jnp.asarray(tokens),
                                  jm.init_cache(B, MAX_LEN))
        jdecs = []
        for i in range(feed.shape[1]):
            jcache, jd = jm.decode_step(jp, jnp.asarray(feed[:, i:i + 1],
                                                        jnp.int32),
                                        jcache, jnp.asarray(pos + i))
            jdecs.append(jd)
    with use_gemm(GemmConfig(**tkw)), torch.no_grad():
        cache, log = tm.prefill(tp, torch.from_numpy(tokens),
                                tm.init_cache(B, MAX_LEN))
        decs = []
        for i in range(feed.shape[1]):
            cache, d = tm.decode_step(tp, torch.from_numpy(feed[:, i:i + 1]),
                                      cache, torch.from_numpy(pos + i))
            decs.append(d)
    for got, want in zip([log] + decs, [jlog] + jdecs):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))
    if case == "default":
        full = np.concatenate([tokens, feed], axis=1)
        with torch.no_grad():
            h, _, _ = T.forward(tp, torch.from_numpy(full), tc)
            want = T.logits_fn(tp, h, tc)
        for i, got in enumerate([log] + decs):
            _bar(got.reshape(B, -1), want[:, S - 1 + i], k=tc.d_model)


GRAD_ARCHS = ("gemma3-4b", "mixtral-8x22b", "starcoder2-3b")


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_grads_match_reference(arch):
    """Model.loss (CE, plus the aux loss for mixtral) and every gradient
    leaf through the flash Function (K4 + K8's plain versions, windows and
    thetas per layer), against jax.value_and_grad of the reference."""
    jc, jm, jp, tc, tm, tp = _setup(arch)
    tokens = _tokens(jc.vocab, 6)
    labels = _tokens(jc.vocab, 7)
    batch = {"tokens": tokens, "labels": labels}
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = adamw.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    leaves = adamw.tree_leaves(params)
    loss = tm.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jgrads)]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max())
        assert np.abs(w).max() > 0


# --- launchers ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_take_each_arch(arch, capsys):
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--slots", "2", "--requests", "4", "--max-new", "3",
                       "--gemm-impl", "cuda",
                       "--paged", "--shared-prefix", "--paged-attention",
                       "flash", "--prefill-chunk", "16", "--max-len", "48",
                       "--compare-contiguous"])
    out = capsys.readouterr().out
    assert "4/4 requests" in out and "tokens identical" in out
    assert out.rstrip().endswith("OK")
    got = launch_train.main(["--arch", arch, "--smoke", "--layers", "3",
                             "--device", "cpu", "--steps", "2", "--batch",
                             "2", "--seq", "16"])
    assert all(np.isfinite(h["loss"]) for h in got["history"])
    assert "3 layers" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="item 15"):
        launch_train.main(["--arch", arch, "--device", "cpu"])
