"""The port's MLA attention and the deepseek-v2-lite-16b smoke model against
the reference's, on the same numpy inputs, the reference's weights carried
across by repro_torch.bridge (JAX on the CPU, Pallas in interpret mode).

* K4/K8's plain versions at d 24 against dv 16 (the shape of MLA's 192 /
  128) against the reference's ``_flash_fwd`` / ``_flash_bwd`` and the
  ``flash_attention`` custom VJP.
* Each branch of ``mla_apply``: the flash prompt (K4, q/k concatenated to
  nope + rope), plain scores (``naive``), the flash prefill into a cache,
  the absorbed contiguous decode, and the paged write with the absorbed
  gather or K5 (its plain version). Outputs and the cache leaves.
* The smoke model: hidden states, the aux loss, ``Model.loss`` and one
  step's gradients against ``jax.value_and_grad``; the init tree's layout.

Bars: f32 at tests/test_kernels.py:40's tolerances (rtol 1e-4, atol 1e-3 *
max(1, K // 64)); flash o/lse and its gradients rtol 1e-4 of the largest
value, as tests/test_torch_train_kernels.py holds K4/K8; the model's loss
rtol 1e-5 and each gradient leaf rtol 1e-3, atol 1e-3 * max|leaf|, as
tests/test_torch_train.py holds the dense and SSM models.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.kernels import flash_attention as jfa
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch import bridge, configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

ARCH = "deepseek-v2-lite-16b"
B, S, MAX_LEN = 2, 8, 16


def _np(x):
    return np.asarray(x, np.float64)


def _bar(got, want, k=64):
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                               atol=1e-3 * max(1, k // 64))


def _close_rel(got, want, rtol=1e-4):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _cfgs(impl="flash"):
    jc = dataclasses.replace(jcfg.smoke_config(jcfg.get_config(ARCH)),
                             attention_impl=impl)
    tc = dataclasses.replace(configs.smoke_config(configs.get_config(ARCH)),
                             attention_impl=impl)
    return jc, tc


# --- K4 / K8's plain versions at dv != d --------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_dv_matches_reference(causal):
    """o, lse and dq, dk, dv at d 24 / dv 16: the plain versions against
    the reference's Pallas kernels in interpret mode."""
    rng = np.random.default_rng(3)
    q, k = (rng.standard_normal((3, 40, 24)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((3, 40, 16)).astype(np.float32)
             for _ in range(2))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jfa._flash_fwd(jq, jk, jv, 0, causal=causal, interpret=True)
    jgrads = jfa._flash_bwd(jq, jk, jv, jo, jlse, jdo, 0, causal=causal,
                            interpret=True)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa._flash_fwd(tq, tk, tv, 0, causal=causal)
    assert o.shape == (3, 40, 16)
    _close_rel(o, jo)
    _close_rel(lse, jlse)
    got = fa._flash_bwd(tq, tk, tv, o, lse, tdo, 0, causal=causal)
    assert [tuple(g.shape) for g in got] == [(3, 40, 24), (3, 40, 24),
                                            (3, 40, 16)]
    for g, w in zip(got, jgrads):
        _close_rel(g, w)


def test_flash_function_dv_grads_match_reference():
    """autograd through the port's Function (K4 forward, K8 backward) at
    d 24 / dv 16 against jax.grad of the reference's custom VJP."""
    rng = np.random.default_rng(4)
    q, k = (rng.standard_normal((2, 32, 24)).astype(np.float32)
            for _ in range(2))
    v, w = (rng.standard_normal((2, 32, 16)).astype(np.float32)
            for _ in range(2))

    def loss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, 0, True, True) * w)

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    (fa.flash_attention(tq, tk, tv, 0, True)
     * torch.from_numpy(w)).sum().backward()
    for t, jg in zip((tq, tk, tv), jgrads):
        _close_rel(t.grad, jg)


# --- mla_apply, branch by branch ----------------------------------------------

@pytest.fixture(scope="module")
def mla():
    jc, _ = _cfgs()
    jp = jax.tree.map(np.asarray, JA.mla_init(jax.random.PRNGKey(1), jc,
                                              jnp.float32))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, 64)).astype(np.float32)
    return jp, bridge.params_from_numpy(jp), x, x1


def _leaves_equal(got, want):
    assert set(got) == set(want) == {"c_kv", "k_rope"}
    for key in want:
        assert tuple(got[key].shape) == tuple(np.shape(want[key]))
        _bar(got[key].detach(), want[key])


def _contiguous_cache(jc, n):
    m = jc.mla
    return {"c_kv": np.zeros((B, n, m.kv_lora_rank), np.float32),
            "k_rope": np.zeros((B, n, m.rope_head_dim), np.float32)}


@pytest.mark.parametrize("branch", ["flash", "naive", "flash prefill",
                                    "contiguous decode"])
def test_mla_apply_contiguous_matches_reference(mla, branch):
    jp, tp, x, x1 = mla
    jc, tc = _cfgs("naive" if branch == "naive" else "flash")
    pos = np.arange(S, dtype=np.int32)
    kw_j, kw_t = {}, {}
    xx = x
    if branch == "flash prefill":
        c = _contiguous_cache(jc, MAX_LEN)
        kw_j = dict(cache=jax.tree.map(jnp.asarray, c), cache_pos=0,
                    prefill=True)
        kw_t = dict(cache=bridge.cache_from_numpy(c), cache_pos=0,
                    prefill=True)
    elif branch == "contiguous decode":
        # a reference prefill fills the cache, one row of each slot at its
        # own position decodes
        c = _contiguous_cache(jc, MAX_LEN)
        _, filled = JA.mla_apply(jp, jnp.asarray(x), cfg=jc,
                                 positions=jnp.asarray(pos),
                                 cache=jax.tree.map(jnp.asarray, c),
                                 cache_pos=0, prefill=True)
        filled = jax.tree.map(np.asarray, filled)
        cp = np.asarray([S, S - 3], np.int32)
        pos = cp[:, None]
        xx = x1
        kw_j = dict(cache=jax.tree.map(jnp.asarray, filled),
                    cache_pos=jnp.asarray(cp))
        kw_t = dict(cache=bridge.cache_from_numpy(filled),
                    cache_pos=torch.from_numpy(cp.astype(np.int64)))
    want, jcache = JA.mla_apply(jp, jnp.asarray(xx), cfg=jc,
                                positions=jnp.asarray(pos), **kw_j)
    with torch.no_grad():
        got, cache = A.mla_apply(tp, torch.from_numpy(xx), cfg=tc,
                                 positions=torch.from_numpy(
                                     pos.astype(np.int64)), **kw_t)
    assert got.shape == want.shape
    _bar(got, want)
    assert (cache is None) == (jcache is None)
    if cache is not None:
        _leaves_equal(cache, jcache)


@pytest.mark.parametrize("impl", ["gather", "flash"])
def test_mla_apply_paged_matches_reference(mla, impl):
    """A 6-row chunk of sequence 0 into the pools (rows past 5 masked off),
    then a decode row of two sequences, the second's write masked off:
    outputs and pools against the reference's (K5's plain version against
    the Pallas kernel in interpret mode for ``flash``)."""
    jp, tp, x, x1 = mla
    jc, tc = _cfgs("flash")
    m = jc.mla
    pools = {"c_kv": np.zeros((8, 4, m.kv_lora_rank), np.float32),
             "k_rope": np.zeros((8, 4, m.rope_head_dim), np.float32)}
    jpool, tpool = jax.tree.map(jnp.asarray, pools), \
        bridge.cache_from_numpy(pools)
    table1 = np.asarray([[2, 5, 7, 0]], np.int32)
    chunk = x[:1]
    mask = (np.arange(S) < 6)[None]
    pos = np.arange(S, dtype=np.int32)
    want, jpool = JA.mla_apply(
        jp, jnp.asarray(chunk), cfg=jc, positions=jnp.asarray(pos),
        cache=jpool, cache_pos=jnp.asarray([0], jnp.int32),
        cache_write_mask=jnp.asarray(mask), prefill=True,
        page_table=jnp.asarray(table1), paged_impl=impl)
    with torch.no_grad():
        got, tpool = A.mla_apply(
            tp, torch.from_numpy(chunk), cfg=tc,
            positions=torch.from_numpy(pos.astype(np.int64)),
            cache=tpool, cache_pos=torch.tensor([0]),
            cache_write_mask=torch.from_numpy(mask), prefill=True,
            page_table=torch.from_numpy(table1), paged_impl=impl)
    _bar(got[:, :6], np.asarray(want)[:, :6])
    _leaves_equal(tpool, jpool)

    table2 = np.asarray([[2, 5, 7, 0], [3, 1, 0, 0]], np.int32)
    cp = np.asarray([6, 5], np.int32)
    live = np.asarray([True, False])
    want, jpool = JA.mla_apply(
        jp, jnp.asarray(x1), cfg=jc, positions=jnp.asarray(cp[:, None]),
        cache=jpool, cache_pos=jnp.asarray(cp),
        cache_write_mask=jnp.asarray(live),
        page_table=jnp.asarray(table2), paged_impl=impl)
    with torch.no_grad():
        got, tpool = A.mla_apply(
            tp, torch.from_numpy(x1), cfg=tc,
            positions=torch.from_numpy(cp[:, None].astype(np.int64)),
            cache=tpool, cache_pos=torch.from_numpy(cp.astype(np.int64)),
            cache_write_mask=torch.from_numpy(live),
            page_table=torch.from_numpy(table2), paged_impl=impl)
    _bar(got, want)
    _leaves_equal(tpool, jpool)
    # the masked-off sequence wrote nothing into its pages 3 and 1
    assert torch.count_nonzero(tpool["c_kv"][[1, 3]]) == 0


# --- the smoke model ----------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jc, tc = _cfgs()
    jm = JM.build_model(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    tokens = np.random.default_rng(6).integers(0, jc.vocab, (B, 16))
    labels = np.random.default_rng(7).integers(0, jc.vocab, (B, 16))
    return jc, tc, jm, jp, tp, tokens, labels


@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_model_hidden_and_aux_match_reference(model, impl):
    jc, tc, jm, jp, tp, tokens, _ = model
    jc, tc = (dataclasses.replace(c, attention_impl=impl) for c in (jc, tc))
    jh, jaux, _ = JT.forward(jp, jnp.asarray(tokens), jc)
    with torch.no_grad():
        h, aux, _ = T.forward(tp, torch.from_numpy(tokens), tc)
    _bar(h, jh)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_model_loss_and_grads_match_reference(model):
    """Model.loss = CE + aux and every gradient leaf, through the flash
    Function (K4 + K8's plain versions at d 24 / dv 16), against
    jax.value_and_grad of the reference."""
    jc, tc, jm, jp, tp, tokens, labels = model
    batch = {"tokens": tokens, "labels": labels}
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = adamw.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    leaves = adamw.tree_leaves(params)
    m = M.Model(tc, device="cpu")
    loss = m.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    # the aux term is in the loss: CE alone differs from it
    with torch.no_grad():
        hidden, aux, _ = T.forward(tp, torch.from_numpy(tokens), tc)
        ce = M.chunked_cross_entropy(tp, hidden, torch.from_numpy(labels),
                                     tc)
    assert float(aux) > 0
    np.testing.assert_allclose(float(loss.detach()), float(ce + aux),
                               rtol=1e-6)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jgrads)]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max())


def test_init_tree_and_caches_match_reference_layout(model):
    """The port's own init (the layer plan: a dense MLA head, then MLA +
    MoE layers) and its caches have the reference's tree layout and
    shapes."""
    jc, tc, jm, jp, *_ = model
    assert [k for _, k, _ in T.layer_plan(tc)] == ["mla_dense", "mla_moe"]
    m = M.Model(tc, device="cpu")

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            out.update(shapes(v, key) if isinstance(v, dict)
                       else {key: tuple(v.shape)})
        return out

    def jshapes(tree):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {jax.tree_util.keystr(p): tuple(x.shape) for p, x in flat}

    assert shapes(m.init(0)) == jshapes(jp)
    assert shapes(m.init_cache(3, 12)) == jshapes(jm.init_cache(3, 12))
    assert shapes(m.init_paged_cache(5, 4)) == jshapes(
        jm.init_paged_cache(5, 4))
    assert T.paged_cache_supported(tc)
