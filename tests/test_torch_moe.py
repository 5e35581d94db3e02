"""The port's MoE layer (``repro_torch/models/moe.py``) against the
reference's ``repro/models/moe.py`` on the deepseek-v2-lite-16b smoke config
(d_model 64, 4 experts, top-2, one shared expert), the reference's weights
carried across by repro_torch.bridge and inputs drawn from a numpy seed.

Compared: out and the aux loss with lossless capacity (the smoke config's
capacity_factor E/k), with a capacity factor that drops assignments, and
with a planted router tie, where the expert order must be jax.lax.top_k's
(the lower index first). The expert choices are integers and must be
equal; out at the f32 bar of tests/test_kernels.py:40
(rtol 1e-4, atol 1e-3 * max(1, K // 64)), aux at rtol 1e-5. Then the
layer's gradients (out and aux both feed the loss) against jax.grad.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import moe as JMOE
from repro_torch import bridge, configs
from repro_torch.models import moe as MOE

ARCH = "deepseek-v2-lite-16b"
B, S = 2, 8


def _configs(capacity_factor=None):
    jc = jcfg.smoke_config(jcfg.get_config(ARCH))
    tc = configs.smoke_config(configs.get_config(ARCH))
    if capacity_factor is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=capacity_factor))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=capacity_factor))
    return jc, tc


def _params(jc, tie=False):
    jp = JMOE.moe_init(jax.random.PRNGKey(0), jc, jnp.float32)
    jp = jax.tree.map(np.asarray, jp)
    if tie:
        # experts 1, 2 and 3 get a zero router column: their logits are
        # exactly 0 in any summation order, so every token ties among them,
        # whatever it sends to expert 0
        w = np.array(jp["router"]["w"])
        w[:, 1:] = 0.0
        jp["router"]["w"] = w
    return jp, bridge.params_from_numpy(jp)


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, 64)).astype(np.float32)


def _bar(got, want, k=64):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-4,
                               atol=1e-3 * max(1, k // 64))


def _routing(probs, k, capacity):
    """(expert ids (T, k), capacity positions (T k,)) from router probs, by
    the reference's rules, in numpy."""
    idx = np.asarray(jax.lax.top_k(jnp.asarray(probs), k)[1])
    flat = idx.reshape(-1)
    onehot = np.eye(probs.shape[-1], dtype=np.int64)[flat]
    pos = ((np.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    return idx, pos, pos < capacity


@pytest.mark.parametrize("case", ["lossless", "drops", "tie"])
def test_moe_apply_matches_reference(case):
    jc, tc = _configs(0.5 if case == "drops" else None)
    jp, tp = _params(jc, tie=case == "tie")
    x = _x(1)
    want, jaux = JMOE.moe_apply(jp, jnp.asarray(x), cfg=jc)
    with torch.no_grad():
        got, aux = MOE.moe_apply(tp, torch.from_numpy(x), cfg=tc)
    assert got.shape == (B, S, 64) and aux.shape == ()
    _bar(got.numpy(), want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)

    # the routing, as integers: the port's top-k against jax.lax.top_k on
    # the same probabilities, and whether this case drops assignments
    logits = x.reshape(-1, 64) @ np.asarray(jp["router"]["w"])
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    cap = MOE.capacity(B * S, tc)
    assert cap == int(B * S * jc.moe.top_k * jc.moe.capacity_factor
                      / jc.moe.n_experts) + 1
    idx, _, keep = _routing(probs, jc.moe.top_k, cap)
    _, tidx = MOE.top_k(torch.from_numpy(probs), tc.moe.top_k)
    np.testing.assert_array_equal(tidx.numpy(), idx)
    assert bool(keep.all()) == (case != "drops")
    if case == "tie":
        # every token ties among experts 1-3: the lower index comes first
        ties = idx[(idx != 0).all(-1)]
        assert len(ties) and (ties == [1, 2]).all()
        assert (idx[(idx == 0).any(-1)][:, 1] == 1).all()


def test_top_k_orders_ties_as_lax_top_k():
    """A planted tie of equal probabilities in several places: the indices
    equal jax.lax.top_k's exactly (torch.topk promises no order)."""
    rng = np.random.default_rng(5)
    p = rng.random((64, 16)).astype(np.float32)
    p[:, 3] = p[:, 7] = p[:, 11] = p.max(-1) + 1.0     # a three-way top tie
    p[::2, 0] = p[::2, 5]                              # ties further down
    for k in (1, 2, 3, 6):
        jv, ji = jax.lax.top_k(jnp.asarray(p), k)
        tv, ti = MOE.top_k(torch.from_numpy(p), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_moe_grads_match_reference():
    """Gradients of sum(out) + aux with respect to x and every weight,
    against jax.grad of the reference (rtol 1e-3, atol 1e-3 * max|leaf|,
    the gradient bar of tests/test_torch_train.py)."""
    jc, tc = _configs(0.5)
    jp, tp = _params(jc)
    x = _x(2)

    def jloss(p, xx):
        out, aux = JMOE.moe_apply(p, xx, cfg=jc)
        return jnp.sum(out) + aux

    jgx, jgp = jax.grad(jloss, argnums=(1, 0))(jp, jnp.asarray(x))
    leaves = [tp["router"]["w"], tp["w_gate"], tp["w_up"], tp["w_down"],
              tp["shared"]["gate"]["w"], tp["shared"]["up"]["w"],
              tp["shared"]["down"]["w"]]
    want = [jgp["router"]["w"], jgp["w_gate"], jgp["w_up"], jgp["w_down"],
            jgp["shared"]["gate"]["w"], jgp["shared"]["up"]["w"],
            jgp["shared"]["down"]["w"]]
    xt = torch.from_numpy(x).requires_grad_(True)
    for t in leaves:
        t.requires_grad_(True)
    out, aux = MOE.moe_apply(tp, xt, cfg=tc)
    grads = torch.autograd.grad(out.sum() + aux, [xt] + leaves)
    for g, w in zip(grads, [jgx] + want):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(g.numpy().astype(np.float64), w,
                                   rtol=1e-3, atol=1e-3 * np.abs(w).max())


def test_moe_init_layout_and_distributions():
    """The port's own init: the reference's tree layout with stacked
    leading dims, and its distributions (std 1/sqrt(d) for the router and
    the gate/up banks, 1/sqrt(d_ff_expert) for the down bank)."""
    _, tc = _configs()
    tc = dataclasses.replace(tc, d_model=256, moe=dataclasses.replace(
        tc.moe, d_ff_expert=512))
    gen = torch.Generator().manual_seed(0)
    p = MOE.moe_init(gen, tc, torch.float32, device="cpu", lead=(3,))
    e, d, f = tc.moe.n_experts, tc.d_model, tc.moe.d_ff_expert
    assert p["router"]["w"].shape == (3, d, e)
    assert p["w_gate"].shape == p["w_up"].shape == (3, e, d, f)
    assert p["w_down"].shape == (3, e, f, d)
    assert p["shared"]["gate"]["w"].shape == (3, d, f * tc.moe.n_shared)
    for w, std in ((p["w_gate"], d ** -0.5), (p["w_up"], d ** -0.5),
                   (p["w_down"], f ** -0.5)):
        assert abs(float(w.std()) / std - 1) < 0.02
        assert not torch.equal(w[0], w[1])
