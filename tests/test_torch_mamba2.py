"""The port's Mamba2 block (zamba2's SSD) against the reference:
``_segsum``, ``_ssd_chunked`` and ``mamba2_apply``, forward and gradients.

Inputs come from numpy with a seed; weights are the reference's, carried
across by repro_torch.bridge. Both sides run on the CPU: the SSD is einsums
outside any kernel in the reference too, and the projections take the
plain GEMM.

Bars:
- ``_segsum``: bit for bit on log-decays that are multiples of 2**-10
  (every partial sum is then exact in f32, whatever the order: XLA's CPU
  cumsum is an associative scan, PyTorch's a running sum), so the mask,
  the orientation of the difference and the -inf above the diagonal are
  held exactly; on normal draws within 4 f32 ulps of the running sums.
- f32: tests/test_kernels.py's bar, rtol 1e-4 and atol 1e-3 * max(1, k //
  64) for a contraction of length k (the state width N or the chunk for
  the SSD, d_model or d_inner for the mixer): the same exact products
  summed in another order.
- bf16: BF16_TOL, a few bf16 ulps at 1 of the f32 view: every op of the
  chunk rounds to bf16 on both sides, and XLA may keep a fused chain in
  f32 where PyTorch rounds each op.
- Gradients (f32): rtol = atol = 1e-3 of the largest gradient of each
  leaf, as a sum of a few hundred f32 products in another order.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import ssm as JS
from repro_torch import bridge, configs
from repro_torch.models import ssm as S

ARCH = "zamba2-1.2b"
BF16_TOL = 2.0 ** -5
GRAD_TOL = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small ops: one thread avoids the pool's overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float64)


def _close(got, want, tol, atol=None):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                               atol=tol if atol is None else atol)


def _f32_atol(k):
    return 1e-3 * max(1, k // 64)


def _smoke(dtype="float32"):
    jc = dataclasses.replace(jcfg.smoke_config(jcfg.get_config(ARCH)),
                             param_dtype=dtype)
    cfg = dataclasses.replace(configs.smoke_config(configs.get_config(ARCH)),
                              param_dtype=dtype)
    return jc, cfg


def _ssd_inputs(bt, s, h, p, g, n, seed=0):
    """xh, dt (softplus of a normal), log_a = -exp(A_log) dt, B, C and a
    nonzero h0, drawn with numpy."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((bt, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bt, s, h)) - 1)).astype(
        np.float32)
    a = np.exp(np.log(np.linspace(1.0, 16.0, h)))
    log_a = (-a * dt).astype(np.float32)
    b = rng.standard_normal((bt, s, g, n)).astype(np.float32)
    c = rng.standard_normal((bt, s, g, n)).astype(np.float32)
    h0 = (rng.standard_normal((bt, h, p, n)) * 0.1).astype(np.float32)
    return xh, dt, log_a, b, c, h0


# --- _segsum ----------------------------------------------------------------

@pytest.mark.parametrize("c", [1, 8, 12])
def test_segsum_exact(c):
    rng = np.random.default_rng(c)
    la = -np.abs(rng.standard_normal((2, 3, c))).astype(np.float32)
    dyadic = (np.round(la * 1024) / 1024).astype(np.float32)
    upper = np.triu_indices(c, 1)
    for inp in (dyadic, la):
        want = np.asarray(JS._segsum(jnp.asarray(inp)))
        got = S._segsum(torch.from_numpy(inp)).numpy()
        assert got.shape == (2, 3, c, c) and got.dtype == np.float32
        assert np.isneginf(got[..., upper[0], upper[1]]).all()
        assert np.array_equal(np.isneginf(got), np.isneginf(want))
        if inp is dyadic:
            np.testing.assert_array_equal(got, want)
        else:
            finite = ~np.isneginf(want)
            ulp = np.spacing(np.float32(np.abs(np.cumsum(inp, -1)).max()))
            assert np.abs(got[finite] - want[finite]).max() <= 4 * ulp


# --- _ssd_chunked -----------------------------------------------------------

@pytest.mark.parametrize("s", [1, 8, 12, 24])
def test_ssd_chunked_f32_matches_reference(s):
    """One chunk (S 1, 8, 12: n_chunks = max(1, S // 8)) and three (S 24),
    from a nonzero state, with two groups of two heads each."""
    args = _ssd_inputs(2, s, 4, 16, 2, 8, seed=s)
    jy, jh = JS._ssd_chunked(*map(jnp.asarray, args), chunk=8)
    y, h = S._ssd_chunked(*map(torch.from_numpy, args), chunk=8)
    assert y.shape == (2, s, 4, 16) and y.dtype == torch.float32
    assert h.shape == (2, 4, 16, 8) and h.dtype == torch.float32
    atol = _f32_atol(8)       # sums over N = 8 and a chunk's <= 12 rows
    _close(y, jy, 1e-4, atol)
    _close(h, jh, 1e-4, atol)


def test_ssd_chunked_bf16_matches_reference():
    """bf16 xh, B and C (the model dtype), f32 dt, log_a and state: the
    intra-chunk tensors round to bf16 where the reference's do."""
    xh, dt, la, b, c, h0 = _ssd_inputs(1, 16, 4, 16, 1, 8, seed=7)
    jbf = [jnp.asarray(v).astype(jnp.bfloat16) for v in (xh, b, c)]
    jy, jh = JS._ssd_chunked(jbf[0], jnp.asarray(dt), jnp.asarray(la),
                             jbf[1], jbf[2], jnp.asarray(h0), chunk=8)
    txh, tb, tc = [bridge.params_from_numpy(np.asarray(v)) for v in jbf]
    assert txh.dtype == torch.bfloat16
    y, h = S._ssd_chunked(txh, torch.from_numpy(dt), torch.from_numpy(la),
                          tb, tc, torch.from_numpy(h0), chunk=8)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    scale = float(np.abs(np.asarray(jy)).max())
    _close(y, jy, BF16_TOL, BF16_TOL * scale)
    _close(h, jh, BF16_TOL, BF16_TOL * float(np.abs(np.asarray(jh)).max()))


def test_ssd_chunk_contract():
    """S 17 at chunk 8 is two chunks that do not split evenly: the reference
    asserts, the port raises ValueError."""
    args = _ssd_inputs(1, 17, 2, 4, 1, 4)
    with pytest.raises(AssertionError):
        JS._ssd_chunked(*map(jnp.asarray, args), chunk=8)
    with pytest.raises(ValueError, match="equal chunks"):
        S._ssd_chunked(*map(torch.from_numpy, args), chunk=8)


# --- mamba2_apply -----------------------------------------------------------

def _mixer(dtype, seed=1):
    jc, cfg = _smoke(dtype)
    jp = JS.mamba2_init(jax.random.PRNGKey(seed), jc, jc.dtype)
    # dt_bias and D are zeros and ones at init: draw them so that a leaf
    # that does not reach the output shows
    rng = np.random.default_rng(seed)
    h = jp["D"].shape[0]
    jp = dict(jp, D=jnp.asarray(rng.uniform(0.5, 1.5, h)).astype(jc.dtype),
              dt_bias=jnp.asarray(rng.standard_normal(h) * 0.5).astype(
                  jc.dtype),
              norm={"scale": jnp.asarray(rng.uniform(
                  0.5, 1.5, jp["norm"]["scale"].shape)).astype(jc.dtype)})
    return jc, cfg, jp, bridge.params_from_numpy(jax.tree.map(np.asarray,
                                                              jp))


def _mixer_cache(jc, b, rng):
    s = jc.ssm
    di = s.expand * jc.d_model
    return {"conv": jnp.asarray(rng.standard_normal(
                (b, s.d_conv - 1, di))).astype(jc.dtype),
            "conv_bc": jnp.asarray(rng.standard_normal(
                (b, s.d_conv - 1, 2 * s.n_groups * s.d_state))).astype(
                jc.dtype),
            "ssm": jnp.asarray(rng.standard_normal(
                (b, di // s.head_dim, s.head_dim, s.d_state)) * 0.1,
                jnp.float32)}


def test_mamba2_init_tree_matches_reference():
    jc, cfg = _smoke("bfloat16")
    jp = jax.jit(lambda k: JS.mamba2_init(k, jc, jc.dtype))(
        jax.random.PRNGKey(0))
    mine = S.mamba2_init(torch.Generator().manual_seed(0), cfg, cfg.dtype,
                         device="cpu", lead=(3,))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(jax.tree.leaves(
        jax.tree.map(lambda t: 0, mine, is_leaf=torch.is_tensor)))
    for path, leaf in flat:
        node = mine
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == (3, *leaf.shape)
        assert node.dtype == torch.bfloat16
    np.testing.assert_array_equal(mine["A_log"][2].float().numpy(),
                                  np.asarray(jp["A_log"], np.float32))
    assert torch.equal(mine["D"], torch.ones_like(mine["D"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [12, 1])
def test_mamba2_apply_with_cache_matches_reference(dtype, s):
    """A prompt chunk (S 12) and a decode step (S 1) from a nonzero cache:
    the output and every updated cache leaf, written in place."""
    jc, cfg, jp, p = _mixer(dtype)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, s, jc.d_model))).astype(jc.dtype)
    jcache = _mixer_cache(jc, 2, rng)
    jout, jnew = jax.jit(functools.partial(JS.mamba2_apply, cfg=jc))(
        jp, x, cache=jcache)
    cache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache))
    with torch.no_grad():
        out, new = S.mamba2_apply(p, bridge.params_from_numpy(np.asarray(x)),
                                  cfg=cfg, cache=cache)
    assert new is cache and out.dtype == cfg.dtype
    assert new["ssm"].dtype == torch.float32
    f32 = dtype == "float32"
    tol = 1e-4 if f32 else BF16_TOL
    di = jc.ssm.expand * jc.d_model
    atol = _f32_atol(di) if f32 else BF16_TOL
    _close(out.float(), jnp.asarray(jout, jnp.float32), tol, atol)
    for k in ("conv", "conv_bc", "ssm"):
        _close(new[k].float(), jnp.asarray(jnew[k], jnp.float32), tol, atol)


def test_mamba2_apply_without_cache_matches_reference():
    jc, cfg, jp, p = _mixer("float32", seed=2)
    x = np.random.default_rng(4).standard_normal(
        (2, 16, jc.d_model)).astype(np.float32)
    jout, jnone = jax.jit(functools.partial(JS.mamba2_apply, cfg=jc))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        out, none = S.mamba2_apply(p, torch.from_numpy(x), cfg=cfg)
    assert jnone is None and none is None
    _close(out, jout, 1e-4, _f32_atol(jc.ssm.expand * jc.d_model))


def test_mamba2_prompt_then_step_equals_one_pass():
    """The streaming contract: a 16-token prompt into a zero cache, then 8
    more tokens from that cache, give the outputs of one 24-token pass."""
    _, cfg, _, p = _mixer("float32", seed=5)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 24, cfg.d_model)).astype(np.float32))
    from repro_torch.models import transformer as T
    cache = {k: v[0] for k, v in T.init_cache(cfg, 1, 24,
                                              device="cpu")["tail"].items()}
    with torch.no_grad():
        whole, _ = S.mamba2_apply(p, x, cfg=cfg)
        first, _ = S.mamba2_apply(p, x[:, :16], cfg=cfg, cache=cache)
        rest, _ = S.mamba2_apply(p, x[:, 16:], cfg=cfg, cache=cache)
    _close(torch.cat([first, rest], 1), whole, 1e-4, 1e-4)


def test_mamba2_gradients_match_jax_grad():
    """Every parameter's and the input's gradient of a scalar of the
    output (no cache, two chunks) against jax.grad of the reference."""
    jc, cfg, jp, p = _mixer("float32", seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, jc.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 16, jc.d_model)).astype(np.float32)

    def jloss(params, xx):
        out, _ = JS.mamba2_apply(params, xx, cfg=jc)
        return jnp.sum(out * jnp.asarray(w))

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {}

    def track(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = track(v, f"{prefix}{k}.")
            else:
                out[k] = leaves[f"{prefix}{k}"] = v.clone().requires_grad_()
        return out

    tp = track(p)
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = S.mamba2_apply(tp, tx, cfg=cfg)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [*leaves.values(), tx])
    flat = {".".join(k.key for k in path): g for path, g in
            jax.tree_util.tree_flatten_with_path(jgp)[0]}
    assert set(flat) == set(leaves)
    for name, got in zip(leaves, grads):
        want = np.asarray(flat[name])
        scale = float(np.abs(want).max())
        assert scale > 0, name
        _close(got, want, GRAD_TOL, GRAD_TOL * scale)
    _close(grads[-1], jgx, GRAD_TOL,
           GRAD_TOL * float(np.abs(np.asarray(jgx)).max()))
