"""The port's zamba2 hybrid (groups of Mamba2 layers, each followed by one
shared attention block, then a tail) against the reference: the layer plan
and cache trees, the training forward, loss and gradients, prefill and
decode, fused decode, the float server's tokens, the launchers, and the
scatter prefill's batch axis. The int8 server's tokens are
tests/test_torch_serve_hybrid.py's (the reference's interpret-mode server
takes most of half a minute a tier).

Inputs come from numpy with a seed; weights and caches are the reference's,
carried across by repro_torch.bridge. The reference runs as its own tests
run it (JAX on the CPU, its Pallas kernels in interpret mode); the port
runs on CPU tensors, so every kernel wrapper takes its plain version.

Bars (f32 smoke model):
- hidden states and logits: rtol = atol = 1e-4 (the same exact products
  summed in another order through 5 layers and 2 attention blocks); the
  argmax equal;
- the loss rtol 1e-5; each gradient leaf rtol 1e-3, atol 1e-3 of its
  largest entry, as tests/test_torch_train.py holds the other stacks;
- serving: identical token streams.
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
from repro.data import pipeline as jpipe
from repro.models import transformer as JT
from repro.models.model import build_model as j_build
from repro.serve.batcher import BatchServer as JServer
from repro.serve.batcher import Request as JRequest
from repro.serve.batcher import _cache_batch_axes as j_batch_axes
from repro_torch import bridge, configs
from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.serve.batcher import (BatchServer, Request,
                                       _cache_batch_axes, _leaves,
                                       _scatter_slot)

ARCH = "zamba2-1.2b"
TOL = 1e-4
MAX_LEN = 48
SLOTS = 2
B, SEQ = 2, 16


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small ops: one thread avoids the pool's overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float64)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _configs():
    return (jcfg.smoke_config(jcfg.get_config(ARCH)),
            configs.smoke_config(configs.get_config(ARCH)))


def _shapes(tree):
    """{dotted path: shape} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        return {f"{k}.{p}" if p else k: s for k, v in tree.items()
                for p, s in _shapes(v).items()}
    return {"": tuple(tree.shape)}


@pytest.fixture(scope="module")
def smoke():
    jc, cfg = _configs()
    jm = j_build(jc)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    # the norms' scales are ones at init: draw them so that a leaf that
    # does not reach its layer shows
    rng = np.random.default_rng(9)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, t: (jnp.asarray(rng.uniform(0.5, 1.5, t.shape),
                                     t.dtype)
                         if any(getattr(k, "key", None) in ("scale", "D")
                                for k in path) else t), jparams)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    tokens = np.random.default_rng(0).integers(0, jc.vocab, (B, SEQ))
    return jc, jm, jparams, cfg, Model(cfg, device="cpu"), params, tokens


# --- plan, init and caches ---------------------------------------------------

def test_config_matches_reference():
    """Every field of the full and the smoke config equals the
    reference's, param_count included."""
    full = (configs.get_config(ARCH), jcfg.get_config(ARCH))
    for tc, jc in (full, _configs()[::-1]):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
    assert full[0].n_layers == 38 and full[0].hybrid_attn_period == 6


def _variants():
    jz, tz = _configs()
    jfull, tfull = jcfg.get_config(ARCH), configs.get_config(ARCH)
    j2 = dataclasses.replace(jz, family="ssm")
    t2 = dataclasses.replace(tz, family="ssm")
    return {"smoke": (jz, tz), "full": (jfull, tfull),
            "ssm version 2": (j2, t2)}


@pytest.mark.parametrize("name", ["smoke", "full", "ssm version 2"])
def test_plan_and_cache_shapes_match_reference(name):
    jc, cfg = _variants()[name]
    assert T.layer_plan(cfg) == JT.layer_plan(jc)
    want = jax.eval_shape(lambda: JT.init_cache(jc, 3, MAX_LEN))
    got = T.init_cache(cfg, 3, MAX_LEN, device="meta")
    assert _shapes(got) == _shapes(want)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for k in path:
            node = node[k.key]
        assert str(node.dtype).removeprefix("torch.") == str(leaf.dtype)
    assert not T.paged_cache_supported(cfg)
    jp = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jc))
    tp = T.init_params(torch.Generator(), cfg, device="meta")
    assert _shapes(tp) == _shapes(jp)


def test_cache_batch_axes_match_reference():
    """The batch axis of every cache leaf, found from shapes, is the
    reference's: 2 in the (n_groups, period, B, ...) leaves, 1 elsewhere."""
    jc, cfg = _configs()
    want = jax.tree.leaves(j_batch_axes(j_build(jc), SLOTS, MAX_LEN))
    got = _cache_batch_axes(Model(cfg, device="cpu"), SLOTS, MAX_LEN)
    names = [p for p in _shapes(T.init_cache(cfg, 1, 1, device="meta"))]
    assert got == want
    assert {n: a for n, a in zip(names, got)} == {
        "hybrid_groups.conv": 2, "hybrid_groups.conv_bc": 2,
        "hybrid_groups.ssm": 2, "shared_attn.k": 1, "shared_attn.v": 1,
        "tail.conv": 1, "tail.conv_bc": 1, "tail.ssm": 1}


def test_scatter_prefill_copies_into_each_leafs_batch_axis():
    """The repair: the old copy ``full[:, slot].copy_(part[:, 0])`` indexes
    a (n_groups, period, B, ...) leaf's period axis on both sides, and so
    broadcasts layer 0's batch-1 state over every slot of layer ``slot``,
    silently; the copy along the batch axis writes the slot and nothing
    else."""
    _, cfg = _configs()
    model = Model(cfg, device="cpu")
    slots = 3
    axes = _cache_batch_axes(model, slots, MAX_LEN)
    one = model.init_cache(1, MAX_LEN)
    gen = torch.Generator().manual_seed(0)
    for leaf in _leaves(one):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))

    def fresh():
        cache = model.init_cache(slots, MAX_LEN)
        for leaf in _leaves(cache):
            leaf.fill_(-7.0)
        return cache

    old = fresh()
    for full, part in zip(_leaves(old), _leaves(one)):
        full[:, 1].copy_(part[:, 0])
    grp = old["hybrid_groups"]["ssm"]            # (n_groups, period, B, ...)
    assert grp.shape[:3] == (2, 2, slots)
    # every slot of each group's layer 1 now holds the prompt's layer-0
    # state, and slot 1 of layer 0 never received it
    want = one["hybrid_groups"]["ssm"][:, 0, 0]
    assert all(torch.equal(grp[:, 1, i], want) for i in range(slots))
    assert (grp[:, 0, 1] == -7.0).all()

    new = fresh()
    _scatter_slot(new, one, axes, 1)
    for full, part, axis in zip(_leaves(new), _leaves(one), axes):
        assert torch.equal(full.select(axis, 1), part.select(axis, 0))
        for other in (0, 2):
            assert (full.select(axis, other) == -7.0).all()


MODEL_CASES = {
    "default": (dict(), dict()),
    "ffip-kernels": (dict(algo="ffip", impl="pallas"),
                     dict(algo="ffip", impl="cuda")),
}
NEXT = np.array([[5], [7]], np.int64)
POS = np.array([SEQ, SEQ], np.int32)
_REFERENCE = {}


def _reference(smoke, case):
    """The reference's prefill of the smoke tokens and one decode step
    under ``case``: (prefilled cache, prefill logits, cache after the
    decode, decode logits), computed once per case."""
    if case not in _REFERENCE:
        jc, jm, jparams, cfg, m, params, tokens = smoke
        # traced anew under each case's GEMM provider
        prefill = jax.jit(lambda *a: jm.prefill(*a))
        decode = jax.jit(lambda *a: jm.decode_step(*a))
        with j_use_gemm(JGemm(**MODEL_CASES[case][0])):
            jcache, jlog = prefill(jparams, jnp.asarray(tokens),
                                   jm.init_cache(B, MAX_LEN))
            jnew, jdec = decode(jparams, jnp.asarray(NEXT, jnp.int32),
                                jcache, jnp.asarray(POS))
        _REFERENCE[case] = (jcache, jlog, jnew, jdec)
    return _REFERENCE[case]


def test_bridge_carries_hybrid_tree_and_cache(smoke):
    """The reference's hybrid tree and a prefilled cache cross unchanged:
    same keys, shapes, dtypes and bits as the port's own; the port decodes
    from the carried cache to the reference's logits."""
    jc, jm, jparams, cfg, m, params, tokens = smoke
    mine = m.init(0)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(adamw.tree_leaves(mine))
    for path, leaf in flat:
        node_t, node_m = params, mine
        for key in path:
            node_t, node_m = node_t[key.key], node_m[key.key]
        np.testing.assert_array_equal(node_t.numpy(), np.asarray(leaf))
        assert node_t.shape == node_m.shape and node_t.dtype == node_m.dtype
    jcache, _, _, jdec = _reference(smoke, "default")
    cache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache))
    assert _shapes(cache) == _shapes(m.init_cache(B, MAX_LEN))
    with torch.no_grad():
        _, dec = m.decode_step(params, torch.from_numpy(NEXT), cache,
                               torch.from_numpy(POS))
    _close(dec, jdec)


# --- the model ---------------------------------------------------------------

@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_training_forward_matches_reference(smoke, impl):
    jc, jm, jparams, cfg, m, params, tokens = smoke
    jc = dataclasses.replace(jc, attention_impl=impl)
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    jh, jaux, _ = JT.forward(jparams, jnp.asarray(tokens), jc)
    with torch.no_grad():
        h, aux, none = T.forward(params, torch.from_numpy(tokens), cfg)
    assert none is None and float(aux) == float(jaux) == 0.0
    _close(h, jh)


def test_loss_and_grads_match_reference(smoke):
    """Every gradient leaf, the shared block's summed over its two uses."""
    jc, jm, jparams, cfg, m, params, _ = smoke
    batch = jpipe.SyntheticLM(jpipe.DataConfig(
        global_batch=B, seq_len=SEQ, vocab=jc.vocab, seed=3)).batch_at(0)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = adamw.tree_map(lambda t: t.clone().requires_grad_(True), params)
    leaves = adamw.tree_leaves(tp)
    loss = m.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = [np.asarray(x) for x in jax.tree.leaves(jgrads)]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape and np.abs(w).max() > 0
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max())


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_prefill_and_decode_logits(smoke, case):
    jc, jm, jparams, cfg, m, params, tokens = smoke
    _, jlog, jcache, jdec = _reference(smoke, case)
    with use_gemm(GemmConfig(**MODEL_CASES[case][1])), torch.no_grad():
        cache = m.init_cache(B, MAX_LEN)
        got, log = m.prefill(params, torch.from_numpy(tokens), cache)
        assert got is cache
        _, dec = m.decode_step(params, torch.from_numpy(NEXT), cache,
                               torch.from_numpy(POS))
    for got_, want in ((log, jlog), (dec, jdec)):
        _close(got_, want)
        np.testing.assert_array_equal(got_.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        node = cache
        for k in path:
            node = node[k.key]
        _close(node, leaf)


def test_sample_steps_chunk_matches_stepping(smoke):
    """A fused 4-step decode with a slot that finishes after one step gives
    the tokens of stepping one at a time, and the live slot's cache."""
    jc, jm, jparams, cfg, m, params, tokens = smoke
    with torch.no_grad():
        cache, log = m.prefill(params, torch.from_numpy(tokens),
                               m.init_cache(B, MAX_LEN))
        stepped = adamw.tree_map(torch.clone, cache)
        first = log.argmax(-1).to(torch.int32)
        pos = torch.full((B,), SEQ)
        cache, toks = m.sample_steps(
            params, first, cache, pos, torch.ones(B, dtype=torch.bool),
            torch.tensor([4, 1]), torch.full((B,), -1), steps=4)
        tok, want = first, []
        for i in range(4):
            stepped, nxt = m.sample_step(params, tok[:, None], stepped,
                                         pos + i)
            want.append(nxt)
            tok = nxt
    assert toks[:, 0].tolist() == [int(t[0]) for t in want]
    assert int(toks[0, 1]) == int(want[0][1])
    for got, ref, axis in zip(_leaves(cache), _leaves(stepped),
                              _cache_batch_axes(m, B, MAX_LEN)):
        assert torch.equal(got.select(axis, 0), ref.select(axis, 0))


def test_paged_and_unknown_kinds_refused(smoke):
    jc, jm, jparams, cfg, m, params, tokens = smoke
    with pytest.raises(ValueError, match="pure-attention"):
        BatchServer(m, batch_slots=2, max_len=MAX_LEN, device="cpu",
                    paged=True)
    with pytest.raises(ValueError, match="pure-attention"):
        m.init_paged_cache(8, 16)
    table = torch.zeros((B, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="hybrid"):
        T.forward(params, torch.from_numpy(tokens), cfg,
                  caches=m.init_cache(B, MAX_LEN), cache_pos=0,
                  page_table=table)
    with pytest.raises(ValueError, match="attention layers"):
        T.block_apply(T.tree_index(params["tail"], 0),
                      torch.zeros((1, 1, cfg.d_model)), cfg=cfg,
                      kind="ssm2", positions=torch.zeros(1),
                      page_table=table)


# --- serving -----------------------------------------------------------------

def serve_prompts(vocab):
    """Prompts within the chunk contract (S <= 15 is one chunk of the smoke
    chunk 8, 16 and 24 split evenly; lengths repeat, so that the
    reference compiles fewer prefills), and one max_len prompt at the
    cache_rows boundary."""
    rng = np.random.default_rng(0)
    lens = [3, 8, 5, 16, 5, 24, 8]
    reqs = [(rng.integers(0, vocab, size=(n,)), 4) for n in lens]
    return reqs + [(rng.integers(0, vocab, size=(MAX_LEN,)), 1)]


def reference_tokens(smoke, reqs, quantized: bool):
    """The reference server's tokens through its Pallas kernels (FFIP), at
    decode_chunk 4."""
    _, jm, jparams, _, _, _, _ = smoke
    srv = JServer(jm, batch_slots=SLOTS, max_len=MAX_LEN, quantized=quantized,
                  gemm_impl="pallas", decode_chunk=4)
    for i, (p, n) in enumerate(reqs):
        srv.submit(JRequest(rid=i, prompt=p, max_new_tokens=n))
    return {r.rid: list(r.out_tokens) for r in srv.run_until_drained(jparams)}


def check_served_tokens(smoke, reqs, want, quantized: bool,
                        decode_chunk: int):
    """The port's server (FFIP through the kernel wrappers: their plain
    versions here) gives ``want``, every prompt in its own scatter prefill:
    the SSM state and conv leaves have no sequence axis to bucket."""
    _, _, _, _, m, params, _ = smoke
    srv = BatchServer(m, batch_slots=SLOTS, max_len=MAX_LEN, device="cpu",
                      gemm_impl="cuda", quantized=quantized,
                      decode_chunk=decode_chunk)
    for i, (p, n) in enumerate(reqs):
        srv.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    got = {r.rid: list(r.out_tokens) for r in srv.run_until_drained(params)}
    assert got == want
    assert all(len(got[i]) == n for i, (_, n) in enumerate(reqs))
    assert not srv._bucketed
    assert srv.stats["prefill_dispatches"] == len(reqs)


@pytest.fixture(scope="module")
def float_tokens(smoke):
    reqs = serve_prompts(smoke[0].vocab)
    return reqs, reference_tokens(smoke, reqs, quantized=False)


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_server_tokens_match_reference(smoke, float_tokens, decode_chunk):
    check_served_tokens(smoke, *float_tokens, quantized=False,
                        decode_chunk=decode_chunk)


# --- the launchers -----------------------------------------------------------

def test_launch_serve_and_train_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--slots", "2", "--requests", "4", "--max-new", "3",
                       "--gemm-impl", "cuda"])
    out = capsys.readouterr().out
    assert "4/4 requests / 12 tokens" in out and "OK" in out
    with pytest.raises(ValueError, match="pure-attention"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--paged", "--requests", "2"])
    res = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq", "16"])
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert "done on cpu; 5 layers" in capsys.readouterr().out
