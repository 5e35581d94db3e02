"""pixtral-12b, a dense decoder behind a patch prefix, on its smoke config
against the reference's, on the same numpy inputs and the reference's
weights carried across by repro_torch.bridge (JAX on the CPU, Pallas in
interpret mode).

The smoke config keeps the family's structure at small widths: 2 layers, d
64, 4 heads of 16 over 2 kv heads, 8 patch tokens, rope theta 1e9, untied
embeddings. Norm scales are drawn at random (both sides get the same
numbers). Patches are one numpy draw carried into both packages (the
stubs' own draws are not compared).

* The configs: field for field equal to the reference's, full and smoke;
  the init tree (the untied ``unembed`` included) and the cache have the
  reference's layout.
* The full forward with patches (flash and naive): the prefix's rows
  stripped, hidden states and logits at tests/test_kernels.py:40's f32
  tolerances (rtol 1e-4, atol 1e-3 * max(1, k // 64)); the patches reach
  the tokens.
* ``prefill(patches=)`` then decode steps at positions that count the
  prefix, against the reference's under the default provider, FFIP and
  int8 FFIP, and against the port's own full forward.
* The loss with patches and every gradient leaf against
  ``jax.value_and_grad`` (loss rtol 1e-5, each leaf rtol 1e-3, atol 1e-3
  * max|leaf|).
* ``BatchServer`` tokens identical to the reference's, text only as the
  reference serves it: contiguous (bucketed prefill) float at decode_chunk
  1 and 4 and int8 once; paged, gather and flash (K5's plain version),
  with the reference's page counters.
* The launchers take ``--arch pixtral-12b``.
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
from repro.serve.batcher import BatchServer as JServer
from repro.serve.batcher import Request as JRequest
from repro_torch import configs
from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serve.batcher import BatchServer, Request
from test_torch_encdec import _shapes, _workload
from test_torch_families import B, CASES, MAX_LEN, _bar, _np, _setup
from test_torch_paged_families import PS, _STATS
from test_torch_serve_families import _run

ARCH = "pixtral-12b"
S = 12


def _patches(cfg, seed=0):
    """(B, frontend_tokens, d) patch embeddings, one numpy draw for both."""
    return np.random.default_rng(seed).normal(
        0.0, 0.5, (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def _tokens(vocab, seed=0, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (B, s))


def test_config_matches_reference():
    for tc, jc in ((configs.get_config(ARCH), jcfg.get_config(ARCH)),
                   (configs.smoke_config(configs.get_config(ARCH)),
                    jcfg.smoke_config(jcfg.get_config(ARCH)))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
    tc = configs.get_config(ARCH)
    assert T.layer_plan(tc) == JT.layer_plan(jcfg.get_config(ARCH)) == [
        ("layers", "dense", 40)]
    assert (tc.frontend_tokens, tc.hd, tc.rope_theta) == (256, 128, 1e9)


def test_init_tree_and_cache_match_reference_layout():
    jc, jm, jp, tc, tm, tp = _setup(ARCH)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in flat}
    assert _shapes(tm.init(0)) == want
    assert _shapes(tp) == want
    assert "['unembed']['w']" in want and "['encoder']" not in str(want)
    assert _shapes(tm.init_cache(3, 12)) == _shapes(
        jax.tree.map(np.asarray, jm.init_cache(3, 12)))


@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_forward_with_patches_matches_reference(impl):
    """The prefix set before the token embeddings, positions counting it,
    its rows stripped from the hidden states."""
    jc, jm, jp, tc, tm, tp = _setup(ARCH, impl)
    tokens, patches = _tokens(jc.vocab), _patches(tc)
    jh, _, _ = JT.forward(jp, jnp.asarray(tokens), jc,
                          patches=jnp.asarray(patches))
    with torch.no_grad():
        h, _, _ = T.forward(tp, torch.from_numpy(tokens), tc,
                            patches=torch.from_numpy(patches))
        logits = T.logits_fn(tp, h, tc)
        bare, _, _ = T.forward(tp, torch.from_numpy(tokens), tc)
    assert h.shape == (B, S, tc.d_model)
    _bar(h, jh)
    _bar(logits, JT.logits_fn(jp, jh, jc), k=tc.d_model)
    assert float((bare - h).abs().max()) > 1e-2


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(case):
    """prefill(patches=) (prefix + prompt through K4's plain version, P + S
    cache rows) and three decode steps at positions P + S + i, against the
    reference's under the same GEMM provider; under the default provider
    each step's logits also equal the port's full forward over the patches,
    the prompt and the fed tokens."""
    from repro.core import quant as jquant
    from repro_torch.core import quant

    jc, jm, jp, tc, tm, tp = _setup(ARCH)
    jkw, tkw, tol = CASES[case]
    if jkw.get("quantized"):
        jp = jquant.attach_quantized_weights(jp)
        tp = quant.attach_quantized_weights(tp)
    tokens, patches = _tokens(jc.vocab, 1), _patches(tc, 4)
    feed = np.random.default_rng(2).integers(0, jc.vocab, (B, 3))
    n = tc.frontend_tokens + S
    pos = np.array([n, n], np.int32)
    with j_use_gemm(JGemm(**jkw)):
        jcache, jlog = jm.prefill(jp, jnp.asarray(tokens),
                                  jm.init_cache(B, MAX_LEN),
                                  patches=jnp.asarray(patches))
        jdecs = []
        for i in range(feed.shape[1]):
            jcache, jd = jm.decode_step(jp, jnp.asarray(feed[:, i:i + 1],
                                                        jnp.int32),
                                        jcache, jnp.asarray(pos + i))
            jdecs.append(jd)
    with use_gemm(GemmConfig(**tkw)), torch.no_grad():
        cache, log = tm.prefill(tp, torch.from_numpy(tokens),
                                tm.init_cache(B, MAX_LEN),
                                patches=torch.from_numpy(patches))
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
            h, _, _ = T.forward(tp, torch.from_numpy(full), tc,
                                patches=torch.from_numpy(patches))
            want = T.logits_fn(tp, h, tc)
        for i, got in enumerate([log] + decs):
            _bar(got.reshape(B, -1), want[:, S - 1 + i], k=tc.d_model)


def test_loss_and_grads_match_reference():
    """Model.loss(patches=) and every gradient leaf, the patches' own
    included, through the flash Function (K4 + K8's plain versions),
    against jax.value_and_grad of the reference."""
    jc, jm, jp, tc, tm, tp = _setup(ARCH)
    batch = {"tokens": _tokens(jc.vocab, 6), "labels": _tokens(jc.vocab, 7),
             "patches": _patches(tc, 8)}

    def jloss_fn(params, patches):
        return jm.loss(params, {"tokens": jnp.asarray(batch["tokens"]),
                                "labels": jnp.asarray(batch["labels"]),
                                "patches": patches})

    jloss, (jgrads, jgp) = jax.value_and_grad(jloss_fn, argnums=(0, 1))(
        jp, jnp.asarray(batch["patches"]))
    params = adamw.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    patches = torch.from_numpy(batch["patches"]).requires_grad_(True)
    leaves = adamw.tree_leaves(params)
    loss = tm.loss(params, {"tokens": torch.from_numpy(batch["tokens"]),
                            "labels": torch.from_numpy(batch["labels"]),
                            "patches": patches})
    grads = torch.autograd.grad(loss, leaves + [patches])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jgrads)]
    want.append(np.asarray(jgp))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max())
        assert np.abs(w).max() > 0


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "int8-ffip"])
def test_contiguous_server_tokens_match_reference(quantized):
    """Bucketed prefill, text only: the reference server's tokens at
    decode_chunk 1 and 4 (float), and int8 FFIP once on shorter work."""
    jc, jm, jp, tc, tm, tp = _setup(ARCH)
    reqs = _workload(tc.vocab, n=3 if quantized else 5)
    want = _run(JServer(jm, batch_slots=2, max_len=MAX_LEN,
                        quantized=quantized), reqs, jp, JRequest)
    impl = "cuda" if quantized else None
    for c in ((1,) if quantized else (1, 4)):
        srv = BatchServer(tm, batch_slots=2, max_len=MAX_LEN, device="cpu",
                          quantized=quantized, gemm_impl=impl,
                          decode_chunk=c)
        assert _run(srv, reqs, tp, Request) == want
        assert srv._bucketed


def _paged_workload(vocab, seed=0):
    """On 3 slots: a prompt behind a 16-token (2-page) prefix and two of
    their own, then, as slots free, a second prompt behind that prefix and
    a resubmission of the first (prefix hits, a whole-prompt hit)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=(16,))
    first = np.concatenate([base, rng.integers(0, vocab, size=(3,))])
    return [(first, 5), (rng.integers(0, vocab, size=(30,)), 6),
            (rng.integers(0, vocab, size=(5,)), 2),
            (np.concatenate([base, rng.integers(0, vocab, size=(4,))]), 5),
            (first.copy(), 3)]


@pytest.mark.parametrize("paged_attention", ["gather", "flash"])
def test_paged_server_tokens_match_contiguous_and_reference(paged_attention):
    """Paged (attention_impl "naive", as tests/test_serve_paged.py runs
    it), text only: the port's contiguous server's tokens and the
    reference's paged server's, with its page counters."""
    jc, jm, jp, tc, tm, tp = _setup(ARCH, "naive")
    reqs = _paged_workload(tc.vocab)
    want = _run(BatchServer(tm, batch_slots=3, max_len=MAX_LEN,
                            device="cpu"), reqs, tp, Request)
    kw = dict(batch_slots=3, max_len=MAX_LEN, decode_chunk=4, paged=True,
              page_size=PS, prefill_chunk=16,
              paged_attention=paged_attention)
    srv = BatchServer(tm, device="cpu", **kw)
    got = _run(srv, reqs, tp, Request)
    assert got == want
    jsrv = JServer(jm, **kw)
    assert got == _run(jsrv, reqs, jp, JRequest)
    assert ({k: srv.stats[k] for k in _STATS}
            == {k: jsrv.stats[k] for k in _STATS})
    assert srv.stats["prefix_hit_tokens"] > 0
    assert srv._reserved == 0
    assert srv.alloc.free_count + srv.alloc.in_use == srv.alloc.num_pages


def test_launchers_take_pixtral(capsys):
    launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--slots", "2", "--requests", "4", "--max-new", "3",
                       "--gemm-impl", "cuda", "--paged", "--shared-prefix",
                       "--paged-attention", "flash", "--prefill-chunk", "16",
                       "--max-len", "48", "--compare-contiguous"])
    out = capsys.readouterr().out
    assert "4/4 requests" in out and "tokens identical" in out
    assert out.rstrip().endswith("OK")
    got = launch_train.main(["--arch", ARCH, "--smoke", "--layers", "3",
                             "--device", "cpu", "--steps", "2", "--batch",
                             "2", "--seq", "16"])
    assert all(np.isfinite(h["loss"]) for h in got["history"])
    assert "3 layers" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="item 15"):
        launch_train.main(["--arch", ARCH, "--device", "cpu"])
