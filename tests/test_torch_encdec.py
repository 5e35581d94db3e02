"""whisper-small, the encoder-decoder, on its smoke config against the
reference's, on the same numpy inputs and the reference's weights carried
across by repro_torch.bridge (JAX on the CPU, Pallas in interpret mode).

The smoke config keeps the family's structure at small widths: 2 encoder
and 2 decoder layers, d 64, 4 heads of 16 (kv 4), 8 frames, layernorm,
gelu, a qkv bias, tied embeddings. The bias, layernorm and norm-scale
leaves are drawn at random (both sides get the same numbers), so a leaf
that does not reach its layer shows. Frames are one numpy draw carried into
both packages (the stubs' own draws are not compared).

* The configs: field for field equal to the reference's, full and smoke;
  the init tree has the reference's layout, ``"encoder"`` and ``xattn``
  included, and the cache its ``cross_kv``.
* ``encode`` (non-causal self-attention: K4's plain version against the
  reference's flash kernel, at the smoke's 8 frames and a ragged 13) and
  ``make_cross_kv``; the full forward with frames (flash and naive), at
  tests/test_kernels.py:40's f32 tolerances (rtol 1e-4, atol 1e-3 *
  max(1, k // 64)).
* ``prefill(frames=)`` then decode steps against the reference's, under
  the default provider, FFIP and int8 FFIP, and against the port's own
  full forward.
* The loss and every gradient leaf against ``jax.value_and_grad`` (loss
  rtol 1e-5, each leaf rtol 1e-3, atol 1e-3 * max|leaf|, as
  tests/test_torch_train.py holds the dense model).
* The batcher's bucket rule from the cache's shapes, as the reference's:
  whisper's cross K/V has no sequence axis, so it takes the scatter
  prefill. ``BatchServer`` tokens identical to the reference's (float at
  decode_chunk 1 and 4, int8 once), over the zeroed cross K/V of a fresh
  cache, as the reference serves it.
* The launchers: serve takes ``--arch whisper-small``; paged serving and
  training without frames raise, as they do in the reference.
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
from repro.serve.batcher import _cache_supports_buckets as j_buckets
from repro_torch import configs
from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serve.batcher import BatchServer, Request
from repro_torch.serve.batcher import _cache_supports_buckets
from test_torch_families import B, CASES, MAX_LEN, _bar, _np, _setup
from test_torch_serve_families import _run

ARCH = "whisper-small"
S = 12


def _frames(cfg, seed=0, n=0):
    """(B, n or n_frames, d) frame embeddings, one numpy draw for both."""
    n = n or cfg.encoder.n_frames
    return np.random.default_rng(seed).normal(
        0.0, 0.5, (B, n, cfg.d_model)).astype(np.float32)


def _tokens(vocab, seed=0, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (B, s))


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        out.update(_shapes(v, key) if isinstance(v, dict)
                   else {key: tuple(v.shape)})
    return out


def test_config_matches_reference():
    for tc, jc in ((configs.get_config(ARCH), jcfg.get_config(ARCH)),
                   (configs.smoke_config(configs.get_config(ARCH)),
                    jcfg.smoke_config(jcfg.get_config(ARCH)))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
    tc = configs.get_config(ARCH)
    assert T.layer_plan(tc) == JT.layer_plan(jcfg.get_config(ARCH)) == [
        ("layers", "encdec", 12)]
    assert (tc.encoder.n_layers, tc.encoder.n_frames) == (12, 1500)


def test_init_tree_and_cache_match_reference_layout():
    """The port's own init has the reference's leaves and shapes (the
    encoder's stacked layers and norm, each decoder layer's ``ln_x`` and
    ``xattn``), the bridge carries every leaf, and the cache holds
    ``cross_kv`` of (L, B, n_frames, KV, hd)."""
    jc, jm, jp, tc, tm, tp = _setup(ARCH)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in flat}
    assert _shapes(tm.init(0)) == want
    assert _shapes(tp) == want
    assert {"['encoder']['layers']['attn']['wq']['b']",
            "['encoder']['norm']['bias']", "['layers']['ln_x']['scale']",
            "['layers']['xattn']['wk']['w']"} <= set(want)
    assert not any("xattn" in n for n in want if n.startswith("['encoder']"))
    cache = tm.init_cache(3, 12)
    assert _shapes(cache) == _shapes(jax.tree.map(np.asarray,
                                                  jm.init_cache(3, 12)))
    assert cache["cross_kv"]["k"].shape == (2, 3, 8, 4, 16)


@pytest.mark.parametrize("n_frames", [8, 13])
@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_encode_and_cross_kv_match_reference(impl, n_frames):
    """The encoder (non-causal, rope at 0..T-1; K4's plain version against
    the reference's flash kernel in interpret mode, 13 frames leaving a
    ragged block) and each decoder layer's cross K/V."""
    jc, jm, jp, tc, tm, tp = _setup(ARCH, impl)
    frames = _frames(tc, 3, n_frames)
    jenc = JT.encode(jp, jnp.asarray(frames), jc)
    jkv = JT.make_cross_kv(jp["layers"], jenc, jc)
    with torch.no_grad():
        enc = T.encode(tp, torch.from_numpy(frames), tc)
        kv = T.make_cross_kv(tp["layers"], enc, tc)
    _bar(enc, jenc)
    for k in ("k", "v"):
        assert kv[k].shape == (2, B, n_frames, 4, 16)
        _bar(kv[k], jkv[k])


@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_forward_with_frames_matches_reference(impl):
    """The full forward (training's: cross attention against the encoder
    states): hidden states and logits."""
    jc, jm, jp, tc, tm, tp = _setup(ARCH, impl)
    tokens, frames = _tokens(jc.vocab), _frames(tc)
    jh, jaux, _ = JT.forward(jp, jnp.asarray(tokens), jc,
                             frames=jnp.asarray(frames))
    with torch.no_grad():
        h, aux, _ = T.forward(tp, torch.from_numpy(tokens), tc,
                              frames=torch.from_numpy(frames))
        logits = T.logits_fn(tp, h, tc)
        # the frames reach the tokens
        other, _, _ = T.forward(tp, torch.from_numpy(tokens), tc,
                                frames=torch.from_numpy(_frames(tc, 9)))
    _bar(h, jh)
    _bar(logits, JT.logits_fn(jp, jh, jc), k=tc.d_model)
    assert float(aux) == 0.0
    assert float((other - h).abs().max()) > 1e-2


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(case):
    """prefill(frames=) (the encoder, the cross K/V into the cache, the
    prompt through K4's plain version) and three decode steps at per-slot
    positions reading the cached cross K/V, against the reference's under
    the same GEMM provider; under the default provider each step's logits
    also equal the port's own full forward over the prompt and the fed
    tokens."""
    from repro.core import quant as jquant
    from repro_torch.core import quant

    jc, jm, jp, tc, tm, tp = _setup(ARCH)
    jkw, tkw, tol = CASES[case]
    if jkw.get("quantized"):
        jp = jquant.attach_quantized_weights(jp)
        tp = quant.attach_quantized_weights(tp)
    tokens, frames = _tokens(jc.vocab, 1), _frames(tc, 4)
    feed = np.random.default_rng(2).integers(0, jc.vocab, (B, 3))
    pos = np.array([S, S], np.int32)
    with j_use_gemm(JGemm(**jkw)):
        jcache, jlog = jm.prefill(jp, jnp.asarray(tokens),
                                  jm.init_cache(B, MAX_LEN),
                                  frames=jnp.asarray(frames))
        jdecs = []
        for i in range(feed.shape[1]):
            jcache, jd = jm.decode_step(jp, jnp.asarray(feed[:, i:i + 1],
                                                        jnp.int32),
                                        jcache, jnp.asarray(pos + i))
            jdecs.append(jd)
    with use_gemm(GemmConfig(**tkw)), torch.no_grad():
        cache, log = tm.prefill(tp, torch.from_numpy(tokens),
                                tm.init_cache(B, MAX_LEN),
                                frames=torch.from_numpy(frames))
        for k in ("k", "v"):
            _bar(cache["cross_kv"][k], jcache["cross_kv"][k])
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
                                frames=torch.from_numpy(frames))
            want = T.logits_fn(tp, h, tc)
        for i, got in enumerate([log] + decs):
            _bar(got.reshape(B, -1), want[:, S - 1 + i], k=tc.d_model)


def test_loss_and_grads_match_reference():
    """Model.loss(frames=) and every gradient leaf (the encoder's, the cross
    attention's and the frames' own) through the flash Function (K4 + K8's
    plain versions, non-causal in the encoder), against jax.value_and_grad
    of the reference."""
    jc, jm, jp, tc, tm, tp = _setup(ARCH)
    batch = {"tokens": _tokens(jc.vocab, 6), "labels": _tokens(jc.vocab, 7),
             "frames": _frames(tc, 8)}

    def jloss_fn(params, frames):
        return jm.loss(params, {"tokens": jnp.asarray(batch["tokens"]),
                                "labels": jnp.asarray(batch["labels"]),
                                "frames": frames})

    jloss, (jgrads, jgf) = jax.value_and_grad(jloss_fn, argnums=(0, 1))(
        jp, jnp.asarray(batch["frames"]))
    params = adamw.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    frames = torch.from_numpy(batch["frames"]).requires_grad_(True)
    leaves = adamw.tree_leaves(params)
    loss = tm.loss(params, {"tokens": torch.from_numpy(batch["tokens"]),
                            "labels": torch.from_numpy(batch["labels"]),
                            "frames": frames})
    grads = torch.autograd.grad(loss, leaves + [frames])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jgrads)]
    want.append(np.asarray(jgf))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max())
        assert np.abs(w).max() > 0


@pytest.mark.parametrize("arch", ["whisper-small", "pixtral-12b",
                                  "minicpm-2b", "falcon-mamba-7b"])
def test_bucket_rule_reads_the_cache_shapes_as_the_reference(arch):
    """Bucketed prefill iff every cache leaf has a sequence axis: whisper's
    cross K/V and falcon's SSM state have none (scatter prefill); pixtral's
    and minicpm's K/V do."""
    from repro.models.model import build_model as j_build
    from repro_torch.models.model import Model
    tc = configs.smoke_config(configs.get_config(arch))
    jc = jcfg.smoke_config(jcfg.get_config(arch))
    want = j_buckets(j_build(jc), 2, MAX_LEN)
    assert want == (arch in ("pixtral-12b", "minicpm-2b"))
    tm = Model(tc, device="cpu")
    assert _cache_supports_buckets(tm, 2, MAX_LEN) == want
    assert BatchServer(tm, batch_slots=2, max_len=MAX_LEN,
                       device="cpu")._bucketed == want


def _workload(vocab, n=5, seed=7):
    """Slot churn on 2 slots, one request finishing at prefill."""
    rng = np.random.default_rng(seed)
    lens, budgets = [12, 9, 21, 10, 17][:n], [5, 1, 4, 6, 3][:n]
    return [(rng.integers(0, vocab, size=(k,)), m)
            for k, m in zip(lens, budgets)]


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "int8-ffip"])
def test_server_tokens_match_reference(quantized):
    """Contiguous, every prompt in its own scatter-prefill dispatch over the
    zeroed cross K/V of a fresh cache: the reference server's tokens, at
    decode_chunk 1 and 4 (float), and int8 FFIP once on shorter work."""
    jc, jm, jp, tc, tm, tp = _setup(ARCH)
    reqs = _workload(tc.vocab, n=3 if quantized else 5)
    want = _run(JServer(jm, batch_slots=2, max_len=MAX_LEN,
                        quantized=quantized), reqs, jp, JRequest)
    impl = "cuda" if quantized else None
    chunks = (1,) if quantized else (1, 4)
    for c in chunks:
        srv = BatchServer(tm, batch_slots=2, max_len=MAX_LEN, device="cpu",
                          quantized=quantized, gemm_impl=impl,
                          decode_chunk=c)
        got = _run(srv, reqs, tp, Request)
        assert got == want
        assert srv.stats["prefill_dispatches"] == len(reqs)
    for i, (_, budget) in enumerate(reqs):
        assert len(want[i]) == budget


def test_launchers_take_whisper(capsys):
    launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--slots", "2", "--requests", "4", "--max-new", "3",
                       "--gemm-impl", "cuda", "--max-len", "48"])
    out = capsys.readouterr().out
    assert "4/4 requests" in out and out.rstrip().endswith("OK")
    with pytest.raises(ValueError, match="pure-attention decoder"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--paged"])
    # the launcher passes no frames, as the reference's (whose forward
    # then fails on caches=None)
    with pytest.raises(ValueError, match="frames="):
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "1", "--batch", "2", "--seq", "16"])
