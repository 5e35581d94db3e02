"""The port's Mamba1 path against the reference: the selective scan K6 (its
plain version), the mixer, the falcon-mamba-7b smoke model and its serving.

Inputs come from numpy with a seed; weights are the reference's, carried
across by repro_torch.bridge. The reference runs as its own tests run it
(JAX on the CPU, its Pallas kernels in interpret mode); the port runs on CPU
tensors, so every kernel wrapper takes its plain version.

Bars:
- K6: y, h_final and h_starts within rtol = atol = 1e-4 in f32, as
  tests/test_selective_scan.py holds the reference kernel; bf16 y within one
  bf16 ulp of the reference's (both round an f32 sum, taken in another
  order, once).
- The mixer and the model in f32: rtol = atol = 1e-4 (equally exact sums in
  other orders); in bf16 a few bf16 ulps (BF16_TOL): every op rounds to
  bf16, and XLA may keep a fused chain in f32 where PyTorch rounds each op.
- int8 logits: tests/test_torch_model.py's 5e-2 (an activation on a
  quantization boundary rounds one int8 step apart); the argmax equal.
- Serving: identical token streams.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import quant as jquant
from repro.core.gemm import GemmConfig as JGemm
from repro.core.gemm import use_gemm as j_use_gemm
from repro.kernels.selective_scan import selective_scan as j_scan
from repro.models import ssm as JS
from repro.models.model import build_model as j_build
from repro.serve.batcher import BatchServer as JServer
from repro.serve.batcher import Request as JRequest
from repro_torch import bridge, configs
from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.kernels import selective_scan as ssk
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.serve.batcher import BatchServer, Request, _leaves
from repro_torch.serve.lifecycle import AdmissionImpossibleError

ARCH = "falcon-mamba-7b"
BF16_TOL = 2.0 ** -6      # four bf16 ulps at 1
MAX_LEN = 64
SLOTS = 2


def _np(x):
    return np.asarray(x, np.float64)


def _scan_inputs(bt, s, di, n, seed=0):
    """tests/test_selective_scan.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bt, s, di)) - 1)).astype(
        np.float32)
    b = rng.standard_normal((bt, s, n)).astype(np.float32)
    c = rng.standard_normal((bt, s, n)).astype(np.float32)
    a = (-np.exp(rng.standard_normal((di, n)) * 0.3)).astype(np.float32)
    h0 = (rng.standard_normal((bt, di, n)) * 0.1).astype(np.float32)
    return x, dt, b, c, a, h0


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# --- K6: the plain version against the reference kernel ----------------------

@pytest.mark.parametrize("bt,s,di,n,chunk,bd", [
    (2, 32, 16, 8, 8, 8),
    (1, 64, 32, 16, 16, 16),
    (2, 16, 8, 4, 16, 8),    # single chunk
])
def test_scan_plain_matches_reference(bt, s, di, n, chunk, bd):
    args = _scan_inputs(bt, s, di, n)
    jy, jh, jstarts = j_scan(*map(jnp.asarray, args), chunk=chunk, bd=bd,
                             interpret=True)
    y, h, starts = ssk.selective_scan_plain(*_torch(*args), chunk=chunk,
                                            bd=bd)
    assert starts.shape == (bt, s // min(chunk, s), di, n)
    assert starts.dtype == torch.float32
    for got, want in ((y, jy), (h, jh), (starts, jstarts)):
        _close(got, want, 1e-4)
    # the wrapper takes the plain version for CPU tensors, counting nothing
    before = ssk.counter.n
    y2, h2, s2 = ssk.selective_scan(*_torch(*args), chunk=chunk, bd=bd)
    assert ssk.counter.n == before
    assert torch.equal(y2, y) and torch.equal(h2, h) and torch.equal(s2,
                                                                      starts)


def test_scan_plain_bf16_matches_reference():
    """bf16 x/dt/B/C, f32 A and h0, as mamba1_apply calls it: y in bf16
    within one ulp, the f32 state within the f32 bar."""
    x, dt, b, c, a, h0 = _scan_inputs(1, 32, 32, 16, seed=3)
    jbf = [jnp.asarray(v).astype(jnp.bfloat16) for v in (x, dt, b, c)]
    jy, jh, jstarts = j_scan(*jbf, jnp.asarray(a), jnp.asarray(h0), chunk=8,
                             bd=16, interpret=True)
    tbf = [bridge.params_from_numpy(np.asarray(v)) for v in jbf]
    assert all(t.dtype == torch.bfloat16 for t in tbf)
    y, h, starts = ssk.selective_scan_plain(*tbf, *_torch(a, h0), chunk=8,
                                            bd=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    want = torch.from_numpy(np.asarray(jy.astype(jnp.float32)))
    _, e = torch.frexp(want.abs().clamp_min(2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(want), e - 8)   # bf16 spacing at want
    assert float(((y.float() - want).abs() / ulp).max()) <= 1.0
    _close(h, jh, 1e-4)
    _close(starts, jstarts, 1e-4)


def test_scan_state_carries_across_calls():
    """h_final of one call feeds the next and equals one call over both
    halves (the streaming contract), in the port and against the
    reference's single call."""
    x, dt, b, c, a, h0 = _scan_inputs(1, 32, 8, 4, seed=1)
    tx, tdt, tb, tc, ta, th0 = _torch(x, dt, b, c, a, h0)
    y_full, h_full, _ = ssk.selective_scan_plain(tx, tdt, tb, tc, ta, th0,
                                                 chunk=8, bd=8)
    y1, h1, _ = ssk.selective_scan_plain(tx[:, :16], tdt[:, :16], tb[:, :16],
                                         tc[:, :16], ta, th0, chunk=8, bd=8)
    y2, h2, _ = ssk.selective_scan_plain(tx[:, 16:], tdt[:, 16:], tb[:, 16:],
                                         tc[:, 16:], ta, h1, chunk=8, bd=8)
    _close(torch.cat([y1, y2], 1), y_full, 1e-4)
    _close(h2, h_full, 1e-4)
    jy, jh, _ = j_scan(*map(jnp.asarray, (x, dt, b, c, a, h0)), chunk=8,
                       bd=8, interpret=True)
    _close(torch.cat([y1, y2], 1), jy, 1e-4)
    _close(h2, jh, 1e-4)


def test_scan_errors():
    x, dt, b, c, a, h0 = _torch(*_scan_inputs(1, 12, 8, 4))
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        ssk.selective_scan(x, dt, b, c, a, h0, chunk=8, bd=8)
    with pytest.raises(ValueError, match="d_inner"):
        ssk.selective_scan(x, dt, b, c, a, h0, chunk=4, bd=3)
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        ssk.selective_scan(x, dt, b, c, a, h0, chunk=4, bd=8)


# --- the mixer -------------------------------------------------------------

def _smoke(dtype="float32"):
    jc = dataclasses.replace(jcfg.smoke_config(jcfg.get_config(ARCH)),
                             param_dtype=dtype)
    cfg = dataclasses.replace(configs.smoke_config(configs.get_config(ARCH)),
                              param_dtype=dtype)
    return jc, cfg


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    st = rng.standard_normal((2, 3, 16)).astype(np.float32)
    jy, jst = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(st) if with_state else None)
    y, new = S._causal_conv(*_torch(x, w),
                            torch.from_numpy(st) if with_state else None)
    _close(y, jy, 1e-6)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jst))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [16, 1])
def test_mamba1_apply_matches_reference(dtype, s):
    """Both branches (K6 at S > 1, the plain f32 scan at S = 1) from a
    nonzero cache, output and updated cache, in f32 and bf16."""
    jc, cfg = _smoke(dtype)
    jp = JS.mamba1_init(jax.random.PRNGKey(1), jc, jc.dtype)
    di = jc.ssm.expand * jc.d_model
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, s, jc.d_model))).astype(jc.dtype)
    jcache = {"conv": jnp.asarray(rng.standard_normal(
                  (2, jc.ssm.d_conv - 1, di))).astype(jc.dtype),
              "ssm": jnp.asarray(rng.standard_normal(
                  (2, di, jc.ssm.d_state)) * 0.1, jnp.float32)}
    jout, jnew = JS.mamba1_apply(jp, x, cfg=jc, cache=jcache, prefill=True)
    p = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    cache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache))
    with torch.no_grad():
        out, new = S.mamba1_apply(p, bridge.params_from_numpy(np.asarray(x)),
                                  cfg=cfg, cache=cache, prefill=True)
    assert new is cache and out.dtype == cfg.dtype
    tol = 1e-4 if dtype == "float32" else BF16_TOL
    _close(out.float(), jnp.asarray(jout, jnp.float32), tol)
    _close(new["ssm"], jnew["ssm"], tol)
    _close(new["conv"].float(), jnp.asarray(jnew["conv"], jnp.float32), tol)


def test_mamba1_without_cache_and_not_prefill():
    """No cache: the output alone. A forward that is not a prefill keeps
    the cache's state (the reference's trainable branch) and still gives
    the prefill's output."""
    jc, cfg = _smoke()
    jp = JS.mamba1_init(jax.random.PRNGKey(2), jc, jc.dtype)
    x = np.random.default_rng(6).standard_normal((1, 8, jc.d_model)).astype(
        np.float32)
    jout, _ = JS.mamba1_apply(jp, jnp.asarray(x), cfg=jc)
    p = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    with torch.no_grad():
        out, none = S.mamba1_apply(p, torch.from_numpy(x), cfg=cfg)
        cache = T.init_cache(cfg, 1, 8, device="cpu")["layers"]
        one = {k: v[0] for k, v in cache.items()}
        out2, _ = S.mamba1_apply(p, torch.from_numpy(x), cfg=cfg, cache=one)
    assert none is None
    _close(out, jout, 1e-4)
    _close(out2, jout, 1e-4)
    assert not one["ssm"].any() and one["conv"].any()
    with pytest.raises(NotImplementedError, match="item 15"):
        S._selective_scan_fused(*[None] * 6, 8, mesh=object())


# --- the model -------------------------------------------------------------

B, SEQ = 2, 16


@pytest.fixture(scope="module")
def smoke_model():
    jc, cfg = _smoke()
    jm = j_build(jc)
    jparams = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, jc.vocab, (B, SEQ))
    return jc, jm, jparams, cfg, Model(cfg, device="cpu"), tokens


MODEL_CASES = {
    "default": (dict(), dict(), 1e-4),
    "ffip-kernels": (dict(algo="ffip", impl="pallas"),
                     dict(algo="ffip", impl="cuda"), 1e-4),
    "int8-ffip": (dict(algo="ffip", impl="pallas", quantized=True),
                  dict(algo="ffip", impl="cuda", quantized=True), 5e-2),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_prefill_and_decode_logits(smoke_model, case):
    jc, jm, jparams, cfg, m, tokens = smoke_model
    jkw, tkw, tol = MODEL_CASES[case]
    if jkw.get("quantized"):
        jparams = jquant.attach_quantized_weights(jparams)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    pos = np.array([SEQ, SEQ], np.int32)
    nxt = np.array([[5], [7]], np.int64)
    with j_use_gemm(JGemm(**jkw)):
        jcache, jlog = jm.prefill(jparams, jnp.asarray(tokens),
                                  jm.init_cache(B, MAX_LEN))
        _, jdec = jm.decode_step(jparams, jnp.asarray(nxt, jnp.int32),
                                 jcache, jnp.asarray(pos))
    with use_gemm(GemmConfig(**tkw)), torch.no_grad():
        cache, log = m.prefill(params, torch.from_numpy(tokens),
                               m.init_cache(B, MAX_LEN))
        _close(cache["layers"]["ssm"], jcache["layers"]["ssm"], tol)
        _, dec = m.decode_step(params, torch.from_numpy(nxt), cache,
                               torch.from_numpy(pos))
    for got, want in ((log, jlog), (dec, jdec)):
        _close(got, want, tol)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))


def test_bridge_carries_ssm_tree_and_cache(smoke_model):
    """The reference's SSM parameter tree and a prefilled cache cross
    unchanged: same keys, shapes, dtypes and bits; the port decodes from
    the carried cache to the reference's logits."""
    jc, jm, jparams, cfg, m, tokens = smoke_model
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    mine = m.init(0)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == len(jax.tree.leaves(mine))
    for path, leaf in flat_j:
        node_t, node_m = params, mine
        for key in path:
            node_t, node_m = node_t[key.key], node_m[key.key]
        np.testing.assert_array_equal(node_t.numpy(), np.asarray(leaf))
        assert node_t.shape == node_m.shape and node_t.dtype == node_m.dtype
    jcache, _ = jm.prefill(jparams, jnp.asarray(tokens),
                           jm.init_cache(B, MAX_LEN))
    nxt = np.array([[3], [9]], np.int64)
    pos = np.array([SEQ, SEQ], np.int32)
    _, jdec = jm.decode_step(jparams, jnp.asarray(nxt, jnp.int32), jcache,
                             jnp.asarray(pos))
    cache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache))
    ref = m.init_cache(B, MAX_LEN)
    for k in ("conv", "ssm"):
        assert cache["layers"][k].shape == ref["layers"][k].shape
        assert cache["layers"][k].dtype == ref["layers"][k].dtype
    with torch.no_grad():
        _, dec = m.decode_step(params, torch.from_numpy(nxt), cache,
                               torch.from_numpy(pos))
    _close(dec, jdec, 1e-4)


def test_sample_steps_chunk_matches_stepping(smoke_model):
    """A fused 4-step decode with a slot that finishes after one step gives
    the tokens of stepping one at a time, and the live slot's state."""
    jc, jm, jparams, cfg, m, tokens = smoke_model
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    with torch.no_grad():
        cache, log = m.prefill(params, torch.from_numpy(tokens),
                               m.init_cache(B, MAX_LEN))
        c1 = {k: v.clone() for k, v in cache["layers"].items()}
        first = log.argmax(-1).to(torch.int32)
        pos = torch.full((B,), SEQ)
        rem = torch.tensor([4, 1])
        live = torch.ones(B, dtype=torch.bool)
        eos = torch.full((B,), -1)
        cache, toks = m.sample_steps(params, first, cache, pos, live, rem,
                                     eos, steps=4)
        step_cache = {"layers": c1}
        tok, want = first, []
        for i in range(4):
            step_cache, nxt = m.sample_step(params, tok[:, None], step_cache,
                                            pos + i)
            want.append(nxt)
            tok = nxt
    assert toks[:, 0].tolist() == [int(t[0]) for t in want]
    assert int(toks[0, 1]) == int(want[0][1])
    for k in ("conv", "ssm"):
        assert torch.equal(cache["layers"][k][:, 0],
                           step_cache["layers"][k][:, 0])


# --- serving ---------------------------------------------------------------

def _serve_prompts(vocab):
    """Prompts within the reference's scan contract (S <= the smoke chunk of
    8, or a multiple of it), and one max_len prompt at the cache_rows
    boundary."""
    rng = np.random.default_rng(0)
    lens = [3, 8, 5, 16, 7, 24, 4]
    reqs = [(rng.integers(0, vocab, size=(n,)), 4) for n in lens]
    return reqs + [(rng.integers(0, vocab, size=(MAX_LEN,)), 1)]


@pytest.fixture(scope="module")
def serve_workload():
    jc, _ = _smoke()
    jm = j_build(jc)
    jparams = jm.init(jax.random.PRNGKey(0))
    reqs = _serve_prompts(jc.vocab)
    want = {}
    for quantized in (False, True):
        srv = JServer(jm, batch_slots=SLOTS, max_len=MAX_LEN,
                      quantized=quantized, gemm_impl="pallas",
                      decode_chunk=4)
        for i, (p, n) in enumerate(reqs):
            srv.submit(JRequest(rid=i, prompt=p, max_new_tokens=n))
        want[quantized] = {r.rid: list(r.out_tokens)
                           for r in srv.run_until_drained(jparams)}
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return reqs, params, want


def _serve(params, reqs, **kw):
    _, cfg = _smoke()
    srv = BatchServer(Model(cfg, device="cpu"), batch_slots=SLOTS,
                      max_len=MAX_LEN, device="cpu", **kw)
    for i, (p, n) in enumerate(reqs):
        srv.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    return srv, {r.rid: list(r.out_tokens)
                 for r in srv.run_until_drained(params)}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_server_tokens_match_reference(serve_workload, quantized,
                                       decode_chunk):
    reqs, params, want = serve_workload
    srv, got = _serve(params, reqs, gemm_impl="cuda", quantized=quantized,
                      decode_chunk=decode_chunk)
    assert got == want[quantized]
    assert all(len(got[i]) == n for i, (_, n) in enumerate(reqs))
    # every prompt took the per-slot scatter prefill
    assert not srv._bucketed
    assert srv.stats["prefill_dispatches"] == len(reqs)


def test_cache_layout_picks_the_scatter_prefill():
    _, cfg = _smoke()
    ssm = Model(cfg, device="cpu")
    dense = Model(configs.smoke_config(configs.get_config("minicpm-2b")),
                  device="cpu")
    assert not BatchServer(ssm, batch_slots=3, max_len=16,
                           device="cpu")._bucketed
    assert BatchServer(dense, batch_slots=3, max_len=16,
                       device="cpu")._bucketed
    # the scatter prefill copies along axis 1: (L, B, W-1, di), (L, B, di,
    # N) and (L, B, S, KV, hd) differ there, and only there, with the batch
    for model in (ssm, dense):
        for a, b in zip(_leaves(model.init_cache(2, 16)),
                        _leaves(model.init_cache(3, 16))):
            assert [i for i in range(a.dim())
                    if a.shape[i] != b.shape[i]] == [1]


def test_dense_scatter_prefill_matches_buckets():
    """prefill_buckets=False sends a dense model through the same scatter
    prefill, with the tokens of the bucketed one."""
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    model = Model(cfg, device="cpu")
    params = model.init(0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (3, 9, 5)]
    out = {}
    for buckets in (True, False):
        srv = BatchServer(model, batch_slots=SLOTS, max_len=32,
                          device="cpu", prefill_buckets=buckets)
        for i, p in enumerate(prompts):
            srv.submit(Request(rid=i, prompt=p, max_new_tokens=3))
        out[buckets] = {r.rid: r.out_tokens
                        for r in srv.run_until_drained(params)}
        assert srv._bucketed == buckets
    assert out[True] == out[False]


def test_ssm_serving_errors():
    _, cfg = _smoke()
    model = Model(cfg, device="cpu")
    with pytest.raises(ValueError, match="pure-attention"):
        BatchServer(model, batch_slots=2, max_len=64, device="cpu",
                    paged=True)
    srv = BatchServer(model, batch_slots=2, max_len=64, device="cpu")
    with pytest.raises(AdmissionImpossibleError):
        srv.submit(Request(rid=0, prompt=np.arange(64), max_new_tokens=2))
    # a prompt longer than the scan chunk and not a multiple of it is
    # outside the reference's contract, which the port keeps
    srv.submit(Request(rid=1, prompt=np.arange(9), max_new_tokens=2))
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        srv.run_until_drained(model.init(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    for other in (dataclasses.replace(cfg, ssm=dataclasses.replace(
                      cfg.ssm, version=2)),
                  dataclasses.replace(cfg, family="hybrid")):
        with pytest.raises(NotImplementedError, match="zamba2"):
            T.layer_plan(other)


def test_launch_serve_ssm_on_cpu(capsys):
    from repro_torch.launch import serve as launch
    launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--slots",
                 "2", "--requests", "6", "--max-new", "4", "--gemm-impl",
                 "cuda", "--prompt-len", "3,9"])
    out = capsys.readouterr().out
    assert "6/6 requests / 24 tokens" in out
    assert "6 dispatches" in out
    assert out.rstrip().endswith("OK")
