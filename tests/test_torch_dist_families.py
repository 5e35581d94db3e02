"""Tensor-parallel serving of the other six families, their frontend entry
points and the router's replicas on a mesh, on two gloo ranks on the CPU,
against single-device serving: gemma3-4b (local:global windows, a
per-layer rope theta, head_dim 16 on half the heads), mixtral-8x22b (GQA +
MoE, a window on every layer, in its config's "ffn" partition and the
"expert" one), starcoder2-3b (layernorm, gelu, the qkv and layernorm
biases, 2 KV heads: one a rank), deepseek-coder-33b, pixtral-12b (text
only, as the launcher serves it, and behind its patches) and whisper-small
(the decoder over a fresh cache's zeroed cross K/V, and through its
encoder and cross attention), each on its smoke config with the
reference's weights carried across by repro_torch.bridge and every bias,
layernorm bias and norm scale drawn at random (tests/test_torch_families.py's
setup), so a leaf that reaches its layer twice, or not at all, shows.

* ``BatchServer(mesh=)``, float: the tp-2 tokens equal the reference's
  single-device ``BatchServer`` tokens and the port's own single device's,
  on both ranks; int8 FFIP (``gemm_impl="cuda"``, the kernels' plain
  versions here): equal to the port's single device (the reference's
  interpret-mode int8 server costs a minute a case);
* the ranks served their pieces: every column-parallel projection (the
  encoder's and the cross attention's too) at half its width, every
  row-parallel one at half its rows, the biases and norms whole, the KV
  cache, the cross K/V cache and mixtral's banks cut as their partition
  reads them;
* the serving specs at the production mesh's tp 16, on the meta device:
  heads that do not divide it kept whole (whisper's 12, gemma3's 8) with
  their cache, and whisper's odd vocab whole under the guard at every tp;
* the frontend entry on a mesh (``repro_torch.dist.parity.frontend_run``:
  ``Model.prefill(frames=)``, whisper's non-causal encoder on a rank's
  heads, every decoder layer's cross K/V of those heads cached and the
  cross attention's ``wo`` row-parallel; ``prefill(patches=)``, pixtral's
  prefix), then greedy decode steps: float against the reference's
  ``Model.prefill`` and ``decode_step`` on the same numpy inputs, tokens
  equal and logits within tests/test_kernels.py:40's f32 bar (rtol 1e-4,
  atol 1e-3 * max(1, d // 64)); int8 FFIP against the port's single
  device, tokens equal and logits within the same bar;
* the router on the mesh (``launch.serve.router_job``: whisper-small, two
  replicas, one of them int8, under the flaky fault plan): every request
  DONE with its tier's no-fault tokens, no unplanned failure, the ranks'
  router events, outcomes and tokens equal; on a one-rank mesh without a
  fault plan it runs on a FakeClock, and a tier's replicas share one
  preparation and its one cut (``PreparedModel.shard`` returns the same
  cut for the same mesh and specs).

The ranks are spawned once for every case while this process runs the
reference and the port on one device (the ``tp_runs`` pattern of
tests/test_torch_dist_serve.py).
"""
import argparse
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_jobs as jobs
from repro.serve.batcher import BatchServer as JServer
from repro.serve.batcher import Request as JRequest
from repro_torch import configs, prepare
from repro_torch.dist import context as dctx
from repro_torch.dist import parity, sharding
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import Model
from repro_torch.serve.faults import FakeClock
from test_torch_families import _np, _setup

ARCHS = ("gemma3-4b", "mixtral-8x22b", "starcoder2-3b", "deepseek-coder-33b",
         "pixtral-12b", "whisper-small")
FRONTENDS = ("whisper-small", "pixtral-12b")
MAX_LEN = 48
MAX_NEW = 4
B, S, STEPS = 2, 12, 3
INT8 = dict(quantized=True, gemm_impl="cuda", gemm_algo="ffip")
CASES = [(a, tier, part) for a in ARCHS for tier in ("float", "int8")
         for part in (("ffn", "expert") if a == "mixtral-8x22b"
                      else ("expert",))]
ROUTER_ARGS = dict(replicas=2, quantized_replicas=1, quantized=False,
                   fault_plan="flaky", deadline_ms=None, slo=None,
                   slo_windows="5,30", slo_min_count=3, slo_drain_ticks=0,
                   max_new=3, paged=False)


def _ids(case):
    return "-".join(case)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread keeps them from contending
    with the other test workers' threads (each rank takes one too)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prompts(vocab):
    """Every prompt past the smoke window of 8."""
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=(n,)) for n in (12, 9, 21)]


def _router_prompts():
    """Six requests: enough dispatches for the flaky plan's faults."""
    rng = np.random.default_rng(5)
    return [rng.integers(0, 512, size=(n,)) for n in (12, 9, 21, 5, 14, 7)]


def _ref(jm, jp, prompts):
    srv = JServer(jm, batch_slots=2, max_len=MAX_LEN)
    for i, p in enumerate(prompts):
        srv.submit(JRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    return {r.rid: list(r.out_tokens) for r in srv.run_until_drained(jp)}


def _single(tm, tp, prompts, kw):
    _, done, _ = launch_serve.serve(tm, tp, prompts, max_new=MAX_NEW,
                                    batch_slots=2, max_len=MAX_LEN, **kw)
    return {r.rid: list(r.out_tokens) for r in done}


def _front_inputs(cfg):
    """(tokens, {"frames" or "patches": (B, n, d)}), one numpy draw for
    both packages."""
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    n = cfg.encoder.n_frames if cfg.encoder else cfg.frontend_tokens
    extra = rng.normal(0.0, 0.5, (B, n, cfg.d_model)).astype(np.float32)
    return tokens, {"frames" if cfg.encoder else "patches": extra}


def _front_reference(arch):
    """The reference's greedy prefill + STEPS decode steps: (tokens, the
    prefill's logits, the last step's)."""
    _, jm, jp, tc, _, _ = _setup(arch)
    tokens, extra = _front_inputs(tc)
    cache, logits = jm.prefill(jp, jnp.asarray(tokens),
                               jm.init_cache(B, MAX_LEN),
                               **{k: jnp.asarray(v) for k, v in extra.items()})
    first = logits
    pos = S + (tc.frontend_tokens if "patches" in extra else 0)
    tok = np.asarray(logits).argmax(-1)
    out = [tok]
    for i in range(STEPS):
        cache, logits = jm.decode_step(
            jp, jnp.asarray(tok[:, None], jnp.int32), cache,
            jnp.full((B,), pos + i, jnp.int32))
        tok = np.asarray(logits).argmax(-1)
        out.append(tok)
    return np.stack(out, 1).tolist(), first, logits


@pytest.fixture(scope="module")
def tp_runs():
    """{case: (rank 0's result, rank 1's, what it is held to)}, every case
    on one spawn of two ranks: the served cases with the reference's float
    tokens and the port's single-device tokens, the frontend cases
    (``(arch, "frontend", tier)``) with the reference's greedy run (float)
    or the port's single device (int8), and ``"router"``."""
    keys, job_list, wants = [], [], []
    for arch, tier, part in CASES:
        _, _, _, tc, _, tp = _setup(arch)
        kw = dict(INT8 if tier == "int8" else {}, moe_partition=part,
                  batch_slots=2, max_len=MAX_LEN)
        keys.append((arch, tier, part))
        job_list.append((jobs.serve_pieces, dict(
            cfg=tc, params=tp, prompts=_prompts(tc.vocab), max_new=MAX_NEW,
            server_kw=kw)))
    for arch in FRONTENDS:
        _, _, _, tc, _, tp = _setup(arch)
        tokens, extra = _front_inputs(tc)
        for tier in ("float", "int8"):
            keys.append((arch, "frontend", tier))
            job_list.append((parity.frontend_run, dict(
                cfg=tc, rows=B, prompt=S, steps=STEPS,
                quantized=tier == "int8", params=tp, tokens=tokens,
                **extra)))
    keys.append("router")
    job_list.append((launch_serve.router_job, dict(
        arch="whisper-small", smoke=True, prompts=_router_prompts(),
        router_args=ROUTER_ARGS,
        server_kw=dict(batch_slots=2, max_len=MAX_LEN, gemm_impl="cuda"))))
    ranks = {}

    def spawn():
        try:
            ranks["out"] = launch_serve.spawn_ranks(2, job_list, device="cpu",
                                                    timeout_s=600)
        except launch_serve.RankError as e:
            ranks["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    refs, singles = {}, {}
    try:
        for key, (_, kw) in zip(keys, job_list):
            if key == "router":
                wants.append(None)
            elif key[1] == "frontend":
                wants.append(parity.frontend_run(None, torch.device("cpu"),
                                                 **kw)
                             if key[2] == "int8" else _front_reference(key[0]))
            else:
                arch, tier, _ = key
                _, jm, jp, tc, tm, tp = _setup(arch)
                prompts = _prompts(tc.vocab)
                if arch not in refs:
                    refs[arch] = _ref(jm, jp, prompts)
                if (arch, tier) not in singles:
                    singles[arch, tier] = _single(
                        tm, tp, prompts, INT8 if tier == "int8" else {})
                wants.append((refs[arch], singles[arch, tier]))
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    out = ranks["out"]
    return {key: (out[0][i], out[1][i], wants[i])
            for i, key in enumerate(keys)}


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == "float"],
                         ids=_ids)
def test_tp_float_tokens_equal_reference_and_single_device(tp_runs, case):
    r0, r1, (ref, single) = tp_runs[case]
    assert sorted(r0["tokens"]) == [0, 1, 2]
    assert all(len(t) == MAX_NEW for t in r0["tokens"].values())
    assert r0["tokens"] == ref
    assert r0["tokens"] == single
    assert r1["tokens"] == r0["tokens"]


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == "int8"],
                         ids=_ids)
def test_tp_int8_tokens_equal_single_device(tp_runs, case):
    r0, r1, (_, single) = tp_runs[case]
    assert r0["tokens"] == single
    assert r1["tokens"] == r0["tokens"]


def _half(whole: tuple, dim: int) -> tuple:
    out = list(whole)
    out[dim] //= 2
    return tuple(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_ranks_hold_their_pieces(tp_runs, arch):
    """Each rank's served params and cache against the whole tree's shapes:
    the projections cut by heads (column-parallel wq/wk/wv on their output,
    row-parallel wo and down on their input), the MLP by d_ff, the biases,
    norms and a vocab that does not divide kept whole, the K/V caches by KV
    heads, mixtral's banks by experts or by d_ff_expert."""
    cfg = configs.smoke_config(configs.get_config(arch))
    meta = Model(cfg, device="meta")
    whole = jobs.leaf_shapes(meta.init(0))
    cache = jobs.leaf_shapes(meta.init_cache(2, MAX_LEN))
    for case in CASES:
        if case[0] != arch or case[1] != "float":
            continue
        for r in tp_runs[case][:2]:
            got = r["params"]
            for path, shape in whole.items():
                leaf, owner = path.split("/")[-1], path.split("/")[-2]
                if leaf in ("b", "scale", "bias") or owner == "router":
                    want = shape
                elif path.endswith(("wq/w", "wk/w", "wv/w", "up/w",
                                    "gate/w")):
                    want = _half(shape, -1)
                elif path.endswith(("wo/w", "down/w")):
                    want = _half(shape, -2)
                elif leaf in ("w_gate", "w_up", "w_down"):
                    dim = -3 if case[2] == "expert" else (
                        -2 if leaf == "w_down" else -1)
                    want = _half(shape, dim)
                elif leaf == "table":
                    want = _half(shape, 0) if cfg.vocab % 2 == 0 else shape
                else:
                    want = _half(shape, -1)        # the untied unembed
                assert got[path] == want, (case, path)
            for path, shape in cache.items():
                assert r["cache"][path] == _half(shape, -2), (case, path)
            if arch == "whisper-small":
                assert "cross_kv/k" in r["cache"]
                assert "encoder/layers/attn/wq/w" in got


@pytest.mark.parametrize("tp", [2, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_specs_at_the_published_widths(arch, tp):
    """The serving specs of the full config on the meta device: q-head
    leaves (wq, wo, the encoder's and the cross attention's) split iff the
    heads divide tp, KV leaves and the K/V and cross K/V caches iff the KV
    heads do, the MLP's d_ff always here, the embedding only where the
    vocab divides, every bias and norm whole."""
    cfg = configs.get_config(arch)
    meta = Model(cfg, device="meta")
    params = meta.init(0)
    mesh = dctx.make_mesh((1, tp), ("data", dctx.MODEL))
    part = cfg.moe.partition if cfg.moe else "expert"
    got = {}

    def walk(tree, spec, prefix=""):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], spec[k], f"{prefix}{k}/")
        else:
            got[prefix[:-1]] = tuple(spec)

    walk(params, sharding.serving_specs(params, mesh, cfg, part))
    assert set(got) == set(jobs.leaf_shapes(params))
    q_split = cfg.n_heads % tp == 0
    kv_split = cfg.n_kv_heads % tp == 0
    for path, spec in got.items():
        leaf = path.split("/")[-1]
        if leaf in ("b", "scale", "bias"):
            assert dctx.MODEL not in spec, path
        elif path.endswith(("wq/w", "wo/w")):
            assert (dctx.MODEL in spec) == q_split, path
        elif path.endswith(("wk/w", "wv/w")):
            assert (dctx.MODEL in spec) == kv_split, path
        elif path.endswith(("up/w", "gate/w", "down/w")):
            assert dctx.MODEL in spec, path
        elif leaf == "table":
            assert (dctx.MODEL in spec) == (cfg.vocab % tp == 0), path
    if arch == "whisper-small":
        assert q_split == (tp == 2)
        assert dctx.MODEL not in got["embed/table"]      # 51865 is odd
    cache = meta.init_cache(4, 64)
    cspecs = sharding.serving_cache_specs(cache, mesh, cfg, batch=4)
    for group, leaves in cspecs.items():
        for name, spec in leaves.items():
            assert (spec[-2] == dctx.MODEL) == kv_split, (group, name)


def _bar(got, want, d):
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                               atol=1e-3 * max(1, d // 64))


@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_entry_on_a_mesh_matches_reference(tp_runs, arch):
    r0, r1, (tokens, first, last) = tp_runs[arch, "frontend", "float"]
    d = configs.smoke_config(configs.get_config(arch)).d_model
    assert r0["tokens"] == tokens
    assert r1["tokens"] == r0["tokens"]
    _bar(r0["first"], first, d)
    _bar(r0["last"], last, d)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_entry_int8_on_a_mesh_equals_single_device(tp_runs, arch):
    r0, r1, single = tp_runs[arch, "frontend", "int8"]
    d = configs.smoke_config(configs.get_config(arch)).d_model
    assert r0["tokens"] == single["tokens"]
    assert r1["tokens"] == r0["tokens"]
    _bar(r0["first"], single["first"], d)
    _bar(r0["last"], single["last"], d)


def test_router_replicas_on_a_mesh_under_faults(tp_runs):
    """Every request DONE with its tier's no-fault oracle's tokens (rank
    0's gate: ``problems``), faults fired and absorbed, and both ranks'
    routers took the same decisions."""
    r0, r1, _ = tp_runs["router"]
    assert r0["problems"] == [] and r1["problems"] == []
    assert r0["outcomes"] == {"done": 6}
    assert r0["stats"]["replica_failures"] > 0
    assert any(ev[0] == "replica_failure" for ev in r0["events"])
    for key in ("events", "outcomes", "tokens"):
        assert r1[key] == r0[key], key


def test_mesh_router_runs_on_a_fake_clock_and_shares_a_tier_s_cut():
    """serve_router on a (one-rank) mesh without a fault plan: the router
    and every replica read one FakeClock, and the two float replicas serve
    one cut of one preparation."""
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    model = Model(cfg, device="cpu")
    params = model.init(0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)) for n in (5, 9, 3)]
    args = argparse.Namespace(**dict(ROUTER_ARGS, quantized_replicas=0,
                                     fault_plan=None))
    problems, rt = launch_serve.serve_router(
        model, params, prompts, args, dict(batch_slots=2, max_len=32,
                                           gemm_impl="cuda"),
        mesh=dctx.make_host_mesh())
    assert problems == []
    assert isinstance(rt.clock, FakeClock)
    servers = [r.server for r in rt.replicas]
    assert all(s._clock is rt.clock for s in servers)
    assert servers[0].prepared is servers[1].prepared
    assert servers[0]._local_prepared is servers[1]._local_prepared
    assert servers[0]._prepared_params is servers[1]._prepared_params


def test_prepared_cut_is_made_once_a_mesh_and_spec_tree():
    cfg = configs.smoke_config(configs.get_config("whisper-small"))
    params = Model(cfg, device="cpu").init(0)
    pm = prepare.prepare_lm(params, quantized=True)
    mesh = dctx.make_mesh((1, 2), ("data", dctx.MODEL))     # shape-only
    specs = sharding.serving_specs(pm.params, mesh, cfg)
    cut = pm.shard(specs, mesh)
    assert pm.shard(sharding.serving_specs(pm.params, mesh, cfg),
                    mesh) is cut
    assert cut.params["layers"]["xattn"]["wk"]["q"]["qw"].shape[-1] == (
        pm.params["layers"]["xattn"]["wk"]["q"]["qw"].shape[-1] // 2)
    other = dctx.make_mesh((1, 2), ("data", dctx.MODEL))
    assert pm.shard(specs, other) is not cut
