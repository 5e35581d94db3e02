"""The sharded scan: falcon-mamba-7b (Mamba1, K6) and zamba2-1.2b (Mamba2's
SSD and the shared GQA block) served tensor-parallel by the port's
BatchServer(mesh=) on two gloo ranks on the CPU, against single-device
serving. The serving cuts at the published shapes (every cut divides, the
in_proj cut as x | z halves, bc_proj whole, the streaming state on the
local d_inner or heads); the float tokens at tp 2 equal the reference's
single-device tokens on the bridged weights; the int8 FFIP tokens equal
the port's single-device int8 tokens (tests/test_torch_ssm.py and
tests/test_torch_serve_hybrid.py hold those to the reference's); the int8
Mamba1 mixer equals the whole mixer bit for bit, and the float mixers are
within the f32 GEMM bar of tests/test_kernels.py:40-41 at K = d_inner
(repro_torch.dist.parity); K6 on a rank's channels equals the whole K6's
columns bit for bit, and the check sees in_proj cut contiguously over x | z
(the layout bug the halves cut prevents); a prepared int8 falcon artifact
cut per rank serves with recomputed == 0; the launcher's --mesh-model 2
--compare-single-device exits 0 for zamba2. The ranks are spawned once for
every rank-side case (launch.serve.spawn_ranks, one intra-op thread a
rank) while this process runs the reference and the single-device port. The smoke widths split at
tp 2 as they are (d_inner 128: 64 a rank; 8 Mamba2 heads: 4)."""
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_jobs as jobs
from repro import configs as jcfg
from repro.launch.inputs import params_specs_struct
from repro.models.model import build_model as j_build
from repro.serve.batcher import BatchServer as JServer
from repro.serve.batcher import Request as JRequest
from repro_torch import bridge, configs, prepare
from repro_torch.core import fip
from repro_torch.dist import context as dctx
from repro_torch.dist import parity
from repro_torch.dist import sharding as shd
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import Model
from test_torch_dist_rules import _flat, _port_flat, _port_tree

ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")
MAX_LEN = 48
MAX_NEW = 4
INT8 = dict(quantized=True, gemm_impl="cuda", gemm_algo="ffip")
MIXER_CASES = [(4, 1), (1, 16)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread keeps them from contending
    with the other test workers' threads (each rank takes one too)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _smoke(arch):
    """The reference's smoke model with its norm scales and D drawn at
    random (so that a leaf read in the wrong piece shows), and its weights
    bridged into the port's tree."""
    jc = jcfg.smoke_config(jcfg.get_config(arch))
    jm = j_build(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, t: (jnp.asarray(rng.uniform(0.5, 1.5, t.shape), t.dtype)
                         if any(getattr(k, "key", None) in ("scale", "D")
                                for k in path) else t), jp)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, configs.smoke_config(configs.get_config(arch)), params


def _prompts(vocab):
    # within both scans' chunk contract (smoke chunk 8)
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=(n,)) for n in (5, 8, 3)]


def _reference(jm, jp, prompts):
    srv = JServer(jm, batch_slots=2, max_len=MAX_LEN, quantized=False)
    for i, p in enumerate(prompts):
        srv.submit(JRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    return {r.rid: list(r.out_tokens) for r in srv.run_until_drained(jp)}


def _single(cfg, params, prompts, **kw):
    _, done, _ = launch_serve.serve(Model(cfg, device="cpu"), params,
                                    prompts, max_new=MAX_NEW, batch_slots=2,
                                    max_len=MAX_LEN, **kw)
    return {r.rid: list(r.out_tokens) for r in done}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every rank-side case on one spawn of two ranks: {case: (rank 0's
    result, rank 1's, the tokens to equal)}, the parity checks under
    "parity" and the planted fault's under "planted"."""
    cases, job_list, smokes = {}, [], {}
    for arch in ARCHS:
        jm, jp, cfg, params = smokes[arch] = _smoke(arch)
        prompts = _prompts(cfg.vocab)
        for tier, kw in (("float", {}), ("int8", INT8)):
            cases[f"{arch} {tier}"] = (arch, prompts, kw)
            job_list.append((jobs.serve_ssm_tokens, dict(
                cfg=cfg, params=params, prompts=prompts, max_new=MAX_NEW,
                server_kw=dict(kw, batch_slots=2, max_len=MAX_LEN))))
    _, _, cfg, params = smokes["falcon-mamba-7b"]
    prompts = _prompts(cfg.vocab)
    art = tmp_path_factory.mktemp("tp_ssm") / "a"
    prepare.prepare_lm(params, quantized=True).save(art)
    cases["falcon-mamba-7b prepared int8"] = ("falcon-mamba-7b", prompts,
                                              INT8)
    job_list.append((jobs.serve_ssm_tokens, dict(
        cfg=cfg, params=params, prompts=prompts, max_new=MAX_NEW,
        server_kw=dict(INT8, batch_slots=2, max_len=MAX_LEN),
        prepared=str(art))))
    checks = [(parity.mixer_parity, dict(arch=a, smoke=True,
                                         cases=MIXER_CASES)) for a in ARCHS]
    checks.append((parity.scan_columns, dict(
        di=128, n=8, chunk=8, cases=[(1, 16), (2, 8)])))
    planted = (parity.mixer_parity, dict(
        arch="falcon-mamba-7b", smoke=True, cases=MIXER_CASES[-1:],
        plant=jobs.contiguous_in_proj))

    ranks = {}

    def spawn():
        try:
            ranks["out"] = launch_serve.spawn_ranks(
                2, job_list + checks + [planted], device="cpu",
                timeout_s=600)
        except launch_serve.RankError as e:
            ranks["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    want = {}
    try:
        for arch in ARCHS:
            jm, jp, cfg, params = smokes[arch]
            prompts = _prompts(cfg.vocab)
            want[f"{arch} float"] = _reference(jm, jp, prompts)
            want[f"{arch} int8"] = _single(cfg, params, prompts, **INT8)
        want["falcon-mamba-7b prepared int8"] = want["falcon-mamba-7b int8"]
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    out = ranks["out"]
    result = {name: (out[0][i], out[1][i], want[name])
              for i, name in enumerate(cases)}
    n = len(cases)
    result["parity"] = [{k: v for res in rank[n:-1] for k, v in res.items()}
                        for rank in out]
    result["planted"] = [rank[-1] for rank in out]
    return result


# --- the serving cuts --------------------------------------------------------

def _with_q(tree):
    """Shape stand-ins of the int8 leaves ``attach_quantized_weights`` adds
    beside every dense weight."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _with_q(v) for k, v in tree.items()}
    if "w" in tree and not isinstance(tree["w"], dict):
        shape = tree["w"].shape
        vec = types.SimpleNamespace(shape=shape[:-2] + shape[-1:])
        out["q"] = {"qw": tree["w"], "scale": vec, "zp": vec,
                    "neg_beta": vec, "colsum": vec}
    return out


def _published(arch):
    cfg = configs.get_config(arch)
    flat = _flat(params_specs_struct(jcfg.get_config(arch)))
    return cfg, _with_q(_port_tree(flat))


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_cuts_at_published_shapes(arch):
    """On a shape-only (1, 2) mesh every Mamba leaf's cut divides; in_proj
    is cut as x | z halves, x_proj row-parallel, A_log by rows, bc_proj and
    conv_bc whole; param_specs keeps the reference's leaves (the rules test
    holds it to them)."""
    cfg, tree = _published(arch)
    mesh = dctx.make_mesh((1, 2), ("data", "model"))
    specs = _port_flat(shd.serving_specs(tree, mesh, cfg))
    ref = _port_flat(shd.param_specs(tree, mesh))
    shapes = {k: v.shape for k, v in _port_flat(tree).items()}
    group = "layers" if cfg.family == "ssm" else "hybrid_groups"
    mixer = {k[len(group) + 5:]: v for k, v in specs.items()
             if k.startswith(f"{group}/ssm/")}
    assert mixer
    for path, spec in specs.items():
        for dim, axes in enumerate(spec):
            if axes == "model":
                blocks = getattr(spec, "blocks", 1)
                assert shapes[path][dim] % (2 * blocks) == 0, (path, spec)
    model_dim = {k: [d - len(v) for d, a in enumerate(v) if a == "model"]
                 for k, v in mixer.items()}
    if cfg.ssm.version == 1:
        for leaf in ("w", "q/qw", "q/scale", "q/colsum"):
            assert isinstance(mixer[f"in_proj/{leaf}"], shd.Blocked)
            assert model_dim[f"in_proj/{leaf}"] == [-1]
        for leaf in ("x_proj/w", "x_proj/q/qw", "out_proj/w", "A_log"):
            assert model_dim[leaf] == [-2], leaf
        assert model_dim["x_proj/q/scale"] == []
        for leaf in ("conv_w", "dt_proj/w", "D"):
            assert model_dim[leaf] == [-1], leaf
        changed = {k for k in specs if specs[k] != ref[k]
                   or type(specs[k]) is not type(ref[k])}
        assert changed == {f"{group}/ssm/{k}" for k in mixer
                           if k.startswith(("in_proj", "x_proj/w",
                                            "x_proj/q/qw", "A_log"))}
    else:
        for leaf in ("bc_proj/w", "bc_proj/q/qw", "conv_bc"):
            assert model_dim[leaf] == [], leaf
        for leaf in ("z_proj/w", "x_proj_in/w", "dtp/w", "conv_x",
                     "A_log", "D", "dt_bias"):
            assert model_dim[leaf] == [-1], leaf
        assert model_dim["out_proj/w"] == [-2]
        assert model_dim["norm/scale"] == []
        # the shared block's heads split (32 of 64 over 2 ranks)
        assert specs["shared_attn/attn/wq/w"][-1] == "model"
    cache = Model(cfg, device="meta").init_cache(4, 64)
    cspecs = _port_flat(shd.serving_cache_specs(cache, mesh, cfg, batch=4))
    flat_cache = _port_flat(cache)
    for path, spec in cspecs.items():
        name = path.split("/")[-1]
        want = {"conv": [-1], "ssm": [-2 if cfg.ssm.version == 1 else -3],
                "conv_bc": [], "k": [-2], "v": [-2]}[name]
        got = [d - len(spec) for d, a in enumerate(spec) if a == "model"]
        assert got == want, (path, spec)
        assert all(flat_cache[path].shape[d] % 2 == 0 for d in got)
    assert _port_flat(shd.cache_specs(cache, mesh, batch=4)) != cspecs


def test_blocked_cut_takes_each_half():
    """A rank's piece of a Blocked leaf is its piece of every block: the x
    half's and the z half's columns, which concatenate back by block."""
    w = torch.arange(2 * 3 * 8).reshape(2, 3, 8)
    spec = shd.Blocked(None, None, "model", blocks=2)
    meshes = [dctx.Mesh((1, 2), ("data", "model"), rank=r) for r in (0, 1)]
    pieces = [shd.shard_leaf(w, spec, m) for m in meshes]
    assert all(p.is_contiguous() for p in pieces)
    assert torch.equal(pieces[0], torch.cat([w[..., 0:2], w[..., 4:6]], -1))
    assert torch.equal(pieces[1], torch.cat([w[..., 2:4], w[..., 6:8]], -1))
    assert "blocks=2" in repr(spec)


def test_prepared_falcon_artifact_cut_per_rank():
    """The y of a Blocked in_proj piece equals make_y of the piece, across
    the x | z join too; the cut quantizes nothing and derives no y."""
    cfg = configs.smoke_config(configs.get_config("falcon-mamba-7b"))
    params = Model(cfg, device="cpu").init(0)
    pm = prepare.prepare_lm(params, quantized=True)
    meshes = [dctx.Mesh((1, 2), ("data", "model"), rank=r) for r in (0, 1)]
    specs = shd.serving_specs(pm.params, meshes[0], cfg)
    before = prepare.counters_snapshot()
    for m in meshes:
        local = pm.shard(specs, m)
        for proj in ("in_proj", "x_proj", "dt_proj", "out_proj"):
            w = local.params["layers"]["ssm"][proj]["q"]["qw"]
            y = local.derived[f"layers/ssm/{proj}/q/qw"]
            for i in range(w.shape[0]):
                assert torch.equal(y[i], fip.make_y(w[i])), (proj, i)
    assert prepare.counters_snapshot() == before


# --- served on two ranks -----------------------------------------------------

@pytest.mark.parametrize("case", [f"{a} {t}" for a in ARCHS
                                  for t in ("float", "int8")])
def test_tp_tokens_identical_to_single_device(tp_runs, case):
    """float: the reference's single-device tokens; int8: the port's."""
    r0, r1, want = tp_runs[case]
    assert r0["tokens"] == want
    assert r1["tokens"] == r0["tokens"]


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_ranks_hold_their_pieces(tp_runs, arch):
    """Each rank served its half of d_inner (or of the heads) and of the
    streaming state; B and C stay whole."""
    cfg = configs.smoke_config(configs.get_config(arch))
    di = cfg.ssm.expand * cfg.d_model
    for r in tp_runs[f"{arch} int8"][:2]:
        sh, cache = r["shapes"], r["cache"]
        if cfg.ssm.version == 1:
            assert sh["in_proj/w"][-1] == di
            assert sh["in_proj/q/scale"][-1] == di
            assert sh["x_proj/w"][-2] == di // 2
            assert sh["A_log"][-2:] == (di // 2, cfg.ssm.d_state)
            assert cache["ssm"][-2] == di // 2
        else:
            heads = di // cfg.ssm.head_dim
            assert sh["z_proj/w"][-1] == di // 2
            assert sh["bc_proj/w"][-1] == 2 * cfg.ssm.d_state
            assert sh["dtp/w"][-1] == heads // 2
            assert cache["ssm"][-3] == heads // 2
            assert cache["conv_bc"][-1] == 2 * cfg.ssm.d_state
        assert cache["conv"][-1] == di // 2


def test_tp_decode_from_prepared_falcon_artifact(tp_runs):
    r0, r1, want = tp_runs["falcon-mamba-7b prepared int8"]
    assert r0["tokens"] == want == r1["tokens"]
    assert r0["recomputed"] == 0 and r1["recomputed"] == 0


def test_tp_mixers_and_scan_columns(tp_runs):
    """The int8 Mamba1 mixer and K6's columns bit for bit; the float mixers
    and both Mamba2 tiers within the f32 GEMM bar."""
    for result in tp_runs["parity"]:
        labels = set(result)
        assert {f"{a} {t} ffip mixer B={b} S={s}" for a in ARCHS
                for t in ("float32", "int8")
                for b, s in MIXER_CASES} <= labels
        assert any(k.startswith("K6 di 128 -> 64") for k in labels)
        bad = {k: v for k, v in result.items() if not v["ok"]}
        assert not bad, bad
        exact = [v for k, v in result.items()
                 if k.startswith(("falcon-mamba-7b int8", "K6"))]
        assert exact and all(v["tol"] == "bit for bit"
                             and v["max_abs_err"] == 0.0 for v in exact)


def test_tp_mixer_check_sees_a_contiguous_in_proj_cut(tp_runs):
    """The layout bug the x | z cut prevents, planted in the check's cut
    (one rank all of x): both tiers off the whole mixer by whole standard
    deviations of its output."""
    for result in tp_runs["planted"]:
        assert len(result) == 2
        for label, rec in result.items():
            assert not rec["ok"] and rec["sd"] > 1.0, (label, rec)


def test_launch_serve_zamba2_mesh_model_compare_single_device(capsys):
    launch_serve.main(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu",
                       "--slots", "2", "--requests", "3", "--max-new", "3",
                       "--mesh-model", "2", "--compare-single-device"])
    out = capsys.readouterr().out
    assert "gloo on cpu, cpu" in out
    assert "compare-single-device: 9 tokens identical at tp=2" in out
    assert out.rstrip().endswith("OK")
