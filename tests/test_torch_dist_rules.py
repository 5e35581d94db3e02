"""The port's sharding rule engine (repro_torch.dist) against the
reference's (repro.dist.sharding): the parameter, cache and data specs of
every arch equal the reference's leaf for leaf, on both production meshes
and the (1, 2) / (1, 4) tensor-parallel ones, in both MoE partitions; the
guard and MoE-mode properties of tests/test_dist_rules.py; the mesh
context; shard_tree's pieces, which concatenate back to the whole leaf;
the executor's widenings; and a prepared artifact's y cut per rank, whose
column pieces equal make_y of the weight's pieces. Specs are computed on
shape stand-ins: nothing is allocated at full size."""
import functools
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jcfg
from repro.dist import sharding as jshd
from repro.launch.inputs import cache_specs_struct, params_specs_struct
from repro_torch import configs, prepare
from repro_torch.core import fip
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models.model import Model
from repro_torch.prepare import artifact


class Mesh16x16:
    axis_names = ("data", "model")

    class devices:  # noqa: D106 (a shape-only stand-in for a 256-chip pod)
        shape = (16, 16)


MESHES = {
    "16x16": launch_mesh.make_production_mesh(),
    "2x16x16": launch_mesh.make_production_mesh(multi_pod=True),
    "1x2": dctx.make_mesh((1, 2), ("data", "model")),
    "1x4": dctx.make_mesh((1, 4), ("data", "model")),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread keeps them from contending
    with the other test workers' threads (each rank takes one too)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(tree, is_leaf=None):
    """{"a/b/c": leaf} of a JAX pytree."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]}


def _port_tree(flat):
    """Nested dicts of shape stand-ins from {"a/b/c": array-like}."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for seg in head:
            node = node.setdefault(seg, {})
        node[last] = types.SimpleNamespace(shape=tuple(leaf.shape))
    return out


def _port_flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def _norm(spec):
    return tuple(tuple(a) if isinstance(a, (tuple, list)) else a
                 for a in spec)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return _flat(params_specs_struct(jcfg.get_config(arch)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("mode", ["expert", "ffn"])
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_param_specs_equal_reference(arch, mode, mesh):
    flat = _ref_params(arch)
    m = MESHES[mesh]
    want = _flat(jshd.param_specs(
        {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in flat.items()},
        m, moe_partition=mode), is_leaf=lambda x: isinstance(x, jshd.P))
    got = _port_flat(shd.param_specs(_port_tree(flat), m,
                                     moe_partition=mode))
    assert set(got) == set(want)
    for path in want:
        assert _norm(got[path]) == _norm(want[path]), (path, got[path],
                                                       want[path])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-v2-lite-16b",
                                  "zamba2-1.2b", "whisper-small"])
def test_cache_specs_equal_reference(arch, mesh):
    """The reference's cache tree at batch 32 against the port's own
    init_cache (on the meta device), leaf for leaf."""
    m = MESHES[mesh]
    ref = cache_specs_struct(jcfg.get_config(arch), 32, 64)
    want = _flat(jshd.cache_specs(ref, m, batch=32),
                 is_leaf=lambda x: isinstance(x, jshd.P))
    port = Model(configs.get_config(arch), device="meta").init_cache(32, 64)
    assert {k: tuple(v.shape) for k, v in _port_flat(port).items()} == {
        k: tuple(v.shape) for k, v in _flat(ref).items()}
    got = _port_flat(shd.cache_specs(port, m, batch=32))
    assert {k: _norm(v) for k, v in got.items()} == {
        k: _norm(v) for k, v in want.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_data_specs_equal_reference(mesh):
    m = MESHES[mesh]
    for shape in ((32, 128), (16, 128), (8, 128), (1,), ()):
        want = jshd.data_specs(jax.ShapeDtypeStruct(shape, np.int32), m)
        got = shd.data_specs(types.SimpleNamespace(shape=shape), m)
        assert _norm(got) == _norm(want), (shape, got, want)


@settings(max_examples=30, deadline=None)
@given(L=st.integers(1, 8), e=st.integers(1, 128), d=st.integers(1, 512),
       f=st.integers(1, 512))
def test_property_moe_rules_divisible_and_modes_differ(L, e, d, f):
    """Any expert-bank shape: both modes give divisible full-rank specs;
    where dims divide, expert mode shards E and ffn mode d_ff."""
    for name in ("w_gate", "w_up", "w_down"):
        shape = (L, e, d, f) if name != "w_down" else (L, e, f, d)
        for mode in ("expert", "ffn"):
            spec = shd._match_spec(f"layers/ffn/{name}", shape, Mesh16x16,
                                   mode)
            assert len(spec) == 4
            for dim, ax in enumerate(spec):
                assert ax is None or shape[dim] % 16 == 0
    if e % 16 == 0:
        assert shd._match_spec("layers/ffn/w_gate", (L, e, d, f), Mesh16x16,
                               "expert")[1] == "model"
    if f % 16 == 0:
        assert shd._match_spec("layers/ffn/w_gate", (L, e, d, f), Mesh16x16,
                               "ffn")[3] == "model"


@settings(max_examples=30, deadline=None)
@given(d0=st.integers(1, 64), d1=st.integers(1, 4096),
       d2=st.integers(1, 4096))
def test_property_guard_never_assigns_indivisible(d0, d1, d2):
    spec = shd._match_spec("layers/attn/wq/w", (d0, d1, d2), Mesh16x16,
                           "expert")
    for dim, ax in zip((d0, d1, d2), spec):
        assert ax is None or dim % 16 == 0
    assert _norm(spec) == _norm(jshd._match_spec(
        "layers/attn/wq/w", (d0, d1, d2), Mesh16x16, "expert"))


def test_moe_partition_mode_validated():
    with pytest.raises(ValueError):
        shd._match_spec("layers/ffn/w_gate", (2, 4, 8, 16), Mesh16x16,
                        "bogus")


def test_q_parent_rule_and_replicated_vectors():
    """An offline-quantized leaf shards like its projection (wo/q/qw is
    row-parallel), and the int8 epilogue vectors stay whole."""
    m = MESHES["1x2"]
    assert shd._match_spec("layers/attn/wo/q/qw", (2, 8, 16), m) == \
        shd.P(None, "model", "data")
    assert shd._match_spec("layers/attn/wq/q/qw", (2, 8, 16), m) == \
        shd.P(None, "data", "model")
    for leaf in ("scale", "zp", "neg_beta", "colsum"):
        assert shd._match_spec(f"layers/attn/wq/q/{leaf}", (2, 16), m) == \
            shd.P(None, None)


def test_mesh_context_nests_and_clears():
    outer, inner = dctx.make_host_mesh(), MESHES["1x2"]
    assert dctx.get_mesh() is None and dctx.tp_size() == 1
    with dctx.mesh_context(outer):
        assert dctx.get_mesh() is outer
        with dctx.mesh_context(inner):
            assert dctx.get_mesh() is inner and dctx.tp_size() == 2
        assert dctx.get_mesh() is outer
    assert dctx.get_mesh() is None
    # a shape-only mesh has no process group to reduce over
    with dctx.mesh_context(inner), pytest.raises(RuntimeError,
                                                 match="shape-only"):
        dctx.all_sum(torch.ones(2))


def _rank_meshes(tp):
    return [dctx.Mesh((1, tp), ("data", "model"), rank=r) for r in range(tp)]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch,mode", [("minicpm-2b", "expert"),
                                       ("deepseek-v2-lite-16b", "expert"),
                                       ("deepseek-v2-lite-16b", "ffn")])
def test_shard_tree_pieces_concatenate_to_the_whole(arch, mode, tp):
    cfg = configs.smoke_config(configs.get_config(arch))
    params = Model(cfg, device="cpu").init(0)
    specs = shd.param_specs(params, _rank_meshes(tp)[0], mode)
    pieces = [shd.shard_tree(params, specs, m) for m in _rank_meshes(tp)]
    whole, flat_specs = _port_flat(params), _port_flat(specs)
    split = 0
    for path, leaf in whole.items():
        parts = [_port_flat(p)[path] for p in pieces]
        spec = flat_specs[path]
        dims = [d for d, a in enumerate(spec) if a == "model"]
        if not dims:
            assert all(p is leaf for p in parts), path
            continue
        split += 1
        assert all(p.is_contiguous() for p in parts)
        assert torch.equal(torch.cat(parts, dim=dims[0]), leaf), path
    assert split > 0


def test_serving_specs_widen_router_latent_and_uneven_heads():
    m = MESHES["1x2"]
    cfg = configs.smoke_config(configs.get_config("deepseek-v2-lite-16b"))
    params = Model(cfg, device="cpu").init(0)
    plain = _port_flat(shd.param_specs(params, m))
    wide = _port_flat(shd.serving_specs(params, m, cfg))
    changed = {p for p in plain if plain[p] != wide[p]}
    assert changed and all(any(s in p for s in ("router", "w_dkv", "w_kr"))
                           for p in changed), changed
    assert all(a is None for p in changed for a in wide[p])
    # 3 heads do not split over 2 ranks: the head projections stay whole;
    # 4 q heads over 2 kv heads split, and so do the kv heads
    mc = configs.smoke_config(configs.get_config("minicpm-2b"))
    for h, kv, whole in ((3, 3, {"wq", "wk", "wv", "wo"}), (4, 1, {"wk",
                                                                    "wv"})):
        c = mc.__class__(**{**mc.__dict__, "n_heads": h, "n_kv_heads": kv,
                            "head_dim": 16})
        p = Model(c, device="cpu").init(0)
        wide = _port_flat(shd.serving_specs(p, m, c))
        for name in ("wq", "wk", "wv", "wo"):
            spec = wide[f"layers/attn/{name}/w"]
            assert (all(a is None for a in spec)) == (name in whole), (
                h, kv, name, spec)


@pytest.mark.parametrize("quantized", [False, True])
def test_prepared_artifact_cut_per_rank(quantized):
    """A column piece of a stacked y equals make_y of the weight's piece
    (its first column reset from the weight), a row piece the rows of y;
    the cut quantizes nothing and derives no y."""
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    params = Model(cfg, device="cpu").init(0)
    pm = prepare.prepare_lm(params, quantized=quantized)
    meshes = _rank_meshes(2)
    specs = shd.serving_specs(pm.params, meshes[0], cfg)
    before = prepare.counters_snapshot()
    w_key = "q/qw" if quantized else "w"
    for m in meshes:
        local = pm.shard(specs, m)
        assert local.built == {"y": 0, "carry": 0}
        for proj in ("wq", "wo"):
            path = f"layers/attn/{proj}/{w_key}"
            w = local.params["layers"]["attn"][proj]
            w = w["q"]["qw"] if quantized else w["w"]
            y = local.derived[path]
            assert y.shape == w.shape
            for i in range(w.shape[0]):
                assert torch.equal(y[i], fip.make_y(w[i])), (path, i)
        tied = local.derived[artifact.TIED_UNEMBED]
        assert torch.equal(tied, fip.make_y(
            local.params["embed"]["table"].T))
    assert prepare.counters_snapshot() == before
