"""The port's prepared artifacts (``repro_torch.prepare``,
``launch/prepare.py``) against the reference's (``repro.prepare``) on the
CPU.

One format: a JAX-written minicpm-2b smoke artifact (f32, quantized) loads
in the port with the params and y deltas of ``bridge.params_from_numpy``,
and a port-written one loads in the reference, bit for bit. Serving a
loaded artifact gives the reference server's greedy tokens with
``recomputed == 0`` (float FFIP: the reference's int8 interpret-mode server
costs 60-110 s a case; the port's int8 tier from its own artifact is held
to its unprepared server). bf16 leaves round-trip bit for bit in the port;
a foreign device kind drops the schedule slice with one warning; corrupt
artifacts are quarantined; a vision artifact keeps its conv entries'
Python ints.
"""
import logging

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import prepare as jprepare
from repro.models.model import build_model as j_build
from repro.serve.batcher import BatchServer as JServer
from repro.serve.batcher import Request as JRequest
from repro_torch import bridge, configs, prepare, tune
from repro_torch.kernels import compat
from repro_torch.launch import prepare as launch_prepare
from repro_torch.models.model import Model
from repro_torch.prepare import artifact as art
from repro_torch.serve.batcher import BatchServer, Request

MAX_LEN = 48


@pytest.fixture(autouse=True)
def _own_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "sched.json"))
    tune.reset_stats()


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small torch ops: one intra-op thread keeps them from contending
    with the other test workers' threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's smoke params, its quantized artifact, its float FFIP
    server's tokens (interpret mode) and the prompts."""
    jc = jcfg.smoke_config(jcfg.get_config("minicpm-2b"))
    jm = j_build(jc)
    jparams = jm.init(jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("jax") / "art"
    jprepare.prepare_lm(jparams, quantized=True).save(path)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jc.vocab, size=(n,)) for n in (4, 7, 3, 9)]
    srv = JServer(jm, batch_slots=2, max_len=MAX_LEN, gemm_impl="pallas",
                  gemm_algo="ffip")
    for i, p in enumerate(prompts):
        srv.submit(JRequest(rid=i, prompt=p, max_new_tokens=4))
    want = {r.rid: list(r.out_tokens) for r in srv.run_until_drained(jparams)}
    return jparams, path, prompts, want


def _np_tree(tree):
    """numpy leaves, Python ints (a conv q entry's geometry) kept."""
    return jax.tree.map(lambda x: x if isinstance(x, int)
                        else np.asarray(x), tree)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_equal_trees(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert set(g) == set(w)
    for k in g:
        if isinstance(w[k], torch.Tensor):
            assert g[k].dtype == w[k].dtype, k
            assert torch.equal(g[k], w[k]), k
        else:
            assert g[k] == w[k] and type(g[k]) is type(w[k]), k


def _serve(pm_or_params, prompts, *, quantized=False, prepared=None):
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    srv = BatchServer(Model(cfg, device="cpu"), batch_slots=2,
                      max_len=MAX_LEN, device="cpu", gemm_impl="cuda",
                      gemm_algo="ffip", quantized=quantized,
                      prepared=prepared)
    for i, p in enumerate(prompts):
        srv.submit(Request(rid=i, prompt=p, max_new_tokens=4))
    return {r.rid: list(r.out_tokens)
            for r in srv.run_until_drained(pm_or_params)}


# -- one format, both directions ---------------------------------------------

def test_jax_artifact_loads_in_port_bit_equal(reference):
    jparams, path, _, _ = reference
    jpm = jprepare.load(path)
    pm = prepare.load(path, map_location="cpu")
    assert pm.recomputed == 0, pm.recompute_report()
    assert pm.kind == "lm" and pm.quantized and pm.device == "cpu"
    _assert_equal_trees(pm.params, bridge.params_from_numpy(
        _np_tree(jpm.params)))
    # the reference's y deltas, and the tied unembed's, derived at load
    ref_y = bridge.params_from_numpy(_np_tree(jpm.derived))
    assert set(pm.derived) == set(ref_y) | {art.TIED_UNEMBED}
    for k, y in ref_y.items():
        assert torch.equal(pm.derived[k], y), k
    assert pm.built == {"y": 1, "carry": 0}
    # ...and seeded: the first FFIP call over a loaded weight is a hit
    w = pm.params["layers"]["attn"]["wq"]["w"][0]
    before = dict(compat.derived.stats)
    y = compat.current_derived().get("y", w, lambda t: None)
    assert y is not None and compat.derived.stats["hits"] == before[
        "hits"] + 1


def test_port_artifact_loads_in_reference_bit_equal(reference, tmp_path):
    jparams, _, _, _ = reference
    params = bridge.params_from_numpy(_np_tree(jparams))
    pm = prepare.prepare_lm(params, quantized=False)
    pm.save(tmp_path / "port")
    jpm = jprepare.load(tmp_path / "port")
    assert jpm.recomputed == 0 and not jpm.quantized
    _assert_equal_trees(bridge.params_from_numpy(_np_tree(jpm.params)),
                        params)
    ref = jprepare.prepare_lm(jparams, quantized=False)
    for k, y in ref.derived.items():          # the reference's own y deltas
        np.testing.assert_array_equal(np.asarray(jpm.derived[k]),
                                      np.asarray(y))
        assert torch.equal(pm.derived[k], bridge.params_from_numpy(
            np.asarray(y)))


def test_loaded_jax_artifact_serves_reference_tokens_warm(reference):
    _, path, prompts, want = reference
    pm = prepare.load(path, map_location="cpu")
    got = _serve(None, prompts, prepared=pm)
    assert got == want
    assert pm.recomputed == 0, pm.recompute_report()


def test_port_int8_artifact_serves_like_unprepared_warm(reference, tmp_path,
                                                        capsys):
    """The int8 tier from the port's own artifact (the int8 codes' y
    deltas): the unprepared int8 server's tokens, nothing re-derived; the
    launcher writes and reports it."""
    jparams, _, prompts, _ = reference
    params = bridge.params_from_numpy(_np_tree(jparams))
    cold = _serve(params, prompts, quantized=True)
    pm = prepare.prepare_lm(params, quantized=True)
    assert any(k.endswith("/q/qw") for k in pm.derived)
    pm.save(tmp_path / "q")
    pm2 = prepare.load(tmp_path / "q", map_location="cpu")
    assert _serve(None, prompts, quantized=True, prepared=pm2) == cold
    assert pm2.recomputed == 0, pm2.recompute_report()
    assert launch_prepare.main(["--arch", "minicpm-2b", "--smoke",
                                "--quantized", "--device", "cpu", "--out",
                                str(tmp_path / "cli")]) == 0
    assert "quantized=True y_deltas=8" in capsys.readouterr().out
    assert prepare.load(tmp_path / "cli", map_location="cpu").quantized


# -- leaves, schedules, corruption -------------------------------------------

def test_bf16_leaf_roundtrips_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    w = torch.randn((6, 10), generator=g).to(torch.bfloat16)
    w.view(torch.int16)[0, :4] = torch.tensor([0x7FC1, -1, 1, 0x0001],
                                              dtype=torch.int16)  # NaN, tiny
    pm = art.PreparedModel(kind="lm", device="cpu", quantized=False,
                           params={"lin": {"w": w, "k": 3}, "f": (1.5,)})
    pm.save(tmp_path / "a")
    got = prepare.load(tmp_path / "a", map_location="cpu").params
    assert got["lin"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["lin"]["w"].view(torch.int16),
                       w.view(torch.int16))
    assert got["lin"]["k"] == 3 and got["f"] == (1.5,)
    # a 2-byte void leaf (how np.save writes the reference's bf16) loads
    # as bf16 too
    void = w.view(torch.int16).numpy().view(np.dtype("V2"))
    np.save(tmp_path / "a" / "arr_00000.npy", void)
    got = prepare.load(tmp_path / "a", map_location="cpu").params
    assert torch.equal(got["lin"]["w"].view(torch.int16),
                       w.view(torch.int16))


_ENTRY = {"blocks": {"bm": 16, "bn": 32, "bk": 32}, "us": 10.0,
          "candidates": 1}


def test_schedule_slice_rides_and_foreign_drop_warns_once(tmp_path,
                                                          monkeypatch,
                                                          caplog):
    key = "gemm|ffip|int8|m8n128k64|cpu"
    tune.get_cache().merge_entries({key: _ENTRY,
                                    "gemm|ffip|int8|m8n128k64|TPU_v5e":
                                    _ENTRY})
    params = {"lin": {"w": torch.randn(8, 6)}}
    pm = prepare.prepare_lm(params, quantized=False)
    assert set(pm.schedule) == {key}
    pm.save(tmp_path / "a")
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "fresh.json"))
    pm2 = prepare.load(tmp_path / "a", map_location="cpu")
    assert pm2.schedule == {key: _ENTRY}
    assert tune.get_cache().lookup(key) == _ENTRY
    # another device kind: weights and y deltas load, the slice drops once
    foreign = prepare.prepare_lm(params, quantized=True, device="TPU_v5e")
    foreign.schedule = {key: _ENTRY}
    foreign.save(tmp_path / "f")
    with caplog.at_level(logging.WARNING, logger="repro_torch.prepare"):
        p1 = prepare.load(tmp_path / "f", map_location="cpu")
        p2 = prepare.load(tmp_path / "f", map_location="cpu")
    assert p1.quantized and p1.schedule == {} == p2.schedule
    assert set(p1.derived) == {"lin/q/qw"}
    assert len([r for r in caplog.records if "dropping" in r.message]) == 1


def test_corrupt_and_missing_artifacts(tmp_path):
    bad = tmp_path / "art"
    bad.mkdir()
    (bad / "manifest.json").write_text("{not json")
    with pytest.raises(prepare.ArtifactError, match="corrupt"):
        prepare.load(bad, map_location="cpu")
    assert not bad.exists()
    assert (tmp_path / "art.corrupt" / "manifest.json").exists()
    with pytest.raises(prepare.ArtifactError, match="no prepared artifact"):
        prepare.load(tmp_path / "nope", map_location="cpu")
    assert not (tmp_path / "nope.corrupt").exists()
    pm = prepare.prepare_lm({"lin": {"w": torch.randn(8, 6)}},
                            quantized=False)
    pm.save(tmp_path / "a")
    pm.save(tmp_path / "a")                     # overwrite in place
    assert prepare.load(tmp_path / "a", map_location="cpu").recomputed == 0
    with pytest.raises(FileExistsError):
        pm.save(tmp_path / "a", overwrite=False)
    (tmp_path / "a" / "arr_00000.npy").unlink()
    with pytest.raises(prepare.ArtifactError, match="quarantined"):
        prepare.load(tmp_path / "a", map_location="cpu")


def test_vision_artifact_keeps_conv_python_ints(tmp_path):
    """An AlexNet smoke vision artifact: the conv ``q`` entries' geometry
    (k_real, kh, kw, groups) comes back as Python ints, the params bit for
    bit, and a quantized forward from the loaded artifact equals the one
    from the prepared tree with nothing recomputed (its FCs' y deltas
    ride along)."""
    from repro_torch.core.gemm import GemmConfig, use_gemm
    from repro_torch.vision import models as vm
    model = vm.build("alexnet", num_classes=10, image_size=67, width_div=8)
    pm = prepare.prepare_vision(model, vm.init_params(model, 0,
                                                      device="cpu"))
    assert pm.kind == "vision" and len(pm.derived) == 3
    pm.save(tmp_path / "v")
    got = prepare.load(tmp_path / "v", map_location="cpu")
    assert got.kind == "vision" and got.quantized
    _assert_equal_trees(got.params, pm.params)
    for k in ("k_real", "kh", "kw", "groups"):
        assert type(got.params[0]["q"][k]) is int
    x = torch.randn((1, 67, 67, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), use_gemm(GemmConfig(algo="ffip", impl="cuda",
                                              quantized=True)):
        out = vm.apply(model, got.params, x)
        want = vm.apply(model, pm.params, x)
    assert torch.equal(out, want) and got.recomputed == 0


def test_launch_tune_refresh_artifact_rehomes_the_slice(tmp_path, capsys):
    """``launch.tune --refresh-artifact``: after tuning, the artifact's
    schedule slice is re-cut from the cache for this device and saved, the
    way to re-home an artifact whose slice a foreign device kind dropped."""
    from repro_torch.launch import tune as launch_tune
    pm = prepare.prepare_lm({"lin": {"w": torch.randn(8, 6)}},
                            quantized=False, device="TPU_v5e")
    pm.save(tmp_path / "a")
    assert launch_tune.main(["--arch", "minicpm-2b", "--smoke", "--m", "4",
                             "--no-flash", "--algos", "ffip", "--dtypes",
                             "int8", "--limit", "2", "--iters", "1",
                             "--device", "cpu", "--refresh-artifact",
                             str(tmp_path / "a")]) == 0
    assert "refreshed" in capsys.readouterr().out
    got = prepare.load(tmp_path / "a", map_location="cpu")
    assert got.device == "cpu" and len(got.schedule) == 2
    assert all(k.endswith("|cpu") for k in got.schedule)
