"""Tensor-parallel serving in the port (BatchServer(mesh=) on two gloo
ranks on the CPU) against single-device serving, mirroring
tests/test_dist_serve.py: the TP tokens equal the reference's
single-device tokens on the bridged weights and the port's own, for
minicpm-2b (GQA) and deepseek-v2-lite-16b (MLA + MoE, both partitions),
float and int8 FFIP (the port's int8 GEMMs through gemm_impl="cuda", the
kernels' plain versions here); a prepared artifact cut per rank serves
them with recomputed == 0; decode_chunk=2 gives them too; paged with a
mesh and a bad moe_partition are refused, an encoder-decoder serves on a
mesh; the int8 column- and
row-parallel layers equal the whole layer bit for bit
(repro_torch.dist.parity); the launcher's --mesh-model 2
--compare-single-device exits 0, and with --replicas 2 --fault-plan flaky
too, while --paged is refused; and a rank that raises fails the run
within its time limit. The ranks are spawned once for all the serving
cases (launch.serve.spawn_ranks: a file:// store under a temporary
directory, one intra-op thread a rank)."""
import dataclasses
import functools
import threading
import time

import jax
import numpy as np
import pytest
import torch

import torch_rank_jobs as jobs
from repro import configs as jcfg
from repro.models.model import build_model as j_build
from repro.serve.batcher import BatchServer as JServer
from repro.serve.batcher import Request as JRequest
from repro_torch import bridge, configs, prepare
from repro_torch.dist import context as dctx
from repro_torch.dist import parity
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import Model
from repro_torch.serve.batcher import BatchServer, Request

MAX_LEN = 48
ARCHS = ("minicpm-2b", "deepseek-v2-lite-16b")
INT8 = dict(quantized=True, gemm_impl="cuda", gemm_algo="ffip")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread keeps them from contending
    with the other test workers' threads (each rank takes one too)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax(arch, cfg_update=None):
    jc = jcfg.smoke_config(jcfg.get_config(arch))
    tc = configs.smoke_config(configs.get_config(arch))
    if cfg_update:
        jc = dataclasses.replace(jc, **cfg_update)
        tc = dataclasses.replace(tc, **cfg_update)
    jm = j_build(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tc, bridge.params_from_numpy(jax.tree.map(np.asarray, jp))


def _prompts(vocab, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)) for n in lens]


def _ref(jm, jp, prompts, quantized):
    srv = JServer(jm, batch_slots=2, max_len=MAX_LEN, quantized=quantized)
    for i, p in enumerate(prompts):
        srv.submit(JRequest(rid=i, prompt=p, max_new_tokens=4))
    return {r.rid: list(r.out_tokens) for r in srv.run_until_drained(jp)}


def _single(cfg, params, prompts, **kw):
    _, done, _ = launch_serve.serve(Model(cfg, device="cpu"), params,
                                    prompts, max_new=4, batch_slots=2,
                                    max_len=MAX_LEN, **kw)
    return {r.rid: list(r.out_tokens) for r in done}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every serving case on one spawn of two ranks, which serve while this
    process runs the reference and the port on one device: {case: (rank
    0's result, rank 1's, the reference's tokens or None, the port's
    single-device tokens)}."""
    cases, job_list, jax_models = {}, [], {}

    def add(name, cfg, params, prompts, server_kw, ref, **extra):
        single = dict(server_kw)
        single.pop("moe_partition", None)
        cases[name] = (ref, functools.partial(_single, cfg, params, prompts,
                                              **single))
        job_list.append((jobs.serve_tokens, dict(
            cfg=cfg, params=params, prompts=prompts, max_new=4,
            server_kw=dict(server_kw, batch_slots=2, max_len=MAX_LEN),
            **extra)))

    for arch in ARCHS:
        jm, jp, cfg, params = _jax(arch)
        prompts = _prompts(cfg.vocab, 7, (5, 9, 3))
        jax_models[arch] = (jm, jp, prompts)
        parts = ("expert", "ffn") if cfg.moe else ("expert",)
        for quantized in (False, True):
            for part in parts:
                kw = dict(INT8 if quantized else {}, moe_partition=part)
                add(f"{arch} {'int8' if quantized else 'float'} {part}",
                    cfg, params, prompts, kw, (arch, quantized))
        if arch == "minicpm-2b":
            add("decode_chunk 2", cfg, params, _prompts(cfg.vocab, 9, (5, 8)),
                dict(decode_chunk=2), None)
            add("float ffip", cfg, params, prompts,
                dict(gemm_impl="cuda", gemm_algo="ffip"), None)
            add("block auto", cfg, params, prompts,
                dict(INT8, gemm_block="auto"), None)
            art = tmp_path_factory.mktemp("tp") / "a"
            prepare.prepare_lm(params, quantized=True).save(art)
            add("prepared int8", cfg, params, prompts, INT8, (arch, True),
                prepared=str(art))
    # q heads split, kv heads whole (KV % tp != 0): each rank reads the
    # kv head of each of its q heads
    _, _, cfg, params = _jax("minicpm-2b", dict(n_kv_heads=1))
    add("kv heads whole", cfg, params, _prompts(cfg.vocab, 7, (5, 9, 3)),
        INT8, None)
    job_list.append((parity.layer_parity, dict(
        shapes=[(5, 32, 48), (3, 64, 16)], dtype="f32")))

    ranks = {}

    def spawn():
        try:
            ranks["out"] = launch_serve.spawn_ranks(2, job_list,
                                                    device="cpu",
                                                    timeout_s=600)
        except launch_serve.RankError as e:
            ranks["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    refs, want = {}, {}
    try:
        for name, (ref, single) in cases.items():
            if ref is not None and ref not in refs:
                jm, jp, prompts = jax_models[ref[0]]
                refs[ref] = _ref(jm, jp, prompts, ref[1])
            want[name] = (refs.get(ref), single())
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    out = ranks["out"]
    result = {name: (out[0][i], out[1][i], *want[name])
              for i, name in enumerate(cases)}
    result["parity"] = (out[0][-1], out[1][-1])
    return result


@pytest.mark.parametrize("case", [
    f"{a} {t} {p}" for a in ARCHS for t in ("float", "int8")
    for p in (("expert", "ffn") if a.startswith("deepseek") else ("expert",))])
def test_tp_decode_tokens_identical_to_single_device(tp_runs, case):
    r0, r1, ref, single = tp_runs[case]
    assert r0["tokens"] == ref
    assert r0["tokens"] == single
    assert r1["tokens"] == r0["tokens"]


def test_tp_ranks_serve_their_pieces(tp_runs):
    """The ranks ran on local pieces: half the heads of wq and wo each."""
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    width = cfg.n_heads * cfg.hd
    for r in tp_runs["minicpm-2b int8 expert"][:2]:
        assert r["shapes"]["wq"][-1] == width // 2
        assert r["shapes"]["wo"][-2] == width // 2


def test_tp_decode_from_prepared_artifact(tp_runs):
    r0, r1, ref, single = tp_runs["prepared int8"]
    assert r0["tokens"] == ref == single
    assert r0["recomputed"] == 0 and r1["recomputed"] == 0


@pytest.mark.parametrize("case", ["decode_chunk 2", "float ffip",
                                  "kv heads whole"])
def test_tp_variants_identical_to_single_device(tp_runs, case):
    r0, r1, _, single = tp_runs[case]
    assert r0["tokens"] == single
    assert r1["tokens"] == r0["tokens"]


def test_tp_block_auto_looks_up_local_buckets(tp_runs):
    """Under a mesh ``gemm_block="auto"`` looks up each rank's local (K, N)
    buckets (here all misses: no schedule is tuned for them) and takes the
    static default, with the single device's tokens."""
    r0, r1, _, single = tp_runs["block auto"]
    assert r0["tokens"] == single == r1["tokens"]
    keys = " ".join(r0["tune_missed"])
    # smoke minicpm: wq / wk / wv (64, 64) and wo (64, 64) whole; a rank
    # runs (64, 32) and (32, 64), and up / gate (64, 128) as (64, 64)
    assert "n32k64" in keys and "n64k32" in keys
    assert "n128k64" not in keys


def test_tp_int8_layers_bit_for_bit(tp_runs):
    for result in tp_runs["parity"]:
        assert result, "no layer checked"
        bad = {k: v for k, v in result.items() if not v["ok"]}
        assert not bad, bad
        assert all(v["max_abs_err"] == 0.0
                   for k, v in result.items() if k.startswith("int8"))


def test_mesh_rejects_paged_and_bad_moe_partition():
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    model = Model(cfg, device="cpu")
    mesh = dctx.make_host_mesh()
    with pytest.raises(NotImplementedError, match="paged"):
        BatchServer(model, batch_slots=2, max_len=MAX_LEN, device="cpu",
                    mesh=mesh, paged=True)
    with pytest.raises(ValueError, match="moe_partition"):
        BatchServer(model, batch_slots=2, max_len=MAX_LEN, device="cpu",
                    moe_partition="bogus")
    # an encoder-decoder serves on a mesh (tests/test_torch_dist_families.py
    # holds it to the reference at tp 2)
    encdec = Model(configs.smoke_config(configs.get_config("whisper-small")),
                   device="cpu")
    srv = BatchServer(encdec, batch_slots=2, max_len=MAX_LEN, device="cpu",
                      mesh=mesh)
    srv.submit(Request(rid=0, prompt=np.arange(5), max_new_tokens=2))
    assert len(srv.run_until_drained(encdec.init(0))[0].out_tokens) == 2


def test_launch_serve_mesh_model_compare_single_device(capsys):
    launch_serve.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
                       "--slots", "2", "--requests", "3", "--max-new", "3",
                       "--quantized", "--gemm-impl", "cuda",
                       "--mesh-model", "2", "--compare-single-device"])
    out = capsys.readouterr().out
    assert "gloo on cpu, cpu" in out
    assert "compare-single-device: 9 tokens identical at tp=2" in out
    assert out.rstrip().endswith("OK")
    with pytest.raises(SystemExit, match="paged"):
        launch_serve.main(["--arch", "minicpm-2b", "--smoke", "--device",
                           "cpu", "--mesh-model", "2", "--paged"])
    # the router's replicas on the mesh, under the flaky fault plan: every
    # request DONE with its oracle's tokens, the ranks' routers in step
    launch_serve.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
                       "--slots", "2", "--requests", "3", "--max-new", "3",
                       "--mesh-model", "2", "--replicas", "2",
                       "--fault-plan", "flaky"])
    out = capsys.readouterr().out
    assert "3/3 done" in out and "faults[" in out
    assert "3 requests' tokens identical on 2 ranks" in out
    assert out.rstrip().endswith("OK")


def test_a_failed_rank_fails_the_run_in_time():
    t0 = time.monotonic()
    with pytest.raises(launch_serve.RankError, match="exited with code"):
        launch_serve.spawn_ranks(2, [(jobs.die_on_rank_1, {})],
                                 device="cpu", timeout_s=120)
    assert time.monotonic() - t0 < 60
