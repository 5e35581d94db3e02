"""The port's training path against the reference's: the chunked
cross-entropy, Model.loss and its gradients (minicpm-2b and falcon-mamba-7b
smoke configs, f32, so the flash K4 + K8 and scan K6 + K9 Functions run
their plain versions), remat, AdamW and its schedules, the data pipeline,
checkpoints in both directions, the train step with and without microbatches,
the resumable loop and the launcher.

Inputs come from numpy with a seed; weights are the reference's, carried
across by repro_torch.bridge. The reference runs as its own tests run it
(JAX on the CPU, Pallas in interpret mode).

Bars:
- chunked CE: rtol 1e-6 (one f32 logsumexp per row, summed).
- Model.loss: rtol 1e-5; each gradient leaf rtol 1e-3, atol 1e-3 *
  max|leaf| (the reference's own scan-gradient bar,
  tests/test_selective_scan.py:88).
- AdamW: rtol 1e-6 for params, m and v, and for the learning rates.
- Pipeline batches and f32 checkpoints: bit for bit.
- Train-step losses and loop histories: rtol 1e-4.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.ckpt.manager import CheckpointManager as JCkpt
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro.train import step as jstep
from repro_torch import bridge, configs
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data import pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train import loop, step
from repro_torch.train.watchdog import HangError, StepWatchdog, WatchdogConfig

ARCHS = ("minicpm-2b", "falcon-mamba-7b")
B, S = 2, 16


def _np(x):
    return np.asarray(x, np.float64)


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """(reference model, its params, port model, the same params bridged,
    a batch as numpy)."""
    jc = jcfg.smoke_config(jcfg.get_config(request.param))
    jm = JM.build_model(jc)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = configs.smoke_config(configs.get_config(request.param))
    m = M.Model(cfg, device="cpu")
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    ds = jpipe.SyntheticLM(jpipe.DataConfig(global_batch=B, seq_len=S,
                                            vocab=jc.vocab, seed=3))
    return jm, jparams, m, params, ds.batch_at(0)


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --- loss and gradients ------------------------------------------------------

@pytest.mark.parametrize("s", [512, 96])
def test_chunked_cross_entropy_matches_reference(s):
    jc = jcfg.smoke_config(jcfg.get_config("minicpm-2b"))
    jparams = JM.build_model(jc).init(jax.random.PRNGKey(1))
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    rng = np.random.default_rng(s)
    hidden = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    labels = rng.integers(0, jc.vocab, (2, s)).astype(np.int32)
    want = JM.chunked_cross_entropy(jparams, jnp.asarray(hidden),
                                    jnp.asarray(labels), jc)
    got = M.chunked_cross_entropy(
        bridge.params_from_numpy(jax.tree.map(np.asarray, jparams)),
        torch.from_numpy(hidden), torch.from_numpy(labels), cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_loss_and_grads_match_reference(smoke):
    jm, jparams, m, params, batch = smoke
    jloss, jgrads = jax.value_and_grad(jm.loss)(jparams, _jbatch(batch))
    leaves = adamw.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = m.loss(params, _tbatch(batch))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = _leaves_np(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max())


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_numbers_of_none(smoke, remat):
    _, _, m, params, batch = smoke
    leaves = adamw.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = {}
    for mode in ("none", remat):
        mm = M.Model(dataclasses.replace(m.cfg, remat=mode), device="cpu")
        loss = mm.loss(params, _tbatch(batch))
        out[mode] = (loss.detach(), torch.autograd.grad(loss, leaves))
    torch.testing.assert_close(out[remat][0], out["none"][0], rtol=0, atol=0)
    for a, b in zip(out[remat][1], out["none"][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# --- AdamW ---------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedule_lr_matches_reference(schedule):
    cfg = dict(lr=1e-3, schedule=schedule, warmup_steps=4, total_steps=20)
    jc, tc = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    for s in range(21):
        np.testing.assert_allclose(
            float(adamw.schedule_lr(tc, torch.tensor(s, dtype=torch.int32))),
            float(jadamw.schedule_lr(jc, jnp.asarray(s, jnp.int32))),
            rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_reference(clip):
    rng = np.random.default_rng(5)
    shapes = {"w": (6, 5), "b": {"x": (4,), "y": (3, 2, 2)}}

    def tree(scale):
        return jax.tree.map(
            lambda shp: (rng.standard_normal(shp) * scale).astype(np.float32),
            shapes, is_leaf=lambda t: isinstance(t, tuple))

    cfg = dict(lr=1e-2, schedule="wsd", warmup_steps=1, total_steps=4,
               grad_clip=clip)
    jc, tc = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    p0 = tree(1.0)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jadamw.init(jp)
    tp = bridge.params_from_numpy(p0)
    ts = adamw.init(tp)
    for _ in range(4):
        g = tree(3.0)
        jp, js = jadamw.update(jc, jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = adamw.update(tc, bridge.params_from_numpy(g), ts, tp)
        np.testing.assert_allclose(float(adamw.global_norm(
            bridge.params_from_numpy(g))), float(jadamw.global_norm(g)),
            rtol=1e-6)
    assert int(ts.step) == int(js.step) == 4
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(adamw.tree_leaves(got), _leaves_np(want)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=0)


def test_adamw_updates_large_leaves_in_slices(monkeypatch):
    """A leaf above the slice size is updated some rows at a time, with the
    numbers of the whole-leaf update."""
    rng = np.random.default_rng(6)
    p0 = {"w": rng.standard_normal((10, 8)).astype(np.float32)}
    g = {"w": rng.standard_normal((10, 8)).astype(np.float32)}
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    whole = adamw.update(cfg, bridge.params_from_numpy(g),
                         adamw.init(bridge.params_from_numpy(p0)),
                         bridge.params_from_numpy(p0))
    monkeypatch.setattr(adamw, "_SLICE_ELEMS", 20)
    assert len(list(adamw._slices(torch.zeros(10, 8)))) == 5   # 2 rows each
    sliced = adamw.update(cfg, bridge.params_from_numpy(g),
                          adamw.init(bridge.params_from_numpy(p0)),
                          bridge.params_from_numpy(p0))
    for a, b in zip(adamw.tree_leaves(sliced), adamw.tree_leaves(whole)):
        assert torch.equal(a, b)


def test_train_step_takes_the_gradient_norm_once(monkeypatch):
    """The step's ``grad_norm`` metric is the norm AdamW clipped with: one
    pass over the gradients, not two."""
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    m = M.Model(cfg, device="cpu")
    params = m.init(0)
    ds = pipeline.SyntheticLM(pipeline.DataConfig(global_batch=B, seq_len=S,
                                                  vocab=cfg.vocab, seed=3))
    norms = []
    real = adamw.global_norm

    def counted(tree):
        norms.append(real(tree))
        return norms[-1]

    monkeypatch.setattr(adamw, "global_norm", counted)
    fn = step.make_train_step(m, step.TrainConfig(
        optimizer=adamw.AdamWConfig(grad_clip=1e-3)))
    _, _, metrics = fn(params, adamw.init(params), _tbatch(ds.batch_at(0)))
    assert len(norms) == 1
    assert metrics["grad_norm"] is norms[0] and float(norms[0]) > 1e-3


@pytest.mark.parametrize("microbatch", [0, 1])
def test_train_step_sums_16bit_gemms_in_f32(microbatch, monkeypatch):
    """The step's forward and backward run with cuBLAS's 16-bit split-K
    sums off (``step.f32_sums``), one card and a mesh alike, and the
    process's setting is put back after the step."""
    mm = torch.backends.cuda.matmul
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    m = M.Model(cfg, device="cpu")
    params = m.init(0)
    ds = pipeline.SyntheticLM(pipeline.DataConfig(global_batch=B, seq_len=S,
                                                  vocab=cfg.vocab, seed=3))
    seen = []
    real = M.Model.loss

    def flags(when):
        seen.append((when, mm.allow_bf16_reduced_precision_reduction,
                     mm.allow_fp16_reduced_precision_reduction))

    def loss(self, p, batch):
        flags("forward")
        out = real(self, p, batch)
        out.register_hook(lambda g: flags("backward"))
        return out

    monkeypatch.setattr(M.Model, "loss", loss)
    fn = step.make_train_step(m, step.TrainConfig(microbatch=microbatch))
    saved = (mm.allow_bf16_reduced_precision_reduction,
             mm.allow_fp16_reduced_precision_reduction)
    mm.allow_bf16_reduced_precision_reduction = True
    mm.allow_fp16_reduced_precision_reduction = True
    try:
        fn(params, adamw.init(params), _tbatch(ds.batch_at(0)))
        after = (mm.allow_bf16_reduced_precision_reduction,
                 mm.allow_fp16_reduced_precision_reduction)
    finally:
        (mm.allow_bf16_reduced_precision_reduction,
         mm.allow_fp16_reduced_precision_reduction) = saved
    calls = max(1, B // microbatch if microbatch else 1)
    assert seen == [("forward", False, False),
                    ("backward", False, False)] * calls
    assert after == (True, True)


def test_int8_error_feedback_matches_reference():
    rng = np.random.default_rng(7)
    g = {"a": rng.standard_normal((5, 3)).astype(np.float32),
         "b": {"c": rng.standard_normal((4,)).astype(np.float32)}}
    e = jax.tree.map(lambda x: (x * 0.01).astype(np.float32), g)
    jq, js, je = jadamw.ef_compress_tree(jax.tree.map(jnp.asarray, g),
                                         jax.tree.map(jnp.asarray, e))
    tq, ts, te = adamw.ef_compress_tree(bridge.params_from_numpy(g),
                                        bridge.params_from_numpy(e))
    for got, want in zip(adamw.tree_leaves(tq), _leaves_np(jq)):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in ((ts, js), (te, je)):
        for a, b in zip(adamw.tree_leaves(got), _leaves_np(want)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)


# --- data ------------------------------------------------------------------------

@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 1)])
def test_pipeline_batches_equal_the_reference(n_hosts, host_id):
    kw = dict(global_batch=4, seq_len=32, vocab=300, seed=11,
              n_hosts=n_hosts, host_id=host_id)
    mine = pipeline.SyntheticLM(pipeline.DataConfig(**kw))
    ref = jpipe.SyntheticLM(jpipe.DataConfig(**kw))
    for s in (0, 1, 7):
        a, b = mine.batch_at(s), ref.batch_at(s)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    pf = pipeline.make_pipeline(cfg, 2, 8, seed=2, start_step=3)
    steps = [next(pf) for _ in range(3)]
    pf.close()
    assert [s for s, _ in steps] == [3, 4, 5]
    want = jpipe.SyntheticLM(jpipe.DataConfig(global_batch=2, seq_len=8,
                                              vocab=cfg.vocab, seed=2))
    np.testing.assert_array_equal(steps[1][1]["tokens"],
                                  want.batch_at(4)["tokens"])


# --- checkpoints -------------------------------------------------------------------

def _state_trees():
    """A reference (params, AdamWState) and the same tree in the port."""
    rng = np.random.default_rng(8)
    p = {"w": rng.standard_normal((8, 16)).astype(np.float32),
         "b": {"x": rng.standard_normal((4,)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, p)
    js = jadamw.init(jp)
    js = js._replace(step=jnp.asarray(3, jnp.int32),
                     m=jax.tree.map(lambda x: x * 0.5, jp),
                     v=jax.tree.map(lambda x: x * x, jp))
    tp = bridge.params_from_numpy(p)
    ts = adamw.AdamWState(step=torch.tensor(3, dtype=torch.int32),
                          m=adamw.tree_map(lambda x: x * 0.5, tp),
                          v=adamw.tree_map(lambda x: x * x, tp))
    return (jp, js), (tp, ts)


def _zeros_like(tree):
    return adamw.tree_map(torch.zeros_like, tree)


def test_reference_checkpoint_restores_in_the_port_and_back(tmp_path):
    (jp, js), (tp, ts) = _state_trees()
    JCkpt(tmp_path / "ref", async_save=False).save(
        3, (jp, js), extra={"data_step": 3})
    got, extra = CheckpointManager(tmp_path / "ref").restore(
        _zeros_like((tp, ts)))
    assert extra == {"data_step": 3}
    assert isinstance(got[1], adamw.AdamWState)
    for a, b in zip(adamw.tree_leaves(got), _leaves_np((jp, js))):
        assert str(a.dtype) == f"torch.{b.dtype}"
        np.testing.assert_array_equal(a.numpy(), b)
    mine = CheckpointManager(tmp_path / "port")     # an async write
    mine.save(5, (tp, ts), extra={"data_step": 5})
    mine.wait()
    back, extra = JCkpt(tmp_path / "port").restore(
        jax.tree.map(jnp.zeros_like, (jp, js)))
    assert extra == {"data_step": 5}
    for a, b in zip(_leaves_np(back), adamw.tree_leaves((tp, ts))):
        np.testing.assert_array_equal(a, b.numpy())


def test_ckpt_bf16_leaves_as_bits(tmp_path):
    """The port reads a two-byte bf16 file by its bits: the reference's own
    bf16 files and the port's earlier uint16 files ("bfloat16" in the
    manifest); and its own bf16 checkpoints round-trip bit for bit."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    jtree = {"w": jnp.asarray(x).astype(jnp.bfloat16)}
    JCkpt(tmp_path / "ref", async_save=False).save(1, jtree)
    tmpl = {"w": torch.zeros((3, 5), dtype=torch.bfloat16)}
    got, _ = CheckpointManager(tmp_path / "ref").restore(tmpl)
    want = bridge.params_from_numpy(jax.tree.map(np.asarray, jtree))
    assert torch.equal(got["w"].view(torch.int16), want["w"].view(torch.int16))
    mgr = CheckpointManager(tmp_path / "port", async_save=False)
    mgr.save(2, want)
    back, _ = mgr.restore(tmpl)
    assert torch.equal(back["w"].view(torch.int16),
                       want["w"].view(torch.int16))
    import json
    meta = json.loads((tmp_path / "port" / "step_00000002" /
                       "manifest.json").read_text())
    assert meta["dtypes"] == ["bfloat16"]
    # a file of the earlier format: the leaf's uint16 bits
    old = tmp_path / "port" / "step_00000002" / "arr_00000.npy"
    np.save(old, want["w"].view(torch.int16).numpy().view(np.uint16))
    back, _ = mgr.restore(tmpl)
    assert torch.equal(back["w"].view(torch.int16),
                       want["w"].view(torch.int16))


def test_ckpt_bf16_port_to_reference_bit_for_bit(tmp_path):
    """A bf16 tree saved by the port restores bit for bit in the reference:
    the port writes bf16 leaves as f32 values (each bf16 value is an f32),
    which the reference's astype(bfloat16) converts exactly; the manifest
    still says "bfloat16"."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((4, 6)).astype(np.float32) * 1e3
    x[0, :3] = [1.0, -2.0, 0.5]
    tree = bridge.params_from_numpy(
        {"b": np.asarray(jnp.asarray(x[:, :2]).astype(jnp.bfloat16)),
         "w": np.asarray(jnp.asarray(x).astype(jnp.bfloat16))})
    CheckpointManager(tmp_path, async_save=False).save(3, tree)
    import json
    meta = json.loads((tmp_path / "step_00000003" /
                       "manifest.json").read_text())
    assert meta["dtypes"] == ["bfloat16", "bfloat16"]
    got, _ = JCkpt(tmp_path).restore(
        {"b": jnp.zeros((4, 2), jnp.bfloat16),
         "w": jnp.zeros((4, 6), jnp.bfloat16)})
    for name in ("b", "w"):
        assert got[name].dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            np.asarray(got[name]).view(np.uint16),
            tree[name].view(torch.int16).numpy().view(np.uint16))


def test_ckpt_keep_n_and_interrupted_write(tmp_path):
    """tests/test_substrate.py's keep-N and atomicity checks on the port."""
    _, (tp, ts) = _state_trees()
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (10, 20, 30):
        mgr.save(s, tp, extra={"data_step": s})
    assert mgr.all_steps() == [20, 30]
    restored, extra = mgr.restore(_zeros_like(tp))
    assert extra["data_step"] == 30
    broken = tmp_path / "step_00000040.tmp"
    broken.mkdir()
    (broken / "arr_00000.npy").write_bytes(b"garbage")
    assert mgr.latest_step() == 30
    restored, _ = mgr.restore(_zeros_like(tp))
    for a, b in zip(adamw.tree_leaves(restored), adamw.tree_leaves(tp)):
        assert torch.equal(a, b)
    mgr.save(50, tp)
    assert not broken.exists()
    with pytest.raises(ValueError, match="tree mismatch"):
        mgr.restore({"w": tp["w"]})


# --- the train step, the loop, the launcher --------------------------------------

@pytest.mark.parametrize("microbatch", [0, 1])
def test_train_step_matches_reference(smoke, microbatch):
    jm, jparams, m, params, batch = smoke
    mb = microbatch * B // 2          # 0 or 1 of batch 2: two microbatches
    ocfg = dict(lr=1e-3, schedule="wsd", warmup_steps=1, total_steps=3)
    jfn = jax.jit(jstep.make_train_step(jm, jstep.TrainConfig(
        optimizer=jadamw.AdamWConfig(**ocfg), microbatch=mb)))
    tfn = step.make_train_step(m, step.TrainConfig(
        optimizer=adamw.AdamWConfig(**ocfg), microbatch=mb))
    ds = jpipe.SyntheticLM(jpipe.DataConfig(global_batch=B, seq_len=S,
                                            vocab=m.cfg.vocab, seed=4))
    jp, js = jparams, jadamw.init(jparams)
    tp = adamw.tree_map(torch.clone, params)
    ts = adamw.init(tp)
    for s in range(3):
        bt = ds.batch_at(s)
        jp, js, jmet = jfn(jp, js, _jbatch(bt))
        tp, ts, tmet = tfn(tp, ts, _tbatch(bt))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-4)
        assert int(tmet["step"]) == int(jmet["step"]) == s + 1


def test_loop_resumes_a_reference_checkpoint(tmp_path):
    """The reference trains 2 steps and checkpoints; the port resumes from
    that checkpoint to step 4, and so does the reference on a copy."""
    jc = jcfg.smoke_config(jcfg.get_config("minicpm-2b"))
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    tcfg = dict(lr=1e-3, schedule="wsd", warmup_steps=1, total_steps=4)
    lkw = dict(global_batch=2, seq_len=16, ckpt_every=2, log_every=1, seed=1)
    jloop.train(JM.build_model(jc), loop_cfg=jloop.LoopConfig(
        total_steps=2, ckpt_dir=str(tmp_path / "a"), **lkw),
        train_cfg=jstep.TrainConfig(optimizer=jadamw.AdamWConfig(**tcfg)))
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    ref = jloop.train(JM.build_model(jc), loop_cfg=jloop.LoopConfig(
        total_steps=4, ckpt_dir=str(tmp_path / "b"), **lkw),
        train_cfg=jstep.TrainConfig(optimizer=jadamw.AdamWConfig(**tcfg)))
    logged = []
    out = loop.train(M.Model(cfg, device="cpu"), loop_cfg=loop.LoopConfig(
        total_steps=4, ckpt_dir=str(tmp_path / "a"), **lkw),
        train_cfg=step.TrainConfig(optimizer=adamw.AdamWConfig(**tcfg)),
        log_fn=logged.append)
    assert [h["data_step"] for h in out["history"]] == [2, 3]
    assert logged == out["history"]
    for h, r in zip(out["history"], ref["history"]):
        assert h["data_step"] == r["data_step"]
        for k in ("loss", "grad_norm", "lr", "step"):
            np.testing.assert_allclose(h[k], r[k], rtol=1e-4)
    # the port's own checkpoint at step 4 holds its final state
    mgr = CheckpointManager(tmp_path / "a")
    assert mgr.latest_step() == 4
    (p, st), extra = mgr.restore((out["params"], out["opt_state"]))
    assert extra == {"data_step": 4} and int(st.step) == 4
    for a, b in zip(adamw.tree_leaves(p), adamw.tree_leaves(out["params"])):
        assert torch.equal(a, b.detach())


def test_launcher_trains_the_smoke_config(capsys):
    out = launch_train.main(["--arch", "minicpm-2b", "--smoke", "--device",
                             "cpu", "--steps", "3", "--batch", "2", "--seq",
                             "16"])
    assert len(out["history"]) == 2 and int(out["opt_state"].step) == 3
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert "done on cpu" in capsys.readouterr().out
    # --smoke --multi-pod trains on the one-rank host mesh, as the
    # reference's does: the same history
    pod = launch_train.main(["--arch", "minicpm-2b", "--smoke",
                             "--multi-pod", "--device", "cpu", "--steps",
                             "3", "--batch", "2", "--seq", "16"])
    assert pod["history"] == out["history"]
    for argv in (["--arch", "minicpm-2b"],
                 ["--arch", "minicpm-2b", "--multi-pod"],
                 ["--arch", "minicpm-2b", "--multi-pod", "--layers", "2"]):
        with pytest.raises(SystemExit, match="production mesh"):
            launch_train.main(argv + ["--device", "cpu"])


def test_serve_step_is_decode_step(smoke):
    _, _, m, params, batch = smoke
    cache = m.init_cache(B, S)
    tok = torch.from_numpy(batch["tokens"][:, :1].astype(np.int64))
    with torch.no_grad():
        _, want = m.decode_step(params, tok, m.init_cache(B, S), 0)
    _, got = step.make_serve_step(m)(params, tok, cache, 0)
    assert torch.equal(got, want)


def test_step_watchdog_flags_stragglers_and_hangs():
    now = [0.0]
    fired = []
    dog = StepWatchdog(WatchdogConfig(threshold=2.0, consecutive_to_act=2,
                                      hang_timeout_s=5.0),
                       on_straggler=lambda *a: fired.append(a),
                       clock=lambda: now[0])
    assert dog.loop == "train"
    for i, dt in enumerate([1.0, 1.0, 5.0, 5.0, 1.0]):
        dog.observe(i, dt)
    assert len(fired) == 1 and len(dog.events) == 2
    now[0] = 10.0
    with pytest.raises(HangError):
        dog.check_hang()
