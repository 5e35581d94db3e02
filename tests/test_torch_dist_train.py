"""Training on a ("data", "model") mesh in the port against the reference's
single-device step, mirroring tests/test_dist.py's sharded train step:
minicpm-2b, falcon-mamba-7b, zamba2-1.2b (2 layers each) and
deepseek-v2-lite-16b (3 layers, both MoE partitions) on two gloo ranks on
the CPU at (2, 1) and (1, 2), and minicpm-2b on four at (2, 2). Weights
cross from the reference through repro_torch.bridge; the batch comes from
numpy with a seed. The ranks run while this process runs the reference
(JAX on the CPU, its Pallas kernels in interpret mode).

deepseek's capacity factor is cut to 0.5 on both sides, so that the
global capacity drops assignments and the keep masks are a test of the
global rule (at the smoke config's 2.0 no expert ever fills).

Bars (f32 smoke configs):
- loss: rtol 1e-5; the gradient norm: rtol 1e-5 (the ranks' sums of
  squares summed in another order);
- every gradient leaf, gathered whole: rtol 1e-3, atol 1e-3 * max|leaf|
  (tests/test_torch_train.py's bar);
- one AdamW step: metrics rtol 1e-4 (test_torch_train.py's step bar), the
  params rtol 1e-4 and atol 2 lr (an element whose gradient is at the
  rounding floor may take Adam's first step, lr * sign(g), either way);
- MoE at (2, 1): each rank's keep mask equals the global rule on the
  gathered expert choices bit for bit, and the aux loss the reference's;
- checkpoints: bit for bit across mesh shapes and the reference's format.

The launcher's mesh runs and chip_smoke.py's phase rehearsed on the CPU
are in tests/test_torch_dist_train_launch.py.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_jobs as jobs
from repro import configs as jcfg
from repro.ckpt.manager import CheckpointManager as JCkpt
from repro.models import model as JM
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import bridge, configs
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.launch import serve as launch_serve
from repro_torch.optim import adamw

B, S = 4, 16
OPT = dict(lr=1e-3, schedule="const", warmup_steps=1, total_steps=4)
LAYERS = {"minicpm-2b": 2, "falcon-mamba-7b": 2, "zamba2-1.2b": 2,
          "deepseek-v2-lite-16b": 3}
CASES = [(arch, part, shape) for arch in LAYERS
         for part in (("expert", "ffn") if arch.startswith("deepseek")
                      else ("expert",))
         for shape in ((2, 1), (1, 2))]


def _name(arch, part, shape):
    tag = f" {part}" if arch.startswith("deepseek") else ""
    return f"{arch}{tag} {shape[0]}x{shape[1]}"


def _cfgs(arch, part="expert"):
    """The reference's and the port's config at the test's depth."""
    jc = jcfg.smoke_config(jcfg.get_config(arch))
    tc = configs.smoke_config(configs.get_config(arch))
    upd = dict(n_layers=LAYERS[arch])
    out = []
    for c in (jc, tc):
        kw = dict(upd)
        if c.moe is not None:
            kw["moe"] = dataclasses.replace(c.moe, capacity_factor=0.5,
                                            partition=part)
        out.append(dataclasses.replace(c, **kw))
    return out


def _batch(vocab, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _leaves(tree):
    return [np.asarray(x, np.float64) for x in adamw.tree_leaves(tree)]


def _reference(arch, batch):
    """The reference's loss, gradients, aux loss and one AdamW step on the
    global batch, one device."""
    jc, _ = _cfgs(arch)
    jm = JM.build_model(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(jm.loss)(jp, jb)
    _, aux, _ = JT.forward(jp, jb["tokens"], jc)
    fn = jax.jit(jstep.make_train_step(jm, jstep.TrainConfig(
        optimizer=jadamw.AdamWConfig(**OPT))))
    p1, _, met = fn(jp, jadamw.init(jp), jb)
    return dict(params=jp, loss=float(loss), grads=jax.tree.map(
        np.asarray, grads), aux=float(aux), step=jax.tree.map(np.asarray, p1),
        metrics={k: float(v) for k, v in met.items()})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on one spawn of two ranks (and minicpm-2b's (2, 2) on one
    of four), while this process runs the reference: {case: (each rank's
    result, the reference's)}."""
    batches = {arch: _batch(512, 5) for arch in LAYERS}
    bridged = {}
    for arch in LAYERS:
        jc, _ = _cfgs(arch)
        jp = JM.build_model(jc).init(jax.random.PRNGKey(0))
        bridged[arch] = bridge.params_from_numpy(jax.tree.map(np.asarray,
                                                              jp))
    jobs2 = [(jobs.train_on, dict(shape=shape, cfg=_cfgs(arch, part)[1],
                                  params=bridged[arch],
                                  batch=batches[arch], steps=1,
                                  optimizer=OPT))
             for arch, part, shape in CASES]
    d = tmp_path_factory.mktemp("ckpt")
    jc, tc = _cfgs("minicpm-2b")
    jp = JM.build_model(jc).init(jax.random.PRNGKey(0))
    JCkpt(d / "ref").save(0, (jp, jadamw.init(jp)), block=True)
    jobs2.append((jobs.ckpt_across, dict(
        cfg=tc, params=bridged["minicpm-2b"], batch=batches["minicpm-2b"],
        ckpt_dir=str(d / "mesh"), ref_dir=str(d / "ref"))))
    out = {}

    def spawn():
        try:
            out[2] = launch_serve.spawn_ranks((1, 2), jobs2, device="cpu",
                                              timeout_s=600)
            out[4] = launch_serve.spawn_ranks((2, 2), [(
                jobs.train_on, dict(
                    shape=(2, 2), cfg=tc, params=bridged["minicpm-2b"],
                    batch=batches["minicpm-2b"], steps=1, optimizer=OPT))],
                device="cpu", timeout_s=600)
        except launch_serve.RankError as e:
            out["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        refs = {arch: _reference(arch, batches[arch]) for arch in LAYERS}
    finally:
        thread.join()
    if "error" in out:
        raise out["error"]
    result = {_name(*case): ([r[i] for r in out[2]], refs[case[0]])
              for i, case in enumerate(CASES)}
    result["minicpm-2b 2x2"] = ([r[0] for r in out[4]], refs["minicpm-2b"])
    result["ckpt"] = ([r[-1] for r in out[2]], (jp, d))
    return result


NAMES = [_name(*c) for c in CASES] + ["minicpm-2b 2x2"]


@pytest.mark.parametrize("case", NAMES)
def test_loss_and_gradients_equal_the_single_device(runs, case):
    ranks, ref = runs[case]
    want = _leaves(ref["grads"])
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-5)
        got = _leaves(r["grads"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-3,
                                       atol=1e-3 * np.abs(w).max())
    # every rank's gathered gradients are the same bits
    for r in ranks[1:]:
        for a, b in zip(_leaves(r["grads"]), _leaves(ranks[0]["grads"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", NAMES)
def test_one_adamw_step_equals_the_reference(runs, case):
    ranks, ref = runs[case]
    for r in ranks:
        met = r["history"][0]
        assert met == ranks[0]["history"][0]
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(met[k], ref["metrics"][k],
                                       rtol=1e-5 if k == "grad_norm"
                                       else 1e-4)
        assert int(met["step"]) == 1
        for g, w in zip(_leaves(r["params"]), _leaves(ref["step"])):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=2 * OPT["lr"])


@pytest.mark.parametrize("case", NAMES)
def test_ranks_hold_their_pieces(runs, case):
    """Each rank's pieces: the reference's param_specs cut over "data" on
    its dim, the port's serving_specs cut over "model" (its widenings)."""
    from repro.dist import sharding as jshd

    ranks, ref = runs[case]
    arch = case.split()[0]
    part = "ffn" if " ffn " in case else "expert"
    shape = tuple(int(n) for n in case.split()[-1].split("x"))
    _, tc = _cfgs(arch, part)
    mesh = dctx.make_mesh(shape, ("data", "model"), connect=False)
    whole = bridge.params_from_numpy(jax.tree.map(np.asarray,
                                                  ref["params"]))
    jspecs = jshd.param_specs(whole, mesh, moe_partition=part)
    sspecs = shd.serving_specs(whole, mesh, tc, moe_partition=part)
    want = {}

    def walk(t, js, ss, path=""):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], js[k], ss[k], f"{path}{k}/")
            return
        shp = list(t.shape)
        for d, (j, s) in enumerate(zip(tuple(js), ss)):
            if s == "model":
                shp[d] //= shape[1]
            elif j == "data":
                shp[d] //= shape[0]
        want[path[:-1]] = tuple(shp)

    walk(whole, jspecs, sspecs)
    for r in ranks:
        assert r["shapes"] == want
    assert any(want[k] != tuple(v.shape) for k, v in _flat(whole).items())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("part", ["expert", "ffn"])
def test_moe_keep_mask_and_aux_are_global(runs, part):
    ranks, ref = runs[f"deepseek-v2-lite-16b {part} 2x1"]
    for r in ranks:
        assert len(r["keep"]) == LAYERS["deepseek-v2-lite-16b"] - 1
        assert r["keep"] == [0] * len(r["keep"])
        np.testing.assert_allclose(r["aux"], ref["aux"], rtol=1e-5)


def test_collectives_cover_both_axes_and_the_backward(runs):
    """One step's collectives on each rank: the same on every rank, and at
    (2, 1) over the data axis (the ZeRO gathers, the reduce-scatters, the
    loss's sum), at (1, 2) over the model axis."""
    for case in ("minicpm-2b 2x1", "minicpm-2b 1x2", "minicpm-2b 2x2"):
        ranks, _ = runs[case]
        recs = [r["collectives"] for r in ranks]
        assert all(r == recs[0] for r in recs)
        assert recs[0] and all(k == "all-reduce" for k, _, _ in recs[0])


def test_checkpoint_restores_across_mesh_shapes(runs):
    ranks, (jp, d) = runs["ckpt"]
    r0 = ranks[0]
    saved = adamw.tree_leaves(r0["saved"])
    for r in ranks:
        assert r["extra"] == {"data_step": 1}
        for a, b in zip(adamw.tree_leaves(r["restored"]), saved):
            assert torch.equal(a, b)
        for a, b in zip(adamw.tree_leaves(r["ref"][0]),
                        jax.tree_util.tree_leaves(jp)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the mesh's checkpoint restores whole on one device too
    (p, st), extra = CheckpointManager(d / "mesh").restore(
        adamw.tree_map(torch.zeros_like, r0["saved"]))
    assert extra == {"data_step": 1} and int(st.step) == 1
    for a, b in zip(adamw.tree_leaves((p, st)), saved):
        assert torch.equal(a, b)
    # each rank restored its (1, 2) pieces
    assert ranks[0]["shapes"] != [tuple(t.shape) for t in saved]
