"""The port's vision path (``core/workloads.py``, ``vision/layers.py``,
``vision/models.py``, the bridge and ``launch/vision.py``) against the
reference on identical weights and inputs. The reference's models run under
``GemmConfig(impl="pallas")``: its fused Pallas conv kernel in interpret mode,
with explicit (128, 128, 64) blocks to keep the interpret grids short.

Bars: float logits at the reference's model bar (rtol = atol = 2e-3,
tests/test_vision.py); int8 logits against the reference's at a relative L2
error of 1e-3 with the same top-1 (both sides make the same integer sums;
the float ops between layers - bias, pooling means - round in another
order, and an int8 step taken differently moves a few logits); the port's
fused int8 path bit for bit against its materialising int8 path (the
reference's contract, tests/test_vision.py); BN folding at the reference's
rtol = atol = 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import workloads as j_workloads
from repro.core.gemm import GemmConfig as JGemmConfig
from repro.core.gemm import use_gemm as j_use_gemm
from repro.vision import layers as jvl
from repro.vision import models as jvm
from repro_torch import bridge
from repro_torch.core import workloads
from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.launch import vision as launch_vision
from repro_torch.vision import layers as vl
from repro_torch.vision import models as vm

ALGOS = ["baseline", "fip", "ffip"]
J_BLOCK = (128, 128, 64)
# (model, image size, width_div, batch)
MODELS = [("alexnet", 67, 8, 2), ("vgg16", 32, 16, 1), ("resnet50", 32, 16, 1)]


def _numpy_tree(tree):
    """A reference parameter list as numpy arrays, Python ints and None
    kept as they are."""
    return jax.tree.map(lambda v: v if isinstance(v, int) else np.asarray(v),
                        tree)


@functools.lru_cache(maxsize=None)
def _case(name, size, div, batch):
    """The reference model, its initial weights and input, and the port's
    model with the same weights (shared by the fixtures below)."""
    jmodel = jvm.build(name, num_classes=10, image_size=size, width_div=div)
    jparams = jvm.init_params(jmodel, jax.random.PRNGKey(0))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                   (batch, size, size, 3)))
    model = vm.build(name, num_classes=10, image_size=size, width_div=div)
    return dict(name=name, jmodel=jmodel, jparams=jparams, x=x, model=model,
                params=bridge.params_from_numpy(_numpy_tree(jparams)))


@pytest.fixture(scope="module", params=MODELS, ids=[m[0] for m in MODELS])
def model_case(request):
    return _case(*request.param)


@pytest.fixture(scope="module")
def alexnet_int8():
    """AlexNet with the reference's int8 preparation (its own offline
    quantization) and its logits under the fused Pallas int8 path."""
    case = _case(*MODELS[0])
    jq = jvm.attach_quantized(case["jmodel"], case["jparams"])
    with j_use_gemm(JGemmConfig(algo="ffip", impl="pallas", quantized=True,
                                block=J_BLOCK)):
        want = jvm.apply(case["jmodel"], jq, jnp.asarray(case["x"]))
    return dict(case, jq=jq, want=np.asarray(want))


def test_model_logits_match_pallas(model_case):
    """For each algo: the port's plain path (F.conv2d / the materialising
    provider path) and its K7 path on the CPU (the plain fused conv)
    against the reference's fused Pallas path."""
    jx = jnp.asarray(model_case["x"])
    x = torch.from_numpy(model_case["x"])
    for algo in ALGOS:
        with j_use_gemm(JGemmConfig(algo=algo, impl="pallas", block=J_BLOCK)):
            want = np.asarray(jvm.apply(model_case["jmodel"],
                                        model_case["jparams"], jx))
        for impl in ("torch", "cuda"):
            with use_gemm(GemmConfig(algo=algo, impl=impl)):
                got = vm.apply(model_case["model"], model_case["params"], x)
            assert got.shape == (x.shape[0], 10)
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-3,
                                       atol=2e-3, err_msg=f"{algo} {impl}")


def test_int8_logits_match_reference(alexnet_int8):
    """The port's own offline int8 preparation and fused int8 path against
    the reference's; the port's fused (K7) int8 logits equal its
    materialising int8 path's bit for bit."""
    case, want = alexnet_int8, alexnet_int8["want"]
    model, x = case["model"], torch.from_numpy(case["x"])
    q = vm.attach_quantized(model, case["params"])
    with use_gemm(GemmConfig(algo="ffip", impl="cuda", quantized=True)):
        fused = vm.apply(model, q, x)
    with use_gemm(GemmConfig(algo="ffip", impl="torch", quantized=True)):
        plain = vm.apply(model, q, x)
    assert torch.equal(fused, plain)
    rel = float(np.linalg.norm(fused.numpy() - want) / np.linalg.norm(want))
    assert rel < 1e-3, rel
    np.testing.assert_array_equal(fused.argmax(-1).numpy(), want.argmax(-1))
    with use_gemm(GemmConfig(algo="baseline", impl="torch")):
        float_logits = vm.apply(model, case["params"], x)
    assert float(torch.linalg.norm(fused - float_logits)
                 / torch.linalg.norm(float_logits)) < 0.35


def test_bridge_carries_quantized_alexnet(alexnet_int8):
    """A reference ``attach_quantized`` AlexNet crosses the bridge with its
    parameterless layers as None and its conv bookkeeping as Python ints,
    every array equal, and runs in the port."""
    jq, want = alexnet_int8["jq"], alexnet_int8["want"]
    q = bridge.params_from_numpy(_numpy_tree(jq))
    model = alexnet_int8["model"]
    assert len(q) == len(model)
    for layer, jp, p in zip(model, jq, q):
        if jp is None:
            assert p is None
            continue
        for key, jv in jp.items():
            if key == "q":
                for qk, qv in jv.items():
                    if isinstance(qv, int):
                        assert type(p["q"][qk]) is int and p["q"][qk] == qv
                    else:
                        assert isinstance(p["q"][qk], torch.Tensor)
                        np.testing.assert_array_equal(p["q"][qk].numpy(),
                                                      np.asarray(qv))
            else:
                np.testing.assert_array_equal(p[key].numpy(), np.asarray(jv))
        if isinstance(layer, vm.Conv):
            assert set(p["q"]) == {"qw", "scale", "zp", "neg_beta", "colsum",
                                   "k_real", "kh", "kw", "groups"}
    with use_gemm(GemmConfig(algo="ffip", impl="cuda", quantized=True)):
        got = vm.apply(model, q, torch.from_numpy(alexnet_int8["x"]))
    rel = float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want))
    assert rel < 1e-3, rel


def test_structure_matches_reference():
    """Layer lists, conv geometries and the workload tables equal the
    reference's, at published widths and at smoke sizes."""
    for name, size, div in [("alexnet", 227, 1), ("vgg16", 224, 1),
                            ("resnet50", 224, 1), ("alexnet", 67, 8),
                            ("resnet50", 32, 16)]:
        model = vm.build(name, image_size=size, width_div=div)
        jmodel = jvm.build(name, image_size=size, width_div=div)
        assert [repr(l) for l in model] == [repr(l) for l in jmodel]
        geoms = [(repr(c), h, w) for c, h, w in
                 vm.conv_geometries(model, size)]
        assert geoms == [(repr(c), h, w) for c, h, w in
                         jvm.conv_geometries(jmodel, size)]
        assert [repr(c) for c in vm.conv_layers(model)] == \
            [repr(c) for c in jvm.conv_layers(jmodel)]
    assert len(vm.conv_layers(vm.build("resnet50"))) == 53
    for name in ("alexnet", "vgg16", "resnet50"):
        assert [repr(s) for s in workloads.CONV_SPECS[name]()] == \
            [repr(s) for s in j_workloads.CONV_SPECS[name]()]
        for batch in (1, 8):
            got = [(g.m, g.k, g.n, g.name, g.ops())
                   for g in workloads.MODELS[name](batch)]
            want = [(g.m, g.k, g.n, g.name, g.ops())
                    for g in j_workloads.MODELS[name](batch)]
            assert got == want
        assert workloads.model_gops(name) == j_workloads.model_gops(name)
    assert workloads.ALEXNET_FCS == j_workloads.ALEXNET_FCS
    assert workloads.VGG16_FCS == j_workloads.VGG16_FCS


def test_fold_bn_matches_batchnorm_and_reference():
    rng = np.random.RandomState(0)
    p = {"w": rng.standard_normal((3, 3, 4, 8)).astype(np.float32) * 0.3,
         "b": rng.standard_normal(8).astype(np.float32)}
    bn = {"gamma": rng.uniform(0.5, 2.0, 8).astype(np.float32),
          "beta": rng.standard_normal(8).astype(np.float32),
          "mean": rng.standard_normal(8).astype(np.float32),
          "var": rng.uniform(0.2, 3.0, 8).astype(np.float32)}
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, 4)).astype(np.float32))
    tp, tbn = bridge.params_from_numpy(p), bridge.params_from_numpy(bn)
    want = vl.batchnorm(vl.conv2d(x, tp, pad=1), tbn)
    folded = vl.fold_bn(tp, tbn)
    np.testing.assert_allclose(vl.conv2d(x, folded, pad=1).numpy(),
                               want.numpy(), rtol=1e-4, atol=1e-4)
    jfolded = jvl.fold_bn({k: jnp.asarray(v) for k, v in p.items()},
                          {k: jnp.asarray(v) for k, v in bn.items()})
    for key in ("w", "b"):
        np.testing.assert_allclose(folded[key].numpy(),
                                   np.asarray(jfolded[key]), rtol=1e-6,
                                   atol=1e-7)
    # attach_quantized folds the given statistics before quantizing
    model = [vm.Conv("c", 3, 3, 4, 8, pad=(1, 1)), vm.Flatten()]
    q = vm.attach_quantized(model, [tp, None], bn_stats=[tbn, None])
    assert q[1] is None
    assert torch.equal(q[0]["w"], folded["w"])
    assert torch.equal(q[0]["q"]["qw"],
                       vl.attach_quantized_conv(folded)["q"]["qw"])


def test_layers_match_reference():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 9, 8, 3)).astype(np.float32)
    for size, stride, pad in [((3, 3), (2, 2), (1, 1)), ((2, 2), None, 0),
                              ((3, 2), (1, 2), (1, 0))]:
        got = vl.maxpool2d(torch.from_numpy(x), size=size, stride=stride,
                           pad=pad)
        want = jvl.maxpool2d(jnp.asarray(x), size=size, stride=stride,
                             pad=pad)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(vl.global_avgpool(torch.from_numpy(x)).numpy(),
                               np.asarray(jvl.global_avgpool(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    from repro_torch.models.layers import dense_init
    gen = torch.Generator().manual_seed(0)
    assert "q" in vl.attach_quantized_fc(
        dense_init(gen, 6, 4, torch.float32, device="cpu"))
    assert "q" not in vl.attach_quantized_fc(
        dense_init(gen, 7, 4, torch.float32, device="cpu"))
    p = vl.conv_init(gen, 3, 3, 4, 8, groups=2)
    assert p["w"].shape == (3, 3, 2, 8) and p["b"].shape == (8,)
    p = vl.conv_init(gen, 3, 3, 3, 8)
    with use_gemm(GemmConfig(algo="ffip", impl="cuda", block="auto")):
        with pytest.raises(NotImplementedError, match="item 14"):
            vl.conv2d(torch.from_numpy(x), p, pad=1)


@pytest.mark.parametrize("quantized", [False, True])
def test_launcher_smoke_on_cpu(quantized, capsys):
    argv = ["--model", "alexnet", "--smoke", "--device", "cpu",
            "--gemm-impl", "cuda"] + (["--quantized"] if quantized else [])
    assert launch_vision.main(argv) == 0
    out = capsys.readouterr().out
    assert out.strip().endswith("OK")
    assert f"quantized={quantized}" in out
