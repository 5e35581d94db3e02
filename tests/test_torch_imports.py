"""The port stands alone: importing every module of repro_torch (the
observability package, the router, the fault plans, the tuner and the
prepared artifacts and the distribution package included) pulls in
neither JAX nor the reference package (nor ml_dtypes), and its entry points
(the LM models, dense and SSM, the server, the serve launcher with its
router, the vision models and launcher, the training loop and launcher,
the tune and prepare launchers and the artifact loader, the
tensor-parallel launcher, the mesh training launcher and the five
examples/torch_*.py) default to the card, raising (not falling back to the
CPU) when there is none; the examples import nothing of JAX or the
reference either."""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro.") or m.startswith("ml_dtypes"))
assert not bad, bad
assert len(names) >= 20, names
for name in ("repro_torch.optim.adamw", "repro_torch.data.pipeline",
             "repro_torch.ckpt.manager", "repro_torch.watchdog",
             "repro_torch.train.watchdog", "repro_torch.train.step",
             "repro_torch.train.loop", "repro_torch.launch.train",
             "repro_torch.core.analytical", "repro_torch.obs",
             "repro_torch.obs.metrics", "repro_torch.obs.trace",
             "repro_torch.obs.window", "repro_torch.obs.slo",
             "repro_torch.obs.profile", "repro_torch.serve.router",
             "repro_torch.serve.faults", "repro_torch.serve.lifecycle",
             "repro_torch.launch.obs_check", "repro_torch.launch.dash",
             "repro_torch.tune", "repro_torch.tune.space",
             "repro_torch.tune.cache", "repro_torch.tune.measure",
             "repro_torch.launch.tune", "repro_torch.prepare",
             "repro_torch.prepare.artifact", "repro_torch.launch.prepare",
             "repro_torch.dist", "repro_torch.dist.context",
             "repro_torch.dist.sharding", "repro_torch.dist.parity",
             "repro_torch.launch.mesh", "repro_torch.launch.costs",
             "repro_torch.launch.roofline", "repro_torch.launch.inputs",
             "repro_torch.launch.dryrun", "repro_torch.launch.report"):
    assert name in names, name

import torch
from repro_torch import configs
from repro_torch.kernels import compat
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch import vision as launch_vision
from repro_torch.launch import prepare as launch_prepare
from repro_torch.launch import tune as launch_tune
from repro_torch import prepare
from repro_torch.models.model import Model
from repro_torch.train import loop as train_loop
from repro_torch.serve.batcher import BatchServer
from repro_torch.vision import models as vm
import contextlib, importlib.util, io, pathlib
examples = []
for path in sorted(pathlib.Path(EXAMPLES).glob("torch_*.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    examples.append(importlib.util.module_from_spec(spec))
    spec.loader.exec_module(examples[-1])
assert len(examples) == 5, examples
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
assert not torch.cuda.is_available()
assert compat.device_kind() == "cpu"
cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
ssm = configs.smoke_config(configs.get_config("falcon-mamba-7b"))
alexnet = vm.build("alexnet", num_classes=10, image_size=67, width_div=8)
for make in (lambda: Model(cfg), lambda: Model(ssm),
             lambda: compat.resolve_device(None),
             lambda: BatchServer(Model(cfg, device="cpu"), batch_slots=1,
                                 max_len=8),
             lambda: vm.init_params(alexnet, 0),
             lambda: launch_vision.main(["--model", "alexnet", "--smoke"]),
             lambda: train_loop.train(Model(cfg),
                                      loop_cfg=train_loop.LoopConfig()),
             lambda: launch_train.main(["--arch", "minicpm-2b", "--smoke",
                                        "--steps", "1"]),
             lambda: launch_serve.main(["--arch", "minicpm-2b", "--smoke",
                                        "--replicas", "2"]),
             lambda: launch_serve.main(["--arch", "minicpm-2b", "--smoke",
                                        "--mesh-model", "2"]),
             lambda: launch_tune.main(["--arch", "minicpm-2b", "--smoke"]),
             lambda: launch_prepare.main(["--arch", "minicpm-2b", "--smoke",
                                          "--out", "unused"]),
             lambda: prepare.load("unused"),
             lambda: launch_train.main(["--arch", "minicpm-2b", "--smoke",
                                        "--mesh-data", "2"])) + tuple(
        (lambda m=m: m.main([])) for m in examples):
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            make()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise AssertionError("device=None must raise without a card")
print("OK", len(names))
"""


def test_port_imports_no_jax_and_needs_a_card():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    probe = _PROBE.replace("EXAMPLES", repr(str(ROOT / "examples")))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_no_reference_imports_in_sources():
    """The static form of the same rule, over every port source,
    chip_smoke.py and the port's examples."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    banned = ("import jax", "from jax", "ml_dtypes", "import repro.",
              "import repro ", "from repro.", "from repro ",
              "from repro import")
    for f in files:
        for n, line in enumerate(f.read_text().splitlines(), 1):
            assert not any(b in line for b in banned), f"{f}:{n}: {line}"
