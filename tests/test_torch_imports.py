"""The port stands alone: importing every module of repro_torch pulls in
neither JAX nor the reference package (nor ml_dtypes), and its entry points
(the LM models, dense and SSM, the server, the vision models and launcher,
the training loop and launcher) default to the card, raising (not falling
back to the CPU) when there is none."""
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
             "repro_torch.train.loop", "repro_torch.launch.train"):
    assert name in names, name

import torch
from repro_torch import configs
from repro_torch.kernels import compat
from repro_torch.launch import train as launch_train
from repro_torch.launch import vision as launch_vision
from repro_torch.models.model import Model
from repro_torch.train import loop as train_loop
from repro_torch.serve.batcher import BatchServer
from repro_torch.vision import models as vm
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
                                        "--steps", "1"])):
    try:
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
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_no_reference_imports_in_sources():
    """The static form of the same rule, over every port source and
    chip_smoke.py."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    banned = ("import jax", "from jax", "ml_dtypes", "import repro.",
              "import repro ", "from repro.", "from repro ",
              "from repro import")
    for f in files:
        for n, line in enumerate(f.read_text().splitlines(), 1):
            assert not any(b in line for b in banned), f"{f}:{n}: {line}"
