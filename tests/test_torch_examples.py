"""The port's five examples (examples/torch_*.py, the counterparts of the
reference's examples/*.py through repro_torch only) run on the CPU at their
smoke sizes (``--device cpu``; the training driver at its micro preset)
and end in their own checks' "OK"."""
import importlib.util
import pathlib

import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread keeps them from contending
    with the other test workers' threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,argv", [
    ("torch_quickstart", []),
    ("torch_serve_batch", []),
    ("torch_cnn_inference", []),
    ("torch_quantized_ffip_inference", []),
    ("torch_train_tiny_lm", ["--preset", "micro", "--steps", "30"]),
])
def test_example_runs_on_the_cpu(name, argv, tmp_path, capsys):
    if name == "torch_train_tiny_lm":
        argv = argv + ["--ckpt-dir", str(tmp_path / "ckpt")]
    _load(name).main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().splitlines()[-1].startswith("OK")
    assert "cuda" not in out


def test_train_example_resumes_after_a_crash(tmp_path, capsys):
    """--simulate-crash exits mid-run; the next invocation resumes from the
    last checkpoint and finishes."""
    mod = _load("torch_train_tiny_lm")
    argv = ["--preset", "micro", "--steps", "30", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ckpt")]
    with pytest.raises(SystemExit) as e:
        mod.main(argv + ["--simulate-crash", "26"])
    assert e.value.code == 42
    mod.main(argv)
    out = capsys.readouterr().out
    assert "SIMULATED CRASH" in out
    # the crash came at step 29's log, after the checkpoint at step 25:
    # the rerun starts there, not at step 0
    resumed = out.split("SIMULATED CRASH")[1]
    assert "step     0" not in resumed and "step    25" in resumed
    assert out.rstrip().endswith("OK")
