"""Training on a mesh through its entry points on the CPU: the launcher's
``--mesh-data 2`` run gives the single-device history (rtol 1e-4, the
train-step bar of tests/test_torch_train.py), and chip_smoke.py's phase
dist train rehearsed at the smoke widths in bf16 finds no problem (the
card runs it at the published widths)."""
import numpy as np

from repro_torch.launch import train as launch_train


def test_launcher_trains_on_a_data_mesh(capsys):
    argv = ["--arch", "minicpm-2b", "--smoke", "--device", "cpu", "--steps",
            "3", "--batch", "4", "--seq", "16"]
    mesh = launch_train.main(argv + ["--mesh-data", "2"])
    single = launch_train.main(argv)
    assert "done on a 2 x 1 mesh on cpu" in capsys.readouterr().out
    assert len(mesh["history"]) == len(single["history"]) == 2
    for a, b in zip(mesh["history"], single["history"]):
        assert a["data_step"] == b["data_step"]
        for k in ("loss", "grad_norm", "lr", "step"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4)


def test_chip_smoke_phase_dist_train_rehearsal():
    """chip_smoke.py's phase dist train rehearsed on the CPU at the smoke
    widths in the card's bf16: its checks (the gradients under GRAD_BAR
    against one device's step, the planted fault above it, the keep
    masks, each rank's collectives against the meta trace, the checkpoint
    across mesh shapes) find no problem."""
    import pathlib
    import sys
    import types

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    runs = tuple((arch, layers, batch, 16, shapes) for arch, layers, batch,
                 _, shapes in chip_smoke.DIST_TRAIN_RUNS)
    problems = []
    by_rank = chip_smoke.run_dist_train(types.SimpleNamespace(seed=0),
                                        problems, runs=runs, device="cpu",
                                        smoke=True)
    assert problems == []
    assert len(by_rank) == 2
