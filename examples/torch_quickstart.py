"""Quickstart on the PyTorch/CUDA port: the paper's FFIP arithmetic end to
end, through ``repro_torch`` only.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

1. FIP/FFIP compute exact matmuls with about half the multiplications.
2. The FFIP CUDA kernel (K3) against the baseline product; with
   ``--device cpu`` its plain PyTorch version runs instead.
3. The GEMM provider swapped under a real model (starcoder2's smoke config)
   for a train step: the same loss, half the multiplies.
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import analytical as an
from repro_torch.core import fip
from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.train.step import TrainConfig, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda:0)")
    args = ap.parse_args(argv)
    gen = torch.Generator().manual_seed(0)

    # --- 1. the algebra ----------------------------------------------------
    m, k, n = 64, 128, 32
    a = torch.randn(m, k, generator=gen, dtype=torch.float64)
    b = torch.randn(k, n, generator=gen, dtype=torch.float64)
    c_base = a @ b
    c_fip = fip.fip_matmul(a, b)
    c_ffip = fip.ffip_matmul(a, b)
    print("max |FIP - baseline| :", float((c_fip - c_base).abs().max()))
    print("max |FFIP - baseline|:", float((c_ffip - c_base).abs().max()))
    print(f"multiplications: baseline={an.baseline_mults(m, k, n)} "
          f"fip={an.fip_mults(m, k, n)} "
          f"(ratio {an.fip_mults(m, k, n) / an.baseline_mults(m, k, n):.3f})")

    # --- 2. the kernel -------------------------------------------------------
    model = build_model(configs.smoke_config(
        configs.get_config("starcoder2-3b")), device=args.device)
    dev = model.device
    a32, b32 = a.float().to(dev), b.float().to(dev)
    c_kernel = ops.matmul(a32, b32, algo="ffip")
    err = float((c_kernel - a32 @ b32).abs().max())
    print(f"max |FFIP kernel - baseline| on {dev}: {err:.2e}")
    assert err < 1e-3

    # --- 3. under a real model ------------------------------------------------
    cfg = model.cfg
    params = model.init(0)
    step = make_train_step(model, TrainConfig())
    rng = np.random.default_rng(0)
    batch = {key: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32))).to(
        dev) for key in ("tokens", "labels")}
    losses = {}
    for algo in ("ffip", "baseline"):
        p = adamw.tree_map(torch.clone, params)
        with use_gemm(GemmConfig(algo=algo, impl="torch")):
            _, _, met = step(p, adamw.init(p), batch)
        losses[algo] = float(met["loss"])
    print(f"loss with FFIP GEMM provider: {losses['ffip']:.4f}")
    print(f"loss with baseline provider : {losses['baseline']:.4f}")
    np.testing.assert_allclose(losses["ffip"], losses["baseline"], rtol=1e-3)
    print("OK: identical model, identical numerics, half the multiplies.")


if __name__ == "__main__":
    main()
