"""CNN inference on the PyTorch/CUDA port through the fused implicit-im2col
(F)FIP conv kernel K7, through ``repro_torch`` only.

The paper's headline workloads are CNNs on an array that maps conv to GEMM
on the fly with the §5.1 address counters: no im2col matrix ever exists in
memory. This example runs a small AlexNet three ways and checks they agree:

  1. the float reference (the baseline provider's conv),
  2. the fused implicit-im2col FFIP kernel (K7 on the card; its plain
     version with ``--device cpu``),
  3. the int8 quantized path (offline weights: Eq. 15 folded beta and
     colsums on the flattened KH*KW*Cin axis; Eq. 20 zero-point adjuster
     with windowed row sums).

    PYTHONPATH=src python examples/torch_cnn_inference.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.kernels.compat import resolve_device
from repro_torch.vision import models as vm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda:0)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model = vm.build("alexnet", num_classes=10, image_size=67, width_div=8)
    params = vm.init_params(model, 0, device=dev)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 67, 67, 3, generator=gen).to(dev)

    # 1) float reference (default config: the baseline algorithm)
    with torch.no_grad():
        ref = vm.apply(model, params, x)
    print("float logits:", np.round(ref[0, :5].cpu().numpy(), 3))

    # 2) fused implicit-im2col FFIP: the same weights and topology, the
    #    conv -> GEMM mapping inside the kernel per (bm, bk) block
    with torch.no_grad(), use_gemm(GemmConfig(algo="ffip", impl="cuda")):
        fused = vm.apply(model, params, x)
    err = float((fused - ref).abs().max())
    print(f"fused FFIP max |delta| vs float: {err:.2e}")
    assert err < 1e-2

    # 3) int8 quantized: the weight preparation happens offline
    #    (attach_quantized), then the same forward runs on int8 operands
    qparams = vm.attach_quantized(model, params)
    with torch.no_grad(), use_gemm(GemmConfig(algo="ffip", impl="cuda",
                                              quantized=True)):
        q_logits = vm.apply(model, qparams, x)
    rel = float(torch.linalg.norm(q_logits - ref) / torch.linalg.norm(ref))
    agree = float((q_logits.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"int8 FFIP rel err: {rel:.4f}  top-1 agreement: {agree:.0%}")
    assert rel < 0.35

    print(f"OK on {dev}: conv -> GEMM mapped on the fly; im2col never "
          f"materialized.")


if __name__ == "__main__":
    main()
