"""The paper's deployment story on the PyTorch/CUDA port: int8 quantized
inference through FFIP with every ML-specific optimization of §3.3/§4.4,
through ``repro_torch`` only:

  * both-signed quantization (d=1 pre-adders),
  * beta folded into the bias (Eq. 15), free at inference,
  * y-deltas precomputed from the weights (Eq. 9),
  * zero-point contributions removed by the adjuster algebra (Eq. 20),

and checks that the int32 accumulators are bit-exact against the baseline
quantized GEMM, on the FFIP kernel (K3 on the card) too, with about half
the multiplies.

    PYTHONPATH=src python examples/torch_quantized_ffip_inference.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import analytical as an
from repro_torch.core import fip, quant
from repro_torch.kernels import ops
from repro_torch.kernels.compat import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda:0)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)

    # a 2-layer MLP "deployed" with 8-bit weights and activations
    x = torch.randn(32, 256, generator=gen).to(dev)
    w1 = (torch.randn(256, 512, generator=gen) * 0.05).to(dev)
    w2 = (torch.randn(512, 64, generator=gen) * 0.05).to(dev)
    b1 = torch.zeros(512, device=dev)
    b2 = torch.zeros(64, device=dev)

    xq = quant.calibrate(x, torch.int8, symmetric=False)  # activations: affine
    w1q = quant.calibrate(w1, torch.int8, symmetric=True)  # weights: symmetric

    h_float = torch.relu(x @ w1 + b1)
    y_float = h_float @ w2 + b2

    # both layers through FFIP int8
    h = torch.relu(quant.quantized_dense_ffip(x, w1, b1, xq, w1q,
                                              algo="ffip"))
    hq = quant.calibrate(h, torch.int8, symmetric=False)
    w2q = quant.calibrate(w2, torch.int8, symmetric=True)
    y = quant.quantized_dense_ffip(h, w2, b2, hq, w2q, algo="ffip")

    rms = float(torch.sqrt(torch.mean((y - y_float) ** 2)))
    ref = float(torch.sqrt(torch.mean(y_float ** 2)))
    print(f"quantization SNR: {20 * np.log10(ref / rms):.1f} dB "
          f"(int8 path vs float reference)")

    # bit-exactness of the arithmetic rearrangement itself, and of the
    # FFIP kernel on the int8 operands (its int32 accumulator)
    aq = quant.quantize(x, xq)
    bq = quant.quantize(w1, w1q)
    base = quant.int_gemm_baseline(aq, bq, xq.zero_point, w1q.zero_point)
    ffip = quant.int_gemm_ffip(aq, bq, xq.zero_point, w1q.zero_point)
    assert torch.equal(base, ffip)
    raw = ops.matmul(aq, bq, algo="ffip")
    assert torch.equal(raw, aq.to(torch.int32) @ bq.to(torch.int32))
    print(f"int32 accumulators: FFIP == baseline, bit-exact (the kernel "
          f"on {dev} too)")

    m, k, n = aq.shape[0], aq.shape[1], bq.shape[1]
    print(f"multiplies: baseline {an.baseline_mults(m, k, n)}, "
          f"ffip {an.fip_mults(m, k, n)} "
          f"({an.fip_mults(m, k, n) / an.baseline_mults(m, k, n):.3f}x)")

    # the 1-extra-bit y encoding (Eq. 9 + §4.4)
    y_enc = fip.make_y(bq.to(torch.int32))
    assert int(y_enc.abs().max()) < 2 ** 8  # fits 9 bits signed
    print("y-delta encoding fits w+1 bits — matches §4.4 storage claim")
    print("OK")


if __name__ == "__main__":
    main()
