"""Serving demo on the PyTorch/CUDA port: continuous batching over a small
model, through ``repro_torch`` only.

    PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]

Eight requests with different prompt lengths and token budgets stream
through four decode slots; each slot decodes at its own position, and a
finished slot is refilled at once. Prompts prefill in power-of-2 length
buckets (the prompt through the flash kernel K4 on the card), sampling runs
on the device (only int32 ids reach the host), and ``decode_chunk`` fuses
several decode steps into one dispatch. Pass ``quantized=True`` to
``BatchServer`` to route the projections through the int8 FFIP kernels.
"""
import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.models.model import build_model
from repro_torch.serve.batcher import BatchServer, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda:0)")
    args = ap.parse_args(argv)
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    srv = BatchServer(model, batch_slots=4, max_len=64, decode_chunk=2,
                      device=model.device)

    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=(int(n),)),
                max_new_tokens=int(t))
        for i, (n, t) in enumerate(zip(rng.integers(3, 12, 8),
                                       rng.integers(2, 8, 8)))
    ]
    for r in reqs:
        srv.submit(r)

    t0 = time.perf_counter()
    steps = 0
    while True:
        n = srv.step(params)
        if n == 0 and not srv.has_queued():
            break
        steps += 1
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out_tokens) for r in reqs)
    print(f"{len(reqs)} requests, {total_tokens} tokens in {steps} decode "
          f"steps ({dt:.2f}s host time) on {model.device}")
    for r in reqs:
        print(f"  rid={r.rid} prompt_len={len(r.prompt)} -> {r.out_tokens}")
    assert all(len(r.out_tokens) == r.max_new_tokens for r in reqs)
    print("OK")


if __name__ == "__main__":
    main()
