"""Serving launcher for the port: build a model, submit synthetic requests to
the contiguous :class:`~repro_torch.serve.batcher.BatchServer`, drain, report.
Counterpart of ``repro/launch/serve.py`` (its contiguous, single-replica
mode). Runs on the card unless ``--device cpu`` is given.

  python -m repro_torch.launch.serve --arch minicpm-2b --layers 4 \\
      --slots 4 --requests 8 --max-len 256 --max-new 16 --gemm-impl cuda

``--layers N`` cuts the depth and keeps the published widths. Weights are
random, from ``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import compat
from repro_torch.models.model import Model
from repro_torch.serve.batcher import BatchServer, Request


def make_prompts(vocab: int, n_requests: int, rng: np.random.Generator,
                 lo: int = 3, hi: int = 12):
    """``n_requests`` prompts of ``lo``..``hi - 1`` uniform token ids."""
    lens = rng.integers(lo, hi, n_requests)
    return [rng.integers(0, vocab, size=(int(n),)) for n in lens]


def serve(model: Model, params, prompts, *, max_new: int, **server_kw):
    """Submit every prompt with ``max_new`` tokens, drain, and return
    ``(server, completed requests, wall seconds)``. The wall time ends in a
    device sync: the last dispatch's ids were copied to the host."""
    srv = BatchServer(model, device=model.device, **server_kw)
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        srv.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
    done = srv.run_until_drained(params)
    return srv, done, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke config (small widths)")
    ap.add_argument("--layers", type=int, default=0, metavar="N",
                    help="cut the depth to N layers at full width")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", default="3,12", metavar="LO,HI",
                    help="prompt lengths drawn uniformly from [LO, HI)")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--decode-chunk", type=int, default=1)
    ap.add_argument("--quantized", action="store_true",
                    help="int8 (F)FIP serving path")
    ap.add_argument("--gemm-algo", choices=["baseline", "fip", "ffip"],
                    default="ffip")
    ap.add_argument("--gemm-impl", choices=["torch", "cuda"], default=None,
                    help="cuda: the hand-written kernels; torch: plain "
                         "PyTorch (default: torch.matmul)")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda:0); 'cpu' for the plain "
                         "versions on the host")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = configs.smoke_config(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = Model(cfg, device=args.device)
    params = model.init(args.seed)
    lo, hi = (int(x) for x in args.prompt_len.split(","))
    prompts = make_prompts(cfg.vocab, args.requests,
                           np.random.default_rng(args.seed), lo, hi)

    compat.reset_counters()
    srv, done, dt = serve(model, params, prompts, max_new=args.max_new,
                          batch_slots=args.slots, max_len=args.max_len,
                          quantized=args.quantized, gemm_algo=args.gemm_algo,
                          gemm_impl=args.gemm_impl,
                          decode_chunk=args.decode_chunk)
    total = sum(len(r.out_tokens) for r in done)
    st = srv.stats
    algo = (args.gemm_algo if args.quantized or args.gemm_impl == "cuda"
            else "baseline")
    mode = f"{'int8-' if args.quantized else ''}{algo}/" \
        f"{args.gemm_impl or 'torch'}"
    print(f"[{mode}] {cfg.name} L={cfg.n_layers} d={cfg.d_model} on "
          f"{model.device}: {len(done)}/{args.requests} requests / {total} "
          f"tokens in {dt:.3f}s ({total / dt:.1f} tok/s)")
    print(f"  prefill {st['prefill_s']:.3f}s ({st['prefill_tokens']} tok / "
          f"{st['prefill_dispatches']} dispatches), decode "
          f"{st['decode_s']:.3f}s over {st['steps']} steps / "
          f"{st['decode_dispatches']} dispatches ({st['decode_tokens']} tok)")
    print(f"  kernel launches: {compat.launch_counts()}")
    if model.device.type == "cuda":
        print(f"  peak device memory "
              f"{torch.cuda.max_memory_allocated(model.device) / 2**30:.2f}"
              f" GiB on {torch.cuda.get_device_name(model.device)}")
    bad = [r.rid for r in done if len(r.out_tokens) != args.max_new]
    if len(done) != args.requests or bad:
        raise SystemExit(f"FAIL: {len(done)} done, short requests {bad}")
    print("OK")


if __name__ == "__main__":
    main()
