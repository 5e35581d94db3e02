"""Vision launcher: the CNN classify smoke of the port. Counterpart of
``repro/launch/vision.py`` (its classify mode). Runs on the card unless
``--device cpu`` is given.

    # a tiny AlexNet through the fused implicit-im2col conv kernel K7
    python -m repro_torch.launch.vision --model alexnet --smoke \\
        --gemm-impl cuda
    # the int8 path (offline-quantized weights, Eq. 15/20 epilogue)
    python -m repro_torch.launch.vision --model alexnet --smoke \\
        --gemm-impl cuda --quantized
    # ResNet-50 at its published widths, batch 8
    python -m repro_torch.launch.vision --model resnet50 --batch 8

The smoke checks that the logits are finite and the forward deterministic,
and that the configured logits stay within a relative L2 error of the float
reference forward (plain PyTorch: F.conv2d and torch.matmul) of 1e-3, or
0.35 with ``--quantized`` (the quantization budget; the bit-exact checks
are in tests/test_torch_conv.py). A float FIP/FFIP run may be as far off
as the plain path in its own algebra where that is further: in f32 the
pre-add (a + b) drops low bits of b when |a| >> |b|, as in the BN-free
random ResNet-50 at full width. Input and weights are random, from
``--seed``.

    # tune K7's schedules over the model's convs (the warm-cache contract
    # of launch.tune: --expect-cached fails if anything was measured)
    python -m repro_torch.launch.vision --model resnet50 --batch 8 --tune \
        --algos ffip --dtypes float32
    # classify with the tuned blocks, or from a prepared artifact
    python -m repro_torch.launch.vision --model resnet50 --gemm-block auto
    python -m repro_torch.launch.vision --model alexnet --smoke \
        --quantized --prepared /tmp/alexnet.prepared

``--prepared DIR`` runs a ``repro_torch.prepare`` vision artifact
(``python -m repro_torch.launch.prepare --vision ...``) instead of
quantizing in the process, and fails if it recomputed offline work.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.kernels import compat
from repro_torch.vision import models as vm


def _smoke_defaults(args) -> None:
    if args.smoke:
        args.image_size = args.image_size or (67 if args.model == "alexnet"
                                              else 32)
        args.width_div = args.width_div or 8
        args.classes = args.classes or 10
    args.width_div = args.width_div or 1
    args.classes = args.classes or 1000


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative L2 error of ``got`` against ``want``."""
    return float(torch.linalg.norm((got - want).double())
                 / (torch.linalg.norm(want.double()) + 1e-9))


_DTYPES = {"float32": torch.float32, "int8": torch.int8}


def _tune(args, model, image_size: int, device) -> int:
    """Fill the conv schedules of ``model``'s convs (one tuning a distinct
    key), as the reference's ``--tune`` does."""
    from repro_torch import tune
    from repro_torch.tune import measure

    algos = [a for a in args.algos.split(",") if a]
    dtypes = [_DTYPES[d] for d in args.dtypes.split(",") if d]
    cache = tune.get_cache()
    jobs, seen = [], set()
    for conv, h, w in vm.conv_geometries(model, image_size):
        for algo in algos:
            for dt in dtypes:
                cin_g = conv.cin // conv.groups
                oh, ow = vm._spatial(conv, h, w)
                key = tune.conv_key(algo, dt, oh * ow,
                                    conv.cout // conv.groups,
                                    conv.kh * conv.kw * cin_g,
                                    cin_g * conv.kw)
                if key not in seen:
                    seen.add(key)
                    jobs.append((conv, h, w, algo, dt))
    t0 = time.perf_counter()
    measured = cached = 0
    for conv, h, w, algo, dt in jobs:
        pre = measure.counters["timed_candidates"]
        entry = tune.tune_conv(
            args.batch, h, w, conv.cin, conv.cout, conv.kh, conv.kw, dt,
            stride=conv.stride, pad=conv.pad, groups=conv.groups, algo=algo,
            budget=args.budget, iters=args.iters, device=device, cache=cache,
            persist=False)
        fresh = measure.counters["timed_candidates"] > pre
        measured += fresh
        cached += not fresh
        b = entry["blocks"]
        status = "tuned " if fresh else "cached"
        print(f"[{status}] conv {algo:8s} {tune._dtype_name(dt):7s} "
              f"{conv.name:12s} {h}x{w}x{conv.cin}->k{conv.kh}x{conv.kw} "
              f"g{conv.groups} -> bm={b['bm']} bn={b['bn']} bk={b['bk']} "
              f"({entry['us']}us, default {entry['default_us']}us, "
              f"{entry['candidates']} candidates)")
    if measured:
        cache.save()
    print(f"{args.model}: {measured} conv buckets tuned / {cached} reused "
          f"({time.perf_counter() - t0:.1f}s) -> {cache.path}")
    if args.expect_cached and measured:
        print("--expect-cached: FAIL, a warm cache still measured",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", required=True, choices=sorted(vm.BUILDERS))
    ap.add_argument("--smoke", action="store_true",
                    help="tiny image + width_div=8 + 10 classes")
    ap.add_argument("--image-size", type=int, default=0)
    ap.add_argument("--width-div", type=int, default=0)
    ap.add_argument("--classes", type=int, default=0)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--algo", choices=["baseline", "fip", "ffip"],
                    default="ffip")
    ap.add_argument("--gemm-impl", choices=["torch", "cuda"], default="cuda",
                    help="cuda: the hand-written kernels (K7 for the convs); "
                         "torch: plain PyTorch")
    ap.add_argument("--gemm-block", default=None, metavar="auto|BM,BN,BK",
                    help="'auto' (the repro_torch.tune conv schedules) or "
                         "explicit conv/GEMM blocks (a tile the cuda kernels "
                         "are compiled for)")
    ap.add_argument("--tune", action="store_true",
                    help="fill the conv schedules instead of classifying")
    ap.add_argument("--algos", default="baseline,fip,ffip",
                    help="--tune: algos to tune")
    ap.add_argument("--dtypes", default="float32,int8",
                    help="--tune: dtypes to tune")
    ap.add_argument("--budget", type=int, default=0)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--expect-cached", action="store_true",
                    help="--tune: fail if anything had to be measured")
    ap.add_argument("--prepared", default=None, metavar="DIR",
                    help="run from a repro_torch.prepare vision artifact "
                         "instead of quantizing in the process")
    ap.add_argument("--quantized", action="store_true",
                    help="int8 path (offline weight quantization)")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda:0); 'cpu' for the plain "
                         "versions on the host")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    _smoke_defaults(args)
    block = args.gemm_block
    if block and block != "auto":
        block = tuple(int(v) for v in args.gemm_block.split(","))
        if len(block) != 3:
            ap.error("--gemm-block takes 'auto' or bm,bn,bk")

    device = compat.resolve_device(args.device)
    image_size = args.image_size or vm.default_image_size(args.model)
    model = vm.build(args.model, num_classes=args.classes,
                     image_size=image_size, width_div=args.width_div)
    if args.tune:
        return _tune(args, model, image_size, device)
    params = vm.init_params(model, args.seed, device=device)
    prepared = None
    if args.prepared:
        from repro_torch import prepare
        prepared = prepare.load(args.prepared, map_location=device)
        if prepared.kind != "vision":
            ap.error(f"--prepared: {args.prepared} is a {prepared.kind!r} "
                     f"artifact, not vision")
        if args.quantized and not prepared.quantized:
            ap.error("--quantized with a float-only artifact: re-run "
                     "launch.prepare with --quantized")
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    x = torch.randn((args.batch, image_size, image_size, 3), generator=gen,
                    device=device)
    n_convs = len(vm.conv_layers(model))
    print(f"{args.model}: image {image_size}x{image_size}, batch "
          f"{args.batch}, width/{args.width_div}, {n_convs} convs, "
          f"algo={args.algo} impl={args.gemm_impl} "
          f"block={args.gemm_block or 'default'} quantized={args.quantized} "
          f"on {device}")

    with torch.no_grad():
        t0 = time.perf_counter()
        with use_gemm(GemmConfig(algo="baseline", impl="torch")):
            float_logits = vm.apply(model, params, x)
        print(f"float reference forward: {time.perf_counter() - t0:.2f}s")
        if not bool(torch.isfinite(float_logits).all()):
            print("FAIL: float logits not finite", file=sys.stderr)
            return 1
        if prepared is not None:
            run_params = prepared.params
        else:
            run_params = (vm.attach_quantized(model, params)
                          if args.quantized else params)
        cfg = GemmConfig(algo=args.algo, impl=args.gemm_impl,
                         quantized=args.quantized, block=block)
        compat.reset_counters()
        with use_gemm(cfg):
            t0 = time.perf_counter()
            logits = vm.apply(model, run_params, x)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            counts = compat.launch_counts()
            logits2 = vm.apply(model, run_params, x)
    if not bool(torch.isfinite(logits).all()):
        print("FAIL: logits not finite", file=sys.stderr)
        return 1
    if not torch.equal(logits, logits2):
        print("FAIL: forward not deterministic", file=sys.stderr)
        return 1
    rel = rel_err(logits, float_logits)
    top1 = logits.argmax(-1).tolist()
    print(f"configured forward: {dt:.2f}s  top1={top1}  "
          f"rel_err_vs_float={rel:.4g}  launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    limit = 0.35 if args.quantized else 1e-3
    if not args.quantized and args.algo != "baseline":
        with torch.no_grad(), use_gemm(GemmConfig(algo=args.algo,
                                                  impl="torch")):
            algebra = rel_err(vm.apply(model, params, x), float_logits)
        print(f"plain {args.algo} algebra: rel_err_vs_float={algebra:.4g}")
        limit = max(limit, algebra)
    if rel > limit:
        print(f"FAIL: rel err {rel:.4g} > {limit}", file=sys.stderr)
        return 1
    if prepared is not None and prepared.recomputed:
        print(f"FAIL: prepared artifact recomputed offline work: "
              f"{prepared.recompute_report()}", file=sys.stderr)
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
