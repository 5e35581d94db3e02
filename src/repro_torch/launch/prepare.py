"""Offline model-prep launcher: build and save a ``repro_torch.prepare``
artifact. Counterpart of ``repro/launch/prepare.py``; runs on the card
unless ``--device cpu`` is given.

    # LM artifact: int8 q entries, the y deltas, the tuned schedule slice
    python -m repro_torch.launch.prepare --arch minicpm-2b --quantized \\
        --out /tmp/minicpm.prepared
    # vision artifact (conv and FC int8 entries)
    python -m repro_torch.launch.prepare --vision alexnet --smoke \\
        --quantized --out /tmp/alexnet.prepared

The paper's §4.4 offline stage as a deployment step: what a serving
process would otherwise derive at its first prefill (per-channel int8
weights with Eq. 15 folded beta, the Eq. 9 y deltas, on the card K3's carry
tables, the device-keyed schedule slice) is done here once and saved.
``launch.serve --prepared DIR`` and ``launch.vision --prepared DIR`` load
it with the zero-recompute warm start; ``--require-warm`` on the serve
side makes that a hard failure.

Params are drawn from ``--seed`` (0), as the serve and vision launchers
draw theirs, so an artifact prepared here serves their synthetic workloads.
``--layers N`` cuts an LM's depth at its published widths, as the serve
launcher's does.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch import configs, prepare
from repro_torch.kernels import compat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="build + save a repro_torch.prepare artifact")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--arch", choices=sorted(configs.ARCHS),
                     help="LM architecture (params from --seed, as "
                          "launch.serve draws them)")
    src.add_argument("--vision", metavar="MODEL",
                     help="vision model name (see launch.vision)")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke-sized config (as the serve / vision "
                         "launchers' --smoke)")
    ap.add_argument("--layers", type=int, default=0, metavar="N",
                    help="LM only: cut the depth to N layers at full width")
    ap.add_argument("--quantized", action="store_true",
                    help="attach per-channel int8 q entries (Eq. 15/20)")
    ap.add_argument("--no-y-deltas", action="store_true",
                    help="LM only: skip the Eq. 9 y-delta precompute")
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda:0); 'cpu' for the host")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = compat.resolve_device(args.device)

    t0 = time.perf_counter()
    if args.arch:
        from repro_torch.models.model import Model
        cfg = configs.get_config(args.arch)
        if args.smoke:
            cfg = configs.smoke_config(cfg)
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        params = Model(cfg, device=device).init(args.seed)
        pm = prepare.prepare_lm(params, quantized=args.quantized,
                                y_deltas=not args.no_y_deltas, name=cfg.name)
    else:
        from repro_torch.vision import models as vm
        if args.vision not in vm.BUILDERS:
            ap.error(f"--vision must be one of {sorted(vm.BUILDERS)}")
        image_size = ((67 if args.vision == "alexnet" else 32) if args.smoke
                      else vm.default_image_size(args.vision))
        model = vm.build(args.vision,
                         num_classes=10 if args.smoke else 1000,
                         image_size=image_size,
                         width_div=8 if args.smoke else 1)
        params = vm.init_params(model, args.seed, device=device)
        pm = prepare.prepare_vision(model, params, quantized=args.quantized,
                                    name=args.vision)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prep_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = pm.save(args.out)
    save_s = time.perf_counter() - t0

    snap = prepare.counters_snapshot()
    print(f"prepared {pm.kind} artifact '{pm.meta.get('name')}' -> {out}")
    print(f"  device_kind={pm.device} quantized={pm.quantized} "
          f"y_deltas={len(pm.derived)} carry_tables="
          f"{sum(len(v) for v in pm.carry.values())} "
          f"schedule_entries={len(pm.schedule)} bytes={pm.nbytes()}")
    print(f"  offline work: quantize={snap['quantize']} "
          f"y_encode={snap['y_encode']} carry={snap['carry']} "
          f"(prep {prep_s:.2f}s, save {save_s:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
