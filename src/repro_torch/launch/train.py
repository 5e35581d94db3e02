"""Training launcher, counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --smoke --steps 100 --batch 8 --seq 256 [--ckpt-dir DIR] [--device cpu]

Runs on the card unless ``--device cpu`` is given. ``--smoke`` trains the
reduced config. ``--layers N`` cuts the depth to N layers and keeps the
widths: a full-width model at a depth whose parameters, gradients and AdamW
moments fit one card (``chip_smoke.py`` trains falcon-mamba-7b at 48 of 64
layers and deepseek-v2-lite-16b at 10 of 27 this way). A full config at
its published depth is refused, as the reference refuses it off its
production mesh: distributed training is ROADMAP queue 1 item 15.
The launcher passes no frontend input, as the reference's passes none:
pixtral-12b trains text only, and whisper-small raises (its forward needs
``frames=``); ``Model.loss`` takes ``frames`` / ``patches`` in its batch.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch import configs
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import TrainConfig

MESH_TODO = ("the production mesh (multi-card and multi-pod training) is "
             "not ported yet: ROADMAP queue 1 item 15 (distribution)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--layers", type=int, default=0, metavar="N",
                    help="cut the depth to N layers, widths kept")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "const"])
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda:0)")
    args = ap.parse_args(argv)

    if args.multi_pod:
        raise SystemExit(f"--multi-pod: {MESH_TODO}")
    cfg = configs.get_config(args.arch)
    if not args.smoke and not args.layers:
        raise SystemExit(f"full configs train on the production mesh: "
                         f"{MESH_TODO}; pass --smoke or cut the depth with "
                         f"--layers")
    if args.smoke:
        cfg = configs.smoke_config(cfg)
    if args.layers:
        if args.layers <= cfg.first_k_dense:
            raise SystemExit(f"--layers must exceed the {cfg.first_k_dense} "
                             f"dense head layer(s) of {cfg.name}")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    # MiniCPM trains with WSD per its paper
    sched = "wsd" if (args.arch == "minicpm-2b" and args.schedule == "cosine") \
        else args.schedule
    model = build_model(cfg, device=args.device)
    out = train(
        model,
        loop_cfg=LoopConfig(total_steps=args.steps, global_batch=args.batch,
                            seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                            log_every=5),
        train_cfg=TrainConfig(optimizer=AdamWConfig(
            schedule=sched, warmup_steps=max(1, args.steps // 10),
            total_steps=args.steps)),
        log_fn=lambda m: print(
            f"step {m['data_step']:>5} loss {m['loss']:.4f} "
            f"lr {m['lr']:.2e}", flush=True),
    )
    print(f"done on {model.device}; {cfg.n_layers} layers; final loss "
          f"{out['history'][-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
