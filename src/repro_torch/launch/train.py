"""Training launcher, counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --smoke --steps 100 --batch 8 --seq 256 [--ckpt-dir DIR] [--device cpu]

Runs on the card unless ``--device cpu`` is given. ``--smoke`` trains the
reduced config; a full config is refused, as the reference refuses it off
its production mesh: distributed training is ROADMAP queue 1 item 15
(``chip_smoke.py`` trains minicpm-2b and falcon-mamba-7b at full width on
one card through ``train.loop.train`` directly).
"""
from __future__ import annotations

import argparse

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
    if not args.smoke:
        raise SystemExit(f"full configs train on the production mesh: "
                         f"{MESH_TODO}; pass --smoke")
    cfg = configs.smoke_config(cfg)

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
    print(f"done on {model.device}; final loss "
          f"{out['history'][-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
