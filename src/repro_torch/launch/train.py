"""Training launcher, counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --smoke --steps 100 --batch 8 --seq 256 [--ckpt-dir DIR] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --smoke --mesh-data 2 --mesh-model 2 [--device cpu]

Runs on the card unless ``--device cpu`` is given. ``--smoke`` trains the
reduced config on the one-rank host mesh, as the reference does (with
``--multi-pod`` too). ``--layers N`` cuts the depth to N layers and keeps
the widths: a full-width model at a depth whose parameters, gradients and
AdamW moments fit one card (``chip_smoke.py`` trains falcon-mamba-7b at
48 of 64 layers and deepseek-v2-lite-16b at 10 of 27 this way). A full
config at its published depth is refused, as the reference refuses it off
its production mesh of 256 cards.

``--mesh-data N --mesh-model M`` trains on an (N, M) ("data", "model")
mesh of ranks (``launch.serve.spawn_ranks``): each rank holds its pieces
of the params and of AdamW's moments, every rank draws the same global
batches, and rank 0 prints the history (every rank's is the same). On one
card the ranks share it over gloo: the port's stand-in for the production
mesh, which proves the cut, not a speed.

The launcher passes no frontend input, as the reference's passes none:
pixtral-12b trains text only, and whisper-small raises (its forward needs
``frames=``); ``Model.loss`` takes ``frames`` / ``patches`` in its batch.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch import configs
from repro_torch.dist import context as dctx
from repro_torch.models.model import Model, build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import TrainConfig

PRODUCTION_MESH = ("full configs at their published depth train on the "
                   "production mesh (16 x 16 = 256 cards, 2 x 16 x 16 "
                   "multi-pod), which one machine cannot give: ROADMAP "
                   "queue 1 item 15, the multi-card depths")


def train_job(mesh, device, *, cfg, loop_kw: dict, opt_kw: dict,
              echo: bool = False) -> dict:
    """A rank's part of a mesh run: :func:`repro_torch.train.loop.train`
    under the rank's mesh. Returns the history and the watchdog's events;
    rank 0 prints each logged step when ``echo``."""
    model = Model(cfg, device=device)
    log = _printer if (echo and mesh.rank == 0) else (lambda m: None)
    with dctx.mesh_context(mesh):
        out = train(model, loop_cfg=LoopConfig(**loop_kw),
                    train_cfg=TrainConfig(optimizer=AdamWConfig(**opt_kw)),
                    log_fn=log)
    return dict(history=out["history"],
                straggler_events=out["straggler_events"])


def _printer(m: dict) -> None:
    print(f"step {m['data_step']:>5} loss {m['loss']:.4f} "
          f"lr {m['lr']:.2e}", flush=True)


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
    ap.add_argument("--mesh-data", type=int, default=1, metavar="N",
                    help="ranks on the mesh's data axis")
    ap.add_argument("--mesh-model", type=int, default=1, metavar="M",
                    help="ranks on the mesh's model axis")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "const"])
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda:0)")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if not args.smoke and (args.multi_pod or not args.layers):
        raise SystemExit(f"{PRODUCTION_MESH}; pass --smoke, or cut the "
                         f"depth with --layers")
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
    loop_kw = dict(total_steps=args.steps, global_batch=args.batch,
                   seq_len=args.seq, ckpt_dir=args.ckpt_dir, log_every=5)
    opt_kw = dict(schedule=sched, warmup_steps=max(1, args.steps // 10),
                  total_steps=args.steps)
    shape = (args.mesh_data, args.mesh_model)
    if shape != (1, 1):
        from repro_torch.launch.serve import spawn_ranks
        out = spawn_ranks(shape, [(train_job, dict(
            cfg=cfg, loop_kw=loop_kw, opt_kw=opt_kw, echo=True))],
            device=args.device or "cuda", timeout_s=3600)[0][0]
        where = f"a {shape[0]} x {shape[1]} mesh on {args.device or 'cuda'}"
    else:
        model = build_model(cfg, device=args.device)
        with dctx.mesh_context(dctx.make_host_mesh()):
            out = train(model, loop_cfg=LoopConfig(**loop_kw),
                        train_cfg=TrainConfig(
                            optimizer=AdamWConfig(**opt_kw)),
                        log_fn=_printer)
        where = str(model.device)
    print(f"done on {where}; {cfg.n_layers} layers; final loss "
          f"{out['history'][-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
