"""Resumable training loop, counterpart of ``repro/train/loop.py``: data +
step + checkpoints + watchdog + metrics, on the model's device (the card
unless the model was built for another).

The loop reads the ambient mesh, as the reference's launcher wraps
``train()`` in ``mesh_context``. On a mesh of more than one rank every rank
draws the same whole weights and the same one-host global batches (the
same seed), holds its pieces of the params and of AdamW's moments
(``dist.sharding.train_specs``), and logs the same metrics; a checkpoint
holds whole leaves, written by rank 0 (the reference's format), and a
resume cuts them for the mesh it finds."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data.pipeline import make_pipeline
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train.step import TrainConfig, make_train_step, state_specs
from repro_torch.train.watchdog import StepWatchdog, WatchdogConfig


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_dir: str = ""
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(model: Model, *, loop_cfg: LoopConfig,
          train_cfg: Optional[TrainConfig] = None,
          log_fn: Callable[[Dict], None] = lambda m: None,
          ) -> Dict[str, Any]:
    """Runs (or resumes, from the newest checkpoint in ``ckpt_dir``)
    training; returns the final params and optimizer state, the logged
    history and the watchdog's straggler events."""
    tcfg = train_cfg or TrainConfig()
    dev = model.device
    mesh = dctx.get_mesh()

    params = model.init(loop_cfg.seed)
    specs = shardings = None
    if mesh is not None and mesh.devices.size > 1:
        specs = shd.train_specs(params, mesh, model.cfg)
        params = shd.own_pieces(params, specs, mesh)
        shardings = shd.Shardings(state_specs(specs), mesh)
    step_fn = make_train_step(model, tcfg, specs=specs)
    opt_state = adamw.init(params)
    start_step = 0

    mgr = None
    if loop_cfg.ckpt_dir:
        mgr = CheckpointManager(loop_cfg.ckpt_dir)
        if mgr.latest_step() is not None:
            (params, opt_state), extra = mgr.restore((params, opt_state),
                                                     shardings=shardings)
            start_step = int(extra.get("data_step", mgr.latest_step()))

    pipe = make_pipeline(model.cfg, loop_cfg.global_batch, loop_cfg.seq_len,
                         seed=loop_cfg.seed, start_step=start_step)
    dog = StepWatchdog(WatchdogConfig())
    history = []
    try:
        t_prev = time.monotonic()
        for _ in range(start_step, loop_cfg.total_steps):
            data_step, batch = next(pipe)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            _sync(dev)
            now = time.monotonic()
            dog.observe(data_step, now - t_prev)
            t_prev = now
            if data_step % loop_cfg.log_every == 0 or \
                    data_step == loop_cfg.total_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["data_step"] = data_step
                history.append(m)
                log_fn(m)
            if mgr is not None and loop_cfg.ckpt_every and \
                    (data_step + 1) % loop_cfg.ckpt_every == 0:
                mgr.save(data_step + 1, (params, opt_state),
                         extra={"data_step": data_step + 1},
                         shardings=shardings)
    finally:
        pipe.close()
        if mgr is not None:
            mgr.wait()
    return dict(params=params, opt_state=opt_state, history=history,
                straggler_events=dog.events)
