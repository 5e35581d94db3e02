"""Train-step factory, counterpart of ``repro/train/step.py``: loss ->
gradients -> AdamW, with optional microbatch gradient accumulation.

The reference jits the step and donates the parameter and optimizer buffers;
here the step runs eagerly and AdamW writes both in place, which is what the
donation buys there."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models.model import Model
from repro_torch.optim import adamw

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatch: int = 0        # 0 = no accumulation; else per-step microbatch


def _grads(model: Model, params, batch: Dict[str, Tensor]):
    """(loss, gradients in the parameters' dtypes), as ``value_and_grad``."""
    leaves = adamw.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), adamw.tree_unflatten(params, list(grads))


def make_train_step(model: Model, tcfg: TrainConfig):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics); params and opt_state are updated in place."""

    def grads_of(params, batch):
        if not tcfg.microbatch:
            return _grads(model, params, batch)
        # gradient accumulation over microbatches along the batch dim, in f32
        b = batch["tokens"].shape[0]
        mb = tcfg.microbatch
        n = b // mb
        if n * mb != b:
            raise ValueError("microbatch must divide batch")
        acc = adamw.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        acc_leaves = adamw.tree_leaves(acc)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        for i in range(n):
            sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, g = _grads(model, params, sub)
            for a, gi in zip(acc_leaves, adamw.tree_leaves(g)):
                a.add_(gi)
            loss_sum = loss_sum + loss
            del g
        for a in acc_leaves:
            a.div_(n)
        return loss_sum / n, acc

    def step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        gnorm = adamw.global_norm(grads)
        params, new_state = adamw.update(tcfg.optimizer, grads, opt_state,
                                         params, gnorm)
        metrics = {
            "loss": loss,
            "grad_norm": gnorm,
            "lr": adamw.schedule_lr(tcfg.optimizer, new_state.step),
            "step": new_state.step,
        }
        return params, new_state, metrics

    return step


def make_serve_step(model: Model):
    """Returns decode(params, token, cache, pos) -> (cache, logits)."""

    def serve_step(params, token, cache, pos):
        with torch.no_grad():
            return model.decode_step(params, token, cache, pos)

    return serve_step
