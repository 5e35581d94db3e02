"""Train-step factory, counterpart of ``repro/train/step.py``: loss ->
gradients -> AdamW, with optional microbatch gradient accumulation.

The reference jits the step and donates the parameter and optimizer buffers;
here the step runs eagerly and AdamW writes both in place, which is what the
donation buys there.

On a mesh (the reference jits the same step with ``param_specs``
in-shardings and GSPMD partitions it) each rank holds its
``("data", "model")`` pieces of the params and of AdamW's moments
(``dist.sharding.train_specs``), and every rank is handed the same global
batch: a (micro)batch's rows are cut by ``data_specs``, the pieces'
``"data"`` cuts gathered for the forward (their gradients reduce-scattered
in the backward), and the loss, the gradient norm and so the update are
those of the single device's step on the global batch.

A step's 16-bit float GEMMs sum their split-K partials in f32
(``f32_sums``), as the reference's bf16 dots accumulate in f32."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.models.model import Model
from repro_torch.optim import adamw

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatch: int = 0        # 0 = no accumulation; else per-step microbatch


def state_specs(specs):
    """The spec tree of ``(params, AdamWState)`` for a params spec tree:
    the moments cut as their leaves, the step count whole."""
    return (specs, adamw.AdamWState(step=shd.P(), m=specs, v=specs))


@contextlib.contextmanager
def f32_sums():
    """cuBLAS sums a 16-bit float GEMM's split-K partials in f32 inside the
    block. PyTorch's default lets it sum them in the 16-bit type, by an
    algorithm it picks from the shapes: a gradient's roundings would then
    follow the batch's row count, and a data rank's half of the rows would
    round otherwise than one card's whole batch. The setting is global to
    the process and is put back on leaving."""
    mm = torch.backends.cuda.matmul
    saved = (mm.allow_bf16_reduced_precision_reduction,
             mm.allow_fp16_reduced_precision_reduction)
    mm.allow_bf16_reduced_precision_reduction = False
    mm.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (mm.allow_bf16_reduced_precision_reduction,
         mm.allow_fp16_reduced_precision_reduction) = saved


def value_and_grad(model: Model, params, batch: Dict[str, Tensor],
                   specs=None):
    """(loss, gradients in the parameters' dtypes), as the reference's
    ``value_and_grad`` of the loss, the GEMMs summing in f32
    (``f32_sums``). With ``specs`` the params are the rank's pieces,
    gathered over ``"data"`` for the forward, and the gradients the
    pieces'."""
    leaves = adamw.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad(), f32_sums():
        whole = params if specs is None else shd.gather_data(params, specs)
        loss = model.loss(whole, batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), adamw.tree_unflatten(params, list(grads))


def _rows(batch: Dict[str, Tensor], mesh) -> Dict[str, Tensor]:
    """This rank's rows of a global (micro)batch under ``data_specs``."""
    axes = tuple(a for a in dctx.BATCH_AXES if a in mesh.axis_names)
    dp = mesh.size(axes)
    b = batch["tokens"].shape[0]
    if b % dp:
        raise ValueError(f"a batch of {b} rows does not split over the "
                         f"{dp} ranks of the batch axes {axes}")
    return shd.shard_tree(batch, shd.data_specs(batch, mesh), mesh)


def make_train_step(model: Model, tcfg: TrainConfig, *,
                    specs: Optional[dict] = None):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics); params and opt_state are updated in place (``grads_out``, a
    list, receives the gradient tree the update applies). ``specs``: on the
    ambient mesh, the spec tree of the params' pieces
    (``dist.sharding.train_specs`` of the whole tree); the batch is then
    the global batch, the same on every rank, and so are the metrics."""

    def mesh_of():
        mesh = dctx.get_mesh() if specs is not None else None
        if mesh is None or mesh.devices.size == 1:
            return None
        return mesh

    def grads_of(params, batch, mesh):
        def local(sub):
            return sub if mesh is None else _rows(sub, mesh)

        if not tcfg.microbatch:
            return value_and_grad(model, params, local(batch),
                                  specs if mesh is not None else None)
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
            loss, g = value_and_grad(model, params, local(sub),
                                     specs if mesh is not None else None)
            for a, gi in zip(acc_leaves, adamw.tree_leaves(g)):
                a.add_(gi)
            loss_sum = loss_sum + loss
            del g
        for a in acc_leaves:
            a.div_(n)
        return loss_sum / n, acc

    def step(params, opt_state, batch, *, grads_out: Optional[list] = None):
        mesh = mesh_of()
        loss, grads = grads_of(params, batch, mesh)
        if grads_out is not None:          # the gradients the update applies
            grads_out.append(grads)
        gnorm = (adamw.global_norm(grads) if mesh is None
                 else adamw.global_norm(grads, specs))
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
