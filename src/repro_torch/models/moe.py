"""Mixture-of-Experts: top-k router and capacity-bounded scatter dispatch,
counterpart of ``repro/models/moe.py``.

The router is a dense layer of the GEMM provider (so K1-K3 and int8 apply to
it); the expert products are batched einsums over the capacity buffer, as
the reference computes them with XLA einsums outside any Pallas kernel.
Dispatch is the position-in-expert scatter: (token, choice) assignments in
token order take consecutive slots of their expert's buffer up to its
capacity, later ones are dropped. The aux load-balancing loss is the
switch-transformer form.

Tensor parallelism over the ambient mesh's "model" axis, in both of the
reference's partitions (``repro_torch.dist.sharding``), read from the
local bank shapes. The router stays whole, so every rank routes alike.
"expert": a rank holds E/tp whole experts and runs their einsums; its
rows of the (E, C, d) output buffer go into a zero-filled buffer that the
ranks sum (exact: one nonzero term an element), and the combine then
gathers and weights exactly as on one card. "ffn": a rank holds every
expert's d_ff_expert/tp piece, and the f32 partials of ``w_down`` are
summed as a row-parallel layer's. The shared experts are an MLP, column-
then row-parallel. Under autograd the replicated capacity buffer's
gradient is summed over the ranks (``context.sum_grad``).

Data parallelism over the ambient mesh's batch axes routes the global
batch as one device does, a rank holding its own rows (the global token
order is the ranks' rows in rank order): the ranks' per-expert assignment
counts ((E,) ints, never the tokens) are gathered, a rank's slots start
after the earlier ranks' counts, the capacity comes from the global T and
the aux loss takes its means over the global T. A rank's capacity buffer
then holds its own assignments at their global slots, and the experts run
on it alone: each capacity row is independent of the others.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import context as dctx
from repro_torch.models import layers as L

Tensor = torch.Tensor


def _bank(gen, lead, shape, std: float, dtype, device) -> Tensor:
    """An expert bank ``(*lead, E, d_in, d_out)`` drawn one layer at a time:
    the whole stacked bank in f32 at once would take twice its bf16 size
    again (36 GiB a bank for mixtral-8x22b at 12 layers)."""
    out = torch.empty((*lead, *shape), dtype=dtype, device=device)
    for layer in out.view(-1, *shape):
        layer.copy_(L._normal(gen, shape, device) * std)
    return out


def moe_init(gen, cfg: ModelConfig, dtype, *, device, lead=()) -> dict:
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    std = 1.0 / (d ** 0.5)
    p = {
        "router": L.dense_init(gen, d, e, dtype, device=device, lead=lead),
        "w_gate": _bank(gen, lead, (e, d, f), std, dtype, device),
        "w_up": _bank(gen, lead, (e, d, f), std, dtype, device),
        "w_down": _bank(gen, lead, (e, f, d), 1.0 / (f ** 0.5), dtype,
                        device),
    }
    if m.n_shared:
        p["shared"] = L.mlp_init(gen, d, m.d_ff_expert * m.n_shared, dtype,
                                 device=device, lead=lead)
    return p


def top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """(values, indices) of the ``k`` largest entries of the last axis, in
    descending order with the LOWER index first among equal values, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order on
    ties). A stable descending sort keeps equal values in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``int(T k capacity_factor / E) + 1``."""
    m = cfg.moe
    return int(tokens * m.top_k * m.capacity_factor / m.n_experts) + 1


def assign_slots(expert_idx: Tensor, cfg: ModelConfig
                 ) -> Tuple[Tensor, Tensor, Tensor, int]:
    """The capacity-bounded positions of the (T, k) assignments ``expert_idx``
    in token order: (flat expert ids (T k,), slots (T k,), keep (T k,)
    bool, capacity). On a mesh with batch axes ("pod", "data") the rows are
    this rank's piece of the global batch: the positions count the earlier
    ranks' assignments first and the capacity is the global T's."""
    m = cfg.moe
    flat_e = expert_idx.reshape(-1)                               # (T k,)
    onehot = F.one_hot(flat_e, m.n_experts).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    axes = dctx.batch_axes()
    dp = dctx.axis_size(axes)
    if dp > 1:
        counts = dctx.all_gather(
            torch.sum(onehot, dim=0, dtype=torch.int32)[None], 0, axes)
        pos_in_e = pos_in_e + torch.sum(counts[:dctx.axis_index(axes)],
                                        dim=0, dtype=torch.int32)
    pos = torch.sum(pos_in_e * onehot, dim=-1, dtype=torch.int32)
    cap = capacity(expert_idx.shape[0] * dp, cfg)
    keep = pos < cap
    return flat_e, torch.where(keep, pos, 0).to(torch.long), keep, cap


def _experts(buf: Tensor, p: dict, n_experts: int, d_ff: int) -> Tensor:
    """The experts' gated MLPs over the capacity buffer (E, C, d), in the
    partition this rank's bank shapes show."""
    w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
    e_local = w_gate.shape[-3]
    if e_local != n_experts or w_gate.shape[-1] != d_ff:
        buf = dctx.sum_grad(buf)       # each rank reads part of the buffer
    if e_local != n_experts:                           # "expert"
        e0 = dctx.tp_rank() * e_local
        buf = buf[e0:e0 + e_local]
    h = (F.silu(torch.einsum("ecd,edf->ecf", buf, w_gate))
         * torch.einsum("ecd,edf->ecf", buf, w_up))
    if e_local != n_experts:
        full = torch.zeros((n_experts, *buf.shape[1:]), dtype=buf.dtype,
                           device=buf.device)
        full[e0:e0 + e_local] = torch.einsum("ecf,efd->ecd", h, w_down)
        return dctx.all_sum(full)
    if w_gate.shape[-1] != d_ff:                       # "ffn"
        part = torch.einsum("ecf,efd->ecd", h.float(), w_down.float())
        return dctx.all_sum(part).to(buf.dtype)
    return torch.einsum("ecf,efd->ecd", h, w_down)


def moe_apply(p: dict, x: Tensor, *, cfg: ModelConfig
              ) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss () f32)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    logits = L.dense(xt, p["router"]).to(torch.float32)          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, m.top_k)                 # (T, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    flat_e, slot, keep, cap = assign_slots(expert_idx, cfg)

    # dropped assignments add zeros to slot 0 of their expert, as the
    # reference's scatter-add does: a kept value plus zeros is exact
    x_rep = torch.repeat_interleave(xt, m.top_k, dim=0)           # (T k, d)
    buf = torch.zeros((m.n_experts, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((flat_e, slot),
                        torch.where(keep[:, None], x_rep, 0),
                        accumulate=True)

    out_buf = _experts(buf, p, m.n_experts, m.d_ff_expert)        # (E, C, d)

    gathered = torch.where(keep[:, None], out_buf[flat_e, slot], 0)
    weighted = gathered * gate_vals.reshape(-1)[:, None].to(x.dtype)
    out = torch.sum(weighted.reshape(t, m.top_k, d), dim=1)

    if m.n_shared:
        out = out + L.mlp(xt, p["shared"], cfg.act,
                          d_ff=m.d_ff_expert * m.n_shared)

    # switch-style aux loss: E * sum_e f_e * p_e, the means over the
    # global T on a data-parallel mesh
    top1 = F.one_hot(expert_idx[:, 0], m.n_experts).to(torch.float32)
    axes = dctx.batch_axes()
    dp = dctx.axis_size(axes)
    if dp > 1:
        me = dctx.all_sum(torch.sum(probs, dim=0), axes) / (t * dp)
        ce = dctx.all_sum(torch.sum(top1, dim=0), axes) / (t * dp)
    else:
        me = torch.mean(probs, dim=0)                             # (E,)
        ce = torch.mean(top1, dim=0)
    aux = m.n_experts * torch.sum(me * ce) * m.router_aux_weight
    return out.reshape(b, s, d), aux
