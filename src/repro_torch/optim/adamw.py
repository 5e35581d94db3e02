"""AdamW + schedules (MiniCPM's WSD among them) + clipping + int8
error-feedback gradient compression, counterpart of
``repro/optim/adamw.py``.

The state mirrors the parameter tree (``m`` and ``v`` in f32 beside every
leaf). The reference builds new trees; here :func:`update` writes the new
parameters and moments in place, under ``torch.no_grad()``, a stacked leaf
some rows at a time, so that its f32 temporaries stay small (a 16-layer
falcon-mamba ``in_proj`` has 1.07 G elements: 4.3 GB per f32 copy). The
arithmetic is elementwise, so the numbers are those of the whole-leaf
update.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, List, NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor
PyTree = Any

# elements per slice of a leaf in the in-place update and the norm
_SLICE_ELEMS = 1 << 26


class AdamWState(NamedTuple):
    step: Tensor        # () int32
    m: PyTree
    v: PyTree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"        # cosine | wsd | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1         # WSD: final fraction of steps in decay
    min_lr_frac: float = 0.1


def tree_leaves(tree) -> List[Tensor]:
    """Leaves in the reference's flatten order: dict keys sorted, sequences
    (``AdamWState``: step, m, v) in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(template, leaves: List[Tensor]):
    """``template``'s structure with its leaves replaced, in
    :func:`tree_leaves` order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, AdamWState):
            return AdamWState(*(build(t) for t in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(t) for t in node)
        return next(it)

    return build(template)


def tree_map(fn, tree):
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])


def schedule_lr(cfg: AdamWConfig, step) -> Tensor:
    """Warmup -> (cosine | WSD stable + decay | const), in f32 as the
    reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        mult = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        # Warmup-Stable-Decay (MiniCPM): stable at peak, then a sharp tail
        decay_start = 1.0 - cfg.decay_frac
        d = torch.clamp((t - decay_start) / cfg.decay_frac, 0.0, 1.0)
        tail = torch.pow(torch.tensor(cfg.min_lr_frac, dtype=torch.float32,
                                      device=t.device), d)
        mult = torch.where(t < decay_start, torch.ones_like(t), tail)
    else:
        mult = torch.ones_like(t)
    return cfg.lr * warm * mult


def init(params: PyTree) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def _slices(*leaves: Tensor) -> Iterator[Tuple[Tensor, ...]]:
    """Matching row slices of same-shaped leaves, each of at most about
    ``_SLICE_ELEMS`` elements (views: writes land in the leaves)."""
    lead = leaves[0]
    if lead.dim() == 0 or lead.numel() <= _SLICE_ELEMS:
        yield leaves
        return
    rows = max(1, _SLICE_ELEMS // max(1, lead[0].numel()))
    yield from zip(*(t.split(rows, dim=0) for t in leaves))


def global_norm(tree: PyTree) -> Tensor:
    """sqrt of the sum over leaves of sum(g^2) in f32 (leaves summed in
    flatten order, as the reference's Python ``sum``)."""
    total = None
    for g in tree_leaves(tree):
        sq = sum(torch.sum(torch.square(part.to(torch.float32)))
                 for (part,) in _slices(g))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: PyTree, state: AdamWState, params: PyTree,
           gnorm: Optional[Tensor] = None) -> Tuple[PyTree, AdamWState]:
    """One AdamW step: global-norm clip, bias-corrected moments, decoupled
    weight decay on every leaf, the new parameters cast back to their dtype.
    Writes ``params``, ``state.m`` and ``state.v`` in place and returns them
    with the advanced step. ``gnorm``, where the caller already holds
    ``global_norm(grads)``, saves a second pass over the gradients."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    lr = schedule_lr(cfg, step)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    b1t = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2t = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    f32 = torch.float32
    for p_leaf, g_leaf, m_leaf, v_leaf in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
            tree_leaves(state.v)):
        for p, g, m, v in _slices(p_leaf, g_leaf, m_leaf, v_leaf):
            g = g.to(f32) * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            del g
            p32 = p.to(f32)
            delta = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
            delta += cfg.weight_decay * p32
            p.copy_(p32 - lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v)


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression (the cross-pod all-reduce trick)
# ---------------------------------------------------------------------------

def compress_int8(g: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-tensor symmetric int8 quantization of a gradient."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(torch.float32) * scale


def ef_compress_tree(grads: PyTree, error: PyTree
                     ) -> Tuple[PyTree, PyTree, PyTree]:
    """Error-feedback compression: quantize (g + e); the new error is the
    input minus its dequantized value. Returns (quantized, scales,
    new_error); the residual re-enters the next step, so the compression is
    unbiased over time."""
    def one(g, e):
        x = g.to(torch.float32) + e
        q, s = compress_int8(x)
        return q, s, x - decompress_int8(q, s)

    def zip_map(g, e):
        if isinstance(g, dict):
            return {k: zip_map(g[k], e[k]) for k in g}
        return one(g, e)

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    out = zip_map(grads, error)
    return pick(out, 0), pick(out, 1), pick(out, 2)
