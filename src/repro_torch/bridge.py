"""Bring the reference's parameter trees and caches across as numpy arrays.

The port never re-creates ``jax.random`` initialisation: a test runs the
reference, turns its tree into numpy (``jax.tree.map(np.asarray, tree)``)
and hands it here, so both sides compute on identical weights. bf16 leaves
(numpy arrays whose dtype is named ``bfloat16``) cross bit for bit through a
uint16 view, so the port needs no numpy extension type for bf16.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dicts / lists / tuples of numpy arrays -> the same structure of
    torch tensors on ``device`` (int8 ``"q"`` entries included). ``None``
    (a vision model's parameterless layer) and Python ints (a conv ``"q"``
    entry's ``k_real``, ``kh``, ``kw``, ``groups``) cross unchanged."""
    if tree is None or isinstance(tree, int):
        return tree
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return _leaf(tree, device)


def cache_from_numpy(tree, device="cpu"):
    """A reference cache tree (stacked K/V leaves) -> torch tensors."""
    return params_from_numpy(tree, device)
