"""Tensor-parallel layer parity: a dense layer run on this rank's pieces
against the whole layer on one device, on every rank of a connected mesh.
The check that holds the mesh path's layers to the single device's, shared
by the CPU tests, the card tests and ``chip_smoke.py``: a rank job
(``launch.serve.spawn_ranks``) that builds the same seeded inputs on every
rank and returns what it found.

* int8, column-parallel: ``qw`` cut on N (the whole weight quantized
  first), the per-channel vectors whole; the ranks' columns gathered must
  equal the whole layer's bit for bit.
* int8, row-parallel: ``x`` and ``qw`` cut on K; the reduced result must
  equal the whole layer's bit for bit.
* float, row-parallel: the ranks' f32 partials summed and rounded once,
  within the reference's f32 GEMM bar of the whole layer (rtol 1e-4, atol
  1e-3 max(1, K / 64)): the same products summed in another order.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.core import quant
from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.dist import context as dctx
from repro_torch.dist.sharding import P, shard_leaf
from repro_torch.kernels import compat
from repro_torch.models import layers as L

Tensor = torch.Tensor
ALGOS = ("baseline", "fip", "ffip")


def _inputs(m: int, k: int, n: int, dtype, device, seed: int):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g)
    w = torch.randn((k, n), generator=g) / k ** 0.5
    return x.to(dtype).to(device), w.to(dtype).to(device)


def _layer(x: Tensor, p: dict, algo: str, quantized: bool, *,
           row_parallel: bool = False) -> Tensor:
    with use_gemm(GemmConfig(algo=algo, impl="cuda", quantized=quantized)), \
            torch.no_grad(), compat.use_derived(compat.DerivedCache()):
        return L.dense(x, p, row_parallel=row_parallel)


def layer_parity(mesh, device, *, shapes: Sequence[tuple],
                 dtype: str = "bf16", seed: int = 0) -> Dict[str, dict]:
    """For each (M, K, N) of ``shapes`` and each algo, the int8 column- and
    row-parallel layers and the float row-parallel layer on this rank's
    pieces against the whole layer, through ``layers.dense`` and the
    kernels (their plain versions on the CPU). Returns {label: {"ok",
    "max_abs_err", "tol"}}."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    col, row = P(None, dctx.MODEL), P(dctx.MODEL, None)
    out: Dict[str, dict] = {}
    for m, k, n in shapes:
        x, w = _inputs(m, k, n, dt, device, seed)
        q = quant.prepare_quantized_dense(w)
        q_col = dict(q, qw=shard_leaf(q["qw"], col, mesh))
        q_row = dict(q, qw=shard_leaf(q["qw"], row, mesh))
        x_row = shard_leaf(x, P(None, dctx.MODEL), mesh)
        w_row = shard_leaf(w, row, mesh)
        for algo in ALGOS:
            whole = _layer(x, {"w": w, "q": q}, algo, True)
            with dctx.mesh_context(mesh):
                got_col = dctx.all_gather(_layer(x, {"q": q_col}, algo,
                                                 True), -1)
                got_row = _layer(x_row, {"q": q_row}, algo, True,
                                 row_parallel=True)
            for kind, got in (("column", got_col), ("row", got_row)):
                out[f"int8 {kind}-parallel {algo} M={m} K={k} N={n}"] = dict(
                    ok=torch.equal(got, whole), tol="bit for bit",
                    max_abs_err=float((got.double()
                                       - whole.double()).abs().max()))
            whole = _layer(x, {"w": w}, algo, False)
            with dctx.mesh_context(mesh):
                got = _layer(x_row, {"w": w_row}, algo, False,
                             row_parallel=True)
            atol = 1e-3 * max(1, k // 64)
            err = (got.double() - whole.double()).abs()
            out[f"{dtype} row-parallel {algo} M={m} K={k} N={n}"] = dict(
                ok=bool((err <= atol + 1e-4 * whole.double().abs()).all()),
                tol=f"rtol 1e-4 atol {atol:g}",
                max_abs_err=float(err.max()))
    return out
