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

The SSM mixers (:func:`mixer_parity`), one layer at an arch's widths cut by
``serving_specs`` / ``serving_cache_specs``, against the whole mixer on the
same input and streaming state, at a decode step (B rows, S 1: the plain
f32 scan) and a prefill (B 1, S rows: K6):

* int8 Mamba1: ``in_proj`` column-parallel (x | z halves), ``x_proj`` and
  ``out_proj`` row-parallel with int32 sums, K6 and the conv per channel:
  the output and this rank's piece of the new state equal the whole
  mixer's bit for bit;
* float Mamba1 and Mamba2 (float and int8; Mamba2's gated norm sums its
  squares over the ranks): within the f32 GEMM bar at K = d_inner.

:func:`scan_columns`: K6 on this rank's channels against the whole K6's
columns, bit for bit (every output channel reads its own channel alone).

:func:`frontend_run`: the frontend entry point (``Model.prefill(frames=)``
for whisper's encoder and cross attention, ``patches=`` for pixtral's
prefix) and greedy decode steps on this rank's pieces of the params and the
cache, for comparison with the single device.

Training on a mesh (:func:`train_parity`): train steps on this rank's
``("data", "model")`` pieces (``sharding.train_specs``) of the global
batch, returning what the single device's step is held to: the loss,
every gradient gathered whole, the gradient norm, the metrics and the
params after the steps, the pieces' shapes, the first step's collectives
and, for a MoE, each layer's keep mask against the global rule applied to
the ranks' gathered expert choices (:func:`record_routing`,
:func:`keep_mismatches`).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import quant
from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding
from repro_torch.dist.sharding import P, shard_leaf
from repro_torch.kernels import compat
from repro_torch.kernels import selective_scan as ssk
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

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


def _f32_bar(got: Tensor, want: Tensor, k: int) -> dict:
    atol = 1e-3 * max(1, k // 64)
    err = (got.double() - want.double()).abs()
    return dict(ok=bool((err <= atol + 1e-4 * want.double().abs()).all()),
                tol=f"rtol 1e-4 atol {atol:g}", max_abs_err=float(err.max()))


def _exact(got: Tensor, want: Tensor) -> dict:
    return dict(ok=torch.equal(got, want), tol="bit for bit",
                max_abs_err=float((got.double() - want.double()).abs().max()))


def _mixer(p: dict, x: Tensor, cache: dict, cfg, quantized: bool,
           prefill: bool):
    apply = S.mamba1_apply if cfg.ssm.version == 1 else S.mamba2_apply
    kw = dict(prefill=prefill) if cfg.ssm.version == 1 else {}
    with use_gemm(GemmConfig(algo="ffip", impl="cuda",
                             quantized=quantized)), torch.no_grad(), \
            compat.use_derived(compat.DerivedCache()):
        out, _ = apply(p, x, cfg=cfg, cache=cache, **kw)
    return out


def _cut_cache(cache: dict, mesh, cfg, batch: int) -> dict:
    """This rank's piece of one layer's streaming state, cut as the server
    cuts the stacked cache (``serving_cache_specs``)."""
    stacked = {"layers": {k: v[None] for k, v in cache.items()}}
    specs = sharding.serving_cache_specs(stacked, mesh, cfg, batch=batch)
    return {k: v[0] for k, v in sharding.shard_tree(
        stacked, specs, mesh)["layers"].items()}


def mixer_parity(mesh, device, *, arch: str, cases: Sequence[tuple],
                 smoke: bool = False, seed: int = 0, plant=None
                 ) -> Dict[str, dict]:
    """One Mamba mixer of ``arch`` (its published widths, or its smoke
    widths with ``smoke``) in the config's dtype, float and int8
    FFIP, on this rank's pieces against the whole mixer, for each (B, S) of
    ``cases`` (S 1: a decode step; S > 1: a prefill through K6) from a
    random streaming state. Returns {label: {"ok", "max_abs_err", "tol"}}:
    the int8 Mamba1 mixer bit for bit, the others within the f32 GEMM bar
    at K = d_inner; each label's check covers the output and this rank's
    piece of the new state, and ``"sd"`` reads the output's largest
    deviation in standard deviations of the whole mixer's output.
    ``plant(specs)``, when given, rewrites the serving specs before the
    cut: a planted fault the checks must see."""
    cfg = configs.get_config(arch)
    if smoke:
        cfg = configs.smoke_config(cfg)
    s_cfg = cfg.ssm
    di = s_cfg.expand * cfg.d_model
    gen = torch.Generator(device=device).manual_seed(seed)
    init = S.mamba1_init if s_cfg.version == 1 else S.mamba2_init
    whole = {"ssm": init(gen, cfg, cfg.dtype, device=device)}
    out: Dict[str, dict] = {}
    for quantized in (False, True):
        params = (quant.attach_quantized_weights(whole) if quantized
                  else whole)
        specs = sharding.serving_specs(params, mesh, cfg)
        local = sharding.shard_tree(
            params, specs if plant is None else plant(specs), mesh)
        exact = quantized and s_cfg.version == 1
        tier = "int8" if quantized else str(cfg.dtype).split(".")[-1]
        for b, s in cases:
            state = {k: torch.randn(v.shape[1:], generator=gen,
                                    device=device).to(v.dtype)
                     for k, v in T._ssm_cache(cfg, 1, b, cfg.dtype,
                                              device).items()}
            x = (torch.randn((b, s, cfg.d_model), generator=gen,
                             device=device) / 2).to(cfg.dtype)
            cache = {k: v.clone() for k, v in state.items()}
            mine = _cut_cache(state, mesh, cfg, b)
            want = _mixer(params["ssm"], x, cache, cfg, quantized, s > 1)
            with dctx.mesh_context(mesh):
                got = _mixer(local["ssm"], x, mine, cfg, quantized, s > 1)
            cut = _cut_cache(cache, mesh, cfg, b)
            res = [_exact(g, w) if exact else _f32_bar(g, w, di)
                   for g, w in [(got, want)] + [(mine[k], cut[k])
                                                for k in cut]]
            out[f"{arch} {tier} ffip mixer B={b} S={s}"] = dict(
                ok=all(r["ok"] for r in res), tol=res[0]["tol"],
                max_abs_err=max(r["max_abs_err"] for r in res),
                sd=float((got.double() - want.double()).abs().max()
                         / want.double().std()))
    return out


def scan_columns(mesh, device, *, di: int, cases: Sequence[tuple],
                 n: int = 16, dtype: str = "bf16", chunk: int = 128,
                 seed: int = 0) -> Dict[str, dict]:
    """K6 on this rank's ``di / tp`` channels against the whole K6's
    columns of y, h_final and h_starts, for each (B, S) of ``cases``, bit
    for bit. Inputs as the served prefill feeds them (dt positive, A
    negative). No collective runs: the check needs only this rank's
    index."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    tp = mesh.size(dctx.MODEL)
    lo = mesh.index(dctx.MODEL) * (di // tp)
    cols = slice(lo, lo + di // tp)
    out: Dict[str, dict] = {}
    for b, s in cases:
        g = torch.Generator(device=device).manual_seed(seed + s)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=device)

        x, c = rnd(b, s, di).to(dt), rnd(b, s, n).to(dt)
        bm = rnd(b, s, n).to(dt)
        dtv = (torch.nn.functional.softplus(rnd(b, s, di)) / 4).to(dt)
        a = -torch.exp(rnd(di, n) / 4)
        h0 = rnd(b, di, n) / 4
        ck = min(chunk, s)
        with torch.no_grad():
            y, h, starts = ssk.selective_scan(x, dtv, bm, c, a, h0,
                                              chunk=ck)
            yl, hl, startsl = ssk.selective_scan(
                x[..., cols].contiguous(), dtv[..., cols].contiguous(), bm,
                c, a[cols].contiguous(), h0[:, cols].contiguous(), chunk=ck)
        res = [_exact(yl, y[..., cols]), _exact(hl, h[:, cols]),
               _exact(startsl, starts[:, :, cols])]
        out[f"K6 di {di} -> {di // tp} B={b} S={s} {dtype}"] = dict(
            ok=all(r["ok"] for r in res), tol="bit for bit",
            max_abs_err=max(r["max_abs_err"] for r in res))
    return out


def frontend_run(mesh, device, *, cfg, rows: int, prompt: int, steps: int,
                 seed: int = 0, quantized: bool = False, algo: str = "ffip",
                 params=None, tokens=None, frames=None, patches=None) -> dict:
    """The frontend entry point on this rank's pieces: ``Model.prefill``
    with ``frames`` (whisper: the encoder, non-causal through K4 on the
    rank's heads, and every decoder layer's cross K/V of those heads into
    the cache) or ``patches`` (pixtral's prefix), then ``steps`` greedy
    ``decode_step``s at positions that count the prefix, in the GEMM scope
    of a ``BatchServer(mesh=, gemm_algo=algo, gemm_impl="cuda",
    quantized=)`` and on the pieces it prepares (the whole weights
    quantized, then cut). ``mesh=None``: the same on one device.

    ``params`` default to ``Model.init(seed)``. Without ``tokens`` every
    input is drawn from ``seed`` as ``chip_smoke.py``'s phase encdec draws
    them (``rows`` x ``prompt`` tokens by numpy, then the frames or patches
    by the stubs of ``models.frontends``), so every rank and a single
    device see the same inputs; with ``tokens``, ``frames`` and
    ``patches`` are the caller's (None: none). Returns the tokens ((rows,
    steps + 1) ints), the prefill's and the last step's logits (f32, on
    the CPU), the launch counts, the peak device memory and the times."""
    from repro_torch.models.frontends import (audio_frames_stub,
                                              vision_patches_stub)
    from repro_torch.models.model import Model
    from repro_torch.serve.batcher import BatchServer

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    model = Model(cfg, device=device)
    if params is None:
        params = model.init(seed)
    if tokens is None:
        tokens = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                      (rows, prompt))
        gen = torch.Generator(device=device).manual_seed(seed)
        if cfg.encoder is not None:
            frames = audio_frames_stub(gen, rows, cfg, device=device)
        elif cfg.frontend == "vision":
            patches = vision_patches_stub(gen, rows, cfg, device=device)
    tokens, frames, patches = (None if t is None
                               else torch.as_tensor(t, device=device)
                               for t in (tokens, frames, patches))
    pos = tokens.shape[1] + (0 if patches is None else patches.shape[1])
    srv = BatchServer(model, batch_slots=1, max_len=1, device=device,
                      mesh=mesh, quantized=quantized, gemm_algo=algo,
                      gemm_impl="cuda")
    p = srv._params_for(params)
    cache = model.init_cache(tokens.shape[0], pos + steps + 1)
    if mesh is not None:
        cache = sharding.shard_tree(cache, sharding.serving_cache_specs(
            cache, mesh, cfg, batch=tokens.shape[0]), mesh)
    if cuda:
        torch.cuda.synchronize(device)
    compat.reset_counters()
    with srv._gemm_scope():
        t0 = time.perf_counter()
        cache, logits = model.prefill(p, tokens, cache, frames=frames,
                                      patches=patches)
        first = logits.float().cpu()
        tok = logits.argmax(-1)
        out = [tok]
        t1 = time.perf_counter()
        for i in range(steps):
            cache, logits = model.decode_step(p, tok[:, None], cache,
                                              pos + i)
            tok = logits.argmax(-1)
            out.append(tok)
        ids = torch.stack(out, 1).cpu().numpy()
        t2 = time.perf_counter()
    return dict(tokens=ids.tolist(), first=first, last=logits.float().cpu(),
                launches=compat.launch_counts(), prefill_s=t1 - t0,
                ms_per_step=1e3 * (t2 - t1) / max(1, steps),
                peak_gib=(torch.cuda.max_memory_allocated(device) / 2 ** 30
                          if cuda else 0.0))


# --- training on a mesh ------------------------------------------------------

@contextlib.contextmanager
def record_routing() -> Iterator[list]:
    """Record each MoE routing the forward runs in the block: (this rank's
    expert choices (T, k), its keep mask (T k,)) a call of
    ``moe.assign_slots``."""
    records: list = []
    real = MOE.assign_slots

    def recorded(expert_idx, cfg):
        out = real(expert_idx, cfg)
        records.append((expert_idx.detach(), out[2].detach()))
        return out

    MOE.assign_slots = recorded
    try:
        yield records
    finally:
        MOE.assign_slots = real


def keep_mismatches(records: list, cfg) -> list:
    """For each recorded routing on the ambient mesh: the elements of this
    rank's keep mask that differ from the single device's rule
    (``moe.assign_slots`` without a mesh) applied to the ranks' expert
    choices gathered over the batch axes, this rank's rows of it. Every
    rank of the mesh takes part."""
    axes = dctx.batch_axes()
    out = []
    for idx, keep in records:
        gathered = dctx.all_gather(idx, 0, axes)
        with dctx.mesh_context(None):
            _, _, want, _ = MOE.assign_slots(gathered, cfg)
        lo = dctx.axis_index(axes) * keep.numel()
        out.append(int((want[lo:lo + keep.numel()] != keep).sum()))
    return out


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().to("cpu")


def _shapes(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tuple(tree.shape)}


def train_parity(mesh, device, *, cfg, batch: dict, params=None,
                 seed: int = 0, steps: int = 1,
                 optimizer: Optional[dict] = None) -> dict:
    """A rank job: ``steps`` AdamW steps (``optimizer``: its config's
    fields) of ``cfg`` on this rank's pieces of ``params`` (a whole tree,
    the same on every rank; default the model's from ``seed``) and of the
    global ``batch`` (numpy, the same on every rank). Returns, on the
    host: ``loss`` and ``grads`` (step 0's, every leaf gathered whole),
    ``history`` (each step's metrics), ``params`` (whole, after the steps),
    ``shapes`` (the pieces'), ``collectives`` (step 0's records), ``keep``
    (step 0's keep-mask mismatches a MoE layer), ``aux`` (step 0's MoE
    aux losses, summed over the layers) and ``launches`` (the kernels'
    launch counts over the steps)."""
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep

    model = Model(cfg, device=device)
    whole = (model.init(seed) if params is None
             else T._tree_map(lambda t: t.to(device), params))
    specs = sharding.train_specs(whole, mesh, cfg)
    pieces = sharding.own_pieces(whole, specs, mesh)
    opt = adamw.init(pieces)
    tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    step = tstep.make_train_step(model, tstep.TrainConfig(
        optimizer=adamw.AdamWConfig(**(optimizer or {}))), specs=specs)
    out = dict(shapes=_shapes(pieces), history=[])
    compat.reset_counters()
    aux: list = []
    real_moe = MOE.moe_apply

    def moe_aux(*a, **kw):
        res = real_moe(*a, **kw)
        aux.append(res[1].detach())
        return res

    with dctx.mesh_context(mesh):
        for i in range(steps):
            got: list = []
            if i == 0:
                MOE.moe_apply = moe_aux
                try:
                    with record_routing() as routing, \
                            dctx.record_collectives() as records:
                        pieces, opt, met = step(pieces, opt, tb,
                                                grads_out=got)
                finally:
                    MOE.moe_apply = real_moe
                with torch.no_grad():
                    out["grads"] = _host(sharding.unshard_tree(got[0],
                                                               specs))
                out.update(loss=float(met["loss"]), collectives=records,
                           keep=keep_mismatches(routing, cfg),
                           aux=float(sum(aux)) if aux else 0.0)
            else:
                pieces, opt, met = step(pieces, opt, tb)
            out["history"].append({k: float(v) for k, v in met.items()})
        out["launches"] = compat.launch_counts()
        with torch.no_grad():
            out["params"] = _host(sharding.unshard_tree(pieces, specs))
    return out
