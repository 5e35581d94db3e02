"""Dry run of every (arch x shape) cell on the meta device: FLOPs, bytes,
memory and collectives a step needs, and its roofline on the H100.
Counterpart of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]

The reference lowers and compiles each cell for 256 (or 512) fake TPU
devices. The port traces the global, unsharded step at full width on the
meta device (no memory, no card, no process group; nothing of the
environment is changed) under ``launch.costs.CostMode``: the train step
with AdamW, a prefill, or a decode step at per-slot positions. From that
trace:

  * ``hlo_flops`` / ``hlo_bytes`` (the reference's key names): the aten
    walker and the kernels' own charges, entry inputs and outputs once;
  * ``model_flops``: 6 N_active D for training, 2 N_active D otherwise;
  * ``argument_bytes``: one device's pieces of the params (plus the AdamW
    state for training), the cache and the batch under the production
    mesh's rule table (``dist.sharding.param_specs`` / ``cache_specs`` /
    ``data_specs``, the reference's specs leaf for leaf);
  * ``peak_live_bytes``: the largest live tensor storage of the
    single-device trace;
  * the collective term: one rank's trace through the port's own mesh
    path, its collectives recorded (``dist.context.record_collectives``):
    a serving cell at the mesh's model-axis size (``serving_specs``,
    ``shard_tree``, ``mesh_context``), a training cell on the whole mesh
    (``train_specs``: the forward, the backward, the ``"data"`` gathers
    and reduce-scatters of the ZeRO cut and the gradient norm's sum). Where
    that path does not take a cell, ``collective_s`` is null and
    ``collective_reason`` says why.

Results land in ``build/reports/dryrun/<arch>__<shape>__<mesh>.json`` (or
``--out``); ``python -m repro_torch.launch.report`` renders them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
import traceback
from typing import Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.core.quant import attach_quantized_weights
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.kernels import compat
from repro_torch.launch import costs
from repro_torch.launch import inputs as inp
from repro_torch.launch import roofline as roof
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train.step import TrainConfig, make_train_step

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
               / "reports" / "dryrun")


def _model_flops(cfg, shape) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # decode: 1 token each


def _step(model: Model, kind: str):
    """The cell's step as a function of its argument tuple."""
    if kind == "train":
        return make_train_step(model, TrainConfig())

    def serve(params, cache, specs):
        with torch.no_grad():
            if kind == "prefill":
                extra = {k: specs[k] for k in ("frames", "patches")
                         if k in specs}
                return model.prefill(params, specs["tokens"], cache, **extra)
            return model.decode_step(params, specs["token"], cache,
                                     specs["pos"])
    return serve


def _split(axes, mesh) -> int:
    """Pieces of a dim split over ``axes`` (None, an axis or a tuple)."""
    n = 1
    for a in ((axes,) if isinstance(axes, str) else axes or ()):
        n *= mesh.size(a)
    return n


def _piece_bytes(tree, specs, mesh) -> float:
    """Bytes of one device's pieces of ``tree`` under ``specs``."""
    if isinstance(tree, torch.Tensor):
        split = 1
        for axes in specs:
            split *= _split(axes, mesh)
        return tree.numel() * tree.element_size() / split
    if isinstance(tree, dict):
        return sum(_piece_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_piece_bytes(v, s, mesh) for v, s in zip(tree, specs))
    return 0.0


def _argument_bytes(cfg, shape, params, specs, mesh) -> float:
    part = cfg.moe.partition if cfg.moe else "expert"
    pspecs = shd.param_specs(params, mesh, moe_partition=part)
    total = _piece_bytes(params, pspecs, mesh)
    if shape.kind == "train":
        opt = adamw.init(params)
        total += (_piece_bytes(opt.step, shd.P(), mesh)
                  + _piece_bytes(opt.m, pspecs, mesh)
                  + _piece_bytes(opt.v, pspecs, mesh))
        total += _piece_bytes(specs, shd.data_specs(specs, mesh), mesh)
        return total
    cache = specs["cache"]
    total += _piece_bytes(cache, shd.cache_specs(
        cache, mesh, batch=shape.global_batch), mesh)
    rest = {k: v for k, v in specs.items() if k != "cache"}
    return total + _piece_bytes(rest, shd.data_specs(rest, mesh), mesh)


def train_collectives(cfg, params, batch, shape, axes) -> list:
    """One rank's collectives in one train step on a shape-only mesh of
    ``shape`` over ``axes`` (rank 0's coordinate), traced on the meta
    device: ``params`` whole and ``batch`` the global batch (as every rank
    is handed it), both meta tensors. What a connected rank of that mesh
    records in the same step (phase dist train holds them equal)."""
    mesh = dctx.make_mesh(shape, axes, connect=False)
    meta = Model(cfg, device="meta")
    specs = shd.train_specs(params, mesh, cfg)
    local = shd.shard_tree(params, specs, mesh)
    step = make_train_step(meta, TrainConfig(), specs=specs)
    with dctx.mesh_context(mesh), costs.CostMode(), \
            dctx.record_collectives() as records:
        step(local, adamw.init(local), batch)
    return records


def _rank_collectives(cfg, shape, params, specs, mesh) -> tuple:
    """(CollectiveStats or None, reason) of one rank's step through the
    port's mesh path: a serving step at the mesh's model-axis size (every
    arch serves on it; whisper's prefill takes its frames, pixtral's its
    patches), its batch the global batch's piece under the mesh's data
    specs; a train step on the whole mesh (:func:`train_collectives`)."""
    if shape.kind == "train":
        try:
            records = train_collectives(cfg, params, specs,
                                        tuple(mesh.devices.shape),
                                        mesh.axis_names)
        except Exception as e:  # noqa: BLE001 - the reason is the result
            return None, (f"the port's mesh path does not take this "
                          f"training cell: {type(e).__name__}: {e}")
        return roof.collective_stats(records), ""
    tp = mesh.size(dctx.MODEL)
    rest = {k: v for k, v in specs.items() if k != "cache"}
    batch_axes = shd.data_specs(rest, mesh)[next(iter(rest))][0]
    batch = shape.global_batch // _split(batch_axes, mesh)
    rank_mesh = dctx.make_mesh((1, tp), ("data", dctx.MODEL), connect=False)
    part = cfg.moe.partition if cfg.moe else "expert"
    model = Model(cfg, device="meta")
    local = shd.shard_tree(params, shd.serving_specs(
        params, rank_mesh, cfg, moe_partition=part), rank_mesh)
    specs = {k: inp.sds((batch,) + tuple(v.shape[1:]), v.dtype)
             for k, v in rest.items()}
    max_len = shape.seq_len + (cfg.frontend_tokens
                               if cfg.frontend == "vision" else 0)
    cache = model.init_cache(batch, max_len)
    cache = shd.shard_tree(cache, shd.serving_cache_specs(
        cache, rank_mesh, cfg, batch=batch), rank_mesh)
    try:
        with dctx.mesh_context(rank_mesh), costs.CostMode(), \
                dctx.record_collectives() as records:
            _step(model, shape.kind)(local, cache, specs)
    except Exception as e:  # noqa: BLE001 - the reason is the result
        return None, (f"the port's mesh path does not take this cell at tp "
                      f"{tp}: {type(e).__name__}: {e}")
    return roof.collective_stats(records), ""


def _is_gemm(tag: str) -> bool:
    """A breakdown tag of a 2-D product ``"dot MxK @ KxN"``: the dense
    layers' GEMMs (attention's batched products have 3-D operands)."""
    if not tag.startswith("dot "):
        return False
    lhs, rhs = tag[4:].split(" @ ")
    return lhs.count("x") == 1 and rhs.count("x") == 1


def trace_cell(arch: str, shape_name: str, *, multi_pod: bool = False
               ) -> Tuple[costs.CostMode, dict]:
    """Trace one cell's global step on the meta device (the counterpart of
    the reference's ``lower_cell``). Returns (the trace, meta): the cell's
    names, cards and trace seconds, and under ``"_cell"`` what
    :func:`analyze` reads."""
    cfg, shape, specs = inp.input_specs(arch, shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    model = Model(cfg, device="meta")
    params = model.init(0)
    t0 = time.perf_counter()
    with costs.CostMode(breakdown=True, track_live=True) as mode:
        if shape.kind == "train":
            args = (params, adamw.init(params), specs)
        else:
            args = (params, specs["cache"], specs)
        mode.track(args)
        out = _step(model, shape.kind)(*args)
    meta = dict(arch=arch, shape=shape_name,
                mesh="2x16x16" if multi_pod else "16x16",
                chips=int(mesh.devices.size), kind=shape.kind,
                compile_s=round(time.perf_counter() - t0, 1))
    meta["_cell"] = (cfg, shape, params, specs, mesh,
                     costs.io_bytes(args) + costs.io_bytes(out))
    return mode, meta


def analyze(mode: costs.CostMode, meta: dict) -> dict:
    """The cell's report (the counterpart of the reference's ``analyze``):
    FLOPs and bytes with the entry inputs and outputs once, the model
    FLOPs, one device's argument bytes, the trace's peak of live storage,
    its predicted launches and costliest tags, one rank's collectives and
    the roofline terms."""
    cfg, shape, params, specs, mesh, io = meta.pop("_cell")
    total = costs.Cost(mode.total.flops, mode.total.bytes + io)
    coll, reason = _rank_collectives(cfg, shape, params, specs, mesh)
    top = sorted(mode.detail.items(), key=lambda kv: -kv[1].bytes)[:10]
    out = dict(meta)
    out.update(
        hlo_flops=total.flops, hlo_bytes=total.bytes,
        argument_bytes=_argument_bytes(cfg, shape, params, specs, mesh),
        peak_live_bytes=mode.peak_live_bytes,
        bytes_per_device=None, launches=mode.launches,
        top_costs=[(k, v.flops, v.bytes) for k, v in top],
        gemm_flops=sum(v.flops for k, v in mode.detail.items()
                       if _is_gemm(k)))
    out.update(roof.roofline_report(
        total.flops, total.bytes, coll, meta["chips"], dtype=cfg.dtype,
        model_flops=_model_flops(cfg, shape), collective_reason=reason))
    return out


def served_steps(model: Model, params, *, quantized: bool, mesh=None,
                 slots: int = 4, max_len: int = 256, prompt_len: int = 128,
                 moe_partition: str = "expert") -> Tuple[dict, tuple]:
    """One bucketed prefill dispatch (``slots`` x ``prompt_len``) and one
    decode step at ``slots`` slots as ``BatchServer`` runs them with FFIP
    through the kernels: int8 ``q`` entries attached when ``quantized``
    (the whole weights quantized, then cut), under ``mesh`` this rank's
    pieces of the weights and the cache, each call in the server's scope
    (mesh, GEMM config, its own per-weight memo, no grad). On the card they
    launch the kernels; on the meta device, in a costing trace, they charge
    them. Returns ({"prefill": fn, "decode": fn}, the state they read: the
    run-ready params and the cache)."""
    cfg = model.cfg
    gemm = GemmConfig(algo="ffip", impl="cuda", quantized=quantized)
    derived = compat.DerivedCache()

    def scope():
        stack = contextlib.ExitStack()
        if mesh is not None:
            stack.enter_context(dctx.mesh_context(mesh))
        stack.enter_context(use_gemm(gemm))
        stack.enter_context(compat.use_derived(derived))
        stack.enter_context(torch.no_grad())
        return stack

    with scope():
        p = attach_quantized_weights(params) if quantized else params
        if mesh is not None:
            p = shd.shard_tree(p, shd.serving_specs(
                p, mesh, cfg, moe_partition), mesh)
    cache = model.init_cache(slots, max_len)
    if mesh is not None:
        cache = shd.shard_tree(cache, shd.serving_cache_specs(
            cache, mesh, cfg, batch=slots), mesh)
    dev = model.device
    tokens = torch.zeros((slots, prompt_len), dtype=torch.long, device=dev)
    lengths = torch.full((slots,), prompt_len, dtype=torch.long, device=dev)
    mask = torch.ones((slots,), dtype=torch.bool, device=dev)
    pos = torch.full((slots,), prompt_len, dtype=torch.long, device=dev)

    def run(fn):
        with scope():
            return fn()

    steps = {
        "prefill": lambda: run(lambda: model.prefill_sample(
            p, tokens, cache, lengths, mask)),
        "decode": lambda: run(lambda: model.sample_step(
            p, tokens[:, :1], cache, pos)),
    }
    return steps, (p, cache)


def predict_dispatch(step, state) -> costs.CostMode:
    """Trace ``step`` (one of :func:`served_steps`' on the meta device)
    twice in one costing trace: a warm-up call that derives the y deltas
    and carry tables, as a server prepares its weights before it serves,
    then the call whose charges, predicted launches, peak of live storage
    and collectives (``mode.collectives``, one rank's on a mesh) the
    returned trace keeps. The entry bytes (``state``) are added once."""
    with costs.CostMode(track_live=True) as mode:
        mode.track(state)
        step()
        mode.reset()
        with dctx.record_collectives() as mode.collectives:
            out = step()
    mode.total += costs.Cost(0.0, costs.io_bytes(state) + costs.io_bytes(out))
    return mode


def storage_bytes(tree, block: int = 1) -> int:
    """The bytes of ``tree``'s distinct storages, each rounded up to a
    multiple of ``block`` (512: the CUDA caching allocator's granule). With
    ``block=1``, what the tensors ask the allocator for (its
    ``requested_bytes`` counter)."""
    seen = {}
    for t in costs.tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = -(-st.nbytes() // block) * block
    return sum(seen.values())


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path) -> bool:
    cfg = configs.get_config(arch)
    shape = configs.SHAPE_BY_NAME[shape_name]
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    path = out_dir / f"{arch}__{shape_name}__{mesh_tag}.json"
    ok, why = configs.shape_supported(cfg, shape)
    if not ok:
        path.write_text(json.dumps(dict(arch=arch, shape=shape_name,
                                        mesh=mesh_tag, status="skipped",
                                        reason=why), indent=1))
        print(f"SKIP {arch} x {shape_name} [{mesh_tag}]: {why}")
        return True
    try:
        result = analyze(*trace_cell(arch, shape_name, multi_pod=multi_pod))
        result["status"] = "ok"
        path.write_text(json.dumps(result, indent=1, default=str))
        coll = result["collective_s"]
        print(f"OK   {arch} x {shape_name} [{mesh_tag}] "
              f"trace={result['compile_s']}s "
              f"bottleneck={result['bottleneck']} "
              f"roofline_frac={result['roofline_fraction']:.3f} collective="
              f"{'null' if coll is None else f'{coll:.3g}s'}", flush=True)
        return True
    except Exception as e:  # noqa: BLE001 - record the failure, keep sweeping
        path.write_text(json.dumps(dict(
            arch=arch, shape=shape_name, mesh=mesh_tag, status="failed",
            error=f"{type(e).__name__}: {e}",
            traceback=traceback.format_exc()[-4000:]), indent=1))
        print(f"FAIL {arch} x {shape_name} [{mesh_tag}]: "
              f"{type(e).__name__}: {e}", flush=True)
        return False


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = (sorted(configs.ARCHS) if (args.all or not args.arch)
             else [args.arch])
    shapes = ([s.name for s in SHAPES] if (args.all or not args.shape)
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    t0 = time.perf_counter()
    failures = sum(not run_cell(a, s, mp, out_dir) for a, s, mp in cells)
    print(f"done: {len(cells) - failures}/{len(cells)} cells ok in "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
