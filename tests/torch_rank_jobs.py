"""Rank jobs of the port's tensor-parallel tests. ``launch.serve.spawn_ranks``
pickles each job by import path and runs it in a spawned rank process, so
they live in a module of their own that imports torch and repro_torch only
(no JAX in the ranks)."""
import torch

from repro_torch.dist import context as dctx
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import Model


def serve_tokens(mesh, device, *, cfg, params, prompts, max_new, server_kw,
                 prepared=""):
    """The prompts served through BatchServer(mesh=) on ``params`` (the
    whole tree, the same on every rank): the tokens, a few local leaf
    shapes (the proof that the rank served its pieces), the schedule keys
    that missed and, with an artifact directory, its recompute report."""
    from repro_torch import prepare, tune

    tune.reset_stats()
    pm = prepare.load(prepared, map_location=device) if prepared else None
    srv, done, _ = launch_serve.serve(Model(cfg, device=device), params,
                                      prompts, max_new=max_new, mesh=mesh,
                                      prepared=pm, **server_kw)
    local = srv._prepared_params
    shapes = {name: tuple(local["layers"]["attn"][name]["w"].shape)
              for name in ("wq", "wo")}
    return dict(tokens={r.rid: list(r.out_tokens) for r in done},
                shapes=shapes, tune_missed=sorted(tune._warned_keys),
                recomputed=None if pm is None else pm.recomputed)


def serve_ssm_tokens(mesh, device, *, cfg, params, prompts, max_new,
                     server_kw, prepared=""):
    """:func:`serve_tokens` for the SSM and hybrid stacks: the tokens, the
    local shapes of every Mamba mixer leaf and streaming-state leaf (the
    proof that the rank served its pieces) and, with an artifact
    directory, its recompute report."""
    from repro_torch import prepare

    pm = prepare.load(prepared, map_location=device) if prepared else None
    srv, done, _ = launch_serve.serve(Model(cfg, device=device), params,
                                      prompts, max_new=max_new, mesh=mesh,
                                      prepared=pm, **server_kw)
    group = "layers" if cfg.family == "ssm" else "hybrid_groups"
    return dict(tokens={r.rid: list(r.out_tokens) for r in done},
                shapes=leaf_shapes(srv._prepared_params[group]["ssm"]),
                cache=leaf_shapes(srv.cache[group]),
                recomputed=None if pm is None else pm.recomputed)


def leaf_shapes(tree, prefix=""):
    """{"a/b/c": shape} of every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in leaf_shapes(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tuple(tree.shape)}


def serve_pieces(mesh, device, *, cfg, params, prompts, max_new, server_kw):
    """The prompts served through BatchServer(mesh=) on ``params`` (the
    whole tree, the same on every rank): the tokens and the shape of every
    local leaf of the served params and of the slot cache."""
    srv, done, _ = launch_serve.serve(Model(cfg, device=device), params,
                                      prompts, max_new=max_new, mesh=mesh,
                                      **server_kw)
    return dict(tokens={r.rid: list(r.out_tokens) for r in done},
                params=leaf_shapes(srv._prepared_params),
                cache=leaf_shapes(srv.cache))


def contiguous_in_proj(specs):
    """A planted fault for ``parity.mixer_parity(plant=)``: Mamba1's in_proj
    cut contiguously over its concatenated x | z width (one rank all of x)
    instead of by each half."""
    from repro_torch.dist.sharding import Blocked, P

    if isinstance(specs, dict):
        return {k: contiguous_in_proj(v) for k, v in specs.items()}
    return P(*specs) if isinstance(specs, Blocked) else specs


def die_on_rank_1(mesh, device):
    """Rank 1 raises; rank 0 waits in a collective that rank 1 never
    joins."""
    if mesh.index("model") == 1:
        raise RuntimeError("planted rank failure")
    with dctx.mesh_context(mesh):
        dctx.all_sum(torch.ones(1, device=device))


def decode_collectives(mesh, device, *, cfg, quantized):
    """A rank's collectives in one decode step at 4 slots as a server on
    the mesh runs it (``launch.dryrun.served_steps``, after a warm-up
    step), in ``dist.context.record_collectives``' counting mode."""
    from repro_torch.launch import dryrun

    model = Model(cfg, device=device)
    steps, _ = dryrun.served_steps(model, model.init(0), quantized=quantized,
                                   mesh=mesh, max_len=32, prompt_len=8)
    steps["decode"]()
    with dctx.record_collectives() as records:
        steps["decode"]()
    return records


def train_on(mesh, device, *, shape, **kw):
    """``parity.train_parity`` on a ("data", "model") mesh of ``shape`` built
    over the spawned ranks (every rank builds it)."""
    from repro_torch.dist import parity

    return parity.train_parity(
        dctx.make_mesh(shape, ("data", "model")), device, **kw)


def ckpt_across(mesh, device, *, cfg, params, batch, ckpt_dir, ref_dir,
                ref_cfg=None):
    """One AdamW step at (2, 1), the state saved from the mesh to
    ``ckpt_dir``; restored at (1, 2) with ``restore(shardings=)``; and the
    reference's checkpoint in ``ref_dir`` (of ``ref_cfg``'s model) restored
    onto the (1, 2) mesh. Returns the whole trees (host): what was saved,
    what (1, 2) restored, and the reference's restored."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.dist import sharding as shd
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep

    def state_at(shape, c):
        m = dctx.make_mesh(shape, ("data", "model"))
        specs = shd.train_specs(params, m, c)
        pieces = shd.shard_tree(adamw.tree_map(torch.clone, params), specs,
                                m)
        return m, specs, pieces, adamw.init(pieces)

    def whole(tree, specs, m):
        with torch.no_grad(), dctx.mesh_context(m):
            return adamw.tree_map(lambda t: t.detach().clone(),
                                  shd.unshard_tree(tree, specs))

    model = Model(cfg, device=device)
    m21, specs, pieces, opt = state_at((2, 1), cfg)
    step = tstep.make_train_step(model, tstep.TrainConfig(), specs=specs)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with dctx.mesh_context(m21):
        pieces, opt, _ = step(pieces, opt, tb)
    full = tstep.state_specs(specs)
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(1, (pieces, opt), extra={"data_step": 1},
             shardings=shd.Shardings(full, m21))
    saved = whole((pieces, opt), full, m21)

    m12, specs12, pieces12, opt12 = state_at((1, 2), cfg)
    full12 = tstep.state_specs(specs12)
    state, extra = mgr.restore((pieces12, opt12),
                               shardings=shd.Shardings(full12, m12))
    shapes = [tuple(t.shape) for t in adamw.tree_leaves(state)]
    restored = whole(state, full12, m12)

    rc = ref_cfg or cfg
    _, rspecs, rpieces, ropt = state_at((1, 2), rc)
    rfull = tstep.state_specs(rspecs)
    rstate, _ = CheckpointManager(ref_dir).restore(
        (rpieces, ropt), shardings=shd.Shardings(rfull, m12))
    return dict(saved=saved, restored=restored, extra=extra,
                shapes=shapes, ref=whole(rstate, rfull, m12))
