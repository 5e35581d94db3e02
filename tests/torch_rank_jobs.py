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


def die_on_rank_1(mesh, device):
    """Rank 1 raises; rank 0 waits in a collective that rank 1 never
    joins."""
    if mesh.index("model") == 1:
        raise RuntimeError("planted rank failure")
    with dctx.mesh_context(mesh):
        dctx.all_sum(torch.ones(1, device=device))
