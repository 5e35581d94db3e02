"""Name/shape-pattern sharding rules -> spec trees, and the cut of a tree
into one rank's pieces. Counterpart of ``repro/dist/sharding.py``: the rule
table (:func:`_match_spec`, :func:`param_specs`, :func:`data_specs`,
:func:`cache_specs`, the divisibility guard and the ``q/`` parent rule) is
a copy, and its specs equal the reference's leaf for leaf.

  * column-parallel weights (wq/wk/wv, mlp up/gate, router, x_proj, ...):
    input dim over "data", output dim over "model";
  * row-parallel weights (wo, mlp down, out_proj): input dim over "model",
    output dim over "data";
  * MoE expert banks (w_gate/w_up/w_down, (L, E, d, f)): the expert axis
    over "model" (``moe_partition="expert"``) or d_ff_expert over "model"
    (``"ffn"``), d_model over "data";
  * the embedding table (V, d): vocab over "model", d over "data";
  * biases, norm scales, the int8 epilogue vectors and other vectors and
    scalars: replicated.

Every assignment passes a hard divisibility guard: a dim that does not
divide its axis stays whole (None).

A spec is a tuple with one entry a dim (:class:`P`): None, an axis name,
or a tuple of axis names. The reference hands its specs to GSPMD, which
places the pieces and inserts the collectives; the port cuts each rank's
local pieces itself (:func:`shard_tree`) and its model code reduces their
partial results (``repro_torch.dist.context``). Where that code needs a
leaf whole that a spec splits, :func:`serving_specs` keeps it whole. The
widenings, each of a leaf that every rank must read in full:

  * a MoE router's weight (``router/...``): the top-k over the experts
    reads every expert's logit;
  * MLA's latent projections ``w_dkv`` and ``w_kr``: every local head
    reads the whole compressed latent and the shared rope key;
  * an attention projection whose heads do not divide the model axis
    (``wq``, ``wo``, ``w_ukv`` when H % tp != 0; ``wk``, ``wv`` when
    KV % tp != 0): heads split as whole heads or not at all, and a local
    q head's kv head must be local.

The SSM cuts, each of a leaf that the reference's spec keeps whole or
cuts in another order than the port's ranks read it (GSPMD may re-shard
anywhere; the port's model code reduces what each rank holds). They apply
where d_inner (Mamba1) or the heads (Mamba2, with one B / C group) divide
the model axis, and otherwise every SSM leaf stays whole:

  * Mamba1 ``in_proj`` (d, 2 di) and its per-channel int8 vectors: each of
    the x and z halves split (:class:`Blocked`), not the concatenated
    width, whose contiguous cut would give one rank all of x;
  * Mamba1 ``x_proj`` (di, R + 2N): row-parallel on the local d_inner it
    consumes (the reference's spec is column-parallel);
  * Mamba1 ``A_log`` (di, N): cut by rows (the generic rule splits N);
  * Mamba2 ``bc_proj`` and ``conv_bc`` (width 2 N at G = 1): whole, since
    every head reads the whole of B and C (a cut would give B to one rank
    and C to the other).

The rest of the mixers keep the reference's specs: ``conv_w`` / ``conv_x``,
``dt_proj``, ``z_proj``, ``x_proj_in`` and ``dtp`` column-parallel on
d_inner or whole heads, ``out_proj`` row-parallel; ``D``, ``dt_bias``,
``A_log`` (Mamba2) and the gated norm's scale are read as local slices.
:func:`serving_cache_specs` cuts the streaming state the same way: the
conv inputs and the scan state on the local d_inner or heads.

The encoder-decoder and the patch prefix need no rule of their own: the
names carry them. Whisper's ``encoder/layers/...`` cut as the decoder's
layers do, each decoder layer's cross attention ``xattn/{wq,wk,wv}``
column-parallel and ``xattn/wo`` row-parallel by heads (whole with the
self-attention's where the heads do not split), and the cached cross K/V
``cross_kv/{k,v}`` ((L, B, T, KV, hd)) by KV heads as any K/V leaf; a vocab
that does not divide the model axis (whisper's 51865) stays whole under
the guard. Pixtral's patches enter before the first layer, whole on every
rank.

Apart from these, nothing is split that a spec keeps whole. A
column-parallel layer reads its piece of a replicated per-channel vector
(bias, int8 scale, zero point, folded beta, colsum) as a view
(``context.local_slice``); a row-parallel one adds it once, after the
reduce.

Training (:func:`train_specs`) holds each rank's ``("data", "model")``
piece of every leaf and of AdamW's moments: the ``"model"`` cut of
:func:`serving_specs`, so the same model code runs, and the reference's
``"data"`` cut (ZeRO) on its own dim where the ``"model"`` cut left that
dim whole. :func:`gather_data` joins a tree's ``"data"`` pieces for the
forward, and its backward reduce-scatters the gradients back to the
pieces; :func:`unshard_tree` gathers whole leaves (a checkpoint from a
mesh).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.dist import context as dctx
from repro_torch.dist.context import DATA, MODEL

PyTree = Any

# Leaves that are never worth sharding (biases, norm params, scalars, and
# the tiny per-output-channel int8 epilogue vectors from repro_torch.prepare).
_REPLICATED_LEAVES = frozenset({"b", "bias", "scale", "step", "pos",
                                "zp", "neg_beta", "colsum"})
# Row-parallel projections: they consume model-sharded activations.
_ROW_PARALLEL_PARENTS = frozenset({"wo", "down", "out_proj"})
# Stacked per-expert weight banks from moe_init.
_MOE_EXPERT_LEAVES = frozenset({"w_gate", "w_up", "w_down"})
# serving_specs' widenings (module docstring)
_WHOLE_PARENTS = frozenset({"router", "w_dkv", "w_kr"})
_Q_HEAD_PARENTS = frozenset({"wq", "wo", "w_ukv"})
_KV_HEAD_PARENTS = frozenset({"wk", "wv"})


class P(tuple):
    """A partition spec: one entry a dim, None where the dim stays whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


class Blocked(P):
    """A spec whose ``"model"``-split dim holds ``blocks`` equal blocks side
    by side (Mamba1's ``in_proj``: x | z): a rank's piece is its piece of
    every block, in block order."""

    def __new__(cls, *axes, blocks: int = 2):
        spec = super().__new__(cls, *axes)
        spec.blocks = blocks
        return spec

    def __repr__(self) -> str:
        return (f"Blocked({', '.join(map(repr, self))}, "
                f"blocks={self.blocks})")


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis_name: size}, duck-typed so shape-only mesh stand-ins work."""
    return dict(zip(tuple(mesh.axis_names), tuple(mesh.devices.shape)))


def _batch_axes(mesh, batch_size: Optional[int] = None):
    """The mesh axes a batch dim is split over, degrading gracefully:
    ("pod", "data") jointly, then the widest single axis, as the
    reference's ladder. With no batch_size the ladder's head."""
    names = tuple(mesh.axis_names)
    present = tuple(a for a in ("pod", "data") if a in names)
    if not present:
        return None
    sizes = _axis_sizes(mesh)
    singles = sorted(((a,) for a in present),
                     key=lambda c: -sizes[c[0]])   # widest axis first
    ladder = ([present] if len(present) > 1 else []) + singles
    if batch_size is None:
        axes = ladder[0]
    else:
        axes = next((cand for cand in ladder
                     if batch_size % _axes_size(cand, sizes) == 0), None)
        if axes is None:
            return None
    return axes if len(axes) > 1 else axes[0]


def _axes_size(axes, sizes: Dict[str, int]) -> int:
    if axes is None:
        return 1
    if isinstance(axes, tuple):
        n = 1
        for a in axes:
            n *= sizes[a]
        return n
    return sizes[axes]


def _guarded(axes_per_dim, shape, sizes) -> P:
    """Apply the divisibility guard: drop any axis that does not divide."""
    out = []
    for dim, axes in enumerate(axes_per_dim):
        n = _axes_size(axes, sizes)
        out.append(axes if (axes is not None and n > 0
                            and shape[dim] % n == 0) else None)
    return P(*out)


def _owner(parts) -> str:
    """The projection that owns a leaf: its parent, or for an offline
    quantized leaf (``<proj>/q/<leaf>``) the projection above the ``q``."""
    parent = parts[-2] if len(parts) > 1 else ""
    if parent == "q" and len(parts) > 2:
        return parts[-3]
    return parent


def _match_spec(path: str, shape: Tuple[int, ...], mesh,
                moe_partition: str = "expert") -> P:
    """Rule table for a single parameter leaf. path: "/"-joined tree path,
    e.g. "layers/attn/wq/w"; returns a spec with len(shape) entries."""
    if moe_partition not in ("expert", "ffn"):
        raise ValueError(f"moe_partition must be 'expert' or 'ffn', "
                         f"got {moe_partition!r}")
    sizes = _axis_sizes(mesh)
    parts = [p for p in path.split("/") if p]
    leaf = parts[-1] if parts else ""
    # offline-quantized leaves (qw/neg_beta/colsum under a "q" subtree)
    # shard like the projection that owns them: wo/q/qw is row-parallel
    parent = _owner(parts)
    ndim = len(shape)
    axes: list = [None] * ndim

    if ndim <= 1 or leaf in _REPLICATED_LEAVES:
        return P(*axes)

    if leaf in _MOE_EXPERT_LEAVES and ndim >= 3:
        # (..., E, d_model, d_ff) for w_gate/w_up; (..., E, d_ff, d_model)
        # for w_down. Leading dims (layer stack) stay replicated.
        e, d_in, d_out = ndim - 3, ndim - 2, ndim - 1
        dm = d_in if leaf != "w_down" else d_out      # the d_model dim
        df = d_out if leaf != "w_down" else d_in      # the d_ff_expert dim
        if moe_partition == "expert":
            axes[e] = MODEL
            axes[dm] = "data"
        else:  # "ffn": TP inside every expert
            axes[df] = MODEL
            axes[dm] = "data"
    elif leaf == "table":
        # embedding (V, d): vocab over model => tied unembed is column-parallel
        axes[ndim - 2] = MODEL
        axes[ndim - 1] = "data"
    elif parent in _ROW_PARALLEL_PARENTS:
        axes[ndim - 2] = MODEL
        axes[ndim - 1] = "data"
    else:
        # generic column-parallel dense / conv / SSM weight
        axes[ndim - 2] = "data"
        axes[ndim - 1] = MODEL

    if MODEL in axes and MODEL not in sizes:
        axes = [None if a == MODEL else a for a in axes]
    if "data" in axes and "data" not in sizes:
        axes = [None if a == "data" else a for a in axes]
    return _guarded(axes, shape, sizes)


def _map_with_path(fn, tree, path=()):
    """``fn("a/b/c", leaf)`` over a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def param_specs(params: PyTree, mesh, moe_partition: str = "expert"
                ) -> PyTree:
    """Spec tree mirroring ``params`` (any leaves with a ``.shape``)."""
    return _map_with_path(
        lambda path, leaf: _match_spec(path, _shape(leaf), mesh,
                                       moe_partition), params)


def data_specs(batch: PyTree, mesh) -> PyTree:
    """Data-parallel input specs: dim 0 over ("pod",)"data", the rest
    replicated; scalars replicated; the guard applies."""
    sizes = _axis_sizes(mesh)

    def one(_, leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        baxes = _batch_axes(mesh, shape[0])
        return _guarded([baxes] + [None] * (len(shape) - 1), shape, sizes)

    return _map_with_path(one, batch)


def _cache_spec(path: str, shape, mesh, batch: int) -> P:
    sizes = _axis_sizes(mesh)
    ndim = len(shape)
    if ndim == 0:
        return P()
    axes: list = [None] * ndim
    parts = path.split("/")
    bdim = 2 if parts[0] == "hybrid_groups" else 1
    if not (bdim < ndim and shape[bdim] == batch):
        bdim = next((d for d in range(ndim) if shape[d] == batch), None)
    if bdim is not None:
        axes[bdim] = _batch_axes(mesh, batch)
    if parts[-1] in ("k", "v") and ndim >= 4:
        axes[ndim - 2] = MODEL if MODEL in sizes else None
    return _guarded(axes, shape, sizes)


def cache_specs(cache: PyTree, mesh, *, batch: int) -> PyTree:
    """Decode/prefill cache specs: the batch dim is data-parallel, found
    structurally (axis 1 of an (L, B, ...) leaf, axis 2 under
    "hybrid_groups"), with a size scan only as a fallback; K/V leaves
    shard the kv-head dim (second-to-last) over "model" when it divides."""
    return _map_with_path(
        lambda path, leaf: _cache_spec(path, _shape(leaf), mesh, batch),
        cache)


def serving_specs(params: PyTree, mesh, cfg, moe_partition: str = "expert"
                  ) -> PyTree:
    """:func:`param_specs` with the executor's widenings and the SSM cuts
    (module docstring): router and MLA latent projections whole, attention
    projections whole where their heads do not split into whole heads, and
    the Mamba mixers cut as their ranks read them."""
    tp = _axis_sizes(mesh).get(MODEL, 1)
    heads_split = cfg.n_heads % tp == 0
    kv_split = cfg.n_kv_heads % tp == 0

    def widen(path, leaf):
        shape = _shape(leaf)
        spec = _match_spec(path, shape, mesh, moe_partition)
        parts = [p for p in path.split("/") if p]
        if "ssm" in parts:
            return _ssm_spec(parts, shape, spec, cfg, tp)
        owner = _owner(parts)
        whole = (owner in _WHOLE_PARENTS
                 or (owner in _Q_HEAD_PARENTS and not heads_split)
                 or (owner in _KV_HEAD_PARENTS and not kv_split))
        return P(*[None] * len(spec)) if whole else spec

    return _map_with_path(widen, params)


def _ssm_splits(cfg, tp: int) -> bool:
    """Whether the Mamba mixers split over ``tp`` ranks: d_inner (Mamba1)
    or the heads (Mamba2, one B / C group, which every head reads) into
    equal pieces. Otherwise they stay whole."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    if s.version == 1:
        return di % tp == 0
    return s.n_groups == 1 and (di // s.head_dim) % tp == 0


def _ssm_spec(parts, shape, spec, cfg, tp: int) -> P:
    """A Mamba mixer leaf's serving spec (module docstring, the SSM cuts)."""
    ndim = len(shape)
    whole = P(*[None] * ndim)
    if tp == 1 or not _ssm_splits(cfg, tp):
        return whole
    owner = _owner(parts)
    leaf = parts[-1]
    if cfg.ssm.version == 1:
        if owner == "in_proj":       # x | z: each half split
            return Blocked(*spec[:-1], MODEL, blocks=2)
        if owner == "x_proj" and leaf in ("w", "qw"):
            return P(*[None] * (ndim - 2), MODEL, None)
        if leaf == "A_log":
            return P(*[None] * (ndim - 2), MODEL, None)
        return spec
    if owner == "bc_proj" or leaf == "conv_bc":
        return whole
    return spec


def serving_cache_specs(cache: PyTree, mesh, cfg, *, batch: int) -> PyTree:
    """:func:`cache_specs` with the SSM cuts: the streaming state of every
    Mamba layer on this rank's d_inner or heads, as its mixer reads it
    (Mamba1 ``conv`` (..., W-1, di) and ``ssm`` (..., di, N); Mamba2
    ``conv`` (..., W-1, di) and ``ssm`` (..., H, P, N), its ``conv_bc``
    whole); the attention K/V as :func:`cache_specs` cuts them."""
    tp = _axis_sizes(mesh).get(MODEL, 1)
    cut = cfg.ssm is not None and tp > 1 and _ssm_splits(cfg, tp)
    state_dim = -2 if cfg.ssm is not None and cfg.ssm.version == 1 else -3

    def one(path, leaf):
        spec = _cache_spec(path, _shape(leaf), mesh, batch)
        name = path.split("/")[-1]
        if not cut or name not in ("conv", "ssm"):
            return spec
        axes = list(spec)
        axes[-1 if name == "conv" else state_dim] = MODEL
        return P(*axes)

    return _map_with_path(one, cache)


def _piece(axes, mesh) -> Tuple[int, int]:
    """(this rank's index, number of pieces) of a dim split over ``axes``."""
    if axes is None:
        return 0, 1
    names = axes if isinstance(axes, tuple) else (axes,)
    idx, count = 0, 1
    for a in names:
        idx = idx * mesh.size(a) + mesh.index(a)
        count *= mesh.size(a)
    return idx, count


def shard_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's piece of ``t`` under ``spec``: a contiguous copy of the
    cut, or ``t`` itself where no dim splits. A :class:`Blocked` spec cuts
    each block of its ``"model"`` dim and joins the pieces."""
    out = t
    for dim, axes in enumerate(spec):
        idx, count = _piece(axes, mesh)
        if count == 1:
            continue
        names = axes if isinstance(axes, tuple) else (axes,)
        blocks = getattr(spec, "blocks", 1) if MODEL in names else 1
        size = t.shape[dim] // blocks
        n = size // count
        out = torch.cat([out.narrow(dim, j * size + idx * n, n)
                         for j in range(blocks)], dim) if blocks > 1 \
            else out.narrow(dim, idx * n, n)
    return out if out is t else out.contiguous()


def _rebuild(node, items: list):
    """A list or tuple like ``node`` (a NamedTuple too) of ``items``."""
    return type(node)(*items) if hasattr(node, "_fields") \
        else type(node)(items)


def shard_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """The rank's local pieces of every leaf (the reference's ``to_named``
    + ``device_put``): each a contiguous tensor, or the leaf itself where
    its spec splits nothing."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [shard_tree(v, s, mesh)
                               for v, s in zip(tree, specs)])
    if isinstance(tree, torch.Tensor):
        return shard_leaf(tree, specs, mesh)
    return tree


def train_specs(params: PyTree, mesh, cfg,
                moe_partition: Optional[str] = None) -> PyTree:
    """The training cut (module docstring): :func:`serving_specs`'
    ``"model"`` entries, and :func:`param_specs`' ``"data"`` entry where
    its dim is not cut over ``"model"``. ``moe_partition`` defaults to the
    config's."""
    if moe_partition is None:
        moe_partition = cfg.moe.partition if cfg.moe else "expert"
    serve = serving_specs(params, mesh, cfg, moe_partition)
    ref = param_specs(params, mesh, moe_partition)

    def join(s, r):
        if isinstance(s, dict):
            return {k: join(s[k], r[k]) for k in s}
        if isinstance(s, (list, tuple)) and not isinstance(s, P):
            return type(s)(join(a, b) for a, b in zip(s, r))
        axes = [a if a == MODEL else (DATA if b == DATA else None)
                for a, b in zip(s, r)]
        return (Blocked(*axes, blocks=s.blocks) if isinstance(s, Blocked)
                else P(*axes))

    return join(serve, ref)


def _dim_of(spec, axis: str) -> Optional[int]:
    """The dim of ``spec`` cut over ``axis`` (alone or in a tuple)."""
    for d, axes in enumerate(spec):
        if axes == axis or (isinstance(axes, tuple) and axis in axes):
            return d
    return None


def own_pieces(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """:func:`shard_tree`, each piece in storage of its own: a leaf the
    specs keep whole, or a cut that is a view of it, is copied. Training
    updates the pieces in place and leaves ``tree`` as it was, and ``tree``
    may be freed."""
    def fresh(piece, whole):
        if isinstance(piece, dict):
            return {k: fresh(v, whole[k]) for k, v in piece.items()}
        if isinstance(piece, (list, tuple)):
            return _rebuild(piece, [fresh(a, b)
                                    for a, b in zip(piece, whole)])
        if not isinstance(piece, torch.Tensor):
            return piece
        same = (piece.untyped_storage().data_ptr()
                == whole.untyped_storage().data_ptr())
        return piece.clone() if same else piece

    return fresh(shard_tree(tree, specs, mesh), tree)


def gather_data(tree: PyTree, specs: PyTree) -> PyTree:
    """The ambient mesh's ``"model"`` pieces of a tree of ``"data"``
    pieces (:func:`context.gather_leaf` a leaf, in the tree's order): the
    backward reduce-scatters each gradient to its piece, and sums that of
    a leaf held whole over the ``"data"`` ranks."""
    if isinstance(tree, dict):
        return {k: gather_data(v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [gather_data(v, s)
                               for v, s in zip(tree, specs)])
    if isinstance(tree, torch.Tensor):
        return dctx.gather_leaf(tree, _dim_of(specs, DATA))
    return tree


def unshard_leaf(t: torch.Tensor, spec) -> torch.Tensor:
    """The whole leaf from this rank's piece under ``spec`` on the ambient
    mesh: each cut dim gathered over its axes (a :class:`Blocked` dim block
    by block). Every rank of the mesh takes part."""
    out = t
    for dim, axes in enumerate(spec):
        if axes is None or dctx.axis_size(axes) == 1:
            continue
        names = axes if isinstance(axes, tuple) else (axes,)
        blocks = getattr(spec, "blocks", 1) if MODEL in names else 1
        whole = dctx.all_gather(out, dim, axes)
        if blocks > 1:           # (count, blocks, n) -> (blocks, count, n)
            count = dctx.axis_size(axes)
            shp = list(whole.shape)
            n = shp[dim] // (count * blocks)
            whole = whole.reshape(*shp[:dim], count, blocks, n,
                                  *shp[dim + 1:]).transpose(
                dim, dim + 1).reshape(shp)
        out = whole
    return out


def unshard_tree(tree: PyTree, specs: PyTree) -> PyTree:
    """:func:`unshard_leaf` over a tree, in its order."""
    if isinstance(tree, dict):
        return {k: unshard_tree(v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [unshard_tree(v, s)
                               for v, s in zip(tree, specs)])
    if isinstance(tree, torch.Tensor):
        return unshard_leaf(tree, specs)
    return tree


def tree_leaves_of_specs(specs: PyTree) -> list:
    """A spec tree's specs in the order of its tree's leaves
    (``optim.adamw.tree_leaves``: a dict by sorted keys; a spec is a
    tuple, not a node)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs)
                for x in tree_leaves_of_specs(specs[k])]
    if isinstance(specs, (list, tuple)) and not isinstance(specs, P):
        return [x for t in specs for x in tree_leaves_of_specs(t)]
    return [specs]


class Shardings(NamedTuple):
    """A spec tree and the mesh it cuts over: the port's counterpart of a
    tree of ``NamedSharding`` (``CheckpointManager.restore(shardings=)``)."""
    specs: PyTree
    mesh: Any
