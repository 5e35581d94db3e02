"""The mesh, the process-global mesh context and the collectives of data and
tensor parallelism. Counterpart of ``repro/dist/context.py`` (the context)
and of the mesh builders of ``repro/launch/mesh.py``.

The reference's mesh is a ``jax.sharding.Mesh`` over devices, and GSPMD
inserts the collectives its sharding needs, forward and backward. The port
runs one process a rank (``torch.distributed``): a :class:`Mesh` names the
axes, carries their shape as ``mesh.devices.shape`` (an array of rank
numbers, so the copied rule table in :mod:`repro_torch.dist.sharding` reads
it unchanged), one process group a line of ranks along each axis and this
rank's coordinate on every axis. Model code reads the ambient mesh
(:func:`get_mesh`) and reduces its partial results with :func:`all_sum`,
:func:`all_max` and :func:`all_gather` over an axis (``"model"`` unless it
names another). Without a mesh, or on an axis of one rank, they return
their input.

Every collective is an ``all_reduce``. PyTorch's gloo backend takes CUDA
tensors only for ``broadcast`` and ``all_reduce``, so one code path runs
under gloo (ranks sharing one card, or the CPU) and under nccl alike. A
sum of 16-bit floats is reduced in f32 (a sum of bf16 partials rounded
once, as a single device rounds its f32 accumulator once). A gather is the
sum of a zero-filled buffer into which each rank wrote its own piece, its
bytes summed as integers: exact in any dtype (each element has one nonzero
term, so no carry crosses it), at the tensor's own width.

Gradients (Megatron's scheme). Every rank's gradient of a tensor that all
ranks of an axis hold alike is complete and the same, and a piece's
gradient is that piece's. :func:`all_sum` reduces into such a replicated
value, so its backward is the identity; :func:`sum_grad` is the identity
forward and sums the gradient over the axis, and goes wherever a
replicated tensor feeds one rank's own computation (a column-parallel
layer's input, the sharded norm's sum of squares, :func:`local_slice`'s
whole leaf); :func:`all_gather`'s backward keeps the rank's slice.
:func:`gather_leaf` joins a parameter's ``"data"`` pieces for the forward
(ZeRO), and its backward reduce-scatters the gradient back to the piece.
Each rank builds the same autograd graph, so the backward issues the
collectives in the same order on every rank, also where a rematerialised
layer replays its forward's.

Nesting is supported (a stack): the innermost context wins.

:func:`record_collectives` records each collective a rank issues (kind,
bytes, group size), backward included. In a costing trace
(``repro_torch.launch.costs``) a shape-only mesh reduces meta tensors
without a process group: the result has the right shape and the record is
one rank's prediction. Outside a trace a shape-only mesh raises, as it
always did.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import compat

Tensor = torch.Tensor

MODEL = "model"
DATA = "data"
# the axes a batch is cut over (data_specs' ladder), where present
BATCH_AXES = ("pod", DATA)

Axes = Union[str, Tuple[str, ...]]


class Mesh:
    """A named grid of ranks. ``devices`` is an int array of rank numbers
    in the mesh's shape (its ``.shape`` is what the rule table reads),
    ``groups`` the process group of this rank's line along each axis of
    more than one rank (none on a shape-only mesh, which has no
    collectives), ``world`` the group of all its ranks, ``coords`` this
    rank's index on each axis."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: int = 0, groups: Optional[Dict[str, object]] = None,
                 world=None, connected: bool = False):
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != len(tuple(shape)):
            raise ValueError(f"mesh shape {tuple(shape)} does not match "
                             f"axes {self.axis_names}")
        self.devices = np.arange(int(np.prod(shape))).reshape(tuple(shape))
        self.rank = rank
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names,
            (int(c) for c in np.unravel_index(rank, self.devices.shape))))
        self.groups = dict(groups or {})
        self.world = world
        self.connected = connected

    def size(self, axis: Axes) -> int:
        sizes = dict(zip(self.axis_names, self.devices.shape))
        n = 1
        for a in _names(axis):
            n *= sizes.get(a, 1)
        return n

    def index(self, axis: Axes) -> int:
        """This rank's index along ``axis`` (a tuple: the first axis major,
        as the rule table's pieces count)."""
        idx = 0
        for a in _names(axis):
            idx = idx * self.size(a) + self.coords.get(a, 0)
        return idx

    def __repr__(self) -> str:
        shape = dict(zip(self.axis_names, self.devices.shape))
        return f"Mesh({shape}, coords={self.coords})"


def _names(axis: Axes) -> Tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, group=None,
              connect: bool = True) -> Mesh:
    """A mesh of ``shape`` over ``axes``. In a process group of exactly
    ``prod(shape)`` ranks (``torch.distributed`` initialised; ``group``,
    default the whole world) the mesh is connected, unless ``connect`` is
    False: this rank's coordinate is its rank's, and each axis of more
    than one rank gets one process group a line of ranks along it (every
    rank creates every line's group, in the same order; an axis that spans
    all ranks reuses ``group``). Otherwise a shape-only mesh, as the
    reference's rule tests and the costing traces use: rank 0's
    coordinate, no collectives."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    n = int(np.prod(shape))
    if not (connect and dist.is_available() and dist.is_initialized()
            and dist.get_world_size(group) == n):
        return Mesh(shape, axes)
    world_ranks = [r if group is None else dist.get_global_rank(group, r)
                   for r in range(n)]
    grid = np.arange(n).reshape(shape)
    groups = {}
    for i, (axis, size) in enumerate(zip(axes, shape)):
        if size == 1:
            continue
        if size == n:
            groups[axis] = group
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, size)
        rank = dist.get_rank(group)
        for line in lines:
            g = dist.new_group([world_ranks[int(r)] for r in line])
            if rank in line:
                groups[axis] = g
    return Mesh(shape, axes, rank=dist.get_rank(group), groups=groups,
                world=group, connected=True)


def make_host_mesh() -> Mesh:
    """The one-rank ("data", "model") mesh."""
    return make_mesh((1, 1), (DATA, MODEL))


_state = threading.local()


def _stack() -> list:
    if not hasattr(_state, "meshes"):
        _state.meshes = []
    return _state.meshes


@contextlib.contextmanager
def mesh_context(mesh) -> Iterator:
    """Make ``mesh`` the ambient mesh for the dynamic extent of the block."""
    stack = _stack()
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def get_mesh():
    """The innermost active mesh, or None outside any mesh_context."""
    stack = _stack()
    return stack[-1] if stack else None


def axis_size(axis: Axes = MODEL) -> int:
    """Ranks on the ambient mesh's ``axis`` (1 without a mesh)."""
    mesh = get_mesh()
    return 1 if mesh is None else mesh.size(axis)


def axis_index(axis: Axes = MODEL) -> int:
    """This rank's index on the ambient mesh's ``axis`` (0 without one)."""
    mesh = get_mesh()
    return 0 if mesh is None else mesh.index(axis)


def batch_axes() -> Tuple[str, ...]:
    """The ambient mesh's axes that cut a batch: ``("pod", "data")``, those
    it has (none without a mesh)."""
    mesh = get_mesh()
    return () if mesh is None else tuple(
        a for a in BATCH_AXES if a in mesh.axis_names)


def tp_size() -> int:
    """Ranks on the ambient mesh's ``"model"`` axis (1 without a mesh)."""
    return axis_size(MODEL)


def tp_rank() -> int:
    """This rank's index on the ambient ``"model"`` axis (0 without one)."""
    return axis_index(MODEL)


def local_slice(t: Tensor, n_local: int, dim: int = -1) -> Tensor:
    """This rank's ``n_local``-wide piece of a leaf that a column-parallel
    layer reads whole (a per-channel scale, bias or zero point the rule
    table replicates): ``t`` itself when it already is that wide. The whole
    leaf's gradient is summed over the ranks (:func:`sum_grad`)."""
    n = t.shape[dim]
    if n == n_local:
        return t
    if n != n_local * tp_size():
        raise ValueError(f"a leaf of width {n} does not split into "
                         f"{tp_size()} pieces of {n_local}")
    return sum_grad(t).narrow(dim, tp_rank() * n_local, n_local)


_recorders: list = []


@contextlib.contextmanager
def record_collectives() -> Iterator[list]:
    """Record every collective issued in the block as ``(kind, bytes,
    group size)`` in the list it yields: what a connected rank sends, or,
    in a costing trace on a shape-only mesh, what one rank would send
    (``repro_torch.launch.roofline.collective_stats`` reads them). A
    backward's collectives are recorded too."""
    records: list = []
    _recorders.append(records)
    try:
        yield records
    finally:
        _recorders.remove(records)


def _reducing_mesh(t: Tensor, axis: Axes, mesh=None):
    """The mesh ``t`` is reduced on along ``axis`` (the ambient one unless
    given: a backward may run on another thread than its forward, so the
    autograd Functions keep their forward's mesh), or None where nothing
    is reduced."""
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None or mesh.size(axis) == 1:
        return None
    if not mesh.connected and not (t.device.type == "meta"
                                   and compat.in_trace()):
        raise RuntimeError(f"{mesh} is shape-only: no process group to "
                           f"reduce over")
    return mesh


def _reduce_(mesh: Mesh, buf: Tensor, op, axis: Axes) -> Tensor:
    """All-reduce ``buf`` in place over each of ``axis``' lines of ranks."""
    for a in _names(axis):
        if mesh.size(a) == 1:
            continue
        for records in _recorders:
            records.append(("all-reduce",
                            float(buf.numel() * buf.element_size()),
                            mesh.size(a)))
        if mesh.connected:
            dist.all_reduce(buf, op=op, group=mesh.groups[a])
    return buf


def _all_reduce(t: Tensor, op, axis: Axes, copy: bool, mesh=None) -> Tensor:
    mesh = _reducing_mesh(t, axis, mesh)
    if mesh is None:
        return t
    wide = t.dtype in (torch.bfloat16, torch.float16)
    if wide:
        buf = t.to(torch.float32)
    else:
        buf = t.clone(memory_format=torch.contiguous_format) if copy \
            else t.contiguous()
    _reduce_(mesh, buf, op, axis)
    return buf.to(t.dtype) if wide else buf


def _bits(t: Tensor) -> Tensor:
    """``t``'s bytes as the widest integers that tile them (a view)."""
    flat = t.reshape(-1)
    if t.dtype == torch.bool:
        flat = flat.view(torch.uint8)
    if t.element_size() == 8:
        return flat.view(torch.int64)
    if (t.numel() * t.element_size()) % 4 == 0:
        return flat.view(torch.int32)
    return flat.view(torch.uint8)


def _gather(t: Tensor, dim: int, axis: Axes, mesh=None) -> Tensor:
    mesh = _reducing_mesh(t, axis, mesh)
    if mesh is None:
        return t
    dim = dim % t.dim()
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * mesh.size(axis)
    buf = torch.zeros(shape, dtype=t.dtype, device=t.device)
    buf.narrow(dim, mesh.index(axis) * n, n).copy_(t)
    _reduce_(mesh, _bits(buf), dist.ReduceOp.SUM, axis)
    return buf


def _own(t: Tensor, dim: int, n: int, axis: Axes, mesh) -> Tensor:
    idx = 0 if mesh is None else mesh.index(axis)
    return t.narrow(dim, idx * n, n).contiguous()


class _Sum(torch.autograd.Function):
    """All-reduce sum into a replicated value: the backward is the
    identity."""

    @staticmethod
    def forward(ctx, t, axis, mesh):
        return _all_reduce(t, dist.ReduceOp.SUM, axis, True, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    """The identity whose backward sums the gradient over the axis."""

    @staticmethod
    def forward(ctx, t, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, dist.ReduceOp.SUM, ctx.axis, True, ctx.mesh),
                None, None)


class _Gather(torch.autograd.Function):
    """The ranks' pieces joined: the backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, t, dim, axis, mesh):
        ctx.dim, ctx.n, ctx.axis, ctx.mesh = (dim % t.dim(), t.shape[dim],
                                              axis, mesh)
        return _gather(t, dim, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.dim, ctx.n, ctx.axis, ctx.mesh), None, None, None


class _GatherLeaf(torch.autograd.Function):
    """A parameter's pieces along ``axis`` joined for the forward (``dim``
    None: a leaf held whole, the identity); the backward sums the
    gradients over ``grad_axes`` and keeps this rank's piece
    (reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, dim, axis, grad_axes, mesh):
        ctx.dim, ctx.axis, ctx.grad_axes, ctx.mesh = dim, axis, grad_axes, \
            mesh
        if dim is None:
            return t.view_as(t)
        ctx.n = t.shape[dim]
        return _gather(t, dim, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        s = _all_reduce(g, dist.ReduceOp.SUM, ctx.grad_axes, True, ctx.mesh)
        if ctx.dim is not None:
            s = _own(s, ctx.dim, ctx.n, ctx.axis, ctx.mesh)
        return s, None, None, None, None


def _grad_path(t: Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def all_sum(t: Tensor, axis: Axes = MODEL) -> Tensor:
    """Sum of ``t`` over ``axis``' ranks (each rank gets the same bits).
    Without autograd a contiguous input of a reduction dtype is reduced in
    place; with it the backward is the identity."""
    if _grad_path(t) and _reducing_mesh(t, axis) is not None:
        return _Sum.apply(t, axis, get_mesh())
    return _all_reduce(t, dist.ReduceOp.SUM, axis, copy=False)


def all_max(t: Tensor, axis: Axes = MODEL) -> Tensor:
    """Elementwise max of ``t`` over ``axis``' ranks (no gradient: the
    int8 path's scales)."""
    return _all_reduce(t.detach(), dist.ReduceOp.MAX, axis, copy=False)


def all_gather(t: Tensor, dim: int, axis: Axes = MODEL) -> Tensor:
    """The ranks' pieces of ``t`` concatenated along ``dim`` in rank order:
    a zero-filled buffer holding this rank's piece, its bytes summed as
    integers. The backward keeps this rank's slice."""
    if _grad_path(t) and _reducing_mesh(t, axis) is not None:
        return _Gather.apply(t, dim, axis, get_mesh())
    return _gather(t, dim, axis)


def sum_grad(t: Tensor, axis: Axes = MODEL) -> Tensor:
    """``t`` itself; its gradient summed over ``axis``' ranks. Where a
    tensor that every rank holds alike feeds one rank's own computation,
    each rank's gradient of it is partial."""
    if not _grad_path(t) or _reducing_mesh(t, axis) is None:
        return t
    return _SumGrad.apply(t, axis, get_mesh())


def gather_leaf(t: Tensor, dim: Optional[int]) -> Tensor:
    """A parameter's whole along ``"data"`` from this rank's piece (cut
    along ``dim``; None: held whole, returned as it is). Its gradient is the
    sum over the batch axes' ranks (each saw its own rows), this rank's
    piece kept (ZeRO's reduce-scatter)."""
    grad_axes = batch_axes()
    mesh = _reducing_mesh(t, grad_axes)
    if mesh is None:
        return t
    if _grad_path(t):
        return _GatherLeaf.apply(t, dim, DATA, grad_axes, mesh)
    return t if dim is None else _gather(t, dim, DATA, mesh)
