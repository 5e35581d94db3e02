"""The mesh, the process-global mesh context and the collectives of tensor
parallelism. Counterpart of ``repro/dist/context.py`` (the context) and of
the mesh builders of ``repro/launch/mesh.py``.

The reference's mesh is a ``jax.sharding.Mesh`` over devices, and GSPMD
inserts the collectives its sharding needs. The port runs one process a
rank (``torch.distributed``): a :class:`Mesh` names the axes, carries their
shape as ``mesh.devices.shape`` (an array of rank numbers, so the copied
rule table in :mod:`repro_torch.dist.sharding` reads it unchanged), the
process group and this rank's coordinate on every axis. Model code reads
the ambient mesh (:func:`get_mesh`) and reduces its partial results with
:func:`all_sum`, :func:`all_max` and :func:`all_gather` over the
``"model"`` axis. Without a mesh, or on a mesh whose ``"model"`` axis has
one rank, they return their input.

Every collective is an ``all_reduce``. PyTorch's gloo backend takes CUDA
tensors only for ``broadcast`` and ``all_reduce``, so one code path runs
under gloo (ranks sharing one card, or the CPU) and under nccl alike. A
gather is the sum of a zero-filled buffer into which each rank wrote its
own piece: exact, since each element has one nonzero term. 16-bit floats
are reduced in f32 (a sum of bf16 partials rounded once, as a single
device rounds its f32 accumulator once).

Nesting is supported (a stack): the innermost context wins.

:func:`record_collectives` records each collective a rank issues (kind,
bytes, group size). In a costing trace (``repro_torch.launch.costs``) a
shape-only mesh reduces meta tensors without a process group: the result
has the right shape and the record is one rank's prediction. Outside a
trace a shape-only mesh raises, as it always did.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import compat

Tensor = torch.Tensor

MODEL = "model"


class Mesh:
    """A named grid of ranks. ``devices`` is an int array of rank numbers
    in the mesh's shape (its ``.shape`` is what the rule table reads),
    ``group`` the process group of the ``"model"`` axis (None: a shape-only
    mesh, which has no collectives), ``coords`` this rank's index on each
    axis."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: int = 0, group=None, connected: bool = False):
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != len(tuple(shape)):
            raise ValueError(f"mesh shape {tuple(shape)} does not match "
                             f"axes {self.axis_names}")
        self.devices = np.arange(int(np.prod(shape))).reshape(tuple(shape))
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names,
            (int(c) for c in np.unravel_index(rank, self.devices.shape))))
        self.group = group
        self.connected = connected

    def size(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.devices.shape)).get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def __repr__(self) -> str:
        shape = dict(zip(self.axis_names, self.devices.shape))
        return f"Mesh({shape}, coords={self.coords})"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              group=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``. In a process group of exactly
    ``prod(shape)`` ranks (``torch.distributed`` initialised) the mesh is
    connected: this rank's coordinate is its rank's, and the collectives run
    over ``group`` (default: the whole world). Only the ``"model"`` axis
    reduces, so every other axis must have one rank (data-parallel serving
    is a later slice). Otherwise a shape-only mesh, as the reference's rule
    tests use: rank 0's coordinate, no collectives."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if dist.is_available() and dist.is_initialized() and (
            dist.get_world_size(group) == n):
        others = [s for a, s in zip(axes, shape) if a != MODEL]
        if any(s != 1 for s in others):
            raise NotImplementedError(
                f"a connected mesh reduces over its 'model' axis only; got "
                f"shape {shape} over {tuple(axes)}: data-parallel serving "
                f"is ROADMAP queue 1 item 15")
        return Mesh(shape, axes, rank=dist.get_rank(group), group=group,
                    connected=True)
    return Mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """The one-rank ("data", "model") mesh."""
    return make_mesh((1, 1), ("data", "model"))


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


def tp_size() -> int:
    """Ranks on the ambient mesh's ``"model"`` axis (1 without a mesh)."""
    mesh = get_mesh()
    return 1 if mesh is None else mesh.size(MODEL)


def tp_rank() -> int:
    """This rank's index on the ambient ``"model"`` axis (0 without one)."""
    mesh = get_mesh()
    return 0 if mesh is None else mesh.index(MODEL)


def local_slice(t: Tensor, n_local: int, dim: int = -1) -> Tensor:
    """This rank's ``n_local``-wide piece of a leaf that a column-parallel
    layer reads whole (a per-channel scale, bias or zero point the rule
    table replicates): ``t`` itself when it already is that wide."""
    n = t.shape[dim]
    if n == n_local:
        return t
    if n != n_local * tp_size():
        raise ValueError(f"a leaf of width {n} does not split into "
                         f"{tp_size()} pieces of {n_local}")
    return t.narrow(dim, tp_rank() * n_local, n_local)


_recorders: list = []


@contextlib.contextmanager
def record_collectives() -> Iterator[list]:
    """Record every collective issued in the block as ``(kind, bytes,
    group size)`` in the list it yields: what a connected rank sends, or,
    in a costing trace on a shape-only mesh, what one rank would send
    (``repro_torch.launch.roofline.collective_stats`` reads them)."""
    records: list = []
    _recorders.append(records)
    try:
        yield records
    finally:
        _recorders.remove(records)


def _reducing_mesh(t: Tensor):
    mesh = get_mesh()
    if mesh is None or mesh.size(MODEL) == 1:
        return None
    if not mesh.connected and not (t.device.type == "meta"
                                   and compat.in_trace()):
        raise RuntimeError(f"{mesh} is shape-only: no process group to "
                           f"reduce over")
    return mesh


def _all_reduce(t: Tensor, op) -> Tensor:
    mesh = _reducing_mesh(t)
    if mesh is None:
        return t
    wide = t.dtype in (torch.bfloat16, torch.float16)
    buf = t.to(torch.float32) if wide else t.contiguous()
    for records in _recorders:
        records.append(("all-reduce", float(buf.numel() * buf.element_size()),
                        mesh.size(MODEL)))
    if mesh.connected:
        dist.all_reduce(buf, op=op, group=mesh.group)
    return buf.to(t.dtype) if wide else buf


def all_sum(t: Tensor) -> Tensor:
    """Sum of ``t`` over the ``"model"`` ranks (each rank gets the same
    bits). A contiguous input of a reduction dtype is reduced in place."""
    return _all_reduce(t, dist.ReduceOp.SUM)


def all_max(t: Tensor) -> Tensor:
    """Elementwise max of ``t`` over the ``"model"`` ranks."""
    return _all_reduce(t, dist.ReduceOp.MAX)


def all_gather(t: Tensor, dim: int) -> Tensor:
    """The ranks' pieces of ``t`` concatenated along ``dim`` in rank order:
    a zero-filled buffer holding this rank's piece, summed."""
    mesh = _reducing_mesh(t)
    if mesh is None:
        return t
    dim = dim % t.dim()
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * mesh.size(MODEL)
    buf = torch.zeros(shape, dtype=t.dtype, device=t.device)
    buf.narrow(dim, mesh.index(MODEL) * n, n).copy_(t)
    return all_sum(buf)

