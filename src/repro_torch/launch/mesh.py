"""Production meshes, counterpart of ``repro/launch/mesh.py``. Functions
only: importing this module touches no device and no process group."""
from __future__ import annotations

from repro_torch.dist.context import Mesh, make_host_mesh, make_mesh

__all__ = ["make_production_mesh", "make_mesh", "make_host_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 cards a pod; 2 pods = 512 multi-pod. Shape-only unless
    a process group of that many ranks is initialised."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)
