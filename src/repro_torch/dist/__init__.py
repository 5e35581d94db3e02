"""Distribution layer: the mesh and its context, the collectives of tensor
parallelism, and the sharding rule engine. Counterpart of ``repro.dist``.

``repro_torch.dist.context`` carries the ambient :class:`Mesh` (one process
a rank, ``torch.distributed``) so model code can reduce its partial results
without threading the mesh through every call; ``repro_torch.dist.sharding``
turns parameter / batch / cache trees into spec trees via the reference's
name/shape rule table with hard divisibility guards, and cuts a tree into
this rank's pieces (``shard_tree``, the reference's ``to_named``).
"""
from repro_torch.dist.context import (  # noqa: F401
    Mesh, get_mesh, make_host_mesh, make_mesh, mesh_context)
from repro_torch.dist.sharding import (  # noqa: F401
    Blocked, P, cache_specs, data_specs, param_specs, serving_cache_specs,
    serving_specs, shard_tree)
