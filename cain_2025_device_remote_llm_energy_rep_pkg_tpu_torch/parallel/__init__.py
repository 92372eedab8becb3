"""Parallelism: device meshes, sharding rules, the sharded engine.

Counterpart of the JAX package's ``parallel/``: ``mesh.py`` (named grids
of ``torch.device``s), ``sharding.py`` (the head-aligned leaf rules and
``shard_model``), ``tp.py`` (``TensorParallelEngine``: tensor, data and
expert parallelism driven from one process), ``ring.py`` (ring attention
over ``sp``), ``distributed.py`` (the multi-host process group) and
``roofline.py`` (the decode roofline that bills the study's aliased
``remote`` rows as an 8-GPU NVLink node). Pipeline parallelism and
sharded training (the JAX package's ``pp.py`` and ``train.py``) are not
ported yet.
"""

from .mesh import Mesh, MeshSpec, build_mesh
from .sharding import param_specs, plan_for, shard_model

__all__ = ["Mesh", "MeshSpec", "build_mesh", "param_specs", "plan_for", "shard_model"]
