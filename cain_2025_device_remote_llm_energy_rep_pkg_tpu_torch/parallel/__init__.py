"""Parallelism: device meshes, sharding rules, the sharded engine and
sharded training.

Counterpart of the JAX package's ``parallel/``: ``mesh.py`` (named grids
of ``torch.device``s), ``sharding.py`` (the head-aligned leaf rules and
``shard_model``), ``tp.py`` (``TensorParallelEngine``: tensor, data and
expert parallelism driven from one process), ``train.py`` (the dp × tp
train step over the same shards, Adam as optax's), ``pp.py`` (the GPipe
pipeline over a ``pp`` axis: loss, gradients and train step),
``ring.py`` (ring attention over ``sp``), ``distributed.py`` (the
multi-host process group) and ``roofline.py`` (the decode roofline that
bills the study's aliased ``remote`` rows as an 8-GPU NVLink node).
"""

from .mesh import Mesh, MeshSpec, build_mesh
from .pp import make_pp_grad, make_pp_loss, make_pp_train_step, pp_param_specs
from .sharding import param_specs, plan_for, shard_model

__all__ = [
    "Mesh",
    "MeshSpec",
    "build_mesh",
    "param_specs",
    "plan_for",
    "shard_model",
    "make_pp_grad",
    "make_pp_loss",
    "make_pp_train_step",
    "pp_param_specs",
]
