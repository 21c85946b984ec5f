"""Parallel layers of the port: the sparse mixture-of-experts layer
(``moe.py``) and tensor-parallel serving, one process per card: the mesh
(``mesh.py``), the sharding rules (``sharding.py``) and the collectives
(``comm.py``). Expert, sequence and pipeline parallelism are not ported
yet (ROADMAP A12)."""

from .mesh import AXES, Mesh, MeshPlan, make_mesh, maybe_init_distributed
from .moe import expert_capacity, route_topk, sparse_moe_ffn
from .sharding import llama_param_specs, shard_params

__all__ = ["AXES", "Mesh", "MeshPlan", "expert_capacity",
           "llama_param_specs", "make_mesh", "maybe_init_distributed",
           "route_topk", "shard_params", "sparse_moe_ffn"]
