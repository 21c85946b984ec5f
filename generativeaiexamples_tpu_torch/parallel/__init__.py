"""Parallel layers of the port: the sparse mixture-of-experts layer and
its expert-parallel form (``moe.py``), ring attention over the sequence
(``ring_attention.py``) and serving over a mesh, one process per card:
the mesh and its groups (``mesh.py``), the sharding rules
(``sharding.py``) and the collectives (``comm.py``). Pipeline parallelism
and training over a mesh are not ported yet (ROADMAP A12)."""

from .mesh import AXES, Mesh, MeshPlan, make_mesh, maybe_init_distributed
from .moe import (ep_expert_ffn, ep_sparse_moe_ffn, expert_capacity,
                  route_topk, sparse_moe_ffn)
from .ring_attention import ring_gqa_attention
from .sharding import llama_param_specs, shard_params

__all__ = ["AXES", "Mesh", "MeshPlan", "ep_expert_ffn", "ep_sparse_moe_ffn",
           "expert_capacity", "llama_param_specs", "make_mesh",
           "maybe_init_distributed", "ring_gqa_attention", "route_topk",
           "shard_params", "sparse_moe_ffn"]
