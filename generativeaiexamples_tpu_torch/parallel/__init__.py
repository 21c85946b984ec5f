"""Parallel layers of the port. One card so far: the sparse
mixture-of-experts layer (``moe.py``); the mesh, sharding and
expert-parallel parts wait for the multi-GPU slice."""

from .moe import expert_capacity, route_topk, sparse_moe_ffn

__all__ = ["expert_capacity", "route_topk", "sparse_moe_ffn"]
