"""Collectives of tensor-parallel serving.

The reference has no module of this name: its ``psum`` and
``all_gather`` run inside ``shard_map`` bodies and GSPMD inserts the
rest, all XLA collectives over ICI. On Hopper the same exchanges are NCCL
collectives issued from outside the kernels (``torch.distributed``; gloo
on the CPU), over the tensor-parallel group of a ``parallel.mesh.Mesh``:

- ``all_reduce_`` sums a tensor over the group in place (after a
  row-parallel product, the vocab-sharded embedding, an MoE combine);
- ``all_gather`` stacks each rank's tensor into a ``(n_shards, ...)``
  tensor (the sampler's carries, the materialized tail's logit shards);
- ``broadcast_header`` / ``receive_header``: the serving leader's round
  headers to its followers, and ``gather_to_leader`` their replies, on
  the host-only gloo group.

The first two enqueue on the current stream without a host read, so a
CUDA graph can capture them (the communicator must exist first:
``warm_up``). Each is a no-op at tp = 1 or without a mesh.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh


def sharded(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` splits work over more than one rank's tp group."""
    return mesh is not None and mesh.tp > 1 and mesh.tp_group is not None


def all_reduce_(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum ``t`` over the tp group, in place; returns ``t``."""
    if sharded(mesh):
        dist.all_reduce(t, group=mesh.tp_group)
    return t


def all_gather(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``(n_shards, *t.shape)``: every rank's ``t`` in rank order (the
    reference's ``jax.lax.all_gather`` over the axis). Without a mesh,
    ``t[None]``."""
    if not sharded(mesh):
        return t[None]
    t = t.contiguous()
    # One flat buffer, rank-major: the layout both NCCL and gloo fill.
    out = t.new_empty((mesh.tp * t.shape[0], *t.shape[1:]) if t.dim()
                      else (mesh.tp,))
    dist.all_gather_into_tensor(out, t if t.dim() else t[None],
                                group=mesh.tp_group)
    return out.view(mesh.tp, *t.shape)


def warm_up(mesh: Optional[Mesh], device: torch.device) -> None:
    """One eager all-reduce on each group, so that NCCL's communicator
    exists before a CUDA graph captures a collective on it."""
    if sharded(mesh):
        probe = torch.ones((1,), device=device)
        dist.all_reduce(probe, group=mesh.tp_group)
        if probe.item() != mesh.tp:
            raise RuntimeError(f"all-reduce over {mesh.tp} ranks gave "
                               f"{probe.item()}")


def broadcast_header(header: Any, mesh: Mesh) -> None:
    """The leader's header to every follower of its group (pickled, over
    the gloo header group: host to host, never behind the card's
    queue)."""
    dist.broadcast_object_list([header], src=_leader_rank(mesh),
                               group=mesh.header_group)


def receive_header(mesh: Mesh) -> Any:
    """A follower's next header from its leader (blocks until one
    comes; raises when the leader's connection closes)."""
    box = [None]
    dist.broadcast_object_list(box, src=_leader_rank(mesh),
                               group=mesh.header_group)
    return box[0]


def gather_to_leader(obj: Any, mesh: Mesh) -> Optional[list]:
    """Every rank's ``obj`` in rank order on the leader (None
    elsewhere), over the header group."""
    out = [None] * mesh.tp if mesh.leader else None
    dist.gather_object(obj, out, dst=_leader_rank(mesh),
                       group=mesh.header_group)
    return out


def _leader_rank(mesh: Mesh) -> int:
    """The global rank of this rank's tp leader (tp index 0)."""
    return mesh.rank - mesh.tp_rank
