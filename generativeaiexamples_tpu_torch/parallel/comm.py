"""Collectives of mesh serving.

The reference has no module of this name: its ``psum``, ``all_gather``
and ``ppermute`` run inside ``shard_map`` bodies and GSPMD inserts the
rest, all XLA collectives over ICI. On Hopper the same exchanges are NCCL
collectives issued from outside the kernels (``torch.distributed``; gloo
on the CPU), over the groups of a ``parallel.mesh.Mesh``, named by axis:
``"tp"`` (the default), ``"sp"``, and ``"moe"`` (the ``ep x tp`` ranks
of one replica's experts):

- ``all_reduce_`` sums a tensor over an axis's group in place (after a
  row-parallel product, the vocab-sharded embedding; over ``"moe"`` the
  MoE combine; over ``"sp"`` the sequence shards' last row);
- ``all_gather`` stacks each rank's tensor into a ``(n_shards, ...)``
  tensor (the sampler's carries, the materialized tail's logit shards,
  the KV tier's pages gathered into whole-model blocks; over ``"sp"``
  the ring prefill's K/V and the score's NLL rows);
- ``ring_pass`` is one step of the sequence-parallel ring: a block to
  the next sp rank and one from the previous (``ring_attention.py``);
- ``all_reduce_max_`` takes the elementwise maximum over tp in place (a
  row-parallel weight's per-channel absmax at quantization);
- ``broadcast_`` copies the serving leader's tensor (global rank 0) into
  every rank's, in place (fused RAG's encoder, corpus and retrieved
  rows; restored KV pages);
- ``broadcast_header`` / ``receive_header``: the serving leader's round
  headers to every other rank, ``gather_to_leader`` their replies,
  ``share_from_leader`` one object from the leader to all, and ``agree``
  one verdict from every rank, on the host-only gloo group.

The device collectives but ``ring_pass`` enqueue on the current stream
without a host read, so a CUDA graph can capture them (the communicator
must exist first: ``warm_up``). Each is a no-op where its axis is 1 or
without a mesh.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh

# The group of each named axis on a ``Mesh``, and the axes it spans.
_GROUPS = {"tp": ("tp_group", ("tp",)), "sp": ("sp_group", ("sp",)),
           "moe": ("moe_group", ("ep", "tp"))}


def axis_size(mesh: Optional[Mesh], axis: str = "tp") -> int:
    """The number of ranks in ``axis``'s group (1 without a mesh)."""
    if mesh is None:
        return 1
    n = 1
    for a in _GROUPS[axis][1]:
        n *= mesh.shape.get(a, 1)
    return n


def _group(mesh: Optional[Mesh], axis: str):
    """``axis``'s group on ``mesh``, or None where nothing splits."""
    if axis_size(mesh, axis) <= 1:
        return None
    return getattr(mesh, _GROUPS[axis][0])


def sharded(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` splits work over more than one rank's tp group."""
    return _group(mesh, "tp") is not None


def distributed(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` has ranks besides this one (a leader and its
    followers, whatever the axes)."""
    return (mesh is not None and mesh.world > 1
            and mesh.header_group is not None)


def all_reduce_(t: torch.Tensor, mesh: Optional[Mesh],
                axis: str = "tp") -> torch.Tensor:
    """Sum ``t`` over ``axis``'s group, in place; returns ``t``."""
    group = _group(mesh, axis)
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, mesh: Optional[Mesh],
               axis: str = "tp") -> torch.Tensor:
    """``(n_shards, *t.shape)``: every rank's ``t`` in the group's rank
    order (the reference's ``jax.lax.all_gather`` over the axis).
    Without a split, ``t[None]``."""
    group = _group(mesh, axis)
    if group is None:
        return t[None]
    n = axis_size(mesh, axis)
    t = t.contiguous()
    # One flat buffer, rank-major: the layout both NCCL and gloo fill.
    out = t.new_empty((n * t.shape[0], *t.shape[1:]) if t.dim() else (n,))
    dist.all_gather_into_tensor(out, t if t.dim() else t[None], group=group)
    return out.view(n, *t.shape)


def ring_pass(send: list, recv: list, mesh: Mesh) -> list:
    """One step of the sp ring (the reference's ``ppermute`` with
    ``perm = [(i, i + 1 mod sp)]``): each tensor of ``send`` to the next
    sp rank and, into each of ``recv``, the previous rank's, all in one
    ``batch_isend_irecv``. Returns its requests: the caller issues the
    pass before the current block's compute and waits on them after
    it."""
    group = _group(mesh, "sp")
    ranks = dist.get_process_group_ranks(group)
    at = ranks.index(mesh.rank)
    nxt, prv = ranks[(at + 1) % len(ranks)], ranks[(at - 1) % len(ranks)]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group=group)
           for t in send]
    ops += [dist.P2POp(dist.irecv, t, prv, group=group) for t in recv]
    return dist.batch_isend_irecv(ops)


def all_reduce_max_(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Elementwise maximum of ``t`` over the tp group, in place."""
    group = _group(mesh, "tp")
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def broadcast_(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The serving leader's ``t`` into every rank's ``t``, in place (each
    rank passes a tensor of the same shape and dtype), over the default
    group of all ranks."""
    if distributed(mesh):
        dist.broadcast(t, src=0)
    return t


def warm_up(mesh: Optional[Mesh], device: torch.device) -> None:
    """One eager all-reduce on each group (every axis's and the default
    group's), so that NCCL's communicators exist before a CUDA graph
    captures a collective on one."""
    if not distributed(mesh):
        return
    probe = torch.ones((1,), device=device)
    dist.all_reduce(probe)
    want = mesh.world
    for axis in _GROUPS:
        group = _group(mesh, axis)
        if group is not None:
            dist.all_reduce(probe, group=group)
            want *= axis_size(mesh, axis)
    if probe.item() != want:
        raise RuntimeError(f"the warm-up all-reduces gave {probe.item()}, "
                           f"not {want}")


def broadcast_header(header: Any, mesh: Mesh) -> None:
    """The leader's header to every other rank (pickled, over the gloo
    header group: host to host, never behind the card's queue)."""
    dist.broadcast_object_list([header], src=0, group=mesh.header_group)


def receive_header(mesh: Mesh) -> Any:
    """A follower's next header from the leader (blocks until one comes;
    raises when the leader's connection closes)."""
    box = [None]
    dist.broadcast_object_list(box, src=0, group=mesh.header_group)
    return box[0]


def gather_to_leader(obj: Any, mesh: Mesh) -> Optional[list]:
    """Every rank's ``obj`` in rank order on the leader (None
    elsewhere), over the header group."""
    out = [None] * mesh.world if mesh.leader else None
    dist.gather_object(obj, out, dst=0, group=mesh.header_group)
    return out


def share_from_leader(obj: Any, mesh: Optional[Mesh]) -> Any:
    """The leader's ``obj`` on every rank (every rank calls this; a
    follower's own ``obj`` is ignored). ``obj`` itself without other
    ranks."""
    if not distributed(mesh):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.header_group)
    return box[0]


def agree(ok: bool, mesh: Optional[Mesh]) -> bool:
    """Whether every rank passed ``ok`` True: the leader gathers the
    verdicts (``gather_to_leader``) and shares their conjunction. Every
    rank calls this at the same point, outside any device collective, so
    a step one rank failed is abandoned by all."""
    if not distributed(mesh):
        return ok
    votes = gather_to_leader(bool(ok), mesh)
    return share_from_leader(all(votes) if votes is not None else None,
                             mesh)
