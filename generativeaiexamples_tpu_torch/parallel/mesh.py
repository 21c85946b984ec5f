"""Device mesh of the port: one process per card, the reference's mesh
axes — port of the reference's ``parallel/mesh.py``.

The reference is one controller over a ``jax.sharding.Mesh``; PyTorch's
idiom is one process per card under ``torch.distributed``. Every rank
builds the same ``Mesh`` from the same ``MeshPlan``: the axis sizes (the
reference's ``mesh.shape``), this rank's place in them, and the process
groups its collectives run on. Rank ``r`` is the reference's device
``r`` of ``np.array(devices).reshape(dp, pp, ep, sp, tp)``: ``tp``
innermost, so a tensor-parallel group is ``tp`` consecutive ranks (on
one host, the cards NVLink joins all to all).

Process groups (``parallel/comm.py`` names them by axis): ``tp_group``
(the row-parallel sums, the vocab shards), ``sp_group`` (the ring and
the sequence shards' gathers), ``moe_group`` (the ``ep x tp`` ranks that
hold one replica's experts: the MoE combine) and the default group over
every rank (the leader's broadcasts), all on the default backend, NCCL
on the card and gloo on the CPU. Global rank 0 serves; every other rank,
the ``dp`` and ``sp`` replicas included, follows it, and the small
host-side headers it sends (``engine/engine.py``) run on a gloo group
over every rank (``header_group``), so a header never waits behind the
card's queue.

Several hosts (``maybe_init_distributed``): each host's process drives
its local cards, one rank each, and global rank = process id x local
cards + local index.
"""

from __future__ import annotations

import datetime
import itertools
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Union

import torch
import torch.distributed as dist

from ..utils.errors import ConfigError, ShardingError

# Canonical mesh axes: data, pipeline, expert, sequence, tensor.
AXES = ("dp", "pp", "ep", "sp", "tp")

# How long a collective may wait for a rank before the group fails
# (``init_process_group``'s timeout): long enough for the slowest rank to
# finish a program capture or a weight load, finite so a dead rank ends
# the group instead of hanging it.
DEFAULT_TIMEOUT_S = 600.0


def parse_mesh_spec(spec: str) -> dict:
    """``"tp=2"`` / ``"tp=2,sp=2"`` -> ``{"tp": 2, "sp": 2}``. The one
    grammar for every mesh-spec surface: unknown axes and non-positive
    sizes are a loud ``ValueError``, as in the reference."""
    axes: dict = {}
    for part in (p.strip() for p in spec.split(",") if p.strip()):
        axis, sep, n = part.partition("=")
        axis = axis.strip()
        if not sep or axis not in AXES:
            raise ValueError(f"mesh spec {spec!r}: want axis=N pairs "
                             f"over {AXES}")
        if axis in axes:
            raise ValueError(f"mesh spec {spec!r}: axis {axis} given "
                             f"twice")
        size = int(n)
        if size < 1:
            raise ValueError(f"mesh spec {spec!r}: axis {axis} size "
                             f"must be >= 1")
        axes[axis] = size
    return axes


def host_settings(coordinator: str = "", num_processes: int = 0,
                  process_id: int = -1) -> tuple[str, int, int]:
    """(coordinator, processes, this process's id): each argument that is
    not given falls back to the reference's environment variable
    (``GAIE_COORDINATOR``, ``GAIE_NUM_PROCESSES``, ``GAIE_PROCESS_ID``);
    one process, id 0, when neither sets a count."""
    coordinator = coordinator or os.environ.get("GAIE_COORDINATOR", "")
    num_processes = num_processes or int(
        os.environ.get("GAIE_NUM_PROCESSES", "0") or 0) or 1
    if process_id < 0:
        process_id = int(os.environ.get("GAIE_PROCESS_ID", "-1") or -1)
    if num_processes == 1 and process_id < 0:
        process_id = 0
    return coordinator, num_processes, process_id


def maybe_init_distributed(coordinator: str = "", num_processes: int = 0,
                           process_id: int = -1, *, local_rank: int = 0,
                           local_ranks: int = 1,
                           device: Union[str, torch.device] = "cuda",
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """The process group of a run over several processes (the
    reference's ``maybe_init_distributed``, which wires hosts for
    ``jax.distributed``).

    ``num_processes`` processes (hosts) take part, this one being
    ``process_id``; each drives ``local_ranks`` ranks, of which the
    calling one is ``local_rank``: global rank = ``process_id x
    local_ranks + local_rank`` of ``num_processes x local_ranks``. The
    arguments fall back to the reference's environment variables
    (``GAIE_COORDINATOR``, ``GAIE_NUM_PROCESSES``, ``GAIE_PROCESS_ID``).
    ``coordinator`` is the group's ``init_method``: ``tcp://host:port``
    (a bare ``host:port``, the reference's form, is taken as tcp; global
    rank 0 hosts the store there), ``file:///path`` or ``env://``. The
    backend is NCCL on the card, each rank on card ``global rank %
    device_count`` (its local index when each host sees its own cards),
    and gloo on the CPU. Returns True if the group is (already)
    initialized; a world of one rank needs none and returns False."""
    if dist.is_initialized():
        return True
    coordinator, num_processes, process_id = host_settings(
        coordinator, num_processes, process_id)
    if not 0 <= local_rank < local_ranks:
        raise ConfigError(f"local rank {local_rank} is not in "
                          f"[0, {local_ranks})")
    world = num_processes * local_ranks
    if world <= 1:
        return False
    if not coordinator or not 0 <= process_id < num_processes:
        raise ConfigError(
            f"a process group needs a coordinator and this process's id "
            f"in [0, {num_processes}) (got {coordinator!r}, {process_id})")
    rank = process_id * local_ranks + local_rank
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ConfigError("no CUDA device is available for an NCCL "
                              "process group; pass device='cpu' for gloo")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=coordinator,
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


@dataclass(frozen=True)
class MeshPlan:
    """Requested parallelism degrees. 0 ⇒ infer from device count."""
    dp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 0

    def resolve(self, n_devices: int) -> "MeshPlan":
        plan = self
        if plan.tp == 0:
            fixed = plan.dp * plan.pp * plan.ep * plan.sp
            if n_devices % fixed:
                raise ShardingError(
                    f"{n_devices} devices not divisible by dp*pp*ep*sp={fixed}")
            plan = MeshPlan(plan.dp, plan.pp, plan.ep, plan.sp,
                            n_devices // fixed)
        total = plan.dp * plan.pp * plan.ep * plan.sp * plan.tp
        if total != n_devices:
            raise ShardingError(
                f"dp*pp*ep*sp*tp = {total} != {n_devices} devices "
                "(the TP·PP=world check of the reference, "
                "model_server/__init__.py:103-110, generalized)")
        return plan


@dataclass(eq=False)
class Mesh:
    """One rank's view of the mesh: ``shape`` (axis -> size, the
    reference's ``mesh.shape``), this rank's global ``rank`` in ``world``
    ranks, its coordinates (``coords``), the device it runs on, and its
    process groups (module docstring): ``tp_group``, ``sp_group`` and
    ``moe_group`` (None where the axis is 1), ``header_group`` (None in a
    world of one)."""
    shape: dict
    rank: int = 0
    world: int = 1
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    tp_group: Any = None
    header_group: Any = None
    sp_group: Any = None
    moe_group: Any = None

    @property
    def coords(self) -> dict:
        """This rank's index along each axis (row-major, ``tp``
        innermost)."""
        out, r = {}, self.rank
        for axis in reversed(AXES):
            out[axis] = r % self.shape[axis]
            r //= self.shape[axis]
        return {a: out[a] for a in AXES}

    @property
    def tp(self) -> int:
        return self.shape["tp"]

    @property
    def tp_rank(self) -> int:
        return self.coords["tp"]

    @property
    def leader(self) -> bool:
        """Whether this rank serves: global rank 0 (at pure tp, the tp
        group's index 0)."""
        return self.rank == 0


def axis_ranks(shape: dict, axes: tuple) -> list:
    """The rank lists of the groups along ``axes``: one list for every
    index of the other axes, its ranks ordered row-major over ``axes``
    (the reference device array's ranks along those axes)."""
    sizes = [shape[a] for a in AXES]
    others = [a for a in AXES if a not in axes]
    groups = []
    for fixed in itertools.product(*(range(shape[a]) for a in others)):
        at = dict(zip(others, fixed))
        ranks = []
        for free in itertools.product(*(range(shape[a]) for a in axes)):
            at.update(zip(axes, free))
            r = 0
            for a, n in zip(AXES, sizes):
                r = r * n + at[a]
            ranks.append(r)
        groups.append(ranks)
    return groups


def make_mesh(plan: Optional[MeshPlan] = None, *,
              device: Union[str, torch.device] = "cuda") -> Mesh:
    """Build this rank's mesh over the initialized process group (one
    rank when none is). Every rank must call it, in the same order as
    its other group calls: it creates every group of every axis over
    one (``axis_ranks``), each rank keeping its own, and the gloo header
    group over all ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    plan = (plan or MeshPlan()).resolve(world)
    shape = {a: getattr(plan, a) for a in AXES}
    mesh = Mesh(shape=shape, rank=rank, world=world,
                device=torch.device(device))
    if world == 1:
        return mesh

    def groups(axes: tuple):
        mine = None
        for ranks in axis_ranks(shape, axes):
            group = dist.new_group(ranks)
            if rank in ranks:
                mine = group
        return mine

    if plan.tp > 1:
        mesh.tp_group = groups(("tp",))
    if plan.sp > 1:
        mesh.sp_group = groups(("sp",))
    if plan.ep > 1:
        mesh.moe_group = groups(("ep", "tp"))
    else:
        mesh.moe_group = mesh.tp_group
    mesh.header_group = dist.new_group(list(range(world)), backend="gloo")
    return mesh
