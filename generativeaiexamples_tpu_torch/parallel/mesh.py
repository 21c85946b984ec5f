"""Device mesh of the port: one process per card, the reference's mesh
axes — port of the reference's ``parallel/mesh.py``.

The reference is one controller over a ``jax.sharding.Mesh``; PyTorch's
idiom is one process per card under ``torch.distributed``. Every rank
builds the same ``Mesh`` from the same ``MeshPlan``: the axis sizes (the
reference's ``mesh.shape``), this rank's place in them, and the process
groups its collectives run on. The axis order is the reference's, ``tp``
innermost, so a tensor-parallel group is ``tp`` consecutive ranks (on one
host, the cards NVLink joins all to all).

Process groups: the collectives of the model (``parallel/comm.py``) run
on the default backend, NCCL on the card and gloo on the CPU; the small
host-side headers the serving leader sends its followers
(``engine/engine.py``) run on a gloo group of their own, so a header never
waits behind the card's queue.
"""

from __future__ import annotations

import datetime
import itertools
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


def maybe_init_distributed(coordinator: str, num_processes: int,
                           process_id: int, *,
                           device: Union[str, torch.device] = "cuda",
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """The process group of a multi-process run on one host (the
    reference's ``maybe_init_distributed``, which wires hosts for
    ``jax.distributed``).

    ``coordinator`` is the group's ``init_method``: ``tcp://host:port``
    (a bare ``host:port`` is taken as tcp), ``file:///path`` or
    ``env://``. The backend is NCCL on the card, each rank on card
    ``process_id % device_count``, and gloo on the CPU. Returns True if
    the group is (already) initialized; a world of one process needs
    none and returns False."""
    if dist.is_initialized():
        return True
    if num_processes <= 1:
        return False
    if not coordinator or not 0 <= process_id < num_processes:
        raise ConfigError(
            f"a process group needs a coordinator and this process's id "
            f"in [0, {num_processes}) (got {coordinator!r}, {process_id})")
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ConfigError("no CUDA device is available for an NCCL "
                              "process group; pass device='cpu' for gloo")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=coordinator,
        world_size=num_processes, rank=process_id,
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
    ranks, its coordinates (``coords``), the device it runs on, and the
    groups of its tensor-parallel ranks (``tp_group`` for the model's
    collectives, ``header_group`` for the leader's headers; None at
    tp = 1)."""
    shape: dict
    rank: int = 0
    world: int = 1
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    tp_group: Any = None
    header_group: Any = None

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
        """Whether this rank leads its tensor-parallel group (tp index 0:
        the rank that serves)."""
        return self.tp_rank == 0


def make_mesh(plan: Optional[MeshPlan] = None, *,
              device: Union[str, torch.device] = "cuda") -> Mesh:
    """Build this rank's mesh over the initialized process group (one
    rank when none is). Every rank must call it, in the same order as
    its other group calls: it creates the tensor-parallel groups, each
    ``tp`` consecutive ranks, and their gloo header groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    plan = (plan or MeshPlan()).resolve(world)
    shape = {a: getattr(plan, a) for a in AXES}
    mesh = Mesh(shape=shape, rank=rank, world=world,
                device=torch.device(device))
    if world > 1 and plan.tp > 1:
        outer = [range(shape[a]) for a in AXES[:-1]]
        for idx in itertools.product(*outer):
            base = 0
            for a, i in zip(AXES[:-1], idx):
                base = base * shape[a] + i
            ranks = [base * plan.tp + t for t in range(plan.tp)]
            group = dist.new_group(ranks)
            header = dist.new_group(ranks, backend="gloo")
            if rank in ranks:
                mesh.tp_group, mesh.header_group = group, header
    return mesh

