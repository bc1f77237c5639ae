"""Device meshes: the engine's mesh over ``torch.distributed``, and the
planning meshes of the sharding rules and the dry run.

NDSEARCH spreads an index that outgrows one device across LUN groups;
the engine models each LUN group as one rank of a 1-D ``"lun"`` mesh.
Here a mesh is an already initialised process group: one process per
rank, rank ``r`` of a world of ``w`` owning the ``S / w`` consecutive
shards ``[r * S / w, (r + 1) * S / w)`` of an ``S``-shard index (``w``
must divide ``S``). At ``w == S`` that is one shard per rank; at
``w == 1`` one rank holds the whole index behind real collectives.

Start the group before building a mesh, with its address given
explicitly (nothing tells a program of a cluster)::

    torch.distributed.init_process_group(
        "nccl", init_method="file:///tmp/rdv", rank=r, world_size=w,
        timeout=datetime.timedelta(seconds=120))
    mesh = make_engine_mesh()

``nccl`` carries tensors on a card, ``gloo`` tensors on the CPU
(``"cuda:nccl,cpu:gloo"`` both). Importing this module touches no
process-group state.

The planning meshes (:func:`make_production_mesh`, :func:`make_mesh_for`)
are plain descriptions: axis names and a size per axis, as the sharding
rules (``models/sharding.py``) and the dry run (``launch/dryrun.py``)
read them. They open no process group and hold no device.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class EngineMesh:
    """One rank's view of the engine mesh: the process group (None: the
    default group), this process's ``rank`` in it and its ``world``
    size. ``generation`` tells the meshes of one process apart (a group
    destroyed and another made with the same rank and world): it keys
    the captured chunks, whose graphs hold one group's collectives."""

    group: Any
    rank: int
    world: int
    axis_name: str = "lun"
    generation: int = 0
    _warm: set = dataclasses.field(default_factory=set, compare=False,
                                   repr=False)

    def shards_per_rank(self, num_shards: int) -> int:
        """Shards each rank owns of a ``num_shards``-shard index."""
        if num_shards % self.world:
            raise ValueError(
                f"{num_shards} shards do not split over a mesh of "
                f"{self.world} ranks (the world size must divide S)")
        return num_shards // self.world

    def shard0(self, num_shards: int) -> int:
        """The first shard this rank owns."""
        return self.rank * self.shards_per_rank(num_shards)

    def warm(self, device) -> None:
        """Run one collective eagerly on ``device`` (once per device):
        NCCL makes its communicator at the first collective, which must
        not happen inside a CUDA-graph capture."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if str(dev) in self._warm:
            return
        x = torch.zeros(1, dtype=torch.int32, device=dev)
        dist.all_reduce(x, group=self.group)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._warm.add(str(dev))


#: a generation per mesh made in this process
_GENERATIONS = itertools.count(1)


def make_engine_mesh(axis_name: str = "lun", num: int | None = None,
                     group=None) -> EngineMesh:
    """The 1-D engine mesh over an initialised process group (``group``,
    default the world). ``num`` (optional) must equal its size."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_engine_mesh reads an initialised process group: call "
            "torch.distributed.init_process_group(...) first")
    world = dist.get_world_size(group)
    if num is not None and int(num) != world:
        raise ValueError(f"num={num} ranks asked for, the process group "
                         f"has {world}")
    return EngineMesh(group=group, rank=dist.get_rank(group), world=world,
                      axis_name=axis_name, generation=next(_GENERATIONS))


@dataclasses.dataclass(frozen=True)
class PlanMesh:
    """A mesh as the planner sees it: ``axis_names`` and ``sizes``, one
    per axis. ``shape`` maps each name to its size, ``size`` is the
    number of devices."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> PlanMesh:
    """The target deployment mesh: 16x16 (data, model) per pod, 2 pods
    (pod, data, model) multi-pod."""
    if multi_pod:
        return PlanMesh(("pod", "data", "model"), (2, 16, 16))
    return PlanMesh(("data", "model"), (16, 16))


def make_mesh_for(num_devices: int, shape, axes) -> PlanMesh:
    """A planning mesh of ``shape`` over ``axes`` for ``num_devices``
    devices."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if math.prod(shape) != num_devices:
        raise ValueError(f"a {shape} mesh has {math.prod(shape)} devices, "
                         f"not {num_devices}")
    return PlanMesh(axes, shape)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh: a :class:`PlanMesh`, a
    ``torch.distributed`` ``DeviceMesh`` (``mesh_dim_names`` and
    ``shape``), or anything with ``axis_names`` and either a
    ``devices.shape`` or a ``shape`` (a tuple, or a mapping of name to
    size)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    names = tuple(mesh.axis_names)
    devices = getattr(mesh, "devices", None)
    shape = devices.shape if devices is not None else mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(s) for s in shape)))
