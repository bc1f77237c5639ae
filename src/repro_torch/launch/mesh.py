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

The training mesh (:class:`TrainMesh`, :func:`make_train_mesh`) lays a
``("data", "model")`` or ``("pod", "data", "model")`` grid over an
initialised world, one process per rank, row-major (the last axis
fastest, as ``jax.make_mesh`` orders its devices), with one process
group per axis and one over the FSDP axes together (``"fsdp"``: pod and
data). :func:`init_train_group` starts the world with an explicit
address and a timeout on every collective: ``nccl`` on a card, ``gloo``
on the CPU.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
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


# ---------------------------------------------------------------------------
# The training mesh
# ---------------------------------------------------------------------------
#: seconds any collective of a training mesh may wait before it fails
TRAIN_TIMEOUT_S = 600
#: the axes that carry the FSDP shards and the batch rows
FSDP_AXES = ("pod", "data")


def init_train_group(device, *, init_method: str | None = None,
                     rank: int | None = None, world: int | None = None,
                     timeout_s: float = TRAIN_TIMEOUT_S) -> None:
    """Start the default process group for a training mesh: ``nccl`` when
    ``device`` is a card (the group bound to it, so its communicator
    exists before the first collective), ``gloo`` on the CPU. The
    address is ``init_method`` (``file://...`` or ``tcp://host:port``),
    else the ``MASTER_ADDR`` / ``MASTER_PORT`` that ``torchrun`` sets;
    ``rank`` and ``world`` default to ``RANK`` and ``WORLD_SIZE`` (else
    0 and 1)."""
    dev = torch.device(device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world = int(os.environ.get("WORLD_SIZE", 1)) if world is None \
        else int(world)
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            raise ValueError("no rendezvous: pass an init_method "
                             "(file:// or tcp://) or set MASTER_ADDR and "
                             "MASTER_PORT")
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    kw = {}
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        kw["device_id"] = dev
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """One rank's view of a training mesh: the axis names and sizes, this
    rank's coordinate on each axis, and the process group of each axis
    of more than one rank (``groups``; ``"fsdp"`` spans pod x data). The
    sharding rules read it as a mesh (``axis_names``, ``shape``)."""

    axis_names: tuple
    sizes: tuple
    rank: int
    coords: dict
    groups: dict
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def size(self, axis) -> int:
        """Ranks along ``axis``: a name, ``"fsdp"`` or a tuple of names."""
        return math.prod(self.shape.get(a, 1) for a in self.names(axis))

    def coord(self, axis) -> int:
        """This rank's place along ``axis`` (row-major over a tuple)."""
        c = 0
        for a in self.names(axis):
            c = c * self.shape.get(a, 1) + self.coords.get(a, 0)
        return c

    def group(self, axis):
        """The process group of ``axis`` (None: a single rank)."""
        return self.groups.get(self.key(axis))

    def names(self, axis) -> tuple:
        """The axis names ``axis`` spans ("fsdp": pod and data; "world":
        every axis)."""
        if axis == "fsdp":
            return tuple(a for a in FSDP_AXES if a in self.shape)
        if axis == "world":
            return self.axis_names
        if isinstance(axis, str):
            return (axis,)
        return tuple(a for e in axis for a in self.names(e))

    def key(self, axis) -> str:
        """``axis``'s name in ``groups`` (and in the collectives' counts)."""
        names = self.names(axis)
        if names == self.names("fsdp"):
            return "fsdp"
        if names == self.axis_names:
            return "world"
        if len(names) == 1:
            return names[0]
        raise ValueError(f"no process group for axes {names}")


def _axis_lines(sizes: tuple, axes: tuple) -> list:
    """Every line of ranks along ``axes`` (indices into ``sizes``) of a
    row-major grid, in one order on every rank."""
    others = [i for i in range(len(sizes)) if i not in axes]
    lines = []
    for fixed in itertools.product(*(range(sizes[i]) for i in others)):
        line = []
        for moving in itertools.product(*(range(sizes[i]) for i in axes)):
            idx = [0] * len(sizes)
            for i, v in zip(others, fixed):
                idx[i] = v
            for i, v in zip(axes, moving):
                idx[i] = v
            r = 0
            for i, v in enumerate(idx):
                r = r * sizes[i] + v
            line.append(r)
        lines.append(line)
    return lines


def make_train_mesh(shape, axes=None, device="cuda") -> TrainMesh:
    """The training mesh of ``shape`` over the initialised world
    (``init_train_group`` first; the world size must equal the product
    of ``shape``). ``axes`` default: ``("data", "model")`` for two
    entries, ``("pod", "data", "model")`` for three, as the reference's
    ``launch/train.py`` names them. Every rank makes every group, in one
    order (``new_group`` is collective)."""
    shape = tuple(int(s) for s in shape)
    if axes is None:
        axes = ("data", "model")[:len(shape)] if len(shape) <= 2 else \
            ("pod", "data", "model")
    axes = tuple(axes)
    if len(axes) != len(shape):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_train_mesh reads an initialised process "
                           "group: call init_train_group(...) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the world has {world}")
    coords, r = {}, rank
    for a, s in reversed(list(zip(axes, shape))):
        coords[a] = r % s
        r //= s
    wanted = {a: (i,) for i, a in enumerate(axes)}
    fsdp = tuple(i for i, a in enumerate(axes) if a in FSDP_AXES)
    if len(fsdp) > 1:
        wanted["fsdp"] = fsdp
    wanted["world"] = tuple(range(len(axes)))
    groups = {}
    for key, idx in wanted.items():
        if math.prod(shape[i] for i in idx) == 1:
            continue
        if idx == tuple(range(len(axes))):
            groups[key] = dist.group.WORLD
            continue
        for line in _axis_lines(shape, idx):
            g = dist.new_group(line)
            if rank in line:
                groups[key] = g
    if len(fsdp) == 1 and axes[fsdp[0]] in groups:
        groups["fsdp"] = groups[axes[fsdp[0]]]
    return TrainMesh(axes, shape, rank, coords, groups, torch.device(device))
