"""The engine's device mesh over ``torch.distributed``.

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
"""
from __future__ import annotations

import dataclasses
import itertools
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
