"""Which process holds which entry of a device mesh.

A device mesh is a list. Entries without a rank (torch devices, all one
device) put every part or shard in this process, stacked on that device.
Entries carrying a rank and a device (``MeshEntry``, built by
``multihost.global_device_mesh``) give each rank of the default process
group its block of entries, in rank order. ``rank_layout`` reads that
rule for the partitioned step (``ops/walk_partitioned.py``) and the
particle shards (``particle_sharding.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshEntry:
    """A mesh entry of a process group: the rank that holds it and that
    rank's device."""

    rank: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """The entries of a device mesh this process holds: ``lo`` to ``hi``
    on ``device``; ``bounds`` every rank's ``(lo, hi)`` in rank order, or
    None when the mesh names no ranks (every entry here)."""

    lo: int
    hi: int
    device: torch.device
    bounds: tuple | None = None
    rank: int = 0


def rank_layout(device_mesh) -> RankLayout:
    """Where a device mesh puts its entries: entries without a rank
    (torch devices) stack every entry on their one device in this
    process; ``MeshEntry`` entries give each rank of the default process
    group its block, in rank order."""
    devs = list(device_mesh)
    ranks = [getattr(d, "rank", None) for d in devs]
    if all(r is None for r in ranks):
        found = {resolve_device(d) for d in devs}
        if len(found) != 1:
            raise ValueError(
                f"the parts of a mesh without ranks are stacked on one "
                f"device, not {sorted(map(str, found))}; entries with a "
                "rank and a device (MeshEntry) spread them over processes")
        return RankLayout(0, len(devs), found.pop())
    if any(r is None for r in ranks):
        raise ValueError("either every entry of the mesh names a rank or "
                         "none does")
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "a mesh over ranks needs the default process group "
            "(parallel/multihost.py::init_distributed)")
    world, me = dist.get_world_size(), dist.get_rank()
    if ranks != sorted(ranks) or set(ranks) != set(range(world)):
        raise ValueError(
            f"the mesh's ranks {ranks} must be the group's {world} ranks, "
            "each in one block, in rank order")
    bounds = tuple((ranks.index(r), len(ranks) - ranks[::-1].index(r))
                   for r in range(world))
    lo, hi = bounds[me]
    found = {resolve_device(d.device) for d in devs[lo:hi]}
    if len(found) != 1:
        raise ValueError(f"rank {me}'s parts must be on one device, not "
                         f"{sorted(map(str, found))}")
    return RankLayout(lo, hi, found.pop(), bounds, me)
