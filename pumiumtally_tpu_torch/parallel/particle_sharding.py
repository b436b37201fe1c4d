"""Particle-axis data parallelism over a replicated mesh.

Counterpart of ``pumiumtally_tpu/parallel/particle_sharding.py``: the
particle axis is split into ``n`` shards, each shard walks its lanes over
the whole mesh into its own partial flux row ``[n, ...]``, and
``reduce_flux`` sums the rows (the tally all-reduce). A device mesh is a
list: torch devices, all one device (the shards walk one after the other
in this process), or ``ranks.MeshEntry(rank, device)`` entries, each rank's in
one block in rank order (``multihost.global_device_mesh``): each process
walks its own shards, and ``reduce_flux`` ends in a ``dist.all_reduce``
over the default process group. Each shard walks with the port's walk
(``ops/walk_cuda.py``: the walk kernel on the card, the plain walk on the
CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import walk_cuda
from ..ops.walk import TraceResult
from ..utils.platform import resolve_device
from .ranks import rank_layout

PARTICLE_AXIS = "p"


def make_device_mesh(n_devices: int | None = None, device=None) -> list:
    """A 1-D device mesh of ``n_devices`` entries (default 1), every one
    ``device`` (default: the CUDA card; ``"cpu"`` on the CPU)."""
    dev = resolve_device(device)
    return [dev] * (1 if n_devices is None else int(n_devices))


def mesh_from_devices(devices) -> list:
    """A 1-D mesh over an explicit list of entries, in their order — the
    elastic recovery's survivors (resilience/elastic.py)."""
    devices = list(devices)
    if not devices:
        raise ValueError("mesh_from_devices needs at least one device")
    return devices


def n_shards(device_mesh) -> int:
    return len(device_mesh)


def _local(device_mesh) -> tuple:
    """(this process's shards, their device)."""
    lay = rank_layout(device_mesh)
    return lay.hi - lay.lo, lay.device


def _device(device_mesh) -> torch.device:
    return _local(device_mesh)[1]


def make_sharded_flux(device_mesh, ntet: int, n_groups: int,
                      dtype=torch.float32, flat: bool = False):
    """This process's per-shard partial tallies ``[n, ntet, n_groups,
    2]``, or with ``flat`` ``[n, ntet·n_groups·2]``, zero."""
    nd, dev = _local(device_mesh)
    shape = (nd, ntet * n_groups * 2) if flat else (nd, ntet, n_groups, 2)
    return torch.zeros(shape, dtype=dtype, device=dev)


def shard_particles(device_mesh, *arrays):
    """This process's per-particle arrays (numpy or tensors) on its
    device; their length must divide by its shard count (pad with parked
    particles)."""
    nd, dev = _local(device_mesh)
    out = []
    for a in arrays:
        t = (a if isinstance(a, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(a)))
        if t.shape[0] % nd:
            raise ValueError(
                f"{t.shape[0]} particles do not split into {nd} shards")
        out.append(t.to(dev).contiguous())
    return tuple(out) if len(out) != 1 else out[0]


def replicate(device_mesh, mesh):
    """The mesh, on the mesh's device (one copy serves every shard)."""
    if mesh.device != _device(device_mesh):
        raise ValueError(f"the mesh is on {mesh.device}, the shards on "
                         f"{_device(device_mesh)}")
    return mesh


def make_sharded_trace(device_mesh, *, initial: bool, max_crossings: int,
                       score_squares: bool = True, tolerance: float = 1e-8,
                       compact_after: int | None = None,
                       compact_size: int | None = None, unroll: int = 8,
                       n_groups: int | None = None):
    """The sharded walk step: ``step(mesh, origin, dest, elem, in_flight,
    weight, group, material_id, flux)`` walks this process's shard k's
    lanes (the k-th block of its particles) into ``flux[k]`` (updated in
    place) and
    returns a TraceResult whose per-lane outputs are concatenated and
    whose flux, segments, iterations and stats carry the shard axis. The
    compaction and unroll knobs schedule the JAX walk only; they are
    ignored. ``n_groups`` defaults to the flux's ``[n, ntet, G, 2]``
    shape."""
    del compact_after, compact_size, unroll
    nd = _local(device_mesh)[0]

    def step(mesh, origin, dest, elem, in_flight, weight, group,
             material_id, flux):
        G = n_groups if n_groups is not None else (
            flux.shape[2] if flux.dim() == 4 else None)
        if G is None:
            raise ValueError(
                "flat flux ([n, ntet*n_groups*2]) requires the explicit "
                "n_groups kwarg")
        n = origin.shape[0]
        if n % nd or flux.shape[0] != nd:
            raise ValueError(
                f"{n} lanes and a [{flux.shape[0]}, ...] flux do not split "
                f"into {nd} shards")
        k = n // nd
        parts = []
        for s in range(nd):
            lanes = slice(s * k, (s + 1) * k)
            parts.append(walk_cuda.trace(
                mesh, origin[lanes], dest[lanes], elem[lanes],
                in_flight[lanes], weight[lanes], group[lanes],
                material_id[lanes], flux[s].view(-1), initial=initial,
                max_crossings=max_crossings, n_groups=G,
                score_squares=score_squares, tolerance=tolerance))
        return TraceResult(
            position=torch.cat([r.position for r in parts]),
            elem=torch.cat([r.elem for r in parts]),
            material_id=torch.cat([r.material_id for r in parts]),
            flux=flux,
            n_segments=torch.stack([r.n_segments for r in parts]),
            n_crossings=torch.stack([r.n_crossings for r in parts]),
            done=torch.cat([r.done for r in parts]),
            lane_iters=torch.cat([r.lane_iters for r in parts]),
            track_length=torch.cat([r.track_length for r in parts]),
            stats=torch.stack([r.stats for r in parts]),
        )

    return step


def reduce_flux(sharded_flux: torch.Tensor,
                device_mesh=None) -> torch.Tensor:
    """The tally reduction: the per-shard partial slabs summed, shard 0
    first; with a ``device_mesh`` over ranks, then summed over the
    processes (one ``dist.all_reduce``; every process gets the sum)."""
    out = sharded_flux.sum(dim=0)
    if device_mesh is not None and rank_layout(device_mesh).bounds:
        import torch.distributed as dist

        dist.all_reduce(out)
    return out
