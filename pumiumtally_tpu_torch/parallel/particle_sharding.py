"""Particle-axis data parallelism over a replicated mesh.

Counterpart of ``pumiumtally_tpu/parallel/particle_sharding.py``: the
particle axis is split into ``n`` shards, each shard walks its lanes over
the whole mesh into its own partial flux row ``[n, ...]``, and
``reduce_flux`` sums the rows (the tally all-reduce). The port runs on one
card: a device mesh is a list of torch devices, every entry the same
device, and the shards walk one after the other, each with the port's
walk (``ops/walk_cuda.py``: the walk kernel on the card, the plain walk on
the CPU). Spreading the shards over several cards with NCCL is ROADMAP.md
A9b.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import walk_cuda
from ..ops.walk import TraceResult
from ..utils.platform import resolve_device

PARTICLE_AXIS = "p"


def make_device_mesh(n_devices: int | None = None, device=None) -> list:
    """A 1-D device mesh of ``n_devices`` entries (default 1), every one
    ``device`` (default: the CUDA card; ``"cpu"`` on the CPU)."""
    dev = resolve_device(device)
    return [dev] * (1 if n_devices is None else int(n_devices))


def n_shards(device_mesh) -> int:
    return len(device_mesh)


def _device(device_mesh) -> torch.device:
    devs = {resolve_device(d) for d in device_mesh}
    if len(devs) != 1:
        raise ValueError(
            "the shards run on one device; a mesh over several devices is "
            "ROADMAP.md A9b")
    return devs.pop()


def make_sharded_flux(device_mesh, ntet: int, n_groups: int,
                      dtype=torch.float32, flat: bool = False):
    """Per-shard partial tallies ``[n, ntet, n_groups, 2]``, or with
    ``flat`` ``[n, ntet·n_groups·2]``, zero."""
    nd = n_shards(device_mesh)
    shape = (nd, ntet * n_groups * 2) if flat else (nd, ntet, n_groups, 2)
    return torch.zeros(shape, dtype=dtype, device=_device(device_mesh))


def shard_particles(device_mesh, *arrays):
    """Per-particle arrays (numpy or tensors) on the mesh's device; their
    length must divide by the shard count (pad with parked particles)."""
    dev, nd = _device(device_mesh), n_shards(device_mesh)
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
    weight, group, material_id, flux)`` walks shard k's lanes (the k-th
    block of the particle axis) into ``flux[k]`` (updated in place) and
    returns a TraceResult whose per-lane outputs are concatenated and
    whose flux, segments, iterations and stats carry the shard axis. The
    compaction and unroll knobs schedule the JAX walk only; they are
    ignored. ``n_groups`` defaults to the flux's ``[n, ntet, G, 2]``
    shape."""
    del compact_after, compact_size, unroll
    nd = n_shards(device_mesh)

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


def reduce_flux(sharded_flux: torch.Tensor) -> torch.Tensor:
    """The tally reduction: the per-shard partial slabs summed, shard 0
    first."""
    return sharded_flux.sum(dim=0)
