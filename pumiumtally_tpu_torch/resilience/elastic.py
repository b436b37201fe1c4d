"""Elastic mesh-shrink recovery: continue the run on the survivors.

Own copy of ``pumiumtally_tpu/resilience/elastic.py``. A lost chip costs
one rollback: the partitioned state is layout independent (the flux is
kept assembled in global element order when it changes layout, the
particle state in particle order), and ``parallel/mesh_partition.py``
accepts any part count, so the last good state restores onto a fresh
``PartitionedTally`` built over the surviving entries of the device mesh
(``utils/checkpoint.py``). The rebuilt facade builds its steps for the
new layout and the run continues: physics-equal to an uninterrupted run
at the shrunk part count (a same-layout rollback stays bitwise).

The verdicts come from ``resilience/coordinator.py``; when to shrink and
what generation to roll to is ``ResilientRunner``'s.
"""
from __future__ import annotations


def surviving_devices(tally, health: dict[int, bool]) -> list:
    """The entries of the tally's device mesh a probe found alive, mesh
    order kept."""
    return [d for i, d in enumerate(tally.device_mesh)
            if health.get(i, True)]


def rebuild_on_devices(tally, devices: list):
    """A fresh ``PartitionedTally`` over ``devices`` with the source
    tally's mesh, config, halo depth, per-part capacity, migration bounds
    and device, the same global mesh re-partitioned onto the new part
    count. The telemetry (registry and flight records) moves over, so
    the counters keep one history across the shrink. The caller restores
    the state into the result (``utils/checkpoint.restore_state``
    re-slabs the flux; the megastep's slot state re-distributes on the
    next chunk)."""
    if not devices:
        raise ValueError(
            "elastic recovery needs at least one surviving device")
    from ..parallel.particle_sharding import mesh_from_devices
    from ..parallel.partitioned_api import PartitionedTally

    return PartitionedTally(
        tally.mesh,
        tally.num_particles,
        tally.config,
        device_mesh=mesh_from_devices(devices),
        halo_layers=tally.partition.halo_layers,
        cap=tally.cap,
        exchange_size=tally._step_kwargs["exchange_size"],
        max_rounds=tally._step_kwargs["max_rounds"],
        telemetry=tally._telemetry,
        device=tally.device,
    )
