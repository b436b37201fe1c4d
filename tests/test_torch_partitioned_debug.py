"""The partitioned facade's debug surfaces other than the recorded points
(tests/test_torch_partitioned_xpoints.py), on the CPU.

Mirrors the JAX ``PartitionedTally``'s handling in
pumiumtally_tpu/parallel/partitioned_api.py: ``checkify_invariants`` is a
host check (``_check_finite``: the initial positions, each move's
destinations and weights must be finite; the JAX step takes no checkify
flag), ``sort_by_element`` is accepted and read by no partitioned
module, and both ``record_xpoints`` and ``checkify_invariants`` force
``io_pipeline="legacy"``, whose step carries the points (the packed-I/O
step refuses them), as tests/test_io_pipeline.py :282-287 pins for the
configuration.

Checks: each refusal raises the JAX facade's ValueError, message for
message, and leaves the tally as it was; a clean checked run and a
sorted run give the plain run's flux, positions and elements bitwise.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.parallel.partitioned_api import (
    PartitionedTally as JPartitionedTally,
)
from pumiumtally_tpu_torch import PartitionedTally, TallyConfig
from pumiumtally_tpu_torch.ops import walk_partitioned as pwp
from pumiumtally_tpu_torch.parallel.mesh_partition import partition_mesh
from pumiumtally_tpu_torch.parallel.particle_sharding import make_device_mesh
from torch_twins import twin_meshes

N = 48


@pytest.fixture(scope="module")
def meshes():
    return twin_meshes(torch.float64, nx=4, classes=(1, 2))


def _inputs(seed=4, moves=2):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.05, 0.95, (N, 3))
    moves_in = [(rng.uniform(0.05, 0.95, (N, 3)), rng.uniform(0.5, 2.0, N),
                 rng.integers(0, 2, N).astype(np.int32))
                for _ in range(moves)]
    return src, moves_in


def _run(t, src, moves_in):
    t.initialize_particle_location(src.ravel().copy())
    outs = []
    for dest, w, g in moves_in:
        buf, mats = dest.ravel().copy(), np.zeros(N, np.int32)
        t.move_to_next_location(buf, np.ones(N, np.int8), w, g, mats)
        outs.append((buf, mats))
    return outs


def _port(pm, **cfg):
    return PartitionedTally(pm, N, TallyConfig(dtype=torch.float64,
                                               n_groups=2, tolerance=1e-8,
                                               **cfg),
                            n_parts=4, halo_layers=1, device="cpu")


def _assert_same_run(a, b, outs_a, outs_b):
    for (pa, ma), (pb, mb) in zip(outs_a, outs_b):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ma, mb)
    np.testing.assert_array_equal(a.raw_flux, b.raw_flux)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.elem_global, b.elem_global)


def test_checkify_clean_run_keeps_the_bits(meshes):
    _, pm = meshes
    src, moves_in = _inputs()
    plain = _port(pm)
    checked = _port(pm, checkify_invariants=True)
    _assert_same_run(checked, plain, _run(checked, src, moves_in),
                     _run(plain, src, moves_in))
    assert checked._io == "legacy"


@pytest.mark.parametrize("where", ["init_particle_positions",
                                   "particle_destinations", "weights"])
def test_checkify_refuses_non_finite_like_jax(meshes, where):
    """A NaN initial position, destination or weight raises the JAX
    facade's ValueError before anything walks; the port's tally is left
    as it was."""
    jm, pm = meshes
    src, moves_in = _inputs(moves=1)
    dest, w, g = moves_in[0]
    src, dest, w = src.copy(), dest.copy(), w.copy()
    {"init_particle_positions": src, "particle_destinations": dest,
     "weights": w}[where][3] = np.nan
    msgs = []
    for t in (_port(pm, checkify_invariants=True),
              JPartitionedTally(jm, N, jpt.TallyConfig(
                  dtype=jnp.float64, n_groups=2, tolerance=1e-8,
                  checkify_invariants=True), n_parts=4, halo_layers=1)):
        if where == "init_particle_positions":
            with pytest.raises(ValueError) as e:
                t.initialize_particle_location(src.ravel().copy())
            msgs.append(str(e.value))
            continue
        t.initialize_particle_location(_inputs()[0].ravel().copy())
        before = np.array(t.raw_flux), np.array(t.positions)
        with pytest.raises(ValueError) as e:
            t.move_to_next_location(dest.ravel().copy(), np.ones(N, np.int8),
                                    w, g, np.zeros(N, np.int32))
        msgs.append(str(e.value))
        np.testing.assert_array_equal(np.array(t.raw_flux), before[0])
        np.testing.assert_array_equal(np.array(t.positions), before[1])
    assert msgs[0] == msgs[1] == f"{where} contains non-finite values"


def test_sort_by_element_has_no_effect(meshes):
    """sort_by_element (with a migration period of one move) changes no
    bit: no partitioned module reads it."""
    _, pm = meshes
    src, moves_in = _inputs()
    plain = _port(pm)
    sorted_ = _port(pm, sort_by_element=True, migration_period=1)
    _assert_same_run(sorted_, plain, _run(sorted_, src, moves_in),
                     _run(plain, src, moves_in))
    assert sorted_._io == plain._io == "packed"


@pytest.mark.parametrize("cfg", [dict(record_xpoints=4),
                                 dict(checkify_invariants=True),
                                 dict(record_xpoints=4, io_pipeline="overlap")])
def test_debug_surfaces_force_legacy(meshes, cfg):
    """Both surfaces force io_pipeline="legacy", as the JAX
    configuration does, and the facade builds the unpacked-I/O step."""
    _, pm = meshes
    t = _port(pm, **cfg)
    assert t._io == "legacy"
    assert TallyConfig(**cfg).resolve_io_pipeline() == "legacy"
    assert jpt.TallyConfig(**cfg).resolve_io_pipeline() == "legacy"
    t.initialize_particle_location(_inputs()[0].ravel().copy())
    assert list(t._steps) == [(True, False)]


def test_packed_step_refuses_record_xpoints_like_jax(meshes):
    """The packed-I/O step refuses the points with the JAX step's
    NotImplementedError text."""
    from pumiumtally_tpu.ops import walk_partitioned as jwp
    from pumiumtally_tpu.parallel.mesh_partition import (
        partition_mesh as jpartition,
    )
    from pumiumtally_tpu.parallel.particle_sharding import (
        make_device_mesh as jdevice_mesh,
    )

    jm, pm = meshes
    msgs = []
    with pytest.raises(NotImplementedError) as e:
        jwp.make_partitioned_step(jdevice_mesh(2), jpartition(jm, 2),
                                  n_groups=2, record_xpoints=4,
                                  packed_io=True)
    msgs.append(str(e.value))
    with pytest.raises(NotImplementedError) as e:
        pwp.make_partitioned_step(make_device_mesh(2, "cpu"),
                                  partition_mesh(pm, 2), n_groups=2,
                                  record_xpoints=4, packed_io=True)
    msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
