"""The port's compaction-ladder planner (``utils/ladder.py``) and the
schedules the facades resolve with it, against the JAX package.

Mirrors tests/test_ladder.py case by case on the port's own copy, and holds
the copy to the JAX functions on the same numpy inputs: ``survivors``,
``exp_survivors``, ``simulate_ladder``, ``plan_stages``, ``dense_ladder``
and ``TallyConfig.resolve_compact_stages`` equal exactly. The port's
single-device walk ignores a schedule, so the counterpart of the JAX
ladder's bit-identity test is that planned schedules leave ``PumiTally``
bitwise unchanged; ``PartitionedTally`` hands its schedule to the step,
which is held to the JAX step with the same schedule at the tolerances of
tests/test_torch_mesh_partition.py. The adaptive replan is checked
against JAX's ``plan_stages`` over the port's own measured crossings (the
JAX facade's run is not repeated here).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pumiumtally_tpu as jpt
from pumiumtally_tpu.utils import ladder as jladder
from pumiumtally_tpu.utils.config import dense_ladder as jdense_ladder
from pumiumtally_tpu_torch import (
    PartitionedTally,
    PumiTally,
    TallyConfig,
    build_box,
)
from pumiumtally_tpu_torch.models.pipeline import StreamingTallyPipeline
from pumiumtally_tpu_torch.ops.walk_partitioned import (
    normalize_compact_stages,
)
from pumiumtally_tpu_torch.utils.config import dense_ladder
from pumiumtally_tpu_torch.utils.ladder import (
    exp_survivors,
    plan_stages,
    simulate_ladder,
    survivors,
)
from test_torch_partitioned_budget import (
    _assert_steps_agree,
    _batch,
    _jax_step,
    _port_step,
)
from torch_twins import twin_meshes

M = 1048576
# The JAX package's hardware grid of three schedules and its measured
# ms a step (tests/test_ladder.py); only their order matters here.
GRID = {
    "default_r2": (((16, M // 2), (24, M // 4), (40, M // 8)), 3437.9),
    "dense": (
        ((8, 5 * M // 8), (16, 3 * M // 8), (24, M // 4), (32, M // 8),
         (48, M // 16), (64, M // 32), (96, M // 64)),
        2188.8,
    ),
    "dp_r250k": (
        ((16, M // 2), (24, M // 4), (40, M // 8), (48, M // 16),
         (56, M // 32), (76, 8192)),
        2400.1,
    ),
}
ROUND_COST = 1.3 * M


def _score(stages, act):
    slots, rounds = simulate_ladder(act, M, stages, unroll=8)
    return slots + ROUND_COST * rounds


# --------------------------------------------------------------------- #
# Mirrors of tests/test_ladder.py
# --------------------------------------------------------------------- #
def test_simulator_reproduces_hardware_ranking():
    act = exp_survivors(M, 14.9)
    scores = {k: _score(v[0], act) for k, v in GRID.items()}
    meas = {k: v[1] for k, v in GRID.items()}
    assert sorted(scores, key=scores.get) == sorted(meas, key=meas.get)


def test_simulator_on_measured_counts_matches_analytic_family():
    rng = np.random.default_rng(0)
    counts = rng.exponential(14.9, 65536).astype(int)
    act_m = survivors(counts) * (M / 65536)
    act_a = exp_survivors(M, 14.9)
    for sched, _ in GRID.values():
        sm, sa = _score(sched, act_m), _score(sched, act_a)
        assert abs(sm - sa) / sa < 0.15, (sched, sm, sa)


def test_planner_beats_dense_under_executional_score():
    act = exp_survivors(M, 14.9)
    planned = plan_stages(M, 14.9)
    assert planned
    assert _score(planned, act) <= _score(dense_ladder(M), act)


def test_planner_adapts_to_mesh_density():
    bench = plan_stages(M, 14.9)
    coarse = plan_stages(65536, 3.3)
    denser = plan_stages(M, 32.6)
    assert coarse
    assert coarse[-1][0] < bench[-1][0] < denser[-1][0]
    for s in (bench, coarse, denser):  # valid by the step's own rules
        normalize_compact_stages(s, None, None, M, M // 8)


def test_config_plan_mode_resolves_and_scales():
    cfg = TallyConfig(compact_stages="plan")
    sched = cfg.resolve_compact_stages(M, ntet=998250)
    assert sched and all(len(s) >= 2 for s in sched)
    sched10m = cfg.resolve_compact_stages(M, ntet=10_110_954)
    assert sched10m[-1][0] > sched[-1][0]
    auto = TallyConfig(compact_stages="auto")
    a1 = auto.resolve_compact_stages(M, ntet=998250)
    assert a1 == dense_ladder(M)
    a10 = auto.resolve_compact_stages(M, ntet=10_110_954)
    assert a10[0][0] > a1[0][0]
    assert [w for _, w in a10] == [w for _, w in a1]


def _drive(mesh, n, cfg, moves=2, seed=4, length=0.3):
    t = PumiTally(mesh, n, cfg, device="cpu")
    rng = np.random.default_rng(seed)
    cents = mesh.centroids().numpy().astype(np.float64)
    pos = cents[rng.integers(0, mesh.ntet, n)]
    t.initialize_particle_location(pos.reshape(-1).copy())
    prev = pos.copy()
    segs = []
    for _ in range(moves):
        d = rng.normal(0, 1, (n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        buf = np.clip(prev + d * rng.exponential(length, (n, 1)), 0.01,
                      0.99).reshape(-1).copy()
        before = t.total_segments
        t.move_to_next_location(buf, np.ones(n, np.int8), np.ones(n),
                                np.zeros(n, np.int32),
                                np.full(n, -1, np.int32))
        segs.append(t.total_segments - before)
        prev = buf.reshape(n, 3)
    return t, segs


@pytest.mark.parametrize("stages", ["plan", "auto"])
def test_planned_schedule_walk_is_bit_identical(stages):
    """The single-device walk refills its threads and ignores the
    schedule: a planned (or dense) ladder leaves PumiTally bitwise."""
    mesh = build_box(1.0, 1.0, 1.0, 6, 6, 6, device="cpu")
    n = 2048
    flat, _ = _drive(mesh, n, TallyConfig(n_groups=2))
    ladd, _ = _drive(mesh, n, TallyConfig(n_groups=2, compact_stages=stages))
    assert ladd._compact_stages and flat._compact_stages is None
    np.testing.assert_array_equal(flat.raw_flux, ladd.raw_flux)
    assert torch.equal(flat.state.origin, ladd.state.origin)
    assert flat.total_segments == ladd.total_segments


def test_adaptive_mode_replans_from_measured_crossings():
    """compact_stages='adaptive' replans after the first move from the
    measured crossings a move: the schedule JAX's planner makes from the
    port's first-move segments, different from the density-only plan and
    ending later (long moves); the flux is the 'plan' run's, bitwise."""
    mesh = build_box(1.0, 1.0, 1.0, 6, 6, 6, dtype=torch.float64,
                     device="cpu")
    n = 2048
    cfg = dict(dtype=torch.float64, n_groups=2)
    t_plan, _ = _drive(mesh, n, TallyConfig(compact_stages="plan", **cfg),
                       length=0.8)
    t_adapt, segs = _drive(mesh, n,
                           TallyConfig(compact_stages="adaptive", **cfg),
                           length=0.8)
    assert t_adapt._replanned and t_plan._replanned
    want = jladder.plan_stages(n, max(segs[0] / n - 1.0, 0.25), unroll=8)
    assert t_adapt._compact_stages == (tuple(want) or None)
    sched_a, sched_p = t_adapt._compact_stages, t_plan._compact_stages
    assert sched_a != sched_p
    assert sched_a[-1][0] > sched_p[-1][0]
    np.testing.assert_array_equal(t_adapt.raw_flux, t_plan.raw_flux)


def test_adaptive_mode_rejected_where_it_cannot_replan():
    """PartitionedTally and the pipeline refuse 'adaptive' with the JAX
    facades' messages."""
    from pumiumtally_tpu.models.pipeline import (
        StreamingTallyPipeline as JaxPipeline,
    )
    from pumiumtally_tpu.parallel.partitioned_api import (
        PartitionedTally as JaxPartitioned,
    )

    mesh = build_box(1.0, 1.0, 1.0, 3, 3, 3, dtype=torch.float64,
                     device="cpu")
    jmesh = jpt.build_box(1.0, 1.0, 1.0, 3, 3, 3, dtype=jnp.float64)
    cfg = TallyConfig(dtype=torch.float64, compact_stages="adaptive")
    jcfg = jpt.TallyConfig(dtype=jnp.float64, compact_stages="adaptive")
    for port, ref in (
        (lambda: PartitionedTally(mesh, 64, cfg, n_parts=8, device="cpu"),
         lambda: JaxPartitioned(jmesh, 64, jcfg, n_parts=8)),
        (lambda: StreamingTallyPipeline(mesh, config=cfg),
         lambda: JaxPipeline(jmesh, config=jcfg)),
    ):
        with pytest.raises(NotImplementedError, match="adaptive") as want:
            ref()
        with pytest.raises(NotImplementedError) as got:
            port()
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------------- #
# The port's copy against the JAX functions
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [256, 4096, M])
def test_dense_ladder_matches_jax(n):
    assert dense_ladder(n) == jdense_ladder(n)


@pytest.mark.parametrize("seed", [0, 1])
def test_survivors_match_jax(seed):
    counts = np.random.default_rng(seed).exponential(9.0, 5000).astype(int)
    np.testing.assert_array_equal(survivors(counts),
                                  jladder.survivors(counts))
    np.testing.assert_array_equal(survivors(counts, kmax=20),
                                  jladder.survivors(counts, kmax=20))


@pytest.mark.parametrize("mean", [0.1, 3.3, 14.9])
def test_exp_survivors_match_jax(mean):
    np.testing.assert_array_equal(exp_survivors(4096, mean),
                                  jladder.exp_survivors(4096, mean))


@pytest.mark.parametrize("name", sorted(GRID))
def test_simulate_ladder_matches_jax(name):
    act = exp_survivors(M, 14.9)
    sched = GRID[name][0]
    assert simulate_ladder(act, M, sched) == jladder.simulate_ladder(
        act, M, sched)
    assert simulate_ladder(act, M, sched, round_cost=ROUND_COST) == \
        jladder.simulate_ladder(act, M, sched, round_cost=ROUND_COST)


@pytest.mark.parametrize("n,mean", [(128, 3.0), (2048, 5.0), (65536, 3.3),
                                    (M, 14.9)])
def test_plan_stages_matches_jax(n, mean):
    assert plan_stages(n, mean) == jladder.plan_stages(n, mean)


def test_plan_stages_from_counts_matches_jax():
    counts = np.random.default_rng(3).exponential(6.0, 4096).astype(int)
    assert plan_stages(4096, 0.0, counts=counts) == jladder.plan_stages(
        4096, 0.0, counts=counts)


@pytest.mark.parametrize("ntet", [998250, 10_110_954])
@pytest.mark.parametrize("stages", ["auto", "plan",
                                    ((16, 300000), (40, 2048, 4))],
                         ids=["auto", "plan", "explicit"])
def test_resolve_compact_stages_matches_jax(stages, ntet):
    port = TallyConfig(compact_stages=stages).resolve_compact_stages(
        M, ntet=ntet)
    ref = jpt.TallyConfig(compact_stages=stages).resolve_compact_stages(
        M, ntet=ntet)
    assert port == ref and port
    # Below 1024 lanes both leave the flat loop.
    assert TallyConfig(compact_stages=stages).resolve_compact_stages(
        1000, ntet=ntet) is None


# --------------------------------------------------------------------- #
# The partitioned facade and step with a planned schedule
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [96, 1024])
@pytest.mark.parametrize("stages", ["plan", "auto"])
def test_partitioned_planned_schedule_bitwise(stages, n):
    """PartitionedTally with a planned (or dense) schedule, on a 3^3 box:
    the search and one move bitwise equal to the default run (at 1024
    lanes the schedule is real; below 1024 it resolves to none)."""
    mesh = build_box(1.0, 1.0, 1.0, 3, 3, 3, dtype=torch.float64,
                     device="cpu")
    rng = np.random.default_rng(7)
    pos = rng.uniform(0.1, 0.9, (n, 3))
    dest = np.clip(pos + rng.normal(0, 0.3, (n, 3)), 0.01, 0.99)
    runs = []
    for cs in (None, stages):
        t = PartitionedTally(mesh, n, TallyConfig(
            dtype=torch.float64, compact_stages=cs), n_parts=4,
            device="cpu")
        assert (t._step_kwargs["compact_stages"] is not None) == (
            cs is not None and n >= 1024)
        t.initialize_particle_location(pos.reshape(-1).copy())
        buf = dest.reshape(-1).copy()
        t.move_to_next_location(buf, np.ones(n, np.int8), np.ones(n),
                                np.zeros(n, np.int32),
                                np.full(n, -1, np.int32))
        runs.append((buf, t.raw_flux))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_partitioned_step_with_planned_schedule_matches_jax():
    """The port's step with a schedule from the planner, held to JAX
    make_partitioned_step with the same schedule (float64, 4 parts)."""
    dtype = torch.float64
    jm, pm = twin_meshes(dtype, nx=4, classes=(1, 2))
    batch = _batch(pm, seed=9)
    sched = plan_stages(len(batch[0]), 3.0)
    assert sched and sched == jladder.plan_stages(len(batch[0]), 3.0)
    jres = _jax_step(jm, 4, batch, dtype, max_crossings=6,
                     compact_stages=sched)
    res = _port_step(pm, 4, batch, dtype, max_crossings=6,
                     compact_stages=sched)
    _assert_steps_agree(res, jres, dtype)
