"""The port's device-sourced move loop (``PumiTally.run_source_moves``,
``ops/walk.py::megastep``) on ``device="cpu"``.

Mirrors the single-chip cases of tests/test_megastep.py:

* megastep-K bit for bit K megastep-1 (flux, per-lane state, counters;
  the absorbed weight within rtol 1e-5 across chunkings, as there), in
  both dtypes and io_pipeline modes, and consecutive calls chaining like
  one call;
* the transfers in ``tally.io``: a steady-state chunk makes no
  host→device copy (the JAX facade makes one, the move counter, which is
  a kernel argument here) and one device→host copy (the tail); re-staged
  lanes count in the chunk that stages them;
* convergence and telemetry through the fused loop, the knob's
  resolution and refusals, inputs never mutated, SyntheticTransport's
  default mode, the pipeline's ``submit_source`` and its all-dead rule.

Against the JAX package (two JAX megastep programs, one a dtype, on the
jittered two-region 4^3 box of tests/test_megastep.py): the port's move
body fed the JAX draws reproduces each JAX move per lane (elements,
materials, alive flags and groups equal; positions and weights within
1e-12 in float64, 1e-5 in float32; flux within 1e-10 relative per bin in
float64, queue C's sliver allowance in float32; counters equal), and the
whole ``run_source_moves(4, SRC)`` agrees the same way with the port's
own draws.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.ops import source as jsource
from pumiumtally_tpu_torch import PumiTally, TallyConfig
from pumiumtally_tpu_torch.models.pipeline import StreamingTallyPipeline
from pumiumtally_tpu_torch.models.transport import (
    Material,
    SyntheticTransport,
)
from pumiumtally_tpu_torch.ops import source, walk
from torch_twins import JDT, TOL, twin_meshes

N = 64
MOVES = 4
SRC_KW = dict(sigma_t={1: 4.0, 2: 9.0}, absorption={1: 0.3, 2: 0.5},
              survival_weight=0.2, seed=13)
SRC = source.SourceParams(**SRC_KW)
PHYS = ("collisions", "escaped", "rouletted", "alive", "truncated")


@pytest.fixture(scope="module")
def meshes():
    """(JAX, port) meshes per dtype: the jittered two-region 4^3 box of
    tests/test_megastep.py (regions 1 and 2 split at x = 0.5)."""
    return {dt: twin_meshes(dt, nx=4, jitter=0.2, seed=11, classes=(1, 2))
            for dt in (torch.float32, torch.float64)}


def _pos(seed=3):
    return np.random.default_rng(seed).uniform(0.1, 0.9, (N, 3))


def _tally(pmesh, dtype=torch.float64, **kw):
    kw.setdefault("tolerance", 1e-8)
    t = PumiTally(pmesh, N, TallyConfig(n_groups=2, dtype=dtype, **kw),
                  device="cpu")
    t.initialize_particle_location(_pos().ravel().copy())
    return t


def _state(t):
    s = t.state
    out = {f: getattr(s, f).numpy().copy() for f in (
        "origin", "elem", "material_id", "weight", "group", "in_flight")}
    out["flux"] = t.raw_flux
    return out


def _assert_out_equal(oa, ob):
    for f in ("moves", "segments") + PHYS:
        assert oa[f] == ob[f], f
    assert np.isclose(oa["absorbed_weight"], ob["absorbed_weight"],
                      rtol=1e-5)


# --------------------------------------------------------------------- #
# Bitwise identity: megastep-K against K megastep-1
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("io", [
    pytest.param("legacy", marks=pytest.mark.slow), "packed", "overlap"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_megastep_k_bitwise(meshes, dtype, io):
    pmesh = meshes[dtype][1]
    w0 = np.random.default_rng(5).uniform(0.5, 2.0, N)
    g0 = np.random.default_rng(6).integers(0, 2, N).astype(np.int32)

    def run(k):
        t = _tally(pmesh, dtype, tolerance=1e-6, io_pipeline=io, megastep=k)
        return t, t.run_source_moves(MOVES, SRC, weights=w0, groups=g0)

    a, oa = run(1)
    b, ob = run(2)
    _assert_out_equal(oa, ob)
    sa, sb = _state(a), _state(b)
    for name in sa:
        np.testing.assert_array_equal(sb[name], sa[name], err_msg=name)
    assert a.total_segments == b.total_segments
    assert a.iter_count == b.iter_count == MOVES


def test_consecutive_calls_chain_bitwise(meshes):
    pmesh = meshes[torch.float64][1]
    a = _tally(pmesh, megastep=2)
    a.run_source_moves(4, SRC, weights=np.ones(N))
    b = _tally(pmesh, megastep=2)
    b.run_source_moves(2, SRC, weights=np.ones(N))
    b.run_source_moves(2, SRC)
    sa, sb = _state(a), _state(b)
    for name in sa:
        np.testing.assert_array_equal(sb[name], sa[name], err_msg=name)


def test_chunk_transfers(meshes):
    """A steady chunk: 0 H2D (the move counter is a kernel argument) and
    1 D2H (the tail). Given lanes are staged in the chunk that stages
    them, one copy each; the telemetry totals count the same."""
    t = _tally(meshes[torch.float64][1], megastep=2, convergence=True,
               batch_moves=2)
    io0 = dict(t.io)
    t.run_source_moves(2, SRC, weights=np.ones(N),
                       groups=np.zeros(N, np.int32), alive=np.ones(N, bool))
    assert t.io["h2d_transfers"] - io0["h2d_transfers"] == 3
    assert t.io["d2h_transfers"] - io0["d2h_transfers"] == 1
    tot0, io0 = t.telemetry()["totals"], dict(t.io)
    t.run_source_moves(4, SRC)
    tot1 = t.telemetry()["totals"]
    assert t.io["h2d_transfers"] - io0["h2d_transfers"] == 0
    assert t.io["d2h_transfers"] - io0["d2h_transfers"] == 2  # 2 chunks
    assert tot1["h2d_transfers"] - tot0["h2d_transfers"] == 0
    assert tot1["d2h_transfers"] - tot0["d2h_transfers"] == 2
    assert tot1["moves"] - tot0["moves"] == 4
    assert tot1["segments"] > tot0["segments"]


def test_megastep_convergence_parity(meshes):
    def run(k):
        t = _tally(meshes[torch.float64][1], megastep=k, convergence=True,
                   batch_moves=2)
        t.run_source_moves(MOVES, SRC, weights=np.ones(N))
        return t

    a, b = run(1), run(4)
    ca, cb = a.telemetry()["convergence"], b.telemetry()["convergence"]
    assert ca["n_batches"] == cb["n_batches"] == 2
    for f in ("scored", "rel_err_mean", "rel_err_max",
              "converged_fraction"):
        assert ca[f] == cb[f], f
    np.testing.assert_array_equal(a.relative_error(), b.relative_error())


def test_megastep_batch_sd_k_bitwise(meshes):
    """sd_mode='batch' folds one squared bin total per fused move."""
    def run(k):
        t = _tally(meshes[torch.float64][1], megastep=k, sd_mode="batch")
        t.run_source_moves(MOVES, SRC, weights=np.ones(N))
        return t.raw_flux

    a, b = run(1), run(3)
    np.testing.assert_array_equal(a, b)
    assert (a[..., 1] > 0).any()


def test_megastep_telemetry_records(meshes):
    t = _tally(meshes[torch.float64][1], megastep=2)
    out = t.run_source_moves(MOVES, SRC, weights=np.ones(N))
    tm = t.telemetry()
    recs = [r for r in tm["per_move"] if r["kind"] == "megastep"]
    assert len(recs) == 2
    assert all(r["moves"] == 2 for r in recs)
    assert tm["totals"]["moves"] == MOVES
    assert tm["totals"]["segments"] == out["segments"]
    assert sum(r["collisions"] for r in recs) == out["collisions"]
    assert recs[-1]["alive"] == out["alive"]


def test_early_stop_when_all_dead(meshes):
    t = _tally(meshes[torch.float64][1], megastep=3)
    out = t.run_source_moves(300, SRC, weights=np.ones(N))
    assert out["alive"] == 0
    assert out["moves"] < 300 and out["moves"] % 3 == 0
    assert t.iter_count == out["moves"]


# --------------------------------------------------------------------- #
# Knob semantics, refusals, inputs never mutated
# --------------------------------------------------------------------- #
def test_resolve_megastep_knob(monkeypatch):
    assert TallyConfig().resolve_megastep() == 1
    assert TallyConfig(megastep=4).resolve_megastep() == 4
    monkeypatch.setenv("PUMI_TPU_MEGASTEP", "8")
    assert TallyConfig(megastep=4).resolve_megastep() == 8
    monkeypatch.delenv("PUMI_TPU_MEGASTEP")
    with pytest.raises(ValueError, match="megastep"):
        TallyConfig(megastep=0).resolve_megastep()


@pytest.mark.parametrize("kw,match", [
    (dict(record_xpoints=4), "record_xpoints"),
    (dict(checkify_invariants=True), "checkify_invariants"),
])
def test_megastep_refuses_debug_surfaces_like_jax(meshes, kw, match):
    for cfg in (TallyConfig(megastep=2, **kw),
                jpt.TallyConfig(megastep=2, **kw)):
        with pytest.raises(ValueError, match=match):
            cfg.resolve_megastep()
    t = _tally(meshes[torch.float64][1], **kw)
    with pytest.raises(ValueError, match=match):
        t.run_source_moves(1, SRC)


def test_run_source_moves_refuses_explicit_pallas(meshes, monkeypatch):
    """kernel='pallas' written into the config is refused as in the JAX
    facade; 'auto' and an env-forced 'pallas' run (the port's one
    walk)."""
    pmesh = meshes[torch.float64][1]
    with pytest.raises(NotImplementedError, match="pallas"):
        _tally(pmesh, kernel="pallas").run_source_moves(1, SRC)
    _tally(pmesh, kernel="auto").run_source_moves(1, SRC)
    monkeypatch.setenv("PUMI_TPU_KERNEL", "pallas")
    a = _tally(pmesh, megastep=2)
    assert a._kernel_policy == "xla"
    a.run_source_moves(2, SRC)


def test_run_source_moves_needs_initialization(meshes):
    t = PumiTally(meshes[torch.float64][1], N, TallyConfig(
        dtype=torch.float64), device="cpu")
    with pytest.raises(RuntimeError, match="initialize_particle_location"):
        t.run_source_moves(1, SRC)


@pytest.mark.parametrize("io", ["packed", "legacy"])
def test_inputs_never_mutated(meshes, io):
    """The facade reads, never writes, its weights and groups, in a move
    and in a source run."""
    pmesh = meshes[torch.float64][1]
    rng = np.random.default_rng(0)
    t = _tally(pmesh, io_pipeline=io)
    w = rng.uniform(0.5, 2.0, N)
    g = rng.integers(0, 2, N).astype(np.int32)
    a = rng.uniform(size=N) < 0.5
    w0, g0, a0 = w.copy(), g.copy(), a.copy()
    t.move_to_next_location(rng.uniform(0.1, 0.9, (N, 3)),
                            np.ones(N, np.int8), w, g,
                            np.full(N, -1, np.int32))
    t.run_source_moves(2, SRC, weights=w, groups=g, alive=a)
    np.testing.assert_array_equal(w, w0)
    np.testing.assert_array_equal(g, g0)
    np.testing.assert_array_equal(a, a0)


def test_transport_megastep_default(meshes):
    pmesh = meshes[torch.float64][1]
    t = PumiTally(pmesh, 48, TallyConfig(n_groups=2, dtype=torch.float64,
                                         tolerance=1e-8), device="cpu")
    d = SyntheticTransport(t, materials={1: Material(4.0, 0.4),
                                         2: Material(8.0, 0.6)},
                           seed=3, max_events=100)
    assert d.mode == "megastep"
    stats = d.run(batches=1)
    assert stats.batches == 1 and stats.events > 0
    assert stats.collisions > 0 and stats.absorbed_weight > 0
    assert stats.boundary_escapes + stats.roulette_kills > 0
    flux = t.raw_flux
    cid = pmesh.class_id.numpy()
    assert flux[cid == 1, :, 0].sum() > 0
    assert flux[cid == 2, :, 0].sum() > 0
    assert flux[:, 1, 0].sum() > 0


# --------------------------------------------------------------------- #
# The pipeline's device-sourced batches
# --------------------------------------------------------------------- #
def _pipe_run(pmesh, n_moves, depth=1, seeds=(1,)):
    pipe = StreamingTallyPipeline(pmesh, TallyConfig(
        n_groups=2, dtype=torch.float64, tolerance=1e-8), depth=depth)
    cents = pmesh.centroids().numpy()
    rng = np.random.default_rng(0)
    for seed in seeds:
        e = rng.integers(0, pmesh.ntet, N).astype(np.int32)
        pipe.submit_source(cents[e], e, n_moves, source.SourceParams(
            sigma_t={1: 5.0, 2: 5.0}, seed=seed))
    flux = pipe.finish()
    return flux, list(pipe.results())


def test_pipeline_drain_all_done_requires_dead(meshes):
    pmesh = meshes[torch.float64][1]
    _, (short,) = _pipe_run(pmesh, 1)
    assert short.physics["alive"] > 0 and not short.all_done
    _, (full,) = _pipe_run(pmesh, 200)
    assert full.physics["alive"] == 0
    assert full.all_done == (full.physics["truncated"] == 0)


def test_pipeline_submit_source(meshes):
    pmesh = meshes[torch.float64][1]
    flux, rs = _pipe_run(pmesh, 3, depth=2, seeds=(0, 1))
    assert flux[..., 0].sum() > 0
    assert [r.index for r in rs] == [0, 1]
    for r in rs:
        assert r.physics is not None and r.physics["collisions"] >= 0
        assert r.n_segments > 0 and r.stats["segments"] == r.n_segments
        assert r.position.shape == (N, 3) and r.elem.shape == (N,)
    # The pipeline's batch is the megastep from move 0 of its own seed:
    # the same batch alone gives the same bits.
    flux1, (r1,) = _pipe_run(pmesh, 3, seeds=(0,))
    np.testing.assert_array_equal(r1.position, rs[0].position)
    assert r1.physics == rs[0].physics


# --------------------------------------------------------------------- #
# Against the JAX package
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_runs(meshes):
    """Per dtype: the JAX facade's state before and after each of MOVES
    single-move ``run_source_moves`` calls (megastep=1: one JAX megastep
    program a dtype), and its counters."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        jmesh = meshes[dtype][0]
        jt = jpt.PumiTally(jmesh, N, jpt.TallyConfig(
            n_groups=2, dtype=JDT[dtype], tolerance=1e-6, megastep=1))
        jt.initialize_particle_location(_pos().ravel().copy())
        w0 = np.random.default_rng(5).uniform(0.5, 2.0, N)
        g0 = np.random.default_rng(6).integers(0, 2, N).astype(np.int32)
        jsrc = jsource.SourceParams(**SRC_KW)
        states, outs = [_jax_state(jt)], []
        for m in range(MOVES):
            kw = dict(weights=w0, groups=g0) if m == 0 else {}
            outs.append(jt.run_source_moves(1, jsrc, **kw))
            states.append(_jax_state(jt))
        out[dtype] = dict(states=states, outs=outs, w0=w0, g0=g0)
    return out


def _jax_state(jt):
    s = jt.state
    d = {f: np.array(getattr(s, f)) for f in (
        "origin", "elem", "material_id", "weight", "group", "in_flight",
        "particle_id")}
    d["flux"] = np.array(jt.raw_flux).reshape(-1)
    return d


def _flux_atol(dtype, weight):
    """Queue C's float32 sliver allowance (the position tolerance times the
    largest weight), none in float64 but the parity bar's."""
    pos_tol, _, atol = TOL[dtype]
    return atol if dtype == torch.float64 else pos_tol * float(weight.max())


def _assert_state_close(got, want, dtype, label):
    pos_tol, rtol, _ = TOL[dtype]
    for f in ("elem", "material_id", "in_flight", "group"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{label} {f}")
    np.testing.assert_allclose(got["origin"], want["origin"], rtol=0,
                               atol=pos_tol, err_msg=f"{label} origin")
    np.testing.assert_allclose(got["weight"], want["weight"], rtol=0,
                               atol=pos_tol, err_msg=f"{label} weight")
    np.testing.assert_allclose(
        got["flux"], want["flux"], rtol=rtol,
        atol=_flux_atol(dtype, want["weight"]), err_msg=f"{label} flux")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_move_body_fed_jax_draws_matches_jax(meshes, jax_runs, dtype):
    """Each JAX move, replayed from the JAX state before it through the
    port's megastep body with the JAX draws fed in."""
    run = jax_runs[dtype]
    pmesh = meshes[dtype][1]
    sig, ab = SRC.tables(pmesh.class_id.numpy())
    sig_t, ab_t = (torch.as_tensor(a, dtype=dtype) for a in (sig, ab))
    eps = source.near_epsilon(pmesh.coords)
    for m in range(MOVES):
        before, after = run["states"][m], run["states"][m + 1]
        if m == 0:
            before = dict(before, weight=run["w0"].astype(before["weight"]
                                                          .dtype),
                          group=run["g0"])
        t = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in before.items()}
        d = jsource.sample_move(jax.random.PRNGKey(SRC.seed), m,
                                jnp.asarray(before["particle_id"]), N,
                                JDT[dtype])
        draws = [tuple(torch.from_numpy(np.array(a)) for a in d)]
        flux = t["flux"].clone()
        r = walk.megastep(
            pmesh, t["origin"], t["elem"], t["material_id"], t["weight"],
            t["group"], t["in_flight"], t["particle_id"], flux, m,
            source.prng_key(SRC.seed), sig_t, ab_t, n_moves=1, n_groups=2,
            survival_weight=SRC.survival_weight,
            downscatter=SRC.downscatter, eps_near=eps,
            max_crossings=pmesh.ntet + 64, tolerance=1e-6, draws=draws)
        got = dict(origin=r.position.numpy(), elem=r.elem.numpy(),
                   material_id=r.material_id.numpy(),
                   weight=r.weight.numpy(), group=r.group.numpy(),
                   in_flight=r.alive.numpy(), flux=r.flux.numpy())
        _assert_state_close(got, after, dtype, f"move {m}")
        from pumiumtally_tpu_torch.ops.staging import split_megastep_tail

        tail, _, _, phys = split_megastep_tail(r.readback, dtype, True,
                                               False, False)
        p = source.phys_to_dict(phys)
        want = run["outs"][m]
        for f in PHYS:
            assert p[f] == want[f], (m, f)
        assert int(tail[6]) == want["segments"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_run_source_moves_matches_jax(meshes, jax_runs, dtype):
    """The port's whole run, its own draws (uniforms bitwise, directions
    and lengths within ulps of JAX's), against the JAX run: no lane in
    this data leaves the bounds through a libm ulp, so the discrete state
    is equal."""
    run = jax_runs[dtype]
    t = _tally(meshes[dtype][1], dtype, tolerance=1e-6, megastep=2)
    out = t.run_source_moves(MOVES, SRC, weights=run["w0"],
                             groups=run["g0"])
    got = _state(t)
    got["flux"] = got["flux"].reshape(-1)
    got["in_flight"] = got.pop("in_flight")
    _assert_state_close(got, run["states"][-1], dtype, "run")
    for f in PHYS:
        want = (run["outs"][-1][f] if f == "alive"
                else sum(o[f] for o in run["outs"]))
        assert out[f] == want, f
    assert out["segments"] == sum(o["segments"] for o in run["outs"])
    np.testing.assert_allclose(
        out["absorbed_weight"],
        sum(o["absorbed_weight"] for o in run["outs"]), rtol=1e-6)
