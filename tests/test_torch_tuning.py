"""The port's autotuner (``pumiumtally_tpu_torch/tuning/``): shape classes,
the database, the facades' consult, the search's parity gate, the CLI and
the calibration join.

Mirrors tests/test_tuning.py case by case on the port's own knobs (the
walk kernel's threads per block in place of the JAX backend and its
``lane_block``; the megastep K), but for its perfdiff case, whose tool
is not ported (ROADMAP.md A14b). On this box the plain walk
stands in for every block width, so a "tuned" run here shows the consult
and the bits; ``tests/test_torch_cuda.py`` runs the widths and the
hardware tuner on the card. Cross-package cases hold ``bucket``,
``classify(...).key()``, ``calibrate_points`` and ``predict_seconds`` to
the JAX functions on the same inputs (fitted floats to 1e-12 relative).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pumiumtally_tpu as jpt
from pumiumtally_tpu.analysis import costmodel as jcost
from pumiumtally_tpu.tuning import shapes as jshapes
from pumiumtally_tpu.tuning.db import env_key as jenv_key
from pumiumtally_tpu_torch import (
    PartitionedTally,
    PumiTally,
    TallyConfig,
    build_box,
)
from pumiumtally_tpu_torch.models.pipeline import StreamingTallyPipeline
from pumiumtally_tpu_torch.ops import walk_cuda
from pumiumtally_tpu_torch.tuning import (
    TUNING_SCHEMA,
    ShapeClass,
    TunedDecision,
    bucket,
    classify,
    empty_db,
    env_key,
    environment,
    load_tuning,
    lookup_tuned,
    write_tuning,
)
from pumiumtally_tpu_torch.tuning import search
from pumiumtally_tpu_torch.tuning.costmodel import (
    NOMINAL_COEFFS,
    calibrate_points,
    predict_seconds,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = environment("cpu")
TINY = dict(cells=2, n_particles=32, n_groups=2)


@pytest.fixture(autouse=True)
def _no_knob_env(monkeypatch):
    for var in ("PUMI_TPU_TUNING", "PUMI_TPU_MEGASTEP",
                "PUMI_TPU_PALLAS_LANE_BLOCK", "PUMI_TPU_KERNEL",
                "PUMI_TPU_TUNE_FAULT"):
        monkeypatch.delenv(var, raising=False)


def _synthetic_db(path, entries, env=None, mode="rehearsal"):
    env = env or CPU
    data = empty_db()
    data["environments"][env_key(env)] = {
        "environment": env, "mode": mode, "entries": entries}
    write_tuning(str(path), data)
    return str(path)


def _mesh(cells=2, dtype=torch.float32):
    return build_box(1.0, 1.0, 1.0, cells, cells, cells, dtype=dtype,
                     device="cpu")


def _seeded(mesh, n, seed=3):
    rng = np.random.default_rng(seed)
    elem = rng.integers(0, mesh.ntet, n)
    return mesh.centroids().numpy().astype(np.float64)[elem]


def _run_moves(mesh, n, cfg, moves=3, seed=11):
    t = PumiTally(mesh, n, cfg, device="cpu")
    t.initialize_particle_location(_seeded(mesh, n).reshape(-1).copy())
    prev = _seeded(mesh, n)
    for i in range(moves):
        rng = np.random.default_rng(seed + i)
        d = rng.normal(0, 1, (n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        buf = np.clip(prev + d * 0.1, 0.01, 0.99).reshape(-1).copy()
        t.move_to_next_location(buf, np.ones(n, np.int8), np.ones(n),
                                np.zeros(n, np.int32),
                                np.full(n, -1, np.int32))
        prev = buf.reshape(n, 3)
    return t


# --------------------------------------------------------------------- #
# Shape classes
# --------------------------------------------------------------------- #
def test_shape_class_bucketing():
    assert bucket(1) == 64 and bucket(64) == 64 and bucket(65) == 128
    sc = classify(48, 1000, 2, torch.float32, True)
    assert sc == ShapeClass(64, 1024, 2, "float32", True)
    assert sc.key() == "ntet64.n1024.g2.float32.packed"
    assert classify(48, 1000, 2, torch.float64, True) != sc
    assert classify(48, 1000, 2, torch.float32, False) != sc


@pytest.mark.parametrize("x", [0, 1, 63, 64, 65, 1000, 998250, 10_110_954])
def test_bucket_matches_jax(x):
    assert bucket(x) == jshapes.bucket(x)


@pytest.mark.parametrize("ntet,n,g,packed", [
    (48, 256, 2, True), (162, 512, 2, False), (998250, 1048576, 8, True),
    (10_110_954, 100, 64, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_classify_key_matches_jax(ntet, n, g, packed, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    assert classify(ntet, n, g, dtype, packed).key() == jshapes.classify(
        ntet, n, g, jdt, packed).key()


# --------------------------------------------------------------------- #
# The database: round trip and refusals
# --------------------------------------------------------------------- #
def test_db_roundtrip(tmp_path):
    sc = classify(48, 256, 2, torch.float32, True)
    path = _synthetic_db(tmp_path / "t.json",
                         {sc.key(): {"block": 64, "megastep": 4}})
    db = load_tuning(path)
    entry = db.lookup(sc, CPU)
    assert entry["block"] == 64 and entry["megastep"] == 4
    assert db.lookup(classify(9999, 256, 2, torch.float32, True), CPU) \
        is None
    assert not list(tmp_path.glob("*.tmp-*"))  # the write was atomic


def test_db_schema_refusal(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"schema": TUNING_SCHEMA + 1,
                             "environments": {}}))
    with pytest.raises(ValueError, match="schema"):
        load_tuning(str(p))
    p2 = tmp_path / "worse.json"
    p2.write_text(json.dumps({"entries": {}}))
    with pytest.raises(ValueError, match="schema"):
        load_tuning(str(p2))


def test_db_cross_environment_refusal(tmp_path):
    card = {"backend": "cuda", "device": "NVIDIA H100 80GB HBM3",
            "n_devices": 1}
    path = _synthetic_db(tmp_path / "card.json", {}, env=card)
    db = load_tuning(path)
    with pytest.raises(ValueError, match="no section for the current"):
        db.section(CPU, strict=True)
    with pytest.raises(ValueError, match="no section for the current"):
        PumiTally(_mesh(), 64, TallyConfig(tuning=path), device="cpu")


def test_jax_tuning_json_refused():
    """The JAX package's committed TUNING.json (sections keyed
    ``cpu-x64off-d1``) is another environment to the port: refused by the
    same cross-environment rule, never read as the port's."""
    path = os.path.join(ROOT, "TUNING.json")
    assert "cpu-x64off-d1" in load_tuning(path).environments
    with pytest.raises(ValueError, match="no section for the current"):
        PumiTally(_mesh(), 64, TallyConfig(tuning=path), device="cpu")


def test_env_keys_never_meet_jax_sections():
    keys = {env_key(CPU), env_key({"backend": "cuda", "device":
                                   "NVIDIA H100 80GB HBM3",
                                   "n_devices": 1})}
    assert keys == {"torch-cpu-d1-cpu", "torch-cuda-d1-NVIDIA-H100-80GB-HBM3"}
    jax_keys = {jenv_key(dict(backend=b, x64=x, n_devices=d))
                for b in ("cpu", "tpu", "gpu", "cuda")
                for x in (False, True) for d in (1, 4, 8)}
    assert not keys & jax_keys


def test_db_section_env_drift_refused(tmp_path):
    data = empty_db()
    data["environments"][env_key(CPU)] = {
        "environment": dict(CPU, n_devices=2), "entries": {}}
    p = tmp_path / "drift.json"
    write_tuning(str(p), data)
    with pytest.raises(ValueError, match="drifted"):
        load_tuning(str(p)).section(CPU)


def test_empty_db_is_all_miss(tmp_path):
    p = tmp_path / "empty.json"
    write_tuning(str(p), empty_db())
    dec = lookup_tuned(str(p), ntet=48, n_particles=64, n_groups=2,
                       dtype=torch.float32, packed=True, device="cpu")
    assert not dec.hit and dec.block is None and dec.megastep is None


# --------------------------------------------------------------------- #
# Knob resolution (no walk)
# --------------------------------------------------------------------- #
def test_resolve_tuning_env_beats_field(monkeypatch):
    cfg, jcfg = (TallyConfig(tuning="/cfg/path.json"),
                 jpt.TallyConfig(tuning="/cfg/path.json"))
    assert cfg.resolve_tuning() == jcfg.resolve_tuning() == "/cfg/path.json"
    monkeypatch.setenv("PUMI_TPU_TUNING", "off")
    assert cfg.resolve_tuning() is None is jcfg.resolve_tuning()
    monkeypatch.setenv("PUMI_TPU_TUNING", "/env/path.json")
    assert cfg.resolve_tuning() == "/env/path.json"
    monkeypatch.delenv("PUMI_TPU_TUNING")
    assert TallyConfig().resolve_tuning() is None


def test_resolve_lane_block_validation(monkeypatch):
    assert TallyConfig().resolve_lane_block(256) is None
    assert TallyConfig(pallas_lane_block=64).resolve_lane_block(256) == 64
    assert TallyConfig(pallas_lane_block=512).resolve_lane_block(80) == 80
    with pytest.raises(ValueError, match="power of two"):
        TallyConfig(pallas_lane_block=100).resolve_lane_block(256)
    with pytest.raises(ValueError, match="power of two"):
        TallyConfig(pallas_lane_block=-8).resolve_lane_block(256)
    monkeypatch.setenv("PUMI_TPU_PALLAS_LANE_BLOCK", "32")
    assert TallyConfig(pallas_lane_block=64).resolve_lane_block(256) == 32


def test_resolve_knobs_precedence_over_db(monkeypatch):
    tuned = TunedDecision(path="x", key="k", hit=True, block=256,
                          megastep=4)
    assert TallyConfig().resolve_lane_block(1024, tuned=tuned) == 256
    assert TallyConfig().resolve_megastep(tuned=tuned) == 4
    assert TallyConfig(pallas_lane_block=64).resolve_lane_block(
        1024, tuned=tuned) == 64
    assert TallyConfig(megastep=2).resolve_megastep(tuned=tuned) == 2
    monkeypatch.setenv("PUMI_TPU_PALLAS_LANE_BLOCK", "512")
    monkeypatch.setenv("PUMI_TPU_MEGASTEP", "16")
    assert TallyConfig(pallas_lane_block=64).resolve_lane_block(
        1024, tuned=tuned) == 512
    assert TallyConfig(megastep=2).resolve_megastep(tuned=tuned) == 16


@pytest.mark.parametrize("value,block", [
    (None, 128), (1, 64), (32, 64), (64, 64), (100, 64), (128, 128),
    (200, 128), (256, 256), (300, 256), (512, 512), (4096, 512)])
def test_block_for_maps_to_a_built_width(value, block):
    assert walk_cuda.block_for(value) == block


@pytest.mark.parametrize("kw", [
    dict(layout=walk_cuda.UNPACKED), dict(layout=walk_cuda.PARTITIONED),
    dict(feature=True), dict(robust=False),
    dict(initial=False, ordered=False)], ids=[
        "unpacked", "partitioned", "feature", "not-robust", "atomic"])
def test_wide_blocks_only_where_built(kw):
    """The widths other than 128 exist for the packed, robust initial
    search and ordered move without feature tails; any other launch at
    such a width raises (no fallback to 128)."""
    base = dict(layout=walk_cuda.PACKED, feature=False, robust=True,
                initial=False, ordered=True)
    for b in walk_cuda.BLOCKS:
        walk_cuda._check_block(b, **base)
    walk_cuda._check_block(128, **dict(base, **kw))
    with pytest.raises(ValueError, match="block width 256"):
        walk_cuda._check_block(256, **dict(base, **kw))
    with pytest.raises(ValueError, match="block must be one of"):
        walk_cuda._check_block(96, **base)


# --------------------------------------------------------------------- #
# The facades' consult at construction
# --------------------------------------------------------------------- #
def test_construction_consumes_db(tmp_path):
    mesh = _mesh()
    n = 256
    sc = classify(mesh.ntet, n, 2, torch.float32, True)
    path = _synthetic_db(tmp_path / "t.json",
                         {sc.key(): {"block": 256, "megastep": 4}})
    t = PumiTally(mesh, n, TallyConfig(tuning=path), device="cpu")
    assert t._tuned.hit and t._tuned.key == sc.key() == t.shape_key
    assert t._lane_block == 256 and t._block == 256
    assert t._walk_kw(False)["block"] == 256
    assert t.config.resolve_megastep(tuned=t._tuned) == 4


def test_db_block_rides_only_built_instantiations(tmp_path):
    """The database's width steers the instantiations built at every
    width; with recorded points, the checks or the non-robust walk the
    facade launches 128 (the JAX block width rides only its kernel)."""
    mesh = _mesh()
    sc = classify(mesh.ntet, 64, 2, torch.float32, True)
    path = _synthetic_db(tmp_path / "t.json",
                         {sc.key(): {"block": 512, "megastep": 1}})
    for kw in (dict(record_xpoints=2), dict(checkify_invariants=True),
               dict(robust=False)):
        t = PumiTally(mesh, 64, TallyConfig(tuning=path, **kw),
                      device="cpu")
        assert t._lane_block == 64  # 512 clamped to the batch of 64
        assert t._block == walk_cuda.DEFAULT_BLOCK


def test_explicit_config_beats_db(tmp_path):
    mesh = _mesh()
    sc = classify(mesh.ntet, 512, 2, torch.float32, True)
    path = _synthetic_db(tmp_path / "t.json",
                         {sc.key(): {"block": 256, "megastep": 4}})
    t = PumiTally(mesh, 512, TallyConfig(tuning=path, pallas_lane_block=64),
                  device="cpu")
    assert t._block == 64
    assert t.config.resolve_megastep(tuned=t._tuned) == 4
    t2 = PumiTally(mesh, 512, TallyConfig(tuning=path, megastep=2),
                   device="cpu")
    assert t2._block == 256
    assert t2.config.resolve_megastep(tuned=t2._tuned) == 2


def test_db_miss_falls_back_to_defaults(tmp_path):
    mesh = _mesh()
    other = classify(99999, 64, 2, torch.float32, True)
    path = _synthetic_db(tmp_path / "t.json",
                         {other.key(): {"block": 512, "megastep": 64}})
    t = PumiTally(mesh, 64, TallyConfig(tuning=path), device="cpu")
    assert t._tuned.path == path and not t._tuned.hit
    assert t._lane_block is None and t._block == 128
    assert t.config.resolve_megastep(tuned=t._tuned) == 1


def test_partitioned_consumes_megastep_only(tmp_path):
    mesh = _mesh(3)
    n = 64
    sc = classify(mesh.ntet, n, 2, torch.float32, packed=False)
    path = _synthetic_db(tmp_path / "t.json",
                         {sc.key(): {"block": 64, "megastep": 4}})
    t = PartitionedTally(mesh, n, TallyConfig(tuning=path), n_parts=4,
                         device="cpu")
    assert t._tuned.hit and t._tuned.block == 64
    assert t.config.resolve_megastep(tuned=t._tuned) == 4


def test_pipeline_classifies_and_consults_per_batch(tmp_path, monkeypatch):
    """The pipeline classifies every submission by its size and consults
    the database for that class's width (the JAX pipeline's per-submit
    consult); the bits are the untuned pipeline's."""
    mesh = _mesh(3, torch.float64)
    small = classify(mesh.ntet, 40, 2, torch.float64, True)
    path = _synthetic_db(tmp_path / "t.json",
                         {small.key(): {"block": 256, "megastep": 1}})
    seen = []
    real = walk_cuda.trace

    def spy(*a, block=walk_cuda.DEFAULT_BLOCK, **kw):
        seen.append(block)
        return real(*a, **kw)

    monkeypatch.setattr(walk_cuda, "trace", spy)
    rng = np.random.default_rng(2)
    batches = []
    for n in (40, 40, 100):
        elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
        o = mesh.centroids().numpy()[elem]
        batches.append((o, np.clip(o + rng.normal(0, 0.2, (n, 3)), 0, 1),
                        elem))
    fluxes = []
    for tuning in (None, path):
        pipe = StreamingTallyPipeline(mesh, TallyConfig(
            dtype=torch.float64, tuning=tuning), depth=2)
        for batch in batches:
            pipe.submit(*batch)
        fluxes.append(pipe.finish())
        assert pipe.shape_keys() == {small.key(): 2, classify(
            mesh.ntet, 100, 2, torch.float64, True).key(): 1}
    # 256 clamped to a batch of 40 maps to 64; the 100-lane class misses.
    assert seen == [128, 128, 128, 64, 64, 128]
    np.testing.assert_array_equal(fluxes[0], fluxes[1])


def test_pipeline_resolves_block_once_per_batch_size(tmp_path,
                                                     monkeypatch):
    """The pipeline classifies every submission but resolves the walk's
    width (the database consult included) once per batch size."""
    from pumiumtally_tpu_torch.models import pipeline as pipeline_mod

    mesh = _mesh(2)
    calls = []
    real = pipeline_mod.resolve_tuned

    def spy(cfg, **kw):
        calls.append(kw["n_particles"])
        return real(cfg, **kw)

    monkeypatch.setattr(pipeline_mod, "resolve_tuned", spy)
    path = _synthetic_db(tmp_path / "t.json", {})
    pipe = StreamingTallyPipeline(mesh, TallyConfig(tuning=path), depth=1)
    rng = np.random.default_rng(4)
    for n in (24, 24, 40, 24, 40):
        elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
        o = mesh.centroids().numpy()[elem]
        pipe.submit(o, np.clip(o + rng.normal(0, 0.2, (n, 3)), 0, 1), elem)
    pipe.finish()
    assert calls == [24, 40]
    assert sum(pipe.shape_keys().values()) == 5


# --------------------------------------------------------------------- #
# Bit identity of tuned runs
# --------------------------------------------------------------------- #
def test_db_miss_and_empty_db_byte_identity(tmp_path):
    mesh = _mesh()
    n = 64
    f_plain = _run_moves(mesh, n, TallyConfig()).raw_flux
    p_empty = tmp_path / "empty.json"
    write_tuning(str(p_empty), empty_db())
    f_empty = _run_moves(mesh, n, TallyConfig(tuning=str(p_empty))).raw_flux
    other = classify(99999, n, 2, torch.float32, True)
    p_miss = _synthetic_db(tmp_path / "miss.json",
                           {other.key(): {"block": 512}})
    f_miss = _run_moves(mesh, n, TallyConfig(tuning=p_miss)).raw_flux
    assert f_plain.tobytes() == f_empty.tobytes() == f_miss.tobytes()


def test_tuned_run_bitwise_identical_to_default(tmp_path):
    mesh = _mesh()
    n = 256
    sc = classify(mesh.ntet, n, 2, torch.float32, True)
    path = _synthetic_db(tmp_path / "t.json",
                         {sc.key(): {"block": 512, "megastep": 4}})
    a = _run_moves(mesh, n, TallyConfig())
    b = _run_moves(mesh, n, TallyConfig(tuning=path))
    assert b._block == 256  # 512 clamped to the batch
    assert a.raw_flux.tobytes() == b.raw_flux.tobytes()
    assert torch.equal(a.state.origin, b.state.origin)


# --------------------------------------------------------------------- #
# The search: parity gate and winners
# --------------------------------------------------------------------- #
def test_parity_gate_rejects_corrupted_candidate(monkeypatch):
    monkeypatch.setenv("PUMI_TPU_TUNE_FAULT", "kernel:cuda:256")
    _, entry = search.tune_shape_class(
        dict(TINY, n_particles=256), mode="rehearsal", reps=1, moves=1,
        mega_moves=1)
    wide = [c for c in entry["candidates"]
            if c["kind"] == "kernel" and c["block"] == 256]
    assert wide and all(c["parity"] == "failed" for c in wide)
    assert entry["block"] == 128
    monkeypatch.delenv("PUMI_TPU_TUNE_FAULT")
    _, clean = search.tune_shape_class(
        dict(TINY, n_particles=256), mode="rehearsal", reps=1, moves=1,
        mega_moves=1)
    assert all(c["parity"] == "bitwise" for c in clean["candidates"])
    assert [c["block"] for c in clean["candidates"]
            if c["kind"] == "kernel"] == [128, 64, 256]


def test_megastep_parity_gate_rejects_corruption(monkeypatch):
    monkeypatch.setenv("PUMI_TPU_TUNE_FAULT", "megastep:4")
    _, entry = search.tune_shape_class(TINY, mode="rehearsal", reps=1,
                                       moves=1, mega_moves=4)
    k4 = [c for c in entry["candidates"]
          if c["kind"] == "megastep" and c["megastep"] == 4]
    assert k4 and k4[0]["parity"] == "failed"
    assert entry["megastep"] == 1


def test_rehearsal_ranks_by_the_model():
    """Every width has the same counts, so the rehearsal keeps 128; the
    megastep's host read a chunk amortizes, so the largest K wins."""
    _, entry = search.tune_shape_class(dict(TINY, n_particles=256),
                                       mode="rehearsal", reps=1, moves=1,
                                       mega_moves=4)
    kern = [c for c in entry["candidates"] if c["kind"] == "kernel"]
    assert len({(c["flops"], c["bytes_accessed"]) for c in kern}) == 1
    assert entry["block"] == 128 and entry["megastep"] == 4
    assert entry["calibration"]["points"] == len(kern)

    def cand(block, s, order, parity="bitwise", times=None):
        return dict(block=block, median_s_per_move=s, order=order,
                    parity=parity, predicted_s_per_move=1.0,
                    times_s_per_move=times or [s])

    # Hardware: a median within TIE_TOL of the reference's keeps the
    # reference; a faster candidate that failed the gate never wins.
    near = [cand(128, 1.0, 0), cand(64, 0.97, 1), cand(256, 0.1, 2, "failed")]
    assert search.pick_winner(near, "hardware")["block"] == 128
    far = [cand(128, 1.0, 0), cand(64, 0.9, 1)]
    assert search.pick_winner(far, "hardware")["block"] == 64
    assert search.pick_winner([cand(64, 1.0, 0, "failed")], "hardware") \
        is None


def _timed(block, order, times):
    return dict(block=block, order=order, parity="bitwise",
                median_s_per_move=float(np.median(times)),
                times_s_per_move=times, predicted_s_per_move=1.0)


_REF = _timed(128, 0, [0.98, 1.0, 1.02])


@pytest.mark.parametrize("cands,block", [
    # A median 10% under the reference's whose slowest rep is not under
    # the reference's fastest: within the reps' spread, no win.
    ([_REF, _timed(64, 1, [0.85, 0.9, 0.99])], 128),
    # Every rep under the reference's fastest, the median 10% under it.
    ([_REF, _timed(64, 1, [0.85, 0.9, 0.97])], 64),
    # Clear of the spread but within TIE_TOL of the reference's median.
    ([_REF, _timed(64, 1, [0.96, 0.965, 0.97])], 128),
    # Two candidates clear of the reference and within TIE_TOL of each
    # other: the canonical order.
    ([_REF, _timed(256, 2, [0.86, 0.88, 0.9]),
      _timed(64, 1, [0.85, 0.9, 0.97])], 64),
], ids=["spread", "clear", "within-tol", "twins"])
def test_hardware_winner_clears_the_reference_spread(cands, block):
    assert search.pick_winner(cands, "hardware")["block"] == block


def test_candidates_timed_in_turns():
    """The timed reps run the candidates forward, then backward."""
    order = []
    runs = [(lambda i=i: (order.append(i), 0.0)) for i in range(3)]
    out = search._timed_in_turns(runs, 3)
    assert order == [0, 1, 2, 2, 1, 0, 0, 1, 2]
    assert [len(r) for r in out] == [3, 3, 3]


# --------------------------------------------------------------------- #
# The CLI: determinism across fresh processes and the drift check
# --------------------------------------------------------------------- #
def _tune_cli(args, timeout=120):
    env = dict(os.environ)
    env.pop("PUMI_TPU_TUNING", None)
    return subprocess.run(
        [sys.executable, "-m", "pumiumtally_tpu_torch.tuning",
         "--mode", "rehearsal", "--shapes", "t=2:64:2", "--moves", "1",
         "--reps", "1", "--mega-moves", "4", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT,
    )


def test_tuner_deterministic_across_processes_and_check_gate(tmp_path):
    out = str(tmp_path / "t.json")
    r1 = _tune_cli(["--out", out])
    assert r1.returncode == 0, r1.stderr
    r2 = _tune_cli(["--check", out])
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert "tuning check clean" in r2.stdout
    data = json.load(open(out))
    sec = next(iter(data["environments"].values()))
    key, entry = next(iter(sec["entries"].items()))
    entry["megastep"] = 999
    json.dump(data, open(out, "w"))
    r3 = _tune_cli(["--check", out])
    assert r3.returncode == 1
    assert "tuning drift" in r3.stdout and key in r3.stdout


# --------------------------------------------------------------------- #
# Calibration (tuning/costmodel.py), against the JAX functions
# --------------------------------------------------------------------- #
def test_calibrate_points_recovers_coefficients():
    F, B = 1e12, 2e11
    pts = [dict(flops=f, bytes_accessed=b, seconds=f / F + b / B)
           for f, b in [(1e9, 2e8), (5e9, 4e8), (2e10, 8e9), (1e8, 6e9)]]
    cal = calibrate_points(pts)
    assert cal["points"] == 4
    assert abs(cal["flops_per_s"] - F) / F < 1e-6
    assert abs(cal["bytes_per_s"] - B) / B < 1e-6
    assert cal["rmse_s"] < 1e-9
    m = dict(flops=3e9, bytes_accessed=5e8)
    assert abs(predict_seconds(m, cal) - (3e9 / F + 5e8 / B)) < 1e-9


def test_calibrate_points_degenerate_falls_back():
    pts = [dict(flops=1e9, bytes_accessed=2e8, seconds=s)
           for s in (0.01, 0.011, 0.009)]
    cal = calibrate_points(pts)
    assert cal is not None
    assert (cal["flops_per_s"] is None) != (cal["bytes_per_s"] is None)
    assert predict_seconds(dict(flops=1e9, bytes_accessed=2e8), cal) > 0
    assert calibrate_points([]) is None


def test_nominal_predict_orders_dispatch_amortization():
    m = dict(flops=1e9, bytes_accessed=1e8)
    t1 = predict_seconds(m, NOMINAL_COEFFS, dispatches=1.0)
    t16 = predict_seconds(m, NOMINAL_COEFFS, dispatches=1.0 / 16)
    assert t16 < t1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_calibrate_and_predict_match_jax(seed):
    rng = np.random.default_rng(seed)
    k = [4, 3, 1, 5][seed]
    pts = [dict(flops=float(f), bytes_accessed=float(b), seconds=float(s))
           for f, b, s in zip(rng.uniform(1e8, 1e10, k),
                              rng.uniform(1e7, 1e9, k),
                              rng.uniform(1e-4, 1e-2, k))]
    if seed == 1:  # identical signatures: the single-term fallback
        pts = [dict(pts[0], seconds=p["seconds"]) for p in pts]
    cal, jcal = calibrate_points(pts), jcost.calibrate_points(pts)
    assert cal.keys() == jcal.keys() and cal["points"] == jcal["points"]
    for f in ("flops_per_s", "bytes_per_s", "rmse_s"):
        if jcal[f] is None:
            assert cal[f] is None
        else:
            assert cal[f] == pytest.approx(jcal[f], rel=1e-12, abs=0)
    m = dict(flops=2e9, bytes_accessed=3e8)
    for coeffs in (cal, NOMINAL_COEFFS):
        assert predict_seconds(m, coeffs, dispatches=3.0) == pytest.approx(
            jcost.predict_seconds(m, coeffs, dispatches=3.0), rel=1e-12)
    assert NOMINAL_COEFFS == jcost.NOMINAL_COEFFS


# --------------------------------------------------------------------- #
# The committed database
# --------------------------------------------------------------------- #
def test_committed_tuning_db_schema():
    """TUNING_TORCH.json parses under the current schema and carries the
    CPU rehearsal section of smoke1 and smoke2 with parity-clean
    candidates and a calibration per entry."""
    db = load_tuning(os.path.join(ROOT, "TUNING_TORCH.json"))
    sec = db.section(CPU)
    assert sec is not None and sec["mode"] == "rehearsal"
    names = {e["spec_name"] for e in sec["entries"].values()}
    assert {"smoke1", "smoke2"} <= names
    for key, entry in sec["entries"].items():
        spec = search.SPECS[entry["spec_name"]]
        assert key == classify(6 * spec["cells"] ** 3, spec["n_particles"],
                               spec["n_groups"], torch.float32, True).key()
        assert entry["block"] in walk_cuda.BLOCKS and entry["megastep"] >= 1
        assert [c for c in entry["candidates"] if c["parity"] == "bitwise"]
        assert entry["calibration"] is not None


def test_astlint_covers_tuner_scripts():
    # The tuner's CLI (the port's tune.py) gets the value-safety subset
    # and the tuning package every rule: pin that both stay clean under
    # the port's lint and its baseline (PUMI001/004/005: host syncs on
    # the move loop, the global random state, float64; and the package
    # rules, whose only tuning entries are search.py's set-up transfers).
    from pumiumtally_tpu_torch.analysis import apply_baseline, load_baseline
    from pumiumtally_tpu_torch.analysis.astlint import lint_sources

    src = {}
    for rel in ("tuning/__main__.py", "tuning/search.py", "tuning/db.py",
                "tuning/shapes.py", "tuning/costmodel.py",
                "tuning/__init__.py"):
        path = f"pumiumtally_tpu_torch/{rel}"
        src[path] = open(os.path.join(ROOT, path)).read()
    entries = load_baseline(os.path.join(ROOT, "LINT_BASELINE_TORCH.json"))
    kept, _, _ = apply_baseline(lint_sources(src), entries)
    assert kept == [], [f.render() for f in kept]
