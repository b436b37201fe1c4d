"""The port's serving layer on the CPU: the library bank's bookkeeping and
the scheduler (``pumiumtally_tpu_torch/serving/{bank,scheduler,saturate}.py``).

Mirrors tests/test_serving.py on a 2x2x2 box, jobs of 40 and 100
particles (64 and 128 padded) and at most 6 moves:

* the bank: entry keys follow the source and the flags, sections follow
  the environment, and toy libraries (no nvcc here) go through the
  load-time validation: a warm hit, and torn, stale and unloadable
  entries named, rebuilt and rewritten; ``PUMI_TPU_AOT_FAULT=torn``; a
  fresh process over a filled bank builds nothing; META records the
  symbols, ptxas's counts, the flags and nvcc;
* the scheduler: request validation, padding onto the ladder, flux served
  bitwise the uninterrupted facade run for two shape classes, round-robin
  admission and quanta, checkpoint preemption bitwise, convergence
  eviction, the metrics and their Prometheus text.

Against the JAX package: the shape keys, the synthetic requests' origins
(bitwise) and their journal documents are equal, and one served job's
flux agrees with the JAX facade's ``run_source_moves`` of the same padded
request (1e-10 relative per bin in float64; float32 within queue C's
sliver allowance, tests/test_torch_megastep.py).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.ops.source import SourceParams as JaxSourceParams
from pumiumtally_tpu.serving import synthetic_requests as jax_requests
from pumiumtally_tpu.serving.journal import request_to_json as jax_to_json
from pumiumtally_tpu.tuning.shapes import bucket as jax_bucket
from pumiumtally_tpu.tuning.shapes import classify as jax_classify
from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
from pumiumtally_tpu_torch.ops import _build
from pumiumtally_tpu_torch.ops.source import SourceParams
from pumiumtally_tpu_torch.serving import (
    JobRequest,
    TallyScheduler,
    run_saturation,
    synthetic_requests,
)
from pumiumtally_tpu_torch.serving import bank as bank_mod
from pumiumtally_tpu_torch.serving.journal import request_to_json
from pumiumtally_tpu_torch.tuning.shapes import bucket, classify
from torch_serving_twins import padded, solo_reference, toy_bank
from torch_twins import JDT, TOL, twin_meshes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBS = bank_mod.FACADE_LIBRARIES


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in (
        "PUMI_TPU_MEGASTEP", "PUMI_TPU_KERNEL", "PUMI_TPU_IO_PIPELINE",
        "PUMI_TPU_TUNING", "PUMI_TPU_AOT_FAULT", "PUMI_TPU_PROM_PORT",
        "PUMI_TPU_FAULTS", "PUMI_TPU_TRACE",
    ):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def mesh():
    return build_box(1.0, 1.0, 1.0, 2, 2, 2, device="cpu")


def _cfg(**kw):
    return TallyConfig(tolerance=1e-6, **kw)


def _causes(bank):
    return sorted(f["cause"] for f in bank.findings)


# --------------------------------------------------------------------- #
# The library bank
# --------------------------------------------------------------------- #
def test_entry_key_tracks_source_and_flags(tmp_path, monkeypatch):
    b = toy_bank(tmp_path / "bank")
    key = b.entry_key("walk")
    assert key == "walk-" + os.path.basename(
        _build.library_path("walk"))[len("libwalk-"):-3]
    assert key == b.entry_key("walk")
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", str(src))
    assert b.entry_key("walk") == key
    with open(src / "walk.cu", "a") as f:
        f.write("\n// edited\n")
    assert b.entry_key("walk") != key
    scatter = b.entry_key("scatter")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert b.entry_key("scatter") != scatter


def test_bank_section_is_environment_keyed(tmp_path):
    b = toy_bank(tmp_path)
    assert b.section == bank_mod.section_key() == "torch-cpu-d1-cpu"
    assert b.section_dir == os.path.join(str(tmp_path), b.section)
    assert b.entries_on_disk() == []


def test_validate_loaded_toy_libraries(tmp_path):
    """A filled bank is pure hits; a torn library, a stale META and a
    library missing a bound symbol are each named, rebuilt, rewritten,
    and then load clean."""
    cold = toy_bank(tmp_path)
    paths = cold.libraries(LIBS)
    assert (cold.misses, cold.hits, cold.rewrites) == (3, 0, 0)
    assert cold.compile_seconds > 0
    assert sorted(e.split("-")[0] for e in cold.entries_on_disk()) == \
        sorted(LIBS)
    assert all(p.startswith(cold.section_dir) for p in paths)
    assert cold.libraries(LIBS) == paths  # memoized: no second count
    assert cold.misses == 3
    warm = toy_bank(tmp_path)
    assert warm.libraries(LIBS) == paths
    assert (warm.misses, warm.hits, warm.rewrites) == (0, 3, 0)
    assert warm.compile_seconds == 0.0 and warm.findings == []
    # torn: the library's bytes; stale: the META's environment;
    # unloadable: a library (with its sha256 recorded) lacking a symbol.
    with open(paths[0], "r+b") as f:
        f.seek(5)
        f.write(b"X")
    meta = os.path.join(os.path.dirname(paths[1]), bank_mod.META_FILE)
    doc = json.load(open(meta))
    doc["environment"] = dict(doc["environment"], device="other card")
    json.dump(doc, open(meta, "w"))
    meta = os.path.join(os.path.dirname(paths[2]), bank_mod.META_FILE)
    with open(paths[2], "wb") as f:
        f.write(b"toy pumi_sample_flight_f32")
    doc = json.load(open(meta))
    doc["library_sha256"] = bank_mod.sha256_file(paths[2])
    json.dump(doc, open(meta, "w"))
    hurt = toy_bank(tmp_path)
    assert hurt.libraries(LIBS) == paths
    assert (hurt.misses, hurt.hits, hurt.rewrites) == (0, 0, 3)
    assert _causes(hurt) == ["stale", "torn", "unloadable"]
    byentry = {f["entry"].split("-")[0]: f for f in hurt.findings}
    assert byentry["source"]["message"].endswith(
        "undefined symbol: pumi_sample_flight_f64")
    text = hurt.registry.render_prometheus()
    for cause in ("stale", "torn", "unloadable"):
        assert f'pumi_aot_rewrites_total{{cause="{cause}"}} 1' in text
    assert [r["outcome"] for r in hurt.recorder.records()
            if r["kind"] == "aot"] == ["torn", "stale", "unloadable"]
    clean = toy_bank(tmp_path)
    clean.libraries(LIBS)
    assert (clean.hits, clean.rewrites, clean.findings) == (3, 0, [])
    # A META that does not parse is torn too.
    with open(meta, "w") as f:
        f.write("{not json")
    torn = toy_bank(tmp_path)
    torn.library("source")
    assert _causes(torn) == ["torn"] and torn.rewrites == 1


def test_meta_records_symbols_ptxas_flags_and_nvcc(tmp_path):
    b = toy_bank(tmp_path)
    path = b.library("walk")
    meta = json.load(open(os.path.join(os.path.dirname(path),
                                       bank_mod.META_FILE)))
    assert meta["schema"] == bank_mod.BANK_SCHEMA
    assert meta["environment"] == bank_mod.environment()
    assert meta["source_sha256"] == _build.source_digest("walk")
    assert meta["flags"] == list(_build.NVCC_FLAGS)
    assert meta["nvcc"] == _build.nvcc_version()
    assert meta["library_sha256"] == bank_mod.sha256_file(path)
    assert meta["symbols"] == _build.bound_symbols("walk") == [
        "pumi_lanes_f32", "pumi_lanes_f64", "pumi_walk_f32",
        "pumi_walk_f64", "pumi_walk_resident_f32", "pumi_walk_resident_f64",
    ]
    assert meta["ptxas"] == [
        "_Z4walkILi128EEvv: 0 bytes spill stores, 0 bytes spill loads",
        "_Z4walkILi128EEvv: Used 64 registers",
    ]
    assert meta["build_seconds"] >= 0 and meta["built_together"] == ["walk"]
    assert "pumi_bucket_count" in _build.bound_symbols("scatter")


def test_load_refuses_a_second_path_and_bind_an_unlisted_symbol(
        monkeypatch, tmp_path):
    """A process holds one copy of a library: asking ``_build.load`` for
    another path of a name already loaded raises (a bank's entry is never
    silently answered by the package's build), the same path is answered
    by the copy loaded; ``bind`` binds only what the wrapper lists."""
    loaded = object()
    first = tmp_path / "a" / "libwalk.so"
    monkeypatch.setattr(_build, "_libs", {"walk": loaded})
    monkeypatch.setattr(_build, "_paths", {"walk": str(first)})
    assert _build.load("walk") is loaded
    assert _build.load("walk", path=str(first)) is loaded
    assert _build.loaded_path("walk") == str(first)
    with pytest.raises(RuntimeError, match="cannot also load"):
        _build.load("walk", path=str(tmp_path / "b" / "libwalk.so"))
    with pytest.raises(KeyError, match="pumi_walk_f16"):
        _build.bind("walk", "pumi_walk_f16", ("pumi_walk_f32",))


def test_bank_resolution_spans_land_in_the_bound_trace(tmp_path):
    """A resolution is one ``aot_resolve`` span (and an ``aot_compile``
    span when it builds) under the caller's bound parent, as in the JAX
    bank, and one ``aot`` flight record a library naming the bound
    job."""
    from pumiumtally_tpu_torch.obs import SpanTracer

    tracer = SpanTracer(enabled=True)
    bank = toy_bank(tmp_path, tracer=tracer)
    tid = SpanTracer.new_trace()
    with tracer.bind(tid, "j0", "admit-1"):
        bank.libraries(LIBS)
    with tracer.bind(tid, "j0", "admit-2"):
        toy_bank(tmp_path, tracer=tracer).libraries(LIBS)
    spans = {(r["name"], r["parent_id"]): r for r in tracer.records()}
    cold = spans[("aot_resolve", "admit-1")]
    assert cold["outcome"] == "miss,miss,miss" and cold["trace_id"] == tid
    assert spans[("aot_compile", "admit-1")]["job_id"] == "j0"
    assert spans[("aot_resolve", "admit-2")]["outcome"] == "hit,hit,hit"
    recs = [r for r in bank.recorder.records() if r["kind"] == "aot"]
    assert [r["outcome"] for r in recs] == ["miss"] * 3
    assert {r["job_id"] for r in recs} == {"j0"}


def test_aot_fault_writes_a_torn_entry(tmp_path, monkeypatch):
    monkeypatch.setenv(bank_mod.ENV_FAULT, "torn")
    poisoned = toy_bank(tmp_path)
    poisoned.libraries(LIBS)
    assert poisoned.misses == 3 and poisoned.rewrites == 0
    monkeypatch.delenv(bank_mod.ENV_FAULT)
    validator = toy_bank(tmp_path)
    validator.libraries(LIBS)
    assert _causes(validator) == ["torn"]
    assert validator.findings[0]["entry"].startswith(LIBS[0])
    assert (validator.hits, validator.rewrites) == (2, 1)
    clean = toy_bank(tmp_path)
    clean.libraries(LIBS)
    assert (clean.hits, clean.findings) == (3, [])
    monkeypatch.setenv(bank_mod.ENV_FAULT, "drop_donation")
    with pytest.raises(ValueError, match="torn"):
        toy_bank(tmp_path)


_WARM_SCRIPT = """
import hashlib, json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from pumiumtally_tpu_torch import TallyConfig, build_box
from pumiumtally_tpu_torch.serving import run_saturation
from pumiumtally_tpu_torch.serving.bank import FACADE_LIBRARIES
from torch_serving_twins import toy_bank
mesh = build_box(1.0, 1.0, 1.0, 2, 2, 2, device="cpu")
bank = toy_bank({bank!r})
bank.libraries(FACADE_LIBRARIES)
out = run_saturation(mesh, TallyConfig(tolerance=1e-6), bank=bank, n_jobs=2,
                     class_sizes=(40, 100), n_moves=4, seed=5,
                     max_resident=2, quantum_moves=2, device="cpu")
print(json.dumps({{
    "stats": bank.stats(),
    "hashes": {{k: hashlib.sha256(v.tobytes()).hexdigest()
               for k, v in sorted(out["results"].items())}},
    "outcomes": out["scheduler"]["outcomes"],
}}))
"""


def test_warm_subprocess_builds_nothing(mesh, tmp_path):
    """A fresh process over a filled bank resolves every library from its
    entries (no miss, no build second) and serves the same bits."""
    bank_dir = str(tmp_path / "bank")
    toy_bank(bank_dir).libraries(LIBS)
    out = run_saturation(mesh, _cfg(), bank=toy_bank(bank_dir), n_jobs=2,
                         class_sizes=(40, 100), n_moves=4, seed=5,
                         max_resident=2, quantum_moves=2, device="cpu")
    want = {k: hashlib.sha256(v.tobytes()).hexdigest()
            for k, v in sorted(out["results"].items())}
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PUMI_TPU_")}
    proc = subprocess.run(
        [sys.executable, "-c", _WARM_SCRIPT.format(
            root=ROOT, tests=os.path.join(ROOT, "tests"), bank=bank_dir)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["stats"]["misses"] == 0, got["stats"]
    assert got["stats"]["rewrites"] == 0, got["stats"]
    assert got["stats"]["hits"] == 3, got["stats"]
    assert got["stats"]["compile_seconds"] == 0.0, got["stats"]
    assert got["hashes"] == want
    assert got["outcomes"] == {"completed": 2}


def test_bank_facade_bitwise_and_telemetry(mesh, tmp_path):
    """A facade given a bank computes the same bits (on the CPU it runs
    no library, so the bank resolves none) and reports it under "aot"."""
    bank = toy_bank(tmp_path)
    req = synthetic_requests(mesh, 1, class_sizes=(40,), n_moves=4,
                             seed=7)[0]
    ref = solo_reference(mesh, req, 2, _cfg())
    origins, w, g, alive = padded(req)
    t = PumiTally(mesh, 64, _cfg(megastep=2), device="cpu",
                  program_bank=bank)
    t.initialize_particle_location(origins.reshape(-1).copy())
    t.run_source_moves(4, req.source, weights=w, groups=g, alive=alive)
    assert t.raw_flux.tobytes() == ref.tobytes()
    assert t.telemetry()["aot"] == bank.stats()
    assert bank.stats()["entries"] == 0 and bank.entries_on_disk() == []
    t.close()
    t.close()
    assert "aot" not in PumiTally(mesh, 4, _cfg(), device="cpu").telemetry()


# --------------------------------------------------------------------- #
# The scheduler
# --------------------------------------------------------------------- #
def test_scheduler_request_validation(mesh, tmp_path):
    sched = TallyScheduler(mesh, _cfg(), max_resident=1, device="cpu")
    with pytest.raises(ValueError, match="at least one particle"):
        sched.submit(JobRequest(origins=np.zeros((0, 3)), n_moves=4))
    with pytest.raises(ValueError, match="n_moves"):
        sched.submit(JobRequest(origins=np.zeros((4, 3)), n_moves=0))
    sched.submit(JobRequest(origins=np.zeros((4, 3)), n_moves=1,
                            job_id="a"))
    with pytest.raises(ValueError, match="duplicate"):
        sched.submit(JobRequest(origins=np.zeros((4, 3)), n_moves=1,
                                job_id="a"))
    with pytest.raises(ValueError, match="weights has 8"):
        sched.submit(JobRequest(
            origins=np.zeros((4, 3)), n_moves=1, weights=np.ones(8),
        ))
    with pytest.raises(ValueError, match="groups has 2"):
        sched.submit(JobRequest(
            origins=np.zeros((4, 3)), n_moves=1,
            groups=np.zeros(2, np.int32),
        ))
    with pytest.raises(ValueError, match="journal-safe"):
        sched.submit(JobRequest(origins=np.zeros((4, 3)), n_moves=1,
                                job_id="../x"))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        TallyScheduler(mesh, _cfg(), preempt_after=1, device="cpu")
    sched.close()


def test_job_padding_lands_on_the_tuning_ladder(mesh):
    sched = TallyScheduler(mesh, _cfg(), device="cpu")
    jid = sched.submit(JobRequest(origins=np.full((40, 3), 0.5), n_moves=2))
    job = sched.job(jid)
    assert job.padded_n == bucket(40) == 64
    assert job.shape_key == classify(mesh.ntet, 64, 2, torch.float32,
                                     True).key()
    sched.close()
    # The JAX ladder and keys, for every size and both dtypes.
    for n in (1, 40, 64, 65, 100, 786432):
        assert bucket(n) == jax_bucket(n)
        for dt in (torch.float32, torch.float64):
            assert classify(mesh.ntet, bucket(n), 8, dt, True).key() == \
                jax_classify(mesh.ntet, bucket(n), 8, JDT[dt], True).key()


def test_served_flux_bitwise_per_shape_class(mesh):
    """Scheduler-served flux equals the job's uninterrupted facade run,
    bit for bit, for every job across two shape classes."""
    cfg = _cfg()
    out = run_saturation(mesh, cfg, n_jobs=4, class_sizes=(40, 100),
                         n_moves=6, seed=3, max_resident=2,
                         quantum_moves=2, device="cpu")
    reqs = synthetic_requests(mesh, 4, class_sizes=(40, 100), n_moves=6,
                              seed=3)
    keys = set()
    for req, row in zip(reqs, out["per_job"]):
        ref = solo_reference(mesh, req, 2, cfg)
        assert out["results"][row["job"]].tobytes() == ref.tobytes(), row
        keys.add(row["shape_key"])
    assert len(keys) == 2
    assert out["jobs_per_sec"] > 0


def test_scheduler_round_robin_fairness(mesh):
    cfg = _cfg()
    sched = TallyScheduler(mesh, cfg, max_resident=2, quantum_moves=2,
                           device="cpu")
    cents = mesh.centroids().numpy().astype(np.float64)
    sizes = (40, 40, 100)
    ids = [sched.submit(JobRequest(
        origins=np.broadcast_to(cents[0], (n, 3)), n_moves=6,
        source=SourceParams(seed=100 + i), job_id=f"j{i}",
    )) for i, n in enumerate(sizes)]
    sched.run()
    sched.close()
    recs = sched.recorder.records()
    admitted = [r["job"] for r in recs if r["kind"] == "job_admitted"]
    assert admitted[0] == "j0" and admitted[1] == "j2"
    quanta = [r["job"] for r in recs if r["kind"] == "quantum"]
    assert quanta[0:2] == ["j0", "j2"] and quanta[2:4] == ["j0", "j2"]
    assert all(sched.job(i).outcome == "completed" for i in ids)
    for i, jid in enumerate(ids):
        req = JobRequest(origins=np.broadcast_to(cents[0], (sizes[i], 3)),
                         n_moves=6, source=SourceParams(seed=100 + i))
        assert sched.result(jid).tobytes() == solo_reference(
            mesh, req, 2, cfg).tobytes()


def test_preemption_resume_is_bitwise_replay(mesh, tmp_path):
    cfg = _cfg()
    sched = TallyScheduler(
        mesh, cfg, bank=str(tmp_path / "bank"), max_resident=1,
        quantum_moves=2, preempt_after=1, checkpoint_dir=str(tmp_path / "ck"),
        device="cpu",
    )
    reqs = synthetic_requests(mesh, 2, class_sizes=(40,), n_moves=6,
                              seed=11)
    ids = [sched.submit(r) for r in reqs]
    sched.run()
    sched.close()
    assert [j for j in sched.jobs() if j.preemptions > 0]
    assert sched.stats()["preemptions"] >= 1
    for req, jid in zip(reqs, ids):
        job = sched.job(jid)
        assert job.outcome == "completed" and job.checkpoint is None
        assert sched.result(jid).tobytes() == solo_reference(
            mesh, req, 2, cfg).tobytes()
    assert os.listdir(tmp_path / "ck") == []


def test_converged_job_evicts_early(mesh):
    cfg = _cfg(convergence=True, rel_err_target=1e6,
               converged_fraction=0.1)
    sched = TallyScheduler(mesh, cfg, max_resident=1, quantum_moves=2,
                           device="cpu")
    req = synthetic_requests(mesh, 1, class_sizes=(40,), n_moves=30,
                             seed=2)[0]
    jid = sched.submit(req)
    sched.run()
    sched.close()
    job = sched.job(jid)
    assert job.outcome == "converged" and job.moves_done < 30
    assert sched.stats()["outcomes"] == {"converged": 1}


def test_serving_metrics_and_prometheus_render(mesh, tmp_path):
    out = run_saturation(mesh, _cfg(), bank=toy_bank(tmp_path), n_jobs=2,
                         class_sizes=(40,), n_moves=4, seed=9,
                         max_resident=2, quantum_moves=2, device="cpu")
    assert out["jobs_per_sec"] > 0
    assert out["scheduler"]["outcomes"].get("completed") == 2
    assert out["scheduler"]["aot"]["root"] == str(tmp_path)
    # A bank given as a path shares the scheduler's registry.
    sched = TallyScheduler(mesh, _cfg(), bank=str(tmp_path),
                           max_resident=1, quantum_moves=2, device="cpu")
    assert sched.bank.registry is sched.registry
    sched.bank._build_fn = toy_bank(tmp_path)._build_fn
    sched.bank._loader = toy_bank(tmp_path)._loader
    sched.bank.libraries(LIBS)
    jid = sched.submit(JobRequest(origins=np.full((40, 3), 0.5), n_moves=2,
                                  source=SourceParams(seed=1)))
    sched.run()
    text = sched.registry.render_prometheus()
    sched.close()
    assert sched.job(jid).outcome == "completed"
    for family in (
        "pumi_jobs_total", "pumi_queue_depth", "pumi_quanta_total",
        "pumi_aot_hits_total", "pumi_aot_misses_total",
        "pumi_compile_seconds_total", "pumi_job_seconds",
        "pumi_job_device_seconds", "pumi_job_time_to_first_quantum_seconds",
    ):
        assert family in text, family
    assert 'pumi_jobs_total{outcome="completed"} 1' in text
    assert "pumi_aot_misses_total 3" in text
    kinds = [r["kind"] for r in sched.recorder.records()]
    assert "job_submitted" in kinds and "job_done" in kinds
    assert "quantum" in kinds and "aot" in kinds
    stats = sched.stats()
    assert stats["quanta"] == 1 and stats["aot"]["entries"] == 3


def test_pipeline_batchresult_carries_shape_key(mesh):
    from pumiumtally_tpu_torch.models.pipeline import StreamingTallyPipeline

    pipe = StreamingTallyPipeline(mesh, _cfg(), depth=1)
    cents = mesh.centroids().numpy()
    n = 40
    elem = np.arange(n, dtype=np.int32) % mesh.ntet
    origin = cents[elem]
    pipe.submit(origin, origin + 0.01, elem)
    pipe.submit_source(origin, elem, n_moves=2, source=SourceParams())
    pipe.finish()
    expected = classify(mesh.ntet, n, 2, torch.float32, True).key()
    assert expected == jax_classify(mesh.ntet, n, 2, jnp.float32,
                                    True).key()
    results = list(pipe.results())
    assert len(results) == 2
    assert all(r.shape_key == expected for r in results)
    assert pipe.shape_keys() == {expected: 2}


# --------------------------------------------------------------------- #
# Against the JAX package
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def twins():
    return {dt: twin_meshes(dt, nx=2) for dt in (torch.float32,
                                                 torch.float64)}


@pytest.fixture(scope="module")
def jax_served(twins):
    """Per dtype: one synthetic job (40 particles, 4 moves) and the JAX
    facade's flux of its padded request, chunked by the quantum (2)."""
    out = {}
    for dt, (jmesh, _) in twins.items():
        req = jax_requests(jmesh, 1, class_sizes=(40,), n_moves=4,
                           seed=3)[0]
        origins, w, g, alive = padded(req)
        jt = jpt.PumiTally(jmesh, origins.shape[0], jpt.TallyConfig(
            dtype=JDT[dt], tolerance=1e-6, megastep=2))
        jt.initialize_particle_location(origins.reshape(-1).copy())
        jt.run_source_moves(
            4, JaxSourceParams(**dataclasses.asdict(req.source)),
            weights=w, groups=g, alive=alive)
        out[dt] = (req, np.asarray(jt.raw_flux))
    return out


def test_synthetic_requests_and_documents_match_jax(twins):
    for dt, (jmesh, pmesh) in twins.items():
        mine = synthetic_requests(pmesh, 3, class_sizes=(40, 100),
                                  n_moves=4, seed=3)
        theirs = jax_requests(jmesh, 3, class_sizes=(40, 100), n_moves=4,
                              seed=3)
        for a, b in zip(mine, theirs):
            assert a.origins.tobytes() == b.origins.tobytes()
            assert a.job_id == b.job_id
            assert json.dumps(request_to_json(a), sort_keys=True) == \
                json.dumps(jax_to_json(b), sort_keys=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_served_job_matches_jax_facade(twins, jax_served, dtype):
    """One job through the port's scheduler against the JAX facade's
    ``run_source_moves`` of the same padded request."""
    pmesh = twins[dtype][1]
    want = jax_served[dtype][1]
    req = synthetic_requests(pmesh, 1, class_sizes=(40,), n_moves=4,
                             seed=3)[0]
    out = run_saturation(pmesh, _cfg(dtype=dtype), n_jobs=1,
                         class_sizes=(40,), n_moves=4, seed=3,
                         quantum_moves=2, device="cpu")
    got = out["results"]["sat-0000"]
    assert out["per_job"][0]["outcome"] == "completed"
    pos_tol, rtol, atol = TOL[dtype]
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol if dtype == torch.float64 else pos_tol)
    assert got.tobytes() == solo_reference(
        pmesh, req, 2, _cfg(dtype=dtype)).tobytes()
