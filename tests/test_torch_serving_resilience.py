"""The port's serving layer under failure on the CPU: the fault grammar's
serving clauses, the journal, admission control, per-job isolation and
crash recovery (``pumiumtally_tpu_torch/serving/{journal,scheduler}.py``).

Mirrors tests/test_serving_resilience.py on a 2x2x2 box, jobs of 40 and
100 particles and at most 6 moves: the serving fault clauses, requests
through the JSON journal bit for bit, rejection at ``max_queued``, the
new knobs, a poison job isolated while the others stay bitwise their
uninterrupted runs, a transient quantum replayed bitwise from its
snapshot, a spent retry budget, a watchdog timeout classified transient
and replayed, a journal recovered in-process and in a fresh process over
a filled bank, and torn bank entries rewritten. Beyond the mirrors: the
journal's degraded mode under ``disk_full_at``, and
``kill_server_at_quantum`` then ``TallyScheduler.recover``.

Against the JAX package: the journal documents of the same requests are
equal, and the JAX package reads the port's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pumiumtally_tpu.serving.journal import request_from_json as jax_from_json
from pumiumtally_tpu.serving.journal import request_to_json as jax_to_json
from pumiumtally_tpu_torch import TallyConfig, build_box
from pumiumtally_tpu_torch.ops.source import SourceParams
from pumiumtally_tpu_torch.resilience.faultinject import (
    FaultInjector,
    FaultPlan,
    InjectedKill,
    parse_faults,
)
from pumiumtally_tpu_torch.serving import (
    JobRequest,
    TallyScheduler,
    run_saturation,
    synthetic_requests,
)
from pumiumtally_tpu_torch.serving.bank import FACADE_LIBRARIES
from pumiumtally_tpu_torch.serving.journal import (
    check_job_id,
    request_from_json,
    request_to_json,
)
from torch_serving_twins import solo_reference, toy_bank

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _sat(mesh, n_jobs, **kw):
    kw = {**dict(class_sizes=(40,), n_moves=4, seed=3, max_resident=1,
                 quantum_moves=2, device="cpu"), **kw}
    return run_saturation(mesh, _cfg(), n_jobs=n_jobs, **kw)


# --------------------------------------------------------------------- #
# Grammar, journal serialization, admission control
# --------------------------------------------------------------------- #
def test_fault_grammar_serving_clauses():
    plan = parse_faults(
        "poison_job:1,transient_quantum:2,kill_server_at_quantum:7"
    )
    assert plan.poison_job == 1
    assert plan.transient_quantum == 2
    assert plan.kill_server_at_quantum == 7
    assert plan.any()
    with pytest.raises(ValueError, match="kill_server_at_quantum"):
        parse_faults("kill_server_at_quantum:0")
    with pytest.raises(ValueError, match="unknown fault"):
        parse_faults("poison_jb:1")
    inj = FaultInjector(parse_faults(
        "poison_job:3,transient_quantum:0,kill_server_at_quantum:5"))
    # poison fires every time; the transient and the kill fire once.
    for _ in range(2):
        with pytest.raises(Exception, match="poison"):
            inj.maybe_poison_job(3)
    with pytest.raises(Exception, match="transient"):
        inj.maybe_transient_quantum(0)
    inj.maybe_transient_quantum(0)
    with pytest.raises(InjectedKill, match="server kill"):
        inj.maybe_kill_server(5)
    inj.maybe_kill_server(5)


def test_journal_request_roundtrip_bitwise():
    rng = np.random.default_rng(5)
    origins = rng.uniform(0.0, 1.0, (7, 3))
    origins[0, 0] = 1.0 / 3.0
    origins[1, 1] = np.nextafter(0.5, 1.0)
    kw = dict(sigma_t={0: 1.25, 3: 0.7}, absorption={0: 0.31},
              default_sigma_t=0.9, survival_weight=0.05, seed=42)
    req = JobRequest(
        origins=origins, n_moves=9, source=SourceParams(**kw),
        weights=rng.uniform(0.5, 2.0, 7),
        groups=np.array([0, 1, 0, 1, 0, 1, 0], np.int32),
        job_id="rt-0",
    )
    doc = json.loads(json.dumps(request_to_json(req)))
    back = request_from_json(doc)
    assert back.origins.tobytes() == origins.tobytes()
    assert back.weights.tobytes() == np.asarray(req.weights).tobytes()
    assert back.groups.tobytes() == req.groups.tobytes()
    assert back.n_moves == 9 and back.job_id == "rt-0"
    assert back.source.seed == 42
    cid = np.arange(4)
    for a, b in zip(back.source.tables(cid), req.source.tables(cid)):
        assert a.tobytes() == b.tobytes()
    with pytest.raises(TypeError, match="SourceParams"):
        request_to_json(JobRequest(origins=origins, n_moves=1,
                                   source=object()))
    with pytest.raises(ValueError, match="journal-safe"):
        check_job_id("../evil")
    # The JAX journal's document of the same request, key for key and
    # float for float; and the JAX reader takes the port's.
    from pumiumtally_tpu.ops.source import SourceParams as JaxSourceParams
    from pumiumtally_tpu.serving import JobRequest as JaxJobRequest

    jreq = JaxJobRequest(origins=origins, n_moves=9,
                         source=JaxSourceParams(**kw), weights=req.weights,
                         groups=req.groups, job_id="rt-0")
    assert json.dumps(jax_to_json(jreq), sort_keys=True) == json.dumps(
        request_to_json(req), sort_keys=True)
    jback = jax_from_json(doc)
    assert jback.origins.tobytes() == origins.tobytes()
    assert dataclasses.asdict(jback.source) == dataclasses.asdict(
        back.source)


def test_admission_rejection_at_max_queued(mesh, tmp_path):
    sched = TallyScheduler(
        mesh, _cfg(), max_resident=1, max_queued=2,
        journal_dir=str(tmp_path / "j"), handle_signals=False, device="cpu",
    )
    ids = [
        sched.submit(JobRequest(origins=np.full((4, 3), 0.5), n_moves=2,
                                job_id=f"q{i}"))
        for i in range(4)
    ]
    assert [sched.job(i).outcome for i in ids] == [
        None, None, "rejected", "rejected"]
    assert sched.queue_depth == 2
    assert sched.stats()["outcomes"] == {"rejected": 2}
    with pytest.raises(RuntimeError, match="rejected"):
        sched.result("q2")
    text = sched.registry.render_prometheus()
    assert 'pumi_jobs_total{outcome="rejected"} 2' in text
    assert "pumi_job_queue_seconds" in text
    doc = sched.journal.load()
    assert doc["jobs"]["q2"]["state"] == "done"
    assert doc["jobs"]["q2"]["outcome"] == "rejected"
    kinds = [r["kind"] for r in sched.recorder.records()]
    assert kinds.count("job_rejected") == 2
    sched.close()
    with pytest.raises(ValueError, match="max_queued"):
        TallyScheduler(mesh, _cfg(), max_queued=0, device="cpu")


def test_scheduler_new_knob_validation(mesh, tmp_path):
    sched = TallyScheduler(mesh, _cfg(), preempt_after=1,
                           journal_dir=str(tmp_path / "j"),
                           handle_signals=False, device="cpu")
    assert sched.checkpoint_dir is None and sched.journal is not None
    sched.close()
    with pytest.raises(ValueError, match="checkpoint_dir or journal"):
        TallyScheduler(mesh, _cfg(), preempt_after=1, device="cpu")
    sched = TallyScheduler(mesh, _cfg(), quantum_deadline_s=5.0,
                           device="cpu")
    assert sched.config.move_deadline_s == 5.0
    assert sched.config.megastep == sched.quantum == 1
    # The health probe: the device answers; a wedged member does not.
    assert sched.heartbeat() and not sched.wedged
    sched.close()
    wedged = TallyScheduler(mesh, _cfg(), member_index=1, device="cpu",
                            faults=FaultInjector(parse_faults(
                                "wedge_member:1")))
    assert wedged.wedged and not wedged.heartbeat()
    wedged.close()
    with pytest.raises(ValueError, match="max_resident"):
        TallyScheduler(mesh, _cfg(), max_resident=0, device="cpu")


# --------------------------------------------------------------------- #
# Fault isolation
# --------------------------------------------------------------------- #
def test_poison_job_isolation_bitwise(mesh):
    reqs = synthetic_requests(mesh, 3, class_sizes=(40, 100), n_moves=4,
                              seed=3)
    out = _sat(mesh, 3, class_sizes=(40, 100), max_resident=2,
               faults=FaultInjector(FaultPlan(poison_job=1)))
    rows = {r["job"]: r for r in out["per_job"]}
    assert rows["sat-0001"]["outcome"] == "poisoned"
    assert "InjectedPoisonFault" in rows["sat-0001"]["error"]
    assert "sat-0001" not in out["results"]
    assert out["scheduler"]["outcomes"] == {"poisoned": 1, "completed": 2}
    for req in (reqs[0], reqs[2]):
        ref = solo_reference(mesh, req, 2, _cfg())
        assert out["results"][req.job_id].tobytes() == ref.tobytes()


def test_transient_quantum_bitwise_replay(mesh):
    req = synthetic_requests(mesh, 1, class_sizes=(40,), n_moves=4,
                             seed=3)[0]
    out = _sat(mesh, 1, faults=FaultInjector(FaultPlan(transient_quantum=0)))
    row = out["per_job"][0]
    assert row["outcome"] == "completed" and row["retries"] == 1
    assert row["recovery_seconds"] > 0
    ref = solo_reference(mesh, req, 2, _cfg())
    assert out["results"][req.job_id].tobytes() == ref.tobytes()


def test_retry_budget_exhaustion_poisons(mesh):
    out = _sat(mesh, 2, job_retries=0,
               faults=FaultInjector(FaultPlan(transient_quantum=0)))
    rows = {r["job"]: r for r in out["per_job"]}
    assert rows["sat-0000"]["outcome"] == "poisoned"
    assert "InjectedTransientFault" in rows["sat-0000"]["error"]
    assert rows["sat-0001"]["outcome"] == "completed"


def test_watchdog_timeout_classified_and_replayed(mesh, monkeypatch):
    """A wedged dispatch (the facade's own ``hang_at_move``, in the
    second quantum, past the first call's amnesty) hits the deadline,
    classifies transient (the device answers its probe) and replays
    bitwise, counted under cause="timeout"."""
    req = synthetic_requests(mesh, 1, class_sizes=(40,), n_moves=4,
                             seed=3)[0]
    monkeypatch.setenv("PUMI_TPU_FAULTS", "hang_at_move:3,hang_seconds:1.0")
    out = _sat(mesh, 1, quantum_deadline_s=0.3,
               faults=FaultInjector(FaultPlan()))
    monkeypatch.delenv("PUMI_TPU_FAULTS")
    row = out["per_job"][0]
    assert row["outcome"] == "completed" and row["retries"] >= 1
    ref = solo_reference(mesh, req, 2, _cfg())
    assert out["results"][req.job_id].tobytes() == ref.tobytes()
    assert out["scheduler"]["retries"] >= 1


def test_disk_full_degrades_the_journal(mesh, tmp_path):
    """``disk_full_at`` makes a durable write fail with ENOSPC: the
    journal degrades (its document frozen), the scheduler parks its
    residents and holds, and nothing raises."""
    jdir = str(tmp_path / "j")
    sched = TallyScheduler(mesh, _cfg(), max_resident=1, quantum_moves=2,
                           journal_dir=jdir, handle_signals=False,
                           faults=FaultInjector(parse_faults(
                               "disk_full_at:3")), device="cpu")
    for r in synthetic_requests(mesh, 2, class_sizes=(40,), n_moves=4,
                                seed=3):
        sched.submit(r)
    for _ in range(4):
        sched.step()
    assert sched.journal.degraded
    assert sched.resident_count == 0
    assert sched.step() is False
    text = sched.registry.render_prometheus()
    assert 'pumi_journal_degraded{member="solo"} 1.0' in text
    kinds = [r["kind"] for r in sched.recorder.records()]
    assert "journal_degraded" in kinds
    doc = sched.journal.load()
    assert set(doc["jobs"]) == {"sat-0000", "sat-0001"}
    sched.abandon()


# --------------------------------------------------------------------- #
# Crash-safe journal and recovery
# --------------------------------------------------------------------- #
def test_journal_roundtrip_recovery_in_process(mesh, tmp_path):
    cfg = _cfg()
    jdir = str(tmp_path / "journal")
    reqs = synthetic_requests(mesh, 3, class_sizes=(40,), n_moves=6,
                              seed=11)
    sched = TallyScheduler(mesh, cfg, max_resident=1, quantum_moves=2,
                           journal_dir=jdir, handle_signals=False,
                           device="cpu")
    for r in reqs:
        sched.submit(r)
    # Three rounds finish the first job (its lanes all escape in its
    # second quantum) and leave the second mid-flight with a journaled
    # checkpoint; then the server dies without a close.
    for _ in range(3):
        sched.step()
    assert sched.job("sat-0000").outcome == "completed"
    mid = sched.job("sat-0001")
    assert 0 < mid.moves_done < 6
    doc = sched.journal.load()
    assert doc["jobs"]["sat-0000"]["state"] == "done"
    assert doc["jobs"]["sat-0001"]["checkpoint"] is not None
    sched.abandon()

    rec = TallyScheduler.recover(jdir, mesh, cfg, max_resident=1,
                                 quantum_moves=2, handle_signals=False,
                                 device="cpu")
    done = rec.job("sat-0000")
    assert done.outcome == "completed" and done.result is not None
    resumed = rec.job("sat-0001")
    assert resumed.checkpoint is not None and resumed.moves_done > 0
    assert rec.stats()["recovered"] == 2
    rec.run()
    rec.close()
    for req in reqs:
        ref = solo_reference(mesh, req, 2, cfg)
        assert rec.result(req.job_id).tobytes() == ref.tobytes()
    kinds = [r["kind"] for r in rec.recorder.records()]
    assert "journal_recovery" in kinds and "journal_recovered" in kinds


def test_server_kill_then_recover_is_bitwise(mesh, tmp_path):
    """``kill_server_at_quantum:3`` stops a journaled server mid-run (no
    close, no flush); ``TallyScheduler.recover`` finishes every job bit
    for bit the fault-free run, each trace continuing under its id."""
    from pumiumtally_tpu_torch.obs import check_job_trace, job_trace
    from pumiumtally_tpu_torch.obs import load_trace_records

    jdir = str(tmp_path / "j")
    with pytest.raises(InjectedKill):
        _sat(mesh, 3, journal_dir=jdir,
             faults=FaultInjector(parse_faults("kill_server_at_quantum:3")))
    out = _sat(mesh, 3, journal_dir=jdir, resume=True)
    assert out["scheduler"]["recovered"] >= 1
    clean = _sat(mesh, 3)
    for jid, flux in clean["results"].items():
        assert out["results"][jid].tobytes() == flux.tobytes(), jid
    recs = load_trace_records(jdir)
    for row in out["per_job"]:
        assert check_job_trace(job_trace(recs, row["job"]),
                               row["job"]) == []


_RECOVER_SCRIPT = """
import hashlib, json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from pumiumtally_tpu_torch import TallyConfig, build_box
from pumiumtally_tpu_torch.serving import ProgramBank, run_saturation
from pumiumtally_tpu_torch.serving.bank import FACADE_LIBRARIES
from torch_serving_twins import toy_build, toy_loader
mesh = build_box(1.0, 1.0, 1.0, 2, 2, 2, device="cpu")
out = run_saturation(
    mesh, TallyConfig(tolerance=1e-6), bank=ProgramBank(
        {bank!r}, build=toy_build, loader=toy_loader),
    n_jobs=3, class_sizes=(40,), n_moves=4, seed=5, max_resident=1,
    quantum_moves=2, journal_dir={journal!r}, resume=True, device="cpu")
outcomes = {{}}
for row in out["per_job"]:
    outcomes[row["outcome"]] = outcomes.get(row["outcome"], 0) + 1
print(json.dumps({{
    "recovered": out["scheduler"]["recovered"],
    "hashes": {{k: hashlib.sha256(v.tobytes()).hexdigest()
               for k, v in sorted(out["results"].items())}},
    "outcomes": outcomes,
}}))
"""


def test_journal_recovery_subprocess(mesh, tmp_path):
    """A fresh process recovers an interrupted journaled server over a
    filled bank and finishes every job bitwise the uninterrupted run."""
    bank_dir = str(tmp_path / "bank")
    jdir = str(tmp_path / "journal")
    toy_bank(bank_dir).libraries(FACADE_LIBRARIES)
    ref = _sat(mesh, 3, seed=5)
    want = {k: hashlib.sha256(v.tobytes()).hexdigest()
            for k, v in sorted(ref["results"].items())}
    sched = TallyScheduler(mesh, _cfg(), bank=toy_bank(bank_dir),
                           max_resident=1, quantum_moves=2,
                           journal_dir=jdir, handle_signals=False,
                           device="cpu")
    for r in synthetic_requests(mesh, 3, class_sizes=(40,), n_moves=4,
                                seed=5):
        sched.submit(r)
    for _ in range(3):
        sched.step()
    assert any(j.moves_done > 0 and j.outcome is None for j in sched.jobs())
    sched.abandon()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PUMI_TPU_")}
    proc = subprocess.run(
        [sys.executable, "-c", _RECOVER_SCRIPT.format(
            root=ROOT, tests=os.path.join(ROOT, "tests"), bank=bank_dir,
            journal=jdir)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["recovered"] >= 1
    assert got["outcomes"] == {"completed": 3}
    assert got["hashes"] == want


def test_torn_bank_entry_degrades_to_rewrite(tmp_path):
    """A byte-flipped library and a torn META (the fault injector's own
    corruption hooks) each degrade to a rebuild and rewrite named
    "torn", never a failed resolution; the rewritten entries load
    clean."""
    cold = toy_bank(tmp_path)
    paths = cold.libraries(FACADE_LIBRARIES)
    entries = cold.entries_on_disk()
    assert len(entries) == 3
    meta = os.path.join(os.path.dirname(paths[1]), "META.json")
    assert FaultInjector(FaultPlan(corrupt_ckpt=True)).corrupt_file(paths[0])
    assert FaultInjector(FaultPlan(torn_shard=1)).maybe_tear(meta)
    hurt = toy_bank(tmp_path)
    assert hurt.libraries(FACADE_LIBRARIES) == paths
    assert hurt.rewrites == 2 and hurt.hits == 1
    causes = {s["labels"]["cause"]
              for s in hurt._rewrites.snapshot()["series"]}
    assert causes == {"torn"}
    clean = toy_bank(tmp_path)
    clean.libraries(FACADE_LIBRARIES)
    assert clean.hits == 3 and clean.rewrites == 0
    assert clean.findings == []
