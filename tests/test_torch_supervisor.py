"""The port's self-healing fleet on the CPU: the supervisor, the journal's
degraded mode and the gateway's backpressure
(``pumiumtally_tpu_torch/serving/{supervisor,journal,gateway}.py``).

Mirrors every case of tests/test_supervisor.py on its 2x2x2 box with
``device="cpu"``: a member that stops answering heartbeats is quarantined
after ``heartbeat_misses`` misses and evicted after ``grace_ticks`` more,
with the FLEET.json record; a slow member is quarantined, not evicted
inside its grace, and restored; ENOSPC degrades the journal and the
supervisor drains the disk-pressured member; a non-disk I/O error still
raises; an eviction journaled before a crash is replayed at recovery; the
gateway answers 503 with Retry-After before any key is journaled; the
fault grammar's fleet clauses parse; the trace check takes ``evicted``
as a link. The JAX cases marked slow (the wedged, brownout and disk
drills, bitwise the fault-free fleet) drain real quanta; on the port's
CPU path they compile nothing and run here unmarked.
"""
from __future__ import annotations

import errno
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from pumiumtally_tpu_torch import TallyConfig, build_box
from pumiumtally_tpu_torch.obs import TRACE_SCHEMA, check_job_trace, job_trace
from pumiumtally_tpu_torch.resilience.faultinject import (
    ChaosInjector,
    ChaosPlan,
    parse_faults,
)
from pumiumtally_tpu_torch.serving import (
    FleetJournal,
    FleetRouter,
    FleetSupervisor,
    TallyGateway,
    synthetic_requests,
)
from pumiumtally_tpu_torch.serving.journal import (
    SchedulerJournal,
    request_to_json,
)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in (
        "PUMI_TPU_MEGASTEP", "PUMI_TPU_KERNEL", "PUMI_TPU_IO_PIPELINE",
        "PUMI_TPU_TUNING", "PUMI_TPU_AOT_FAULT", "PUMI_TPU_PROM_PORT",
        "PUMI_TPU_FAULTS", "PUMI_TPU_FLEET_OBS",
    ):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def mesh():
    return build_box(1.0, 1.0, 1.0, 2, 2, 2, device="cpu")


def _cfg(**kw):
    return TallyConfig(tolerance=1e-6, **kw)


def _router(tmp_path, mesh, n_members=3, **kw):
    kw.setdefault("quantum_moves", 2)
    kw.setdefault("max_resident", 2)
    return FleetRouter(
        mesh, _cfg(), fleet_dir=str(tmp_path / "fleet"),
        n_members=n_members, bank=None, device="cpu", **kw,
    )


def _reference_results(tmp_path, mesh, requests, **kw):
    kw.setdefault("quantum_moves", 2)
    ref = FleetRouter(
        mesh, _cfg(), fleet_dir=str(tmp_path / "ref"), n_members=2,
        bank=None, max_resident=2, device="cpu", **kw,
    )
    try:
        for r in requests:
            ref.submit(r, idempotency_key=f"key-{r.job_id}")
        ref.run()
        return {r.job_id: np.asarray(ref.result(r.job_id)).copy()
                for r in requests}
    finally:
        ref.close()


def _health(router, member, state):
    return router.registry.gauge("pumi_member_health").value(
        member=f"m{member}", state=state,
    )


def _trace(router):
    return [json.loads(line) for line in open(router.journal.trace_path())
            if line.strip()]


# --------------------------------------------------------------------- #
# Knobs and the classification (no quanta)
# --------------------------------------------------------------------- #
def test_supervisor_knob_validation(tmp_path, mesh):
    router = _router(tmp_path, mesh, n_members=1)
    try:
        with pytest.raises(ValueError, match="slow_factor"):
            FleetSupervisor(router, slow_factor=1.0)
        for bad in ("window", "heartbeat_misses", "grace_ticks",
                    "restore_ticks"):
            with pytest.raises(ValueError, match=bad):
                FleetSupervisor(router, **{bad: 0})
    finally:
        router.close()


def test_wedged_member_quarantined_then_evicted_no_kill(tmp_path, mesh):
    """Missed heartbeats alone evict: healthy → wedged (quarantined) →
    evicted, with the FLEET.json record."""
    router = _router(tmp_path, mesh)
    sup = FleetSupervisor(router, heartbeat_misses=2, grace_ticks=1)
    try:
        assert _health(router, 0, "healthy") == 1.0
        router.members[0].scheduler.faults = ChaosInjector(
            ChaosPlan(wedge_member=0)
        )
        sup.tick()  # one miss: still healthy
        assert not router.members[0].quarantined
        assert router.members[0].health == "healthy"
        sup.tick()  # second miss: wedged, quarantined
        assert router.members[0].quarantined
        assert router.members[0].health == "wedged"
        assert router.members[0].alive
        assert _health(router, 0, "wedged") == 1.0
        assert _health(router, 0, "healthy") == 0.0
        sup.tick()  # past grace_ticks: evicted
        assert not router.members[0].alive
        assert router.members[0].health == "evicted"
        assert _health(router, 0, "evicted") == 1.0
        assert sup._evictions_total.value(cause="wedged") == 1
        doc = FleetJournal(router.journal.dir).load()
        assert doc["evicted"] == {"0": {"cause": "wedged"}}
        assert all(m.alive for m in router.members[1:])
        assert _health(router, 1, "healthy") == 1.0
        assert router.registry.histogram(
            "pumi_supervisor_probe_seconds").snapshot()["series"]
    finally:
        router.close()


def test_brownout_hysteresis_quarantine_restore(tmp_path, mesh):
    router = _router(tmp_path, mesh)
    sup = FleetSupervisor(
        router, slow_factor=3.0, window=4, grace_ticks=100,
        restore_ticks=2,
    )
    try:
        for m in router.members:
            m.scheduler.recent_quantum_seconds.extend([0.01] * 4)
        router.members[0].scheduler.recent_quantum_seconds.extend(
            [1.0] * 4
        )
        sup.tick()
        assert router.members[0].quarantined
        assert router.members[0].health == "brownout"
        assert _health(router, 0, "brownout") == 1.0
        req = synthetic_requests(mesh, 1, class_sizes=(24,))[0]
        assert router.member_of(router.submit(req)) != 0
        router.members[0].scheduler.recent_quantum_seconds.extend(
            [0.01] * 4
        )
        sup.tick()
        assert router.members[0].quarantined  # one clean tick: held
        sup.tick()
        assert not router.members[0].quarantined
        assert router.members[0].health == "healthy"
        assert _health(router, 0, "healthy") == 1.0
        assert router.members[0].alive
        assert sup._evictions_total.value(cause="brownout") == 0
    finally:
        router.close()


def test_disk_pressure_classified_and_cooperatively_drained(
    tmp_path, mesh
):
    router = _router(tmp_path, mesh)
    sup = FleetSupervisor(router, grace_ticks=1)
    try:
        router.members[0].scheduler.journal.note_disk_failure(
            "test", OSError(errno.ENOSPC, "No space left on device")
        )
        assert router.members[0].registry.gauge(
            "pumi_journal_degraded"
        ).value(member="m0") == 1.0
        sup.tick()
        assert router.members[0].quarantined
        assert router.members[0].health == "disk-pressured"
        sup.tick()
        assert not router.members[0].alive
        assert sup._evictions_total.value(cause="disk-pressured") == 1
        doc = FleetJournal(router.journal.dir).load()
        assert doc["evicted"] == {"0": {"cause": "disk-pressured"}}
    finally:
        router.close()


# --------------------------------------------------------------------- #
# The journal's degraded mode (no scheduler)
# --------------------------------------------------------------------- #
def test_journal_degrades_on_enospc_instead_of_crashing(tmp_path):
    j = SchedulerJournal(str(tmp_path / "j"))
    fired = []
    j.on_degraded = lambda op, exc: fired.append((op, exc.errno))
    assert not j.degraded
    j.faults = ChaosInjector(ChaosPlan(disk_full_at=1))
    assert j.write_flux("job-a", np.ones(3, np.float64)) is None
    assert j.degraded
    assert fired == [("flux persist", errno.ENOSPC)]
    j.flush([], quantum_moves=2)
    assert j.write_flux("job-b", np.ones(3, np.float64)) is None
    assert fired == [("flux persist", errno.ENOSPC)]
    assert j.load() is None


def test_journal_non_disk_oserror_still_raises(tmp_path):
    j = SchedulerJournal(str(tmp_path / "j"))

    class _EIOFaults:
        def maybe_disk_full(self):
            raise OSError(errno.EIO, "I/O error")

    j.faults = _EIOFaults()
    with pytest.raises(OSError, match="I/O error"):
        j.write_flux("job-a", np.ones(3, np.float64))
    assert not j.degraded


# --------------------------------------------------------------------- #
# An eviction journaled before a crash, replayed at recovery
# --------------------------------------------------------------------- #
def test_eviction_record_replayed_at_recovery(tmp_path, mesh):
    fdir = str(tmp_path / "fleet")
    router = FleetRouter(
        mesh, _cfg(), fleet_dir=fdir, n_members=2, bank=None,
        quantum_moves=2, max_resident=2, device="cpu",
    )
    requests = synthetic_requests(mesh, 4, class_sizes=(24,))
    for r in requests:
        router.submit(r, idempotency_key=f"key-{r.job_id}")
    victims = [
        r.job_id for r in requests if router.member_of(r.job_id) == 0
    ]
    assert victims
    router.record_eviction(0, "wedged")
    router.abandon()  # the record is flushed, the drain never ran

    kw = dict(bank=None, quantum_moves=2, max_resident=2, device="cpu")
    router = FleetRouter.recover(fdir, mesh, _cfg(), **kw)
    try:
        assert not router.members[0].alive
        assert router.members[0].health == "evicted"
        for jid in victims:
            assert router.member_of(jid) == 1
        ids = sorted(j.id for j in router.jobs())
        assert ids == sorted(r.job_id for r in requests)
        doc = FleetJournal(fdir).load()
        assert doc["evicted"] == {"0": {"cause": "wedged"}}
        router.abandon()
        router = FleetRouter.recover(fdir, mesh, _cfg(), **kw)
        assert not router.members[0].alive
        assert sorted(j.id for j in router.jobs()) == ids
    finally:
        router.close()


# --------------------------------------------------------------------- #
# The gateway's deadlines and 503 backpressure
# --------------------------------------------------------------------- #
def test_gateway_knob_validation(tmp_path, mesh):
    router = _router(tmp_path, mesh, n_members=1)
    try:
        with pytest.raises(ValueError, match="request_timeout_s"):
            TallyGateway(router, port=0, request_timeout_s=0)
        with pytest.raises(ValueError, match="retry_after_s"):
            TallyGateway(router, port=0, retry_after_s=-1)
    finally:
        router.close()


def test_gateway_503_retry_after_on_backpressure(tmp_path, mesh):
    router = _router(
        tmp_path, mesh, n_members=2, max_resident=1, max_queued=1,
    )
    gateway = TallyGateway(router, port=0, retry_after_s=2.5)
    try:
        for r in synthetic_requests(mesh, 4, class_sizes=(24,)):
            router.submit(r)  # 1 resident + 1 queued a member
        assert router.backpressured()
        wire = request_to_json(
            synthetic_requests(mesh, 1, class_sizes=(24,))[0]
        )
        body = json.dumps(dict(wire, idempotency_key="key-z")).encode()
        req = urllib.request.Request(
            f"{gateway.url}/submit", data=body,
            headers={"Content-Type": "application/json"},
        )
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(req, timeout=30)
        e = exc_info.value
        payload = json.loads(e.read())
        assert e.code == 503
        assert e.headers["Retry-After"] == "3"  # ceil(2.5)
        assert payload["retry_after_s"] == 2.5
        assert payload["retry_jitter_s"] == 1.25
        assert "idempotency_key" in payload["guidance"]
        doc = FleetJournal(router.journal.dir).load()
        assert "key-z" not in doc["accepted"]
        assert gateway.request_timeout_s == 30.0
    finally:
        gateway.stop()
        router.close()


# --------------------------------------------------------------------- #
# The fault grammar and the trace check's evicted link
# --------------------------------------------------------------------- #
def test_parse_faults_self_healing_clauses():
    plan = parse_faults("wedge_member:1")
    assert plan.wedge_member == 1
    plan = parse_faults("slow_member:2:8")
    assert (plan.slow_member, plan.slow_factor) == (2, 8.0)
    plan = parse_faults("slow_member:0")
    assert (plan.slow_member, plan.slow_factor) == (0, 4.0)
    plan = parse_faults("disk_full_at:3")
    assert plan.disk_full_at == 3
    with pytest.raises(ValueError, match="factor must be >= 1"):
        parse_faults("slow_member:0:0.5")
    with pytest.raises(ValueError, match="durable writes from 1"):
        parse_faults("disk_full_at:0")
    with pytest.raises(ValueError) as exc_info:
        parse_faults("nope:1")
    for clause in ("wedge_member", "slow_member", "disk_full_at"):
        assert clause in str(exc_info.value)


def _rec(name, *, kind="span", sid, parent=None, pid=1, seq=0):
    return dict(
        schema=TRACE_SCHEMA, kind=kind, name=name, trace_id="t1",
        span_id=sid, parent_id=parent, job_id="jX", pid=pid, ts=1.0,
        seconds=0.0, seq=seq,
    )


def test_trace_check_accepts_evicted_link():
    root = "t1/root"
    split = [
        _rec("submit", kind="event", sid="a", parent=root, seq=0),
        _rec("quantum", sid="b", parent=root, seq=1),
        _rec("quantum", sid="c", parent=root, pid=2, seq=2),
        _rec("job", sid=root, pid=2, seq=3),
    ]
    problems = check_job_trace(job_trace(split, "jX"), "jX")
    assert any("evicted" in p for p in problems)
    healed = split + [
        _rec("evicted", kind="event", sid="d", parent=root, pid=2,
             seq=4)
    ]
    assert check_job_trace(job_trace(healed, "jX"), "jX") == []


# --------------------------------------------------------------------- #
# The drills: real quanta, bitwise the fault-free fleet
# --------------------------------------------------------------------- #
def test_wedged_eviction_end_to_end_bitwise(tmp_path, mesh):
    requests = synthetic_requests(mesh, 4, class_sizes=(24,), n_moves=6)
    ref = _reference_results(tmp_path, mesh, requests)
    router = _router(tmp_path, mesh, n_members=3)
    try:
        for r in requests:
            router.submit(r, idempotency_key=f"key-{r.job_id}")
        router.step()  # checkpoints exist before the wedge
        victims = [
            r.job_id for r in requests
            if router.member_of(r.job_id) == 0
        ]
        assert victims
        router.members[0].scheduler.faults = ChaosInjector(
            ChaosPlan(wedge_member=0)
        )
        sup = FleetSupervisor(router, heartbeat_misses=2, grace_ticks=1)
        sup.run()
        assert not router.members[0].alive
        for jid in victims:
            assert router.member_of(jid) != 0
        ids = sorted(j.id for j in router.jobs())
        assert ids == sorted(r.job_id for r in requests)
        for r in requests:
            assert np.array_equal(
                np.asarray(router.result(r.job_id)), ref[r.job_id]
            ), f"{r.job_id} not bitwise across wedged eviction"
        linked = {
            t["job_id"] for t in _trace(router)
            if t.get("name") == "evicted"
        }
        assert set(victims) <= linked
    finally:
        router.close()


def test_brownout_quarantined_not_evicted_restored_bitwise(
    tmp_path, mesh
):
    """A 25x slow member trips quarantine but not eviction; once the
    slowness clears it is restored and every job ends bitwise where it
    was placed: no migration."""
    requests = synthetic_requests(mesh, 4, class_sizes=(24,), n_moves=6)
    ref = _reference_results(tmp_path, mesh, requests, quantum_moves=1)
    router = _router(tmp_path, mesh, n_members=3, quantum_moves=1)
    try:
        for r in requests:
            router.submit(r, idempotency_key=f"key-{r.job_id}")
        router.members[0].scheduler.faults = ChaosInjector(
            ChaosPlan(slow_member=0, slow_factor=25.0)
        )
        sup = FleetSupervisor(
            router, slow_factor=4.0, window=2, grace_ticks=50,
            restore_ticks=1,
        )
        quarantined_seen = False
        for _ in range(200):
            pending = router.step()
            sup.tick()
            if router.members[0].quarantined and not quarantined_seen:
                quarantined_seen = True
                router.members[0].scheduler.faults = ChaosInjector(
                    ChaosPlan()
                )
            if not pending and all(j.terminal for j in router.jobs()):
                break
        assert quarantined_seen
        assert all(m.alive for m in router.members)
        assert not router.members[0].quarantined
        assert router.members[0].health == "healthy"
        assert router.stats()["migrations"] == 0
        for r in requests:
            assert np.array_equal(
                np.asarray(router.result(r.job_id)), ref[r.job_id]
            ), f"{r.job_id} not bitwise through quarantine"
    finally:
        router.close()


def test_disk_pressure_drained_zero_loss_bitwise(tmp_path, mesh):
    requests = synthetic_requests(mesh, 4, class_sizes=(24,), n_moves=6)
    ref = _reference_results(tmp_path, mesh, requests)
    router = _router(tmp_path, mesh, n_members=2)
    try:
        for r in requests:
            router.submit(r, idempotency_key=f"key-{r.job_id}")
        router.members[0].scheduler.faults = ChaosInjector(
            ChaosPlan(disk_full_at=1)
        )
        sup = FleetSupervisor(router, grace_ticks=1)
        sup.run()
        assert router.members[0].registry.gauge(
            "pumi_journal_degraded"
        ).value(member="m0") == 1.0
        assert not router.members[0].alive
        assert router.members[0].health == "evicted"
        doc = FleetJournal(router.journal.dir).load()
        assert doc["evicted"] == {"0": {"cause": "disk-pressured"}}
        ids = sorted(j.id for j in router.jobs())
        assert ids == sorted(r.job_id for r in requests)
        for r in requests:
            assert np.array_equal(
                np.asarray(router.result(r.job_id)), ref[r.job_id]
            ), f"{r.job_id} not bitwise across disk-pressure drain"
    finally:
        router.close()
