"""The port's registry aggregation, SLOs, profiler and exporter knobs
(``pumiumtally_tpu_torch/obs/{aggregate,slo,profile,exporter}.py``) on the
CPU.

Mirrors every case of tests/test_fleet_obs.py. Without a fleet: the
aggregator's merge semantics, its order independence and its refusal of
type drift; the SLO alert's edge, attribution and clearing, the
availability burn and the stock objectives; the profile mode and the
capture gate; the exporter's query opt-in. With a ``FleetRouter`` on
``device="cpu"`` (its 2x2x2 box): FLEETSTATS.json from round zero and
after close, passing ``obs.fleetview``'s check; ``PUMI_TPU_FLEET_OBS=off``
runs bare; ``/fleetz`` mounted and taught; ``parse_traceparent``'s forms
(equal to the JAX parser's); a traceparent joined at submit and kept by
the dedup; progress rows carrying the trace id; ``/jobs?limit=``; and
scrapes beside a draining fleet that parse and never go back (the last
two JAX cases are marked slow; on the port's CPU path they compile
nothing and run here unmarked). Against the JAX package, the
same registries and series go through both: the merges and their
Prometheus text are equal byte for byte, and the SLO evaluators raise and
clear the same alerts on the same ticks with the same burn rates. Beyond
the mirrors: ``PUMI_TPU_PROFILE=anomaly`` opens a torch.profiler window on
an alert and writes its Chrome trace.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from pumiumtally_tpu import obs as jxobs
from pumiumtally_tpu.serving.gateway import (
    parse_traceparent as jax_parse_traceparent,
)
from pumiumtally_tpu_torch import TallyConfig, build_box
from pumiumtally_tpu_torch.obs.fleetview import (
    check_fleetstats,
    check_live,
    check_prom_text,
    load_dir,
    load_url,
)
from pumiumtally_tpu_torch.serving import (
    FleetRouter,
    TallyGateway,
    synthetic_requests,
)
from pumiumtally_tpu_torch.serving.gateway import parse_traceparent
from pumiumtally_tpu_torch.serving.journal import request_to_json
from pumiumtally_tpu_torch.obs import (
    FLEETSTATS_FILE,
    FLEETSTATS_SCHEMA,
    FleetAggregator,
    FleetProfiler,
    MetricsRegistry,
    SLO,
    default_slos,
    profile_mode,
    render_snapshot_prometheus,
)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("PUMI_TPU_PROM_PORT", "PUMI_TPU_FAULTS", "PUMI_TPU_PROFILE",
                "PUMI_TPU_FLEET_OBS", "PUMI_TPU_MEGASTEP",
                "PUMI_TPU_IO_PIPELINE", "PUMI_TPU_TUNING"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def mesh():
    return build_box(1.0, 1.0, 1.0, 2, 2, 2, device="cpu")


def _router(tmp_path, mesh, n_members=2, **kw):
    kw.setdefault("quantum_moves", 2)
    kw.setdefault("max_resident", 2)
    return FleetRouter(
        mesh, TallyConfig(tolerance=1e-6), fleet_dir=str(tmp_path / "fleet"),
        n_members=n_members, bank=None, device="cpu", **kw,
    )


def _seed_registries(reg_cls=MetricsRegistry):
    a, b = reg_cls(), reg_cls()
    for r, n in ((a, 3), (b, 4)):
        r.counter("pumi_jobs_total", "jobs").inc(n, outcome="completed")
        r.gauge("pumi_queue_depth", "depth").set(n)
        h = r.histogram("pumi_job_e2e_seconds", "e2e")
        h.observe(0.002)
        h.observe(5.0)
    a.counter("pumi_jobs_total", "jobs").inc(1, outcome="poisoned")
    return a, b


# --------------------------------------------------------------------- #
# Aggregation
# --------------------------------------------------------------------- #
def test_aggregator_merge_semantics():
    a, b = _seed_registries()
    agg = FleetAggregator(lambda: [("m0", a), ("m1", b)])
    snap = agg.merge()
    jobs = {
        tuple(sorted(e["labels"].items())): e["value"]
        for e in snap["pumi_jobs_total"]["series"]
    }
    assert jobs[(("outcome", "completed"),)] == 7
    assert jobs[(("outcome", "poisoned"),)] == 1
    depth = {
        e["labels"]["member"]: e["value"]
        for e in snap["pumi_queue_depth"]["series"]
    }
    assert depth == {"m0": 3, "m1": 4}
    e2e = snap["pumi_job_e2e_seconds"]["series"][0]["value"]
    assert e2e["count"] == 4
    assert e2e["sum"] == pytest.approx(2 * (0.002 + 5.0))
    assert e2e["buckets"]["0.0025"] == 2
    assert e2e["buckets"]["5.0"] == 4
    # The JAX aggregator over the same observations: the same merge and
    # the same Prometheus text, byte for byte.
    ja, jb = _seed_registries(jxobs.MetricsRegistry)
    jagg = jxobs.FleetAggregator(lambda: [("m0", ja), ("m1", jb)])
    assert json.dumps(snap, sort_keys=True) == json.dumps(
        jagg.merge(), sort_keys=True)
    assert agg.render_prometheus() == jagg.render_prometheus()


def test_aggregator_deterministic_across_member_orderings():
    a, b = _seed_registries()
    sources = [("m0", a), ("m1", b)]
    merges, texts = [], []
    for perm in itertools.permutations(sources):
        agg = FleetAggregator(lambda p=perm: list(p))
        merges.append(agg.merge())
        texts.append(agg.render_prometheus())
    assert merges[0] == merges[1]
    assert texts[0] == texts[1]
    assert render_snapshot_prometheus(merges[0]) == texts[0]
    assert jxobs.render_snapshot_prometheus(merges[0]) == texts[0]
    assert (FLEETSTATS_FILE, FLEETSTATS_SCHEMA) == (
        jxobs.FLEETSTATS_FILE, jxobs.FLEETSTATS_SCHEMA)


def test_aggregator_type_drift_is_loud():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.counter("pumi_thing", "x").inc()
    b.gauge("pumi_thing", "x").set(1)
    agg = FleetAggregator(lambda: [("m0", a), ("m1", b)])
    with pytest.raises(ValueError, match="pumi_thing"):
        agg.merge()


# --------------------------------------------------------------------- #
# SLO burn-rate evaluation
# --------------------------------------------------------------------- #
class _Recorder:
    def __init__(self):
        self.records = []

    def record(self, kind, **fields):
        self.records.append(dict(fields, kind=kind))


def _latency_run(pkg):
    """The JAX test's latency series through one package's evaluator: the
    alerts after every tick and the breach records."""
    slo = pkg.SLO(
        name="e2e", kind="latency", metric="pumi_job_e2e_seconds",
        threshold_s=1.0, objective=0.9, windows=((2.0, 4.0),),
    )
    regs = [pkg.MetricsRegistry(), pkg.MetricsRegistry()]
    hists = [r.histogram("pumi_job_e2e_seconds", "e2e") for r in regs]
    rec = _Recorder()
    clock = itertools.count(start=0.0, step=1.0)
    ev = pkg.SLOEvaluator(
        (slo,), pkg.MetricsRegistry(), rec, clock=lambda: next(clock)
    )
    members = [(i, f"m{i}", regs[i], True) for i in range(2)]
    ticks = []
    hists[0].observe(0.01)
    hists[1].observe(0.01)
    for _ in range(5):
        ticks.append(json.dumps(ev.evaluate(members), sort_keys=True))
    hists[1].observe(30.0)
    hists[1].observe(30.0)
    for _ in range(7):
        ticks.append(json.dumps(ev.evaluate(members), sort_keys=True))
    return ev, rec, ticks


def test_slo_alert_fires_attributes_and_clears():
    import pumiumtally_tpu_torch.obs as pobs

    ev, rec, ticks = _latency_run(pobs)
    assert all(t == "{}" for t in ticks[:5])
    alert = json.loads(ticks[5])["e2e"]
    assert alert["member"] == 1
    assert [r["kind"] for r in rec.records] == ["slo_breach"]
    assert rec.records[0]["slo"] == "e2e"
    assert rec.records[0]["member"] == 1
    # A still-breaching tick updates burns and records no new edge; the
    # windows slide past the bad observations and the alert clears.
    assert "e2e" in json.loads(ticks[6])
    assert ticks[-1] == "{}"
    assert ev.alerts == {} and ev.alerts_by_member() == {}
    # The JAX evaluator on the same series: the same alert sequence,
    # burns included, and the same breach records.
    _, jrec, jticks = _latency_run(jxobs)
    assert ticks == jticks
    assert rec.records == jrec.records


def _avail_run(pkg):
    slo = pkg.SLO(name="avail", kind="availability", objective=0.5,
                  windows=((2.0, 3.0),))
    clock = itertools.count(start=0.0, step=1.0)
    ev = pkg.SLOEvaluator((slo,), pkg.MetricsRegistry(),
                          clock=lambda: next(clock))
    out = []
    for alive in [(True, False)] * 4 + [(False, False)] * 3:
        members = [(i, f"m{i}", None, alive[i]) for i in range(2)]
        out.append(json.dumps(ev.evaluate(members), sort_keys=True))
    return ev, out


def test_slo_availability_burns_on_dead_member():
    import pumiumtally_tpu_torch.obs as pobs

    ev, ticks = _avail_run(pobs)
    # Half the fleet down at objective 0.5 burns exactly 1.0, which does
    # not exceed the default alert threshold.
    assert all(t == "{}" for t in ticks[:4])
    assert "avail" in ev.alerts
    assert ticks == _avail_run(jxobs)[1]


def test_default_slos_are_wellformed():
    slos = default_slos()
    assert len({s.name for s in slos}) == len(slos) == 4
    assert [repr(s) for s in slos] == [repr(s) for s in jxobs.default_slos()]
    with pytest.raises(ValueError, match="kind"):
        SLO(name="x", kind="nope", objective=0.5)
    with pytest.raises(ValueError, match="objective"):
        SLO(name="x", kind="availability", objective=1.5)
    with pytest.raises(ValueError, match="window"):
        SLO(name="x", kind="availability", objective=0.5,
            windows=((5.0, 2.0),))


# --------------------------------------------------------------------- #
# Profiling
# --------------------------------------------------------------------- #
def test_profile_mode_resolution(monkeypatch):
    assert profile_mode() == "off"
    monkeypatch.setenv("PUMI_TPU_PROFILE", "anomaly")
    assert profile_mode() == "anomaly"
    with pytest.raises(ValueError, match="bogus"):
        profile_mode("bogus")
    monkeypatch.setenv("PUMI_TPU_PROFILE", "sometimes")
    with pytest.raises(ValueError, match="sometimes"):
        FleetProfiler(MetricsRegistry(), journal_dir="unused")


def test_profiler_capture_gated_off_by_default(tmp_path):
    prof = FleetProfiler(MetricsRegistry(), journal_dir=str(tmp_path))
    assert prof.status()["mode"] == "off"
    assert prof.on_alert({"slo": "e2e", "member": 0}) is False
    assert prof.status()["captures"] == []
    assert not os.path.exists(os.path.join(tmp_path, "profiles"))


def test_profiler_anomaly_capture_writes_a_chrome_trace(tmp_path,
                                                         monkeypatch):
    """An alert opens one bounded torch.profiler window (never a second
    while it is open); the sample past ``capture_s`` closes it and writes
    the trace; the utilization gauges read the member's counters."""
    import torch

    monkeypatch.setenv("PUMI_TPU_PROFILE", "anomaly")
    clock = itertools.count(start=0.0, step=1.0)
    reg = MetricsRegistry()
    prof = FleetProfiler(reg, journal_dir=str(tmp_path), capture_s=1.5,
                         clock=lambda: next(clock))
    member = MetricsRegistry()
    member.counter("pumi_job_device_seconds").inc(0.5, member="solo")
    member.counter("pumi_quantum_wall_seconds_total").inc(0.8,
                                                          member="solo")
    members = [(0, "solo", member, True)]
    prof.sample(members)
    assert prof.on_alert({"slo": "e2e", "member": 0}) is True
    assert prof.on_alert({"slo": "e2e", "member": 0}) is False
    torch.ones(64).sum()
    member.counter("pumi_job_device_seconds").inc(0.5, member="solo")
    prof.sample(members)
    assert prof.capturing
    # 0.5 device seconds over the 2 s between the samples (the alert read
    # the clock once between them).
    util = reg.snapshot()["pumi_member_device_utilization"]["series"]
    assert util[0]["value"] == pytest.approx(0.25)
    prof.sample(members)
    status = prof.status()
    assert not status["capturing"] and len(status["captures"]) == 1
    trace = status["captures"][0]["trace"]
    assert trace.startswith(os.path.join(str(tmp_path), "profiles"))
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    assert reg.counter("pumi_profile_captures_total").value() == 1
    assert reg.counter("pumi_profile_failures_total").value() == 0


def test_exporter_query_optin_is_by_param_name():
    from pumiumtally_tpu_torch.obs.exporter import _accepts_query

    assert _accepts_query(lambda query: query)
    assert _accepts_query(lambda query=None: query)
    assert not _accepts_query(lambda records=None: records)
    assert not _accepts_query(lambda: None)
    assert not _accepts_query(lambda **kw: kw)


# --------------------------------------------------------------------- #
# FLEETSTATS.json and the off switch
# --------------------------------------------------------------------- #
def test_fleetstats_written_from_round_zero(tmp_path, mesh):
    router = _router(tmp_path, mesh)
    try:
        path = router.fleetstats_path()
        assert os.path.basename(path) == FLEETSTATS_FILE
        with open(path) as fh:
            doc = json.load(fh)
        assert doc["schema"] == FLEETSTATS_SCHEMA
        assert {m["member"] for m in doc["fleet"]["members"]} == {0, 1}
        assert [s["name"] for s in doc["slo"]["slos"]] == [
            s.name for s in default_slos()
        ]
        assert check_fleetstats(load_dir(router.journal.dir)) == []
    finally:
        router.close()
    # close() writes the last picture; it outlives the router.
    assert check_fleetstats(load_dir(router.journal.dir)) == []


def test_fleet_obs_off_runs_bare(tmp_path, mesh, monkeypatch):
    monkeypatch.setenv("PUMI_TPU_FLEET_OBS", "off")
    monkeypatch.setenv("PUMI_TPU_PROM_PORT", "0")
    router = _router(tmp_path, mesh)
    try:
        assert router.aggregator is None
        assert router.slo is None
        assert router.slo_alerts_by_member() == {}
        assert not os.path.exists(router.fleetstats_path())
        base = router._exporter.url.replace("/metrics", "")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/fleetz", timeout=5)
        assert err.value.code == 404
    finally:
        router.close()
    assert not os.path.exists(router.fleetstats_path())


def test_fleetz_mounted_and_taught(tmp_path, mesh, monkeypatch):
    monkeypatch.setenv("PUMI_TPU_PROM_PORT", "0")
    router = _router(tmp_path, mesh)
    try:
        base = router._exporter.url.replace("/metrics", "")
        with urllib.request.urlopen(f"{base}/fleetz", timeout=5) as r:
            text = r.read().decode()
            ctype = r.headers.get("Content-Type", "")
        assert "text/plain" in ctype
        assert "# TYPE pumi_jobs_total counter" in text
        with urllib.request.urlopen(f"{base}/buildz", timeout=5) as r:
            assert "/fleetz" in json.loads(r.read())["endpoints"]
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/nope", timeout=5)
        assert "/fleetz" in err.value.read().decode()
        assert check_live(load_url(base)) == []
    finally:
        router.close()


# --------------------------------------------------------------------- #
# Traceparent ingress
# --------------------------------------------------------------------- #
W3C = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


def test_parse_traceparent_forms():
    assert parse_traceparent(None) is None
    assert parse_traceparent("  ") is None
    assert parse_traceparent(W3C) == "4bf92f3577b34da6a3ce929d0e0e4736"
    assert parse_traceparent("DEADBEEFDEADBEEF") == "deadbeefdeadbeef"
    for bad in ("xyz", "00-short-span-01", "ff" * 20):
        with pytest.raises(ValueError):
            parse_traceparent(bad)
    # The JAX parser agrees on every form.
    for form in (None, "  ", W3C, "DEADBEEFDEADBEEF", W3C.upper(),
                 " " + W3C + " "):
        assert parse_traceparent(form) == jax_parse_traceparent(form)
    for bad in ("xyz", "00-short-span-01", "ff" * 20):
        with pytest.raises(ValueError):
            jax_parse_traceparent(bad)


def _post(url, body, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers=headers or {},
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_traceparent_joins_submit_and_dedup(tmp_path, mesh):
    router = _router(tmp_path, mesh)
    gateway = TallyGateway(router)
    try:
        req = synthetic_requests(mesh, 1, class_sizes=(24,))[0]
        body = dict(request_to_json(req), idempotency_key="k1")
        status, payload = _post(
            f"{gateway.url}/submit", body, {"traceparent": W3C}
        )
        assert status == 200
        trace = "4bf92f3577b34da6a3ce929d0e0e4736"
        assert payload["trace_id"] == trace
        assert router.job(payload["job"]).trace_id == trace
        status2, payload2 = _post(f"{gateway.url}/submit", body)
        assert status2 == 200
        assert payload2 == payload
        status3, payload3 = _post(
            f"{gateway.url}/submit", body, {"traceparent": "zz"}
        )
        assert status3 == 400
        assert "traceparent" in payload3["error"]
        other = synthetic_requests(
            mesh, 2, class_sizes=(24,), seed=9,
        )[1]
        status4, payload4 = _post(
            f"{gateway.url}/submit",
            dict(request_to_json(other), idempotency_key="k2"),
        )
        assert status4 == 200
        assert payload4["trace_id"]
        assert payload4["trace_id"] != trace
    finally:
        gateway.stop()
        router.close()


def test_progress_rows_carry_trace_id(tmp_path, mesh):
    router = _router(tmp_path, mesh)
    gateway = TallyGateway(router)
    try:
        req = synthetic_requests(
            mesh, 1, class_sizes=(24,), n_moves=2,
        )[0]
        status, payload = _post(
            f"{gateway.url}/submit",
            dict(request_to_json(req), idempotency_key="k1"),
            {"traceparent": W3C},
        )
        assert status == 200
        router.run()
        with urllib.request.urlopen(
            f"{gateway.url}/progress/{payload['job']}?timeout=5",
            timeout=30,
        ) as resp:
            rows = [
                json.loads(line) for line in resp.read().splitlines()
            ]
        assert rows
        assert all(r["trace_id"] == payload["trace_id"] for r in rows)
    finally:
        gateway.stop()
        router.close()


# --------------------------------------------------------------------- #
# /jobs limit
# --------------------------------------------------------------------- #
def test_jobs_endpoint_limit(tmp_path, mesh, monkeypatch):
    monkeypatch.setenv("PUMI_TPU_PROM_PORT", "0")
    router = _router(tmp_path, mesh)
    try:
        for r in synthetic_requests(mesh, 5, class_sizes=(24,)):
            router.submit(r, idempotency_key=f"key-{r.job_id}")
        base = router._exporter.url.replace("/metrics", "")

        def jobs(q=""):
            with urllib.request.urlopen(
                f"{base}/jobs{q}", timeout=5
            ) as resp:
                return json.loads(resp.read())
        full = jobs()
        assert full["total_jobs"] == 5
        assert full["limit"] == 500
        assert len(full["jobs"]) == 5
        capped = jobs("?limit=2")
        assert capped["limit"] == 2
        assert capped["total_jobs"] == 5
        assert len(capped["jobs"]) == 2
        assert capped["jobs"][0]["index"] >= capped["jobs"][1]["index"]
        assert jobs("?limit=bogus")["limit"] == 500
    finally:
        router.close()


# --------------------------------------------------------------------- #
# Scrapes beside a draining fleet
# --------------------------------------------------------------------- #
def test_concurrent_scrapes_parse_and_stay_monotonic(
    tmp_path, mesh, monkeypatch
):
    monkeypatch.setenv("PUMI_TPU_PROM_PORT", "0")
    router = _router(tmp_path, mesh)
    try:
        for r in synthetic_requests(
            mesh, 4, class_sizes=(24,), n_moves=4,
        ):
            router.submit(r, idempotency_key=f"key-{r.job_id}")
        base = router._exporter.url.replace("/metrics", "")
        stop = threading.Event()
        quanta: list[float] = []
        errors: list[str] = []

        def scrape(path, sink):
            while not stop.is_set():
                try:
                    with urllib.request.urlopen(
                        f"{base}{path}", timeout=10
                    ) as resp:
                        text = resp.read().decode()
                except OSError as e:  # noqa: PERF203
                    errors.append(f"{path}: {e}")
                    return
                problems = check_prom_text(text, path)
                if problems:
                    errors.extend(problems)
                    return
                total = 0.0
                for line in text.splitlines():
                    if line.startswith("pumi_quanta_total"):
                        total += float(line.rsplit(" ", 1)[1])
                sink.append(total)

        threads = [
            threading.Thread(
                target=scrape, args=("/fleetz", quanta), daemon=True
            ),
            threading.Thread(
                target=scrape, args=("/metrics", []), daemon=True
            ),
        ]
        for t in threads:
            t.start()
        router.run()
        # The CPU drain may end before a scrape saw a quantum: let the
        # scrapes go on until one after it has.
        deadline = time.monotonic() + 30
        while (len(quanta) < 2 or quanta[-1] == 0) and not errors \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors
        assert len(quanta) >= 2
        assert all(b >= a for a, b in zip(quanta, quanta[1:])), quanta
        assert quanta[-1] > 0
        assert check_fleetstats(load_dir(router.journal.dir)) == []
        doc = json.load(open(router.fleetstats_path()))
        util = doc["router_metrics"].get(
            "pumi_member_device_utilization"
        )
        assert util is not None and util["series"]
    finally:
        router.close()


def test_exports_match_jax():
    """``obs`` and ``serving`` export every name the JAX packages do, but
    ``validate_loaded`` (the JAX bank's check of loaded HLO; the port's
    bank holds built libraries, checked as it loads them)."""
    from pumiumtally_tpu import serving as jxserving
    from pumiumtally_tpu_torch import obs, serving

    assert set(jxobs.__all__) <= set(obs.__all__)
    assert set(jxserving.__all__) - set(serving.__all__) == {
        "validate_loaded"}
    assert obs.IDX == jxobs.IDX
    assert obs.default_registry() is obs.default_registry()
