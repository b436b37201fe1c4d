"""The port's span tracer, its black box, the checks of one job's trace
and the exporter (``pumiumtally_tpu_torch/obs/{trace,exporter}.py``), and
the scheduler's traces on the CPU.

Mirrors tests/test_obs_trace.py on a 2x2x2 box, jobs of 40 particles (64
padded) and 4 moves: span nesting and the ambient binding, spans on
exceptions, the off switch, the ring and the black box, the JSONL sink,
the Chrome export, the trace checks' defect classes, the exporter's
``/buildz``, extra endpoints and 500s, the rejection path's trace and
flight schema, a served job's whole trace with its device seconds, the
poison black box, served fluxes bitwise with tracing on and off, and the
trace id across a recovery in a fresh process.

Against the JAX package: the port's records pass JAX's
``scripts/teleview.py`` checks, the port's checks flag the same defects
as teleview's on the same records, and both packages' Chrome exports of
the same records are equal.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

from pumiumtally_tpu.obs import chrome_trace as jax_chrome_trace
from pumiumtally_tpu_torch import TallyConfig, build_box
from pumiumtally_tpu_torch.obs import (
    FLIGHT_SCHEMA,
    NO_PARENT,
    TRACE_SCHEMA,
    MetricsRegistry,
    SpanTracer,
    check_job_trace,
    job_trace,
    load_trace_records,
    trace_enabled,
)
from pumiumtally_tpu_torch.obs.exporter import MetricsExporter, build_info
from pumiumtally_tpu_torch.resilience.faultinject import (
    FaultInjector,
    parse_faults,
)
from pumiumtally_tpu_torch.serving import (
    JobRequest,
    TallyScheduler,
    run_saturation,
    synthetic_requests,
)
from pumiumtally_tpu_torch.serving.journal import (
    JOURNAL_SCHEMA,
    JOURNAL_SCHEMAS_READABLE,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import teleview  # noqa: E402

SAT = dict(class_sizes=(40,), n_moves=4, max_resident=1, quantum_moves=2,
           device="cpu")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in (
        "PUMI_TPU_MEGASTEP", "PUMI_TPU_KERNEL", "PUMI_TPU_IO_PIPELINE",
        "PUMI_TPU_TUNING", "PUMI_TPU_AOT_FAULT", "PUMI_TPU_PROM_PORT",
        "PUMI_TPU_FAULTS", "PUMI_TPU_TRACE", "PUMI_TPU_METRICS",
    ):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def mesh():
    return build_box(1.0, 1.0, 1.0, 2, 2, 2, device="cpu")


def _cfg(**kw):
    return TallyConfig(tolerance=1e-6, **kw)


def _both_checks(trace, job_id):
    """The port's and teleview's verdicts on one job's records, which
    must agree."""
    mine = check_job_trace(job_trace(trace, job_id), job_id)
    theirs = teleview.check_job_trace(teleview.job_trace(trace, job_id),
                                      job_id)
    assert mine == theirs
    return mine


# --------------------------------------------------------------------- #
# The span model
# --------------------------------------------------------------------- #
def test_span_nesting_and_ordering():
    tr = SpanTracer(enabled=True)
    tid = SpanTracer.new_trace()
    root = SpanTracer.root_id(tid)
    assert root == f"{tid}/root" == SpanTracer.root_id(tid)
    tr.event("submit", trace_id=tid, parent=root, job_id="j1", n=4)
    qid = tr.next_id()
    with tr.bind(tid, "j1", qid):
        assert tr.current == (tid, "j1", qid)
        with tr.span("aot_resolve", key="k") as sp:
            sp["outcome"] = "hit"
    tr.span_record("quantum", 0.25, trace_id=tid, parent=root,
                   job_id="j1", span_id=qid, k=4)
    tr.span_record("job", 1.0, trace_id=tid, parent=NO_PARENT,
                   job_id="j1", span_id=root, outcome="completed")
    recs = tr.records()
    assert [r["name"] for r in recs] == [
        "submit", "aot_resolve", "quantum", "job",
    ]
    assert all(r["schema"] == TRACE_SCHEMA for r in recs)
    assert all(r["trace_id"] == tid for r in recs)
    seqs = [r["seq"] for r in recs]
    assert seqs == sorted(seqs)
    by_name = {r["name"]: r for r in recs}
    assert by_name["aot_resolve"]["parent_id"] == qid
    assert by_name["aot_resolve"]["outcome"] == "hit"
    assert by_name["quantum"]["span_id"] == qid
    assert by_name["quantum"]["parent_id"] == root
    assert by_name["job"]["span_id"] == root
    assert by_name["job"]["parent_id"] is None
    assert tr.current == (None, None, None)
    # The record schema is the JAX tracer's, field for field.
    from pumiumtally_tpu.obs import SpanTracer as JaxTracer

    jt = JaxTracer(enabled=True)
    jt.event("submit", trace_id=tid, parent=root, job_id="j1", n=4)
    assert set(jt.records()[0]) == set(recs[0])
    assert _both_checks(recs, "j1") == []


def test_span_emitted_on_exception():
    tr = SpanTracer(enabled=True)
    with pytest.raises(RuntimeError, match="boom"):
        with tr.span("classify") as sp:
            sp["verdict"] = "pending"
            raise RuntimeError("boom")
    (rec,) = tr.records()
    assert rec["name"] == "classify"
    assert rec["error"].startswith("RuntimeError: boom")


def test_disabled_tracer_is_noop(monkeypatch):
    assert trace_enabled()
    monkeypatch.setenv("PUMI_TPU_TRACE", "off")
    assert not trace_enabled()
    tr = SpanTracer()
    assert tr.event("submit") is None
    with tr.span("quantum") as sp:
        sp["k"] = 1
    assert tr.span_record("job", 1.0) is None
    assert len(tr) == 0 and tr.records() == []


def test_ring_bound_and_blackbox_dump(tmp_path):
    tr = SpanTracer(capacity=8, enabled=True)
    for i in range(20):
        tr.event("tick", job_id="j", i=i)
    assert len(tr) == 8
    assert [r["i"] for r in tr.records()] == list(range(12, 20))
    path = str(tmp_path / "j.blackbox.json")
    doc = tr.dump(path, reason="poisoned:persistent", meta={"job_id": "j"})
    with open(path) as fh:
        on_disk = json.load(fh)
    assert on_disk == json.loads(json.dumps(doc))
    assert on_disk["kind"] == "blackbox"
    assert on_disk["schema"] == TRACE_SCHEMA
    assert on_disk["reason"] == "poisoned:persistent"
    assert on_disk["meta"] == {"job_id": "j"}
    assert [r["i"] for r in on_disk["records"]] == list(range(12, 20))
    with pytest.raises(ValueError, match="capacity"):
        SpanTracer(capacity=0)


def test_trace_jsonl_sink_streams_records(tmp_path):
    sink = str(tmp_path / "TRACE.jsonl")
    tr = SpanTracer(sink=sink, enabled=True)
    tid = SpanTracer.new_trace()
    tr.event("submit", trace_id=tid, job_id="j1")
    tr.span_record("job", 0.5, trace_id=tid, job_id="j1",
                   span_id=SpanTracer.root_id(tid), parent=NO_PARENT)
    lines = [
        json.loads(x)
        for x in open(sink).read().splitlines() if x.strip()
    ]
    assert [r["name"] for r in lines] == ["submit", "job"]
    tr.dump(str(tmp_path / "x.blackbox.json"), reason="shutdown")
    recs = load_trace_records(str(tmp_path))
    assert len(recs) == 2
    assert recs == teleview.load_trace_records(str(tmp_path))


def test_chrome_trace_export_is_lossless():
    tr = SpanTracer(enabled=True)
    tid = SpanTracer.new_trace()
    tr.event("submit", trace_id=tid, job_id="j1")
    tr.span_record("quantum", 0.5, trace_id=tid, job_id="j1", k=4)
    doc = tr.chrome()
    events = [e for e in doc["traceEvents"] if e.get("ph") in ("X", "i")]
    assert len(events) == 2
    phases = {e["args"]["name"]: e["ph"] for e in events}
    assert phases == {"submit": "i", "quantum": "X"}
    args = [e["args"] for e in events]
    assert all(a["trace_id"] == tid and "span_id" in a for a in args)
    assert doc == jax_chrome_trace(tr.records())


# --------------------------------------------------------------------- #
# The checks of one job's trace
# --------------------------------------------------------------------- #
def _mk(name, *, kind="span", tid="t1", sid, parent=None, pid=1, ts=1.0,
        seq=0, **attrs):
    return dict(
        schema=TRACE_SCHEMA, kind=kind, name=name, trace_id=tid,
        span_id=sid, parent_id=parent, job_id="jX", pid=pid, ts=ts,
        seconds=0.0, seq=seq, **attrs,
    )


def test_teleview_check_flags_each_defect_class():
    root = "t1/root"
    good = [
        _mk("submit", kind="event", sid="a", parent=root, seq=0),
        _mk("quantum", sid="b", parent=root, seq=1),
        _mk("job", sid=root, seq=2),
    ]
    assert _both_checks(good, "jX") == []
    assert check_job_trace([], "jX") == ["no span records for job jX"]
    forked = good + [_mk("retry", kind="event", tid="t2", sid="z", seq=3)]
    assert any("one trace_id" in p for p in _both_checks(forked, "jX"))
    assert any("no submit" in p for p in _both_checks(good[1:], "jX"))
    assert any("root span" in p for p in _both_checks(good[:2], "jX"))
    torn = good + [_mk("probe", sid="c", parent="gone", seq=4)]
    assert any("unresolvable" in p for p in _both_checks(torn, "jX"))
    split = good + [_mk("quantum", sid="d", parent=root, pid=2, seq=5)]
    assert any("recovered" in p for p in _both_checks(split, "jX"))
    healed = split + [
        _mk("recovered", kind="event", sid="e", parent=root, pid=2, seq=6)
    ]
    assert _both_checks(healed, "jX") == []
    future = [dict(r, schema=99, new_field="x") for r in good]
    assert _both_checks(future, "jX") == []


# --------------------------------------------------------------------- #
# The exporter
# --------------------------------------------------------------------- #
def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.read().decode()


def test_exporter_buildz_and_extra_endpoints():
    reg = MetricsRegistry()
    reg.counter("demo_total", "demo").inc()
    exp = MetricsExporter(
        reg, port=0, endpoints={"/jobs": lambda: {"jobs": [1, 2]}},
    )
    base = exp.url.replace("/metrics", "")
    try:
        status, body = _get(base + "/buildz")
        build = json.loads(body)
        assert status == 200
        for key in ("package", "version", "backend", "device",
                    "n_devices", "torch", "cuda", "nvcc", "pid"):
            assert key in build, key
        assert build["package"] == "pumiumtally_tpu_torch"
        assert build["backend"] == "cpu" and build["pid"] == os.getpid()
        assert build["endpoints"] == ["/metrics", "/healthz", "/buildz",
                                      "/jobs"]
        status, body = _get(base + "/metrics")
        assert status == 200 and "demo_total 1" in body
        status, body = _get(base + "/jobs")
        assert status == 200 and json.loads(body) == {"jobs": [1, 2]}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + "/nope")
        err_body = ei.value.read().decode()
        assert ei.value.code == 404
        for ep in ("/metrics", "/healthz", "/buildz", "/jobs"):
            assert ep in err_body, err_body
    finally:
        exp.stop()
    assert isinstance(build_info(), dict)


def test_exporter_endpoint_exception_is_500_not_crash():
    reg = MetricsRegistry()

    def broken():
        raise RuntimeError("collector died")

    exp = MetricsExporter(reg, port=0, endpoints={"/jobs": broken})
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(exp.url.replace("/metrics", "/jobs"))
        assert ei.value.code == 500
        status, body = _get(exp.url.replace("/metrics", "/healthz"))
        assert status == 200 and body == "ok\n"
    finally:
        exp.stop()
    exp.stop()  # idempotent


def test_facade_exporter_starts_on_the_knob_and_close_stops_it(
        mesh, monkeypatch):
    from pumiumtally_tpu_torch import PumiTally

    assert PumiTally(mesh, 4, _cfg(), device="cpu")._exporter is None
    monkeypatch.setenv("PUMI_TPU_PROM_PORT", "0")
    t = PumiTally(mesh, 4, _cfg(), device="cpu")
    url = t._exporter.url
    status, body = _get(url)
    assert status == 200 and "pumi_" in body
    t.close()
    assert t._exporter is None
    with pytest.raises(urllib.error.URLError):
        _get(url)
    t.close()


# --------------------------------------------------------------------- #
# The scheduler's traces
# --------------------------------------------------------------------- #
def test_rejection_path_traced_and_flight_schema(mesh, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("PUMI_TPU_PROM_PORT", "0")
    sched = TallyScheduler(
        mesh, _cfg(), max_resident=1, max_queued=1,
        journal_dir=str(tmp_path / "j"), handle_signals=False,
        device="cpu",
    )
    try:
        for i in range(3):
            sched.submit(JobRequest(
                origins=np.full((4, 3), 0.5), n_moves=2, job_id=f"q{i}",
            ))
        recs = sched.recorder.records()
        assert recs and all(r["schema"] == FLIGHT_SCHEMA for r in recs)
        assert all("job_id" in r for r in recs)
        trace = job_trace(sched.tracer.records(), "q2")
        assert _both_checks(trace, "q2") == []
        job_span = [r for r in trace if r["name"] == "job"][0]
        assert job_span["outcome"] == "rejected"
        assert JOURNAL_SCHEMA == 2 and 1 in JOURNAL_SCHEMAS_READABLE
        doc = sched.journal.load()
        assert doc["schema"] == JOURNAL_SCHEMA
        assert doc["jobs"]["q2"]["trace_id"] == sched.job("q2").trace_id
        base = sched._exporter.url.replace("/metrics", "")
        status, body = _get(base + "/jobs")
        rows = json.loads(body)
        assert status == 200 and rows["schema"] == FLIGHT_SCHEMA
        byid = {r["id"]: r for r in rows["jobs"]}
        assert byid["q2"]["outcome"] == "rejected"
        assert byid["q2"]["trace_id"] == sched.job("q2").trace_id
        assert json.loads(_get(base + "/jobs?limit=1")[1])["limit"] == 1
        status, body = _get(base + "/trace")
        chrome = json.loads(body)
        assert status == 200 and any(
            e.get("args", {}).get("job_id") == "q2"
            for e in chrome["traceEvents"]
        )
        text = sched.registry.render_prometheus()
        assert "pumi_job_e2e_seconds" in text
    finally:
        sched.close()
    bb = os.path.join(str(tmp_path / "j"), "shutdown.blackbox.json")
    with open(bb) as fh:
        assert json.load(fh)["kind"] == "blackbox"


def test_full_lifecycle_trace_and_device_attribution(mesh, tmp_path):
    jdir = str(tmp_path / "j")
    out = run_saturation(mesh, _cfg(), n_jobs=2, journal_dir=jdir, **SAT)
    recs = load_trace_records(jdir)
    for row in out["per_job"]:
        jid = row["job"]
        trace = job_trace(recs, jid)
        assert _both_checks(recs, jid) == [], jid
        names = [r["name"] for r in trace]
        for expected in ("submit", "queued", "admit", "quantum", "job"):
            assert expected in names, (jid, names)
        assert names.index("submit") < names.index("admit") \
            < names.index("quantum") < names.index("job")
        q_dev = sum(
            r["device_seconds"] for r in trace if r["name"] == "quantum"
        )
        assert q_dev > 0
        assert row["device_seconds"] == pytest.approx(q_dev, abs=1e-3)
        job_span = [r for r in trace if r["name"] == "job"][0]
        assert job_span["outcome"] == "completed"
        assert job_span["device_seconds"] == pytest.approx(q_dev, abs=1e-3)
    assert out["scheduler"]["device_seconds"] > 0


def test_poison_blackbox_contains_final_spans(mesh, tmp_path):
    bdir = str(tmp_path / "bb")
    out = run_saturation(
        mesh, _cfg(), n_jobs=2, blackbox_dir=bdir, job_retries=1,
        faults=FaultInjector(parse_faults("poison_job:1")), **SAT,
    )
    rows = {r["job"]: r for r in out["per_job"]}
    assert rows["sat-0001"]["outcome"] == "poisoned"
    with open(os.path.join(bdir, "sat-0001.blackbox.json")) as fh:
        doc = json.load(fh)
    assert doc["kind"] == "blackbox"
    assert doc["reason"].startswith("poisoned:")
    assert doc["meta"]["job_id"] == "sat-0001"
    assert doc["meta"]["trace_id"] == rows["sat-0001"]["trace_id"]
    mine = job_trace(doc["records"], "sat-0001")
    job_span = [r for r in mine if r["name"] == "job"][0]
    assert job_span["outcome"] == "poisoned"
    quantum = [r for r in mine if r["name"] == "quantum"]
    assert quantum and "error" in quantum[-1]
    # The coordinator's classify span sits under the failing quantum.
    classify = [r for r in mine if r["name"] == "classify"]
    assert classify and classify[0]["parent_id"] == quantum[-1]["span_id"]


def test_bitwise_parity_tracing_on_vs_off(mesh, monkeypatch):
    kw = dict(SAT, n_jobs=2, seed=9)
    on = run_saturation(mesh, _cfg(), **kw)
    monkeypatch.setenv("PUMI_TPU_TRACE", "off")
    off = run_saturation(mesh, _cfg(), **kw)
    assert sorted(on["results"]) == sorted(off["results"]) != []
    for jid in on["results"]:
        assert on["results"][jid].tobytes() == \
            off["results"][jid].tobytes(), jid


def test_trace_id_survives_subprocess_recovery(mesh, tmp_path):
    """Interrupt a journaled scheduler, recover it in a fresh process, and
    read each job's one trace across both pids from the journal alone."""
    jdir = str(tmp_path / "journal")
    sched = TallyScheduler(
        mesh, _cfg(), max_resident=1, quantum_moves=2,
        journal_dir=jdir, handle_signals=False, device="cpu",
    )
    for r in synthetic_requests(mesh, 3, class_sizes=(40,), n_moves=4,
                                seed=5):
        sched.submit(r)
    for _ in range(3):
        sched.step()
    assert any(j.moves_done > 0 and j.outcome is None
               for j in sched.jobs())
    trace_ids = {j.id: j.trace_id for j in sched.jobs()}
    kill_pid = os.getpid()
    sched.abandon()

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PUMI_TPU_")}
    script = (
        "import sys; sys.path.insert(0, {root!r})\n"
        "from pumiumtally_tpu_torch import TallyConfig, build_box\n"
        "from pumiumtally_tpu_torch.serving import run_saturation\n"
        "mesh = build_box(1.0, 1.0, 1.0, 2, 2, 2, device='cpu')\n"
        "out = run_saturation(\n"
        "    mesh, TallyConfig(tolerance=1e-6), n_jobs=3,\n"
        "    class_sizes=(40,), n_moves=4, seed=5, max_resident=1,\n"
        "    quantum_moves=2, journal_dir={journal!r}, resume=True,\n"
        "    device='cpu')\n"
        "assert out['scheduler']['recovered'] >= 1\n"
    ).format(root=ROOT, journal=jdir)
    proc = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    recs = load_trace_records(jdir)
    for jid, tid in trace_ids.items():
        trace = job_trace(recs, jid)
        assert _both_checks(recs, jid) == [], jid
        assert {r["trace_id"] for r in trace} == {tid}, jid
        pids = {r["pid"] for r in trace}
        if len(pids) > 1:
            assert kill_pid in pids
            assert "recovered" in [r["name"] for r in trace]
    assert any(
        len({r["pid"] for r in job_trace(recs, jid)}) > 1
        for jid in trace_ids
    )
