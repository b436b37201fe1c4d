"""The port's telemetry core on ``device="cpu"``: ``utils/log.py``,
``obs/registry.py``, ``obs/recorder.py``, ``obs/telemetry.py`` and
``PumiTally.telemetry()``.

Mirrors tests/test_logging.py (all four), the registry and flight-recorder
tests of tests/test_obs.py (:30-:139) and its facade telemetry tests
(:321, :345, :355, :365), and the recorder and registry concurrency tests
of tests/test_convergence.py (:545, :787, :815). Where the JAX package
computes the same thing, both packages get the same inputs: the
registries' Prometheus text is equal byte for byte, and the facades'
telemetry totals are equal (counts exactly, the flux at the float64
parity bar of 1e-10 relative).
"""
from __future__ import annotations

import json
import logging
import threading

import numpy as np
import pytest
import torch

from pumiumtally_tpu.obs import MetricsRegistry as JRegistry
from pumiumtally_tpu.utils import log as jlog
from pumiumtally_tpu_torch.obs.recorder import FlightRecorder
from pumiumtally_tpu_torch.obs.registry import MetricsRegistry
from pumiumtally_tpu_torch.obs.telemetry import TallyTelemetry
from pumiumtally_tpu_torch.utils import log as plog
from pumiumtally_tpu_torch.utils.profiling import device_memory_stats
from pumiumtally_tpu_torch.utils.timing import TallyTimes
from torch_twins import assert_tallies_agree, move_both, twin_meshes, twin_tallies


def _err_lines(capsys):
    return capsys.readouterr().err.strip().split("\n")


# --------------------------------------------------------------------- #
# utils/log.py (tests/test_logging.py)
# --------------------------------------------------------------------- #
def test_tagged_format(capsys):
    plog.log_info("mesh loaded", ntet=6)
    plog.log_warn("truncated")
    ours = _err_lines(capsys)
    jlog.log_info("mesh loaded", ntet=6)
    jlog.log_warn("truncated")
    assert ours == ["[INFO] mesh loaded ntet=6", "[WARN] truncated"]
    assert ours == _err_lines(capsys)


def test_level_filtering(capsys):
    logger = plog.get_logger()
    old = logger.level
    try:
        logger.setLevel(logging.WARNING)
        plog.log_info("hidden")
        plog.log_error("shown")
        assert _err_lines(capsys) == ["[ERROR] shown"]
    finally:
        logger.setLevel(old)


def test_json_mode(monkeypatch, capsys):
    monkeypatch.setenv("PUMI_TPU_LOG_JSON", "1")
    plog.log_time("tally", 1.25, steps=10)
    (line,) = _err_lines(capsys)
    rec = json.loads(line)
    assert rec["level"] == "info"
    assert rec["phase"] == "tally"
    assert rec["seconds"] == 1.25
    assert rec["steps"] == 10
    jlog.log_time("tally", 1.25, steps=10)
    (jline,) = _err_lines(capsys)
    jrec = json.loads(jline)
    assert {k: v for k, v in rec.items() if k != "ts"} == {
        k: v for k, v in jrec.items() if k != "ts"}


def test_tally_times_print_goes_through_logger(capsys):
    t = TallyTimes(initialization_time=1.0, total_time_to_tally=2.0)
    t.print_times()
    lines = _err_lines(capsys)
    assert any("initialization" in ln and "1.0" in ln for ln in lines)
    assert any("total" in ln and "3.0" in ln for ln in lines)


def test_tally_times_per_move_report(capsys):
    TallyTimes(total_time_to_tally=3.0, n_moves=4).print_times()
    err = capsys.readouterr().err
    assert "tally_per_move" in err
    assert "0.75" in err
    assert "n_moves=4" in err


# --------------------------------------------------------------------- #
# obs/registry.py (tests/test_obs.py :30-:99)
# --------------------------------------------------------------------- #
def test_counter_semantics():
    reg = MetricsRegistry()
    c = reg.counter("hits", "help text")
    c.inc()
    c.inc(4)
    assert c.value() == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    assert reg.counter("hits") is c


def test_labeled_series_are_independent():
    reg = MetricsRegistry()
    c = reg.counter("reqs")
    c.inc(2, device="cuda:0")
    c.inc(3, device="cuda:1")
    c.inc(7)
    assert c.value(device="cuda:0") == 2
    assert c.value(device="cuda:1") == 3
    assert c.value() == 7
    snap = reg.snapshot()["reqs"]
    assert snap["type"] == "counter"
    assert len(snap["series"]) == 3


def test_gauge_set_and_inc():
    g = MetricsRegistry().gauge("depth")
    g.set(10)
    g.inc(5)
    g.dec(2)
    assert g.value() == 13


def test_histogram_cumulative_buckets():
    h = MetricsRegistry().histogram("lat", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    s = h.value()
    assert s["count"] == 5
    assert s["sum"] == pytest.approx(56.05)
    assert s["buckets"] == [1, 3, 4]


def test_type_mismatch_raises():
    reg = MetricsRegistry()
    reg.counter("x")
    with pytest.raises(ValueError):
        reg.gauge("x")


def _fill(reg, rng):
    """The same observations into either package's registry."""
    reg.counter("seg_total", "segments").inc(9, kind="move")
    reg.gauge("occ", "occupancy").set(0.75)
    h = reg.histogram("lat", "latency", buckets=(0.01, 0.1, 1.0))
    for v in rng.exponential(0.1, 40):
        h.observe(float(v))
    c = reg.counter("reqs_total", "requests")
    for dev in rng.integers(0, 3, 25):
        c.inc(1, device=f"cuda:{dev}")


def test_prometheus_exposition_equals_jax():
    reg, jreg = MetricsRegistry(), JRegistry()
    _fill(reg, np.random.default_rng(3))
    _fill(jreg, np.random.default_rng(3))
    text = reg.render_prometheus()
    assert text == jreg.render_prometheus()
    assert reg.snapshot() == jreg.snapshot()
    assert "# TYPE seg_total counter" in text
    assert 'seg_total{kind="move"} 9' in text
    assert "occ 0.75" in text
    assert 'lat_bucket{le="+Inf"} 40' in text


def test_registry_rejects_conflicting_reregistration():
    reg = MetricsRegistry()
    c = reg.counter("pumi_thing_total", "what it counts")
    assert reg.counter("pumi_thing_total", "what it counts") is c
    assert reg.counter("pumi_thing_total") is c
    with pytest.raises(ValueError, match="conflicting help"):
        reg.counter("pumi_thing_total", "a different meaning")
    with pytest.raises(ValueError, match="already registered as"):
        reg.gauge("pumi_thing_total", "what it counts")


def test_registry_render_safe_under_concurrent_registration():
    reg = MetricsRegistry()
    stop = threading.Event()
    errs = []

    def reader():
        while not stop.is_set():
            try:
                reg.render_prometheus()
                reg.snapshot()
            except Exception as e:  # the failure this test looks for
                errs.append(e)
                return

    th = threading.Thread(target=reader)
    th.start()
    try:
        for i in range(400):
            reg.counter(f"pumi_stress_{i}_total", "stress family").inc()
    finally:
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive()
    assert not errs, errs


# --------------------------------------------------------------------- #
# obs/recorder.py (tests/test_obs.py :102-:150)
# --------------------------------------------------------------------- #
def test_recorder_ring_and_seq():
    rec = FlightRecorder(capacity=3)
    for i in range(5):
        rec.record("move", move=i)
    assert len(rec) == 3
    assert rec.total_recorded == 5
    assert [r["move"] for r in rec.records()] == [2, 3, 4]
    assert [r["seq"] for r in rec.tail(2)] == [3, 4]


def test_recorder_jsonl_sink_schema(tmp_path, monkeypatch):
    path = tmp_path / "metrics.jsonl"
    monkeypatch.setenv("PUMI_TPU_METRICS", f"jsonl:{path}")
    rec = FlightRecorder()
    rec.record("move", move=1, segments=42, crossings=7)
    rec.record("memory", phase="vtk_write", devices={})
    lines = path.read_text().strip().split("\n")
    assert len(lines) == 2
    first = json.loads(lines[0])
    assert set(first) == {
        "ts", "level", "msg", "seq", "kind", "move", "segments",
        "crossings",
    }
    assert first["level"] == "metric"
    assert first["msg"] == "move" and first["kind"] == "move"
    assert first["segments"] == 42
    second = json.loads(lines[1])
    assert second["kind"] == "memory" and second["phase"] == "vtk_write"


def test_no_sink_is_silent(monkeypatch):
    monkeypatch.delenv("PUMI_TPU_METRICS", raising=False)
    FlightRecorder().record("move", move=0)


def test_unwritable_sink_never_crashes(monkeypatch, capsys):
    monkeypatch.setenv(
        "PUMI_TPU_METRICS", "jsonl:/nonexistent_dir_pumi_torch/m.jsonl"
    )
    rec = FlightRecorder()
    rec.record("move", move=0)
    rec.record("move", move=1)
    assert capsys.readouterr().err.count("unwritable") == 1
    assert rec.total_recorded == 2


def test_flight_recorder_concurrent_records(monkeypatch):
    monkeypatch.delenv("PUMI_TPU_METRICS", raising=False)
    rec = FlightRecorder(capacity=8192)
    n_threads, per = 8, 400

    def work(k):
        for i in range(per):
            rec.record("stress", thread=k, i=i)

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    seqs = [r["seq"] for r in rec.records()]
    assert rec.total_recorded == n_threads * per
    assert set(seqs) == set(range(n_threads * per))


# --------------------------------------------------------------------- #
# obs/telemetry.py and the facade (tests/test_obs.py :321-:365)
# --------------------------------------------------------------------- #
def test_telemetry_payload_keys_match_jax():
    from pumiumtally_tpu.obs import TallyTelemetry as JTelemetry

    ours = TallyTelemetry("PumiTally").snapshot(times=TallyTimes())
    theirs = JTelemetry("PumiTally").snapshot(times=TallyTimes())
    assert set(ours) == set(theirs)
    assert set(ours["totals"]) == set(theirs["totals"])
    assert set(ours["integrity"]) == set(theirs["integrity"])
    assert set(ours["metrics"]) == set(theirs["metrics"])
    for name, fam in ours["metrics"].items():
        assert fam["help"] == theirs["metrics"][name]["help"], name
        assert fam["type"] == theirs["metrics"][name]["type"], name


def _drive(tallies, n, moves, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.1, 0.9, (n, 3))
    for t in tallies:
        t.initialize_particle_location(pos.ravel().copy())
    for _ in range(moves):
        dest = np.clip(pos + rng.normal(0, 0.2, (n, 3)), 0.02, 0.98)
        outs = move_both(tallies, (
            dest.ravel(), np.ones(n, np.int8), rng.uniform(0.5, 2.0, n),
            rng.integers(0, 2, n).astype(np.int32),
            np.full(n, -1, np.int32)))
        pos = outs[-1][0].reshape(n, 3)


@pytest.mark.parametrize("io", ["packed", "overlap", "legacy"])
def test_pumitally_telemetry_snapshot(io, monkeypatch):
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    n = 16
    jt, pt = twin_tallies(twin_meshes(nx=2), n, n_groups=2,
                          tolerance=1e-8, io_pipeline=io)
    _drive((jt, pt), n, moves=3)
    assert_tallies_agree(jt, pt)
    snap, jsnap = pt.telemetry(), jt.telemetry()
    assert set(snap) == set(jsnap)
    assert snap["facade"] == "PumiTally"
    for key in ("moves", "segments", "crossings", "truncated", "chase_hops",
                "quarantined", "rewalked", "lost"):
        assert snap["totals"][key] == jsnap["totals"][key], key
    assert snap["totals"]["moves"] == 3
    assert snap["totals"]["segments"] == pt.total_segments > 0
    want = {"packed": (4, 4), "overlap": (4, 4), "legacy": (1 + 12, 4)}[io]
    assert (snap["totals"]["h2d_transfers"],
            snap["totals"]["d2h_transfers"]) == want
    assert snap["totals"]["h2d_transfers"] == pt.io["h2d_transfers"]
    assert snap["totals"]["d2h_bytes"] == pt.io["d2h_bytes"]
    kinds = [r["kind"] for r in snap["per_move"]]
    assert kinds.count("move") == 3
    assert "initial_search" in kinds and "memory" in kinds
    assert snap["times"]["n_moves"] == 3
    for r in snap["per_move"]:
        if r["kind"] == "move":
            assert {"move", "seconds", "crossings", "segments", "truncated",
                    "occupancy", "h2d_transfers"} <= set(r)
    assert [r["move"] for r in snap["per_move"] if r["kind"] == "move"] \
        == [1, 2, 3]
    assert snap["metrics"]["pumi_moves_total"]["series"][0]["value"] == 3
    assert "pumi_segments_total" in pt.metrics.render_prometheus()
    assert snap["convergence"] == {"enabled": False}
    assert snap["memory"] == device_memory_stats() == {}


def test_overlap_defers_the_fold_to_the_next_move(monkeypatch):
    """Under "overlap" a move's flight record is folded after the next
    move's walk (or at a read of the telemetry), never inside its own
    call."""
    monkeypatch.delenv("PUMI_TPU_IO_PIPELINE", raising=False)
    n = 8
    _, pt = twin_tallies(twin_meshes(nx=2), n, n_groups=2,
                         io_pipeline="overlap")
    rng = np.random.default_rng(1)
    pt.initialize_particle_location(rng.uniform(0.1, 0.9, 3 * n))
    recorder = pt._telemetry.recorder

    def move():
        pt.move_to_next_location(
            rng.uniform(0.1, 0.9, 3 * n), np.ones(n, np.int8), np.ones(n),
            np.zeros(n, np.int32), np.zeros(n, np.int32))

    move()
    assert [r["kind"] for r in recorder.records()].count("move") == 0
    move()
    assert [r["move"] for r in recorder.records()
            if r["kind"] == "move"] == [1]
    assert pt.telemetry()["totals"]["moves"] == 2


def test_pumitally_telemetry_jsonl_stream(tmp_path, monkeypatch):
    path = tmp_path / "run.jsonl"
    monkeypatch.setenv("PUMI_TPU_METRICS", f"jsonl:{path}")
    n = 16
    _, pt = twin_tallies(twin_meshes(nx=2), n, n_groups=2)
    _drive((pt,), n, moves=2)
    recs = [json.loads(ln) for ln in path.read_text().strip().split("\n")]
    moves = [r for r in recs if r["kind"] == "move"]
    assert len(moves) == 2
    assert sum(r["segments"] for r in moves) == pt.total_segments


def test_pumitally_walk_stats_off_falls_back():
    n = 16
    jt, pt = twin_tallies(twin_meshes(nx=2), n, n_groups=2,
                          walk_stats=False)
    _drive((jt, pt), n, moves=2)
    snap = pt.telemetry()
    assert pt.total_segments == jt.total_segments > 0
    assert snap["totals"]["moves"] == 2
    assert snap["totals"]["crossings"] == 0
    assert snap["totals"]["segments"] == jt.telemetry()["totals"]["segments"]


def test_device_memory_stats_off_the_card():
    """Off the card (no CUDA in this process) there is nothing to
    report; on the card ``tests/test_torch_cuda.py`` reads it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert device_memory_stats() == {}
