"""The port's spans and host-read counts (``utils/timing.py``) on
``device="cpu"``, and on the card (marker ``cuda``).

* Off (no clock bound, no profiler recording) a span is one shared no-op
  and no profiler range is opened.
* A K = 2 ``run_source_moves`` under ``PumiTally.step_clock`` gives the
  rows the benchmark reads (``sample``, ``walk``, ``physics``, ``folds``
  a fused move, then ``tail read``); its spans nest under the call and the
  chunk, and self times are durations less children's, also in the
  watchdog's worker thread (``move_deadline_s``).
* Under ``profile_trace`` the spans are ``pumi:`` ranges, nested as the
  program nests.
* The benchmark's three readers of the clock (``tallybench/metrics``) do
  their arithmetic on a hand-built clock.
* On the card: a K = 2 chunk counts the host reads ``count`` 2, ``bucket``
  2, ``tail`` 1, and an ordered walk that relaunches has a ``count_wait``
  row for each of its two reads.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
from pumiumtally_tpu_torch.ops.source import SourceParams
from pumiumtally_tpu_torch.utils import timing
from pumiumtally_tpu_torch.utils.profiling import profile_trace
from pumiumtally_tpu_torch.utils.timing import StepClock

ROOT = Path(__file__).resolve().parent.parent
N = 64
SRC = SourceParams(default_sigma_t=4.0, default_absorption=0.3,
                   survival_weight=0.2, seed=13)
MOVE_ROWS = ["sample", "walk", "physics", "folds"]


def _tally(device="cpu", n=N, **kw):
    mesh = build_box(1.0, 1.0, 1.0, 4, 4, 4, dtype=torch.float64,
                     device=device)
    t = PumiTally(mesh, n, TallyConfig(n_groups=2, dtype=torch.float64,
                                       tolerance=1e-8, megastep=2, **kw),
                  device=device)
    pos = np.random.default_rng(3).uniform(0.1, 0.9, (n, 3))
    t.initialize_particle_location(pos.ravel().copy())
    return t


def _by_id(clock):
    return {s["id"]: s for s in clock.spans()}


def test_span_off_is_shared_noop(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        Counting)
    assert timing.span("a") is timing.span("b") is timing._OFF
    assert timing.step("c") is timing._OFF
    timing.count("count")   # nowhere to count: no error
    t = _tally()
    t.run_source_moves(2, SRC)
    assert entered == []


def test_source_loop_rows_and_nesting():
    t = _tally()
    t.step_clock = clock = StepClock("cpu")
    t.run_source_moves(2, SRC)
    assert [r["step"] for r in clock.rows()] == MOVE_ROWS * 2 + [
        "tail read"]
    assert clock.rows() == []
    spans = _by_id(clock)
    (call,) = [s for s in spans.values() if s["parent"] is None]
    assert call["name"] == "run_source_moves"
    assert all(s["call"] == "run_source_moves" for s in spans.values())
    (chunk,) = [s for s in spans.values() if s["name"] == "chunk"]
    assert spans[chunk["parent"]] is call
    walks = [s for s in spans.values() if s["name"] == "walk"]
    assert len(walks) == 2
    assert all(s["parent"] == chunk["id"] for s in walks)
    names = {s["name"] for s in spans.values()
             if s["parent"] == call["id"]}
    assert names == {"stage lanes", "chunk", "bookkeeping"}
    # Self time: the duration less the children's.
    for s in spans.values():
        kids = sum(k["end_ns"] - k["start_ns"] for k in spans.values()
                   if k["parent"] == s["id"])
        assert s["self_ns"] == s["end_ns"] - s["start_ns"] - kids
        assert s["start_ns"] <= s["end_ns"]
    tot = clock.totals()["run_source_moves"]
    assert tot["walk"]["count"] == 2 and tot["chunk"]["count"] == 1
    assert tot["run_source_moves"]["host_ns"] == (
        call["end_ns"] - call["start_ns"])
    # The CPU walk reads nothing from a card.
    assert not [k for k in tot if k.startswith("read:")]
    assert timing.last_clock() is clock


def test_other_calls_have_their_own_totals():
    t = _tally()
    t.step_clock = clock = StepClock("cpu")
    t.initialize_particle_location(
        np.random.default_rng(5).uniform(0.1, 0.9, (N, 3)).ravel())
    t.run_source_moves(2, SRC)
    tot = clock.totals()
    assert set(tot) == {"initialize_particle_location", "run_source_moves"}
    assert tot["initialize_particle_location"][
        "initialize_particle_location"]["count"] == 1
    # A tally without a clock binds none, and records nothing here.
    t.step_clock = None
    t.run_source_moves(2, SRC)
    assert clock.totals() == tot


def test_worker_thread_spans_sit_under_chunk():
    t = _tally(move_deadline_s=60.0)
    t.step_clock = clock = StepClock("cpu")
    # Two chunks: the first of its kind runs inline, the second in the
    # watchdog's worker thread.
    t.run_source_moves(4, SRC)
    spans = _by_id(clock)
    chunks = {s["id"] for s in spans.values() if s["name"] == "chunk"}
    walks = [s for s in spans.values() if s["name"] == "walk"]
    assert len(chunks) == 2 and len(walks) == 4
    assert all(s["parent"] in chunks for s in walks)
    reads = [s for s in spans.values() if s["name"] == "tail read"]
    assert len(reads) == 2 and all(s["parent"] in chunks for s in reads)
    assert [r["step"] for r in clock.rows()] == (
        MOVE_ROWS * 2 + ["tail read"]) * 2


def test_profile_trace_nests_pumi_ranges(tmp_path):
    t = _tally()
    with profile_trace(str(tmp_path)):
        t.run_source_moves(2, SRC)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]

    def ranges(name):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events if e.get("name") == name]

    (outer,) = ranges("pumi:run_source_moves")
    walks = ranges("pumi:walk")
    assert len(walks) == 2
    assert all(outer[0] <= a <= b <= outer[1] for a, b in walks)
    assert len(ranges("pumi:chunk")) == 1


def _reader(name):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    path = ROOT / "tallybench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "test_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Clock:
    def __init__(self, device, totals):
        self.device = torch.device(device)
        self._totals = totals

    def totals(self):
        return self._totals


def _t(count, host_ns=0, self_ns=0):
    return dict(count=count, host_ns=host_ns, self_ns=self_ns)


READERS = ("host_syncs_per_move.source", "loop_host_ms.source",
           "walk_host_ms.source", "sparse_fold_pct.source")


@pytest.mark.parametrize("name,want", [
    # 9 reads over 3 moves.
    ("host_syncs_per_move.source", 3.0),
    # Self times of the loop's four spans: 6e6 ns over 3 moves.
    ("loop_host_ms.source", 2.0),
    # The walk's 15e6 ns less 3e6 of waits, over 3 moves.
    ("walk_host_ms.source", 4.0),
    # Two sparse folds and one dense.
    ("sparse_fold_pct.source", 200.0 / 3.0),
])
def test_readers_arithmetic(monkeypatch, name, want):
    call = {
        "run_source_moves": _t(1, 30_000_000, 1_000_000),
        "stage lanes": _t(1, 500_000, 500_000),
        "chunk": _t(3, 20_000_000, 3_000_000),
        "bookkeeping": _t(6, 1_500_000, 1_500_000),
        "walk": _t(3, 15_000_000, 2_000_000),
        "count_wait": _t(3, 2_000_000, 2_000_000),
        "bucket_wait": _t(3, 1_000_000, 1_000_000),
        "sample": _t(3, 900_000, 900_000),
        "scatter.fold": _t(1, 300_000, 300_000),
        "scatter.sparse": _t(2, 100_000, 100_000),
        "read:count": _t(3), "read:bucket": _t(3), "read:tail": _t(3),
    }
    totals = {"run_source_moves": call,
              "initialize_particle_location": {"walk": _t(7, 9, 9),
                                               "read:tail": _t(5)}}
    read = _reader(name)
    monkeypatch.setattr(timing, "last_clock",
                        lambda: _Clock("cuda", totals))
    assert read(None) == pytest.approx(want, rel=1e-12)
    # Nothing to read: no clock, a clock off the card, no fused move.
    for clock in (None, _Clock("cpu", totals),
                  _Clock("cuda", {"run_source_moves": {}})):
        monkeypatch.setattr(timing, "last_clock", lambda c=clock: c)
        assert read(None) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_last_clock(monkeypatch, name):
    """A program without ``last_clock`` (an earlier one) gives nothing."""
    monkeypatch.delattr(timing, "last_clock")
    assert _reader(name)(None) is None


def test_sparse_share_needs_the_sparse_fold_and_a_fold(monkeypatch):
    """A program without the sparse fold (an earlier one) gives nothing,
    and so does a window without a fold; a window of dense folds only
    reads 0."""
    from pumiumtally_tpu_torch.ops import scatter

    read = _reader("sparse_fold_pct.source")
    call = {"walk": _t(3), "scatter.fold": _t(3)}
    monkeypatch.setattr(timing, "last_clock", lambda: _Clock(
        "cuda", {"run_source_moves": call}))
    assert read(None) == 0.0
    del call["scatter.fold"]
    assert read(None) is None
    call["scatter.sparse"] = _t(3)
    assert read(None) == 100.0
    monkeypatch.delattr(scatter, "SPARSE_LAUNCHES")
    assert read(None) is None


# --------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_chunk_host_reads_on_card(cuda):
    from pumiumtally_tpu_torch.ops import walk_cuda

    t = _tally(cuda, n=4096)
    t.step_clock = clock = StepClock(cuda)
    t.run_source_moves(2, SRC)
    tot = clock.totals()["run_source_moves"]
    reads = {k: v["count"] for k, v in tot.items() if k.startswith("read:")}
    assert reads == {"read:count": 2, "read:bucket": 2, "read:tail": 1}
    rows = [r["step"] for r in clock.rows()]
    assert rows.count("count_wait") == 2 and rows.count("bucket_wait") == 2
    assert [r for r in rows if not r.endswith("_wait")] == (
        MOVE_ROWS * 2 + ["tail read"])
    for name in ("walk.schedule", "walk.launch", "walk.result",
                 "scatter.count", "scatter.fold"):
        assert tot[name]["count"] == 2, name
    assert not hasattr(walk_cuda, "LAST_WAIT_S")


@pytest.mark.cuda
def test_relaunch_notes_both_count_reads(cuda):
    from pumiumtally_tpu_torch.ops import scatter, walk_cuda

    t = _tally(cuda, n=4096)
    s = t.state
    dest = torch.rand_like(s.origin) * 0.8 + 0.1
    clock = StepClock(cuda)
    before = walk_cuda.RELAUNCHES
    with timing.bind(clock, "walk"):
        walk_cuda.trace(t.mesh, s.origin, dest, s.elem, s.in_flight,
                        s.weight, s.group, s.material_id, t.flux.clone(),
                        initial=False, max_crossings=10_000, n_groups=2,
                        capacity=1)
    assert walk_cuda.RELAUNCHES == before + 1
    rows = [r["step"] for r in clock.rows()]
    assert rows == ["count_wait", "count_wait", "bucket_wait"]
    tot = clock.totals()["walk"]
    assert tot["read:count"]["count"] == 2
    assert tot["read:bucket"]["count"] == 1
    assert "wait_s" not in scatter.LAST_BUCKETS
