"""The roofline, idle and trace arithmetic."""
from __future__ import annotations

import types

import pytest
from tb_small import ROOT

from tallybench import devtrace, harness, roofline


def test_walk_and_scatter_least_time():
    walks = [dict(lanes=1000, iters=5000, segments=4000),
             dict(lanes=10, iters=10 ** 7, segments=10 ** 7)]
    ntet, item = 2000, 4
    b0 = 2000 * 80 + 1000 * roofline.LANE_BYTES[4]
    b1 = 2000 * 80 + 10 * roofline.LANE_BYTES[4]
    expect = max(b0 / 3.35e12, 5000 * 80 / 67e12) + max(
        b1 / 3.35e12, 1e7 * 80 / 67e12)
    assert roofline.walk_least_s(walks, ntet, item, "geo20") == pytest.approx(
        expect)
    nbins = 3000
    s0 = 4000 * 16 + 3000 * 16
    s1 = 1e7 * 16 + 3000 * 16
    assert roofline.scatter_least_s(walks, nbins, 4) == pytest.approx(
        (s0 + s1) / 3.35e12)
    assert roofline.LANE_BYTES == {4: 78, 8: 122}
    assert roofline.ROW_BYTES["unpacked"][8] == 148


class Ev:
    def __init__(self, name, start, dur, kind, device="CPU"):
        self._n, self._s, self._d, self._k = name, start, dur, kind
        self._dev = device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def activity_type(self):
        return self._k

    def device_type(self):
        return "DeviceType." + self._dev


class OldEv(Ev):
    """A torch whose events have no activity_type()."""

    def __getattribute__(self, item):
        if item == "activity_type":
            raise AttributeError(item)
        return object.__getattribute__(self, item)


@pytest.mark.parametrize("cls", [Ev, OldEv])
def test_busy_idle_and_named_gaps(cls):
    k = "void (anonymous namespace)::walk_kernel<float, true>(float const*)"
    evs = [
        cls("tb:window", 0, 1000, "user_annotation"),
        cls("tb:batch", 0, 1000, "user_annotation"),
        cls("tb:snapshot", 100, 200, "user_annotation"),
        cls("tb:run_source_moves", 300, 700, "user_annotation"),
        cls("tb:run_source_moves", 300, 700, "gpu_user_annotation",
            "CUDA"),
        cls(k, 400, 200, "kernel", "CUDA"),
        cls(k, 500, 300, "kernel", "CUDA"),     # overlaps the first
        cls("Memcpy HtoD (Pinned -> Device)", 900, 50, "gpu_memcpy", "CUDA"),
        cls("aten::add", 10, 5, "cpu_op"),
    ]
    red = devtrace.reduce_events(evs)
    assert red.window_s == pytest.approx(1e-6)
    assert red.busy_s == pytest.approx(450e-9)          # [400,800] + [900,950]
    gaps = {n: s for n, s in devtrace.breakdown(red)["idle_gaps"]}
    # [0,400]: mid 200 in the snapshot; [800,900] and [950,1000]: in the move.
    assert gaps == pytest.approx({"snapshot": 400e-9,
                                  "run_source_moves": 150e-9})
    ops = dict(devtrace.breakdown(red)["device_ops"])
    assert ops["void walk_kernel<float, true>"] == pytest.approx(500e-9)
    assert devtrace.kernel_id(k) == "walk_kernel"
    assert devtrace.kernel_id("order_count") == "order_count"
    assert devtrace.kernel_id(
        "void at::native::reduce_kernel<512, 1>(int)") == "reduce_kernel"


def test_csrc_kernel_names():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.find_spec("pumiumtally_tpu_torch")
    names = harness.csrc_kernels(Path(spec.origin).parent)
    assert {"walk_kernel", "lane_count", "lane_scan", "lane_place"} <= names[
        "walk"]
    assert {"bucket_fold", "bucket_place", "order_count"} <= names["scatter"]
    assert "sample_flight_kernel" in names["source"]


def ctx_of(red, walks):
    by = red.kernel_seconds()
    csrc = {"walk": {"walk_kernel"}, "scatter": {"bucket_fold"}}
    return types.SimpleNamespace(
        reduced=red, csrc=csrc, kernel_id=devtrace.kernel_id,
        kernel_seconds=lambda: by,
        csrc_seconds=lambda stem: sum(
            s for n, s in by.items()
            if devtrace.kernel_id(n) in csrc.get(stem, ())),
        device_seconds=lambda: sum(s for _, _, s in red.ops),
        walks=walks, waits=[(0.002, 2)], step_ms=[3.0, 5.0], ntet=100, item=4,
        layout="geo20", nbins=800, roofline=roofline)


def test_metric_readers():
    red = devtrace.Reduced(window_s=2.0, busy_s=0.5, ops=[
        ("walk_kernel<float>", "kernel", 0.3),
        ("bucket_fold<float>", "kernel", 0.1),
        ("at::native::vectorized_elementwise_kernel<4>", "kernel", 0.1)],
        gaps=[])
    walks = [dict(lanes=10, iters=50, segments=40)]
    ctx = ctx_of(red, walks)
    here = ROOT / "tallybench"
    read = lambda n: harness.metric_reader(here, n)(ctx)  # noqa: E731
    assert read("idle_pct.source") == pytest.approx(75.0)
    assert read("torch_ops_pct.source") == pytest.approx(20.0)
    assert read("walk_wait_ms.source") == pytest.approx(1.0)
    assert read("host_step_ms.source") == pytest.approx(4.0)
    least = roofline.walk_least_s(walks, 100, 4, "geo20")
    assert read("walk_roofline_pct.source") == pytest.approx(
        100 * least / 0.3)
    least = roofline.scatter_least_s(walks, 800, 4)
    assert read("scatter_roofline_pct.source") == pytest.approx(
        100 * least / 0.1)


def test_readers_find_nothing_without_rows():
    red = devtrace.Reduced(window_s=1.0, busy_s=0.0, ops=[], gaps=[])
    ctx = ctx_of(red, [])
    ctx.waits, ctx.step_ms = [], []
    here = ROOT / "tallybench"
    for name in ("walk_roofline_pct.source", "scatter_roofline_pct.source",
                 "torch_ops_pct.source", "walk_wait_ms.source",
                 "host_step_ms.source"):
        assert harness.metric_reader(here, name)(ctx) is None, name
