"""Per-quantum device readings and capture-on-anomaly profiling.

Counterpart of ``pumiumtally_tpu/obs/profile.py``, on ``torch.profiler``.
``FleetProfiler`` turns the counters the scheduler keeps into a member's
utilization readings, and when a burn-rate alert fires captures one
bounded profiler window, so the anomaly can be read afterwards.

Gauges, sampled at quantum cadence from each member's registry:

  * ``pumi_member_device_utilization{member=}``: the share of wall time
    spent inside blocked quantum dispatches since the last sample
    (``pumi_job_device_seconds`` delta over the wall delta);
  * ``pumi_member_time_seconds{member=,phase=}``: cumulative wall
    attribution, ``device`` (inside dispatches), ``dispatch_wait``
    (quantum wall minus device: host overhead, retries) and
    ``queue_wait`` (the ``pumi_job_queue_seconds`` histogram's sum);
  * ``pumi_fleet_hbm_high_water_bytes``: ``torch.cuda.max_memory_allocated``
    of this process (0 on a process that has not used the card).

Capture-on-anomaly, off by default: ``PUMI_TPU_PROFILE=anomaly`` arms
it. The first alert opens a ``torch.profiler`` window (the card's
activity where there is one, the host's besides) and the window closes
after ``capture_s`` wall seconds at the next sample, writing a Chrome
trace to ``<journal_dir>/profiles/<tag>/trace.json``. One window at a
time; a profiler failure is counted in ``pumi_profile_failures_total``
and logged, never raised into the scheduler (the profiler is an optional
observer, not part of any kernel's path).
"""
from __future__ import annotations

import os
import time

import torch

from ..utils.log import log_warn

ENV_PROFILE = "PUMI_TPU_PROFILE"
PROFILE_MODES = ("off", "anomaly")
TRACE_FILE = "trace.json"


def profile_mode(mode: str | None = None) -> str:
    """The capture mode: the argument, else ``PUMI_TPU_PROFILE``, else
    ``off``. An unknown value is refused (a typo must not turn capture
    off unnoticed)."""
    if mode is None:
        mode = os.environ.get(ENV_PROFILE, "").strip() or "off"
    mode = str(mode).lower()
    if mode not in PROFILE_MODES:
        raise ValueError(
            f"{ENV_PROFILE}={mode!r}: expected one of {PROFILE_MODES}"
        )
    return mode


def _device_events(prof) -> int:
    """Events the profile kept on the card (kernels, copies, fills)."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


class FleetProfiler:
    """Quantum-cadence utilization sampling and anomaly capture."""

    def __init__(self, registry, *, journal_dir: str, mode: str | None = None,
                 capture_s: float = 5.0, clock=time.monotonic):
        self.mode = profile_mode(mode)
        self.capture_s = float(capture_s)
        self.profile_dir = os.path.join(str(journal_dir), "profiles")
        self._clock = clock
        self._util_gauge = registry.gauge(
            "pumi_member_device_utilization",
            "fraction of wall time spent inside blocked device "
            "dispatches since the previous profiler sample "
            "(device_seconds delta / wall delta, per member)",
        )
        self._time_gauge = registry.gauge(
            "pumi_member_time_seconds",
            "cumulative wall attribution per member: phase=device "
            "(inside dispatches), phase=dispatch_wait (quantum wall "
            "minus device — host overhead), phase=queue_wait "
            "(submit-to-first-dispatch)",
        )
        self._hbm_gauge = registry.gauge(
            "pumi_fleet_hbm_high_water_bytes",
            "high-water device memory of this process "
            "(torch.cuda.max_memory_allocated; 0 before the card is "
            "used)",
        )
        self._captures_total = registry.counter(
            "pumi_profile_captures_total",
            "anomaly-triggered torch.profiler capture windows opened",
        )
        self._failures_total = registry.counter(
            "pumi_profile_failures_total",
            "torch.profiler capture windows that failed to open or to "
            "write their trace (logged, never raised)",
        )
        # {member index: (t, device_s, quantum_wall_s)}
        self._last: dict[int, tuple] = {}
        self._capture_until: float | None = None
        self._prof = None
        self._captures: list[dict] = []

    # ------------------------------------------------------------------ #
    # Sampling
    # ------------------------------------------------------------------ #
    @staticmethod
    def _member_counts(label: str, registry) -> tuple:
        """(device_s, quantum_wall_s, queue_wait_s), cumulative, of one
        member's registry."""
        device = registry.counter("pumi_job_device_seconds").value(
            member=label
        )
        qwall = registry.counter(
            "pumi_quantum_wall_seconds_total"
        ).value(member=label)
        queue = 0.0
        snap = registry.snapshot().get("pumi_job_queue_seconds")
        if snap is not None:
            queue = sum(s["value"]["sum"] for s in snap["series"])
        return float(device), float(qwall), float(queue)

    def sample(self, members) -> None:
        """One sample over ``[(index, label, registry, alive), ...]``."""
        now = self._clock()
        for index, label, registry, alive in members:
            if not alive or registry is None:
                self._util_gauge.set(0.0, member=str(label))
                self._last.pop(index, None)
                continue
            device, qwall, queue = self._member_counts(label, registry)
            prev = self._last.get(index)
            if prev is not None:
                dt = now - prev[0]
                dd = device - prev[1]
                if dt > 0:
                    self._util_gauge.set(
                        max(0.0, dd / dt), member=str(label)
                    )
            self._last[index] = (now, device, qwall)
            self._time_gauge.set(
                device, member=str(label), phase="device"
            )
            self._time_gauge.set(
                max(0.0, qwall - device),
                member=str(label), phase="dispatch_wait",
            )
            self._time_gauge.set(
                queue, member=str(label), phase="queue_wait"
            )
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._hbm_gauge.set(float(torch.cuda.max_memory_allocated()))
        self._maybe_stop_capture(now)

    # ------------------------------------------------------------------ #
    # Capture-on-anomaly
    # ------------------------------------------------------------------ #
    @property
    def capturing(self) -> bool:
        return self._capture_until is not None

    def _failed(self, what: str, exc: BaseException) -> None:
        self._failures_total.inc()
        log_warn(f"profiler capture: {what} failed ({exc})")

    def on_alert(self, alert: dict) -> bool:
        """A burn-rate alert fired: open one bounded profiler window
        (only with ``mode="anomaly"``, never while one is open). Returns
        True when a capture started."""
        if self.mode != "anomaly" or self.capturing:
            return False
        tag = (
            f"{alert.get('slo', 'alert')}-m{alert.get('member', 'x')}-"
            f"{len(self._captures):03d}"
        )
        target = os.path.join(self.profile_dir, tag)
        try:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(target, exist_ok=True)
            prof = profile(activities=activities)
            prof.__enter__()
        except Exception as e:
            self._failed("start", e)
            return False
        self._prof = prof
        self._capture_until = self._clock() + self.capture_s
        self._captures.append({
            "tag": tag, "dir": target, "slo": alert.get("slo"),
            "member": alert.get("member"), "trace": None,
            "device_events": None,
        })
        self._captures_total.inc()
        return True

    def _maybe_stop_capture(self, now: float) -> None:
        if self._capture_until is not None and now >= self._capture_until:
            self.stop_capture()

    def stop_capture(self) -> None:
        """Close an open window and write its Chrome trace (idempotent)."""
        if self._capture_until is None:
            return
        self._capture_until = None
        prof, self._prof = self._prof, None
        entry = self._captures[-1]
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            path = os.path.join(entry["dir"], TRACE_FILE)
            prof.export_chrome_trace(path)
            entry["trace"] = path
            entry["device_events"] = _device_events(prof)
        except Exception as e:
            self._failed("stop", e)

    def status(self) -> dict:
        """The ``profile`` section of a stats document."""
        return {
            "mode": self.mode,
            "capturing": self.capturing,
            "captures": [dict(c) for c in self._captures],
            "profile_dir": self.profile_dir,
        }
