"""ResilienceCoordinator: failure taxonomy and the device health probe.

Own copy of ``pumiumtally_tpu/resilience/coordinator.py`` for the
single-device facade. The ``ResilientRunner`` sees one exception per
failed move; what it should do depends on what happened:

  * ``"transient"`` — a one-shot device or runtime error (injected
    transients, a ``torch.AcceleratorError``, a watchdog timeout with
    the device still answering its probe). Recovery: roll back to the
    last good state and replay bit for bit.
  * ``"chip-lost"`` — the device dropped out (injected
    ``chip_down_at_move``, or an error behind which the probe finds the
    device dead). On one device nothing is left to shrink onto: the
    runner flushes the last good generation and raises (the elastic
    mesh shrink needs ``PartitionedTally``, ROADMAP.md A9b).
  * ``"preempted"`` — an eviction notice (``InjectedPreemption``, or a
    real SIGTERM/SIGINT through the runner's handlers): one last flush
    of the last good generation, then die; the next process resumes.
  * ``"persistent"`` — a failure a replay cannot fix (a fatal integrity
    violation, an injected poison job).

The health probe is a tiny round trip on the tally's device (two ones
made there and summed back on the host), plus the ``downed_devices``
set the runner feeds through ``note_down`` on every ``ChipLostError``.
Results go to the ``pumi_chip_health`` gauge of the tally's registry,
beside ``pumi_rollbacks_total{cause=...}`` and
``pumi_elastic_reshards_total`` (which stays 0 on one device).

``tracer`` takes an object with the JAX package's ``SpanTracer``
surface (``span(name, **attrs)`` as a context manager yielding a dict,
``event(name, **attrs)``); without one, spans are not recorded (the
port's span tracer is ROADMAP.md A12).
"""
from __future__ import annotations

import contextlib

import torch

from ..integrity.policy import FatalIntegrityViolation
from ..integrity.watchdog import DispatchTimeoutError
from .faultinject import (
    ChipLostError,
    FaultInjector,
    InjectedPoisonFault,
    InjectedPreemption,
    InjectedTransientFault,
)


class _DeviceErrorPlaceholder(Exception):
    """Stands in for ``torch.AcceleratorError`` where torch lacks it."""


#: The error type torch raises for a failed CUDA call on the card.
DeviceError = getattr(torch, "AcceleratorError", _DeviceErrorPlaceholder)

#: The classifier's verdicts, in escalation order.
VERDICTS = ("transient", "chip-lost", "preempted", "persistent")


class _NoSpans:
    """The span surface when no tracer is given: records nothing."""

    @contextlib.contextmanager
    def span(self, name, **attrs):
        yield dict(attrs)

    def event(self, name, **attrs) -> None:
        return None


class ResilienceCoordinator:
    def __init__(self, tally, faults: FaultInjector | None = None,
                 tracer=None):
        self.tally = tally
        self.faults = faults if faults is not None else FaultInjector()
        self.tracer = tracer if tracer is not None else _NoSpans()
        r = tally.metrics
        self.c_rollbacks = r.counter(
            "pumi_rollbacks_total",
            "coordinated rollbacks to the last good generation "
            "(labeled by cause: transient, chip-lost, preempted, "
            "integrity)",
        )
        self.c_reshards = r.counter(
            "pumi_elastic_reshards_total",
            "elastic mesh-shrink recoveries (re-partition onto the "
            "surviving device set)",
        )
        self._g_health = r.gauge(
            "pumi_chip_health",
            "per-chip health probe result (1 = answering, 0 = lost)",
        )
        # Dead devices by identity (a torch.device), as the JAX
        # coordinator keeps them.
        self.downed_devices: set = set()
        self._last_probe: dict[int, bool] | None = None

    def rebind(self, tally) -> None:
        """Point at another tally (its registry keeps the counters)."""
        self.tally = tally

    def note_rollback(self, cause: str) -> None:
        """Count one rollback to the last good generation."""
        self.c_rollbacks.inc(cause=cause)
        self.tracer.event("rollback", cause=cause)

    # ------------------------------------------------------------------ #
    def devices(self) -> list:
        """The tally's device set: the one device its tensors live on."""
        return [torch.device(self.tally.device)]

    def note_down(self, chip_index: int) -> None:
        """Record a failed device (the runner calls this on every
        ``ChipLostError``)."""
        devs = self.devices()
        self.downed_devices.add(devs[chip_index % len(devs)])

    def consume_last_probe(self) -> dict[int, bool] | None:
        """The probe ``classify`` ran for this failure (None when the
        verdict needed none); one incident pays for one probe."""
        probe, self._last_probe = self._last_probe, None
        return probe

    def probe_chips(self) -> dict[int, bool]:
        """Device liveness: two ones made on the device and summed back on
        the host (touches no tally state). A device in
        ``downed_devices`` reports dead without a probe. Updates the
        ``pumi_chip_health`` gauge."""
        health: dict[int, bool] = {}
        with self.tracer.span("probe") as sp:
            for i, dev in enumerate(self.devices()):
                if dev in self.downed_devices:
                    ok = False
                else:
                    try:
                        probe = torch.ones(2, dtype=torch.float32,
                                           device=dev)
                        ok = float(probe.sum().item()) == 2.0
                    except Exception:
                        ok = False
                health[i] = ok
                self._g_health.set(1.0 if ok else 0.0, chip=str(i))
            sp["chips"] = len(health)
            sp["dead"] = sum(1 for ok in health.values() if not ok)
        return health

    # ------------------------------------------------------------------ #
    def classify(self, exc: BaseException) -> str:
        """Name the failure (module docstring). Ambiguous errors (a hung
        step, a device error) are resolved by probing: a dead device
        behind them makes the verdict chip-lost, a live one transient."""
        with self.tracer.span("classify", exc=type(exc).__name__) as sp:
            verdict = self._classify(exc)
            sp["verdict"] = verdict
        return verdict

    def _classify(self, exc: BaseException) -> str:
        # A probe is kept only for the chip-lost verdict it produced.
        self._last_probe = None
        if isinstance(exc, (FatalIntegrityViolation, InjectedPoisonFault)):
            return "persistent"
        if isinstance(exc, InjectedPreemption):
            return "preempted"
        if isinstance(exc, ChipLostError):
            return "chip-lost"
        if isinstance(exc, (DispatchTimeoutError, DeviceError)):
            health = self.probe_chips()
            if not all(health.values()):
                self._last_probe = health
                return "chip-lost"
            return "transient"
        if isinstance(exc, InjectedTransientFault):
            return "transient"
        return "transient"
