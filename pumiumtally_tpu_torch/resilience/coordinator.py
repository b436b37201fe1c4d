"""ResilienceCoordinator: failure taxonomy and the device health probe.

Own copy of ``pumiumtally_tpu/resilience/coordinator.py``. The
``ResilientRunner`` sees one exception per failed move; what it should
do depends on what happened:

  * ``"transient"`` — a one-shot device or runtime error (injected
    transients, a ``torch.AcceleratorError``, a watchdog timeout with
    the device still answering its probe). Recovery: roll back to the
    last good state and replay bit for bit.
  * ``"chip-lost"`` — a chip dropped out (injected
    ``chip_down_at_move``, or an error behind which the probe finds a
    chip dead). A partitioned tally of several parts is rebuilt on the
    surviving entries of its device mesh (``resilience/elastic.py``);
    the plain facade and a one-part tally flush the last good
    generation and raise.
  * ``"preempted"`` — an eviction notice (``InjectedPreemption``, or a
    real SIGTERM/SIGINT through the runner's handlers): one last flush
    of the last good generation, then die; the next process resumes.
  * ``"persistent"`` — a failure a replay cannot fix (a fatal integrity
    violation, an injected poison job).

The chips are the entries of the tally's device mesh, by position (the
parts of a PartitionedTally may all be stacked on one card, so a chip is
a mesh position, not a torch device): the health probe is a tiny round
trip on each entry's device (two ones made there and summed back on the
host), and the ``downed`` positions the runner feeds through
``note_down`` on every ``ChipLostError`` report dead. A rebind to a
rebuilt tally clears them (its mesh holds only survivors). Results go to
the ``pumi_chip_health`` gauge of the tally's registry, beside
``pumi_rollbacks_total{cause=...}`` and ``pumi_elastic_reshards_total``.

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
        # Dead chips by position in the tally's device mesh (the JAX
        # coordinator keeps devices, which are one a chip there).
        self.downed: set[int] = set()
        self._last_probe: dict[int, bool] | None = None

    def rebind(self, tally) -> None:
        """Point at the rebuilt tally (its registry keeps the counters);
        its mesh holds the survivors only, so no position is down."""
        self.tally = tally
        self.downed.clear()

    def note_rollback(self, cause: str) -> None:
        """Count one rollback to the last good generation."""
        self.c_rollbacks.inc(cause=cause)
        self.tracer.event("rollback", cause=cause)

    # ------------------------------------------------------------------ #
    def devices(self) -> list:
        """The tally's chips, mesh order: the entries of the partitioned
        facade's device mesh, or the one device of the plain facade."""
        dm = getattr(self.tally, "device_mesh", None)
        if dm is not None:
            return list(dm)
        return [torch.device(self.tally.device)]

    def note_down(self, chip_index: int) -> None:
        """Record a failed chip by its position in the current mesh (the
        runner calls this on every ``ChipLostError``, before a rebuild
        re-indexes the mesh)."""
        self.downed.add(chip_index % len(self.devices()))

    def consume_last_probe(self) -> dict[int, bool] | None:
        """The probe ``classify`` ran for this failure (None when the
        verdict needed none); one incident pays for one probe."""
        probe, self._last_probe = self._last_probe, None
        return probe

    def probe_chips(self) -> dict[int, bool]:
        """Device liveness: two ones made on the device and summed back on
        the host (touches no tally state). A device in
        ``downed`` reports dead without a probe. Updates the
        ``pumi_chip_health`` gauge."""
        health: dict[int, bool] = {}
        with self.tracer.span("probe") as sp:
            for i, entry in enumerate(self.devices()):
                if i in self.downed:
                    ok = False
                else:
                    try:
                        probe = torch.ones(
                            2, dtype=torch.float32,
                            device=getattr(entry, "device", entry))
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
