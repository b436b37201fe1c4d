"""Escalation policy for integrity violations.

Own copy of ``pumiumtally_tpu/integrity/policy.py``. One knob, four rungs — ``TallyConfig(integrity=...)``:

  * ``"off"``   — no invariant programs compiled, no checks, today's
    exact behavior (bit-identical outputs, pinned by
    tests/test_torch_integrity.py).
  * ``"warn"``  — violations are counted
    (``pumi_integrity_violations_total{check=...}``), recorded in the
    flight recorder, and surfaced as ``RuntimeWarning``s; the run keeps
    going. The production default for long campaigns that graph the
    counters.
  * ``"retry"`` — violations raise ``TransientIntegrityViolation``,
    which is in ``resilience.runner.RETRYABLE``: under a
    ``ResilientRunner`` the move rolls back to the last good in-memory
    snapshot and replays (exactly the transient-fault path — a
    genuine SDC does not recur, a deterministic kernel bug exhausts the
    bounded retries and propagates). Without a runner the error simply
    propagates, which is fail-safe.
  * ``"halt"``  — violations raise ``FatalIntegrityViolation``; the
    ``ResilientRunner`` flushes a checkpoint of the last GOOD state
    (never the suspect post-violation state) before letting it
    propagate, so the campaign can be resumed from verified data.
"""
from __future__ import annotations

import warnings


class IntegrityViolation(RuntimeError):
    """An integrity check failed: the tally state is suspect.

    Carries ``checks`` — the violated check names — and ``move``.
    """

    def __init__(self, message: str, checks=(), move: int = 0):
        super().__init__(message)
        self.checks = tuple(checks)
        self.move = int(move)


class TransientIntegrityViolation(IntegrityViolation):
    """Retryable (``integrity="retry"``): the supervisor's last-good
    rollback + replay is the recovery path (one-shot SDC never
    recurs)."""


class FatalIntegrityViolation(IntegrityViolation):
    """Non-retryable (``integrity="halt"``): stop the run; the
    supervisor flushes a last-good checkpoint on the way out."""


def escalate(
    mode: str, violations: list[str], move: int, stacklevel: int = 3
) -> None:
    """Apply the configured policy to one move's violated checks.

    No-op when the list is empty or the mode is "off" (detectors may
    still have recorded telemetry). Counting happens at the telemetry
    layer (TallyTelemetry.record_integrity) BEFORE escalation so the
    counters are consistent whichever rung fires.
    """
    if not violations or mode == "off":
        return
    msg = (
        f"integrity violation at move {move}: "
        f"{', '.join(violations)} check(s) failed — the tally state is "
        "suspect (SDC, kernel regression, or corrupted accumulator); "
        "see telemetry()['integrity'] and the flight recorder"
    )
    if mode == "warn":
        warnings.warn(msg, RuntimeWarning, stacklevel=stacklevel)
    elif mode == "retry":
        raise TransientIntegrityViolation(msg, violations, move)
    elif mode == "halt":
        raise FatalIntegrityViolation(msg, violations, move)
    else:  # pragma: no cover - config validation rejects this earlier
        raise ValueError(f"unknown integrity mode {mode!r}")
