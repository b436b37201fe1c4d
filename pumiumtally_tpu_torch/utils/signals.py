"""SIGTERM/SIGINT plumbing for the preemption flushes of
``resilience/runner.py::ResilientRunner`` and
``serving/scheduler.py::TallyScheduler``.

Own copy of ``pumiumtally_tpu/utils/signals.py``. A supervisor follows
one discipline: install handlers on the
two preemption signals, defer delivery that lands mid-dispatch to a
consistent boundary, flush durable state, then DIE THE WAY THE
PROCESS WOULD HAVE WITHOUT US — chain a callable previous handler,
honor SIG_IGN, or exit 128+signum like the default disposition.  The
subtle parts (the not-main-thread fallback, the chaining rules) live
here once.
"""
from __future__ import annotations

import signal

from .log import log_warn

#: The eviction notices a preemptible fleet delivers.
PREEMPTION_SIGNALS = (signal.SIGTERM, signal.SIGINT)


def install_preemption_handlers(handler, what: str) -> dict:
    """Install ``handler`` on the preemption signals; returns the
    {signum: previous_handler} map ``uninstall_preemption_handlers``
    restores.  Outside the main thread signal delivery belongs to the
    embedding application — a warning is logged and whatever was
    installed so far is returned (the caller's cadence flushes still
    bound the loss window)."""
    prev: dict = {}
    for sig in PREEMPTION_SIGNALS:
        try:
            prev[sig] = signal.signal(sig, handler)
        except ValueError:
            log_warn(
                f"{what}: cannot install signal handlers outside the "
                "main thread; preemption flush disabled"
            )
            return prev
    return prev


def uninstall_preemption_handlers(prev: dict, mine=None) -> None:
    """Restore the saved previous handlers.  When ``mine`` (the
    handler this supervisor installed) is given, a signal whose
    CURRENT handler is no longer ours is left alone — tearing down an
    older supervisor must not clobber the handler a newer one (or the
    embedding application) installed on top.  Bound methods compare by
    ``==`` (same object + same function), not identity — each
    ``self._on_signal`` access creates a fresh bound-method object."""
    for sig, handler in prev.items():
        if mine is not None and signal.getsignal(sig) != mine:
            continue
        signal.signal(sig, handler)


def resume_previous_handler(prev, signum, frame) -> None:
    """After the flush: behave as the process would have without the
    supervisor's handler installed."""
    if callable(prev):
        prev(signum, frame)
    elif prev == signal.SIG_IGN:
        return
    else:
        raise SystemExit(128 + signum)
