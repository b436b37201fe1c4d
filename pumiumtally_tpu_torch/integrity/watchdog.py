"""Dispatch watchdog: a deadline around a move's device work.

Own copy of ``pumiumtally_tpu/integrity/watchdog.py``. A hung device
step (a wedged device, a kernel that never returns) blocks the facade in
its readback forever: no exception ever surfaces, so the retry machinery
cannot see it. With ``TallyConfig(move_deadline_s=...)`` the facade runs
each move's walk and readback on a worker thread; if it misses the
deadline a ``DispatchTimeoutError`` is raised, which is in
``resilience.runner.RETRYABLE``, so the supervisor rolls back to the last
good snapshot and replays the move instead of wedging.

Contract for the supervised closure: it must not mutate facade state (the
walk writes only into buffers the closure owns). On a timeout the
abandoned worker may still finish its device work later; nobody applies
its results, and the rollback restores the facade from its own copies,
so the late completion is inert. The worker is a daemon thread: a truly
hung step never blocks process exit.
"""
from __future__ import annotations

import threading


class DispatchTimeoutError(RuntimeError):
    """A compiled-step dispatch/readback missed its deadline. Retryable:
    the ResilientRunner treats it like any transient device fault
    (last-good rollback + bounded backoff replay)."""


def _timeout(what: str, seconds) -> DispatchTimeoutError:
    return DispatchTimeoutError(
        f"{what} dispatch exceeded move_deadline_s={seconds}: the "
        "device step (or its readback) never returned — surfacing "
        "as a transient error so the supervisor can re-arm and "
        "replay from the last good snapshot"
    )


def run_with_deadline(fn, seconds: float | None, what: str = "move"):
    """Run ``fn()`` with a wall-clock deadline.

    ``seconds`` None/0 → run inline (no thread, no overhead). On
    timeout raises ``DispatchTimeoutError`` and abandons the worker
    (daemon) thread; exceptions raised by ``fn`` re-raise here
    unchanged, so injected faults and device errors keep their types
    through the watchdog.
    """
    if not seconds:
        return fn()
    # The worker publishes into ``outcome`` and the caller reads it
    # only after the event fires (or never, on timeout): the
    # happens-before edge is the Event.
    outcome = {}  # guarded by: finished (event)
    finished = threading.Event()

    def target():
        try:
            outcome["value"] = fn()
        except BaseException as e:  # re-raised on the caller thread
            outcome["error"] = e
        finally:
            finished.set()

    worker = threading.Thread(
        target=target, name="pumi-dispatch-watchdog", daemon=True
    )
    worker.start()
    if not finished.wait(float(seconds)):
        raise _timeout(what, seconds)
    if "error" in outcome:
        raise outcome["error"]
    return outcome["value"]
