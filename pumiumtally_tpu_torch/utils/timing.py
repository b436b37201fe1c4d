"""Per-phase wall-clock accumulators (TallyTimes parity), and the
program's spans and host-read counts.

Counterpart of ``pumiumtally_tpu/utils/timing.py``. CUDA work is
asynchronous, so a timed phase that asks for it synchronizes the device
(``torch.cuda.synchronize``) before the clock is read, like the
reference's PUMI_MEASURE_TIME-guarded fence.

Spans mark the program's host steps where the work happens:

  * ``span(name)`` with no clock bound and no torch profiler recording
    returns one shared context that does nothing (no allocation, no torch
    call): the state the program runs in when nobody measures;
  * while a torch profiler records (torch's own flag), it opens the range
    ``pumi:<name>`` (``utils/profiling.py::annotate``), so the step lands
    in the profiler's trace on the clock of the card's kernels, nested as
    the program nests;
  * while a ``StepClock`` is bound, it records the span into the clock:
    name, parent span, start and end (``time.perf_counter_ns``).

``bind(clock, name)`` binds a clock (or None) for one public call of a
facade and opens the call's span; the binding is a context variable, so a
worker thread run in a copy of the caller's context (``_dispatch``'s
watchdog) records into the same clock. ``step(name)`` is a span that is
also a row of the bound clock (``StepClock.rows()``); ``count(site)``
counts one blocking device→host read into the bound clock at the line
that reads. ``last_clock()`` is the clock bound most recently, for readers
that run after the facade is gone.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import threading
import time

import torch

from .log import log_time
from .profiling import annotate


@dataclasses.dataclass
class TallyTimes:
    initialization_time: float = 0.0
    total_time_to_tally: float = 0.0
    vtk_file_write_time: float = 0.0
    n_moves: int = 0

    def print_times(self) -> None:
        """One ``[TIME]`` record per phase through ``utils/log.py``."""
        total = (
            self.initialization_time
            + self.total_time_to_tally
            + self.vtk_file_write_time
        )
        log_time("initialization", self.initialization_time)
        log_time("tally", self.total_time_to_tally, n_moves=self.n_moves)
        if self.n_moves:
            log_time(
                "tally_per_move",
                self.total_time_to_tally / self.n_moves,
                n_moves=self.n_moves,
            )
        log_time("vtk_write", self.vtk_file_write_time)
        log_time("total", total)


# The clock bound for the current public call, and the innermost span open
# in this context.
_CLOCK: contextvars.ContextVar = contextvars.ContextVar(
    "pumi_step_clock", default=None)
_OPEN: contextvars.ContextVar = contextvars.ContextVar(
    "pumi_open_span", default=None)
_LAST = None  # the clock bound most recently (``last_clock``)
#: Spans a clock keeps for ``spans()``, the newest.
SPAN_RING = 1 << 16
_PROFILER = torch.autograd.profiler


def _recording() -> bool:
    """Whether a torch profiler records (its own flag, no torch call)."""
    return _PROFILER._is_profiler_enabled


# The one context of a span with nowhere to go (reusable).
_OFF = contextlib.nullcontext()


class _Span:
    """One span of ``clock`` (and a row of it when ``row``), with its
    ``pumi:`` profiler range while a profiler records."""

    __slots__ = ("clock", "name", "row", "id", "parent", "call", "child_ns",
                 "t0", "_token", "_range")

    def __init__(self, clock: "StepClock", name: str, row: bool):
        self.clock, self.name, self.row = clock, name, row

    def __enter__(self):
        parent = _OPEN.get()
        if parent is not None and parent.clock is not self.clock:
            parent = None
        self.parent = parent
        self.call = self.name if parent is None else parent.call
        self.id = next(self.clock._ids)
        self.child_ns = 0
        self._token = _OPEN.set(self)
        self._range = None
        if _recording():
            self._range = annotate("pumi:" + self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _OPEN.reset(self._token)
        self.clock._close(self, t1)
        return False


class StepClock:
    """The spans, rows and host-read counts of the calls it is bound to.

    A facade binds its ``step_clock`` for each public call (``bind``);
    every ``span`` the call opens records into it, nested under the call's
    own span, and every ``count`` counts into it. A pipeline with a clock
    set (``StreamingTallyPipeline.step_clock``) opens its steps on it with
    ``clock_step``. ``rows()`` lists the steps (``step``) in the order
    they closed; ``spans()`` every span, newest ``SPAN_RING``;
    ``totals()`` sums them by outermost call and name. ``device`` names
    the card the calls run on; no span records a device event."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._rows: list = []  # guarded by: self._lock
        self._spans = collections.deque(maxlen=SPAN_RING)  # guarded by: self._lock
        self._totals: dict = {}  # guarded by: self._lock

    def step(self, name: str) -> _Span:
        """A span of this clock that is also a row."""
        return _Span(self, name, True)

    def _close(self, s: _Span, t1: int) -> None:
        host = t1 - s.t0
        with self._lock:
            if s.parent is not None:
                s.parent.child_ns += host
            own = host - s.child_ns
            self._spans.append((
                s.id, s.name, None if s.parent is None else s.parent.id,
                s.call, s.t0, t1, own))
            _add(self._totals, s.call, s.name, host, own)
            if s.row:
                self._rows.append((s.name, host))

    def _count(self, site: str) -> None:
        parent = _OPEN.get()
        call = (parent.call if parent is not None and parent.clock is self
                else None)
        with self._lock:
            _add(self._totals, call, "read:" + site, 0, 0)

    def rows(self) -> list[dict]:
        """``{"step", "host_ms"}`` per step in the order they closed (a
        wait closes inside its step, so before it); clears the rows."""
        with self._lock:
            rows, self._rows = self._rows, []
        return [{"step": name, "host_ms": ns * 1e-6} for name, ns in rows]

    def spans(self) -> list[dict]:
        """Every span kept, in the order they closed: ``id``, ``name``,
        ``parent`` (its id, or None), ``call`` (the outermost span's
        name), ``start_ns``, ``end_ns`` and ``self_ns`` (the duration less
        its children's)."""
        keys = ("id", "name", "parent", "call", "start_ns", "end_ns",
                "self_ns")
        with self._lock:
            return [dict(zip(keys, s)) for s in self._spans]

    def totals(self) -> dict:
        """``{call: {name: {"count", "host_ns", "self_ns"}}}`` over every
        span since the clock was made, by outermost call (``rows()``
        clears none of it). A host read of ``site`` counts under
        ``"read:<site>"`` with no time."""
        with self._lock:
            return {call: {name: dict(count=c, host_ns=h, self_ns=o)
                           for name, (c, h, o) in per.items()}
                    for call, per in self._totals.items()}


def _add(totals: dict, call, name: str, host: int, own: int) -> None:
    tot = totals.setdefault(call, {}).get(name)
    if tot is None:
        tot = totals[call][name] = [0, 0, 0]
    tot[0] += 1
    tot[1] += host
    tot[2] += own


def _open(name: str, row: bool):
    clock = _CLOCK.get()
    if clock is not None:
        return _Span(clock, name, row)
    return annotate("pumi:" + name) if _recording() else _OFF


def span(name: str):
    """A host step of the program: a span of the bound clock, or the
    ``pumi:<name>`` range while a profiler records, or nothing."""
    return _open(name, False)


def step(name: str):
    """``span(name)`` that is also a row of the bound clock."""
    return _open(name, True)


def count(site: str) -> None:
    """Count one blocking device→host read at ``site`` into the bound
    clock."""
    clock = _CLOCK.get()
    if clock is not None:
        clock._count(site)


def last_clock() -> StepClock | None:
    """The clock bound most recently (None before any)."""
    return _LAST


class bind:
    """Bind ``clock`` (a ``StepClock`` or None) for one public call and
    open the call's span ``name``. A call that finds its clock already
    bound nests in the call around it."""

    __slots__ = ("clock", "name", "_tokens", "_span")

    def __init__(self, clock: StepClock | None, name: str):
        self.clock, self.name = clock, name

    def __enter__(self):
        global _LAST
        clock, self._tokens = self.clock, None
        if clock is not None:
            _LAST = clock
        if _CLOCK.get() is not clock:
            self._tokens = (_CLOCK.set(clock), _OPEN.set(None))
        self._span = span(self.name)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._span.__exit__(*exc)
        finally:
            if self._tokens is not None:
                _OPEN.reset(self._tokens[1])
                _CLOCK.reset(self._tokens[0])
        return False


def clock_step(clock: StepClock | None, name: str):
    """``clock.step(name)``, or ``span(name)`` without a clock."""
    return span(name) if clock is None else clock.step(name)


class phase_timer(contextlib.AbstractContextManager):
    """Accumulate elapsed wall-clock into ``times.<field>``. Inside the
    block, ``.sync(device)`` asks for the device to be synchronized before
    the clock is read (a no-op for the CPU)."""

    def __init__(self, times: TallyTimes, field: str, enabled: bool):
        self._times, self._field, self._enabled = times, field, enabled
        self._device = None

    def sync(self, device) -> None:
        self._device = torch.device(device)

    def __enter__(self):
        if self._enabled:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._enabled:
            if self._device is not None and self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            setattr(
                self._times,
                self._field,
                getattr(self._times, self._field)
                + (time.perf_counter() - self._start),
            )
        return False
