"""Per-job span tracing: spans, events, the crash black box, and the
checks a job's trace must pass.

Counterpart of ``pumiumtally_tpu/obs/trace.py``, with the same record
schema field for field. The serving path shares one tracer: every job
gets a ``trace_id`` at submission (persisted in the ``JOBS.json``
journal, so a job recovered after a server crash continues its trace,
the two process lifetimes linked by the id and a ``recovered`` event);
every phase of its life is one span (``submit`` → ``queued`` →
``admit`` → ``quantum`` a scheduling quantum → ``retry`` / ``preempted``
/ ``recovered`` → the terminal ``job`` root span) with a ``span_id``, a
``parent_id``, a wall-clock end timestamp and a monotonic duration. The
library bank (``aot_resolve``) and the resilience coordinator
(``classify``, ``probe``) emit into the same trace through the ambient
binding the scheduler sets around each phase.

Records are flat JSON dicts (``schema``/``kind``/``name``/``trace_id``/
``span_id``/``parent_id``/``job_id``/``pid``/``ts``/``seconds``/``seq``
and attributes) kept in a bounded ring and, with a ``sink`` (the
scheduler points it at ``<journal_dir>/TRACE.jsonl``), streamed one JSON
line a record through ``utils/log.py::emit_metric``.

``dump()`` writes the ring as one postmortem document through
``utils/checkpoint.atomic_write_json``. It is reachable from the
scheduler's SIGTERM/SIGINT flush, so it takes no lock: ``list(deque)``
snapshots the ring atomically under the GIL.

The tracer wraps host control flow only (no tensor, no random key, no
kernel argument), so served fluxes are bitwise equal with tracing on or
off. ``PUMI_TPU_TRACE=off`` turns emission off.

``job_trace``, ``check_job_trace`` and ``load_trace_records`` are the
port's copies of ``scripts/teleview.py``'s checks of one job's trace.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
import uuid

from ..utils.log import emit_metric

#: Version stamp of every span and event record and every black box.
TRACE_SCHEMA = 1

#: "off", "0" or "false" turns span emission off.
ENV_TRACE = "PUMI_TPU_TRACE"

#: Pass as ``parent=`` when an emit must not inherit the ambient
#: binding's parent (the terminal root span, emitted inside a binding).
NO_PARENT = "__no_parent__"

#: The events that link two process lifetimes of one job's trace.
LIFETIME_LINKS = ("recovered", "migrated", "evicted")


def trace_enabled() -> bool:
    return os.environ.get(ENV_TRACE, "").strip().lower() not in (
        "off", "0", "false",
    )


class SpanTracer:
    """Bounded-ring span and event tracer with an ambient job binding.

    One writer (the scheduler's loop; a watchdog worker dispatching for
    it is serialized by the blocked caller), concurrent readers (the
    exporter's ``/trace``, the signal path's black box). Appends take
    ``_lock``; ``dump`` does not."""

    def __init__(self, capacity: int = 1024, sink: str | None = None,
                 enabled: bool | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = trace_enabled() if enabled is None else bool(enabled)
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=capacity)  # guarded by: self._lock
        self._seq = 0  # guarded by: self._lock
        # None defers to PUMI_TPU_METRICS at emission time.
        self._sink = sink
        # Ambient (trace_id, job_id, parent_id).
        self._ctx: tuple | None = None

    # -- identity ------------------------------------------------------- #
    @staticmethod
    def new_trace() -> str:
        """A fresh 16-hex trace id (one a job, across every process that
        serves it)."""
        return uuid.uuid4().hex[:16]

    @staticmethod
    def root_id(trace_id: str) -> str:
        """The deterministic id of a trace's root ``job`` span, so the
        phases of several process lifetimes parent onto one root."""
        return f"{trace_id}/root"

    def next_id(self) -> str:
        """One span id, unique across process lifetimes (the pid tells
        two processes appending to one TRACE.jsonl apart)."""
        with self._lock:
            n = self._seq
            self._seq += 1
        return f"{os.getpid():x}-{n}"

    # -- ambient binding ------------------------------------------------ #
    @contextlib.contextmanager
    def bind(self, trace_id: str, job_id: str | None = None,
             parent_id: str | None = None):
        """The ambient trace context for one serving phase; spans emitted
        without explicit ids (the bank, the coordinator) inherit it."""
        prev, self._ctx = self._ctx, (trace_id, job_id, parent_id)
        try:
            yield
        finally:
            self._ctx = prev

    @property
    def current(self) -> tuple:
        """(trace_id, job_id, parent_id) of the ambient binding, or
        (None, None, None)."""
        return self._ctx if self._ctx is not None else (None, None, None)

    # -- emission ------------------------------------------------------- #
    def _emit(self, kind: str, name: str, seconds: float, *,
              trace_id=None, parent=None, job_id=None, span_id=None,
              end_ts=None, attrs=None) -> dict | None:
        if not self.enabled:
            return None
        ctx_trace, ctx_job, ctx_parent = self.current
        parent_id = parent if parent is not None else ctx_parent
        if parent_id == NO_PARENT:
            parent_id = None
        rec = {
            "schema": TRACE_SCHEMA,
            "kind": kind,
            "name": str(name),
            "trace_id": trace_id if trace_id is not None else ctx_trace,
            "span_id": span_id if span_id is not None else self.next_id(),
            "parent_id": parent_id,
            "job_id": job_id if job_id is not None else ctx_job,
            "pid": os.getpid(),
            "ts": round(end_ts if end_ts is not None else time.time(), 6),
            "seconds": round(float(seconds), 6),
        }
        if attrs:
            for k, v in attrs.items():
                rec.setdefault(k, v)
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            self._ring.append(rec)
        emit_metric(rec, path=self._sink)
        return rec

    def event(self, name: str, *, trace_id=None, parent=None,
              job_id=None, **attrs) -> dict | None:
        """One zero-duration point event."""
        return self._emit(
            "event", name, 0.0, trace_id=trace_id, parent=parent,
            job_id=job_id, attrs=attrs,
        )

    def span_record(self, name: str, seconds: float, *, trace_id=None,
                    parent=None, job_id=None, span_id=None,
                    **attrs) -> dict | None:
        """One completed span of known duration ending now; ``span_id=``
        emits onto a pre-allocated or deterministic (``root_id``) id."""
        return self._emit(
            "span", name, seconds, trace_id=trace_id, parent=parent,
            job_id=job_id, span_id=span_id, attrs=attrs,
        )

    @contextlib.contextmanager
    def span(self, name: str, *, trace_id=None, parent=None,
             job_id=None, **attrs):
        """A span around a block. Yields the attribute dict (set result
        attributes before exit); the span is emitted on normal and on
        exceptional exit, the error named."""
        if not self.enabled:
            yield attrs
            return
        t0 = time.perf_counter()
        sid = self.next_id()
        try:
            yield attrs
        except BaseException as e:
            attrs.setdefault("error", f"{type(e).__name__}: {e}"[:200])
            raise
        finally:
            self._emit(
                "span", name, time.perf_counter() - t0,
                trace_id=trace_id, parent=parent, job_id=job_id,
                span_id=sid, attrs=attrs,
            )

    # -- read surfaces -------------------------------------------------- #
    def records(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def tail(self, n: int) -> list[dict]:
        if n <= 0:
            return []
        with self._lock:
            return list(self._ring)[-n:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- the crash black box -------------------------------------------- #
    def dump(self, path: str, *, reason: str, meta: dict | None = None,
             ) -> dict:
        """Write the ring as one atomic postmortem document. Reachable
        from a signal handler, so no lock (module docstring)."""
        from ..utils.checkpoint import atomic_write_json

        doc = {
            "schema": TRACE_SCHEMA,
            "kind": "blackbox",
            "reason": str(reason),
            "pid": os.getpid(),
            "ts": round(time.time(), 6),
            "meta": dict(meta or {}),
            "records": list(self._ring),
        }
        atomic_write_json(path, doc)
        return doc

    # -- chrome://tracing export ---------------------------------------- #
    def chrome(self, records: list[dict] | None = None) -> dict:
        """The ring (or the given records) as a Chrome-trace document:
        a track a job, a complete ("X") slice a span ending at its wall
        timestamp, an instant ("i") mark an event; the whole record
        rides in ``args``."""
        recs = self.records() if records is None else records
        return chrome_trace(recs)


def chrome_trace(records: list[dict]) -> dict:
    """Span and event records as Chrome-trace JSON (lossless: the
    records ride in each event's ``args``)."""
    spans = [
        r for r in records
        if isinstance(r, dict)
        and r.get("kind") in ("span", "event")
        and isinstance(r.get("ts"), (int, float))
    ]
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(r["ts"] - float(r.get("seconds") or 0.0) for r in spans)
    tracks = sorted({
        str(r.get("job_id") or r.get("trace_id") or "untraced")
        for r in spans
    })
    tid = {k: i + 1 for i, k in enumerate(tracks)}
    events: list[dict] = [
        {
            "name": "thread_name",
            "ph": "M",
            "pid": 1,
            "tid": tid[k],
            "cat": "__metadata",
            "args": {"name": k},
        }
        for k in tracks
    ]
    for r in spans:
        track = str(r.get("job_id") or r.get("trace_id") or "untraced")
        sec = float(r.get("seconds") or 0.0)
        args = {
            k: v for k, v in r.items()
            if isinstance(v, (int, float, str, bool)) or v is None
        }
        ev = {
            "name": str(r.get("name", r["kind"])),
            "pid": 1,
            "tid": tid[track],
            "args": args,
        }
        if r["kind"] == "span" and sec > 0:
            ev.update(
                ph="X", ts=(r["ts"] - sec - t0) * 1e6, dur=sec * 1e6
            )
        else:
            ev.update(ph="i", ts=(r["ts"] - t0) * 1e6, s="t")
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# --------------------------------------------------------------------- #
# One job's trace (the port's copy of scripts/teleview.py's checks)
# --------------------------------------------------------------------- #
def read_records(path: str) -> list[dict]:
    """Records of a JSONL stream; a torn or malformed line is skipped."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and "kind" in rec:
                records.append(rec)
    return records


def records_from_doc(doc) -> list[dict]:
    """Span records of a parsed document: a black box (``records``) or a
    Chrome-trace export (the records in each event's ``args``)."""
    if not isinstance(doc, dict):
        return []
    if isinstance(doc.get("records"), list):
        return [r for r in doc["records"] if isinstance(r, dict)]
    if isinstance(doc.get("traceEvents"), list):
        return [
            e["args"] for e in doc["traceEvents"]
            if isinstance(e, dict)
            and isinstance(e.get("args"), dict)
            and e["args"].get("span_id") is not None
        ]
    return []


def load_trace_records(source: str) -> list[dict]:
    """Span records of a journal directory (``TRACE.jsonl`` and every
    ``*.blackbox.json``), a ``.json`` document or a JSONL stream, with
    the records that sit in more than one of them kept once."""
    out: list[dict] = []
    if os.path.isdir(source):
        jsonl = os.path.join(source, "TRACE.jsonl")
        if os.path.exists(jsonl):
            out.extend(read_records(jsonl))
        for name in sorted(os.listdir(source)):
            if not name.endswith(".blackbox.json"):
                continue
            try:
                with open(os.path.join(source, name)) as f:
                    out.extend(records_from_doc(json.load(f)))
            except (OSError, ValueError):
                continue  # a torn dump must not hide the others
    elif source.endswith(".json"):
        with open(source) as f:
            out = records_from_doc(json.load(f))
    else:
        out = read_records(source)
    seen: set = set()
    deduped = []
    for r in out:
        key = (r.get("pid"), r.get("span_id"), r.get("seq"))
        if r.get("span_id") is not None and key in seen:
            continue
        seen.add(key)
        deduped.append(r)
    return deduped


def job_trace(records: list[dict], job_id: str) -> list[dict]:
    """One job's span and event records in causal (end timestamp, then
    sequence) order; unknown fields ride along."""
    mine = [
        r for r in records
        if r.get("job_id") == job_id and r.get("span_id") is not None
    ]
    return sorted(
        mine,
        key=lambda r: (
            r.get("ts") if isinstance(r.get("ts"), (int, float)) else 0,
            r.get("seq", 0) if isinstance(r.get("seq"), int) else 0,
        ),
    )


def check_job_trace(trace: list[dict], job_id: str) -> list[str]:
    """What is wrong with one job's trace (empty: nothing): it needs one
    trace id, a submit record, a terminal ``job`` root span, every
    parent resolvable, and, when its spans come from more than one
    process lifetime, a ``recovered``/``migrated``/``evicted`` link."""
    problems = []
    if not trace:
        return [f"no span records for job {job_id}"]
    trace_ids = {r.get("trace_id") for r in trace} - {None}
    if len(trace_ids) != 1:
        problems.append(
            f"expected one trace_id, found {sorted(map(str, trace_ids))}"
        )
    names = [r.get("name") for r in trace]
    if "submit" not in names:
        problems.append("no submit record")
    roots = [r for r in trace if r.get("name") == "job"]
    if not roots:
        problems.append("no terminal 'job' root span")
    ids = {r.get("span_id") for r in trace}
    dangling = {
        str(r.get("parent_id")) for r in trace
        if r.get("parent_id") is not None
        and r.get("parent_id") not in ids
    }
    if dangling:
        problems.append(f"unresolvable parent span(s): {sorted(dangling)}")
    pids = {r.get("pid") for r in trace} - {None}
    if len(pids) > 1 and not set(LIFETIME_LINKS) & set(names):
        problems.append(
            f"spans from {len(pids)} process lifetimes but no "
            "'recovered'/'migrated'/'evicted' link"
        )
    return problems
