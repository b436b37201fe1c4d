"""Crash-safe scheduler journal: the ``JOBS.json`` write-ahead log.

Counterpart of ``pumiumtally_tpu/serving/journal.py``, with the same
document (schema 2) and request keys. The scheduler's whole job table
persists through one file, so a fresh process can
``TallyScheduler.recover(journal_dir)`` and continue every job bit for
bit: the source loop's random stream is keyed by the move counter the
checkpoints carry.

Layout, one directory a scheduler::

  <journal_dir>/JOBS.json            the journal (atomic tmp+fsync+
                                     rename on every flush: a crash
                                     leaves the previous document)
  <journal_dir>/<job>.ckpt.npz       the job's latest quantum-boundary
                                     checkpoint (also its preemption
                                     checkpoint when journaling is on)
  <journal_dir>/<job>.flux.npy       a finished job's raw flux (atomic)
  <journal_dir>/TRACE.jsonl          the span stream (obs/trace.py)

Document (schema 2; schema-1 documents still load, the trace fields
defaulted)::

  {"schema": 2, "quantum_moves": K,
   "jobs": {job_id: {id, index, state: "pending"|"done", outcome,
                     error, shape_key, n, padded_n, moves_done,
                     preemptions, retries, checkpoint, flux,
                     trace_id, device_seconds,
                     request: {...}}}}

Write-ahead: the journal is flushed after every state transition, and a
resident job's checkpoint is written before the flush that names it. A
crash between the two leaves a journal whose ``moves_done`` lags the
checkpoint, which is harmless: the checkpoint carries its own move
counter and recovery reads it at restore.

Degraded mode: a durable write failing with ENOSPC or EDQUOT marks the
journal ``degraded`` instead of raising out of the flush: the in-memory
table is intact. While degraded, flushes and flux writes are skipped
(the document freezes at its last commit) and the scheduler parks its
residents at the next quantum boundary. The flag stays for the
journal's lifetime.

Requests round-trip exactly: json writes floats by ``repr`` (shortest
round trip), so float64 origins and weights come back bit for bit, and
``SourceParams.tables()`` turns the string keys json gives the region
dicts back into integer classes.

A request's text is made once and kept (``RequestTexts``, on the
``RequestJSON`` that ``request_to_json`` returns): the document is
rewritten at every transition, and a 1,048,576-particle request is ~80
MB of indented JSON, 6-7 s of ``json.dumps`` on one host core. The
document's bytes are those of ``json.dumps(doc, indent=1,
sort_keys=True)`` all the same (its number lists are rendered from their
``repr``, which is json's float and int text).
"""
from __future__ import annotations

import dataclasses
import errno
import io
import json
import os
import re

import numpy as np

from ..utils.checkpoint import atomic_write_bytes
from ..utils.log import log_warn

#: The errnos that mean "the disk is full", not "the write is wrong":
#: these degrade the journal instead of crashing the scheduler.
DISK_FULL_ERRNOS = (errno.ENOSPC, errno.EDQUOT)

JOURNAL_SCHEMA = 2
#: Schemas this reader accepts (older documents lack trace fields,
#: which recovery defaults).
JOURNAL_SCHEMAS_READABLE = (1, 2)
JOURNAL_FILE = "JOBS.json"
TRACE_FILE = "TRACE.jsonl"

# Journaled job ids become filenames — refuse anything that cannot be
# one (path separators, parent-dir tricks) before it is persisted.
_SAFE_ID = re.compile(r"[A-Za-z0-9._-]{1,128}")


def check_job_id(job_id: str) -> str:
    if not _SAFE_ID.fullmatch(job_id) or job_id in (".", ".."):
        raise ValueError(
            f"job id {job_id!r} is not journal-safe (allowed: "
            "1-128 chars of [A-Za-z0-9._-])"
        )
    return job_id


# --------------------------------------------------------------------- #
# Request (de)serialization
# --------------------------------------------------------------------- #
def request_to_json(request) -> dict:
    """One JobRequest as a json-safe dict (module docstring contract:
    float64 payloads survive bitwise through repr round-trip)."""
    from ..ops.source import SourceParams

    origins = np.asarray(request.origins, np.float64).reshape(-1, 3)
    src = request.source
    if src is not None and not isinstance(src, SourceParams):
        raise TypeError(
            "journaling serves SourceParams sources only; got "
            f"{type(src).__name__} (a custom source object cannot be "
            "reconstructed by a fresh recovery process)"
        )
    return RequestJSON({
        "origins": origins.tolist(),
        "n_moves": int(request.n_moves),
        "weights": (
            None if request.weights is None
            else np.asarray(request.weights, np.float64)
            .reshape(-1).tolist()
        ),
        "groups": (
            None if request.groups is None
            else np.asarray(request.groups, np.int32)
            .reshape(-1).tolist()
        ),
        "source": (
            None if src is None else dataclasses.asdict(src)
        ),
        "job_id": request.job_id,
        "trace_id": getattr(request, "trace_id", None),
    })


def request_from_json(d: dict):
    from ..ops.source import SourceParams
    from .scheduler import JobRequest

    src = d.get("source")
    return JobRequest(
        origins=np.asarray(d["origins"], np.float64).reshape(-1, 3),
        n_moves=int(d["n_moves"]),
        source=None if src is None else SourceParams(**src),
        weights=(
            None if d.get("weights") is None
            else np.asarray(d["weights"], np.float64)
        ),
        groups=(
            None if d.get("groups") is None
            else np.asarray(d["groups"], np.int32)
        ),
        job_id=d.get("job_id"),
        trace_id=d.get("trace_id"),
    )


# --------------------------------------------------------------------- #
# Request texts
# --------------------------------------------------------------------- #
#: A json string that stands for a request in a document until its kept
#: text replaces it (the NUL cannot occur in a journal-safe id).
_TOKEN = "\x00request:"
_TOKEN_TEXT = re.compile(r'"\\u0000request:([^"]*)"')
#: The characters of a list of finite numbers' repr, which is then its
#: json text too (json writes NaN and Infinity, repr nan and inf).
_NUMBER_CHARS = b"0123456789.-+e, []"


def _number_list_text(value: list, level: int) -> str | None:
    """``json.dumps(value, indent=1)`` of a list of finite numbers, or of
    a list of such lists, whose bracket opens at indent ``level``; None
    for any other value (the caller then lets json render it)."""
    s = repr(value)
    if len(s) < 3 or "[]" in s or s.startswith("[[[") or \
            s.encode().translate(None, _NUMBER_CHARS):
        return None
    sp = " " * (level + 1)
    if not s.startswith("[["):
        if s.count("[") != 1:
            return None
        return ("[\n" + sp + s[1:-1].replace(", ", ",\n" + sp)
                + "\n" + " " * level + "]")
    rows = s.count("], [")
    if s.count("],") != rows or s.count(", [") != rows or \
            s.count("[") != rows + 2:
        return None
    sp2 = " " * (level + 2)
    inner = (s[2:-2].replace("], [", "\x01")
             .replace(", ", ",\n" + sp2)
             .replace("\x01", "\n" + sp + "],\n" + sp + "[\n" + sp2))
    return ("[\n" + sp + "[\n" + sp2 + inner + "\n" + sp + "]\n"
            + " " * level + "]")


def request_text(req: dict) -> str:
    """``json.dumps(req, indent=1, sort_keys=True)``: its number lists
    (origins, weights, groups) rendered from their ``repr``, the rest by
    json."""
    stub, lists = {}, {}
    for k, v in req.items():
        text = _number_list_text(v, 1) if type(v) is list else None
        if text is None:
            stub[k] = v
        else:
            stub[k] = _TOKEN + k
            lists[json.dumps(_TOKEN + k)] = text
    out = json.dumps(stub, indent=1, sort_keys=True)
    if not lists:
        return out
    parts = re.split("(" + "|".join(map(re.escape, lists)) + ")", out)
    return "".join(lists.get(p, p) for p in parts)


class RequestJSON(dict):
    """A request's journal form (``request_to_json``), which keeps the
    texts the journals make of it: FLEET.json, the member that runs the
    job and a member that adopts it hold this one object, so each text
    is made once a process."""

    __slots__ = ("texts",)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.texts: dict[int, str] = {}


class RequestTexts:
    """A journal's request texts, made once while the request object
    stays the same (a job's request dict is never changed in place), so
    that a document's rewrite costs its small fields only. A
    ``RequestJSON`` keeps its own texts; a plain dict (one read back from
    a journal) has them kept here while this journal holds it."""

    def __init__(self):
        self._kept: dict[str, tuple[dict, dict]] = {}

    def _texts(self, key: str, req: dict) -> dict:
        if isinstance(req, RequestJSON):
            return req.texts
        kept = self._kept.get(key)
        if kept is None or kept[0] is not req:
            kept = self._kept[key] = (req, {})
        return kept[1]

    def dumps(self, doc: dict, requests: dict) -> str:
        """The text of ``json.dumps(doc, indent=1, sort_keys=True)`` with
        each ``token(key)`` in ``doc`` replaced by ``requests[key]``,
        indented where the token stands."""
        out = json.dumps(doc, indent=1, sort_keys=True)
        for key in set(self._kept) - set(requests):
            del self._kept[key]
        pieces, pos = [], 0
        for m in _TOKEN_TEXT.finditer(out):
            key = m.group(1)
            line = out.rfind("\n", 0, m.start()) + 1
            head = out[line:m.start()]
            level = len(head) - len(head.lstrip(" "))
            texts = self._texts(key, requests[key])
            if level not in texts:
                if 0 not in texts:
                    texts[0] = request_text(requests[key])
                texts[level] = texts[0].replace("\n", "\n" + " " * level)
            pieces += [out[pos:m.start()], texts[level]]
            pos = m.end()
        pieces.append(out[pos:])
        return "".join(pieces)

    @staticmethod
    def token(key: str) -> str:
        return _TOKEN + key


# --------------------------------------------------------------------- #
# The journal
# --------------------------------------------------------------------- #
class SchedulerJournal:
    """Atomic JOBS.json document plus the per-job checkpoint/flux
    side files (module docstring layout).  The scheduler is the single
    writer; recovery is the single reader."""

    def __init__(self, dirname: str):
        self.dir = str(dirname)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, JOURNAL_FILE)
        #: Sticky disk-pressure flag (module docstring "Degraded
        #: mode"): set by the first ENOSPC-class durable-write failure;
        #: while set, flush/write_flux are skipped instead of raising.
        self.degraded = False
        #: Optional fault injector — or a zero-arg provider returning
        #: one — whose ``maybe_disk_full`` gates every durable write.
        #: The owning scheduler wires a provider so an injector
        #: swapped in mid-run still gates.
        self.faults = None
        #: Optional ``(op, exc) -> None`` callback fired once, on the
        #: transition into degraded mode (the scheduler hangs metrics
        #: and flight-recorder notes off it).
        self.on_degraded = None
        self._texts = RequestTexts()

    def note_disk_failure(self, op: str, exc: OSError) -> None:
        """Record an ENOSPC-class failure of durable write ``op`` and
        enter degraded mode (idempotent; first transition logs and
        fires ``on_degraded``)."""
        if self.degraded:
            return
        self.degraded = True
        log_warn(
            "journal degraded: durable write failed with disk "
            "pressure — freezing the on-disk document and parking "
            "residents (serving/journal.py 'Degraded mode')",
            dir=self.dir, op=op, error=str(exc),
        )
        if self.on_degraded is not None:
            self.on_degraded(op, exc)

    def _gate_durable(self) -> None:
        """Fault-injection gate for one durable write
        (``disk_full_at:N``); raises the injected ENOSPC."""
        faults = self.faults() if callable(self.faults) else self.faults
        if faults is not None:
            faults.maybe_disk_full()

    # -- side files ---------------------------------------------------- #
    def checkpoint_path(self, job_id: str) -> str:
        return os.path.join(self.dir, f"{job_id}.ckpt.npz")

    def flux_path(self, job_id: str) -> str:
        return os.path.join(self.dir, f"{job_id}.flux.npy")

    def trace_path(self) -> str:
        """The journal-local span sink (TRACE.jsonl): every process
        lifetime serving this journal appends to the same stream, so a
        trace across a crash reads from one directory."""
        return os.path.join(self.dir, TRACE_FILE)

    def blackbox_path(self, tag: str) -> str:
        """Where a postmortem black box for ``tag`` (a job id or a
        shutdown reason) lands inside the journal dir."""
        return os.path.join(self.dir, f"{tag}.blackbox.json")

    def write_flux(self, job_id: str, arr: np.ndarray) -> str | None:
        """Persist one finished job's raw flux atomically; returns the
        journal-relative name the document records, or None when the
        disk is full (degraded mode: the result stays in memory)."""
        if self.degraded:
            return None
        buf = io.BytesIO()
        np.save(buf, np.asarray(arr))
        try:
            self._gate_durable()
            atomic_write_bytes(self.flux_path(job_id), buf.getvalue())
        except OSError as exc:
            if exc.errno not in DISK_FULL_ERRNOS:
                raise
            self.note_disk_failure("flux persist", exc)
            return None
        return os.path.basename(self.flux_path(job_id))

    def load_flux(self, job_id: str) -> np.ndarray | None:
        path = self.flux_path(job_id)
        if not os.path.exists(path):
            return None
        return np.load(path)

    def remove_sidefiles(self, job_id: str, *, flux: bool = False) -> None:
        paths = [self.checkpoint_path(job_id)]
        if flux:
            paths.append(self.flux_path(job_id))
        for p in paths:
            try:
                os.remove(p)
            except OSError:
                pass

    # -- the document -------------------------------------------------- #
    def flush(self, entries: list[dict], *, quantum_moves: int) -> None:
        if self.degraded:
            return
        doc = {
            "schema": JOURNAL_SCHEMA,
            "quantum_moves": int(quantum_moves),
            "jobs": {
                e["id"]: dict(e, request=RequestTexts.token(e["id"]))
                for e in entries
            },
        }
        text = self._texts.dumps(
            doc, {e["id"]: e["request"] for e in entries})
        try:
            self._gate_durable()
            atomic_write_bytes(self.path, (text + "\n").encode())
        except OSError as exc:
            if exc.errno not in DISK_FULL_ERRNOS:
                raise
            self.note_disk_failure("journal flush", exc)

    def load(self) -> dict | None:
        """The committed document, or None when no journal exists yet.
        A parse failure is a real error (the atomic writer cannot tear
        the file — unreadable means someone else wrote it)."""
        if not os.path.exists(self.path):
            return None
        with open(self.path) as fh:
            doc = json.load(fh)
        if (not isinstance(doc, dict)
                or doc.get("schema") not in JOURNAL_SCHEMAS_READABLE):
            raise ValueError(
                f"journal {self.path}: schema "
                f"{doc.get('schema') if isinstance(doc, dict) else doc!r}"
                f" not in {JOURNAL_SCHEMAS_READABLE}"
            )
        return doc
