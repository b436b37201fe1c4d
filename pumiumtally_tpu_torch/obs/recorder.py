"""Per-move flight recorder: a bounded in-memory trail of structured
records plus optional JSONL emission.

Counterpart of ``pumiumtally_tpu/obs/recorder.py``. Every facade call
appends one record (walk stats, phase seconds, transfer counts); the
recorder keeps the last ``capacity`` in a ring for ``telemetry()`` and,
when ``PUMI_TPU_METRICS=jsonl:/path`` is set, streams each record to that
file (``utils/log.py::emit_metric``), so a crashed run leaves its whole
per-move history on disk.

The serving path's recorders (scheduler, journal, bank) stamp every
record with ``schema=FLIGHT_SCHEMA``, so the JSONL streams of a killed
server and of its restarted successor stay distinguishable.
"""
from __future__ import annotations

import collections
import threading

from ..utils.log import emit_metric

#: Version stamp of the serving path's flight records.
FLIGHT_SCHEMA = 1


class FlightRecorder:
    def __init__(self, capacity: int = 512, sink: str | None = None,
                 schema: int | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._schema = schema
        # None defers to PUMI_TPU_METRICS at record time.
        self._sink = sink
        # Sequencing and the ring append happen under one lock, so
        # records from several threads get unique, gap-free numbers.
        self._lock = threading.Lock()
        self._records = collections.deque(maxlen=capacity)  # guarded by: self._lock
        self._seq = 0  # guarded by: self._lock

    def record(self, kind: str, **fields) -> dict:
        """Append one record; ``kind`` names the event ("move",
        "initial_search", "memory", ...). Returns the stored record."""
        with self._lock:
            rec = {"seq": self._seq, "kind": str(kind), **fields}
            if self._schema is not None:
                rec.setdefault("schema", self._schema)
            self._seq += 1
            self._records.append(rec)
        emit_metric(rec, path=self._sink)
        return rec

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)

    def tail(self, n: int) -> list[dict]:
        if n <= 0:
            return []
        with self._lock:
            return list(self._records)[-n:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    @property
    def total_recorded(self) -> int:
        """Records ever appended (>= len() once the ring wraps)."""
        with self._lock:
            return self._seq
