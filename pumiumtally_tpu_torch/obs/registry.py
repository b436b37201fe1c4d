"""Labeled metrics registry: counters, gauges, histograms.

Counterpart of ``pumiumtally_tpu/obs/registry.py``, with the same metric
kinds, label model and text formats: a small in-process registry with
``snapshot()`` for structured consumers (``PumiTally.telemetry()``) and
Prometheus text exposition for scrapers.

Label handling follows the Prometheus model: a metric name owns a family
of series keyed by the label set supplied at observation time
(``counter.inc(3, device="cuda:0")``); the empty label set is one series.
"""
from __future__ import annotations

import math
import threading


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: dict = {}
        self._lock = threading.Lock()

    def labels_seen(self) -> list[dict]:
        return [dict(k) for k in self._series]

    def _snapshot_value(self, v):
        return v

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "type": self.kind,
                "help": self.help,
                "series": [
                    {"labels": dict(k), "value": self._snapshot_value(v)}
                    for k, v in self._series.items()
                ],
            }


class Counter(_Metric):
    """Monotonically increasing count (negative increments rejected)."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc {amount})"
            )
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0)


class Gauge(_Metric):
    """Point-in-time value (set wins; inc/dec for running levels)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = value

    def inc(self, amount: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def dec(self, amount: float = 1, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0)


# Wall-clock-per-move oriented default: 1 ms .. 60 s.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations <= its upper bound; +Inf is implicit)."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        b = tuple(sorted(float(x) for x in buckets))
        if not b or any(not math.isfinite(x) for x in b):
            raise ValueError(f"histogram {name}: buckets must be finite")
        self.buckets = b

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = {"count": 0, "sum": 0.0,
                     "buckets": [0] * len(self.buckets)}
                self._series[key] = s
            s["count"] += 1
            s["sum"] += float(value)
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    s["buckets"][i] += 1

    def value(self, **labels) -> dict | None:
        s = self._series.get(_label_key(labels))
        return None if s is None else dict(s, buckets=list(s["buckets"]))

    def _snapshot_value(self, v):
        return {
            "count": v["count"],
            "sum": v["sum"],
            "buckets": dict(zip((str(b) for b in self.buckets),
                                v["buckets"])),
        }


def _fmt_labels(labels: dict, extra: dict | None = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(items.items()))
    return "{" + inner + "}"


class MetricsRegistry:
    """Create-or-get metric families by name; duplicate names must agree
    on type (a counter named like an existing gauge raises)."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            elif help and m.help and help != m.help:
                # The same name with another meaning is refused rather
                # than served under one family's help text. The same
                # help, or a lookup with none, is a create-or-get.
                raise ValueError(
                    f"metric {name!r} already registered with help "
                    f"{m.help!r}; conflicting help {help!r}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def _families(self) -> dict:
        """Stable copy of the family table: readers iterate the copy,
        never the live dict, which a registration from another thread
        may change under them."""
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> dict:
        """{name: {type, help, series: [{labels, value}, ...]}}: the
        structured view ``telemetry()`` embeds."""
        return {name: m.snapshot() for name, m in self._families().items()}

    def render_prometheus(self) -> str:
        """Prometheus text exposition (content-type
        ``text/plain; version=0.0.4``) of every registered series."""
        lines: list[str] = []
        for name, m in sorted(self._families().items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for entry in m.snapshot()["series"]:
                labels = entry["labels"]
                if m.kind == "histogram":
                    v = entry["value"]
                    # observe() incremented every bucket with value <= ub,
                    # so the stored counts are already cumulative.
                    for ub, c in v["buckets"].items():
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(labels, {'le': ub})} {c}"
                        )
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, {'le': '+Inf'})} "
                        f"{v['count']}"
                    )
                    lines.append(
                        f"{name}_sum{_fmt_labels(labels)} {v['sum']}"
                    )
                    lines.append(
                        f"{name}_count{_fmt_labels(labels)} {v['count']}"
                    )
                else:
                    lines.append(
                        f"{name}{_fmt_labels(labels)} {entry['value']}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")


# Process-default registry for callers that want one shared aggregation
# point; the facades default to a private registry per tally instance so
# concurrent tallies (and tests) do not interleave counts.
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT
