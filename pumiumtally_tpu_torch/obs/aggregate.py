"""Metric aggregation: merge N member registries into one.

Counterpart of ``pumiumtally_tpu/obs/aggregate.py``, on the port's
``obs/registry.py``. ``FleetAggregator`` merges every member's registry
snapshot with Prometheus semantics:

  * counters are summed across members a label set;
  * histograms are bucket-merged a label set (one ``DEFAULT_BUCKETS``
    ladder everywhere, so cumulative counts, sums and totals add);
  * gauges stay a member each under a ``{member="mK"}`` label (a level
    has no meaningful sum).

``render_snapshot_prometheus`` renders the merge (or a
``FLEETSTATS.json`` read back from disk) as Prometheus text.

Merging does not depend on the members' order: sources are sorted by
label before the fold and every series list is emitted in sorted label
order, so two aggregators over the same registries render the same
bytes.
"""
from __future__ import annotations

from .registry import _fmt_labels, _label_key

FLEETSTATS_SCHEMA = 1
FLEETSTATS_FILE = "FLEETSTATS.json"


def _merge_hist(a: dict, b: dict) -> dict:
    """Merge two histogram snapshot values ({count, sum, buckets}).
    Bucket maps may differ (custom ladders): union the bounds — a
    bound one side never saw contributes that side's total count at
    +Inf only, which the cumulative render already handles."""
    buckets = dict(a["buckets"])
    for ub, c in b["buckets"].items():
        buckets[ub] = buckets.get(ub, 0) + c
    return {
        "count": a["count"] + b["count"],
        "sum": a["sum"] + b["sum"],
        "buckets": buckets,
    }


class FleetAggregator:
    """Merge member registries into one fleet-level snapshot.

    ``sources`` is a zero-arg callable returning ``[(label, registry),
    ...]`` — a callable, not a static list, so membership changes
    (evictions, deaths) are reflected at the next merge without the
    aggregator holding references to dead schedulers.
    """

    def __init__(self, sources):
        self._sources = sources

    def merge(self) -> dict:
        """{name: {type, help, series: [{labels, value}]}} — the same
        shape as ``MetricsRegistry.snapshot()``, so every structured
        consumer of a single registry can read the fleet rollup."""
        merged: dict[str, dict] = {}
        for label, registry in sorted(
            self._sources(), key=lambda s: str(s[0])
        ):
            for name, fam in registry.snapshot().items():
                out = merged.get(name)
                if out is None:
                    out = merged[name] = {
                        "type": fam["type"],
                        "help": fam["help"],
                        "series": {},
                    }
                elif out["type"] != fam["type"]:
                    # Cross-member type drift: impossible while every
                    # member runs the same code; refuse to fold rather
                    # than serve a lie.
                    raise ValueError(
                        f"fleet metric {name!r}: member {label} "
                        f"registers {fam['type']}, another member "
                        f"registered {out['type']}"
                    )
                if not out["help"] and fam["help"]:
                    out["help"] = fam["help"]
                for entry in fam["series"]:
                    labels = dict(entry["labels"])
                    if fam["type"] == "gauge":
                        # Point-in-time levels stay attributable.
                        labels["member"] = str(label)
                    key = _label_key(labels)
                    prev = out["series"].get(key)
                    if prev is None:
                        out["series"][key] = (labels, entry["value"])
                    elif fam["type"] == "histogram":
                        out["series"][key] = (
                            labels, _merge_hist(prev[1], entry["value"])
                        )
                    else:
                        out["series"][key] = (
                            labels, prev[1] + entry["value"]
                        )
        return {
            name: {
                "type": fam["type"],
                "help": fam["help"],
                "series": [
                    {"labels": labels, "value": value}
                    for _, (labels, value) in sorted(
                        fam["series"].items()
                    )
                ],
            }
            for name, fam in merged.items()
        }

    def render_prometheus(self) -> str:
        """Prometheus text exposition of the merged snapshot — the
        ``/fleetz`` body (mirrors MetricsRegistry.render_prometheus,
        but over the fold instead of a live family table)."""
        return render_snapshot_prometheus(self.merge())


def render_snapshot_prometheus(snap: dict) -> str:
    """Render a snapshot-shaped dict ({name: {type, help, series}}) as
    Prometheus text.  Shared by the aggregator (live ``/fleetz``) and
    fleetview (rendering a FLEETSTATS.json recovered from disk)."""
    lines: list[str] = []
    for name, fam in sorted(snap.items()):
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for entry in fam["series"]:
            labels = entry["labels"]
            if fam["type"] == "histogram":
                v = entry["value"]
                for ub, c in sorted(
                    v["buckets"].items(), key=lambda kv: float(kv[0])
                ):
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
