"""Declarative SLOs with multi-window burn-rate evaluation.

Counterpart of ``pumiumtally_tpu/obs/slo.py``. An SLO is a statement
over metrics the serving path already emits:

  * ``kind="latency"``: the fraction of a histogram family's
    observations at or under ``threshold_s`` (good = the cumulative
    count of the largest bucket bound <= the threshold, so "good" never
    overcounts);
  * ``kind="ratio"``: the fraction of a counter family's observations
    whose ``label`` value is in ``good_values`` (job success over
    ``pumi_jobs_total{outcome=}``);
  * ``kind="availability"``: the fraction of members alive, one
    observation a member a tick.

For each ``(fast, slow)`` window pair the burn rate is

    burn(W) = (bad_W / total_W) / (1 - objective)

(1.0 burns the error budget exactly at the objective's rate); an alert
fires only when both windows burn above ``alert_burn``. Burn rates are
the ``pumi_slo_burn_rate{slo=,window=}`` gauges; a rising edge records
an ``slo_breach`` flight record naming the member whose bad count grew
most over the fast window. A single scheduler is one member.

The evaluator is pull-based: one cumulative (good, total) sample a
member a tick into a bounded ring, deltas against the ring on
evaluation, nothing on the dispatch path.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque


@dataclasses.dataclass(frozen=True)
class SLO:
    """One objective over an existing metric family."""

    name: str
    kind: str                      # "latency" | "ratio" | "availability"
    objective: float               # target good fraction, e.g. 0.99
    metric: str = ""               # histogram/counter family name
    threshold_s: float | None = None   # latency: good iff <= threshold
    label: str = ""                # ratio: label key holding the outcome
    good_values: tuple = ()        # ratio: label values that count good
    windows: tuple = ((30.0, 120.0),)  # (fast_s, slow_s) pairs
    alert_burn: float = 1.0        # burn threshold (both windows)

    def __post_init__(self):
        if self.kind not in ("latency", "ratio", "availability"):
            raise ValueError(f"SLO {self.name}: unknown kind {self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO {self.name}: objective must be in (0, 1): "
                f"{self.objective}"
            )
        if self.kind == "latency" and (
            not self.metric or self.threshold_s is None
        ):
            raise ValueError(
                f"SLO {self.name}: latency kind needs metric + threshold_s"
            )
        if self.kind == "ratio" and (
            not self.metric or not self.label or not self.good_values
        ):
            raise ValueError(
                f"SLO {self.name}: ratio kind needs metric + label + "
                "good_values"
            )
        for pair in self.windows:
            fast, slow = pair
            if not 0 < fast <= slow:
                raise ValueError(
                    f"SLO {self.name}: window pair {pair} must satisfy "
                    "0 < fast <= slow"
                )


def default_slos() -> tuple:
    """The fleet's stock objectives — all over families the scheduler
    already emits (serving/scheduler.py)."""
    return (
        SLO(
            name="job-e2e-latency",
            kind="latency",
            metric="pumi_job_e2e_seconds",
            threshold_s=30.0,
            objective=0.95,
            windows=((60.0, 300.0),),
        ),
        SLO(
            name="time-to-first-quantum",
            kind="latency",
            metric="pumi_job_time_to_first_quantum_seconds",
            threshold_s=10.0,
            objective=0.95,
            windows=((60.0, 300.0),),
        ),
        SLO(
            name="job-success",
            kind="ratio",
            metric="pumi_jobs_total",
            label="outcome",
            good_values=("completed", "cancelled"),
            objective=0.99,
            windows=((60.0, 300.0),),
        ),
        SLO(
            name="member-availability",
            kind="availability",
            objective=0.90,
            windows=((30.0, 120.0),),
        ),
    )


def _latency_counts(registry, metric: str, threshold: float):
    """(good, total) over every series of a histogram family: good is
    the cumulative count of the largest bucket bound <= threshold —
    an under-count when the threshold falls inside a bucket, never an
    over-count."""
    snap = registry.snapshot().get(metric)
    if snap is None or snap["type"] != "histogram":
        return 0, 0
    good = total = 0
    for entry in snap["series"]:
        v = entry["value"]
        total += v["count"]
        best = -1.0
        best_c = 0
        for ub, c in v["buckets"].items():
            b = float(ub)
            if b <= threshold and b > best:
                best, best_c = b, c
        good += best_c
    return good, total


def _ratio_counts(registry, metric: str, label: str, good_values):
    snap = registry.snapshot().get(metric)
    if snap is None:
        return 0, 0
    good = total = 0
    for entry in snap["series"]:
        v = entry["value"]
        total += v
        if entry["labels"].get(label) in good_values:
            good += v
    return good, total


class SLOEvaluator:
    """Tick-driven burn-rate evaluation over per-member registries.

    ``evaluate(members)`` takes ``[(index, label, registry, alive),
    ...]`` — the router's live view — appends one cumulative sample to
    the ring, recomputes burn rates per window, updates the
    ``pumi_slo_burn_rate`` gauges, and maintains ``self.alerts``
    ({slo name -> alert dict}).  A RISING edge records ``slo_breach``
    through the recorder; the alert stays active (and keeps its
    original attribution) until every window's burn drops back under
    the threshold.
    """

    def __init__(self, slos, registry, recorder=None, *,
                 clock=time.monotonic, max_samples: int = 1024):
        self.slos = tuple(slos)
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.recorder = recorder
        self._clock = clock
        self._burn_gauge = registry.gauge(
            "pumi_slo_burn_rate",
            "error-budget burn rate per SLO and evaluation window "
            "(1.0 = burning exactly at the objective rate; alerts "
            "need every window of a pair above the threshold)",
        )
        self._alerts_gauge = registry.gauge(
            "pumi_slo_alert",
            "1 while the SLO's multi-window burn-rate alert is "
            "active, else 0",
        )
        # Ring of (t, {slo: {"fleet": (good, total),
        #                    "member": {index: (good, total)}}}).
        self._samples: deque = deque(maxlen=int(max_samples))
        # Availability ticks accumulated here so the samples stay
        # cumulative like every counter-backed kind — a raw per-tick
        # (alive, 1) snapshot would difference to zero in every
        # window and the SLO could never burn.
        self._avail: dict[str, dict[int, tuple]] = {}
        #: Active alerts: {slo name: {"slo", "member", "burn", "since"}}.
        self.alerts: dict[str, dict] = {}

    # ------------------------------------------------------------------ #
    def _counts(self, slo: SLO, members):
        """Cumulative (good, total) fleet-wide and per member index."""
        per: dict[int, tuple] = {}
        if slo.kind == "availability":
            cum = self._avail.setdefault(slo.name, {})
            for index, _label, _registry, alive in members:
                good, total = cum.get(index, (0, 0))
                cum[index] = per[index] = (
                    good + (1 if alive else 0), total + 1,
                )
        else:
            # Dead members' registries stay in the fold: their counts
            # are cumulative history — dropping them would shrink the
            # fleet totals and fake a good/bad delta.
            for index, _label, registry, _alive in members:
                if registry is None:
                    continue
                if slo.kind == "latency":
                    per[index] = _latency_counts(
                        registry, slo.metric, slo.threshold_s
                    )
                else:
                    per[index] = _ratio_counts(
                        registry, slo.metric, slo.label, slo.good_values
                    )
        fleet = (
            sum(g for g, _ in per.values()),
            sum(t for _, t in per.values()),
        )
        return fleet, per

    def _window_delta(self, now: float, window: float, slo: str,
                      member: int | None = None):
        """(good_delta, total_delta) between the newest sample and the
        newest sample at least ``window`` old (the oldest one when
        history is still shorter than the window)."""
        if not self._samples:
            return 0, 0
        newest = self._samples[-1]
        base = self._samples[0]
        for s in reversed(self._samples):
            if now - s[0] >= window:
                base = s
                break

        def pick(sample):
            entry = sample[1].get(slo)
            if entry is None:
                return (0, 0)
            if member is None:
                return entry["fleet"]
            return entry["member"].get(member, (0, 0))

        g1, t1 = pick(newest)
        g0, t0 = pick(base)
        # Availability samples are per-tick observations, cumulative by
        # construction; counters can only grow — clamp defensively so a
        # member swap never yields negative deltas.
        return max(0, g1 - g0), max(0, t1 - t0)

    @staticmethod
    def _burn(good: float, total: float, objective: float) -> float:
        if total <= 0:
            return 0.0
        bad_ratio = (total - good) / total
        return bad_ratio / (1.0 - objective)

    # ------------------------------------------------------------------ #
    def evaluate(self, members) -> dict:
        """One tick: sample, recompute burns, maintain alerts.
        Returns ``self.alerts`` (live dict, keyed by SLO name)."""
        now = self._clock()
        sample = {}
        for slo in self.slos:
            fleet, per = self._counts(slo, members)
            sample[slo.name] = {"fleet": fleet, "member": per}
        self._samples.append((now, sample))

        for slo in self.slos:
            breaching = False
            burns = {}
            for fast, slow in slo.windows:
                pair_hot = True
                for w in (fast, slow):
                    g, t = self._window_delta(now, w, slo.name)
                    burn = self._burn(g, t, slo.objective)
                    burns[f"{w:g}s"] = burn
                    self._burn_gauge.set(
                        burn, slo=slo.name, window=f"{w:g}s"
                    )
                    if burn <= slo.alert_burn:
                        pair_hot = False
                breaching = breaching or pair_hot
            active = self.alerts.get(slo.name)
            if breaching and active is None:
                fast = min(f for f, _ in slo.windows)
                offender = None
                worst = 0
                for index, _label, _registry, _alive in members:
                    g, t = self._window_delta(
                        now, fast, slo.name, member=index
                    )
                    bad = t - g
                    if bad > worst:
                        worst, offender = bad, index
                alert = {
                    "slo": slo.name,
                    "member": offender,
                    "burn": dict(burns),
                    "since": now,
                }
                self.alerts[slo.name] = alert
                if self.recorder is not None:
                    self.recorder.record(
                        "slo_breach", slo=slo.name, member=offender,
                        burn=dict(burns),
                        objective=slo.objective,
                    )
            elif breaching:
                active["burn"] = dict(burns)
            elif active is not None:
                del self.alerts[slo.name]
            self._alerts_gauge.set(
                1.0 if slo.name in self.alerts else 0.0, slo=slo.name
            )
        return self.alerts

    # ------------------------------------------------------------------ #
    def alerts_by_member(self) -> dict[int, list[dict]]:
        """Active alerts grouped by attributed member index (alerts
        with no attribution — e.g. a fleet-wide availability burn —
        are not anyone's fault and do not appear here)."""
        out: dict[int, list[dict]] = {}
        for alert in self.alerts.values():
            if alert.get("member") is not None:
                out.setdefault(int(alert["member"]), []).append(alert)
        return out

    def status(self) -> dict:
        """The FLEETSTATS.json ``slo`` section: declared objectives,
        current burns, active alerts, and the recent sample ring (the
        burn timeline fleetview renders)."""
        now = self._clock()
        slos = []
        for slo in self.slos:
            windows = []
            for fast, slow in slo.windows:
                for w in (fast, slow):
                    g, t = self._window_delta(now, w, slo.name)
                    windows.append({
                        "window_s": w,
                        "good": g,
                        "total": t,
                        "burn": self._burn(g, t, slo.objective),
                    })
            slos.append({
                "name": slo.name,
                "kind": slo.kind,
                "objective": slo.objective,
                "metric": slo.metric,
                "threshold_s": slo.threshold_s,
                "windows": windows,
                "alert": self.alerts.get(slo.name),
            })
        timeline = [
            {
                "t": t,
                "age_s": now - t,
                "slos": {
                    name: {"fleet": list(entry["fleet"])}
                    for name, entry in sample.items()
                },
            }
            for t, sample in list(self._samples)[-64:]
        ]
        return {"slos": slos, "alerts": dict(self.alerts),
                "timeline": timeline}
