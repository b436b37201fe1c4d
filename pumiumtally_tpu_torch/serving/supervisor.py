"""Self-healing fleet supervisor: eviction driven by health probes.

Counterpart of ``pumiumtally_tpu/serving/supervisor.py``, with the same
states, hysteresis, journal records and metrics. ``FleetSupervisor``
finds a member that wedges, slows down or fills its disk with no kill
signal anywhere:

  detect   every ``tick()`` probes each alive member's heartbeat
           (``TallyScheduler.heartbeat``: on the port a round trip to
           the card through ``resilience/coordinator.py``'s
           ``probe_chips``), reads its per-quantum latency window
           (``scheduler.recent_quantum_seconds``) and its journal's
           disk-pressure flag (serving/journal.py "Degraded mode").
  decide   each member is classified::

             healthy ──(probe miss x heartbeat_misses)──▶ wedged
             healthy ──(median quantum > slow_factor x
                        fleet median over `window` quanta)──▶ brownout
             healthy ──(journal.degraded)──▶ disk-pressured
             healthy ──(an SLO burn-rate alert attributes this
                        member, obs/slo.py)──▶ slo-burn

           An unhealthy member is quarantined first: it keeps and runs
           its jobs but gets no new placement (``FleetRouter._choose``
           ranks it last). Only more than ``grace_ticks`` unhealthy
           ticks in a row evict it, and ``restore_ticks`` healthy ticks
           in a row lift the quarantine, so a slow member that recovers
           is not drained.
  drain    eviction journals the decision first
           (``FleetRouter.record_eviction``: FLEET.json's ``evicted``),
           then drains: a wedged member's in-memory table is not
           trusted, so its journal places its jobs
           (``drain_member_from_journal``); a brownout or disk-pressured
           member still answers and hands its jobs over itself
           (``drain_member``: park, export, adopt on a healthy peer,
           drop). A crash between record and drain leaves an eviction
           that recovery replays.

Evicted jobs end bitwise the fault-free run's: placement rides the
migration's checkpoint adoption (the random stream is keyed by the move
counter), and a disk-pressured member's unpersisted state replays from
its last durable checkpoint or from move 0. The trace goes on with an
``evicted`` link event.

Metrics, on the router's registry:

  pumi_member_health{member,state}    1 for the member's state
                                      (healthy/brownout/wedged/
                                      disk-pressured/slo-burn/evicted),
                                      0 for the others
  pumi_evictions_total{cause}         evictions by detected cause
  pumi_supervisor_probe_seconds       wall seconds a tick() sweep

The supervisor runs synchronously (``tick()`` between scheduling rounds,
or ``run()``, which interleaves them) under the router's lock: no
background thread touches a member scheduler.
"""
from __future__ import annotations

import statistics
import time

from ..utils.log import log_info, log_warn

#: Every state ``pumi_member_health`` reports ("evicted" is terminal).
#: "slo-burn": an SLO's burn-rate alert (obs/slo.py) attributes the
#: member; it goes through the brownout's hysteresis, the trigger being
#: the objective rather than the quantum window.
HEALTH_STATES = (
    "healthy", "brownout", "wedged", "disk-pressured", "slo-burn",
    "evicted",
)


class FleetSupervisor:
    """Periodic health sweep over one ``FleetRouter`` (module
    docstring).  Construct it over a live router and either call
    ``tick()`` from your own loop or ``run()`` to drive the fleet to
    drain with supervision interleaved.

    Knobs (all per-tick, so the wall-clock grace scales with however
    often the caller ticks):

      slow_factor       brownout threshold: member median quantum
                        latency > ``slow_factor`` x fleet median
      window            quanta in the sliding latency window (a member
                        needs a full window before it can be judged
                        slow; the fleet needs >= 2 judged members for
                        a median)
      heartbeat_misses  consecutive failed probes before "wedged"
      grace_ticks       consecutive unhealthy ticks tolerated in
                        quarantine before eviction
      restore_ticks     consecutive healthy ticks before a quarantined
                        member is restored
    """

    def __init__(self, router, *, slow_factor: float = 3.0,
                 window: int = 4, heartbeat_misses: int = 2,
                 grace_ticks: int = 2, restore_ticks: int = 2):
        if float(slow_factor) <= 1.0:
            raise ValueError(
                f"slow_factor must be > 1.0: {slow_factor}"
            )
        for name, v in (("window", window),
                        ("heartbeat_misses", heartbeat_misses),
                        ("grace_ticks", grace_ticks),
                        ("restore_ticks", restore_ticks)):
            if int(v) < 1:
                raise ValueError(f"{name} must be >= 1: {v}")
        self.router = router
        self.slow_factor = float(slow_factor)
        self.window = int(window)
        self.heartbeat_misses = int(heartbeat_misses)
        self.grace_ticks = int(grace_ticks)
        self.restore_ticks = int(restore_ticks)
        #: Per-member streak counters: consecutive probe misses,
        #: consecutive healthy ticks, consecutive unhealthy ticks.
        self._track: dict[int, dict] = {}
        r = router.registry
        self._health_gauge = r.gauge(
            "pumi_member_health",
            "1 for the member's current supervisor-classified health "
            "state (healthy/brownout/wedged/disk-pressured/slo-burn/"
            "evicted), 0 for the others — labeled by member and state",
        )
        self._evictions_total = r.counter(
            "pumi_evictions_total",
            "members evicted by the fleet supervisor, labeled by the "
            "detected cause (wedged/brownout/disk-pressured/slo-burn)",
        )
        self._probe_seconds = r.histogram(
            "pumi_supervisor_probe_seconds",
            "wall seconds per supervisor tick (heartbeat probes + "
            "latency classification over every alive member)",
        )
        for m in router.members:
            self._set_health(m)

    # ------------------------------------------------------------------ #
    # Detection
    # ------------------------------------------------------------------ #
    def tick(self) -> None:
        """One detect-decide sweep over every alive member (module
        docstring state machine).  May evict — which re-places jobs
        onto healthy peers and can raise ``RuntimeError`` when none
        survive to take them."""
        t0 = time.perf_counter()
        with self.router.lock:
            members = [m for m in self.router.members if m.alive]
            # The observability plane's advisory signal: active
            # burn-rate alerts attributed to a member (obs/slo.py,
            # evaluated by the router's obs tick).  Empty when the
            # plane is off.
            slo_alerts = self.router.slo_alerts_by_member()
            # Latency view: a member is judged only on a FULL window,
            # and only against a fleet median built from >= 2 judged
            # members — one member alone has nothing to be slower than.
            medians = {}
            for m in members:
                recent = list(m.scheduler.recent_quantum_seconds)
                if len(recent) >= self.window:
                    medians[m.index] = statistics.median(
                        recent[-self.window:]
                    )
            fleet_median = (
                statistics.median(medians.values())
                if len(medians) >= 2 else None
            )
            for m in members:
                track = self._track.setdefault(
                    m.index, {"misses": 0, "ok": 0, "unhealthy": 0}
                )
                beat = m.scheduler.heartbeat()
                track["misses"] = 0 if beat else track["misses"] + 1
                if track["misses"] >= self.heartbeat_misses:
                    state = "wedged"
                elif (m.scheduler.journal is not None
                      and m.scheduler.journal.degraded):
                    state = "disk-pressured"
                elif slo_alerts.get(m.index):
                    # SLO advisory ranks above the raw latency window:
                    # the objective IS the contract, and the breach
                    # record (journaled by _advise_slo before the
                    # quarantine) must cite the SLO signal.
                    state = "slo-burn"
                elif (fleet_median is not None
                      and fleet_median > 0.0
                      and m.index in medians
                      and medians[m.index]
                      > self.slow_factor * fleet_median):
                    state = "brownout"
                else:
                    state = "healthy"
                if state == "slo-burn" and not m.quarantined:
                    self._advise_slo(m, slo_alerts[m.index][0])
                self._apply(m, state, credit=beat)
        self._probe_seconds.observe(time.perf_counter() - t0)

    # ------------------------------------------------------------------ #
    # Decision (hysteresis) + drain
    # ------------------------------------------------------------------ #
    def _apply(self, member, state: str, *, credit: bool) -> None:
        """Fold one tick's classification into the member's streaks:
        quarantine on the first unhealthy tick, evict after
        ``grace_ticks`` consecutive ones, restore after
        ``restore_ticks`` consecutive healthy ticks.  A healthy
        classification with a MISSED probe (``credit=False`` — below
        the wedged deadline but suspect) neither breaks nor builds the
        healthy streak."""
        track = self._track[member.index]
        if state == "healthy":
            track["unhealthy"] = 0
            if credit:
                track["ok"] += 1
            if member.quarantined and track["ok"] >= self.restore_ticks:
                member.quarantined = False
                member.health = "healthy"
                self.router.recorder.record(
                    "member_restored", member=member.index,
                )
                log_info(
                    f"fleet member {member.index} restored to healthy "
                    f"after {track['ok']} clean ticks — quarantine "
                    "lifted, jobs untouched"
                )
            elif not member.quarantined:
                member.health = "healthy"
            self._set_health(member)
            return
        track["ok"] = 0
        track["unhealthy"] += 1
        member.health = state
        if not member.quarantined:
            self._quarantine(member, state)
        self._set_health(member)
        if track["unhealthy"] > self.grace_ticks:
            self._evict(member, state)

    def _quarantine(self, member, state: str) -> None:
        """Flip one member into quarantine (no new placements, jobs
        keep running) and record the decision with the state that
        triggered it."""
        member.quarantined = True
        self.router.recorder.record(
            "member_quarantined", member=member.index, state=state,
        )
        log_warn(
            f"fleet member {member.index} quarantined ({state}): "
            "no new placements; eviction after "
            f"{self.grace_ticks} more unhealthy ticks"
        )

    def _advise_slo(self, member, alert: dict) -> None:
        """Act on one SLO burn-rate attribution: journal the breach in
        FLEET.json first, then quarantine the member
        (breach-record-before-quarantine), so the quarantine is
        explained by the routing journal even if the process dies right
        after it. Eviction and restore stay with ``_apply``."""
        self.router.record_breach(member.index, alert)
        member.health = "slo-burn"
        self._quarantine(member, "slo-burn")

    def _evict(self, member, cause: str) -> int:
        """Evict one member: journal the decision, then drain its jobs
        onto healthy peers (eviction-record-before-drain): a journaled
        eviction whose drain never ran is replayed at recovery from the
        member's journal; the other order would leave moved jobs under a
        member the routing journal still calls healthy."""
        self.router.record_eviction(member.index, cause)
        if cause == "wedged":
            # The member answers nothing — its in-memory table is
            # untrustworthy; the on-disk write-ahead journal re-places.
            moved = self.router.drain_member_from_journal(
                member.index, cause=cause
            )
        else:
            # Brownout / disk pressure: the scheduler still answers,
            # so it hands its jobs over cooperatively (including a
            # degraded-disk member's unpersisted results).
            moved = self.router.drain_member(member.index, cause=cause)
        self._evictions_total.inc(cause=cause)
        self._set_health(member)
        self._track.pop(member.index, None)
        return moved

    def _set_health(self, member) -> None:
        for state in HEALTH_STATES:
            self._health_gauge.set(
                1.0 if member.health == state else 0.0,
                member=f"m{member.index}", state=state,
            )

    # ------------------------------------------------------------------ #
    # The supervised scheduling loop
    # ------------------------------------------------------------------ #
    def step(self) -> bool:
        """One scheduling round + one supervision sweep.  Returns True
        while any accepted job is non-terminal — including jobs held
        by a wedged member the router's own loop cannot advance, so a
        supervised fleet never declares itself drained while work is
        stuck behind a pending eviction."""
        pending = self.router.step()
        self.tick()
        return pending or any(
            not j.terminal for j in self.router.jobs()
        )

    def run(self, max_rounds: int = 100000) -> None:
        for _ in range(max_rounds):
            if not self.step():
                return
        raise RuntimeError(
            f"supervised fleet did not drain within {max_rounds} "
            "rounds"
        )
