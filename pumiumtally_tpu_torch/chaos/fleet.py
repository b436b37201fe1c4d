"""Fleet chaos campaign: the serving fleet under fire, each scenario with a
DECLARED outcome.

Counterpart of the JAX package's ``scripts/chaos_fleet.py``. Every
scenario drives the same mixed-class job workload (a 2^3 box, six jobs of
40 and 100 particles, 8 moves in quanta of 4) through the ``FleetRouter``
and ``TallyGateway`` stack (``serving/fleet.py``, ``serving/gateway.py``;
three members, all on one device) and asserts the fleet contracts:

  * **zero lost, zero duplicated**: after any fault every accepted job
    reaches a terminal outcome on exactly ONE alive member (FLEET.json's
    assignment record arbitrates; member journals are disjoint);
  * **bitwise survivors**: every non-poisoned job's flux is bitwise the
    fault-free reference's, whether it ran uninterrupted, was re-placed
    off a dead member mid-run (resuming from its quantum-boundary
    checkpoint on another member) or was recovered by a fresh router
    process;
  * **trace continuity**: every job, migrated and poisoned included,
    passes ``obs/trace.py``'s ``check_job_trace`` against the fleet
    directory alone, with a ``migrated`` / ``recovered`` / ``evicted``
    link wherever its spans cross process lifetimes;
  * **reconstructible observability**: every scenario ends with
    ``obs/fleetview.py``'s ``check_fleetstats`` over its fleet directory.

Scenarios (all by default; ``--only`` takes one name or a comma-separated
list, ``--list`` names them):

  member_kill   one member dies mid-run (injected kill, absorbed) and
                another poisons one of ITS jobs;
  router_kill   the ROUTER process dies mid-run (a subprocess of
                ``python -m pumiumtally_tpu_torch.serving --fleet``,
                crashed by an injected member kill with absorption off),
                then ``--resume`` recovers the fleet from FLEET.json and
                the member journals with nothing built (warm bank);
  retry_storm   every job POSTed 4x concurrently with one idempotency key:
                one job id and one execution per key;
  wedged_member member 0 silently wedges: the FleetSupervisor evicts it on
                missed heartbeats alone and re-places its jobs from its
                journal with ``evicted`` trace links;
  brownout      member 0 runs 100x slow: the SLO burn-rate alert fires,
                the supervisor quarantines it citing the SLO (FLEET.json
                journals the breach first), does NOT evict, and restores
                it once the latency clears; its jobs finish bitwise;
  disk_pressure member 0's disk fills (ENOSPC on every durable write):
                its journal degrades, residents park at the quantum
                boundary and the supervisor drains the member.

    python -m pumiumtally_tpu_torch.chaos.fleet [--jobs N] [--only NAMES]
        [--list] [--device cuda|cpu]

Exit code 0 = every scenario met its declared contract.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

from ..obs import SLO
from ..obs.aggregate import FLEETSTATS_FILE, FLEETSTATS_SCHEMA
from ..obs.fleetview import check_fleetstats, load_dir as load_fleet_view
from ..obs.registry import DEFAULT_BUCKETS
from ..obs.trace import check_job_trace, job_trace, load_trace_records
from ..resilience.faultinject import ChaosInjector, ChaosPlan
from ..serving import FleetRouter, FleetSupervisor, TallyGateway
from ..serving.journal import request_to_json
from ..serving.saturate import synthetic_requests
from ..utils.platform import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = 2
CLASSES = (40, 100)
N_MOVES = 8     # a multiple of QUANTUM: resumed chunks run the same
QUANTUM = 4     # quanta as the uninterrupted run
SEED = 3
N_MEMBERS = 3
SUBPROCESS_TIMEOUT_S = 900


#: The library bank every router of a campaign shares (``--bank``); None
#: makes a fresh one in the campaign's temporary directory.
BANK_DIR: str | None = None


def bank_dir(tmpdir: str) -> str:
    return BANK_DIR or os.path.join(tmpdir, "bank")


def build(device):
    from ..mesh.box import build_box
    from ..utils.config import TallyConfig

    mesh = build_box(1.0, 1.0, 1.0, CELLS, CELLS, CELLS, device=device)
    return mesh, TallyConfig(tolerance=1e-6)


def make_router(mesh, cfg, fleet_dir, bank, **kw):
    kw.setdefault("max_resident", 2)
    kw.setdefault("quantum_moves", QUANTUM)
    kw.setdefault("job_retries", 2)
    return FleetRouter(
        mesh, cfg, fleet_dir=fleet_dir, n_members=N_MEMBERS,
        bank=bank, device=mesh.device, **kw,
    )


def submit_all(router, requests):
    return [
        router.submit(r, idempotency_key=f"key-{r.job_id}")
        for r in requests
    ]


def reference_results(mesh, cfg, tmpdir, requests) -> dict:
    """Fault-free fleet run: the bitwise oracle for every scenario (the
    member count cannot change a flux: every member shares one mesh,
    configuration and bank, and the quantum chunking is the same)."""
    router = make_router(
        mesh, cfg, os.path.join(tmpdir, "ref-fleet"),
        bank_dir(tmpdir),
    )
    try:
        ids = submit_all(router, requests)
        router.run()
        return {i: np.asarray(router.result(i)) for i in ids}
    finally:
        router.close()


def fleet_trace_problems(fleet_dir: str, job_ids) -> list[str]:
    """``check_job_trace`` over every job, from the fleet directory alone
    (the shared TRACE.jsonl and the black-box dumps)."""
    records = load_trace_records(fleet_dir)
    problems = []
    for jid in sorted(job_ids):
        for p in check_job_trace(job_trace(records, jid), jid):
            problems.append(f"{jid}: {p}")
    return problems


def fleet_obs_problems(name: str, fleet_dir: str) -> list[str]:
    """``check_fleetstats`` over one scenario's fleet directory (the
    reconstructible-observability contract); problems are printed AND
    returned so every scenario folds them into its verdict."""
    problems = check_fleetstats(load_fleet_view(fleet_dir))
    for p in problems:
        print(f"[chaos-fleet] {name}: fleetview check: {p}", flush=True)
    return problems


def member_journal_ids(fleet_dir: str, member: int) -> set:
    path = os.path.join(
        fleet_dir, f"member-{member:02d}", "JOBS.json"
    )
    if not os.path.exists(path):
        return set()
    with open(path) as fh:
        return set(json.load(fh)["jobs"])


def check_member_kill(name, mesh, cfg, ref, requests, tmpdir) -> bool:
    """Member 0 dies at its 2nd quantum (absorbed: its journaled jobs
    re-place onto survivors and resume from their checkpoints on the
    new member); member 1 poisons the first job placed on it.  Zero
    lost, zero duplicated, survivors bitwise, every trace green."""
    fleet_dir = os.path.join(tmpdir, name)
    router = make_router(
        mesh, cfg, fleet_dir, bank_dir(tmpdir),
        absorb_member_kills=True,
    )
    try:
        ids = submit_all(router, requests)
        # Per-member fault schedules (the router passes one injector
        # to every member; chaos wants them DIFFERENT per member).
        router.members[0].scheduler.faults = ChaosInjector(
            ChaosPlan(kill_server_at_quantum=2)
        )
        router.members[1].scheduler.faults = ChaosInjector(
            ChaosPlan(poison_job=0)
        )
        want_poisoned = {
            next(i for i in ids if router.member_of(i) == 1)
        }
        router.run()
        jobs = {j.id: j for j in router.jobs()}
        got_poisoned = {
            i for i, j in jobs.items() if j.outcome == "poisoned"
        }
        lost = set(ids) - set(jobs)
        duplicated = [
            i for i in ids
            if sum(
                1 for m in router.members if m.alive
                and any(j.id == i for j in m.scheduler.jobs())
            ) > 1
        ]
        terminal = all(j.terminal for j in jobs.values())
        member_died = not router.members[0].alive
        migrations = router.stats()["migrations"]
        bitwise = True
        n_compared = 0
        for i in ids:
            if i in got_poisoned:
                continue
            if jobs[i].outcome != "completed":
                bitwise = False
                break
            if (
                np.asarray(router.result(i)).tobytes()
                != ref[i].tobytes()
            ):
                bitwise = False
                break
            n_compared += 1
    finally:
        router.close()
    trace_problems = fleet_trace_problems(fleet_dir, ids)
    obs_problems = fleet_obs_problems(name, fleet_dir)
    ok = (
        member_died and not lost and not duplicated and terminal
        and got_poisoned == want_poisoned and migrations >= 1
        and bitwise and not trace_problems and not obs_problems
    )
    for p in trace_problems:
        print(f"[chaos-fleet] {name}: trace check: {p}", flush=True)
    print(
        f"[chaos-fleet] {name}: kill member0@q2 + poison on member1 | "
        f"died={member_died} lost={sorted(lost)} "
        f"duplicated={duplicated} poisoned={sorted(got_poisoned)} "
        f"migrations={migrations} "
        f"bitwise({n_compared} survivors)={bitwise} "
        f"traces({len(ids)} jobs)={not trace_problems} "
        f"fleetview={not obs_problems} "
        f"{'OK' if ok else 'FAIL'}",
        flush=True,
    )
    return ok


def serve_fleet_cmd(fleet_dir, bank, n_jobs, cfg, device, resume=False):
    cmd = [
        sys.executable, "-m", "pumiumtally_tpu_torch.serving",
        "--demo", str(n_jobs), "--device", device.type,
        "--cells", str(CELLS), "--groups", str(cfg.n_groups),
        "--dtype", str(cfg.dtype).replace("torch.", ""),
        "--classes", ",".join(map(str, CLASSES)),
        "--moves", str(N_MOVES), "--quantum", str(QUANTUM),
        "--max-resident", "2", "--retries", "2",
        "--seed", str(SEED), "--bank", bank,
        "--fleet", "2", "--port", "0", "--journal", fleet_dir,
    ]
    if resume:
        cmd.append("--resume")
    return cmd


def run_serve_fleet(fleet_dir, bank, n_jobs, cfg, device, faults="",
                    resume=False):
    """One router process; (CompletedProcess, its summary line or None)."""
    env = {
        k: v for k, v in os.environ.items()
        if not k.startswith("PUMI_TPU_")
    }
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    if faults:
        env["PUMI_TPU_FAULTS"] = faults
    proc = subprocess.run(
        serve_fleet_cmd(fleet_dir, bank, n_jobs, cfg, device,
                        resume=resume),
        capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S,
        env=env, cwd=REPO,
    )
    summary = None
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            summary = json.loads(line).get("summary")
            break
        except (json.JSONDecodeError, AttributeError):
            continue
    return proc, summary


def check_router_kill(name, ref, tmpdir, n_jobs, cfg, device) -> bool:
    """The ROUTER process dies mid-run (a member's injected kill with
    absorption off crashes the whole process — the crash model), then
    a --resume restart recovers the fleet from FLEET.json + the member
    journals: zero lost, zero duplicated, nothing built on the warm
    bank, survivors bitwise, traces green across both lifetimes."""
    bank = bank_dir(tmpdir)
    fleet_dir = os.path.join(tmpdir, name)
    kill_proc, _ = run_serve_fleet(
        fleet_dir, bank, n_jobs, cfg, device,
        faults="kill_server_at_quantum:2",
    )
    killed = kill_proc.returncode != 0
    # The KILLED router must leave a last-known FLEETSTATS.json (the
    # plane snapshots atomically at construction and every step) —
    # checked before the restart overwrites it.
    stats_path = os.path.join(fleet_dir, FLEETSTATS_FILE)
    fleetstats_survived = False
    if os.path.exists(stats_path):
        with open(stats_path) as fh:
            fleetstats_survived = (
                json.load(fh).get("schema") == FLEETSTATS_SCHEMA
            )
    res_proc, res_sum = run_serve_fleet(
        fleet_dir, bank, n_jobs, cfg, device, resume=True
    )
    if res_proc.returncode != 0 or res_sum is None:
        print(f"[chaos-fleet] {name}: restart rc={res_proc.returncode}"
              f" (want 0)\n{res_proc.stderr[-2000:]}")
        return False
    ids = sorted(ref)
    # Ownership after recovery: every job in exactly one member
    # journal (the assignment record arbitrated any overlap).
    owned = [member_journal_ids(fleet_dir, m) for m in range(2)]
    union = set().union(*owned)
    lost = set(ids) - union
    duplicated = sorted(owned[0] & owned[1])
    zero_builds = (res_sum["aot"] or {}).get("misses", -1) == 0
    recovered = res_sum.get("recovered", 0) > 0
    completed = res_sum["outcomes"] == {"completed": n_jobs}
    bitwise = True
    n_compared = 0
    for jid in ids:
        flux = None
        for m in range(2):
            p = os.path.join(
                fleet_dir, f"member-{m:02d}", f"{jid}.flux.npy"
            )
            if os.path.exists(p) and jid in owned[m]:
                flux = np.load(p)
        if flux is None or flux.tobytes() != ref[jid].tobytes():
            bitwise = False
            break
        n_compared += 1
    trace_problems = fleet_trace_problems(fleet_dir, ids)
    obs_problems = fleet_obs_problems(name, fleet_dir)
    ok = (
        killed and fleetstats_survived and not lost and not duplicated
        and completed and zero_builds and recovered and bitwise
        and not trace_problems and not obs_problems
    )
    for p in trace_problems:
        print(f"[chaos-fleet] {name}: trace check: {p}", flush=True)
    print(
        f"[chaos-fleet] {name}: kill_server@q2 + --resume | "
        f"killed={killed} fleetstats_survived={fleetstats_survived} "
        f"lost={sorted(lost)} "
        f"duplicated={duplicated} "
        f"recovered={res_sum.get('recovered')} "
        f"aot_misses={(res_sum['aot'] or {}).get('misses')} "
        f"placements={res_sum.get('placements')} "
        f"bitwise({n_compared} jobs)={bitwise} "
        f"traces({len(ids)} jobs)={not trace_problems} "
        f"fleetview={not obs_problems} "
        f"{'OK' if ok else 'FAIL'}",
        flush=True,
    )
    return ok


def check_retry_storm(name, mesh, cfg, ref, requests, tmpdir) -> bool:
    """Every job POSTed 4x concurrently with the same idempotency key:
    the journaled key map must collapse the storm onto one job id and
    ONE execution per key, with FLEET.json as the proof."""
    fleet_dir = os.path.join(tmpdir, name)
    router = make_router(
        mesh, cfg, fleet_dir, bank_dir(tmpdir),
    )
    gateway = TallyGateway(router)
    per_key: dict = {}
    errors = []
    try:
        def post(r, attempt):
            body = json.dumps(dict(
                request_to_json(r),
                idempotency_key=f"key-{r.job_id}",
            )).encode()
            try:
                with urllib.request.urlopen(
                    urllib.request.Request(
                        f"{gateway.url}/submit", data=body,
                        method="POST",
                    ),
                    timeout=60,
                ) as resp:
                    jid = json.loads(resp.read())["job"]
                per_key.setdefault(f"key-{r.job_id}", set()).add(jid)
            except Exception as e:  # noqa: BLE001 - collected, asserted
                errors.append(f"{r.job_id}/{attempt}: {e}")

        threads = [
            threading.Thread(target=post, args=(r, a))
            for r in requests for a in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        router.run()
        one_id_per_key = all(
            len(ids) == 1 for ids in per_key.values()
        )
        jobs = {j.id: j for j in router.jobs()}
        # One EXECUTION per key: exactly n_jobs jobs exist anywhere,
        # the router dispatched exactly n_jobs placements total, and
        # no job appears in more than one member's journal.  (A move
        # count is NOT an invariant here — a job whose lanes all die
        # finishes early by design.)
        owned = [
            member_journal_ids(fleet_dir, m.index)
            for m in router.members
        ]
        one_execution = (
            len(jobs) == len(requests)
            and sum(m.placed for m in router.members)
            == len(requests)
            and sorted(i for o in owned for i in o) == sorted(jobs)
        )
        bitwise = all(
            np.asarray(router.result(i)).tobytes()
            == ref[i].tobytes()
            for i in jobs
        )
        with open(os.path.join(fleet_dir, "FLEET.json")) as fh:
            journaled = json.load(fh)["accepted"]
        journal_proof = journaled == {
            k: next(iter(v)) for k, v in per_key.items()
        }
    finally:
        gateway.stop()
        router.close()
    obs_problems = fleet_obs_problems(name, fleet_dir)
    ok = (
        not errors and one_id_per_key and one_execution and bitwise
        and journal_proof and not obs_problems
    )
    for e in errors:
        print(f"[chaos-fleet] {name}: POST error: {e}", flush=True)
    print(
        f"[chaos-fleet] {name}: {4 * len(requests)} concurrent POSTs "
        f"over {len(requests)} keys | "
        f"one_id_per_key={one_id_per_key} "
        f"one_execution={one_execution} bitwise={bitwise} "
        f"journal_proof={journal_proof} "
        f"fleetview={not obs_problems} "
        f"{'OK' if ok else 'FAIL'}",
        flush=True,
    )
    return ok


def _lost_and_duplicated(router, ids):
    """The zero-lost / zero-duplicated contract over alive members."""
    jobs = {j.id: j for j in router.jobs()}
    lost = set(ids) - set(jobs)
    duplicated = [
        i for i in ids
        if sum(
            1 for m in router.members if m.alive
            and any(j.id == i for j in m.scheduler.jobs())
        ) > 1
    ]
    return jobs, lost, duplicated


def _bitwise(router, ref, ids):
    """(all-bitwise?, n_compared) — every job completed with a flux
    byte-identical to the fault-free reference."""
    n = 0
    for i in ids:
        job = router.job(i)
        if job.outcome != "completed":
            return False, n
        if np.asarray(router.result(i)).tobytes() != ref[i].tobytes():
            return False, n
        n += 1
    return True, n


def evicted_link_jobs(fleet_dir: str) -> set:
    """Job ids with an ``evicted`` trace link in the fleet's span
    stream (the supervisor's cross-member hop marker)."""
    return {
        r.get("job_id")
        for r in load_trace_records(fleet_dir)
        if r.get("name") == "evicted"
    }


def check_wedged_member(name, mesh, cfg, ref, requests, tmpdir) -> bool:
    """Member 0 wedges silently — it answers no heartbeat but holds
    its jobs, and NOTHING sends a kill.  The supervisor must detect
    via missed probes alone, journal the eviction
    (eviction-record-before-drain), re-place every journaled job with
    ``evicted`` trace links, and drain the fleet bitwise."""
    fleet_dir = os.path.join(tmpdir, name)
    router = make_router(
        mesh, cfg, fleet_dir, bank_dir(tmpdir),
    )
    try:
        ids = submit_all(router, requests)
        victim = 0
        victim_jobs = {i for i in ids if router.member_of(i) == victim}
        router.members[victim].scheduler.faults = ChaosInjector(
            ChaosPlan(wedge_member=victim)
        )
        supervisor = FleetSupervisor(
            router, heartbeat_misses=2, grace_ticks=1,
        )
        supervisor.run()
        jobs, lost, duplicated = _lost_and_duplicated(router, ids)
        evicted = (
            not router.members[victim].alive
            and router.members[victim].health == "evicted"
        )
        with open(os.path.join(fleet_dir, "FLEET.json")) as fh:
            journaled = json.load(fh).get("evicted")
        journal_proof = journaled == {str(victim): {"cause": "wedged"}}
        counted = supervisor._evictions_total.value(cause="wedged") == 1
        links_ok = victim_jobs <= evicted_link_jobs(fleet_dir)
        bitwise, n_compared = _bitwise(router, ref, ids)
    finally:
        router.close()
    trace_problems = fleet_trace_problems(fleet_dir, ids)
    obs_problems = fleet_obs_problems(name, fleet_dir)
    ok = (
        len(victim_jobs) > 0 and evicted and not lost
        and not duplicated and journal_proof and counted and links_ok
        and bitwise and not trace_problems and not obs_problems
    )
    for p in trace_problems:
        print(f"[chaos-fleet] {name}: trace check: {p}", flush=True)
    print(
        f"[chaos-fleet] {name}: wedge member{victim}, no kill signal | "
        f"evicted={evicted} lost={sorted(lost)} "
        f"duplicated={duplicated} journal_proof={journal_proof} "
        f"evicted_links({len(victim_jobs)} jobs)={links_ok} "
        f"bitwise({n_compared} jobs)={bitwise} "
        f"traces({len(ids)} jobs)={not trace_problems} "
        f"fleetview={not obs_problems} "
        f"{'OK' if ok else 'FAIL'}",
        flush=True,
    )
    return ok


def check_brownout(name, mesh, cfg, tmpdir) -> bool:
    """Member 0 runs 100x slow under ``slow_member`` injection, and
    the conviction comes from the OBSERVABILITY PLANE, not the latency
    probe: a chaos-tightened e2e latency SLO (threshold = one
    histogram bucket above everything the fault-free reference run
    observed) burns hot in both windows, the burn-rate alert
    attributes the victim, and the supervisor quarantines it CITING
    the SLO signal — FLEET.json journals the breach BEFORE the
    quarantine takes effect (breach-record-before-quarantine).  It
    must NOT evict; once the injected latency clears and the burn
    windows slide past the bad observations, the alert drops and the
    restore hysteresis lifts the quarantine — the victim's jobs never
    leave it and finish bitwise vs a fault-free run of the SAME
    workload (false-positive resistance).  Runs at ``quantum_moves=1``
    (reference included, so the chunking matches bitwise) — jobs then
    span enough quanta for the slowdown to dominate their e2e.

    The kernels are built and loaded BEFORE the reference run: otherwise
    the reference e2e holds the one-time build (tens of seconds on the
    card), the derived threshold lands in the top bucket, and the warm
    fault run (milliseconds a quantum) can never breach it."""
    requests = synthetic_requests(
        mesh, 6, class_sizes=CLASSES, n_moves=N_MOVES, seed=SEED + 1,
    )
    warm_router = make_router(
        mesh, cfg, os.path.join(tmpdir, f"{name}-warm"),
        bank_dir(tmpdir), quantum_moves=1,
    )
    try:
        submit_all(warm_router, synthetic_requests(
            mesh, len(CLASSES), class_sizes=CLASSES, n_moves=1,
            seed=SEED + 2,
        ))
        warm_router.run()
    finally:
        warm_router.close()
    ref_router = make_router(
        mesh, cfg, os.path.join(tmpdir, f"{name}-ref"),
        bank_dir(tmpdir), quantum_moves=1,
    )
    try:
        ids = submit_all(ref_router, requests)
        ref_router.run()
        ref = {i: np.asarray(ref_router.result(i)) for i in ids}
        # The reference e2e ceiling: the smallest bucket bound covering
        # EVERY fault-free observation, plus one bucket of slack for
        # scheduling noise — 100x-slowed jobs land far above it.
        worst = 0.0
        for m in ref_router.members:
            fam = m.registry.snapshot().get("pumi_job_e2e_seconds")
            for entry in (fam or {}).get("series", []):
                v = entry["value"]
                for ub in sorted(v["buckets"], key=float):
                    if v["buckets"][ub] >= v["count"]:
                        worst = max(worst, float(ub))
                        break
    finally:
        ref_router.close()
    above = [b for b in DEFAULT_BUCKETS if b > worst]
    threshold = above[0] if above else worst
    slo = SLO(
        name="chaos-e2e", kind="latency",
        metric="pumi_job_e2e_seconds", threshold_s=threshold,
        objective=0.9, windows=((1.0, 4.0),),
    )
    fleet_dir = os.path.join(tmpdir, name)
    router = make_router(
        mesh, cfg, fleet_dir, bank_dir(tmpdir),
        quantum_moves=1, slos=(slo,),
    )
    try:
        ids = submit_all(router, requests)
        victim = 0
        router.members[victim].scheduler.faults = ChaosInjector(
            ChaosPlan(slow_member=victim, slow_factor=100.0)
        )
        # The probe-side slow_factor is pushed out of reach: only the
        # SLO advisory may convict here.
        supervisor = FleetSupervisor(
            router, slow_factor=1000.0, window=2, heartbeat_misses=2,
            grace_ticks=100000, restore_ticks=1,
        )
        quarantined_seen = False
        quarantine_health = None
        for _ in range(100000):
            pending = router.step()
            supervisor.tick()
            if router.members[victim].quarantined and not quarantined_seen:
                quarantined_seen = True
                quarantine_health = router.members[victim].health
                # The brownout clears: whatever throttled the member
                # (thermal, a noisy neighbor) goes away mid-grace.
                router.members[victim].scheduler.faults = ChaosInjector(
                    ChaosPlan()
                )
            if not pending and all(j.terminal for j in router.jobs()):
                break
        # Settle: keep evaluating until the burn windows slide past
        # the bad observations, the alert clears, and the restore
        # hysteresis lifts the quarantine.
        deadline = time.monotonic() + 30.0
        while (
            (router.members[victim].quarantined
             or router.members[victim].health != "healthy")
            and time.monotonic() < deadline
        ):
            router.step()
            supervisor.tick()
            time.sleep(0.05)
        slo_convicted = quarantine_health == "slo-burn"
        never_evicted = all(m.alive for m in router.members)
        restored = (
            not router.members[victim].quarantined
            and router.members[victim].health == "healthy"
        )
        migrations = router.stats()["migrations"]
        jobs, lost, duplicated = _lost_and_duplicated(router, ids)
        bitwise, n_compared = _bitwise(router, ref, ids)
    finally:
        router.close()
    with open(os.path.join(fleet_dir, "FLEET.json")) as fh:
        journaled = json.load(fh).get("breaches") or {}
    breach_cited = any(
        b.get("slo") == "chaos-e2e"
        for b in journaled.get(str(victim), [])
    )
    trace_problems = fleet_trace_problems(fleet_dir, ids)
    obs_problems = fleet_obs_problems(name, fleet_dir)
    ok = (
        quarantined_seen and slo_convicted and breach_cited
        and never_evicted and restored
        and migrations == 0 and not lost and not duplicated
        and bitwise and not trace_problems and not obs_problems
    )
    for p in trace_problems:
        print(f"[chaos-fleet] {name}: trace check: {p}", flush=True)
    print(
        f"[chaos-fleet] {name}: member{victim} 100x slow, SLO "
        f"chaos-e2e<= {threshold:g}s | quarantined={quarantined_seen} "
        f"slo_convicted={slo_convicted} breach_cited={breach_cited} "
        f"never_evicted={never_evicted} restored={restored} "
        f"migrations={migrations} lost={sorted(lost)} "
        f"duplicated={duplicated} "
        f"bitwise({n_compared} jobs)={bitwise} "
        f"traces({len(ids)} jobs)={not trace_problems} "
        f"fleetview={not obs_problems} "
        f"{'OK' if ok else 'FAIL'}",
        flush=True,
    )
    return ok


def check_disk_pressure(name, mesh, cfg, ref, requests, tmpdir) -> bool:
    """Member 0's disk fills on its FIRST durable write after
    submission: the journal degrades instead of crashing, residents
    park at the quantum boundary, and the supervisor drains the member
    cooperatively — zero lost, zero duplicated, every flux bitwise
    (jobs without a durable checkpoint replay from move 0, which is
    bitwise by the RNG's move-counter keying)."""
    fleet_dir = os.path.join(tmpdir, name)
    router = make_router(
        mesh, cfg, fleet_dir, bank_dir(tmpdir),
    )
    try:
        ids = submit_all(router, requests)
        victim = 0
        router.members[victim].scheduler.faults = ChaosInjector(
            ChaosPlan(disk_full_at=1)
        )
        supervisor = FleetSupervisor(
            router, heartbeat_misses=2, grace_ticks=1,
        )
        supervisor.run()
        # The degraded gauge lives on the VICTIM's registry now (one
        # registry per member) — it outlives the eviction, so the
        # postmortem read still works.
        degraded = (
            router.members[victim].registry
            .gauge("pumi_journal_degraded")
            .value(member=f"m{victim}") == 1.0
        )
        drained = (
            not router.members[victim].alive
            and router.members[victim].health == "evicted"
        )
        with open(os.path.join(fleet_dir, "FLEET.json")) as fh:
            journaled = json.load(fh).get("evicted")
        journal_proof = journaled == {
            str(victim): {"cause": "disk-pressured"}
        }
        jobs, lost, duplicated = _lost_and_duplicated(router, ids)
        bitwise, n_compared = _bitwise(router, ref, ids)
    finally:
        router.close()
    trace_problems = fleet_trace_problems(fleet_dir, ids)
    obs_problems = fleet_obs_problems(name, fleet_dir)
    ok = (
        degraded and drained and journal_proof and not lost
        and not duplicated and bitwise and not trace_problems
        and not obs_problems
    )
    for p in trace_problems:
        print(f"[chaos-fleet] {name}: trace check: {p}", flush=True)
    print(
        f"[chaos-fleet] {name}: disk_full@write1 on member{victim} | "
        f"degraded={degraded} drained={drained} "
        f"journal_proof={journal_proof} lost={sorted(lost)} "
        f"duplicated={duplicated} "
        f"bitwise({n_compared} jobs)={bitwise} "
        f"traces({len(ids)} jobs)={not trace_problems} "
        f"fleetview={not obs_problems} "
        f"{'OK' if ok else 'FAIL'}",
        flush=True,
    )
    return ok


SCENARIOS = (
    "member_kill", "router_kill", "retry_storm",
    "wedged_member", "brownout", "disk_pressure",
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pumiumtally_tpu_torch.chaos.fleet",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--only", default=None, metavar="NAMES",
                    help="one scenario or a comma-separated list")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--bank", default=None, metavar="DIR",
                    help="library bank shared by every router (default: "
                         "a fresh one; a warm bank builds nothing)")
    return ap.parse_args(argv)


def run_scenario(name, mesh, cfg, ref, requests, tmpdir, n_jobs) -> bool:
    if name == "member_kill":
        return check_member_kill(name, mesh, cfg, ref, requests, tmpdir)
    if name == "router_kill":
        return check_router_kill(name, ref, tmpdir, n_jobs, cfg,
                                 mesh.device)
    if name == "retry_storm":
        return check_retry_storm(name, mesh, cfg, ref, requests, tmpdir)
    if name == "wedged_member":
        return check_wedged_member(name, mesh, cfg, ref, requests, tmpdir)
    if name == "brownout":
        return check_brownout(name, mesh, cfg, tmpdir)
    return check_disk_pressure(name, mesh, cfg, ref, requests, tmpdir)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.list:
        for name in SCENARIOS:
            print(name)
        return 0
    names = ([n for n in args.only.split(",") if n] if args.only
             else list(SCENARIOS))
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        print(f"[chaos-fleet] unknown scenario(s) {unknown}", file=sys.stderr)
        return 2
    global BANK_DIR
    BANK_DIR = args.bank
    device = resolve_device(args.device)
    # The in-process scenarios drive faults explicitly: no fault spec or
    # scrape port from the environment, and the observability plane on
    # (the scenarios assert over it).
    for var in ("PUMI_TPU_FAULTS", "PUMI_TPU_PROM_PORT", "PUMI_TPU_FLEET_OBS"):
        os.environ.pop(var, None)
    mesh, cfg = build(device)
    requests = synthetic_requests(
        mesh, args.jobs, class_sizes=CLASSES, n_moves=N_MOVES, seed=SEED,
    )
    fails = 0
    with tempfile.TemporaryDirectory(prefix="chaos_fleet_") as tmpdir:
        t0 = time.perf_counter()
        ref = reference_results(mesh, cfg, tmpdir, requests)
        print(f"[chaos-fleet] reference: {time.perf_counter() - t0:.2f} s "
              f"on {device}", flush=True)
        for name in names:
            t0 = time.perf_counter()
            ok = run_scenario(name, mesh, cfg, ref, requests, tmpdir,
                              args.jobs)
            print(f"[chaos-fleet] {name}: {time.perf_counter() - t0:.2f} s "
                  f"on {device} {'OK' if ok else 'FAIL'}", flush=True)
            fails += 0 if ok else 1
    print("FLEET CHAOS CAMPAIGN",
          "PASS" if fails == 0 else f"{fails} FAILURES")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
