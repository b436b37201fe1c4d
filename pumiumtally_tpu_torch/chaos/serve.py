"""Serving chaos campaign: fault-isolated multi-tenant scheduling under
fire, each scenario with a DECLARED outcome.

Counterpart of the JAX package's ``scripts/chaos_serve.py``. Every
scenario drives a mixed-class job workload (a 2^3 box, jobs of 40 and 100
particles, 8 moves in quanta of 4) through the ``TallyScheduler``
(``serving/scheduler.py``) with a composed per-job fault schedule
(``resilience/faultinject.py``: poison_job, transient_quantum,
kill_server_at_quantum) and asserts the serving contracts:

  * **isolation**: a poison job finishes ``outcome="poisoned"`` and every
    other job's flux is bitwise the fault-free reference's;
  * **bitwise replay**: a transient quantum is absorbed by the bounded
    per-job retry, flux bitwise the fault-free reference's;
  * **crash-safe recovery**: a server killed mid-run (a subprocess of
    ``python -m pumiumtally_tpu_torch.serving --journal``) and restarted
    with ``--resume`` loses no job: every job reaches a terminal outcome,
    unaffected fluxes are bitwise the fault-free run's, and the restarted
    process builds nothing (the library bank is warm: its summary's
    ``aot.misses == 0``);
  * **postmortem trace**: every scenario leaves a readable black-box dump,
    and in kill_restart every job, the poisoned one included, passes
    ``obs/trace.py``'s ``check_job_trace`` against the journal directory:
    one causally ordered trace over both process lifetimes. The
    reference process serves with ``PUMI_TPU_TRACE=off``, so its bitwise
    comparison is the tracing-on-against-off parity gate too.

Scenarios (all by default; ``--only NAME`` picks one, ``--list`` names
them): poison_isolation, transient_replay, storm, kill_restart.

    python -m pumiumtally_tpu_torch.chaos.serve [--jobs N] [--only NAME]
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
import time

import numpy as np

from ..obs.trace import check_job_trace, job_trace, load_trace_records
from ..resilience.faultinject import ChaosInjector, ChaosPlan
from ..utils.platform import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = 2
CLASSES = (40, 100)
N_MOVES = 8     # a multiple of QUANTUM: resumed chunks run the same
QUANTUM = 4     # quanta as the uninterrupted run
SEED = 3
SUBPROCESS_TIMEOUT_S = 900


def build(device):
    from ..mesh.box import build_box
    from ..utils.config import TallyConfig

    mesh = build_box(1.0, 1.0, 1.0, CELLS, CELLS, CELLS, device=device)
    return mesh, TallyConfig(tolerance=1e-6)


def fleet(mesh, cfg, n_jobs, **kw) -> dict:
    from ..serving import run_saturation

    return run_saturation(
        mesh, cfg, n_jobs=n_jobs, class_sizes=CLASSES, n_moves=N_MOVES,
        seed=SEED, max_resident=2, quantum_moves=QUANTUM,
        device=mesh.device, **kw,
    )


def readable_postmortems(dirpath: str) -> list[str]:
    """Names of the readable black-box dumps in ``dirpath`` (valid JSON,
    ``kind == "blackbox"``, a ``records`` list)."""
    found = []
    if not os.path.isdir(dirpath):
        return found
    for fname in sorted(os.listdir(dirpath)):
        if not fname.endswith(".blackbox.json"):
            continue
        try:
            with open(os.path.join(dirpath, fname)) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            continue
        if doc.get("kind") == "blackbox" and isinstance(
                doc.get("records"), list):
            found.append(fname)
    return found


def check_in_process(name, mesh, cfg, ref, plan, n_jobs, poisoned: set,
                     workdir: str) -> bool:
    """One in-process scenario: the workload under the chaos plan; the
    poisoned set exact, the survivors bitwise the reference, a readable
    black-box postmortem in ``workdir``."""
    t0 = time.perf_counter()
    out = fleet(mesh, cfg, n_jobs, faults=ChaosInjector(plan),
                job_retries=2, blackbox_dir=workdir)
    rows = {r["job"]: r for r in out["per_job"]}
    got_poisoned = {j for j, r in rows.items() if r["outcome"] == "poisoned"}
    want_poisoned = {f"sat-{i:04d}" for i in poisoned}
    survivors_bitwise = True
    for jid, r in rows.items():
        if jid in want_poisoned:
            continue
        if (r["outcome"] != "completed" or jid not in ref["results"]
                or out["results"][jid].tobytes()
                != ref["results"][jid].tobytes()):
            survivors_bitwise = False
            break
    ok = got_poisoned == want_poisoned and survivors_bitwise
    retries = out["scheduler"]["retries"]
    if plan.transient_quantum is not None:
        ok = ok and retries >= 1
    # Every scenario leaves a readable postmortem: a poisoned job dumps
    # its span ring, and close() always dumps the shutdown black box.
    dumps = readable_postmortems(workdir)
    ok = ok and len(dumps) >= 1
    if want_poisoned:
        ok = ok and any(f.startswith(tuple(want_poisoned)) for f in dumps)
    print(
        f"[chaos-serve] {name}: {plan.describe()} | "
        f"poisoned={sorted(got_poisoned)} retries={retries} "
        f"survivors_bitwise={survivors_bitwise} postmortems={dumps} "
        f"{time.perf_counter() - t0:.2f} s on {mesh.device} "
        f"{'OK' if ok else 'FAIL'}",
        flush=True,
    )
    return ok


def serve_cmd(journal, bank, n_jobs, cfg, device, resume=False) -> list:
    cmd = [
        sys.executable, "-m", "pumiumtally_tpu_torch.serving",
        "--demo", str(n_jobs), "--device", device.type,
        "--cells", str(CELLS), "--groups", str(cfg.n_groups),
        "--dtype", str(cfg.dtype).replace("torch.", ""),
        "--classes", ",".join(map(str, CLASSES)),
        "--moves", str(N_MOVES), "--quantum", str(QUANTUM),
        "--max-resident", "2", "--retries", "2",
        "--seed", str(SEED), "--bank", bank, "--journal", journal,
    ]
    if resume:
        cmd.append("--resume")
    return cmd


def run_serve(journal, bank, n_jobs, cfg, device, faults="", resume=False,
              trace=None):
    """One server process; (CompletedProcess, its summary line or None)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PUMI_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    if faults:
        env["PUMI_TPU_FAULTS"] = faults
    if trace is not None:
        # The reference run serves with tracing off so its flux
        # comparison doubles as the tracing-on/off bitwise gate.
        env["PUMI_TPU_TRACE"] = trace
    proc = subprocess.run(
        serve_cmd(journal, bank, n_jobs, cfg, device, resume=resume),
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


def check_kill_restart(name, tmpdir, n_jobs, cfg, device) -> bool:
    """A fault storm (poison + transient) plus a mid-run server kill, then
    a ``--resume`` restart over the same journal and warm bank: no job
    lost, unaffected fluxes bitwise, nothing built in the restart."""
    t0 = time.perf_counter()
    bank = os.path.join(tmpdir, "bank")
    ref_j = os.path.join(tmpdir, "ref-journal")
    j = os.path.join(tmpdir, "journal")
    # The fault-free reference fills the bank and keeps each job's flux
    # beside its journal; tracing is off in it.
    ref_proc, _ = run_serve(ref_j, bank, n_jobs, cfg, device, trace="off")
    if ref_proc.returncode != 0:
        print(f"[chaos-serve] {name}: reference run failed "
              f"rc={ref_proc.returncode}\n{ref_proc.stderr[-2000:]}")
        return False
    # The storm: poison job 1, one transient on job 2, the server killed
    # before its 4th quantum.
    storm = "poison_job:1,transient_quantum:2,kill_server_at_quantum:4"
    kill_proc, _ = run_serve(j, bank, n_jobs, cfg, device, faults=storm)
    killed = kill_proc.returncode != 0
    # The restart: the poison clause stays (the job is poison because of
    # what it is), the kill clause does not (the hardware recovered).
    res_proc, res_sum = run_serve(j, bank, n_jobs, cfg, device,
                                  faults="poison_job:1", resume=True)
    if res_proc.returncode != 3 or res_sum is None:
        print(f"[chaos-serve] {name}: restart rc={res_proc.returncode} "
              f"(want 3)\n{res_proc.stderr[-2000:]}")
        return False
    with open(os.path.join(j, "JOBS.json")) as fh:
        jobs = json.load(fh)["jobs"]
    poisoned = {i for i, e in jobs.items() if e["outcome"] == "poisoned"}
    terminal = all(e["state"] == "done" for e in jobs.values())
    zero_builds = (res_sum["aot"] or {}).get("misses", -1) == 0
    recovered = res_sum.get("recovered", 0) > 0
    bitwise = True
    n_compared = 0
    for jid, e in jobs.items():
        if jid in poisoned:
            continue
        if e["outcome"] != "completed":
            bitwise = False
            break
        got = np.load(os.path.join(j, f"{jid}.flux.npy"))
        want = np.load(os.path.join(ref_j, f"{jid}.flux.npy"))
        if got.tobytes() != want.tobytes():
            bitwise = False
            break
        n_compared += 1
    # From the journal directory alone (TRACE.jsonl and the black-box
    # dumps) every job is one causally ordered trace over both lifetimes.
    dumps = readable_postmortems(j)
    records = load_trace_records(j)
    trace_problems = [f"{jid}: {p}" for jid in jobs
                      for p in check_job_trace(job_trace(records, jid), jid)]
    traced = not trace_problems
    ok = (killed and terminal and zero_builds and recovered and bitwise
          and poisoned == {"sat-0001"} and len(jobs) == n_jobs and traced
          and len(dumps) >= 1)
    for p in trace_problems:
        print(f"[chaos-serve] {name}: trace check: {p}", flush=True)
    print(
        f"[chaos-serve] {name}: {storm} | killed={killed} "
        f"jobs={len(jobs)} poisoned={sorted(poisoned)} "
        f"recovered={res_sum.get('recovered')} "
        f"aot_misses={(res_sum['aot'] or {}).get('misses')} "
        f"bitwise({n_compared} survivors)={bitwise} "
        f"traces({len(jobs)} jobs)={traced} postmortems={dumps} "
        f"{time.perf_counter() - t0:.2f} s on {device} "
        f"{'OK' if ok else 'FAIL'}",
        flush=True,
    )
    return ok


SCENARIOS = {
    "poison_isolation": (ChaosPlan(poison_job=1), {1}),
    "transient_replay": (ChaosPlan(transient_quantum=0), set()),
    "storm": (ChaosPlan(poison_job=2, transient_quantum=0), {2}),
    "kill_restart": None,  # subprocess scenario
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pumiumtally_tpu_torch.chaos.serve",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--only", default=None, metavar="NAME")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.list:
        for name in SCENARIOS:
            print(name)
        return 0
    names = [args.only] if args.only else list(SCENARIOS)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        print(f"[chaos-serve] unknown scenario(s) {unknown}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    # The in-process scenarios drive their faults explicitly.
    os.environ.pop("PUMI_TPU_FAULTS", None)
    mesh, cfg = build(device)
    ref = None
    fails = 0
    with tempfile.TemporaryDirectory(prefix="chaos_serve_") as tmpdir:
        for name in names:
            if SCENARIOS[name] is None:
                ok = check_kill_restart(name, tmpdir, args.jobs, cfg, device)
            else:
                if ref is None:
                    ref = fleet(mesh, cfg, args.jobs)
                plan, poisoned = SCENARIOS[name]
                workdir = os.path.join(tmpdir, name)
                os.makedirs(workdir, exist_ok=True)
                ok = check_in_process(name, mesh, cfg, ref, plan, args.jobs,
                                      poisoned, workdir)
            fails += 0 if ok else 1
    print("SERVING CHAOS CAMPAIGN",
          "PASS" if fails == 0 else f"{fails} FAILURES")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
