"""Serve a synthetic many-job workload through one ``TallyScheduler``, or
through a ``FleetRouter`` of N members behind the HTTP gateway.

The port's counterpart of ``scripts/serve.py``::

  python -m pumiumtally_tpu_torch.serving --demo 3               # temp bank
  python -m pumiumtally_tpu_torch.serving --demo 3 --bank BANK/  # run it
                                          # twice: the second process is
                                          # the warm regime, no nvcc build
  python -m pumiumtally_tpu_torch.serving --demo 3 --prom-port 9464
  python -m pumiumtally_tpu_torch.serving --demo 3 --journal J/
  python -m pumiumtally_tpu_torch.serving --demo 3 --journal J/ --resume
  python -m pumiumtally_tpu_torch.serving --device cpu --demo 4
  python -m pumiumtally_tpu_torch.serving --demo 3 --fleet 2 --port 0 \
      --journal F/      # N member schedulers behind the gateway, the
                        # FLEET.json routing journal in F/ (--resume
                        # recovers the whole fleet and re-POSTs the jobs)

On the card (the default) it serves the main cell: the 55^3 box
(998,250 tets), 8 groups, float32, jobs of 1,048,576, 786,432 (padded to
1,048,576) and 262,144 particles in turn. With ``--device cpu`` the
defaults are the JAX script's: a 4^3 box, 2 groups, jobs of 96 and 192.
``--cells``, ``--groups``, ``--dtype`` and ``--classes`` override either.

The full JSON goes to stdout (and ``--out``): the scheduler's and the
bank's counters, a row a job, each job's flux sha256 (``flux_sha256``) and
the seconds from the start of ``main`` (mesh build and bank included) to
the first quantum (``first_quantum_s``). One summary line follows: the
last stdout line is always one JSON object.

With ``--fleet N`` every member runs on ``--device`` (one card holds
them all), each job is POSTed to the gateway on ``--port`` with the
idempotency key ``key-<job id>``, and the summary line adds the members,
the alive ones, the placements and the migrations; without ``--journal``
the fleet directory is a temporary one.

Exit codes: 0 every job completed or converged; 3 some jobs poisoned,
rejected or cancelled (the server stayed healthy); 1 anything else.

``--bank off`` loads the package's own build of the libraries; per-job
fault injection (poison_job, transient_quantum, kill_server_at_quantum,
disk_full_at) rides ``PUMI_TPU_FAULTS``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time

#: Outcomes that leave the exit code at 0.
GOOD = ("completed", "converged")
#: Outcomes of a job that failed, was shed or was told to stop while
#: the server stayed healthy: exit 3.
ISOLATED = ("poisoned", "rejected", "cancelled")

#: Defaults by device: (cells, groups, dtype, classes).
DEFAULTS = {
    "cuda": (55, 8, "float32", "1048576,786432,262144"),
    "cpu": (4, 2, "float32", "96,192"),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pumiumtally_tpu_torch.serving",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--demo", type=int, default=8, metavar="N_JOBS",
                    help="serve N synthetic jobs and exit (default 8)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cells", type=int, default=None,
                    help="box subdivisions per axis (ntet = 6*cells^3)")
    ap.add_argument("--groups", type=int, default=None)
    ap.add_argument("--dtype", default=None, choices=("float32", "float64"))
    ap.add_argument("--bank", default=None, metavar="DIR|off",
                    help="library-bank root (default: a throwaway temp "
                         "dir; 'off' = the package's own build)")
    ap.add_argument("--classes", default=None,
                    help="comma list of request particle counts (each "
                         "pads to its own shape bucket)")
    ap.add_argument("--moves", type=int, default=8,
                    help="device-sourced moves per job")
    ap.add_argument("--quantum", type=int, default=4,
                    help="moves per scheduling quantum")
    ap.add_argument("--max-resident", type=int, default=2)
    ap.add_argument("--max-queued", type=int, default=None,
                    help="admission backpressure: submissions beyond "
                         "this queue depth finish outcome=rejected")
    ap.add_argument("--retries", type=int, default=2,
                    help="bounded per-quantum transient replays before "
                         "a job is poisoned")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-quantum dispatch watchdog deadline "
                         "(seconds); a timeout classifies as transient")
    ap.add_argument("--journal", default=None, metavar="DIR",
                    help="crash-safe JOBS.json journal directory "
                         "(enables --resume)")
    ap.add_argument("--resume", action="store_true",
                    help="recover the job table from --journal first")
    ap.add_argument("--preempt-after", type=int, default=None,
                    help="quanta before a resident job yields its slot "
                         "to queued work (checkpoint preemption)")
    ap.add_argument("--convergence", action="store_true",
                    help="convergence statistics and early eviction at "
                         "the target precision")
    ap.add_argument("--rel-err-target", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prom-port", type=int, default=None,
                    help="serve live Prometheus /metrics on this port")
    ap.add_argument("--fleet", type=int, default=None, metavar="N",
                    help="serve through a FleetRouter with N member "
                         "schedulers behind the HTTP gateway (--journal "
                         "names the fleet directory)")
    ap.add_argument("--port", type=int, default=0, metavar="P",
                    help="gateway port with --fleet (default 0: "
                         "ephemeral)")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)
    if args.resume and not args.journal:
        ap.error("--resume needs --journal DIR")
    if args.fleet is not None and args.fleet < 1:
        ap.error("--fleet needs at least one member")
    cells, groups, dtype, classes = DEFAULTS[args.device]
    args.cells = args.cells or cells
    args.groups = args.groups or groups
    args.dtype = args.dtype or dtype
    args.classes = args.classes or classes
    return args


def main(argv=None) -> int:
    t_main = time.perf_counter()
    args = parse_args(argv)
    if args.prom_port is not None:
        os.environ["PUMI_TPU_PROM_PORT"] = str(args.prom_port)

    import torch

    from .. import TallyConfig, build_box
    from .saturate import run_fleet_saturation, run_saturation

    dtype = getattr(torch, args.dtype)
    mesh = build_box(1.0, 1.0, 1.0, args.cells, args.cells, args.cells,
                     dtype=dtype, device=args.device)
    cfg = TallyConfig(
        n_groups=args.groups, dtype=dtype, tolerance=1e-6,
        convergence=args.convergence, rel_err_target=args.rel_err_target,
    )
    # The bank rides as a path: the scheduler builds it on its own
    # registry, so the pumi_aot_* counters share the job metrics'
    # endpoint.
    tmp_bank = tmp_ck = None
    if args.bank == "off":
        bank = None
    elif args.bank:
        bank = args.bank
    else:
        tmp_bank = bank = tempfile.mkdtemp(prefix="pumi_bank_")
    ck_dir = tmp_fleet = None
    if (args.preempt_after is not None and args.journal is None
            and args.fleet is None):
        tmp_ck = ck_dir = tempfile.mkdtemp(prefix="pumi_serve_ck_")
    if args.fleet is not None and args.journal is None:
        tmp_fleet = tempfile.mkdtemp(prefix="pumi_fleet_")
    classes = tuple(int(x) for x in args.classes.split(","))
    try:
        t_call = time.perf_counter()
        if args.fleet is not None:
            out = run_fleet_saturation(
                mesh, cfg, bank=bank, n_jobs=args.demo,
                fleet_dir=args.journal or tmp_fleet,
                n_members=args.fleet, port=args.port,
                class_sizes=classes, n_moves=args.moves, seed=args.seed,
                resume=args.resume,
                max_resident=args.max_resident,
                quantum_moves=args.quantum,
                preempt_after=args.preempt_after,
                max_queued=args.max_queued,
                job_retries=args.retries,
                quantum_deadline_s=args.deadline,
                device=args.device,
            )
        else:
            out = run_saturation(
                mesh, cfg, bank=bank, n_jobs=args.demo,
                class_sizes=classes, n_moves=args.moves, seed=args.seed,
                max_resident=args.max_resident,
                quantum_moves=args.quantum,
                preempt_after=args.preempt_after,
                checkpoint_dir=ck_dir,
                max_queued=args.max_queued,
                job_retries=args.retries,
                quantum_deadline_s=args.deadline,
                journal_dir=args.journal,
                resume=args.resume,
                device=args.device,
            )
    finally:
        for d in (tmp_bank, tmp_ck, tmp_fleet):
            if d is not None:
                shutil.rmtree(d, ignore_errors=True)
    # The raw flux arrays are not JSON material: their digests are.
    out["flux_sha256"] = {
        jid: hashlib.sha256(flux.tobytes()).hexdigest()
        for jid, flux in sorted(out.pop("results").items())
    }
    firsts = [r["first_quantum_s"] for r in out["per_job"]
              if r.get("first_quantum_s") is not None]
    out["first_quantum_s"] = (
        round(t_call - t_main + min(firsts), 4)
        if firsts else None)
    out["device"] = str(mesh.device)
    if mesh.device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(mesh.device)
    print(json.dumps(out, indent=1, sort_keys=True))
    if args.out:
        from ..utils.checkpoint import atomic_write_json

        atomic_write_json(args.out, out)
    outcomes: dict = {}
    for row in out["per_job"]:
        outcomes[row["outcome"]] = outcomes.get(row["outcome"], 0) + 1
    bad = [r for r in out["per_job"] if r["outcome"] not in GOOD]
    if not bad:
        rc = 0
    elif all(r["outcome"] in ISOLATED for r in bad):
        rc = 3
    else:
        rc = 1
    sched = out["fleet"] if args.fleet is not None else out["scheduler"]
    summary = {
        "outcomes": outcomes,
        "jobs": len(out["per_job"]),
        "recovered": sched.get("recovered", 0),
        "retries": sched.get("retries", 0),
        "aot": sched.get("aot"),
        "exit": rc,
    }
    if args.fleet is not None:
        for key in ("members", "alive", "placements", "migrations"):
            summary[key] = sched[key]
    print(json.dumps({"summary": summary}, sort_keys=True))
    return rc


if __name__ == "__main__":
    sys.exit(main())
