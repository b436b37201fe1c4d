"""Render (and check) the serving fleet's observability picture.

The port's copy of ``scripts/fleetview.py``. A ``FleetRouter`` leaves two
sources:

  * live: the router exporter's ``/fleetz`` (merged Prometheus text),
    ``/fleet`` (routing and liveness JSON) and ``/jobs?limit=`` (the job
    table across members);
  * on disk: ``<fleet_dir>/FLEETSTATS.json`` (the snapshot {schema,
    fleet, slo, profile, metrics, router_metrics} that outlives the
    router), ``FLEET.json`` (the routing journal with the supervisor's
    journaled SLO ``breaches``) and the members' ``member-*/JOBS.json``.

``fleetview`` renders either as one page: the member table, each SLO's
burn rates and alert, the recent burn timeline and the top jobs by
device time. ``--check`` validates instead that the whole picture can be
rebuilt from the source: FLEETSTATS.json parses at its schema with every
section well formed (counters finite and non-negative, histograms with
count, sum and buckets, both metric snapshots rendering back to
Prometheus text), burns are numbers over sane objectives, every
journaled breach names a declared SLO and a real member, and the
profiler reports a known mode. Exit 0 when every source checks out.

Usage::

    python -m pumiumtally_tpu_torch.obs.fleetview <fleet_dir> [...]
    python -m pumiumtally_tpu_torch.obs.fleetview http://127.0.0.1:9200
    python -m pumiumtally_tpu_torch.obs.fleetview <fleet_dir> --check
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

from .aggregate import (
    FLEETSTATS_FILE,
    FLEETSTATS_SCHEMA,
    render_snapshot_prometheus,
)
from .profile import PROFILE_MODES

_METRIC_TYPES = ("counter", "gauge", "histogram")
#: One exposition sample line: name, optional {labels}, one value.
_SAMPLE_LINE = re.compile(
    r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+"
)


# --------------------------------------------------------------------- #
# Sources
# --------------------------------------------------------------------- #
def load_dir(fleet_dir: str) -> dict:
    """The on-disk surface: FLEETSTATS.json + FLEET.json + every
    member journal's job rows (missing files stay None/empty — the
    checker names them, the renderer degrades)."""
    out = {"source": fleet_dir, "fleetstats": None, "fleet": None,
           "jobs": [], "fleetz": None}
    stats = os.path.join(fleet_dir, FLEETSTATS_FILE)
    if os.path.exists(stats):
        with open(stats) as fh:
            out["fleetstats"] = json.load(fh)
    routing = os.path.join(fleet_dir, "FLEET.json")
    if os.path.exists(routing):
        with open(routing) as fh:
            out["fleet"] = json.load(fh)
    for name in sorted(os.listdir(fleet_dir)):
        path = os.path.join(fleet_dir, name, "JOBS.json")
        if not name.startswith("member-") or not os.path.exists(path):
            continue
        with open(path) as fh:
            doc = json.load(fh)
        member = int(name.split("-")[1])
        for entry in doc.get("jobs", {}).values():
            out["jobs"].append(dict(entry, member=member))
    if out["fleetstats"] is not None:
        try:
            out["fleetz"] = render_snapshot_prometheus(
                out["fleetstats"].get("metrics") or {}
            )
        except Exception:  # noqa: BLE001 - the checker reports it
            pass
    return out


def load_url(base: str) -> dict:
    """The live surface: one exporter base URL."""
    from urllib.request import urlopen

    base = base.rstrip("/")

    def get(path):
        with urlopen(f"{base}{path}", timeout=10) as resp:
            return resp.read().decode()

    fleet = json.loads(get("/fleet"))
    jobs_doc = json.loads(get("/jobs?limit=500"))
    jobs = [dict(r) for r in jobs_doc.get("jobs", [])]
    try:
        fleetz = get("/fleetz")
    except Exception:  # noqa: BLE001 - plane off: renderer degrades
        fleetz = None
    return {"source": base, "fleetstats": None, "fleet": None,
            "live_fleet": fleet, "jobs": jobs, "fleetz": fleetz}


# --------------------------------------------------------------------- #
# --check
# --------------------------------------------------------------------- #
def _check_snapshot(snap, where: str) -> list[str]:
    """Well-formedness of one registry-snapshot-shaped dict."""
    problems = []
    if not isinstance(snap, dict):
        return [f"{where}: not a mapping"]
    for name, fam in snap.items():
        if fam.get("type") not in _METRIC_TYPES:
            problems.append(
                f"{where}: {name}: bad type {fam.get('type')!r}"
            )
            continue
        if not isinstance(fam.get("help"), str):
            problems.append(f"{where}: {name}: missing help")
        for entry in fam.get("series", []):
            v = entry.get("value")
            if fam["type"] == "histogram":
                if not (isinstance(v, dict) and "count" in v
                        and "sum" in v and "buckets" in v):
                    problems.append(
                        f"{where}: {name}: malformed histogram series"
                    )
            elif not isinstance(v, (int, float)) or v != v:
                problems.append(
                    f"{where}: {name}: non-numeric value {v!r}"
                )
            elif fam["type"] == "counter" and v < 0:
                problems.append(
                    f"{where}: {name}: negative counter {v}"
                )
    try:
        render_snapshot_prometheus(snap)
    except Exception as e:  # noqa: BLE001 - the whole point of --check
        problems.append(f"{where}: does not render: {e}")
    return problems


def check_prom_text(text: str, where: str) -> list[str]:
    """Minimal exposition-format validation: every sample line parses
    and belongs to a family a # TYPE line declared."""
    problems = []
    typed: set[str] = set()
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            typed.add(line.split()[2])
            continue
        if line.startswith("#"):
            continue
        if not _SAMPLE_LINE.fullmatch(line):
            problems.append(f"{where}:{i}: unparseable sample {line!r}")
            continue
        name = line.split("{")[0].split(" ")[0]
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in typed and base not in typed:
            problems.append(f"{where}:{i}: sample {name} has no # TYPE")
    return problems


def check_fleetstats(view: dict) -> list[str]:
    """The reconstructibility check of one on-disk source (module
    docstring); an empty list means the picture is complete."""
    src = view["source"]
    doc = view["fleetstats"]
    if doc is None:
        return [f"{src}: no {FLEETSTATS_FILE}"]
    problems = []
    if doc.get("schema") != FLEETSTATS_SCHEMA:
        problems.append(
            f"{src}: schema {doc.get('schema')!r} != {FLEETSTATS_SCHEMA}"
        )
    for section in ("fleet", "slo", "profile", "metrics",
                    "router_metrics"):
        if not isinstance(doc.get(section), dict):
            problems.append(f"{src}: missing section {section!r}")
    if problems:
        return problems
    members = doc["fleet"].get("members", [])
    if not members:
        problems.append(f"{src}: fleet section lists no members")
    for m in members:
        if not isinstance(m.get("health"), str):
            problems.append(f"{src}: member {m.get('member')}: no health")
    declared = set()
    for slo in doc["slo"].get("slos", []):
        declared.add(slo.get("name"))
        obj = slo.get("objective")
        if not (isinstance(obj, (int, float)) and 0 < obj < 1):
            problems.append(
                f"{src}: slo {slo.get('name')}: objective {obj!r}"
            )
        for w in slo.get("windows", []):
            burn = w.get("burn")
            if not isinstance(burn, (int, float)) or burn < 0:
                problems.append(
                    f"{src}: slo {slo.get('name')}: burn {burn!r}"
                )
    if doc["profile"].get("mode") not in PROFILE_MODES:
        problems.append(
            f"{src}: profile mode {doc['profile'].get('mode')!r}"
        )
    problems += _check_snapshot(doc["metrics"], f"{src}: metrics")
    problems += _check_snapshot(
        doc["router_metrics"], f"{src}: router_metrics"
    )
    # Each journaled breach names a declared SLO and a member the fleet
    # section knows (breach-record-before-quarantine).
    indexes = {m.get("member") for m in members}
    journaled = (view["fleet"] or {}).get("breaches") or {}
    for member, breaches in journaled.items():
        if int(member) not in indexes:
            problems.append(f"{src}: breach on unknown member {member}")
        for b in breaches:
            if b.get("slo") not in declared:
                problems.append(
                    f"{src}: breach cites undeclared SLO {b.get('slo')!r}"
                )
    if view["fleetz"] is not None:
        problems += check_prom_text(view["fleetz"], f"{src}: fleetz")
    return problems


def check_live(view: dict) -> list[str]:
    problems = []
    src = view["source"]
    fleet = view.get("live_fleet") or {}
    if not fleet.get("members"):
        problems.append(f"{src}: /fleet lists no members")
    if view["fleetz"] is None:
        problems.append(f"{src}: /fleetz unavailable")
    else:
        problems += check_prom_text(view["fleetz"], f"{src}: fleetz")
    return problems


# --------------------------------------------------------------------- #
# Rendering
# --------------------------------------------------------------------- #
def _fmt_burn(burns: dict) -> str:
    return " ".join(
        f"{w}={b:.2f}" for w, b in sorted(burns.items())
    )


def render(view: dict, top: int = 10) -> None:
    print(f"== fleet: {view['source']}")
    fleet = view.get("live_fleet")
    stats = view.get("fleetstats")
    if fleet is None and stats is not None:
        fleet = stats.get("fleet")
    if fleet:
        print(f"{'member':>6} {'alive':>5} {'health':<14} "
              f"{'quar':>4} {'queue':>5} {'resident':>8} {'placed':>6}")
        for m in fleet.get("members", []):
            print(
                f"{m.get('member'):>6} "
                f"{str(bool(m.get('alive'))):>5} "
                f"{str(m.get('health')):<14} "
                f"{str(bool(m.get('quarantined'))):>4} "
                f"{m.get('queue_depth', 0):>5} "
                f"{m.get('resident', 0):>8} {m.get('placed', 0):>6}"
            )
        breaches = (view.get("fleet") or {}).get("breaches") or {}
        for member, entries in sorted(breaches.items()):
            for b in entries:
                print(f"  breach: member {member} slo={b.get('slo')} "
                      f"burn[{_fmt_burn(b.get('burn') or {})}]")
    if stats is not None:
        print("-- SLOs")
        for slo in stats["slo"].get("slos", []):
            alert = slo.get("alert")
            flag = (
                f"ALERT member={alert.get('member')}" if alert else "ok"
            )
            burns = " ".join(
                f"{w['window_s']:g}s={w['burn']:.2f}"
                for w in slo.get("windows", [])
            )
            print(f"  {slo['name']:<24} obj={slo['objective']:.2f} "
                  f"burn[{burns}] {flag}")
        timeline = stats["slo"].get("timeline", [])
        if timeline:
            print(f"-- burn timeline ({len(timeline)} samples)")
            for t in timeline[-8:]:
                marks = " ".join(
                    f"{name}:{entry['fleet'][1] - entry['fleet'][0]}bad"
                    f"/{entry['fleet'][1]}"
                    for name, entry in sorted(t.get("slos", {}).items())
                )
                print(f"  -{t.get('age_s', 0):7.1f}s  {marks}")
        prof = stats.get("profile") or {}
        print(f"-- profiling: mode={prof.get('mode')} "
              f"captures={prof.get('captures')} "
              f"capturing={prof.get('capturing')}")
    jobs = sorted(
        view.get("jobs", []),
        key=lambda j: float(j.get("device_seconds") or 0.0),
        reverse=True,
    )
    if jobs:
        print(f"-- top {min(top, len(jobs))} jobs by device time")
        for j in jobs[:top]:
            print(
                f"  {str(j.get('id')):<24} m{j.get('member')} "
                f"{j.get('state'):<8} "
                f"device={float(j.get('device_seconds') or 0):8.4f}s "
                f"moves={j.get('moves_done')}"
            )


# --------------------------------------------------------------------- #
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pumiumtally_tpu_torch.obs.fleetview",
        description="Render or check the fleet observability picture "
        "from journal dirs or a live exporter URL"
    )
    ap.add_argument(
        "sources", nargs="+",
        help="fleet journal directories and/or exporter base URLs",
    )
    ap.add_argument(
        "--check", action="store_true",
        help="validate reconstructibility instead of rendering "
        "(exit non-zero on any problem)",
    )
    ap.add_argument(
        "--top", type=int, default=10,
        help="job rows in the device-time table (default 10)",
    )
    args = ap.parse_args(argv)
    problems = []
    for source in args.sources:
        live = source.startswith(("http://", "https://"))
        view = load_url(source) if live else load_dir(source)
        if args.check:
            found = (
                check_live(view) if live else check_fleetstats(view)
            )
            for p in found:
                print(f"CHECK FAILED: {p}", file=sys.stderr)
            if not found:
                print(f"[fleetview] {source}: OK")
            problems += found
        else:
            render(view, top=args.top)
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
