"""The delta between two PERF_CONTRACTS_TORCH.json captures, or the
autotuner's tuned-against-default table of a TUNING_TORCH.json.

  python -m pumiumtally_tpu_torch.analysis.perfdiff OLD.json NEW.json
  python -m pumiumtally_tpu_torch.analysis.perfdiff --all OLD.json NEW.json
  git show HEAD~1:PERF_CONTRACTS_TORCH.json > old.json && \\
      python -m pumiumtally_tpu_torch.analysis.perfdiff old.json \\
      PERF_CONTRACTS_TORCH.json
  python -m pumiumtally_tpu_torch.analysis.perfdiff --tuning TUNING_TORCH.json

Counterpart of the JAX package's ``scripts/perfdiff.py``. One row a
changed value: each instantiation's ptxas counts (registers, barriers,
shared memory, stack, spills, float64 SASS instructions) by source, and
each CPU family's torch-op cost at its base and top rungs and its
scaling exponents; paste the table into the description of a PR that
regenerates the capture (``--write-perf-contracts`` on the card after a
kernel edit). ``--tuning`` renders the tuner's database: per
(environment, shape class, axis) the default candidate (block 128,
megastep K = 1) against the tuned one, with the measured speedup and the
fitted calibration coefficients. Text only: it imports no torch.
"""
from __future__ import annotations

import argparse
import json
import sys


def _rows(old: dict, new: dict):
    """(section, key, metric, old, new) over every value either capture
    holds: ptxas counts by source and instantiation, then the families'
    metrics and exponents."""
    po = old.get("ptxas", {}).get("sources", {})
    pn = new.get("ptxas", {}).get("sources", {})
    for src in sorted(set(po) | set(pn)):
        io = po.get(src, {}).get("instantiations", {})
        inn = pn.get(src, {}).get("instantiations", {})
        for inst in sorted(set(io) | set(inn)):
            a, b = io.get(inst, {}), inn.get(inst, {})
            for metric in sorted(set(a) | set(b)):
                yield src, inst, metric, a.get(metric), b.get(metric)
    fo = old.get("families", {}).get("families", {})
    fn = new.get("families", {}).get("families", {})
    for fam in sorted(set(fo) | set(fn)):
        a, b = fo.get(fam, {}), fn.get(fam, {})
        for rung, prefix in (("base", ""), ("top", "top.")):
            ma = a.get(rung, {}).get("metrics", {})
            mb = b.get(rung, {}).get("metrics", {})
            for metric in sorted(set(ma) | set(mb)):
                yield ("family", fam, prefix + metric, ma.get(metric),
                       mb.get(metric))
        sa, sb = a.get("scaling", {}), b.get("scaling", {})
        for axis in sorted(set(sa) | set(sb)):
            ea, eb = sa.get(axis, {}), sb.get(axis, {})
            for metric in sorted(set(ea) | set(eb)):
                yield ("family", fam, f"scaling.{axis}.{metric}",
                       ea.get(metric), eb.get(metric))


def _fmt(v) -> str:
    if v is None:
        return "-"
    return f"{v:g}" if isinstance(v, float) else str(v)


def _pct(old, new) -> str:
    if old is None or new is None:
        return "new" if old is None else "gone"
    if old == new:
        return "0%"
    if old == 0:
        return "was 0"
    return f"{100.0 * (new - old) / abs(old):+.1f}%"


def _print_table(headers, table) -> None:
    widths = [max(len(headers[i]), *(len(r[i]) for r in table))
              for i in range(len(headers))]
    print("  ".join(h.ljust(w) for h, w in zip(headers, widths)))
    print("  ".join("-" * w for w in widths))
    for r in table:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)))


def capture_delta(old: dict, new: dict, show_all: bool = False) -> int:
    for section in ("ptxas", "families"):
        eo = old.get(section, {}).get("environment")
        en = new.get(section, {}).get("environment")
        if eo != en:
            print(f"{section} environment: {eo} -> {en} (counts compare "
                  "only within one environment)")
    rows = [r for r in _rows(old, new) if show_all or r[3] != r[4]]
    if not rows:
        print("no per-instantiation or per-family deltas")
        return 0
    _print_table(("source", "instantiation or family", "metric", "old",
                  "new", "delta"),
                 [(s, k, m, _fmt(a), _fmt(b), _pct(a, b))
                  for s, k, m, a, b in rows])
    changed = sum(1 for r in rows if r[3] != r[4])
    print(f"\n{changed} changed value(s) across "
          f"{len({(r[0], r[1]) for r in rows})} instantiation(s) or "
          "family(ies)")
    return 0


def _candidate_name(c: dict) -> str:
    return f"block={c['block']}" if c["kind"] == "kernel" else (
        f"K={c['megastep']}")


def tuning_table(path) -> int:
    """Per (environment section, shape class, axis): the default
    candidate's median seconds a move, the winner's, the speedup; then
    the candidates that failed the bitwise parity gate and each class's
    calibration."""
    with open(path) as fh:
        db = json.load(fh)
    rows, failed, cal = [], [], []
    for ekey, sec in sorted(db.get("environments", {}).items()):
        for skey, entry in sorted(sec.get("entries", {}).items()):
            cands = entry.get("candidates", [])
            for axis, default, winner in (
                    ("kernel", "block=128",
                     f"block={entry.get('block', 128)}"),
                    ("megastep", "K=1", f"K={entry.get('megastep', 1)}")):
                named = {_candidate_name(c): c for c in cands
                         if c["kind"] == axis}
                if not named:
                    continue
                d_s = named.get(default, {}).get("median_s_per_move")
                w_s = named.get(winner, {}).get("median_s_per_move")
                rows.append((ekey, skey, axis, default, _fmt(d_s), winner,
                             _fmt(w_s),
                             f"{d_s / w_s:.2f}x" if d_s and w_s else "-"))
            failed += [(ekey, skey, _candidate_name(c)) for c in cands
                       if c.get("parity") != "bitwise"]
            cal.append((ekey, skey, entry.get("calibration") or {}))
    if not rows:
        print(f"{path}: no tuning entries")
        return 0
    _print_table(("env", "shape class", "axis", "default", "default s/move",
                  "tuned", "tuned s/move", "speedup"), rows)
    modes = {k: s.get("mode", "?")
             for k, s in db.get("environments", {}).items()}
    print(f"\nsection modes: {modes} (a rehearsal section's times are the "
          "CPU's plain walk, not a card's)")
    if failed:
        print(f"{len(failed)} candidate(s) failed the bitwise parity gate "
              "(excluded from winning):")
        for ekey, skey, name in failed:
            print(f"  {ekey} {skey}: {name}")
    print("\ncalibration (fitted effective coefficients per shape class):")
    for ekey, skey, c in cal:
        f, b = c.get("flops_per_s"), c.get("bytes_per_s")
        print(f"  {ekey} {skey}: flops_per_s={f and f'{f:.3g}'} "
              f"bytes_per_s={b and f'{b:.3g}'} "
              f"rmse_s={_fmt(c.get('rmse_s'))} over {c.get('points', 0)} "
              "point(s)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pumiumtally_tpu_torch.analysis.perfdiff",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("old", nargs="?")
    ap.add_argument("new", nargs="?")
    ap.add_argument("--all", action="store_true",
                    help="print unchanged rows too")
    ap.add_argument("--tuning", metavar="TUNING_JSON",
                    help="render the tuner's tuned-against-default table")
    args = ap.parse_args(argv)
    if args.tuning:
        return tuning_table(args.tuning)
    if not args.old or not args.new:
        ap.error("need OLD.json NEW.json (or --tuning TUNING_TORCH.json)")
    with open(args.old) as fo, open(args.new) as fn:
        return capture_delta(json.load(fo), json.load(fn), args.all)


if __name__ == "__main__":
    sys.exit(main())
