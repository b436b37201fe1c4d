"""Run the port's four analysis layers.

  python -m pumiumtally_tpu_torch.analysis                # all four layers
  python -m pumiumtally_tpu_torch.analysis --ast-only
  python -m pumiumtally_tpu_torch.analysis --protocols-only
  python -m pumiumtally_tpu_torch.analysis --no-protocols
  python -m pumiumtally_tpu_torch.analysis --no-contracts # no torch import
  python -m pumiumtally_tpu_torch.analysis --no-cost
  python -m pumiumtally_tpu_torch.analysis --write-protocols
                                  # regenerate PROTOCOLS_TORCH.json
                                  # (intentional protocol drift only)
  python -m pumiumtally_tpu_torch.analysis --write-contracts
                                  # regenerate CONTRACTS_TORCH.json
  python -m pumiumtally_tpu_torch.analysis --write-perf-contracts \
      [--ptxas-dir DIR]           # regenerate PERF_CONTRACTS_TORCH.json
                                  # from the build logs (on the card)
  python -m pumiumtally_tpu_torch.analysis --explain PUMI001
                                  # a rule's rationale, example finding
                                  # and fix pattern (also 'protocol' or
                                  # a protocol name)
  python -m pumiumtally_tpu_torch.analysis --allow-stale
                                  # mid-refactor: stale baseline entries
                                  # warn instead of failing

The AST layer (analysis/astlint.py) lints every module of
``pumiumtally_tpu_torch/`` against the rules PUMI001, PUMI002, PUMI004,
PUMI005 and PUMI007..PUMI011, the entry points under their subsets. The
protocol layer (analysis/protolint.py) verifies the declared
effect-ordering protocols of the crash-safety surface along all CFG
paths of their owning functions, and diffs the effect inventories
against the committed PROTOCOLS_TORCH.json (a capture from another
environment is refused). Both layers share one parsed index. The
contracts layer (analysis/contracts.py) runs the move loop's program
families on the CPU under a census and checks them (CONTRACT findings)
and their drift from CONTRACTS_TORCH.json. The cost layer
(analysis/costmodel.py, COST findings) checks ptxas's report of every
instantiation in csrc/: fresh build logs (the package's _build/, or
--ptxas-dir) are checked and diffed against PERF_CONTRACTS_TORCH.json;
without them, the committed capture's invariants and its source digests
against the tree's; and the CPU families' torch-op cost on the shape
ladder. --no-contracts skips the contracts layer and the cost layer's
families, so that the run imports no torch. Findings are suppressed per
(rule, path, symbol) through LINT_BASELINE_TORCH.json; every suppression
carries a justification, and a STALE entry (its finding no longer
exists) is itself a failure unless --allow-stale.

Exit 0: no finding outside the baseline and no stale entry; 1: findings
or a stale entry; 2: a configuration error (a baseline entry without a
justification, or one whose rule routes to no layer, or
--write-perf-contracts without the build logs of every source) or a
usage error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: Rule prefix of each layer's baseline entries.
LAYERS = {"astlint": "PUMI", "protolint": "PROTO", "contracts": "CONTRACT",
          "costmodel": "COST"}


def _layer_entries(entries, layer):
    """The baseline entries of one layer, by rule prefix, so that a PROTO
    entry never shows as stale to the AST layer (and the reverse)."""
    return [e for e in entries if e["rule"].startswith(LAYERS[layer])]


def report(layer, kept, suppressed, unused, verbose, allow_stale=False):
    for f in kept:
        print(f.render())
    if verbose:
        for f in suppressed:
            print(f"suppressed: {f.render()}")
    for e in unused:
        severity = "warning" if allow_stale else "error"
        print(
            f"{severity}: stale baseline entry {e['rule']} {e['path']} "
            f"[{e['symbol']}] — the finding is gone; retire the "
            "suppression"
            + ("" if allow_stale else
               " (or re-run with --allow-stale mid-refactor)")
        )
    state = "clean" if not kept else f"{len(kept)} finding(s)"
    print(
        f"{layer}: {state}"
        + (f", {len(suppressed)} baselined" if suppressed else "")
        + (f", {len(unused)} STALE baseline entr"
           f"{'y' if len(unused) == 1 else 'ies'}" if unused else "")
    )
    return 1 if (kept or (unused and not allow_stale)) else 0


def run_ast(args, entries, index) -> int:
    from . import apply_baseline
    from .astlint import lint_index

    kept, suppressed, unused = apply_baseline(
        lint_index(index), _layer_entries(entries, "astlint"))
    return report("astlint", kept, suppressed, unused, args.verbose,
                  args.allow_stale)


def run_protocols(args, entries, index) -> int:
    from . import apply_baseline
    from . import protolint as P

    proto_path = os.path.join(ROOT, args.protocols)
    findings = P.check(index)
    cap = P.capture(index)
    if args.write_protocols:
        P.write_protocols(proto_path, cap)
        print(f"wrote {args.protocols} for {len(cap['protocols'])} "
              f"protocols under {cap['environment']}")
    elif os.path.exists(proto_path):
        findings += P.diff_baseline(cap, P.load_protocols(proto_path))
    else:
        findings.append(P._finding(
            "baseline.missing.all",
            f"{args.protocols} not found — generate it with python -m "
            "pumiumtally_tpu_torch.analysis --write-protocols"))
    kept, suppressed, unused = apply_baseline(
        findings, _layer_entries(entries, "protolint"))
    return report("protolint", kept, suppressed, unused, args.verbose,
                  args.allow_stale)


class Runs:
    """The CPU families' runs, kept so that the cost layer's first ladder
    rung reuses the contracts layer's (the same problem)."""

    def __init__(self):
        self.done: dict = {}

    def __call__(self, family, *, n, cells, frames=None):
        from . import contracts as C

        key = (family, n, cells)
        if key not in self.done:
            self.done[key] = C.run_family(family, n=n, cells=cells,
                                          frames=frames)
        return self.done[key]


def run_contracts(args, entries, runs) -> int:
    from . import apply_baseline
    from . import contracts as C

    path = os.path.join(ROOT, C.CONTRACTS_FILE)
    cap = C.capture(run=runs)
    findings = C.check_structural(cap, entries)
    if args.write_contracts:
        C.write_contracts(path, cap)
        print(f"wrote {C.CONTRACTS_FILE} for {len(cap['families'])} "
              "families")
    elif os.path.exists(path):
        findings += C.diff_baseline(cap, C.load_contracts(path))
    else:
        findings.append(C._finding(
            "baseline.missing", "all",
            f"{C.CONTRACTS_FILE} not found — generate it with python -m "
            "pumiumtally_tpu_torch.analysis --write-contracts"))
    kept, suppressed, unused = apply_baseline(
        findings, _layer_entries(entries, "contracts"))
    return report("contracts", kept, suppressed, unused, args.verbose,
                  args.allow_stale)


def run_cost(args, entries, runs) -> int:
    """The ptxas capture (fresh logs if any, else the committed one) and,
    with the contracts layer on, the families' torch-op cost."""
    from . import apply_baseline
    from . import costmodel as M

    path = os.path.join(ROOT, args.perf_contracts)
    committed = (M.load_perf_contracts(path) if os.path.exists(path)
                 else {})
    logs = M.find_logs(args.ptxas_dir)
    if args.write_perf_contracts and set(logs) != set(M.SOURCES):
        raise ValueError(
            f"--write-perf-contracts needs the build logs of every source "
            f"({', '.join(M.SOURCES)}); found {sorted(logs) or 'none'} in "
            f"{args.ptxas_dir or 'the package _build/'}: build them on the "
            "card first")
    base_ptxas = committed.get("ptxas", {"environment": {}, "sources": {}})
    findings = []
    if logs:
        fresh = M.capture_ptxas(logs, f64=M.sass_census(logs)
                                if args.write_perf_contracts else None)
        merged = dict(base_ptxas, sources=dict(base_ptxas.get("sources", {}),
                                               **fresh["sources"]))
        findings += M.diff_cost(fresh, base_ptxas) if committed else []
        ptxas = fresh if args.write_perf_contracts else merged
        print(f"costmodel: ptxas logs of {sorted(logs)} under "
              f"{fresh['environment']}")
    else:
        ptxas = base_ptxas
    findings += M.check_cost(ptxas) + M.check_stale(ptxas)
    families = committed.get("families")
    if not args.no_contracts:
        families = M.capture_families(run=runs)
        if committed.get("families") and not args.write_perf_contracts:
            findings += M.diff_families(families, committed["families"])
    if families:
        findings += M.check_families(families)
    if args.write_perf_contracts:
        M.write_perf_contracts(path, {"ptxas": ptxas, "families": families})
        n = sum(len(s["instantiations"]) for s in ptxas["sources"].values())
        print(f"wrote {args.perf_contracts}: {n} instantiations")
    elif not committed:
        findings.append(M._finding(
            "cost.baseline.missing",
            f"{args.perf_contracts} not found — write it on the card with "
            "--write-perf-contracts"))
    kept, suppressed, unused = apply_baseline(
        findings, _layer_entries(entries, "costmodel"))
    return report("costmodel", kept, suppressed, unused, args.verbose,
                  args.allow_stale)


def run_explain(topic: str) -> int:
    from . import astlint, protolint

    text = astlint.explain(topic)
    if text is None:
        text = protolint.explain(topic)
    if text is None:
        print(
            f"--explain: unknown rule or protocol {topic!r} (rules: "
            f"{', '.join(sorted(astlint.RULES_BY_ID))}; 'protocol' for "
            "the protocol layer's overview, or a protocol name from "
            "PROTOCOLS_TORCH.json)",
            file=sys.stderr,
        )
        return 2
    print(text)
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pumiumtally_tpu_torch.analysis",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ast-only", action="store_true")
    ap.add_argument("--protocols-only", action="store_true",
                    help="run only the protocol layer")
    ap.add_argument("--no-protocols", action="store_true",
                    help="skip the protocol layer")
    ap.add_argument("--no-contracts", action="store_true",
                    help="skip the contracts layer and the cost layer's "
                         "CPU families (the run imports no torch)")
    ap.add_argument("--no-cost", action="store_true",
                    help="skip the cost layer")
    ap.add_argument("--write-protocols", action="store_true",
                    help="regenerate PROTOCOLS_TORCH.json from the current "
                         "tree (intentional protocol drift only)")
    ap.add_argument("--write-contracts", action="store_true",
                    help="regenerate CONTRACTS_TORCH.json")
    ap.add_argument("--write-perf-contracts", action="store_true",
                    help="regenerate PERF_CONTRACTS_TORCH.json from the "
                         "build logs of every source (refused without "
                         "them)")
    ap.add_argument("--ptxas-dir", metavar="DIR",
                    help="read the build logs (lib<name>-<hash>.log) from "
                         "DIR instead of the package's _build/")
    ap.add_argument("--explain", metavar="RULE|PROTOCOL",
                    help="print one rule's (or protocol's) rationale, an "
                         "example finding and the fix pattern, then exit")
    ap.add_argument("--allow-stale", action="store_true",
                    help="stale baseline entries warn instead of failing")
    ap.add_argument("--baseline", default="LINT_BASELINE_TORCH.json")
    ap.add_argument("--protocols", default="PROTOCOLS_TORCH.json")
    ap.add_argument("--perf-contracts", default="PERF_CONTRACTS_TORCH.json")
    ap.add_argument("-v", "--verbose", action="store_true")
    return ap


def main(argv=None, index=None) -> int:
    """The runner's exit code for ``argv``. ``index`` is a
    ``PackageIndex`` already built over this checkout's sources (the
    tests share one); by default the run parses the tree."""
    t0 = time.perf_counter()
    ap = parser()
    args = ap.parse_args(argv)
    if args.explain:
        return run_explain(args.explain)
    if args.ast_only and args.protocols_only:
        ap.error("--ast-only and --protocols-only are exclusive")
    if args.no_protocols and args.protocols_only:
        ap.error("--no-protocols contradicts --protocols-only")
    do_ast = not args.protocols_only
    do_protocols = not (args.ast_only or args.no_protocols)
    only = args.ast_only or args.protocols_only
    do_contracts = not (only or args.no_contracts)
    do_cost = not (only or args.no_cost)
    # A write flag aimed at a disabled layer would exit 0 with the
    # baseline silently NOT regenerated — refuse the combination.
    if args.write_protocols and not do_protocols:
        ap.error("--write-protocols needs the protocol layer; drop "
                 "--ast-only / --no-protocols")
    if args.write_contracts and not do_contracts:
        ap.error("--write-contracts needs the contracts layer; drop "
                 "--ast-only / --protocols-only / --no-contracts")
    if args.write_perf_contracts and not do_cost:
        ap.error("--write-perf-contracts needs the cost layer; drop "
                 "--ast-only / --protocols-only / --no-cost")

    from . import load_baseline

    baseline_path = os.path.join(ROOT, args.baseline)
    entries = (load_baseline(baseline_path)
               if os.path.exists(baseline_path) else [])
    # Every entry must route to a layer — an unroutable rule (a typo
    # like "UMI001", or a JAX contract layer's CONTRACT/COST) would
    # suppress nothing AND dodge the stale-entry failure.
    for e in entries:
        if not e["rule"].startswith(tuple(LAYERS.values())):
            raise ValueError(
                f"baseline entry rule {e['rule']!r} matches no lint layer "
                "of the port (PUMI* / PROTO* / CONTRACT* / COST*) — fix "
                "the rule name or remove the entry")
    if index is None:
        from .protolint import build_index

        index = build_index(ROOT)
    rc = 0
    if do_ast:
        rc |= run_ast(args, entries, index)
    if do_protocols:
        rc |= run_protocols(args, entries, index)
    runs = Runs()
    if do_contracts:
        rc |= run_contracts(args, entries, runs)
    if do_cost:
        rc |= run_cost(args, entries, runs)
    print(f"analysis: {time.perf_counter() - t0:.2f} s")
    return rc


def run(argv=None, index=None) -> int:
    """``main`` with a configuration error as exit code 2."""
    try:
        return main(argv, index)
    except (RuntimeError, ValueError, json.JSONDecodeError) as e:
        print(f"lint configuration error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(run())
