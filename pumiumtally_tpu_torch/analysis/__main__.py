"""Run the port's two lint layers over its sources.

  python -m pumiumtally_tpu_torch.analysis                # both layers
  python -m pumiumtally_tpu_torch.analysis --ast-only
  python -m pumiumtally_tpu_torch.analysis --protocols-only
  python -m pumiumtally_tpu_torch.analysis --no-protocols
  python -m pumiumtally_tpu_torch.analysis --write-protocols
                                  # regenerate PROTOCOLS_TORCH.json
                                  # (intentional protocol drift only)
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
environment is refused). Both layers share one parsed index. Findings
are suppressed per (rule, path, symbol) through LINT_BASELINE_TORCH.json;
every suppression carries a justification, and a STALE entry (its
finding no longer exists) is itself a failure unless --allow-stale.

Exit 0: no finding outside the baseline and no stale entry; 1: findings
or a stale entry; 2: a configuration error (a baseline entry without a
justification, or one whose rule routes to no layer) or a usage error.
The kernel resource checks (the JAX package's contracts and cost layers)
are not part of this runner.
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
LAYERS = {"astlint": "PUMI", "protolint": "PROTO"}


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
    ap.add_argument("--write-protocols", action="store_true",
                    help="regenerate PROTOCOLS_TORCH.json from the current "
                         "tree (intentional protocol drift only)")
    ap.add_argument("--explain", metavar="RULE|PROTOCOL",
                    help="print one rule's (or protocol's) rationale, an "
                         "example finding and the fix pattern, then exit")
    ap.add_argument("--allow-stale", action="store_true",
                    help="stale baseline entries warn instead of failing")
    ap.add_argument("--baseline", default="LINT_BASELINE_TORCH.json")
    ap.add_argument("--protocols", default="PROTOCOLS_TORCH.json")
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
    # A write flag aimed at a disabled layer would exit 0 with the
    # baseline silently NOT regenerated — refuse the combination.
    if args.write_protocols and not do_protocols:
        ap.error("--write-protocols needs the protocol layer; drop "
                 "--ast-only / --no-protocols")

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
                "of the port (PUMI* / PROTO*) — fix the rule name or "
                "remove the entry")
    if index is None:
        from .protolint import build_index

        index = build_index(ROOT)
    rc = 0
    if do_ast:
        rc |= run_ast(args, entries, index)
    if do_protocols:
        rc |= run_protocols(args, entries, index)
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
