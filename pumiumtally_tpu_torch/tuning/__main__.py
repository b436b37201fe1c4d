"""The port's autotuner: search, write, check.

    python -m pumiumtally_tpu_torch.tuning                  # on the card
    python -m pumiumtally_tpu_torch.tuning --mode rehearsal # on the CPU
    python -m pumiumtally_tpu_torch.tuning --shapes smoke1,headline
    python -m pumiumtally_tpu_torch.tuning --mode rehearsal \\
        --shapes smoke1,smoke2 --check TUNING_TORCH.json   # drift check

For each shape class (``tuning/search.py`` SPECS, or
``name=cells:n_particles:n_groups``) it times the walk kernel's block
widths and the megastep K, gates every candidate bitwise against the
reference (block 128, K = 1), fits the calibration and merges the
winners into the environment's section of the database (default
``TUNING_TORCH.json`` at the repository's root): entries of other shape
classes and sections stay. ``--mode hardware`` runs on the card and ranks
by measured medians; ``--mode rehearsal`` runs on the CPU and ranks by
the cost model's predicted seconds, so two processes pick the same
winners. ``--check DB`` tunes, compares the winners with DB's and writes
nothing: it prints "tuning check clean" and exits 0, or "tuning drift"
with the keys and exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    from .db import TUNING_FILE, environment, load_tuning, write_tuning
    from .search import MODES, SPECS, mode_device, tune, winners

    ap = argparse.ArgumentParser(
        prog="python -m pumiumtally_tpu_torch.tuning",
        description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--shapes", default="smoke1,smoke2",
        help="comma-separated shape classes (tuning/search.py SPECS) or "
             "name=cells:n_particles:n_groups")
    ap.add_argument("--out", default=os.path.join(ROOT, TUNING_FILE))
    ap.add_argument(
        "--check", metavar="DB",
        help="tune, compare the winners with this database and exit 1 on "
             "drift (writes nothing)")
    ap.add_argument("--mode", choices=MODES, default="hardware",
                    help="hardware: the card, measured medians; rehearsal: "
                         "the CPU, the cost model's ranking")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed repetitions a candidate, in turns "
                         "(default 9, rehearsal 2): a candidate displaces "
                         "the reference only with every rep under the "
                         "reference's fastest")
    ap.add_argument("--moves", type=int, default=None,
                    help="moves of a kernel candidate's chain (default 4, "
                         "rehearsal 2)")
    ap.add_argument("--mega-moves", type=int, default=None,
                    help="device-sourced moves of the megastep runs; "
                         "clamps the K ladder (default 64, rehearsal 4)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rehearsal = args.mode == "rehearsal"
    # The knobs' env variables must not steer the candidates being tuned.
    for var in ("PUMI_TPU_TUNING", "PUMI_TPU_MEGASTEP", "PUMI_TPU_KERNEL",
                "PUMI_TPU_PALLAS_LANE_BLOCK"):
        os.environ.pop(var, None)
    reps = args.reps if args.reps is not None else (2 if rehearsal else 9)
    moves = args.moves if args.moves is not None else (
        2 if rehearsal else 4)
    mega = args.mega_moves if args.mega_moves is not None else (
        4 if rehearsal else 64)

    specs = {}
    for tok in args.shapes.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" in tok:
            name, rest = tok.split("=", 1)
            cells, n, g = (int(x) for x in rest.split(":"))
            specs[name] = dict(cells=cells, n_particles=n, n_groups=g)
        elif tok in SPECS:
            specs[tok] = SPECS[tok]
        else:
            ap.error(f"unknown shape class {tok!r}; known: {sorted(SPECS)} "
                     "(or name=cells:n:groups)")

    base = None
    if os.path.exists(args.out) and not args.check:
        base = load_tuning(args.out).data

    def progress(msg):
        print(f"[tune] {msg}", file=sys.stderr, flush=True)

    data = tune(specs, mode=args.mode, reps=reps, moves=moves,
                mega_moves=mega, seed=args.seed, base=base,
                progress=progress)
    env = environment(mode_device(args.mode))
    if args.check:
        fresh = winners(data, env)
        drift = []
        committed = None
        try:
            committed = load_tuning(args.check)
        except (ValueError, OSError, json.JSONDecodeError) as e:
            drift.append(f"unusable database: {e}")
        if committed is not None:
            try:
                if committed.section(env, strict=True) is None:
                    drift.append("no section for the current environment "
                                 f"{env} (empty database)")
            except ValueError as e:
                drift.append(str(e))
            old = {k: v for k, v in winners(committed.data, env).items()
                   if k in fresh}
            for k in sorted(fresh):
                if k not in old:
                    drift.append(f"{k}: missing from {args.check}")
                elif tuple(old[k]) != tuple(fresh[k]):
                    drift.append(f"{k}: committed winners {old[k]} != "
                                 f"fresh {fresh[k]}")
        if drift:
            print(f"tuning drift against {args.check}:")
            for d in drift:
                print(f"  {d}")
            print("regenerate with: python -m pumiumtally_tpu_torch.tuning "
                  f"--mode {args.mode} --shapes {args.shapes} "
                  f"--out {args.check}")
            return 1
        print(f"tuning check clean: {len(fresh)} shape class(es) match "
              f"{args.check}")
        return 0

    write_tuning(args.out, data)
    for key, (block, mega_k) in sorted(winners(data, env).items()):
        print(f"{key}: block={block} megastep={mega_k}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (ValueError, json.JSONDecodeError) as e:
        print(f"tune error: {e}", file=sys.stderr)
        sys.exit(2)
