"""The readings the check's limits are set from, in one process.

    python3 tallybench/control.py --workload <name> --program-seeds 1,2 \\
        --control-seeds 3,4,5 [--out readings.jsonl]

For each program seed: a fresh tally runs the cell's first batch of that
seed's traffic (as a run's warm-up does), and the check's numbers are taken
against the reference. For each control seed: the reference computed in the
precision below the configuration's (bfloat16 for float32, float32 for
float64; the same uniforms, drawn in the configuration's type) is put in
the program's place and compared the same way: it has to come out over a
limit. Prints one JSON line a reading, then the largest program reading and
the least control reading of each number. The benchmark's own runs do not
run this.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

LOWER = {"float32": "bfloat16", "float64": "float32"}


def readings(workload, program_seeds, control_seeds, *, device="cuda",
             overrides=None, emit=print):
    """Yield ``(side, seed, numbers)`` for every seed."""
    import torch

    from . import check, meshgen
    from .drive import Probe
    from .generator import Traffic
    from .harness import lookup

    cell = lookup(workload)
    cfg = dict(cell["config"], **(overrides or {}))
    mix, drive = cell["mix"], cell["drive"]
    dev = torch.device(device)
    dtype = check.DTYPES[cfg["dtype"]]
    ref_dtype = check.DTYPES[cfg["reference_dtype"]]
    arrays = meshgen.build(cfg["mesh"])
    cfg["regions"] = int(arrays[2].max()) + 1
    out = []
    if program_seeds:
        from pumiumtally_tpu_torch import PumiTally, TallyConfig
        from pumiumtally_tpu_torch.mesh.core import TetMesh

        mesh = TetMesh.from_numpy(*arrays, dtype=dtype, device=dev)
    for seed in program_seeds:
        traffic = Traffic(mix, cfg, seed, drive)
        tally = PumiTally(mesh, int(cfg["particles"]), TallyConfig(
            n_groups=int(cfg["n_groups"]), dtype=dtype,
            tolerance=float(cfg["tolerance"])), device=dev)
        drv = drive.Driver(tally, traffic, cfg, Probe())
        drv.batch()
        last = drv.last
        prog = dict(flux=tally.flux.double(), **drv.outputs())
        del tally, drv
        ref = check.reference_batch(cfg, drive, traffic, last, arrays, dev,
                                    ref_dtype)
        nums = check.numbers(drive, prog, ref)
        del prog, ref
        emit(json.dumps(dict(side="program", seed=seed, **nums)))
        out.append(("program", seed, nums))
    low = check.DTYPES[LOWER[cfg["dtype"]]]
    for seed in control_seeds:
        traffic = Traffic(mix, cfg, seed, drive)
        last = drive.first(traffic)
        ref = check.reference_batch(cfg, drive, traffic, last, arrays, dev,
                                    ref_dtype)
        ctl = check.reference_batch(cfg, drive, traffic, last, arrays, dev,
                                    low)
        nums = check.numbers(drive, ctl, ref)
        del ref, ctl
        emit(json.dumps(dict(side="control", seed=seed, **nums)))
        out.append(("control", seed, nums))
    return out


def summary(rows) -> dict:
    """The largest program reading and the least control reading of each
    number."""
    res = {}
    for side, agg in (("program", max), ("control", min)):
        vals = [n for s, _, n in rows if s == side]
        if vals:
            res[side] = {k: agg(v[k] for v in vals) for k in vals[0]}
    return res


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    a = ap.parse_args(argv)

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    sink = open(a.out, "a") if a.out else None

    def emit(line):
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    t0 = time.perf_counter()
    try:
        rows = readings(a.workload, seeds(a.program_seeds),
                        seeds(a.control_seeds), emit=emit)
    finally:
        if sink:
            sink.close()
    print(json.dumps(dict(workload=a.workload, seconds=time.perf_counter()
                          - t0, **summary(rows))), flush=True)
    return 0


if __name__ == "__main__":
    from tallybench.control import main as _main

    sys.exit(_main(sys.argv[1:]))
