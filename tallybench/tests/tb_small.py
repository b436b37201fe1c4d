"""Shared helpers of the benchmark's CPU tests: small versions of the
cells (the same code, a 6³- or 8³-cube mesh and 300 lanes in 3 groups) run
on the CPU."""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("pincell-casmo8-f64.source", "assembly17-casmo70-f64.source")


def small(workload: str, root: Path = ROOT) -> dict:
    """The configuration overrides of a cell's small CPU version."""
    from tallybench.harness import lookup

    mesh = dict(lookup(workload, root)["config"]["mesh"])
    if mesh["kind"] == "assembly":
        mesh.update(cells=8, lattice=3)
    else:
        mesh.update(cells=6)
    return {"mesh": mesh, "particles": 300, "n_groups": 3}


def run_small(workload, trace=False, fault=None, seed=2 ** 31 + 7,
              seconds=0.3, root=ROOT):
    """Run a cell's small version on the CPU; the harness's result."""
    from tallybench import harness

    return harness.run(workload, seed, seconds, trace,
                       t_start=time.perf_counter(), device="cpu",
                       root=root, overrides=small(workload, root),
                       fault=fault)
