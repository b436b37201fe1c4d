"""Chaos campaign driver: multi-fault scenarios against the supervised
partitioned run, each with a DECLARED outcome.

Counterpart of the JAX package's ``scripts/chaos.py``. Every scenario
drives a small partitioned campaign (a 4^3 box of two materials, 64
particles, 2 groups, float64) through ``ResilientRunner`` with a composed
fault schedule (``resilience/faultinject.py``) and asserts one of two
contracts:

  * **bitwise replay**: the completed run's flux is bit-identical to the
    fault-free reference on the same layout (transient storms,
    torn-generation fallback and replay, eviction and auto-resume);
  * **graceful degradation**: the run completes on a SHRUNKEN layout and
    the flux matches the fault-free reference at the shrunk part count
    within the layout-independence tolerance (atol 1e-11, float64).

The JAX script's eight virtual CPU devices are eight parts of one
``PartitionedTally`` stacked on one device; a chip loss shrinks it to
seven.

Scenarios (all by default; ``--only NAME`` picks one, ``--list`` names
them): transient_storm, chip_down, fault_during_recovery,
torn_generation_resume, corrupt_manifest_chip_down.

    python -m pumiumtally_tpu_torch.chaos.campaign [--moves M]
        [--only NAME] [--list] [--device cuda|cpu]

Exit code 0 = every scenario met its declared contract.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..mesh.box import build_box_arrays
from ..mesh.core import TetMesh
from ..parallel.partitioned_api import PartitionedTally
from ..resilience.faultinject import ChaosInjector, ChaosPlan, InjectedKill
from ..resilience.runner import ResilientRunner
from ..utils.config import TallyConfig
from ..utils.platform import resolve_device

N = 64
N_PARTS = 8
# The layout-independence contract's tolerance (float64): the bound the
# elastic tests and the JAX campaign hold a shrunk run to.
SHRINK_ATOL = 1e-11


def config() -> TallyConfig:
    return TallyConfig(n_groups=2, dtype=torch.float64, tolerance=1e-8)


def build_mesh(device) -> TetMesh:
    coords, tets = build_box_arrays(1.0, 1.0, 1.0, 4, 4, 4)
    cid = (coords[tets].mean(1)[:, 0] > 0.5).astype(np.int32)
    return TetMesh.from_numpy(coords, tets, cid, dtype=torch.float64,
                              device=device)


def _inputs(i):
    r = np.random.default_rng(7000 + i)
    return (
        r.uniform(0.05, 0.95, (N, 3)).ravel().copy(),
        np.ones(N, np.int8),
        r.uniform(0.5, 2.0, N),
        r.integers(0, 2, N).astype(np.int32),
        np.full(N, -1, np.int32),
    )


def _pos():
    return np.random.default_rng(42).uniform(0.1, 0.9, (N, 3)).ravel()


def reference_flux(mesh, n_parts, moves) -> np.ndarray:
    """The fault-free run at ``n_parts`` parts: the contracts' oracle."""
    t = PartitionedTally(mesh, N, config(), n_parts=n_parts,
                         device=mesh.device)
    t.initialize_particle_location(_pos())
    for i in range(1, moves + 1):
        t.move_to_next_location(*_inputs(i))
    return np.asarray(t.raw_flux, np.float64)


def drive_campaign(mesh, plan, ckdir, moves):
    """One supervised campaign under the chaos plan, auto-resuming across
    evictions (a fresh tally and runner per 'process'). Returns (final
    runner, evictions seen)."""
    t = PartitionedTally(mesh, N, config(), n_parts=N_PARTS,
                         device=mesh.device)
    run = ResilientRunner(
        t, ckdir, every_moves=1, handle_signals=False,
        sleep=lambda s: None, faults=ChaosInjector(plan),
    )
    evictions = 0
    run.initialize_particle_location(_pos())
    i = 1
    while i <= moves:
        if run.tally.iter_count >= i:
            i += 1
            continue
        try:
            run.move_to_next_location(*_inputs(i))
        except InjectedKill:
            evictions += 1
            t = PartitionedTally(mesh, N, config(),
                                 n_parts=run.tally.n_parts,
                                 device=mesh.device)
            run = ResilientRunner(
                t, ckdir, every_moves=1, handle_signals=False,
                sleep=lambda s: None,
            )
            continue
        i += 1
    return run, evictions


def check(name, mesh, plan, moves, expect, tmpdir) -> bool:
    """Run one scenario and assert its declared contract. ``expect`` is
    "bitwise" or ("shrink", expected_parts)."""
    t0 = time.perf_counter()
    run, evictions = drive_campaign(mesh, plan, os.path.join(tmpdir, name),
                                    moves)
    parts = run.tally.n_parts
    got = np.asarray(run.raw_flux, np.float64)
    if expect == "bitwise":
        want_parts, atol = N_PARTS, 0.0
    else:
        want_parts, atol = expect[1], SHRINK_ATOL
    want = reference_flux(mesh, want_parts, moves)
    ok = parts == want_parts and got.shape == want.shape and np.allclose(
        got, want, rtol=0, atol=atol)
    if expect == "bitwise":
        ok = ok and got.tobytes() == want.tobytes()
    st = run.recovery_stats
    err = np.abs(got - want).max() if got.shape == want.shape else np.inf
    print(
        f"[chaos] {name}: {plan.describe() or 'no faults'} | "
        f"parts {N_PARTS}->{parts} rollbacks={st['rollbacks']} "
        f"reshards={st['reshards']} evictions={evictions} "
        f"max|dflux|={err:.3e} "
        f"(contract={'bitwise' if expect == 'bitwise' else 'shrink'}) "
        f"{time.perf_counter() - t0:.2f} s on {mesh.device} "
        f"{'OK' if ok else 'FAIL'}",
        flush=True,
    )
    return ok


SCENARIOS = {
    # Fault storm: three transients, same layout: bitwise.
    "transient_storm": (ChaosPlan(transient_moves=(2, 3, 5)), "bitwise"),
    # One chip down mid-campaign: shrink to 7 parts, physics-equal.
    "chip_down": (ChaosPlan(chip_down_move=3), ("shrink", 7)),
    # Fault during recovery: the transient fires on the post-reshard
    # replay of the SAME move.
    "fault_during_recovery": (
        ChaosPlan(transient_moves=(3,), chip_down_move=3), ("shrink", 7),
    ),
    # Torn newest generation + eviction: resume skips it, restores the
    # older generation, replays bitwise.
    "torn_generation_resume": (
        ChaosPlan(preempt_move=4, torn_generation=3), "bitwise",
    ),
    # Composition: a torn generation AND a chip loss in one campaign.
    "corrupt_manifest_chip_down": (
        ChaosPlan(chip_down_move=4, torn_generation=2), ("shrink", 7),
    ),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pumiumtally_tpu_torch.chaos.campaign",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--moves", type=int, default=6)
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
        print(f"[chaos] unknown scenario(s) {unknown}", file=sys.stderr)
        return 2
    mesh = build_mesh(resolve_device(args.device))
    fails = 0
    with tempfile.TemporaryDirectory(prefix="chaos_") as tmpdir:
        for name in names:
            plan, expect = SCENARIOS[name]
            fails += 0 if check(name, mesh, plan, args.moves, expect,
                                tmpdir) else 1
    print("CHAOS CAMPAIGN", "PASS" if fails == 0 else f"{fails} FAILURES")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
