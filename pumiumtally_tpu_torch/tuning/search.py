"""The port's shape-class autotuner: search, parity gate, calibration join.

Counterpart of ``pumiumtally_tpu/tuning/search.py``. For each shape class
(``tuning/shapes.py``) it times the port's own knobs on a seeded workload:

  * the kernel axis: the walk kernel's threads per block over
    ``BLOCK_LADDER`` (64, 128, 256, 512; ``ops/walk_cuda.py``), the
    counterpart of the JAX kernel's ``lane_block`` ladder, each candidate
    a chain of ``moves`` moves through ``walk_cuda.trace`` (the lane
    schedule, the walk kernel, the ordered scatter); 128, the kernel's
    default, is the canonical first candidate and the reference. A mesh
    without geo20 has the 128 instantiations only, so 128 is its one
    candidate;
  * the megastep axis: K over ``MEGASTEP_LADDER`` (clamped to the move
    budget), timed through ``PumiTally.run_source_moves`` (the flight
    kernel, the walk, the physics), K = 1 the reference. Every K runs the
    same ``mega_moves`` moves from a fresh facade, in chunks of K: lanes
    die as the moves go on, so timing later moves for a larger K (as
    chunks continued on one facade would) would favour it.

Each candidate is run once untimed (the kernels' build and first launch),
then the axis's candidates are timed ``reps`` times in turns (forward,
then backward), so that a drift of the clocks over the search falls on
every candidate alike; a candidate's time is its median seconds a move.
Every candidate is gated on bitwise parity with its axis's reference
before it can win: final positions, elements, done flags and the flux
(and the segments) of the kernel chain; the flux and the segments of the
megastep run. A candidate that differs by one bit is recorded with
``parity: "failed"`` and never wins. The atomic tally is not a candidate:
its flux varies from run to run in its last bits (tens of thousands of
entries of the main cell's flux between two runs), so it could never pass
the gate.

``mode="hardware"`` (the card) times each run between two CUDA events and
keeps the axis's reference unless a candidate beats it beyond the spread
of the reps: the candidate's slowest rep faster than the reference's
fastest, and its median more than ``TIE_TOL`` under the reference's.
Among such candidates medians within ``TIE_TOL`` of the best tie toward
the canonical order. A move's times on one card vary by more than the
widths differ, so a rule on medians alone picked a different width from
run to run. ``mode="rehearsal"``
(the CPU, where the plain walk stands in for every width) still measures
every candidate but ranks by the predicted seconds of
``tuning/costmodel.py``: host wall clock says nothing of the card, and a
ranking by counts is what makes two processes pick the same winners. The
counts of a move (``walk_metrics``) are the same for every width, so the
widths tie and 128 wins a rehearsal; the megastep's predicted seconds
carry one host read a chunk, so the largest K of the ladder wins one.

Calibration: every parity-clean kernel candidate is a ``(flops, bytes,
seconds a move)`` point, fitted by ``costmodel.calibrate_points``.

Fault hook: ``PUMI_TPU_TUNE_FAULT=kernel:cuda:<block>`` or
``megastep:<K>`` corrupts that candidate's flux by one ulp before the
parity compare (the reference itself cannot be corrupted: it defines
correct).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..ops.walk_cuda import BLOCKS as BLOCK_LADDER
from ..ops.walk_cuda import DEFAULT_BLOCK as CANONICAL_BLOCK
from .costmodel import (
    FLIGHT_OPS_PER_LANE,
    NOMINAL_COEFFS,
    calibrate_points,
    predict_seconds,
    walk_metrics,
)
from .db import TUNING_SCHEMA, empty_db, env_key, environment
from .shapes import classify

MEGASTEP_LADDER = (1, 4, 16, 64)
# A candidate displaces its axis's reference only with a median more than
# this fraction under the reference's (and every rep under the
# reference's fastest); medians within it of the best tie toward the
# canonical order (defaults first).
TIE_TOL = 0.05
MODES = ("hardware", "rehearsal")

# The canonical shape classes (the JAX tuner's): unit box meshes of 6 ·
# cells³ tets. smoke1 and smoke2 are the committed CPU rehearsal's;
# headline is the main cell (998,250 tets, 1,048,576 particles, 8 groups).
SPECS = {
    "smoke1": dict(cells=2, n_particles=256, n_groups=2),
    "smoke2": dict(cells=3, n_particles=512, n_groups=2),
    "ab12": dict(cells=12, n_particles=8192, n_groups=2),
    "ab14": dict(cells=14, n_particles=8192, n_groups=2),
    "headline": dict(cells=55, n_particles=1048576, n_groups=8),
}


def mode_device(mode: str) -> str:
    """The device a mode tunes on: the card for "hardware", the CPU for
    "rehearsal"."""
    if mode not in MODES:
        raise ValueError(f"mode must be 'hardware' or 'rehearsal': {mode!r}")
    return "cuda" if mode == "hardware" else "cpu"


def _fault():
    """PUMI_TPU_TUNE_FAULT as ("kernel", "cuda", 256) or ("megastep", 4)."""
    spec = os.environ.get("PUMI_TPU_TUNE_FAULT", "")
    if not spec:
        return None
    parts = spec.split(":")
    if parts[0] == "kernel" and len(parts) == 3:
        return ("kernel", parts[1], int(parts[2]))
    if parts[0] == "megastep" and len(parts) == 2:
        return ("megastep", int(parts[1]))
    raise ValueError(
        f"PUMI_TPU_TUNE_FAULT must be kernel:cuda:<block> or "
        f"megastep:<K>: {spec!r}"
    )


def _corrupt(flux: np.ndarray) -> np.ndarray:
    """One ulp up on the first flux entry: the smallest silent corruption,
    which the bitwise gate must still catch."""
    out = flux.copy()
    flat = out.reshape(-1)
    flat[0] = np.nextafter(flat[0], np.inf)
    return out


def _bitwise_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _span(device, fn):
    """``(fn(), seconds)``: between two CUDA events on the card, on the
    host clock elsewhere."""
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _launches() -> int:
    """Kernel launches the wrappers counted so far (walk, lane schedule,
    ordered scatter, flight); none move on the CPU."""
    from ..ops import scatter, source_cuda, walk_cuda

    return (walk_cuda.LAUNCHES + walk_cuda.SCHEDULE_LAUNCHES
            + scatter.ORDERED_LAUNCHES + source_cuda.LAUNCHES)


# --------------------------------------------------------------------- #
# The workload (the JAX tuner's generator, seeded host numpy)
# --------------------------------------------------------------------- #
def build_workload(spec: dict, *, moves: int, seed: int, device="cuda",
                   mesh=None) -> dict:
    """The spec's unit box (or ``mesh``, a box of its size) on
    ``device``, ``n_particles`` lanes at the centroids of seeded random
    elements, and a chain of ``moves`` destinations (isotropic flights of
    exponential length, mean ``mean_path``, clipped to [0.01, 0.99]), so
    every candidate walks the same trajectory."""
    from ..mesh.box import build_box

    dtype = {"float32": torch.float32, "float64": torch.float64}[
        spec.get("dtype", "float32")]
    cells = int(spec["cells"])
    n = int(spec["n_particles"])
    g = int(spec["n_groups"])
    if mesh is None:
        mesh = build_box(1.0, 1.0, 1.0, cells, cells, cells, dtype=dtype,
                         device=device)
    if mesh.ntet != 6 * cells ** 3 or mesh.dtype != dtype:
        raise ValueError(
            f"the mesh given has {mesh.ntet} {mesh.dtype} tets; the spec's "
            f"box has {6 * cells ** 3} {dtype}")
    device = mesh.device
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(seed)
    elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
    origin = mesh.centroids().cpu().numpy()[elem].astype(np_dt)
    mean_path = float(spec.get("mean_path", 0.08))
    dests, prev = [], origin
    for _ in range(moves):
        d = rng.normal(0, 1, (n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        ln = rng.exponential(mean_path, (n, 1))
        prev = np.clip(prev + d * ln, 0.01, 0.99).astype(np_dt)
        dests.append(prev)

    def put(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    return dict(
        spec=spec, mesh=mesh, dtype=dtype, device=device, n_particles=n,
        n_groups=g, mean_path=mean_path, seed=seed,
        origin_host=origin,
        origin=put(origin, dtype),
        elem=put(elem, torch.int32),
        dests=[put(x, dtype) for x in dests],
        in_flight=torch.ones(n, dtype=torch.bool, device=device),
        weight=torch.ones(n, dtype=dtype, device=device),
        group=put(rng.integers(0, g, n).astype(np.int32), torch.int32),
        material=torch.full((n,), -1, dtype=torch.int32, device=device),
        packed=mesh.geo20 is not None,
        capacity=None,
    )


def _run_chain(w: dict, block: int, outputs: bool = True) -> dict:
    """Walk the destination chain once from the seeded start at ``block``
    threads per block. Returns the segments and lane iterations summed
    over the moves, the kernel launches the chain made and, with
    ``outputs``, the final position, element, done flags and flux (host
    copies, made after the chain so that a timed chain leaves them
    out)."""
    from ..core.tally import make_flux
    from ..ops import walk_cuda

    mesh = w["mesh"]
    cur, elem = w["origin"], w["elem"]
    flux = make_flux(mesh.ntet, w["n_groups"], w["dtype"], device=w["device"])
    nseg = iters = 0
    records = []
    launches = _launches()
    r = None
    for i, dest in enumerate(w["dests"]):
        cap = None if w["capacity"] is None else w["capacity"][i]
        r = walk_cuda.trace(
            mesh, cur, dest, elem, w["in_flight"], w["weight"], w["group"],
            w["material"], flux, initial=False,
            max_crossings=mesh.ntet + 64, n_groups=w["n_groups"],
            tolerance=1e-6, capacity=cap, block=block,
        )
        cur, elem = r.position, r.elem
        nseg += int(r.n_segments)
        iters += int(r.lane_iters.sum(dtype=torch.int64))
        records.append(r.n_records)
    _sync(w["device"])
    out = dict(segments=nseg, iters=iters, records=records,
               launches=_launches() - launches)
    if outputs:
        out.update(position=r.position.cpu().numpy(),
                   elem=r.elem.cpu().numpy(), done=r.done.cpu().numpy(),
                   flux=flux.cpu().numpy())
    return out


def _median(vals) -> float:
    return float(np.median(np.asarray(vals)))


def kernel_candidates(w: dict) -> list[dict]:
    """The kernel axis: the canonical width first, then the rest of the
    ladder, each clamped to the batch and mapped to a built width as a
    facade maps a resolved value (``walk_cuda.block_for``), duplicates
    dropped; a mesh without geo20 has the canonical width only."""
    from ..ops.walk_cuda import block_for

    order = (CANONICAL_BLOCK,) + tuple(
        b for b in BLOCK_LADDER if b != CANONICAL_BLOCK)
    if not w["packed"]:
        order = (CANONICAL_BLOCK,)
    pow2_cap = 1 << (max(int(w["n_particles"]), 1).bit_length() - 1)
    cands, seen = [], set()
    for b in order:
        eff = block_for(min(b, pow2_cap))
        if eff not in seen:
            seen.add(eff)
            cands.append(dict(kind="kernel", block=eff))
    return cands


def _timed_in_turns(runs: list, reps: int) -> list[list]:
    """``reps`` rounds over ``runs`` (callables returning ``(result,
    seconds)``), forward on even rounds and backward on odd ones, so that
    a drift of the clocks over the search falls on every candidate alike.
    Returns each run's pairs."""
    out = [[] for _ in runs]
    for rep in range(reps):
        turn = range(len(runs)) if rep % 2 == 0 else range(len(runs))[::-1]
        for i in turn:
            out[i].append(runs[i]())
    return out


def evaluate_kernel_axis(w: dict, *, reps: int, nominal: dict
                         ) -> list[dict]:
    fault = _fault()
    moves = len(w["dests"])
    cands = kernel_candidates(w)
    # Untimed, in order: each width's build and first launch and its
    # outputs; the canonical width's run sizes the timed runs' record
    # buffers.
    results = []
    for c in cands:
        results.append(_run_chain(w, c["block"]))
        if w["capacity"] is None and w["device"].type == "cuda":
            from ..ops.walk_cuda import record_capacity

            w["capacity"] = [record_capacity(w["n_particles"], r)
                             for r in results[0]["records"]]
    timed = _timed_in_turns([
        (lambda b=c["block"]: _span(
            w["device"], lambda: _run_chain(w, b, outputs=False)))
        for c in cands], reps)
    out = []
    reference = results[0]  # the canonical width: the reference
    for order, (c, outputs, runs) in enumerate(zip(cands, results, timed)):
        block = c["block"]
        if (fault is not None and fault[0] == "kernel"
                and fault[2] == block and order > 0):
            outputs = dict(outputs, flux=_corrupt(outputs["flux"]))
        parity = (
            "bitwise"
            if all(_bitwise_equal(outputs[f], reference[f])
                   for f in ("position", "elem", "done", "flux"))
            and outputs["segments"] == reference["segments"]
            else "failed"
        )
        times = [secs / moves for _, secs in runs]
        metrics = walk_metrics(w, outputs["iters"] / moves,
                               outputs["segments"] / moves)
        # The launches of a timed chain (the untimed one may relaunch
        # walks whose record buffers it sized).
        launches = runs[-1][0]["launches"] / moves
        out.append(dict(
            kind="kernel",
            block=block,
            order=order,
            parity=parity,
            median_s_per_move=round(_median(times), 6),
            times_s_per_move=[round(t, 6) for t in times],
            flops=metrics["flops"],
            bytes_accessed=metrics["bytes_accessed"],
            launches_per_move=launches,
            predicted_s_per_move=round(
                predict_seconds(metrics, nominal, dispatches=launches), 9),
            segments=outputs["segments"],
        ))
    return out


def _mega_ladder(mega_moves: int) -> list[int]:
    # run_source_moves chunks at min(K, moves left): a K above the move
    # budget would run as a smaller chunk, so the ladder is clamped.
    return [k for k in MEGASTEP_LADDER if k <= mega_moves]


def _source(w: dict):
    from ..ops.source import SourceParams

    return SourceParams(default_sigma_t=1.0 / w["mean_path"], seed=w["seed"])


def _run_mega(w: dict, k: int, n_moves: int):
    """A fresh facade's ``n_moves`` device-sourced moves in chunks of K;
    returns (flux on the host, totals, seconds of the ``run_source_moves``
    call, the lanes' staging included, ``_span``'s clock)."""
    from ..api import PumiTally
    from ..utils.config import TallyConfig

    n = w["n_particles"]
    cfg = TallyConfig(dtype=w["dtype"], n_groups=w["n_groups"],
                      tolerance=1e-6, megastep=k)
    t = PumiTally(w["mesh"], n, cfg, device=w["device"])
    t.initialize_particle_location(
        w["origin_host"].astype(np.float64).reshape(-1).copy())
    _sync(w["device"])
    totals, secs = _span(w["device"], lambda: t.run_source_moves(
        n_moves, _source(w), weights=np.ones(n),
        groups=np.zeros(n, np.int32), alive=np.ones(n, bool),
    ))
    return t.flux.cpu().numpy(), totals, secs


def evaluate_megastep_axis(w: dict, *, reps: int, mega_moves: int,
                           nominal: dict, walk: dict) -> list[dict]:
    """Time and parity-gate the megastep ladder through
    ``run_source_moves``: K fused moves are bitwise the same moves at
    K = 1 on this workload. ``walk`` is the reference kernel candidate
    (its counts and launches a move)."""
    fault = _fault()
    ladder = _mega_ladder(mega_moves)
    metrics = dict(
        flops=walk["flops"] + FLIGHT_OPS_PER_LANE * w["n_particles"],
        bytes_accessed=walk["bytes_accessed"],
    )
    # The parity runs (untimed): a fresh facade each, mega_moves moves.
    parity_runs = []
    for k in ladder:
        launches = _launches()
        flux, totals, _ = _run_mega(w, k, mega_moves)
        parity_runs.append((flux, totals["segments"],
                            (_launches() - launches) / mega_moves))
    # Timed runs: the same moves again, each from a fresh facade.
    timed = _timed_in_turns([
        (lambda k=k: _run_mega(w, k, mega_moves)[1:]) for k in ladder], reps)
    out = []
    reference = parity_runs[0]  # K = 1
    for order, (k, (flux, segments, launches), runs) in enumerate(
            zip(ladder, parity_runs, timed)):
        if (fault is not None and fault[0] == "megastep" and fault[1] == k
                and order > 0):
            flux = _corrupt(flux)
        parity = (
            "bitwise"
            if _bitwise_equal(flux, reference[0]) and segments == reference[1]
            else "failed"
        )
        times = [secs / mega_moves for _, secs in runs]
        # A move's launches plus one host read a chunk, amortized over K.
        pred = predict_seconds(metrics, nominal,
                               dispatches=launches + 1.0 / k)
        out.append(dict(
            kind="megastep",
            megastep=k,
            order=order,
            parity=parity,
            median_s_per_move=round(_median(times), 6),
            times_s_per_move=[round(x, 6) for x in times],
            launches_per_move=launches,
            predicted_s_per_move=round(pred, 9),
            segments=int(reference[1] if parity == "bitwise" else -1),
        ))
    return out


def pick_winner(cands: list[dict], mode: str) -> dict | None:
    eligible = [c for c in cands if c["parity"] == "bitwise"]
    if not eligible:
        return None
    if mode == "rehearsal":
        return min(eligible,
                   key=lambda c: (c["predicted_s_per_move"], c["order"]))

    def reps(c):
        return c.get("times_s_per_move") or [c["median_s_per_move"]]

    ref = min(eligible, key=lambda c: c["order"])
    clear = [ref] + [
        c for c in eligible if c is not ref
        and max(reps(c)) < min(reps(ref))
        and c["median_s_per_move"] < ref["median_s_per_move"] * (1 - TIE_TOL)
    ]
    best = min(c["median_s_per_move"] for c in clear)
    tied = [c for c in clear
            if c["median_s_per_move"] <= best * (1.0 + TIE_TOL)]
    return min(tied, key=lambda c: c["order"])


def tune_shape_class(spec: dict, *, mode: str = "hardware", reps: int = 5,
                     moves: int = 4, mega_moves: int = 64, seed: int = 0,
                     mesh=None) -> tuple[str, dict]:
    """Search one shape class on the mode's device; returns ``(shape key,
    database entry)``. ``mesh``: a box of the spec's size already built
    on that device."""
    if reps < 1 or moves < 1 or mega_moves < 1:
        raise ValueError(f"reps, moves and mega_moves must be >= 1: "
                         f"{reps}, {moves}, {mega_moves}")
    w = build_workload(spec, moves=moves, seed=seed,
                       device=mode_device(mode), mesh=mesh)
    shape = classify(w["mesh"].ntet, w["n_particles"], w["n_groups"],
                     w["dtype"], w["packed"])
    kcands = evaluate_kernel_axis(w, reps=reps, nominal=NOMINAL_COEFFS)
    mcands = evaluate_megastep_axis(w, reps=reps, mega_moves=mega_moves,
                                    nominal=NOMINAL_COEFFS, walk=kcands[0])
    kwin = pick_winner(kcands, mode)
    mwin = pick_winner(mcands, mode)
    points = [
        dict(flops=c["flops"], bytes_accessed=c["bytes_accessed"],
             seconds=c["median_s_per_move"])
        for c in kcands if c["parity"] == "bitwise"
    ]
    entry = {
        "workload": {
            "cells": int(spec["cells"]),
            "ntet": int(w["mesh"].ntet),
            "n_particles": int(w["n_particles"]),
            "n_groups": int(w["n_groups"]),
            "dtype": shape.dtype,
            "packed": bool(w["packed"]),
            "moves": moves,
            "mega_moves": mega_moves,
            "seed": seed,
        },
        "block": int(kwin["block"]) if kwin else CANONICAL_BLOCK,
        "megastep": int(mwin["megastep"]) if mwin else 1,
        "candidates": kcands + mcands,
        "calibration": calibrate_points(points),
    }
    return shape.key(), entry


def tune(specs: dict, *, mode: str = "hardware", reps: int = 5,
         moves: int = 4, mega_moves: int = 64, seed: int = 0,
         base: dict | None = None, progress=None, meshes=None) -> dict:
    """Tune every spec and merge the entries into (a copy of) ``base``
    under the mode's environment section; entries of other shape classes
    and other sections stay. ``meshes``: {spec name: a box already built
    on the mode's device}."""
    data = json.loads(json.dumps(base)) if base else empty_db()
    if data.get("schema") != TUNING_SCHEMA:
        raise ValueError(
            f"cannot merge into schema {data.get('schema')!r} database "
            f"(this tuner writes schema {TUNING_SCHEMA})"
        )
    env = environment(mode_device(mode))
    sec = data.setdefault("environments", {}).setdefault(
        env_key(env), {"environment": env, "mode": mode, "entries": {}})
    if sec.get("environment") != env:
        raise ValueError(
            f"existing section {env_key(env)!r} pins environment "
            f"{sec.get('environment')}, current is {env}"
        )
    if sec.get("entries") and sec.get("mode") not in (None, mode):
        raise ValueError(
            f"section {env_key(env)!r} was tuned in mode "
            f"{sec.get('mode')!r}; merging {mode!r} entries would "
            "mislabel the existing ones — re-tune all shapes in one "
            "mode or start a fresh database"
        )
    sec["mode"] = mode
    for name, spec in specs.items():
        if progress:
            progress(f"tuning {name}: {spec}")
        key, entry = tune_shape_class(
            spec, mode=mode, reps=reps, moves=moves, mega_moves=mega_moves,
            seed=seed, mesh=(meshes or {}).get(name))
        entry["spec_name"] = name
        sec["entries"][key] = entry
        if progress:
            progress(f"  {key}: block={entry['block']} "
                     f"megastep={entry['megastep']}")
    return data


def winners(data: dict, env: dict | None = None) -> dict:
    """{shape key: (block, megastep)} of one environment section, the
    surface the drift check compares."""
    env = env or environment()
    sec = data.get("environments", {}).get(env_key(env), {})
    return {
        k: (e.get("block"), e.get("megastep"))
        for k, e in sorted(sec.get("entries", {}).items())
    }
