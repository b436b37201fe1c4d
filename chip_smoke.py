#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pumiumtally_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on any failed check:

1. device: the card's name and power limit from nvidia-smi;
2. build: the three CUDA sources (csrc/walk.cu, scatter.cu, gather.cu),
   one nvcc each, started together, timed;
3. kernel vs plain on a jittered 20^3 box (48,000 tets, two materials),
   65,536 lanes, 8 groups, float32 and float64, initial and move mode with
   robust=True plus one move with robust=False: elements, material ids,
   done flags and stats equal on every lane, positions within 1e-12 (f64)
   / 1e-5 (f32), flux bitwise equal (the ordered tally folds each bin in
   the plain walk's order); the robust move also through the atomic
   tally, its flux within rtol 1e-4;
4. main path: the four-call facade at the headline configuration
   (998,250-tet box, 1,048,576 particles, 8 groups, float32, the default
   ``io_pipeline="packed"``): construct, locate, 4 moves, write a .vtu.
   Launch counts are zeroed just before and read just after; the
   conservation invariant, the boundary write-backs, the .vtu and one
   transfer each way a call are checked. Each move's ordered scatter must
   take the bucket path (its largest bucket and the capacity are
   printed);
5. kernel vs plain at the main path's shapes: the inputs of the main
   path's initial search and of its first move, replayed through the
   kernel and the plain walk, compared (flux bitwise) and timed with CUDA
   events (median of 5); the ordered move is also timed in its two parts
   (walk into records, ordered scatter) and beside the atomic walk. The
   bound is the larger of two times: the bytes the walk must move (each
   distinct table row it needs once, each flux bin it scores read and
   written once, the lanes' inputs and outputs) over the HBM rate, and its
   lane iterations' operations over the FP32/FP64 rate. Each walk's
   active-lane share, Σ lane iterations / (32 · Σ warp loop trips), is
   printed beside the share one-thread-per-lane warps in launch order
   would have had (32-lane groups of the lane iterations), and the walk
   launch is timed with its lanes in the kernel's order (by start
   element, or by destination cell in the initial search; the lane-order
   pass included) and in launch order, a move's ordered scatter too.
   Move 1's records are scattered by the ordered scatter's bucket path,
   by its crowded path called directly and by ``torch.argsort`` +
   ``Tensor.index_put_(accumulate=True)``, each held bitwise to the plain
   version and timed, and the bucket path is profiled by kernel;
6. reproducibility (phase C): move 1 replayed twice through the ordered
   walk gives the same flux bits; twice through the atomic walk, each run
   held against the plain walk (lanes equal, flux within rtol 1e-4) and
   their run-to-run difference reported (the atomic walk's path: its
   launches are counted over these replays);
7. overflow (phase D): move 1 with a record capacity of 1,000 overflows,
   runs the walk again and gives the same flux bits;
8. probe path (phase A): the gather/scatter probe
   (``pumiumtally_tpu_torch.probes.gather_scatter.run``) with the main
   path's geo20 table and move 1's real records: K2 and K3 against their
   plain versions (bitwise for the gather and the ordered scatter, rtol
   1e-5 for the atomic one) at the JAX probe's shapes and the walk's,
   timed, with the library call beside them; launch counts zeroed before
   and read after. K3 outer also in float64, with and without squares, at
   the JAX probe's shapes and move 1's records; and the SASS of the
   atomic scatter and the atomic walk (cuobjdump) must hold the float32
   pair's vector reduction;
9. point source (phase E): all 1,048,576 lanes start at one point of the
   main-path mesh and fly one move; the ordered scatter of its records
   must take the crowded path; it is held bitwise against the plain
   version and timed, and its largest bin's record count reported;
10. move-loop I/O: the main path's initial search and moves 1-4 from the
   same seed under each ``io_pipeline`` mode (legacy, packed, overlap),
   twice each: once with a ``StepClock`` (each host step of every move on
   the host clock and as a stream span, and the walk's two host waits),
   once with moves 2-4 traced by torch.profiler (the card's busy share of
   their host time). Write-backs and raw flux must be bitwise equal
   across all runs; a packed or overlap move must make 1 host→device and
   1 device→host transfer, a legacy move 4 and 1; every run launches the
   walk 5 times and the bucket scatter 4 times. Segments/s of moves 2-4
   per mode;
11. pipeline: 4 independent batches of 1,048,576 lanes through
   ``StreamingTallyPipeline`` at depth 1 and 2, flux and positions
   bitwise equal to sequential ``walk_cuda.trace``; batches/s beside the
   sequential walk's, the submit calls' host times, and the busy share.

The last two lines of standard output are the card line and the result
JSON; before them one line carries the ``kernels`` JSON.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM, float32 outside the tensor cores
FP64_FLOPS = 34e12             # H100 SXM, float64 outside the tensor cores
# Floating-point operations per lane iteration of the walk, counted from
# csrc/walk.cu: 4 faces x (denominator 5, numerator 6, division 1), the
# ray norm 6, tolerance 2, crossing point 6, score 4, escalated bump 14.
FLOPS_PER_ITER = 4 * 12 + 6 + 2 + 6 + 4 + 14
# Per-lane bytes read once and written once by one walk launch.
LANE_IN = {4: 12 + 12 + 4 + 1 + 4 + 4, 8: 24 + 24 + 4 + 1 + 8 + 4}
LANE_OUT = {4: 12 + 4 + 4 + 1 + 4 + 16, 8: 24 + 4 + 4 + 1 + 8 + 16}

# Where and at what size the phases run (a CPU rehearsal at a tiny size
# may override these; the run on the card uses them as they are).
DEVICE = "cuda"
SMALL_CELLS, SMALL_LANES = 20, 65536
MAIN_CELLS, MAIN_PARTICLES, MAIN_GROUPS = 55, 1048576, 8
OVERFLOW_CAPACITY = 1000
SOURCES = ("walk", "scatter", "gather")
WARP = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def event_ms(fn, reps: int = 5, setup=None) -> float:
    """Median over ``reps`` of one call's device time (CUDA events)."""
    times = []
    for _ in range(reps):
        args = setup() if setup is not None else ()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare(k, p, dtype, pos_tol, flux_rtol, label: str) -> dict:
    """Hold a kernel TraceResult against the plain one; raises on a
    mismatch. ``flux_rtol`` 0 asks for bitwise equal flux. Returns the
    error summary."""
    differ = (
        (k.elem != p.elem) | (k.material_id != p.material_id)
        | (k.done != p.done)
    )
    n_differ = int(differ.sum())
    pos_err = float((k.position - p.position).abs().max())
    fk, fp = k.flux.double(), p.flux.double()
    flux_abs = float((fk - fp).abs().max())
    denom = torch.maximum(fk.abs(), fp.abs())
    rel = (fk - fp).abs() / torch.where(denom > 0, denom, 1.0)
    flux_rel = float(rel.max())
    flux_bitwise = bool(torch.equal(k.flux, p.flux))
    stats_equal = bool(torch.equal(k.stats, p.stats))
    iters_equal = bool(torch.equal(k.lane_iters, p.lane_iters))
    log(
        f"[compare] {label}: lanes whose path differs={n_differ} "
        f"max|dpos|={pos_err:.3e} (tol {pos_tol:g}) "
        f"max flux rel={flux_rel:.3e} (rtol {flux_rtol:g}) "
        f"flux bitwise equal={flux_bitwise} "
        f"stats equal={stats_equal} stats={k.stats.tolist()}"
    )
    if n_differ or not stats_equal or not iters_equal:
        raise AssertionError(f"{label}: kernel and plain walk disagree")
    if not pos_err <= pos_tol:
        raise AssertionError(f"{label}: positions differ by {pos_err}")
    if not (flux_bitwise if flux_rtol == 0 else flux_rel <= flux_rtol):
        raise AssertionError(f"{label}: flux differs by rel {flux_rel}")
    return {"max_abs_err": max(pos_err, flux_abs)}


def jittered_box(nx: int, jitter: float, seed: int, dtype):
    from pumiumtally_tpu_torch.mesh.box import build_box_arrays
    from pumiumtally_tpu_torch.mesh.core import TetMesh

    coords, tets = build_box_arrays(1.0, 1.0, 1.0, nx, nx, nx)
    rng = np.random.default_rng(seed)
    interior = (coords > 1e-9).all(axis=1) & (coords < 1 - 1e-9).all(axis=1)
    coords = coords.copy()
    coords[interior] += rng.uniform(
        -jitter / nx, jitter / nx, (interior.sum(), 3)
    )
    cid = (coords[tets].mean(axis=1)[:, 0] > 0.5).astype(np.int32)
    return TetMesh.from_numpy(coords, tets, cid, dtype=dtype, device=DEVICE)


def phase_kernel_vs_plain_small() -> None:
    from pumiumtally_tpu_torch.ops import walk, walk_cuda

    n, G = SMALL_LANES, 8
    for dtype, pos_tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        mesh = jittered_box(SMALL_CELLS, 0.2, 0, dtype)
        rng = np.random.default_rng(0)
        dev = mesh.device

        def t(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

        weight = t(rng.uniform(0.5, 2.0, n), dtype)
        group = rng.integers(0, G, n).astype(np.int32)
        group[rng.uniform(size=n) < 0.01] = G  # out of range: scores nothing
        group = t(group, torch.int32)
        mat = torch.full((n,), -1, dtype=torch.int32, device=dev)
        flux0 = torch.zeros(mesh.ntet * G * 2, dtype=dtype, device=dev)
        kw = dict(max_crossings=mesh.ntet + 64, n_groups=G)

        # Initial mode: every lane from element 0's centroid.
        origin = mesh.centroids()[0].expand(n, 3).contiguous()
        elem = torch.zeros(n, dtype=torch.int32, device=dev)
        src = t(rng.uniform(0.02, 0.98, (n, 3)), dtype)
        fly = torch.ones(n, dtype=torch.bool, device=dev)
        args = (mesh, origin, src, elem, fly, weight, group, mat)
        k = walk_cuda.trace(*args, flux0.clone(), initial=True, **kw)
        p = walk.trace(*args, flux0.clone(), initial=True, **kw)
        compare(k, p, dtype, pos_tol, 0.0, f"{dtype} initial robust")

        # Move mode from the located positions, some lanes leaving.
        direction = rng.normal(size=(n, 3))
        direction /= np.linalg.norm(direction, axis=1, keepdims=True)
        length = rng.exponential(0.15, (n, 1))
        origin, elem = p.position, p.elem
        dest = t(origin.double().cpu().numpy() + direction * length, dtype)
        fly = t(rng.uniform(size=n) > 0.05, torch.bool)
        args = (mesh, origin, dest, elem, fly, weight, group, mat)
        for robust in (True, False):
            k = walk_cuda.trace(*args, flux0.clone(), initial=False,
                                robust=robust, **kw)
            p = walk.trace(*args, flux0.clone(), initial=False,
                           robust=robust, **kw)
            compare(k, p, dtype, pos_tol, 0.0,
                    f"{dtype} move robust={robust}")
            if robust:
                a = walk_cuda.trace(*args, flux0.clone(), initial=False,
                                    tally="atomic", **kw)
                compare(a, p, dtype, pos_tol, 1e-4, f"{dtype} move atomic")
        torch.cuda.synchronize()


def phase_main_path(tmpdir: str):
    """The four calls at the headline configuration. Returns the tally,
    snapshots of the inputs of the initial search and of the first move
    (for the replay of phase 5), and the kernel launches counted."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
    from pumiumtally_tpu_torch.ops import scatter

    cells, n, G = MAIN_CELLS, MAIN_PARTICLES, MAIN_GROUPS
    rng = np.random.default_rng(1)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    mesh = build_box(1.0, 1.0, 1.0, cells, cells, cells, device=DEVICE)
    tally = PumiTally(mesh, n, TallyConfig(n_groups=G), device=DEVICE)
    torch.cuda.synchronize()
    log(f"[main] construct: {time.perf_counter() - t0:.3f} s "
        f"(ntet={mesh.ntet}, particles={n}, groups={G})")
    if mesh.ntet != 6 * cells ** 3:
        raise AssertionError(f"mesh has {mesh.ntet} tets")

    pos = rng.uniform(0.05, 0.95, (n, 3))
    snaps = {"initial": _snapshot(tally, pos, tally.state.group.cpu().numpy())}
    t0 = time.perf_counter()
    tally.initialize_particle_location(pos.reshape(-1))
    torch.cuda.synchronize()
    log(f"[main] initialize_particle_location: "
        f"{time.perf_counter() - t0:.3f} s, stats {tally.last_stats}")
    if tally.last_stats["truncated"]:
        raise AssertionError("initial search truncated")

    prev = pos.copy()
    path = 0.0
    late_segs, late_secs = 0, 0.0
    for move in range(1, 5):
        direction = rng.normal(size=(n, 3))
        direction /= np.linalg.norm(direction, axis=1, keepdims=True)
        length = rng.exponential(0.08, (n, 1))
        want = prev + direction * length
        dest = want.reshape(-1).copy()
        flying = np.ones(n, np.int8)
        weights = np.ones(n)
        groups = rng.integers(0, G, n).astype(np.int32)
        mats = np.zeros(n, np.int32)
        if move == 1:
            snaps["move"] = _snapshot(tally, want, groups)
        paths = (scatter.BUCKET_LAUNCHES, scatter.CROWDED_LAUNCHES)
        t0 = time.perf_counter()
        tally.move_to_next_location(dest, flying, weights, groups, mats)
        secs = time.perf_counter() - t0
        st = tally.last_stats
        took = (scatter.BUCKET_LAUNCHES - paths[0],
                scatter.CROWDED_LAUNCHES - paths[1])
        log(f"[main] move {move}: ordered scatter took the "
            f"{scatter.LAST_BUCKETS['path']} path (bucket, crowded calls "
            f"{took}); {scatter.LAST_BUCKETS}")
        final = dest.reshape(n, 3)
        if flying.any():
            raise AssertionError(f"move {move}: flying not reset")
        outside = ((want < 0) | (want > 1)).any(axis=1)
        on_bound = (np.minimum(final, 1 - final).min(axis=1) <= 1e-5)
        if not (mats[outside] == -1).all() or not on_bound[outside].all():
            raise AssertionError(
                f"move {move}: a lane that left the domain is not on the "
                "boundary with material id -1"
            )
        reach = np.abs(final[~outside] - want[~outside]).max()
        if not reach <= 1e-5 or not (mats == -1).all():
            raise AssertionError(
                f"move {move}: inside destinations not reached ({reach})"
            )
        if st["truncated"]:
            raise AssertionError(f"move {move}: truncated walks")
        path += float(np.linalg.norm(final - prev, axis=1).sum())
        prev = final.copy()
        if move >= 2:
            late_segs += st["segments"]
            late_secs += secs
        log(f"[main] move {move}: {secs:.4f} s, segments={st['segments']}, "
            f"crossings={st['crossings']}, loop_iters={st['loop_iters']}, "
            f"segments/s={st['segments'] / secs:.4e}, "
            f"left domain={int(outside.sum())}")

    log(f"[main] moves 2-4: {late_segs} segments in {late_secs:.4f} s, "
        f"segments/s={late_segs / late_secs:.4e}")

    scored = float(tally.raw_flux[..., 0].astype(np.float64).sum())
    rel = abs(scored - path) / path
    log(f"[main] conservation: flux sum {scored:.9e} vs path {path:.9e}, "
        f"rel {rel:.3e} (limit 1e-4)")
    if not rel <= 1e-4:
        raise AssertionError("conservation invariant violated")

    out = os.path.join(tmpdir, "fluxresult.vtu")
    t0 = time.perf_counter()
    tally.write_pumi_tally_mesh(out)
    log(f"[main] write_pumi_tally_mesh: {time.perf_counter() - t0:.3f} s, "
        f"{os.path.getsize(out)} bytes")
    torch.cuda.synchronize()
    launches = read_counts()
    with open(out) as f:
        head = f.read(4096)
    cells_m = re.search(r'NumberOfCells="(\d+)"', head)
    if cells_m is None or int(cells_m.group(1)) != mesh.ntet:
        raise AssertionError(".vtu does not hold the mesh's cells")
    log(f"[main] times: init {tally.tally_times.initialization_time:.3f} s, "
        f"tally {tally.tally_times.total_time_to_tally:.3f} s, "
        f"vtk {tally.tally_times.vtk_file_write_time:.3f} s; "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} bytes")
    log(f"[main] launches: {launches}; transfers {tally.io}")
    if (tally.io["h2d_transfers"], tally.io["d2h_transfers"]) != (5, 5):
        raise AssertionError("the packed facade did not make one transfer "
                             "each way a call")
    if launches["walk"] != 5 + launches["walk_relaunches"]:
        raise AssertionError(f"walk kernel launches {launches}: not 5 "
                             "walks and their relaunches")
    if launches["lane_order"] != 5:
        raise AssertionError("the lanes were not ordered once a walk")
    if launches["scatter_ordered"] != 4:
        raise AssertionError("the ordered scatter did not run once a move")
    if launches["scatter_bucket"] != 4 or launches["scatter_crowded"]:
        raise AssertionError("a move's ordered scatter left the bucket path")
    if launches["scatter_atomic"] or launches["gather"]:
        raise AssertionError("the facade launched a probe kernel")
    return tally, snaps, launches


def main_move_inputs(rng, n: int, G: int, prev: np.ndarray):
    """One main-path move's destinations (isotropic flights of mean 0.08
    from ``prev``) and groups."""
    direction = rng.normal(size=(n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    want = prev + direction * rng.exponential(0.08, (n, 1))
    return want, rng.integers(0, G, n).astype(np.int32)


def io_run(mesh, mode: str, *, clocked: bool, profiled: bool) -> dict:
    """The main-path cell's initial search and moves 1-4 under one
    ``io_pipeline`` mode, from numpy seed 1 (the main path's inputs).
    ``clocked`` times each host step of every move (``StepClock``: host
    clock and stream span) and the host waits inside the walk;
    ``profiled`` traces moves 2-4 with torch.profiler for the card's busy
    share. Returns the write-backs, the flux, the per-move host seconds,
    segments, transfers and step rows, and the launches counted."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.ops import scatter, walk_cuda
    from pumiumtally_tpu_torch.utils.timing import StepClock

    n, G = MAIN_PARTICLES, MAIN_GROUPS
    rng = np.random.default_rng(1)
    tally = PumiTally(mesh, n, TallyConfig(n_groups=G, io_pipeline=mode),
                      device=DEVICE)
    pos = rng.uniform(0.05, 0.95, (n, 3))
    torch.cuda.synchronize()
    zero_counts()
    tally.initialize_particle_location(pos.reshape(-1))
    if clocked:
        tally.step_clock = StepClock(DEVICE)
    prev, outs, moves, prof = pos, [], [], None
    for move in range(1, 5):
        want, groups = main_move_inputs(rng, n, G, prev)
        dest = want.reshape(-1).copy()
        mats = np.zeros(n, np.int32)
        io0 = dict(tally.io)
        if profiled and move == 2:
            prof = start_profile()
        t0 = time.perf_counter()
        tally.move_to_next_location(dest, np.ones(n, np.int8), np.ones(n),
                                    groups, mats)
        secs = time.perf_counter() - t0
        row = dict(move=move, secs=secs,
                   segments=tally.last_stats["segments"],
                   io={k: tally.io[k] - io0[k] for k in io0})
        if clocked:
            row["steps"] = tally.step_clock.rows()
            row["count_wait_ms"] = walk_cuda.LAST_WAIT_S * 1e3
            row["bucket_wait_ms"] = scatter.LAST_BUCKETS.get(
                "wait_s", float("nan")) * 1e3
        moves.append(row)
        outs.append((dest.copy(), mats.copy()))
        prev = dest.reshape(n, 3).copy()
    busy = (stop_profile(prof, 3, sum(m["secs"] for m in moves[1:]))
            if profiled else None)
    torch.cuda.synchronize()
    return dict(mode=mode, outs=outs, flux=tally.raw_flux, moves=moves,
                busy=busy, launches=read_counts())


def start_profile():
    """A torch.profiler session tracing the card's activity only (kernels
    and copies, CUPTI), so the host runs untraced."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop_profile(prof, calls: int, host_s: float) -> dict:
    """Stop a ``start_profile`` session after ``calls`` calls that took
    ``host_s`` seconds on the host clock: per call, the card's busy time
    (the device events only: kernels, copies and fills), its copies'
    part, the host time, and the busy share of the host time."""
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    rows = device_rows(prof)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    copies = sum(e.self_device_time_total for e in rows
                 if e.key.startswith(("Memcpy", "Memset"))) / 1e6
    return dict(busy_ms=busy / calls * 1e3, copy_ms=copies / calls * 1e3,
                span_ms=host_s / calls * 1e3, share=busy / host_s,
                kernel_share=(busy - copies) / host_s,
                top=[(e.key[:60], e.self_device_time_total / calls / 1e3)
                     for e in sorted(rows, key=lambda e:
                                     -e.self_device_time_total)[:8]])


def print_io_run(run: dict) -> None:
    """A run's moves (host clock, segments, transfers), segments/s of
    moves 2-4 and, when profiled, the card's busy share and its kernels."""
    mode, tag = run["mode"], "profiled" if run["busy"] else "clocked"
    for m in run["moves"]:
        log(f"[io] {mode} ({tag}) move {m['move']}: {m['secs'] * 1e3:.4f} ms "
            f"host clock, segments {m['segments']}, transfers {m['io']}")
    late = run["moves"][1:]
    segs, secs = sum(m["segments"] for m in late), sum(m["secs"] for m in late)
    run["segments_per_s"] = segs / secs
    log(f"[io] {mode} ({tag}) moves 2-4: {segs} segments in {secs:.4f} s, "
        f"segments/s={segs / secs:.4e}")
    if run["busy"] is not None:
        b = run["busy"]
        log(f"[io] {mode} moves 2-4 profiled, per move: card busy "
            f"{b['busy_ms']:.4f} ms (copies {b['copy_ms']:.4f} ms) of "
            f"{b['span_ms']:.4f} ms on the host clock, busy share "
            f"{b['share']:.4f} (kernels alone {b['kernel_share']:.4f})")
        for key, ms in b["top"]:
            log(f"[io]   {ms:9.4f} ms {key}")


def print_step_table(label: str, moves: list) -> None:
    """Median, least and most of each host step (host clock and stream
    span) over ``moves``, which carry StepClock rows, in step order."""
    steps: dict = {}
    for m in moves:
        for r in m["steps"]:
            steps.setdefault(r["step"], []).append(r)
        for key in ("count_wait_ms", "bucket_wait_ms"):
            if key in m:
                steps.setdefault(f"  {key[:-3]}", []).append(
                    {"host_ms": m[key], "stream_ms": None})
    for name, rows in steps.items():
        host = np.array([r["host_ms"] for r in rows])
        span = [r["stream_ms"] for r in rows if r["stream_ms"] is not None]
        stream = (f"; stream span median {np.median(span):.4f} ms"
                  if span else "")
        log(f"[io] {label} {name:<16} host median {np.median(host):.4f} ms "
            f"(least {host.min():.4f}, most {host.max():.4f}, "
            f"{len(host)} samples){stream}")


IO_MODES = ("legacy", "packed", "overlap")
# The clocked runs, in turns, so that each mode meets the host's drift.
IO_TURNS = ("legacy", "packed", "overlap", "overlap", "packed", "legacy")
PIPE_BATCHES = 4


def phase_io(mesh) -> dict:
    """The main-path cell under each ``io_pipeline`` mode: clocked runs in
    turns (``IO_TURNS``: per-step host table over moves 2-4 of both turns,
    segments/s of moves 2-4) and one profiled run a mode (busy share of
    moves 2-4). Every run's write-backs and flux must be bitwise equal to
    the first's."""
    runs: dict = {m: [] for m in IO_MODES}
    ref = None
    for mode, clocked in ([(m, True) for m in IO_TURNS]
                          + [(m, False) for m in IO_MODES]):
        run = io_run(mesh, mode, clocked=clocked, profiled=not clocked)
        print_io_run(run)
        outs, flux = run.pop("outs"), run.pop("flux")
        if ref is None:
            ref = dict(mode=mode, outs=outs, flux=flux)
        for k, ((d, m), (d0, m0)) in enumerate(zip(outs, ref["outs"]), 1):
            if not (np.array_equal(d, d0) and np.array_equal(m, m0)):
                raise AssertionError(f"{mode}: move {k}'s write-backs "
                                     f"differ from {ref['mode']}'s")
        if not np.array_equal(flux, ref["flux"]):
            raise AssertionError(f"{mode}: flux differs from "
                                 f"{ref['mode']}'s")
        want = (4, 1) if mode == "legacy" else (1, 1)
        for m in run["moves"]:
            got = (m["io"]["h2d_transfers"], m["io"]["d2h_transfers"])
            if got != want:
                raise AssertionError(f"{mode} move {m['move']}: "
                                     f"transfers {got}, not {want}")
        la = run["launches"]
        if la["walk"] != 5 or la["scatter_bucket"] != 4:
            raise AssertionError(f"{mode}: launches {la}")
        runs[mode].append(run)
    out = {}
    for mode in IO_MODES:
        clocked = [r for r in runs[mode] if r["busy"] is None]
        print_step_table(f"{mode} moves 2-4",
                         [m for r in clocked for m in r["moves"][1:]])
        print_step_table(f"{mode} move 1",
                         [r["moves"][0] for r in clocked])
        rates = [r["segments_per_s"] for r in clocked]
        busy = [r["busy"] for r in runs[mode] if r["busy"]][0]
        out[mode] = dict(segments_per_s=rates, busy=busy,
                         launches=clocked[0]["launches"])
        log(f"[io] {mode}: moves 2-4 segments/s in turns "
            f"{', '.join(f'{x:.4e}' for x in rates)}; busy share "
            f"{busy['share']:.4f}; write-backs and flux bitwise equal to "
            f"{ref['mode']}'s; launches {clocked[0]['launches']}")
    return out


def pipeline_batches(mesh, n: int, G: int) -> list:
    """Independent batches at the main path's cell (numpy seed 11): lanes
    start at the centroids of random elements and fly isotropically (mean
    0.08), unit weights, random groups."""
    rng = np.random.default_rng(11)
    cent = mesh.centroids().double().cpu().numpy()
    out = []
    for _ in range(PIPE_BATCHES):
        elem = rng.integers(0, mesh.ntet, n).astype(np.int32)
        want, group = main_move_inputs(rng, n, G, cent[elem])
        out.append((cent[elem], want, elem, group))
    return out


def walk_batch(mesh, cfg, batch, flux, capacity=None):
    """One batch through ``walk_cuda.trace`` with pageable copies in and
    out (the outputs a pipeline batch reads back: positions, elements,
    material ids, stats): the pipeline's sequential reference. Returns the
    positions."""
    from pumiumtally_tpu_torch.ops import walk_cuda

    origin, dest, elem, group = batch
    n, dev, dt = len(elem), mesh.device, cfg.dtype
    r = walk_cuda.trace(
        mesh, torch.from_numpy(origin).to(dev, dt),
        torch.from_numpy(dest).to(dev, dt), torch.from_numpy(elem).to(dev),
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.ones(n, dtype=dt, device=dev), torch.from_numpy(group).to(dev),
        torch.full((n,), -1, dtype=torch.int32, device=dev), flux,
        initial=False, max_crossings=cfg.resolve_max_crossings(mesh.ntet),
        n_groups=cfg.n_groups, tolerance=cfg.tolerance, capacity=capacity,
    )
    r.elem.cpu(), r.material_id.cpu(), r.stats.cpu()
    return r.position.cpu().numpy()


def phase_pipeline(mesh) -> dict:
    """``PIPE_BATCHES`` independent batches of the main-path width through
    ``StreamingTallyPipeline`` at depth 1 and 2, each held bitwise (flux
    and every batch's positions) to the same batches through sequential
    ``walk_cuda.trace``; batches per second on the host clock (the
    sequential walk with pageable copies beside them) and, from a second,
    profiled run, the card's busy share."""
    from pumiumtally_tpu_torch import TallyConfig
    from pumiumtally_tpu_torch.models.pipeline import StreamingTallyPipeline
    from pumiumtally_tpu_torch.ops import walk_cuda
    from pumiumtally_tpu_torch.utils.timing import StepClock

    cfg = TallyConfig(n_groups=MAIN_GROUPS)
    n = MAIN_PARTICLES
    batches = pipeline_batches(mesh, n, cfg.n_groups)
    ref = torch.zeros(mesh.ntet * cfg.n_groups * 2, dtype=cfg.dtype,
                      device=mesh.device)
    ref_pos = [walk_batch(mesh, cfg, b, ref) for b in batches]
    cap = walk_cuda.record_capacity(n, max(
        walk_cuda.path_records(walk_cuda.face_rate(mesh), b[0], b[1],
                               np.ones(n, bool)) for b in batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = torch.zeros_like(ref)
    for b in batches:
        walk_batch(mesh, cfg, b, seq, capacity=cap)
    seq.cpu()
    seq_s = time.perf_counter() - t0
    log(f"[pipe] sequential walk_cuda.trace with pageable copies (the flux "
        f"read back at the end, as finish() does): {PIPE_BATCHES} batches "
        f"of {n} lanes in {seq_s:.4f} s, {PIPE_BATCHES / seq_s:.4f} "
        "batches/s")
    out = {"sequential_batches_per_s": PIPE_BATCHES / seq_s}
    for depth in (1, 2):
        # The warm-up run fills the caching allocators (pinned host
        # buffers, device blocks), so the timed runs see the steady state
        # a long stream of batches runs in.
        for run in ("warm-up", "clocked", "profiled"):
            zero_counts()
            torch.cuda.synchronize()
            prof = start_profile() if run == "profiled" else None
            t0 = time.perf_counter()
            pipe = StreamingTallyPipeline(mesh, cfg, depth=depth)
            if run == "clocked":
                pipe.step_clock = StepClock(DEVICE)
            submit_s = []
            for origin, dest, elem, group in batches:
                t1 = time.perf_counter()
                pipe.submit(origin, dest, elem, group=group)
                submit_s.append(time.perf_counter() - t1)
            flux = pipe.finish()
            secs = time.perf_counter() - t0
            got = list(pipe.results())
            launches = read_counts()
            if not np.array_equal(flux.reshape(-1), ref.cpu().numpy()):
                raise AssertionError(f"pipeline depth {depth}: flux differs "
                                     "from sequential walk_cuda.trace")
            if [b.index for b in got] != list(range(PIPE_BATCHES)):
                raise AssertionError(f"pipeline depth {depth}: results out "
                                     "of order")
            for b, want in zip(got, ref_pos):
                if not (np.array_equal(b.position, want) and b.all_done):
                    raise AssertionError(f"pipeline depth {depth}: batch "
                                         f"{b.index}'s positions differ")
            if (launches["walk"] != PIPE_BATCHES + launches["walk_relaunches"]
                    or launches["scatter_bucket"] != PIPE_BATCHES):
                raise AssertionError(f"pipeline depth {depth}: launches "
                                     f"{launches}")
            if run == "profiled":
                b = stop_profile(prof, PIPE_BATCHES, secs)
                log(f"[pipe] depth {depth} profiled, per batch: card busy "
                    f"{b['busy_ms']:.4f} ms (copies {b['copy_ms']:.4f} ms) "
                    f"of {b['span_ms']:.4f} ms on the host clock, busy share "
                    f"{b['share']:.4f} (kernels alone "
                    f"{b['kernel_share']:.4f})")
                for key, ms in b["top"]:
                    log(f"[pipe]   {ms:9.4f} ms {key}")
                out[f"depth{depth}_busy"] = b
                continue
            log(f"[pipe] depth {depth} {run}: {PIPE_BATCHES} batches in "
                f"{secs:.4f} s, {PIPE_BATCHES / secs:.4f} batches/s; submit "
                f"calls {[round(x * 1e3, 4) for x in submit_s]} ms; flux and "
                f"positions bitwise equal to sequential walk_cuda.trace; "
                f"launches {launches}")
            if run == "warm-up":
                continue
            rows = pipe.step_clock.rows()
            for r in rows:
                span = ("" if r["stream_ms"] is None
                        else f", stream span {r['stream_ms']:.4f} ms")
                log(f"[pipe]   depth {depth} {r['step']:<9} host "
                    f"{r['host_ms']:.4f} ms{span}")
            flux_s = sum(r["host_ms"] for r in rows
                         if r["step"] == "flux") / 1e3
            out[f"depth{depth}_batches_per_s"] = PIPE_BATCHES / secs
            out[f"depth{depth}_launches"] = launches
            steady = (PIPE_BATCHES - 1) / sum(submit_s[1:])
            out[f"depth{depth}_steady_submits_per_s"] = steady
            log(f"[pipe] depth {depth}: {PIPE_BATCHES / secs:.4f} batches/s "
                f"with finish()'s flux copy ({flux_s * 1e3:.4f} ms), "
                f"{PIPE_BATCHES / (secs - flux_s):.4f} without it; submits "
                f"2-{PIPE_BATCHES} (past the first batch's set-up) "
                f"{steady:.4f} a second")
    return out


def zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from pumiumtally_tpu_torch.ops import gather, scatter, walk_cuda

    walk_cuda.LAUNCHES = walk_cuda.RELAUNCHES = 0
    scatter.ATOMIC_LAUNCHES = scatter.ORDERED_LAUNCHES = 0
    scatter.ORDER_LAUNCHES = 0
    scatter.BUCKET_LAUNCHES = scatter.CROWDED_LAUNCHES = 0
    gather.LAUNCHES = 0


def read_counts() -> dict:
    from pumiumtally_tpu_torch.ops import gather, scatter, walk_cuda

    return {
        "walk": walk_cuda.LAUNCHES,
        "walk_relaunches": walk_cuda.RELAUNCHES,
        "scatter_ordered": scatter.ORDERED_LAUNCHES,
        "scatter_bucket": scatter.BUCKET_LAUNCHES,
        "scatter_crowded": scatter.CROWDED_LAUNCHES,
        "scatter_atomic": scatter.ATOMIC_LAUNCHES,
        "lane_order": scatter.ORDER_LAUNCHES,
        "gather": gather.LAUNCHES,
    }


def _snapshot(tally, dest: np.ndarray, groups: np.ndarray) -> dict:
    """The walk inputs a facade call is about to use (unit weights, all
    lanes flying, as the main path drives them)."""
    s = tally.state
    return dict(
        origin=s.origin.clone(), elem=s.elem.clone(),
        material_id=s.material_id.clone(), flux=tally.flux.clone(),
        dest=np.array(dest, copy=True), groups=np.array(groups, copy=True),
    )


def touched(mesh, args, kw, end_elem, scores: bool) -> tuple[int, int]:
    """Distinct geo20 rows and flux bins one walk cannot avoid: the rows of
    the start and end elements and of every element a segment scored in,
    and (when the walk scores) the (element, group) bins it adds to. The
    scored elements come from a probe launch with unit weights into a zero
    flux; rows only chased through are left out, so the count is a lower
    bound."""
    from pumiumtally_tpu_torch.ops import walk_cuda

    origin, elem, weight = args[1], args[3], args[5]
    probe = walk_cuda.trace(
        *args[:5], torch.ones_like(weight), *args[6:],
        torch.zeros(mesh.ntet * kw["n_groups"] * 2, dtype=origin.dtype,
                    device=origin.device),
        **kw,
    )
    hit = probe.flux.view(mesh.ntet, kw["n_groups"], 2)[..., 0] > 0
    rows = hit.any(dim=1)
    rows[elem.long()] = True
    rows[end_elem.long()] = True
    return int(rows.sum()), (int(hit.sum()) if scores else 0)


def replay_args(tally, snap, initial: bool):
    """The walk arguments of a snapshotted main-path call (without the
    flux) and its keywords."""
    mesh, cfg = tally.mesh, tally.config
    dev, dtype = mesh.device, cfg.dtype
    n = tally.num_particles
    dest = torch.from_numpy(snap["dest"]).to(dev, dtype)
    fly = torch.ones(n, dtype=torch.bool, device=dev)
    weight = torch.ones(n, dtype=dtype, device=dev)
    if initial:  # the facade walks its zero-initialized weights
        weight = torch.zeros(n, dtype=dtype, device=dev)
    group = torch.from_numpy(snap["groups"]).to(dev, torch.int32)
    args = (mesh, snap["origin"], dest, snap["elem"], fly, weight, group,
            snap["material_id"])
    kw = dict(initial=initial, max_crossings=tally._max_crossings,
              n_groups=cfg.n_groups, tolerance=cfg.tolerance)
    return args, kw


def phase_kernel_vs_plain_full(tally, snap, initial: bool) -> dict:
    """Replay one main-path walk (the initial search or the first move)
    through the kernel and the plain walk: compare, then time both. The
    move is also timed in its parts and with the atomic tally; its plain
    result, its records and a record capacity that holds them are returned
    for the later phases."""
    from pumiumtally_tpu_torch.ops import scatter, walk, walk_cuda

    mesh, dtype = tally.mesh, tally.config.dtype
    n = tally.num_particles
    args, kw = replay_args(tally, snap, initial)
    label = "initial search" if initial else "move 1"
    k = walk_cuda.trace(*args, snap["flux"].clone(), **kw)
    trips = int(walk_cuda.WARP_TRIPS)
    p = walk.trace(*args, snap["flux"].clone(), **kw)
    err = compare(k, p, dtype, 1e-5, 0.0, f"main-path {label} ({dtype})")
    # Buffers for every record (at most one per segment), so the timed
    # calls never run the walk again.
    cap = {} if initial else {"capacity": int(k.n_segments)}
    share = active_share(k.lane_iters, trips)
    runs = walk_orders(args, snap["flux"], kw, cap.get("capacity", 0))
    resident = walk_cuda.resident_threads(dtype, initial=initial)
    log(f"[share] {label}: active-lane share {share:.4f} (Σ lane "
        f"iterations / (32 · {trips} warp trips), {resident} resident "
        f"threads); one thread per lane in launch order (the earlier "
        f"design, 32-lane groups): {launch_order_share(k.lane_iters):.4f}")
    by = "destination cell" if initial else "start element"
    log(f"[order] {label}: walk launch with lanes by {by} "
        f"{runs['slots']['ms']:.4f} ms (lane-order pass "
        f"{runs['order_ms']:.4f} ms included, share "
        f"{runs['slots']['share']:.4f}); in launch order "
        f"{runs['launch']['ms']:.4f} ms (share "
        f"{runs['launch']['share']:.4f}); median of 5")
    if not initial:
        slot_sum = runs["slots"]["ms"] + runs["slots"]["scatter_ms"]
        launch_sum = runs["launch"]["ms"] + runs["launch"]["scatter_ms"]
        log(f"[order] {label}: ordered scatter of the records of the walk "
            f"by {by} {runs['slots']['scatter_ms']:.4f} ms, in launch "
            f"order {runs['launch']['scatter_ms']:.4f} ms; walk and "
            f"scatter {slot_sum:.4f} / {launch_sum:.4f} ms")

    def fresh():
        return (snap["flux"].clone(),)

    ms = event_ms(lambda f: walk_cuda.trace(*args, f, **kw, **cap), 5, fresh)
    plain_ms = event_ms(lambda f: walk.trace(*args, f, **kw), 5, fresh)
    out = {}
    if not initial:
        wkw = {key: v for key, v in kw.items() if key != "initial"}
        _, rec = walk_cuda.walk_records(*args, snap["flux"].clone(), **wkw,
                                        **cap)
        nbins = mesh.ntet * kw["n_groups"]
        out = dict(
            walk_ms=event_ms(
                lambda f: walk_cuda.walk_records(*args, f, **wkw, **cap), 5,
                fresh),
            atomic_ms=event_ms(
                lambda f: walk_cuda.trace(*args, f, **kw, tally="atomic"), 5,
                fresh),
            records=rec, plain=p, **cap,
            **scatter_paths(snap["flux"], rec, nbins),
        )
        profile_call("ordered move 1",
                     lambda: walk_cuda.trace(*args, snap["flux"].clone(),
                                             **kw, **cap))
        log(f"[kernel] move 1 ordered = walk into {rec.bin.numel()} records "
            f"{out['walk_ms']:.4f} ms + ordered scatter "
            f"{out['scatter_ms']:.4f} ms (whole call {ms:.4f} ms); atomic "
            f"walk {out['atomic_ms']:.4f} ms")
    item = torch.finfo(dtype).bits // 8
    rows = int(k.lane_iters.sum(dtype=torch.int64))
    segs = int(k.n_segments)
    table_rows, bins = touched(mesh, args, dict(kw, **cap), k.elem,
                               scores=not initial)
    nbytes = table_rows * 20 * item + bins * 2 * 2 * item + n * (
        LANE_IN[item] + LANE_OUT[item]
    )
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * FLOPS_PER_ITER / (
        FP32_FLOPS if item == 4 else FP64_FLOPS
    ) * 1e3
    log(f"[kernel] walk, main-path {label}: {ms:.4f} ms (median of 5), "
        f"plain {plain_ms:.4f} ms; lane iterations (row reads) {rows}, "
        f"their bytes {rows * 20 * item}, segments {segs}; distinct rows "
        f"{table_rows}, flux bins written {bins}, bytes that must move "
        f"{nbytes}, bytes bound {bytes_ms:.4f} ms, operations bound "
        f"{ops_ms:.4f} ms")
    if initial:
        profile_call("initial search",
                     lambda: walk_cuda.trace(*args, snap["flux"].clone(),
                                             **kw))
    return dict(
        ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        max_abs_err=err["max_abs_err"], share=share,
        launch_order_share=launch_order_share(k.lane_iters),
        slot_order_ms=runs["slots"]["ms"],
        launch_order_ms=runs["launch"]["ms"], **out,
    )


def scatter_paths(flux0, rec, nbins: int) -> dict:
    """Move 1's records through the ordered scatter's bucket path (the
    wrapper the walk calls), its crowded path called directly, and
    ``torch.argsort`` + ``Tensor.index_put_(accumulate=True)``: each held
    bitwise to the plain version, then timed in turns (CUDA events,
    median of 5); the bucket path's calls profiled by kernel."""
    from pumiumtally_tpu_torch.ops import scatter
    from pumiumtally_tpu_torch.probes.gather_scatter import library_ordered

    def bucket(f):
        return scatter.ordered_cuda(f, rec.bin, rec.order, rec.c, True, nbins)

    def crowded(f):
        return scatter.crowded_cuda(f, rec.bin, rec.order, rec.c, True, nbins)

    def library(f):
        return library_ordered(f, rec.bin, rec.order, rec.c)

    ref = scatter.scatter_ordered_plain(flux0.clone(), rec.bin, rec.order,
                                        rec.c)
    before = scatter.BUCKET_LAUNCHES
    if not torch.equal(bucket(flux0.clone()), ref):
        raise AssertionError("move 1: the bucket path differs from plain")
    if scatter.BUCKET_LAUNCHES != before + 1:
        raise AssertionError("move 1's records left the bucket path")
    info = dict(scatter.LAST_BUCKETS)
    if not torch.equal(crowded(flux0.clone()), ref):
        raise AssertionError("move 1: the crowded path differs from plain")
    lib_equal = bool(torch.equal(library(flux0.clone()), ref))

    def fresh():
        return (flux0.clone(),)

    out = {}
    for name, fn in (("scatter_ms", bucket), ("crowded_ms", crowded),
                     ("library_ms", library), ("scatter_ms_2", bucket),
                     ("crowded_ms_2", crowded)):
        out[name] = event_ms(fn, 5, fresh)
    log(f"[scatter] move 1's {rec.bin.numel()} records into {nbins} bins: "
        f"bucket path {out['scatter_ms']:.4f} / {out['scatter_ms_2']:.4f} ms "
        f"(shift {info['shift']}, {info['buckets']} buckets, largest "
        f"{info['largest']} of capacity {info['capacity']}), crowded path "
        f"{out['crowded_ms']:.4f} / {out['crowded_ms_2']:.4f} ms, "
        f"torch.argsort + index_put_(accumulate=True) "
        f"{out['library_ms']:.4f} ms (bitwise equal: {lib_equal}); median "
        "of 5 each, in turns")
    profile_call("ordered scatter of move 1, bucket path",
                 lambda: bucket(flux0.clone()))
    return dict(out, buckets=info)


def active_share(iters, trips: int) -> float:
    """Σ lane iterations over the lane slots of the warps' loop trips."""
    return int(iters.sum(dtype=torch.int64)) / (WARP * trips)


def launch_order_share(iters) -> float:
    """The active-lane share of one thread per lane, lanes in launch order:
    each 32-lane warp issues for as long as its longest lane."""
    pad = torch.nn.functional.pad(iters, (0, (-iters.numel()) % WARP))
    longest = pad.view(-1, WARP).amax(dim=1).sum(dtype=torch.int64)
    return int(iters.sum(dtype=torch.int64)) / (WARP * int(longest))


def walk_orders(args, flux0, kw, capacity: int) -> dict:
    """The walk launch alone, its lanes taken in ``lane_slots`` order (the
    lane-order pass included) and in launch order: time (median of 5) and
    active-lane share of each, and the lane-order pass alone. A move's
    records from each order are also folded by the ordered scatter, timed:
    the order the walk makes its records in is the order the scatter's
    passes meet their bins in."""
    from pumiumtally_tpu_torch.ops import scatter, walk_cuda

    mesh, dest, elem = args[0], args[2], args[3]
    initial = kw["initial"]
    full = dict(kw, score_squares=True, robust=True, ledger=True,
                stats=True, ordered=not initial, capacity=capacity)

    def slots():
        return walk_cuda.lane_slots(mesh, elem, dest, initial)

    order = {
        "slots": lambda f: walk_cuda._launch(*args, f, **full,
                                             perm=slots()),
        "launch": lambda f: walk_cuda._launch(*args, f, **full, perm=None),
    }

    def fresh():
        return (flux0.clone(),)

    out = {}
    for name, fn in order.items():
        o = fn(flux0.clone())
        trips = int(walk_cuda.WARP_TRIPS)
        out[name] = dict(ms=event_ms(fn, 5, fresh))
        if not initial:
            o, rec, made = o
            b, k, c = (r[:made] for r in rec)
            out[name]["scatter_ms"] = event_ms(
                lambda f: scatter.ordered_cuda(f, b, k, c, True,
                                               flux0.numel() // 2), 5, fresh)
        out[name]["share"] = active_share(o["iters"], trips)
    out["order_ms"] = event_ms(slots, 5)
    return out


def device_rows(prof) -> list:
    """A profile's device events (kernels, copies, fills) by name: the rows
    on the card, without the CPU ops that carry their kernels' device time
    (counting those too counts a torch op twice) and without CUPTI's own
    buffer requests."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and e.key != "Activity Buffer Request"]


def profile_call(label: str, fn, calls: int = 3) -> None:
    """Device time by kernel per call, from torch.profiler's CUDA activity
    (CUPTI) over ``calls`` calls after a warm-up; the share of the calls'
    host span the card was busy."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) / calls
    rows = device_rows(prof)
    busy = sum(e.self_device_time_total for e in rows) / calls
    log(f"[profile] {label}, per call of {calls}: {len(rows)} device "
        f"kernels, busy {busy / 1e3:.4f} ms of a {span * 1e3:.4f} ms host "
        "span")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total):
        log(f"[profile]   {e.self_device_time_total / calls / 1e3:9.4f} ms "
            f"x{e.count / calls:g} {e.key[:90]}")


def phase_reproducible(tally, snap, move) -> dict:
    """Move 1 twice through the ordered walk (same bits) and twice through
    the atomic walk, each atomic run held against the plain walk
    (``move["plain"]`` from phase 5) and their run-to-run difference
    reported. The atomic replays are the atomic walk's path: its launches
    are counted there."""
    from pumiumtally_tpu_torch.ops import walk_cuda

    args, kw = replay_args(tally, snap, initial=False)
    cap = move["capacity"]
    a = walk_cuda.trace(*args, snap["flux"].clone(), **kw, capacity=cap)
    b = walk_cuda.trace(*args, snap["flux"].clone(), **kw, capacity=cap)
    if not torch.equal(a.flux, b.flux):
        raise AssertionError("ordered walk: two runs of move 1 differ")
    zero_counts()
    x = walk_cuda.trace(*args, snap["flux"].clone(), **kw, tally="atomic")
    y = walk_cuda.trace(*args, snap["flux"].clone(), **kw, tally="atomic")
    torch.cuda.synchronize()
    launches = read_counts()["walk"]
    dtype = tally.config.dtype
    err = max(
        compare(r, move["plain"], dtype, 1e-5, 1e-4,
                f"main-path move 1 atomic run {i}")["max_abs_err"]
        for i, r in enumerate((x, y), 1)
    )
    diff = (x.flux.double() - y.flux.double()).abs()
    log(f"[repro] ordered: two runs of move 1 bitwise equal; atomic: two "
        f"runs differ in {int((diff > 0).sum())} of {diff.numel()} flux "
        f"entries, max |diff| {float(diff.max()):.3e}; atomic vs plain "
        f"max abs err {err:.3e}; atomic walk launches {launches}")
    return dict(flux=a.flux, launches=launches, max_abs_err=err)


def phase_overflow(tally, snap, ordered_flux) -> None:
    """Move 1 with buffers for OVERFLOW_CAPACITY records: the walk runs
    again with buffers of its count and gives the same flux bits."""
    from pumiumtally_tpu_torch.ops import walk_cuda

    args, kw = replay_args(tally, snap, initial=False)
    before = walk_cuda.RELAUNCHES
    r = walk_cuda.trace(*args, snap["flux"].clone(), **kw,
                        capacity=OVERFLOW_CAPACITY)
    if walk_cuda.RELAUNCHES != before + 1:
        raise AssertionError("a capacity of 1,000 records did not overflow")
    if not torch.equal(r.flux, ordered_flux):
        raise AssertionError("the relaunched walk's flux differs")
    log(f"[overflow] capacity {OVERFLOW_CAPACITY}: walk relaunched once, "
        "flux bitwise equal to the ordered walk's")


def phase_probe(tally, snap, rec) -> tuple[dict, dict]:
    """The gather/scatter probe with the main path's table and move 1's
    records; its launch counts are zeroed before and read after."""
    from pumiumtally_tpu_torch.probes import gather_scatter

    records = dict(flux=snap["flux"].clone(), bin=rec.bin, order=rec.order,
                   c=rec.c)
    zero_counts()
    payload = gather_scatter.run(DEVICE, geo20=tally.mesh.geo20,
                                 records=records)
    torch.cuda.synchronize()
    launches = read_counts()
    for p in payload["probes"]:
        log(f"[probe] {p['probe']} {p['shape']}: ok={p['ok']} "
            f"agree={p['agree']} {p['usec_per_call']} us (plain "
            f"{p['plain_usec_per_call']}, {p['library']} "
            f"{p['library_usec_per_call']}), {p['gbps']} GB/s, bound "
            f"{p['bound_usec']} us" + (f" {p['error']}" if p["error"] else ""))
    bad = [p for p in payload["probes"] if not p["ok"]]
    if bad:
        raise AssertionError(f"probes failed: {bad}")
    log(f"[probe] launches: {launches}")
    atomic = [p for p in payload["probes"] if p["probe"] == "scatter_atomic"]
    log(f"[probe] K3 outer with move 1's records: "
        f"{atomic[-1]['usec_per_call'] / 1e3:.4f} ms, Tensor.index_add_ "
        f"{atomic[-1]['library_usec_per_call'] / 1e3:.4f} ms (median of 5)")
    return payload, launches


def probe_atomic_f64(rec, nbins: int) -> None:
    """K3 outer in float64 (two scalar adds a record) against its plain
    version, with and without squares: at the JAX probe's shapes and with
    move 1's records, their contributions in float64."""
    from pumiumtally_tpu_torch.probes import gather_scatter as gs

    cases = [(gs.probe_scatter_inputs(B, ntet, G, DEVICE), (B, ntet, G))
             for B, ntet, G in gs.SCATTER_SHAPES]
    cases.append((dict(flux=torch.zeros(2 * nbins, device=DEVICE),
                       bin=rec.bin, order=rec.order, c=rec.c),
                  (rec.bin.numel(), nbins)))
    for r, shape in cases:
        for sq in (True, False):
            p = gs.scatter_probe("atomic", r["flux"].double(), r["bin"],
                                 r["order"], r["c"].double(), shape,
                                 score_squares=sq)
            log(f"[probe] scatter_atomic float64 {shape} squares={sq}: "
                f"ok={p['ok']} agree={p['agree']} {p['usec_per_call']} us, "
                f"Tensor.index_add_ {p['library_usec_per_call']} us"
                + (f" {p['error']}" if p["error"] else ""))
            if not p["ok"]:
                raise AssertionError(f"float64 atomic scatter failed: {p}")


def sass_reductions(lib: str, kernel: str) -> list[str]:
    """The atomic instructions (RED*, ATOM*) of the functions in lib's SASS
    (cuobjdump) whose mangled name contains ``kernel``."""
    from pumiumtally_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    found, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and re.search(r"\b(RED|ATOM)G?\.", line):
            found.append(re.sub(r"\s+", " ", line.split(";")[0]).strip())
    return found


def check_sass(libs: list[str]) -> None:
    """The float32 atomic scatter (aligned records) and the float32 atomic
    walk must add each (c, c²) pair with one vector reduction."""
    lib = dict(zip(SOURCES, libs))
    for source, kernel in (("scatter", "atomic_kernelIfLb1E"),
                           ("walk", "walk_kernelIfLb1ELb0ELb0E")):
        ops = sass_reductions(lib[source], kernel)
        log(f"[sass] {kernel}: {ops}")
        if not any("F32x2" in op for op in ops):
            raise AssertionError(f"{kernel}: no vector reduction in its SASS")


def phase_lane_order(snap, ntet: int) -> dict:
    """The lane-order kernel against its plain version (argsort by
    element) on move 1's start elements: a permutation whose elements
    match; timed beside the plain version and an unstable argsort."""
    from pumiumtally_tpu_torch.ops import scatter

    elem = snap["elem"]
    n = elem.numel()
    perm = scatter.lane_order_cuda(elem, ntet).long()
    plain = scatter.lane_order_plain(elem).long()
    if not torch.equal(torch.sort(perm).values,
                       torch.arange(n, device=elem.device)):
        raise AssertionError("lane order: not a permutation")
    err = int((elem[perm] - elem[plain]).abs().max())
    if err:
        raise AssertionError("lane order: elements out of order")
    bytes_ms = 2 * 4 * n / HBM_BYTES_PER_S * 1e3  # elem read, perm written
    out = dict(
        ms=event_ms(lambda: scatter.lane_order_cuda(elem, ntet), 5),
        plain_ms=event_ms(lambda: scatter.lane_order_plain(elem), 5),
        library_ms=event_ms(lambda: torch.argsort(elem), 5),
        bound_ms=bytes_ms, max_abs_err=float(err),
    )
    log(f"[order] lane order of move 1's {n} lanes over {ntet} elements: "
        f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, unstable "
        f"torch.argsort {out['library_ms']:.4f} ms, bound "
        f"{bytes_ms:.4f} ms (median of 5)")
    return out


def phase_point_source(tally) -> None:
    """Every lane starts at one point (the centroid of the element nearest
    the box centre) and flies one move: the ordered scatter of its records
    against the plain version, timed, with its largest bin."""
    from pumiumtally_tpu_torch.ops import scatter, walk_cuda

    mesh, cfg = tally.mesh, tally.config
    dev, dtype, n = mesh.device, cfg.dtype, tally.num_particles
    cent = mesh.centroids()
    e0 = int(((cent - 0.5) ** 2).sum(dim=1).argmin())
    rng = np.random.default_rng(7)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    origin = cent[e0].expand(n, 3).contiguous()
    dest = origin + torch.from_numpy(d * rng.exponential(0.08, (n, 1))).to(
        dev, dtype)
    group = torch.from_numpy(
        rng.integers(0, cfg.n_groups, n).astype(np.int32)).to(dev)
    args = (mesh, origin, dest,
            torch.full((n,), e0, dtype=torch.int32, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.ones(n, dtype=dtype, device=dev), group,
            torch.full((n,), -1, dtype=torch.int32, device=dev))
    flux0 = torch.zeros(mesh.ntet * cfg.n_groups * 2, dtype=dtype, device=dev)
    res, rec = walk_cuda.walk_records(
        *args, flux0, max_crossings=tally._max_crossings,
        n_groups=cfg.n_groups, tolerance=cfg.tolerance)
    per_bin = torch.bincount(rec.bin)
    nbins = mesh.ntet * cfg.n_groups
    crowded = scatter.CROWDED_LAUNCHES
    got = scatter.scatter_ordered(flux0.clone(), rec.bin, rec.order, rec.c)
    log(f"[point] ordered scatter took the {scatter.LAST_BUCKETS['path']} "
        f"path: {scatter.LAST_BUCKETS}")
    if scatter.CROWDED_LAUNCHES != crowded + 1:
        raise AssertionError("point source: the scatter was not crowded")
    t0 = time.perf_counter()
    ref = scatter.scatter_ordered_plain(flux0.clone(), rec.bin, rec.order,
                                        rec.c)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not torch.equal(got, ref):
        raise AssertionError("point source: ordered scatter differs from "
                             "its plain version")

    def fresh():
        return (flux0.clone(),)

    ms = event_ms(lambda f: scatter.ordered_cuda(f, rec.bin, rec.order,
                                                 rec.c, True, nbins), 5, fresh)
    log(f"[point] {n} lanes from element {e0}: {rec.bin.numel()} records, "
        f"largest bin {int(per_bin.max())} records, bins over 32 records "
        f"{int((per_bin > 32).sum())}; ordered scatter {ms:.4f} ms (median "
        f"of 5), bitwise equal to the plain version ({plain_s:.3f} s on the "
        f"host clock); walk truncated {int((~res.done).sum())}")


def _probe_kernel(payload, probe: str, launches: int, name: str,
                  source: str, replaces: str) -> dict:
    """A ``kernels`` entry from the probe's walk-shape run of ``probe``
    (its last entry of that kind)."""
    p = [q for q in payload["probes"] if q["probe"] == probe][-1]
    lib = p["library_usec_per_call"]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": p["max_abs_err"],
        "ms": p["usec_per_call"] / 1e3,
        "plain_ms": p["plain_usec_per_call"] / 1e3,
        "bound_ms": p["bound_usec"] / 1e3, "bound_by": "bytes",
        "library_ms": None if lib is None else lib / 1e3,
        "library": p["library"], "shape": p["shape"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    from pumiumtally_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {name} | host: {os.cpu_count()} CPUs, "
        f"torch threads {torch.get_num_threads()}")

    t0 = time.perf_counter()
    libs = _build.build_many(SOURCES)
    log(f"[build] csrc/{{{','.join(SOURCES)}}}.cu, built together, in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:  # ptxas's registers, shared memory and spills
        with open(lib[:-3] + ".log") as f:
            kernel = ""
            for line in f:
                if "Function properties for" in line:
                    kernel = line.split(" for ", 1)[1].strip()[:72]
                elif "registers" in line or "spill" in line:
                    log(f"[build] {os.path.basename(lib)} {kernel}: "
                        f"{line.strip()}")

    check_sass(libs)

    t0 = time.perf_counter()
    phase_kernel_vs_plain_small()
    log(f"[phase] kernel vs plain (20^3 box): "
        f"{time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tally, snaps, launches = phase_main_path(tmpdir)
        log(f"[phase] main path: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_kernel_vs_plain_full(tally, snaps["initial"], initial=True)
    k = phase_kernel_vs_plain_full(tally, snaps["move"], initial=False)
    log(f"[phase] kernel vs plain (main-path shapes): "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    repro = phase_reproducible(tally, snaps["move"], k)
    phase_overflow(tally, snaps["move"], repro["flux"])
    log(f"[phase] reproducibility and overflow: "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    payload, probe_launches = phase_probe(tally, snaps["move"], k["records"])
    probe_atomic_f64(k["records"], tally.flux.numel() // 2)
    order = phase_lane_order(snaps["move"], tally.mesh.ntet)
    log(f"[phase] probe path: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_point_source(tally)
    log(f"[phase] point source: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    io = phase_io(tally.mesh)
    log(f"[phase] move-loop I/O: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    pipe = phase_pipeline(tally.mesh)
    log(f"[phase] pipeline: {time.perf_counter() - t0:.2f} s")

    walk = {
        "route": "cuda",
        "source": "pumiumtally_tpu_torch/csrc/walk.cu",
        "replaces": "pumiumtally_tpu/ops/walk_pallas.py:730",
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,
    }
    kernels = [
        {"name": "walk_cuda.trace", **walk, "launches": launches["walk"],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "walk_ms": k["walk_ms"], "scatter_ms": k["scatter_ms"],
         "atomic_ms": k["atomic_ms"], "active_share": k["share"],
         "launch_order_share": k["launch_order_share"],
         "slot_order_ms": k["slot_order_ms"],
         "launch_order_ms": k["launch_order_ms"],
         "io_launches": {m: r["launches"]["walk"] for m, r in io.items()},
         "pipeline_launches": {d: pipe[f"depth{d}_launches"]["walk"]
                               for d in (1, 2)}},
        {"name": "walk_cuda.trace(tally='atomic')", **walk,
         "launches": repro["launches"], "max_abs_err": repro["max_abs_err"],
         "ms": k["atomic_ms"]},
        _probe_kernel(payload, "gather", probe_launches["gather"],
                      "gather.gather_rows",
                      "pumiumtally_tpu_torch/csrc/gather.cu",
                      "scripts/probe_pallas_gather.py:76"),
        _probe_kernel(payload, "scatter_atomic",
                      probe_launches["scatter_atomic"],
                      "scatter.scatter_atomic",
                      "pumiumtally_tpu_torch/csrc/scatter.cu",
                      "scripts/probe_pallas_gather.py:211"),
        dict(_probe_kernel(payload, "scatter_ordered",
                           launches["scatter_ordered"],
                           "scatter.scatter_ordered",
                           "pumiumtally_tpu_torch/csrc/scatter.cu",
                           "scripts/probe_pallas_gather.py:211"),
             bucket_launches=launches["scatter_bucket"],
             crowded_launches=launches["scatter_crowded"],
             move1_bucket_ms=k["scatter_ms"], move1_crowded_ms=k["crowded_ms"],
             move1_library_ms=k["library_ms"], buckets=k["buckets"],
             io_bucket_launches={m: r["launches"]["scatter_bucket"]
                                 for m, r in io.items()},
             pipeline_bucket_launches={
                 d: pipe[f"depth{d}_launches"]["scatter_bucket"]
                 for d in (1, 2)}),
        {"name": "scatter.lane_order", "route": "cuda",
         "source": "pumiumtally_tpu_torch/csrc/scatter.cu",
         "replaces": "pumiumtally_tpu/ops/walk_pallas.py:730",
         "launches": launches["lane_order"], "bound_by": "bytes",
         "library": "torch.argsort", **order},
    ]
    for kern in kernels:
        if not kern["launches"]:
            raise AssertionError(f"{kern['name']} was not launched on its path")
    log(f"[phase] total: {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
