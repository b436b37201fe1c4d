#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pumiumtally_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on any failed check:

1. device: the card's name and power limit from nvidia-smi;
2. build: the CUDA walk kernel (csrc/walk.cu) with nvcc, timed;
3. kernel vs plain on a jittered 20^3 box (48,000 tets, two materials),
   65,536 lanes, 8 groups, float32 and float64, initial and move mode with
   robust=True plus one move with robust=False: elements, material ids,
   done flags and stats equal on every lane, positions within 1e-12 (f64)
   / 1e-5 (f32), per-bin flux within rtol 1e-10 / 1e-4 (atomics reorder
   the adds);
4. main path: the four-call facade at the headline configuration
   (998,250-tet box, 1,048,576 particles, 8 groups, float32): construct,
   locate, 4 moves, write a .vtu. Launch counts are zeroed just before and
   read just after; the conservation invariant, the boundary write-backs
   and the .vtu are checked;
5. kernel vs plain at the main path's shapes: the inputs of the main
   path's initial search and of its first move, replayed through the
   kernel and the plain walk, compared and timed with CUDA events (median
   of 5). The bound is the larger of two times: the bytes the walk must
   move (each distinct table row it needs once, each flux bin it scores
   read and written once, the lanes' inputs and outputs) over the HBM
   rate, and its lane iterations' operations over the FP32/FP64 rate.
   The ``kernels`` line reports the move.

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
    mismatch. Returns the error summary."""
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
    stats_equal = bool(torch.equal(k.stats, p.stats))
    iters_equal = bool(torch.equal(k.lane_iters, p.lane_iters))
    log(
        f"[compare] {label}: lanes whose path differs={n_differ} "
        f"max|dpos|={pos_err:.3e} (tol {pos_tol:g}) "
        f"max flux rel={flux_rel:.3e} (rtol {flux_rtol:g}) "
        f"stats equal={stats_equal} stats={k.stats.tolist()}"
    )
    if n_differ or not stats_equal or not iters_equal:
        raise AssertionError(f"{label}: kernel and plain walk disagree")
    if not pos_err <= pos_tol:
        raise AssertionError(f"{label}: positions differ by {pos_err}")
    if not flux_rel <= flux_rtol:
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
    for dtype, pos_tol, rtol in (
        (torch.float64, 1e-12, 1e-10),
        (torch.float32, 1e-5, 1e-4),
    ):
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
        compare(k, p, dtype, pos_tol, rtol, f"{dtype} initial robust")

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
            compare(k, p, dtype, pos_tol, rtol,
                    f"{dtype} move robust={robust}")
        torch.cuda.synchronize()


def phase_main_path(tmpdir: str):
    """The four calls at the headline configuration. Returns the tally,
    snapshots of the inputs of the initial search and of the first move
    (for the replay of phase 5), and the walk launches counted."""
    from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
    from pumiumtally_tpu_torch.ops import walk_cuda

    cells, n, G = MAIN_CELLS, MAIN_PARTICLES, MAIN_GROUPS
    rng = np.random.default_rng(1)
    torch.cuda.reset_peak_memory_stats()
    walk_cuda.LAUNCHES = 0
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
        t0 = time.perf_counter()
        tally.move_to_next_location(dest, flying, weights, groups, mats)
        secs = time.perf_counter() - t0
        st = tally.last_stats
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
    launches = walk_cuda.LAUNCHES
    with open(out) as f:
        head = f.read(4096)
    cells_m = re.search(r'NumberOfCells="(\d+)"', head)
    if cells_m is None or int(cells_m.group(1)) != mesh.ntet:
        raise AssertionError(".vtu does not hold the mesh's cells")
    log(f"[main] times: init {tally.tally_times.initialization_time:.3f} s, "
        f"tally {tally.tally_times.total_time_to_tally:.3f} s, "
        f"vtk {tally.tally_times.vtk_file_write_time:.3f} s; "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} bytes")
    if launches != 5:
        raise AssertionError(f"walk kernel launched {launches} times, not 5")
    return tally, snaps, launches


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


def phase_kernel_vs_plain_full(tally, snap, initial: bool) -> dict:
    """Replay one main-path walk (the initial search or the first move)
    through the kernel and the plain walk: compare, then time both."""
    from pumiumtally_tpu_torch.ops import walk, walk_cuda

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
    label = "initial search" if initial else "move 1"
    k = walk_cuda.trace(*args, snap["flux"].clone(), **kw)
    p = walk.trace(*args, snap["flux"].clone(), **kw)
    err = compare(k, p, dtype, 1e-5, 1e-4, f"main-path {label} ({dtype})")

    def fresh():
        return (snap["flux"].clone(),)

    ms = event_ms(lambda f: walk_cuda.trace(*args, f, **kw), 5, fresh)
    plain_ms = event_ms(lambda f: walk.trace(*args, f, **kw), 5, fresh)
    item = torch.finfo(dtype).bits // 8
    rows = int(k.lane_iters.sum(dtype=torch.int64))
    segs = int(k.n_segments)
    table_rows, bins = touched(mesh, args, kw, k.elem, scores=not initial)
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
    return dict(
        ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        max_abs_err=err["max_abs_err"],
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    from pumiumtally_tpu_torch.ops import _build

    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {name}")

    t0 = time.perf_counter()
    lib = _build.build("walk")
    log(f"[build] csrc/walk.cu -> {os.path.basename(lib)} in "
        f"{time.perf_counter() - t0:.2f} s")
    with open(lib[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")

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

    kernels = [{
        "name": "walk_cuda.trace",
        "route": "cuda",
        "source": "pumiumtally_tpu_torch/csrc/walk.cu",
        "replaces": "pumiumtally_tpu/ops/walk_pallas.py:730",
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
