"""Phases 4 and 5 of a checkout's ``chip_smoke.py``, or its row gather
(K2), to compare two commits on one card in turns.

    python3 turns.py --tree DIR [--reps N]
    python3 turns.py --tree DIR --gather
    python3 turns.py --tree DIR --sass
    python3 turns.py --tree DIR --flight [--reps N]

Imports the package and the ``chip_smoke.py`` of the checkout at ``DIR``
and builds its kernels. Without ``--gather`` it drives the checkout's main
path (phase 4) and replays the main path's initial search and first move
through the kernel and the plain walk (phase 5), whose log lines carry the
walk into records, the ordered scatter, the active-lane share and the
profile by kernel. The last line is a JSON object: move 1's walk into
records, ordered scatter and whole walk call (CUDA events, median of 5),
its active-lane share, the device time of every kernel of one move-1
walk into records (torch.profiler, mean over 3 calls), from which a reader
sums the lane schedule's kernels of either design, the main path's moves
2-4 in segments per second (host clock, from phase 4's log line), and the
walk kernels' registers and spills as ptxas reported them when the
checkout's ``csrc/walk.cu`` was built. ``--reps N`` adds the quartiles
(25%, 50%, 75%) of N single calls each of move 1's walk into records and
of its whole ordered walk call (``walk_cuda.trace``, a fresh flux each),
CUDA events around each call, for comparisons finer than a median of 5.

With ``--gather`` it times the checkout's ``gather.gather_cuda`` (CUDA
events, median of 5 after a warm-up; each output held bitwise to
``tbl[idx]``) at the walk's shape (the geo20 of the 55³-cell box in
float32 and float64, 16,934,705 uniform int32 indices from numpy seed 3),
at the JAX probe's ([4096, 16] float32, 2048 indices) and over float32
tables of 80 B rows of 8, 16, 32, 48, 64, 80 and 160 MB with as many
indices, where the time shows how much of the table the L2 keeps; the
last line is a JSON object of those times in ms. Started for two
checkouts in turns (parent, change, change, parent) in one command,
either mode compares them on one card.

With ``--sass`` it prints, after the build, a JSON object of the
checkout's walk kernel instantiations (by template arguments, as
``walk_ptxas``) with the count and sha256 of their SASS instructions
(``cuobjdump -sass`` of the built library, addresses and encodings left
out), so two checkouts' machine code can be compared instantiation by
instantiation.

With ``--flight`` it times the checkout's flight kernel
(``source_cuda.sample_flight``) in its single-device form on the megastep
cell's shape: the 55³-cell box in float32, 1,048,576 lanes, all alive,
each at the centroid of an element drawn from numpy seed 5, Σt 12.5, the
move key of seed 1 and move 9. The last line is a JSON object of its CUDA
events (median of 5 after a warm-up; ``--reps N`` adds the quartiles of
N single calls) and the sha256 of its outputs' bytes (destinations,
collision and roulette draws), so two checkouts' outputs compare bit for
bit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True,
                    help="root of the checkout whose phases run")
    ap.add_argument("--reps", type=int, default=0,
                    help="also time N single calls of move 1's walk")
    ap.add_argument("--gather", action="store_true",
                    help="time the checkout's row gather instead")
    ap.add_argument("--sass", action="store_true",
                    help="digest the walk kernels' SASS instead")
    ap.add_argument("--flight", action="store_true",
                    help="time the checkout's flight kernel instead")
    args = ap.parse_args()
    reps = args.reps
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("turns: needs an NVIDIA card", file=sys.stderr)
        return 2
    from pumiumtally_tpu_torch.ops import _build, walk_cuda

    smoke.log(f"[turns] tree {tree}: {smoke.card_line()}")
    _build.build_many(smoke.SOURCES)
    if args.sass:
        print(json.dumps(dict(tree=tree, walk_sass=sass_digests(
            _build.library_path("walk")))), flush=True)
        return 0
    if args.gather:
        print(json.dumps(dict(tree=tree, gather_ms=gather_ms(smoke.log))),
              flush=True)
        return 0
    if args.flight:
        print(json.dumps(dict(tree=tree, **flight_ms(smoke, reps))),
              flush=True)
        return 0
    lines = []
    log = smoke.log

    def keep(msg):
        lines.append(msg)
        log(msg)

    smoke.log = keep
    with tempfile.TemporaryDirectory() as tmp:
        tally, snaps, launches = smoke.phase_main_path(tmp)
    smoke.log = log
    late = [m for m in lines if m.startswith("[main] moves 2-4")]
    segs_per_s = float(late[-1].rsplit("segments/s=", 1)[1])
    smoke.log(f"[turns] main path launches {launches}")
    smoke.phase_kernel_vs_plain_full(tally, snaps["initial"], initial=True)
    k = smoke.phase_kernel_vs_plain_full(tally, snaps["move"], initial=False)
    snap = snaps["move"]
    args, kw = smoke.replay_args(tally, snap, initial=False)
    wkw = {key: v for key, v in kw.items() if key != "initial"}
    extra = {}
    if reps:
        import numpy as np

        def quartiles(fn, setup=None):
            t = [smoke.event_ms(fn, 1, setup) for _ in range(reps)]
            return [float(q) for q in np.percentile(t, [25, 50, 75])]

        extra = dict(
            walk_records_quartiles_ms=quartiles(
                lambda: walk_cuda.walk_records(
                    *args, snap["flux"].clone(), **wkw,
                    capacity=k["capacity"])),
            trace_quartiles_ms=quartiles(
                lambda f: walk_cuda.trace(*args, f, **kw,
                                          capacity=k["capacity"]),
                lambda: (snap["flux"].clone(),)))
    print(json.dumps(dict(
        tree=tree, walk_ms=k["walk_ms"], scatter_ms=k["scatter_ms"],
        ms=k["ms"], share=k["share"], moves_2_4_segments_per_s=segs_per_s,
        walk_ptxas=ptxas_lines(_build.library_path("walk")),
        walk_records_kernels=device_ms(
            lambda: walk_cuda.walk_records(*args, snap["flux"].clone(), **wkw,
                                           capacity=k["capacity"])),
        **extra,
    )), flush=True)
    return 0


def ptxas_lines(lib: str) -> dict:
    """{walk kernel instantiation: [ptxas lines]} from the build log kept
    beside ``lib``: registers, shared memory and spills, by the kernel's
    template arguments (its mangled name between ``walk_kernelI`` and
    the parameter list)."""
    out, kernel = {}, ""
    with open(lib[:-3] + ".log") as f:
        for line in f:
            if "Function properties for" in line:
                kernel = line.split(" for ", 1)[1].strip()
            elif "walk_kernelI" in kernel and (
                    "registers" in line or "spill" in line):
                name = kernel.split("walk_kernelI", 1)[1].split("EEvPK")[0]
                out.setdefault(name, []).append(line.strip())
    return out


def sass_digests(lib: str) -> dict:
    """{walk kernel instantiation: [instructions, sha256 of their text]}
    from ``cuobjdump -sass`` of ``lib``."""
    import hashlib
    import re
    import subprocess

    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    out, name, body = {}, None, []

    def close():
        if name is not None:
            out[name] = [len(body), hashlib.sha256(
                "\n".join(body).encode()).hexdigest()]

    for line in text.splitlines():
        if "Function :" in line:
            close()
            fn = line.split("Function :", 1)[1].strip()
            name = (fn.split("walk_kernelI", 1)[1].split("EEvPK")[0]
                    if "walk_kernelI" in fn else None)
            body = []
        elif name is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
            if m:
                body.append(m.group(1))
    close()
    return out


SWEEP_MB = (8, 16, 32, 48, 64, 80, 160)
WALK_RECORDS = 16_934_705


def gather_ms(log) -> dict:
    """The checkout's K2 in ms at the walk's shape, the JAX probe's and
    over the table sizes of ``SWEEP_MB`` (see the module's docstring)."""
    import numpy as np
    import torch

    from pumiumtally_tpu_torch.mesh.box import build_box
    from pumiumtally_tpu_torch.ops import gather
    from pumiumtally_tpu_torch.probes.gather_scatter import event_us

    def timed(label, tbl, idx):
        bits = torch.int32 if tbl.element_size() == 4 else torch.int64
        ok = torch.equal(gather.gather_cuda(tbl, idx).view(bits),
                         tbl[idx.long()].view(bits))
        if not ok:
            raise AssertionError(f"gather {label}: not tbl[idx]")
        ms = event_us(lambda: gather.gather_cuda(tbl, idx), 5) / 1e3
        log(f"[turns] gather {label} {tuple(tbl.shape)} x {idx.numel()}: "
            f"{ms:.4f} ms")
        return ms

    def uniform(rows, n, seed=3):
        r = np.random.default_rng(seed).integers(0, rows, n)
        return torch.from_numpy(r.astype(np.int32)).cuda()

    out = {}
    for dtype in (torch.float32, torch.float64):
        geo = build_box(1.0, 1.0, 1.0, 55, 55, 55, dtype=dtype,
                        device="cuda").geo20
        name = f"walk {str(dtype)[6:]}"
        out[name] = timed(name, geo, uniform(geo.shape[0], WALK_RECORDS))
        del geo
    tbl = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4096, 16)).astype(np.float32)).cuda()
    out["jax probe"] = timed("jax probe", tbl, uniform(4096, 2048, seed=1))
    for mb in SWEEP_MB:
        rows = mb * 1_000_000 // 80
        tbl = torch.randn(rows, 20, device="cuda")
        out[f"{mb} MB"] = timed(f"{mb} MB", tbl, uniform(rows, WALK_RECORDS))
        del tbl
        torch.cuda.empty_cache()
    return out


def flight_ms(smoke, reps: int) -> dict:
    """The checkout's flight kernel, single-device form, on the megastep
    cell's shape (see the module's docstring): ms and output digests."""
    import hashlib

    import numpy as np
    import torch

    from pumiumtally_tpu_torch.mesh.box import build_box
    from pumiumtally_tpu_torch.ops import source, source_cuda

    mesh = build_box(1.0, 1.0, 1.0, 55, 55, 55, device="cuda")
    n = 1048576
    elem = torch.from_numpy(np.random.default_rng(5).integers(
        0, mesh.ntet, n).astype(np.int32)).cuda()
    origin = mesh.centroids()[elem.long()].contiguous()
    pid = torch.arange(n, dtype=torch.int32, device="cuda")
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    sig = torch.tensor([12.5], device="cuda")
    key = source.fold_in(source.prng_key(1), 9)
    args = (key, pid, n, elem, alive, origin, mesh.class_id, sig)
    outs = source_cuda.sample_flight(*args)
    digest = hashlib.sha256()
    for t in outs:
        digest.update(t.cpu().numpy().tobytes())
    out = dict(flight_ms=smoke.event_ms(lambda: source_cuda.sample_flight(
        *args)), flight_sha256=digest.hexdigest())
    if reps:
        t = [smoke.event_ms(lambda: source_cuda.sample_flight(*args), 1)
             for _ in range(reps)]
        out["flight_quartiles_ms"] = [
            float(q) for q in np.percentile(t, [25, 50, 75])]
    smoke.log(f"[turns] flight: {out}")
    return out


def device_ms(fn, calls: int = 3) -> dict:
    """Device ms per call of every device event of ``fn`` by name
    (torch.profiler over ``calls`` calls after a warm-up)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


if __name__ == "__main__":
    sys.exit(main())
