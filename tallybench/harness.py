"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell needs is found by name from ``BENCHMARK.json``:
``configs/<config>.json`` (through the configuration's ``file``),
``traffic/<mix>.json``, the mix's drive ``drives/<drive>.py`` (``drive.py``
says what it defines), ``limits/<workload>.json`` and, for each metric,
end-to-end or per-layer, ``metrics/<metric>.py`` (its ``read(ctx)`` returns
a number, or None where it finds nothing to read). Adding a cell, a configuration, a
mix, a drive or a metric adds files and entries and edits none.

With ``--trace 0`` the line holds the cell's end-to-end metrics; with
``--trace 1`` the first ``TRACE_SPAN_S`` seconds of the window (whole
batches) run under ``torch.profiler`` and the line holds the cell's
per-layer metrics, the device's busy seconds and the traced window, and the
breakdown.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import re
import statistics
import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_SPAN_S = 4.0
FORBIDDEN = ("jax", "jaxlib", "flax", "pumiumtally_tpu")
PROGRAM = "pumiumtally_tpu_torch"


class Refused(Exception):
    """A run that cannot give a result (no card, no program, a bad
    name); the message goes to standard error."""


def note(msg: str) -> None:
    print(f"tallybench: {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def lookup(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, mix, drive, limits and
    metrics."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    wl = cells[workload]
    confs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / confs[wl["config"]]["file"])
    here = root / "tallybench"
    mix = load_json(here / "traffic" / f"{wl['traffic']}.json")
    limits = load_json(here / "limits" / f"{workload}.json")

    def applies(m):
        return workload in m.get("workloads", [workload])

    from .drive import load

    return dict(
        bench=bench, workload=wl, config=cfg, mix=mix, limits=limits,
        drive=load(mix["drive"], here),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        here=here)


def metric_reader(here: Path, name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "tallybench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def csrc_kernels(program_dir: Path) -> dict:
    """{source stem: kernel names} of the program's ``csrc/*.cu``."""
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")
    return {p.stem: set(pat.findall(p.read_text()))
            for p in sorted((program_dir / "csrc").glob("*.cu"))}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", root: Path = ROOT,
        overrides: dict | None = None, fault=None) -> dict:
    """One run; returns the result's fields (``line`` and ``check``).
    ``overrides`` replaces configuration keys (the CPU tests' small
    sizes); ``fault(tally)`` breaks the program under the window (the
    tests of the check)."""
    cell = lookup(workload, root)
    cfg = dict(cell["config"], **(overrides or {}))
    mix, limits, wl = cell["mix"], cell["limits"], cell["workload"]
    drive = cell["drive"]
    import torch

    from . import check, meshgen, roofline
    from .drive import Probe, span
    from .generator import Traffic

    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("no CUDA card: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < int(wl["chips"]):
            raise Refused(f"the cell asks for {wl['chips']} cards, "
                          f"{torch.cuda.device_count()} present")
    dev = torch.device(device)
    if importlib.util.find_spec(PROGRAM) is None:
        raise Refused(f"the program {PROGRAM} is not in this checkout")
    from pumiumtally_tpu_torch import PumiTally, TallyConfig
    from pumiumtally_tpu_torch.mesh.core import TetMesh
    from pumiumtally_tpu_torch.utils.timing import StepClock

    dtype = check.DTYPES[cfg["dtype"]]
    stages = [("imports", time.perf_counter())]
    arrays = meshgen.build(cfg["mesh"])
    cfg["regions"] = int(arrays[2].max()) + 1
    traffic = Traffic(mix, cfg, seed, drive)
    stages.append(("mesh arrays and traffic", time.perf_counter()))
    mesh = TetMesh.from_numpy(*arrays, dtype=dtype, device=dev)
    tally = PumiTally(mesh, int(cfg["particles"]),
                      TallyConfig(n_groups=int(cfg["n_groups"]), dtype=dtype,
                                  tolerance=float(cfg["tolerance"])),
                      device=dev)
    stages.append(("program mesh and tally", time.perf_counter()))
    probe = Probe()
    driver = drive.Driver(tally, traffic, cfg, probe)
    driver.batch()                       # warms this cell's shapes
    stages.append(("warm-up batch", time.perf_counter()))
    snap = torch.empty_like(tally.flux)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):   # the profiler's own first start
            torch.zeros(1, device=dev).add_(1)
        prof = profile(activities=acts)
        tally.step_clock = StepClock(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if fault is not None:
        fault(tally)
    setup_s = time.perf_counter() - t_start
    marks = [t_start] + [t for _, t in stages]
    note(f"set-up {setup_s:.3f} s (" + ", ".join(
        f"{name} {b - a:.3f}" for (name, _), a, b in zip(
            stages, marks, marks[1:])) + ")")

    # The window: whole batches back to back, from the first timed moment
    # to the end of the batch in progress at its close.
    b0, calls0, seg = driver.batches, driver.calls, 0
    t0 = time.perf_counter()
    end, traced_until = t0 + seconds, t0 + TRACE_SPAN_S
    win = span(True, "window") if prof is not None else None

    def stop_trace():
        win.__exit__(None, None, None)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        prof.stop()
        probe.on = False
        tally.step_clock = None

    if prof is not None:
        prof.start()
        probe.on = True
        win.__enter__()
    batch_s, last_t = [], t0
    while True:
        with span(probe.on, "snapshot"):
            snap.copy_(tally.flux)
        seg += driver.batch()
        now = time.perf_counter()
        batch_s.append(now - last_t)
        last_t = now
        if probe.on and (now >= traced_until or now >= end):
            stop_trace()
        if now >= end:
            break
    window_s = time.perf_counter() - t0
    batches = driver.batches - b0
    calls = driver.calls - calls0
    peak = (torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else 0)

    # The program's outputs of the last batch, then its state freed.
    last = driver.last
    prog = dict(flux=(tally.flux.double() - snap.double()),
                **driver.outputs())
    ntet, item = mesh.ntet, tally.flux.element_size()
    layout = "geo20" if mesh.geo20 is not None else "unpacked"
    del tally, snap, mesh, driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    q = statistics.quantiles(batch_s, n=4) if len(batch_s) > 1 else batch_s * 3
    note(f"window {window_s:.3f} s, {batches} batches (seconds a batch: "
         f"min {min(batch_s):.4f}, quartiles {q[0]:.4f} {q[1]:.4f} "
         f"{q[2]:.4f}, max {max(batch_s):.4f}), peak {peak} B")
    t_ref = time.perf_counter()
    ref = check.reference_batch(cfg, drive, traffic, last, arrays, dev,
                                check.DTYPES[cfg["reference_dtype"]])
    nums = check.numbers(drive, prog, ref)
    correct = check.verdict(nums, limits)
    note(f"reference {time.perf_counter() - t_ref:.3f} s")

    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    device_f = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": name, "count": int(wl["chips"]),
                "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": int(batches),
            "failed": 0}
    # What the metric readers read: the window's totals, and in a traced
    # run the trace's reduction and the probe's walks, waits and steps.
    ctx = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s, segments=seg, batches=batches,
        calls=calls, batch_s=batch_s)
    breakdown = None
    if trace:
        from . import devtrace

        red = devtrace.reduce_events(prof.profiler.kineto_results.events())
        spec = importlib.util.find_spec(PROGRAM)
        csrc = csrc_kernels(Path(spec.origin).parent)
        by_kernel = red.kernel_seconds()

        def csrc_seconds(stem):
            names = csrc.get(stem, set())
            return sum(s for k, s in by_kernel.items()
                       if devtrace.kernel_id(k) in names)

        vars(ctx).update(
            reduced=red, csrc=csrc, kernel_id=devtrace.kernel_id,
            kernel_seconds=lambda: by_kernel, csrc_seconds=csrc_seconds,
            device_seconds=lambda: sum(s for _, _, s in red.ops),
            walks=probe.walks, waits=probe.waits, step_ms=probe.step_ms,
            ntet=ntet, item=item, layout=layout,
            nbins=ntet * int(cfg["n_groups"]), roofline=roofline)
        device_f.update(busy_s=red.busy_s, window_s=red.window_s)
        breakdown = devtrace.breakdown(red)
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = metric_reader(cell["here"], m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line["metrics"] = metrics
    line["device"] = device_f
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check"] = {k: {"value": nums[k], "limit": limits[k]}
                     for k in limits}
    return dict(line=line, nums=nums, limits=limits, window_s=window_s,
                calls=calls, segments=seg,
                card=roofline.card_line() if dev.type == "cuda" else None)


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        res = run(a.workload, a.seed, a.seconds, bool(a.trace),
                  t_start=t_start)
    except Refused as e:
        print(f"tallybench: refused: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"tallybench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line = res["line"]
    print(f"tallybench: {a.workload} seed {a.seed} window "
          f"{res['window_s']:.3f} s, {line['attempted']} batches, "
          f"{res['calls']} calls, {res['segments']} segments; card "
          f"{res['card']}", file=sys.stderr)
    for k in sorted(set(res["nums"]) - set(line["check"])):
        print(f"reading {k} {res['nums'][k]!r} (not compared)",
              file=sys.stderr)
    for k, v in line["check"].items():
        ok = "ok" if v["value"] <= v["limit"] else "OVER"
        print(f"check {k} {v['value']!r} limit {v['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
