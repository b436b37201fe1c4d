"""Phases 4 and 5 of a checkout's ``chip_smoke.py``, or its row gather
(K2), to compare two commits on one card in turns.

    python3 turns.py --tree DIR
    python3 turns.py --tree DIR --gather

Imports the package and the ``chip_smoke.py`` of the checkout at ``DIR``
and builds its kernels. Without ``--gather`` it drives the checkout's main
path (phase 4) and replays the main path's initial search and first move
through the kernel and the plain walk (phase 5), whose log lines carry the
walk into records, the ordered scatter, the active-lane share and the
profile by kernel. The last line is a JSON object: move 1's walk into
records, ordered scatter and whole walk call (CUDA events, median of 5),
its active-lane share, and the device time of every kernel of one move-1
walk into records (torch.profiler, mean over 3 calls), from which a reader
sums the lane schedule's kernels of either design.

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
    ap.add_argument("--gather", action="store_true",
                    help="time the checkout's row gather instead")
    args = ap.parse_args()
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
    if args.gather:
        print(json.dumps(dict(tree=tree, gather_ms=gather_ms(smoke.log))),
              flush=True)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        tally, snaps, launches = smoke.phase_main_path(tmp)
    smoke.log(f"[turns] main path launches {launches}")
    smoke.phase_kernel_vs_plain_full(tally, snaps["initial"], initial=True)
    k = smoke.phase_kernel_vs_plain_full(tally, snaps["move"], initial=False)
    snap = snaps["move"]
    args, kw = smoke.replay_args(tally, snap, initial=False)
    wkw = {key: v for key, v in kw.items() if key != "initial"}
    print(json.dumps(dict(
        tree=tree, walk_ms=k["walk_ms"], scatter_ms=k["scatter_ms"],
        ms=k["ms"], share=k["share"],
        walk_records_kernels=device_ms(
            lambda: walk_cuda.walk_records(*args, snap["flux"].clone(), **wkw,
                                           capacity=k["capacity"])),
    )), flush=True)
    return 0


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
