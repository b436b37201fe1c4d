"""Phases 4 and 5 of a checkout's ``chip_smoke.py``, to compare two commits
on one card in turns.

    python3 turns.py --tree DIR

Imports the package and the ``chip_smoke.py`` of the checkout at ``DIR``,
builds its kernels, drives its main path (phase 4) and replays the main
path's initial search and first move through the kernel and the plain
walk (phase 5), whose log lines carry the walk into records, the ordered
scatter, the active-lane share and the profile by kernel. Started for two
checkouts in turns (parent, change, change, parent) in one command, it
compares them on one card. The last line is a JSON object: move 1's walk
into records, ordered scatter and whole walk call (CUDA events, median of
5), its active-lane share, and the device time of every kernel of one
move-1 walk into records (torch.profiler, mean over 3 calls), from which
a reader sums the lane schedule's kernels of either design.
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
    tree = os.path.abspath(ap.parse_args().tree)
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
