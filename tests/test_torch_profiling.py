"""The port's profiler integration (``utils/profiling.py``) on
``device="cpu"``.

Mirrors test_profiling: a ``profile_trace`` around real facade work
writes a trace into its directory, with the ``annotate`` spans in it, and
``device_memory_stats`` returns integer fields (nothing off the card).
"""
from __future__ import annotations

import json
import os

import numpy as np

from pumiumtally_tpu_torch import PumiTally, TallyConfig, build_box
from pumiumtally_tpu_torch.utils.profiling import (
    annotate,
    device_memory_stats,
    profile_trace,
)


def test_profile_trace_writes_artifacts(tmp_path):
    logdir = str(tmp_path / "trace")
    mesh = build_box(1.0, 1.0, 1.0, 2, 2, 2, device="cpu")
    t = PumiTally(mesh, 8, TallyConfig(tolerance=1e-6), device="cpu")
    rng = np.random.default_rng(0)
    with profile_trace(logdir) as d:
        assert d == logdir
        with annotate("init"):
            t.initialize_particle_location(
                rng.uniform(0.1, 0.9, (8, 3)).ravel())
        with annotate("move"):
            t.move_to_next_location(
                rng.uniform(0.1, 0.9, (8, 3)), np.ones(8, np.int8),
                np.ones(8), np.zeros(8, np.int32), np.full(8, -1, np.int32))
    path = os.path.join(logdir, "trace.json")
    assert os.path.exists(path), os.listdir(logdir)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"init", "move"} <= names


def test_device_memory_stats_shape():
    stats = device_memory_stats()
    for rec in stats.values():
        for v in rec.values():
            assert isinstance(v, int)
