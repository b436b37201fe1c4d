"""The result line's schema, the traced run's fields, and the command's
refusals: no card, and a directory without the program."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
from tb_small import CELLS, ROOT, run_small

E2E = {"segments_per_s", "setup_s"}
# On the CPU no device op runs: the readers of device rows find nothing,
# the idle share reads the whole window.
TRACED = {"host_step_ms.source", "walk_wait_ms.source", "idle_pct.source"}


def check_line(line, traced):
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if traced:
        keys.append("breakdown")
    keys.append("check")
    assert list(line) == keys
    json.loads(json.dumps(line))
    assert isinstance(line["correct"], bool)
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for v in line["check"].values():
        assert set(v) == {"value", "limit"}
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        for k in ("device_ops", "idle_gaps"):
            assert len(line["breakdown"][k]) <= 10


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_line(workload):
    line = run_small(workload)["line"]
    check_line(line, False)
    assert set(line["metrics"]) == E2E
    assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_traced_line(workload):
    line = run_small(workload, trace=True)["line"]
    check_line(line, True)
    assert set(line["metrics"]) == TRACED
    assert line["device"]["window_s"] > 0


def command(args, cwd, env=None):
    return subprocess.run(
        [sys.executable, "tallybench/run.py", "--workload",
         "pincell-casmo8-f64.source", "--seed", "4294967301", "--seconds", "1",
         "--trace", "0", *args], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = command([], ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "tallybench", tmp_path / "tallybench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = command([], tmp_path, env)
    assert p.returncode != 0 and p.stdout.strip() == ""
