"""Boundaries of the PyTorch port.

* ``pumiumtally_tpu_torch`` and ``chip_smoke.py`` import neither ``jax``
  nor any module of ``pumiumtally_tpu`` (checked in a fresh interpreter
  and by an AST scan of the sources).
* Entry points default to the CUDA card and refuse to run without one;
  there is no silent CPU fallback.
* The kernel build raises, and does not fall back, when nvcc is missing;
  importing the kernel wrapper builds nothing.
* ``chip_smoke.py`` exits non-zero and prints no result without a card.
"""
from __future__ import annotations

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "pumiumtally_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                      ROOT / "turns.py"]


def _run(code: str, cwd=ROOT, env=None) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, capture_output=True,
        text=True, timeout=120, env=env,
    )


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pumiumtally_tpu_torch as p, chip_smoke\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'pumiumtally_tpu'\n"
        "             or m.startswith('pumiumtally_tpu.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BAD []" in r.stdout


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES]
)
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: stays inside the package
                continue
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "pumiumtally_tpu"), (
                f"{path.name} imports {name}"
            )


# The port's copies of modules of the JAX package that import no JAX
# themselves (the port keeps its own copy of each); the scans above
# cover them like every source of the package.
OWN_COPIES = (
    "utils/log.py", "utils/profiling.py", "obs/registry.py",
    "obs/recorder.py", "obs/telemetry.py", "obs/convergence.py",
    "resilience/quarantine.py", "mesh/osh.py",
    "integrity/invariants.py", "integrity/policy.py", "integrity/audit.py",
    "integrity/watchdog.py", "utils/checkpoint.py", "utils/signals.py",
    "resilience/store.py", "resilience/runner.py",
    "resilience/coordinator.py", "resilience/faultinject.py",
)


@pytest.mark.parametrize("rel", OWN_COPIES)
def test_own_copies_are_scanned_and_import_nothing_of_jax(rel):
    path = PKG / rel
    assert path in SOURCES
    r = _run(
        "import importlib, sys\n"
        f"importlib.import_module('pumiumtally_tpu_torch.' + "
        f"{rel[:-3].replace('/', '.')!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pumiumtally_tpu')]\n"
        "assert not bad, bad\n"
    )
    assert r.returncode == 0, r.stdout + r.stderr


# The partitioned slice's modules (their JAX counterparts import JAX):
# each imports in a fresh interpreter without pulling JAX in.
PARTITIONED_MODULES = (
    "parallel/mesh_partition.py", "parallel/particle_sharding.py",
    "parallel/partitioned_api.py", "ops/walk_partitioned.py",
)


@pytest.mark.parametrize("rel", PARTITIONED_MODULES)
def test_partitioned_modules_import_nothing_of_jax(rel):
    test_own_copies_are_scanned_and_import_nothing_of_jax(rel)


# The autotuner and the ladder (their JAX counterparts import no JAX, but
# the port keeps its own copies): each imports in a fresh interpreter
# without pulling JAX in, the CLI too.
TUNING_MODULES = (
    "tuning/__init__.py", "tuning/shapes.py", "tuning/db.py",
    "tuning/costmodel.py", "tuning/search.py", "tuning/__main__.py",
    "utils/ladder.py",
)


@pytest.mark.parametrize("rel", TUNING_MODULES)
def test_tuning_modules_import_nothing_of_jax(rel):
    test_own_copies_are_scanned_and_import_nothing_of_jax(rel)


# Observability and the serving layer (their JAX counterparts import no
# JAX, but the port keeps its own copies): each imports in a fresh
# interpreter without pulling JAX in, the CLI too.
SERVING_MODULES = (
    "obs/__init__.py", "obs/trace.py", "obs/slo.py", "obs/aggregate.py",
    "obs/profile.py", "obs/exporter.py", "serving/__init__.py",
    "serving/bank.py", "serving/journal.py", "serving/scheduler.py",
    "serving/saturate.py", "serving/__main__.py",
)


@pytest.mark.parametrize("rel", SERVING_MODULES)
def test_serving_modules_import_nothing_of_jax(rel):
    test_own_copies_are_scanned_and_import_nothing_of_jax(rel)


# The serving fleet (its JAX counterparts import no JAX, but the port
# keeps its own copies, fleetview's checks included): each imports in a
# fresh interpreter without pulling JAX in.
FLEET_MODULES = (
    "serving/fleet.py", "serving/gateway.py", "serving/supervisor.py",
    "obs/fleetview.py",
)


@pytest.mark.parametrize("rel", FLEET_MODULES)
def test_fleet_modules_import_nothing_of_jax(rel):
    test_own_copies_are_scanned_and_import_nothing_of_jax(rel)


def test_fleet_entry_points_default_to_cuda(tmp_path):
    """``FleetRouter`` and ``run_fleet_saturation`` place their members on
    the card unless told otherwise, and raise (naming device='cpu')
    before they write anything when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    from pumiumtally_tpu_torch import build_box
    from pumiumtally_tpu_torch.serving import (
        FleetRouter,
        run_fleet_saturation,
    )

    mesh = build_box(1.0, 1.0, 1.0, 2, 2, 2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetRouter(mesh, fleet_dir=str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fleet_saturation(mesh, fleet_dir=str(tmp_path / "b"), n_jobs=1)
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()


def test_fleet_cli_raises_without_a_card(tmp_path):
    """``--fleet`` on the default device raises without a card: no
    fleet directory, no summary line, a non-zero exit."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    r = subprocess.run(
        [sys.executable, "-m", "pumiumtally_tpu_torch.serving", "--demo",
         "1", "--fleet", "2", "--port", "0", "--journal",
         str(tmp_path / "fleet"), "--bank", str(tmp_path / "bank")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0 and "device='cpu'" in r.stderr
    assert '"summary"' not in r.stdout
    assert not (tmp_path / "fleet").exists()
    assert not (tmp_path / "bank").exists()


def test_partitioned_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    from pumiumtally_tpu_torch import PartitionedTally, build_box
    from pumiumtally_tpu_torch.parallel.particle_sharding import (
        make_device_mesh,
    )

    mesh = build_box(1.0, 1.0, 1.0, 2, 2, 2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PartitionedTally(mesh, 4, n_parts=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_device_mesh(2)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    from pumiumtally_tpu_torch import PumiTally, TetMesh, build_box

    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_box(1.0, 1.0, 1.0, 2, 2, 2)
    mesh = build_box(1.0, 1.0, 1.0, 2, 2, 2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PumiTally(mesh, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TetMesh.from_numpy(
            mesh.coords.numpy(), mesh.tet2vert.numpy().astype(np.int64)
        )


def test_serving_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    from pumiumtally_tpu_torch import build_box
    from pumiumtally_tpu_torch.serving import TallyScheduler

    mesh = build_box(1.0, 1.0, 1.0, 2, 2, 2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TallyScheduler(mesh)
    r = subprocess.run(
        [sys.executable, "-m", "pumiumtally_tpu_torch.serving", "--demo",
         "1", "--bank", str(tmp_path / "bank")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0 and "device='cpu'" in r.stderr
    assert '"summary"' not in r.stdout
    assert not (tmp_path / "bank").exists()


def test_bank_build_raises_without_nvcc(monkeypatch, tmp_path):
    """The bank builds with ``_build``'s nvcc and has nothing to fall back
    to; a failed build leaves no entry."""
    from pumiumtally_tpu_torch.ops import _build
    from pumiumtally_tpu_torch.serving import ProgramBank

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    bank = ProgramBank(str(tmp_path / "bank"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bank.library("walk")
    assert bank.entries_on_disk() == [] and bank.misses == 1


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from pumiumtally_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("walk")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("walk")
    assert not (tmp_path / "build").exists()


def test_build_failure_shows_nvcc_output(monkeypatch, tmp_path):
    """A failing compiler's output reaches the error; nothing is kept."""
    from pumiumtally_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build("walk")
    assert not list((tmp_path / "build").glob("*.so"))


def test_import_builds_nothing():
    code = (
        "import subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('subprocess started at import')\n"
        "subprocess.run = subprocess.Popen = refuse\n"
        "from pumiumtally_tpu_torch.ops import _build, walk_cuda\n"
        "import pumiumtally_tpu_torch\n"
        "assert _build._libs == {}, _build._libs\n"
        "assert walk_cuda.LAUNCHES == 0\n"
        "print('OK')\n"
    )
    r = _run(code)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr


def test_library_path_tracks_source_and_flags():
    from pumiumtally_tpu_torch.ops import _build

    p = _build.library_path("walk")
    assert p.startswith(_build.BUILD_DIR) and p.endswith(".so")
    assert "lib" + "walk-" in os.path.basename(p)
    flags = " ".join(_build.NVCC_FLAGS)
    assert "sm_90a" in flags and "--fmad=false" in flags


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", lone / "chip_smoke.py")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=lone, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
