"""Python side of the C ABI bridge (``csrc/host/pumi_tally_c.cpp``).

Counterpart of ``pumiumtally_tpu/capi.py``. The embedded interpreter calls
these functions with the C caller's raw pointers wrapped as writable
memoryviews; ``np.frombuffer`` turns them into zero-copy numpy views, so
the facade's write-backs (clipped positions, zeroed ``flying``, material
ids) land in the C caller's buffers under every ``io_pipeline`` mode — the
raw-pointer contract the reference's pimpl facade gives OpenMC
(pumipic_particle_data_structure.h:20-47), without a staging copy.

Handles are integers into a registry (the C struct carries the id). A
tally runs on the CUDA card; an embedded host that wants the CPU sets
``PUMI_TPU_PLATFORM=cpu`` (the variable the JAX bridge reads). Without it
``create`` raises on a machine with no card: there is no CPU fallback.

``build_bridge()`` builds the bridge library, the demo host and the replay
host (a test harness that drives the ABI with a recorded run) with g++ and
the running interpreter's ``sysconfig``; ``host_env()`` is the environment
a host needs to find this package and torch from its embedded interpreter.
"""
from __future__ import annotations

import hashlib
import itertools
import os
import shutil
import site
import subprocess
import sys
import sysconfig
import time

import numpy as np

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PKG_DIR)
HOST_DIR = os.path.join(PKG_DIR, "csrc", "host")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
HOST_SOURCES = ("pumi_tally_c.cpp", "demo_host.c", "replay_host.c",
                os.path.join("include", "pumi_tally.h"))
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
CC_FLAGS = ("-O2",)
PLATFORM_ENV = "PUMI_TPU_PLATFORM"

_registry: dict = {}
_ids = itertools.count(1)


def platform_device():
    """The device ``create`` places a tally on: ``"cpu"`` when
    ``PUMI_TPU_PLATFORM=cpu``, else None (the CUDA card)."""
    value = os.environ.get(PLATFORM_ENV, "").strip().lower()
    if value in ("", "cuda", "gpu"):
        return None
    if value == "cpu":
        return "cpu"
    raise ValueError(
        f"{PLATFORM_ENV}={value!r}: this bridge runs on 'cuda' (the "
        "default) or 'cpu'")


def create(mesh_file: str, num_particles: int, n_groups: int) -> int:
    from .api import PumiTally
    from .utils.config import TallyConfig

    tally = PumiTally(mesh_file, num_particles,
                      TallyConfig(n_groups=n_groups),
                      device=platform_device())
    handle = next(_ids)
    _registry[handle] = tally
    return handle


def destroy(handle: int) -> None:
    tally = _registry.pop(handle, None)
    if tally is not None:
        tally.close()


def _view(mv: memoryview, dtype, count: int) -> np.ndarray:
    arr = np.frombuffer(mv, dtype=dtype, count=count)
    if not arr.flags.writeable:
        raise ValueError("C buffer must be writable")
    return arr


def initialize_particle_location(handle: int, positions: memoryview,
                                 size: int) -> None:
    t = _registry[handle]
    t.initialize_particle_location(_view(positions, np.float64, size), size)


def move_to_next_location(handle: int, dests: memoryview,
                          flying: memoryview, weights: memoryview,
                          groups: memoryview, material_ids: memoryview,
                          size: int) -> None:
    t = _registry[handle]
    n = t.num_particles
    t.move_to_next_location(
        _view(dests, np.float64, size),
        _view(flying, np.int8, n),
        _view(weights, np.float64, n),
        _view(groups, np.int32, n),
        _view(material_ids, np.int32, n),
        size,
    )


def write(handle: int, filename: str) -> None:
    _registry[handle].write_pumi_tally_mesh(filename)


def get_flux(handle: int, out: memoryview, capacity: int) -> int:
    """The raw flux as float64 in the JAX layout ``[ntet * G * 2]``."""
    flux = np.asarray(_registry[handle].raw_flux, np.float64).ravel()
    if flux.size > capacity:
        raise ValueError(
            f"flux has {flux.size} entries, buffer holds {capacity}")
    _view(out, np.float64, flux.size)[:] = flux
    return int(flux.size)


# --------------------------------------------------------------------- #
# Building and running the C hosts
# --------------------------------------------------------------------- #
def python_flags() -> tuple[list, list]:
    """(compile flags, link flags) that embed the running interpreter,
    from ``sysconfig`` (``python3-config`` may be missing). Raises
    RuntimeError when the interpreter has no headers or no shared
    libpython to embed with."""
    include = sysconfig.get_paths()["include"]
    plat = sysconfig.get_paths().get("platinclude", include)
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(
            f"Python.h not found under {include}: this interpreter cannot "
            "be embedded (its development headers are not installed)")
    cflags = sorted({f"-I{include}", f"-I{plat}"})
    var = sysconfig.get_config_var
    extra = (var("LIBS") or "").split() + (var("SYSLIBS") or "").split()
    libdir, lib = var("LIBDIR") or "", var("LDLIBRARY") or ""
    if not var("Py_ENABLE_SHARED") or not os.path.exists(
            os.path.join(libdir, lib)):
        raise RuntimeError(
            f"no shared libpython ({lib} under {libdir}): the bridge "
            "library embeds the interpreter through it")
    return cflags, [f"-L{libdir}", f"-l:{lib}", f"-Wl,-rpath,{libdir}",
                    *extra]


def _digest(flags: list) -> str:
    h = hashlib.sha256()
    for rel in HOST_SOURCES:
        with open(os.path.join(HOST_DIR, rel), "rb") as f:
            h.update(f.read())
    h.update(" ".join((*CXX_FLAGS, *CC_FLAGS, *flags, sys.version)).encode())
    return h.hexdigest()[:16]


def _compile(cmd: list, out: str) -> None:
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd = [tmp if a == out else a for a in cmd]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed:\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build_bridge() -> dict:
    """Build (once per source and flags) the bridge library
    ``libpumi_tally_c-<hash>.so``, ``demo_host-<hash>`` and
    ``replay_host-<hash>`` into the ignored ``_build/``, the hosts linked
    to the bridge by an ``$ORIGIN`` rpath. Returns their paths and the
    build's seconds. Raises RuntimeError when g++/gcc are missing or a
    build fails."""
    cxx = shutil.which("g++")
    cc = shutil.which("gcc") or shutil.which("cc")
    if cxx is None or cc is None:
        raise RuntimeError("g++ and gcc are needed to build the C ABI")
    cflags, lflags = python_flags()
    tag = _digest(cflags + lflags)
    lib_name = f"libpumi_tally_c-{tag}.so"
    paths = {"lib": os.path.join(BUILD_DIR, lib_name),
             "demo_host": os.path.join(BUILD_DIR, f"demo_host-{tag}"),
             "replay_host": os.path.join(BUILD_DIR, f"replay_host-{tag}")}
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    if not os.path.exists(paths["lib"]):
        _compile([cxx, *CXX_FLAGS, os.path.join(HOST_DIR, "pumi_tally_c.cpp"),
                  *cflags, f"-I{HOST_DIR}", "-o", paths["lib"], *lflags],
                 paths["lib"])
    for host in ("demo_host", "replay_host"):
        if not os.path.exists(paths[host]):
            _compile([cc, *CC_FLAGS, os.path.join(HOST_DIR, f"{host}.c"),
                      f"-I{HOST_DIR}", f"-L{BUILD_DIR}", f"-l:{lib_name}",
                      "-Wl,-rpath,$ORIGIN", "-o", paths[host]], paths[host])
    return dict(paths, seconds=time.perf_counter() - t0)


def host_env(device=None) -> dict:
    """The environment of a C host of this bridge: ``PYTHONPATH`` holds the
    repository and the running interpreter's site-packages (the embedded
    interpreter starts from the base prefix and would not see a venv's),
    and ``device="cpu"`` sets ``PUMI_TPU_PLATFORM=cpu``."""
    env = dict(os.environ)
    paths = [REPO_DIR, *site.getsitepackages()]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(paths)
    if device is not None and str(device) == "cpu":
        env[PLATFORM_ENV] = "cpu"
    else:
        env.pop(PLATFORM_ENV, None)
    return env


def write_replay_inputs(dirname: str, positions: np.ndarray,
                        moves: list) -> None:
    """Write a recorded run for the replay host: ``positions`` [n, 3] and,
    per move, (dests [n, 3] float64, flying int8, weights float64, groups
    int32, material ids int32)."""
    os.makedirs(dirname, exist_ok=True)
    np.ascontiguousarray(positions, np.float64).tofile(
        os.path.join(dirname, "pos.bin"))
    dtypes = (np.float64, np.int8, np.float64, np.int32, np.int32)
    for m, arrays in enumerate(moves, start=1):
        with open(os.path.join(dirname, f"move_{m}.bin"), "wb") as f:
            for a, dt in zip(arrays, dtypes):
                np.ascontiguousarray(a, dt).tofile(f)


def read_replay_outputs(dirname: str, n: int, moves: int) -> dict:
    """The replay host's outputs: ``flux`` (float64) and, per move,
    ``(dests [n, 3], flying, material ids)`` as written back into the C
    buffers."""
    out = {"flux": np.fromfile(os.path.join(dirname, "flux.bin"),
                               np.float64), "moves": []}
    for m in range(1, moves + 1):
        raw = np.fromfile(os.path.join(dirname, f"out_{m}.bin"), np.uint8)
        d, f = 24 * n, 25 * n
        out["moves"].append((raw[:d].view(np.float64).reshape(n, 3),
                             raw[d:f].view(np.int8),
                             raw[f:f + 4 * n].view(np.int32)))
    return out


def parse_host_seconds(stdout: str) -> dict:
    """The replay host's seconds a call: ``create_s``, ``init_s``,
    ``flux_s``, ``write_s`` and ``move_s`` (a list in move order)."""
    out: dict = {"move_s": []}
    for line in stdout.splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[0].endswith("_S"):
            out[parts[0].lower()] = float(parts[1])
        elif len(parts) == 3 and parts[0] == "MOVE_S":
            out["move_s"].append(float(parts[2]))
    return out
