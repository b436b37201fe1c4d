"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (``extern "C"``
functions taking ``void*`` pointers and returning a ``cudaError_t``), so
it builds without PyTorch's headers in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC --fmad=false -Xptxas=-v

into ``pumiumtally_tpu_torch/_build/lib<name>-<hash>.so``, where the hash
covers the source and the flags, so an edited source never loads a stale
library. ``--fmad=false`` keeps the kernels' arithmetic operation for
operation equal to their plain PyTorch versions. ptxas's register and
spill report is kept beside the library as ``.log``.

Nothing is built at import: the first ``load(name)`` builds. A missing
``nvcc`` or a failed build raises with nvcc's output; there is no
fallback. ``build_dir=`` builds elsewhere (the library bank,
``serving/bank.py``, builds each library into its own entry), and
``load(name, path=)`` loads a library built there. A process loads one
library of each name: asking for another path of a name already loaded
raises.

Each wrapper module lists the C entries it binds (``SYMBOLS``) and binds
them through ``bind``, which refuses a name not on its list; the bank
records those lists (``bound_symbols``) and checks them at load.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas=-v",
)

DEFAULT_CUDA_HOME = "/usr/local/cuda"

#: The wrapper module of each source, the one that binds its entries.
WRAPPERS = {"walk": "walk_cuda", "scatter": "scatter",
            "source": "source_cuda", "gather": "gather",
            "exchange": "exchange_cuda", "integrity": "integrity_cuda"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_paths: dict[str, str] = {}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME, else under
    ``DEFAULT_CUDA_HOME``. Raises RuntimeError when there is none."""
    candidates = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/ at first use and need "
        "the CUDA toolkit"
    )


@functools.cache
def nvcc_version() -> str | None:
    """The last line of ``nvcc --version`` (its release and build), or
    None when there is no nvcc."""
    try:
        out = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[-1] if lines else None


def source_path(name: str) -> str:
    return os.path.join(SRC_DIR, f"{name}.cu")


def source_digest(name: str) -> str:
    """sha256 of ``csrc/<name>.cu`` and the nvcc flags: the library's
    identity (its first 16 hex digits name the file)."""
    with open(source_path(name), "rb") as f:
        return hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                              ).hexdigest()


def library_path(name: str, build_dir: str | None = None) -> str:
    """Where ``csrc/<name>.cu`` builds to (content- and flag-hashed), in
    ``build_dir`` or the package's ``_build/``."""
    return os.path.join(build_dir or BUILD_DIR,
                        f"lib{name}-{source_digest(name)[:16]}.so")


def bound_symbols(name: str) -> list[str]:
    """The C entries of ``csrc/<name>.cu`` that its wrapper binds (the
    wrapper module's ``SYMBOLS``)."""
    mod = importlib.import_module(f".{WRAPPERS[name]}", __package__)
    return sorted(mod.SYMBOLS)


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library path. Raises RuntimeError with nvcc's output on failure."""
    return build_many([name])[0]


def build_many(names, build_dir=None) -> list[str]:
    """``build`` for several sources, one nvcc process each, all started
    together; returns the library paths in order. ``build_dir`` is one
    directory for all, or a list of one a name. Raises RuntimeError with
    nvcc's output if any build fails."""
    from ..utils.checkpoint import atomic_write_bytes

    names = list(names)
    dirs = (list(build_dir) if isinstance(build_dir, (list, tuple))
            else [build_dir] * len(names))
    outs = [library_path(n, d) for n, d in zip(names, dirs)]
    todo = [(n, o) for n, o in zip(names, outs) if not os.path.exists(o)]
    if not todo:
        return outs
    nvcc = find_nvcc()
    for _, out in todo:
        os.makedirs(os.path.dirname(out), exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = f"{out}.tmp.{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs.append((name, out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            failed.append(
                f"nvcc failed to build csrc/{name}.cu (exit "
                f"{proc.returncode}):\n{' '.join(cmd)}\n{stdout}{stderr}"
            )
            continue
        # The bank reads this log back into an entry's META
        # (serving/bank.py::ptxas_summary): written whole or not at all.
        atomic_write_bytes(out[:-3] + ".log", (stdout + stderr).encode())
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str, path: str | None = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``: on first use the one at
    ``path`` (a bank's entry) or, without one, the package's own build.
    Its kernels keep state on the card, so a process holds one copy: a
    ``path`` other than the one loaded raises RuntimeError."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = path or build(name)
            lib = _libs[name] = ctypes.CDLL(path)
            _paths[name] = path
        elif path is not None and (os.path.realpath(path)
                                   != os.path.realpath(_paths[name])):
            raise RuntimeError(
                f"csrc/{name}.cu is loaded from {_paths[name]} in this "
                f"process; it cannot also load {path}")
        return lib


def loaded_path(name: str) -> str | None:
    """The file this process loaded ``csrc/<name>.cu`` from, or None."""
    return _paths.get(name)


def bind(name: str, symbol: str, symbols) -> ctypes._CFuncPtr:
    """``symbol`` of the loaded ``csrc/<name>.cu``; the wrapper's
    ``symbols`` must list it (the bank checks that list at load)."""
    if symbol not in symbols:
        raise KeyError(f"{symbol} is not among the entries the "
                       f"csrc/{name}.cu wrapper lists: {sorted(symbols)}")
    return getattr(load(name), symbol)
