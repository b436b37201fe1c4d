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
fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
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

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to (content- and flag-hashed)."""
    with open(os.path.join(SRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library path. Raises RuntimeError with nvcc's output on failure."""
    return build_many([name])[0]


def build_many(names) -> list[str]:
    """``build`` for several sources, one nvcc process each, all started
    together; returns the library paths in order. Raises RuntimeError
    with nvcc's output if any build fails."""
    outs = [library_path(name) for name in names]
    todo = [(n, o) for n, o in zip(names, outs) if not os.path.exists(o)]
    if not todo:
        return outs
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = f"{out}.tmp.{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(SRC_DIR, f"{name}.cu")]
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
        with open(out[:-3] + ".log", "w") as f:
            f.write(stdout + stderr)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib
