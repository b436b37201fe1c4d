"""The native host runtime (``csrc/host/pumi_native.cpp``): the
face-adjacency hash, the derived face-plane and volume tables and the Gmsh
ASCII tokenizer, compiled with g++ and called through ctypes.

Counterpart of ``pumiumtally_tpu/native/__init__.py``, with its own copy
of the source. Every table it returns is bit for bit the numpy path's
(``mesh/core.py``, ``mesh/io.py``): the source sums its dot products in
numpy's order and is built with ``-ffp-contract=off`` and no
``-march=native``, so no host fuses a product into an FMA.

The library is built at first use (never at import) into the ignored
``pumiumtally_tpu_torch/_build/`` as ``libpumi_native-<hash>.so``, where the
hash covers the source and the flags, so an edited source never loads a
stale library. It is a host accelerator, not a device kernel: without g++,
or with ``PUMI_TPU_NATIVE=0``, the callers take the numpy path, which gives
the same tables. ``CALLS`` counts the calls that went through the library,
so a caller can tell which path ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(PKG_DIR, "csrc", "host", "pumi_native.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             "-ffp-contract=off")
ABI_VERSION = 1

#: Calls served by the native library, by function.
CALLS = {"build_tet2tet": 0, "derive_geometry": 0, "parse_gmsh": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def library_path() -> str:
    """Where the library of the current source and flags is built."""
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libpumi_native-{h.hexdigest()[:16]}.so")


def _build(lib: str) -> bool:
    # A private temporary name and an atomic rename: concurrent first
    # builds (pytest-xdist workers, server processes) each compile on
    # their own and every rename leaves a whole library.
    tmp = f"{lib}.tmp.{os.getpid()}"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, lib)
    except (subprocess.SubprocessError, OSError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False
    return True


def load() -> ctypes.CDLL | None:
    """The native library, built if needed, or None (no g++, a failed
    build, or ``PUMI_TPU_NATIVE=0``)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if os.environ.get("PUMI_TPU_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _load_failed = True
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.pn_build_tet2tet.restype = ctypes.c_int
        lib.pn_build_tet2tet.argtypes = [i64p, ctypes.c_int64, i64p]
        lib.pn_derive_geometry.restype = None
        lib.pn_derive_geometry.argtypes = [f64p, i64p, ctypes.c_int64, f64p,
                                           f64p, f64p]
        lib.pn_gmsh_open.restype = ctypes.c_void_p
        lib.pn_gmsh_open.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.POINTER(ctypes.c_int64)]
        lib.pn_gmsh_fill.restype = None
        lib.pn_gmsh_fill.argtypes = [ctypes.c_void_p, f64p, i64p, i32p]
        lib.pn_gmsh_free.restype = None
        lib.pn_gmsh_free.argtypes = [ctypes.c_void_p]
        lib.pn_abi_version.restype = ctypes.c_int
        if lib.pn_abi_version() != ABI_VERSION:
            _load_failed = True
            return None
        _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def build_tet2tet(tet2vert: np.ndarray) -> np.ndarray | None:
    """Native face-adjacency build, or None without the library. Raises
    ValueError on a non-manifold mesh (a face shared by more than two
    tets): no walk table can be built for it."""
    lib = load()
    if lib is None:
        return None
    tet2vert = np.ascontiguousarray(tet2vert, dtype=np.int64)
    ntet = tet2vert.shape[0]
    out = np.empty((ntet, 4), dtype=np.int64)
    rc = lib.pn_build_tet2tet(tet2vert, ntet, out)
    CALLS["build_tet2tet"] += 1
    if rc != 0:
        raise ValueError(
            "non-manifold mesh: some face is shared by more than two "
            "tetrahedra"
        )
    return out


def derive_geometry(coords: np.ndarray, tet2vert: np.ndarray):
    """The derived tables in one threaded pass: canonicalizes ``tet2vert``'s
    orientation IN PLACE and returns (tet2vert, volumes, normals [ntet, 4,
    3], face_d [ntet, 4]), or None without the library."""
    lib = load()
    if lib is None:
        return None
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    tet2vert = np.ascontiguousarray(tet2vert, dtype=np.int64)
    ntet = tet2vert.shape[0]
    volumes = np.empty(ntet, dtype=np.float64)
    normals = np.empty(ntet * 12, dtype=np.float64)
    face_d = np.empty(ntet * 4, dtype=np.float64)
    lib.pn_derive_geometry(coords, tet2vert, ntet, volumes, normals, face_d)
    CALLS["derive_geometry"] += 1
    return (tet2vert, volumes, normals.reshape(ntet, 4, 3),
            face_d.reshape(ntet, 4))


def parse_gmsh(filename: str):
    """Native Gmsh ASCII reader (v2.2 and v4.1): (coords, tet2vert,
    class_id), or None (no library, binary files, sparse node ids and
    files it cannot parse go to the Python reader)."""
    lib = load()
    if lib is None:
        return None
    n_nodes = ctypes.c_int64(0)
    n_tets = ctypes.c_int64(0)
    handle = lib.pn_gmsh_open(os.fsencode(filename), ctypes.byref(n_nodes),
                              ctypes.byref(n_tets))
    if not handle:
        return None
    try:
        coords = np.empty((n_nodes.value, 3), dtype=np.float64)
        tet2vert = np.empty((n_tets.value, 4), dtype=np.int64)
        class_id = np.empty(n_tets.value, dtype=np.int32)
        lib.pn_gmsh_fill(handle, coords, tet2vert, class_id)
    finally:
        lib.pn_gmsh_free(handle)
    CALLS["parse_gmsh"] += 1
    return coords, tet2vert, class_id
