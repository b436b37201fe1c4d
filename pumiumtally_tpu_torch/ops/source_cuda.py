"""Wrapper of the flight-sampling kernel ``csrc/source.cu``.

``sample_flight`` gives one move's sampled destinations and collision and
roulette draws for every lane, keyed by (seed, move, particle id): the
counterpart of ``pumiumtally_tpu/ops/source.py::sample_move`` (:179) and
of the flight in the JAX megastep's body, which the JAX package left to
XLA, in both its forms: one mesh (``ops/walk.py::megastep``) and the
partitioned megastep's stacked slots
(``ops/walk_partitioned.py::make_partitioned_megastep``, JAX
``walk_partitioned.py:1385-1387``), where lane i looks up its region by
its part-local row ``(i // cap)·max_local + clip(elem, 0, max_local-1)``
of the stacked class table. A CPU tensor goes to the plain version
(``ops/source.py::sample_flight_plain``); a CUDA tensor goes to the
kernel, built with nvcc at first use (``ops/_build.py``), or raises.
``LAUNCHES`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .source import sample_flight_plain

LAUNCHES = 0

_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}
_ARGTYPES = (
    [ctypes.c_uint] * 2                  # move key words
    + [ctypes.c_void_p, ctypes.c_int]    # pid, n_total
    + [ctypes.c_void_p] * 4              # elem, alive, origin, class_id
    + [ctypes.c_int] * 2                 # cap, max_local
    + [ctypes.c_void_p]                  # sigma_t
    + [ctypes.c_int] * 2                 # nclass, n
    + [ctypes.c_void_p] * 5              # dest, coll_u, roul_u, u_out, stream
)
#: The C entries of csrc/source.cu this module binds.
SYMBOLS = tuple(f"pumi_sample_flight_{t}" for t in _DTYPE_TAG.values()) + (
    "pumi_source_smem",)
_FNS: dict = {}


def _entry(dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        fn = _build.bind("source", f"pumi_sample_flight_{_DTYPE_TAG[dtype]}",
                         SYMBOLS)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def dynamic_smem() -> int:
    """The dynamic shared memory bytes a flight launch passes
    (``pumi_source_smem``; analysis/costmodel.py checks its mirror)."""
    fn = _build.bind("source", "pumi_source_smem", SYMBOLS)
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return int(fn())


def _check(pid, elem, alive, origin, class_id, sigma_t, cap, max_local):
    dtype, dev = origin.dtype, origin.device
    n = origin.shape[0]
    if dtype not in _DTYPE_TAG:
        raise ValueError(f"the flight is float32 or float64, not {dtype}")
    expect = {
        "pid": (pid, (n,), torch.int32), "elem": (elem, (n,), torch.int32),
        "alive": (alive, (n,), torch.bool), "origin": (origin, (n, 3), dtype),
        "class_id": (class_id, tuple(class_id.shape[:1]), torch.int32),
        "sigma_t": (sigma_t, tuple(sigma_t.shape[:1]), dtype),
    }
    for name, (t, shape, dt) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, origin on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if class_id.numel() == 0 or sigma_t.numel() == 0:
        raise ValueError("class_id and sigma_t must not be empty")
    if cap < 1 or n % cap:
        raise ValueError(f"{n} lanes do not split into blocks of cap={cap}")
    if max_local < 1 or (n // cap) * max_local > class_id.shape[0]:
        raise ValueError(
            f"class_id has {class_id.shape[0]} rows; {n // cap} block(s) of "
            f"max_local={max_local} need {(n // cap) * max_local}")


def sample_flight(move_key, pid, n_total: int, elem, alive, origin,
                  class_id, sigma_t, u_out=None, *, cap: int | None = None,
                  max_local: int | None = None):
    """One move's ``(dest [n,3], coll_u [n], roul_u [n])``: ``move_key``
    is the move key's two uint32 words (``source.fold_in(base key,
    move)``, host ints), ``pid``/``elem`` int32 ``[n]``, ``alive`` bool
    ``[n]``, ``origin`` ``[n,3]`` in the walk dtype, ``class_id`` the
    mesh's int32 region per element, ``sigma_t`` the Σt table in the walk
    dtype. ``u_out``, a ``[n, 5]`` tensor of the walk dtype, receives the
    lanes' uniforms (a check of the draws). ``cap`` and ``max_local``
    (default: the lanes and ``class_id``'s rows, one mesh) give the
    stacked slots' rows: lane i's region is ``class_id[(i // cap)·
    max_local + clip(elem, 0, max_local-1)]``. CPU tensors take
    ``sample_flight_plain``; CUDA tensors the kernel."""
    global LAUNCHES
    n, dtype, dev = origin.shape[0], origin.dtype, origin.device
    cap = n if cap is None else int(cap)
    max_local = class_id.shape[0] if max_local is None else int(max_local)
    _check(pid, elem, alive, origin, class_id, sigma_t, max(cap, 1),
           max_local)
    if not 1 <= n_total < 2**31:
        raise ValueError(f"n_total must lie in [1, 2^31): {n_total}")
    if u_out is not None and (tuple(u_out.shape) != (n, 5)
                              or u_out.dtype != dtype or u_out.device != dev
                              or not u_out.is_contiguous()):
        raise ValueError(f"u_out must be a contiguous [{n}, 5] {dtype} "
                         f"tensor on {dev}")
    if dev.type == "cpu":
        out = sample_flight_plain(move_key, pid, n_total, elem, alive,
                                  origin, class_id, sigma_t, cap=cap,
                                  max_local=max_local)
        if u_out is not None:
            from .source import lane_uniforms

            u_out.copy_(lane_uniforms(move_key, pid, n_total, dtype))
        return out
    if dev.type != "cuda":
        raise ValueError(f"the flight runs on 'cuda' or 'cpu', not {dev}")
    dest = torch.empty_like(origin)
    coll_u = torch.empty(n, dtype=dtype, device=dev)
    roul_u = torch.empty(n, dtype=dtype, device=dev)
    if n == 0:
        return dest, coll_u, roul_u
    fn = _entry(dtype)
    k0, k1 = (int(w) for w in move_key)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(k0, k1, pid.data_ptr(), int(n_total), elem.data_ptr(),
                 alive.data_ptr(), origin.data_ptr(), class_id.data_ptr(),
                 cap, max_local, sigma_t.data_ptr(), sigma_t.shape[0], n,
                 dest.data_ptr(), coll_u.data_ptr(), roul_u.data_ptr(),
                 None if u_out is None else u_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"flight sampling kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return dest, coll_u, roul_u
