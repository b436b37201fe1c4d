"""Shared set-up of the port's serving tests: the library bank's toy
build and load stand-ins, and a job's uninterrupted run.

There is no nvcc on the CPU, so the bank's bookkeeping is driven with
toy libraries: ``toy_build`` writes ``lib<name>-<hash>.so`` files whose
bytes name the symbols the wrappers bind and a ptxas-style ``.log``
beside each; ``toy_loader`` accepts exactly such files (the role
``ctypes`` plays on the card)."""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from pumiumtally_tpu_torch import PumiTally
from pumiumtally_tpu_torch.ops import _build
from pumiumtally_tpu_torch.tuning.shapes import bucket

PTXAS_LOG = (
    "ptxas info    : Function properties for _Z4walkILi128EEvv\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 64 registers, used 1 barriers, 6144 bytes smem\n"
)


def toy_build(names, dirs):
    out = []
    for name, d in zip(names, dirs):
        path = _build.library_path(name, d)
        os.makedirs(d, exist_ok=True)
        with open(path, "wb") as f:
            f.write(("toy " + " ".join(_build.bound_symbols(name)))
                    .encode())
        with open(path[:-3] + ".log", "w") as f:
            f.write(PTXAS_LOG)
        out.append(path)
    return out


def toy_loader(path, symbols):
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"toy "):
        raise OSError(f"{path}: invalid ELF header")
    have = set(data[4:].decode().split())
    for sym in symbols:
        if sym not in have:
            raise AttributeError(f"{path}: undefined symbol: {sym}")


def toy_bank(root, **kw):
    from pumiumtally_tpu_torch.serving import ProgramBank

    return ProgramBank(str(root), build=toy_build, loader=toy_loader,
                       **kw)


def padded(request):
    """A request's origins, weights, groups and alive flags padded to its
    shape bucket, as the scheduler pads them."""
    origins = np.asarray(request.origins, np.float64).reshape(-1, 3)
    n = origins.shape[0]
    N = bucket(n)
    pad = np.broadcast_to(origins[0], (N - n, 3))
    return (np.concatenate([origins, pad], axis=0),
            np.concatenate([np.ones(n), np.zeros(N - n)]),
            np.zeros(N, np.int32),
            np.concatenate([np.ones(n, bool), np.zeros(N - n, bool)]))


def solo_reference(mesh, request, quantum, cfg, device="cpu"):
    """The uninterrupted facade run of one scheduler job: padded to the
    same bucket, chunked the same way (megastep = the quantum)."""
    origins, w, g, alive = padded(request)
    t = PumiTally(mesh, origins.shape[0],
                  dataclasses.replace(cfg, megastep=quantum), device=device)
    t.initialize_particle_location(origins.reshape(-1).copy())
    t.run_source_moves(request.n_moves, request.source, weights=w,
                       groups=g, alive=alive)
    return t.raw_flux.copy()
