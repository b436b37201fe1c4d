"""The multi-process layer on ``torch.distributed``.

Counterpart of ``pumiumtally_tpu/parallel/multihost.py``. Every process
runs the same program; ``init_distributed`` joins them into the default
process group (NCCL when the process's device is a CUDA card, gloo when
it is the CPU), and a device mesh whose entries carry a rank and a
device (``ranks.MeshEntry``, built by ``global_device_mesh``)
spreads the partitioned step's parts over the processes
(``ops/walk_partitioned.py``: the exchange, the stop test and the halo
fold become collectives) or the particle shards of
``parallel/particle_sharding.py`` (the tally reduction an all_reduce).

  * ``init_distributed`` — joins the group once, from arguments or the
    torchrun variables (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``); a no-op for one process unless asked for a group of one.
  * ``global_device_mesh`` — the parts (or shards) of every process, in
    rank order.
  * ``host_local_batch`` — this process's contiguous share of a global
    batch (the work_per_rank split).
  * ``allreduce_flux`` — the per-process partial tallies summed into
    every process's copy: ``dist.all_reduce`` on a device tensor, or with
    ``in_program=False`` a host gather and a numpy sum (an explicit
    choice; a failing collective raises).
  * ``write_parallel_vtk`` — a .vtu piece a process, rank 0 the .pvtu.

The two-process tests (tests/test_torch_multihost.py) run gloo on the
CPU; on one card a group of one rank runs NCCL.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.platform import resolve_device
from .ranks import MeshEntry

_initialized = False


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None, *, device=None,
                     group_of_one: bool = False,
                     timeout_s: float | None = None) -> bool:
    """Join the default process group once; True when a group is up.

    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK``
    (1 and 0); ``init_method`` to ``env://`` when ``MASTER_ADDR`` and
    ``MASTER_PORT`` are set (torchrun's contract), else it must be given
    (``tcp://host:port`` or ``file:///path``). One process, or no
    address, is a no-op returning False, unless ``group_of_one`` (a
    group of one rank: the collective code path on one device). The
    backend follows ``device`` (default the CUDA card): NCCL for a CUDA
    device, which becomes this process's current device, gloo for the
    CPU; there is no fallback from one to the other. A second call
    returns True without touching the group."""
    global _initialized
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None and {"MASTER_ADDR", "MASTER_PORT"} <= set(
            os.environ):
        init_method = "env://"
    if (world_size <= 1 and not group_of_one) or init_method is None:
        return False
    if _initialized or dist.is_initialized():
        _initialized = True
        return True
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if timeout_s is not None:
        import datetime

        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(_backend(dev), init_method=init_method,
                            world_size=int(world_size), rank=int(rank), **kw)
    _initialized = True
    return True


def _rank_size() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def group_device() -> torch.device:
    """This process's device in the group: the current CUDA card under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_device_mesh(parts_per_rank: int = 1, device=None) -> list:
    """A 1-D mesh over every process: ``parts_per_rank`` entries
    ``MeshEntry(rank, device)`` a process, in rank order (each process's
    own ``device``, default its group device). Without a group, the
    entries of one process: ``parts_per_rank`` torch devices."""
    if not (dist.is_available() and dist.is_initialized()):
        dev = resolve_device(device)
        return [dev] * int(parts_per_rank)
    dev = group_device() if device is None else resolve_device(device)
    devs = [None] * dist.get_world_size()
    dist.all_gather_object(devs, str(dev))
    return [MeshEntry(r, torch.device(d)) for r, d in enumerate(devs)
            for _ in range(int(parts_per_rank))]


def host_local_batch(n_global: int) -> tuple[int, int]:
    """This process's contiguous (start, count) share of a global batch —
    the work_per_rank split."""
    rank, size = _rank_size()
    base, rem = divmod(n_global, size)
    start = rank * base + min(rank, rem)
    count = base + (1 if rank < rem else 0)
    return start, count


def allreduce_flux(local_flux, in_program: bool = True) -> np.ndarray:
    """Sum the processes' partial ``[ntet, n_groups, 2]`` tallies; every
    process gets the sum (numpy). ``in_program``: one ``dist.all_reduce``
    on a tensor on the group's device (``local_flux`` itself when it is a
    tensor there). ``in_program=False``: every partial gathered to every
    host (``all_gather_object``) and summed in rank order with numpy. A
    failing collective raises. One process returns its own tally.

    Under ``sd_mode="batch"`` each process's slot 1 is a sum over its own
    batches; pass ``n_iterations = moves × processes`` to the batch
    normalization (the JAX function's note)."""
    rank, size = _rank_size()
    if size == 1:
        if isinstance(local_flux, torch.Tensor):
            return local_flux.detach().cpu().numpy()
        return np.asarray(local_flux)
    if not in_program:
        host = (local_flux.detach().cpu().numpy()
                if isinstance(local_flux, torch.Tensor)
                else np.asarray(local_flux))
        got = [None] * size
        dist.all_gather_object(got, host)
        total = got[0].copy()
        for g in got[1:]:
            total = total + g
        return total
    dev = group_device()
    t = (local_flux if isinstance(local_flux, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(local_flux)))
    t = t.detach().to(dev, copy=True).contiguous()
    dist.all_reduce(t)
    return t.cpu().numpy()


def write_parallel_vtk(basename: str, mesh, normalized_flux,
                       elem_slice: slice | None = None) -> str:
    """Per-process parallel VTK: each process writes its own .vtu piece
    (``elem_slice`` restricts it to those elements), process 0 the .pvtu
    index. Returns this process's piece path."""
    from ..io.vtk import write_pvtu, write_vtu

    rank, size = _rank_size()
    coords = mesh.coords.cpu().numpy().astype(np.float64)
    tets = mesh.tet2vert.cpu().numpy().astype(np.int64)
    flux = (normalized_flux.cpu().numpy()
            if isinstance(normalized_flux, torch.Tensor)
            else np.asarray(normalized_flux))
    if elem_slice is not None:
        tets, flux = tets[elem_slice], flux[elem_slice]
    cell_data = {f"flux_group_{g}": flux[:, g, 0]
                 for g in range(flux.shape[1])}
    piece = f"{basename}_p{rank:04d}.vtu"
    write_vtu(piece, coords, tets, cell_data)
    if rank == 0:
        write_pvtu(f"{basename}.pvtu",
                   [f"{basename}_p{r:04d}.vtu" for r in range(size)],
                   list(cell_data))
    return piece
