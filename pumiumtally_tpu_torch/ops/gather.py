"""Random row gather ``out[i, :] = tbl[idx[i], :]``.

Counterpart of the gather probe of ``scripts/probe_pallas_gather.py::run``
(K2): its ``k_take`` kernel, ``jnp.take(table, idx, axis=0)`` inside a
Pallas kernel. The probe's other two forms, ``k_onehot`` (a one-hot matmul
on the MXU) and ``k_loop`` (a scalar loop of dynamic slices), were ways of
getting the same gather through Mosaic's lowering on a TPU. They compute
the same function and have no meaning on Hopper, so they are not ported as
kernels of their own: ``gather_rows`` is all three.

The plain version is ``tbl[idx]``. ``gather_rows`` takes it for CPU
tensors only; for CUDA tensors it launches ``csrc/gather.cu`` (built at
first use) or raises. ``LAUNCHES`` counts its kernel launches. The kernel
sets no cache policy: it leaves the stream's attributes and the device's
L2 limits as it found them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCHES = 0

_INDEX_TAG = {torch.int32: "i32", torch.int64: "i64"}
#: The C entries of csrc/gather.cu this module binds.
SYMBOLS = tuple(f"pumi_gather_{t}" for t in _INDEX_TAG.values())
_FNS: dict = {}


def gather_rows_plain(tbl, idx):
    """``tbl[idx]`` for a 2-D table and 1-D integer indices."""
    return tbl[idx.long()]


def piece_bytes(row_bytes: int, *ptrs: int) -> int:
    """The widest piece (16, 8 or 4 bytes) that divides a row's bytes and
    every address in ``ptrs``: the kernel copies a row in such pieces.
    Raises ValueError for a row that is not whole 4-byte words."""
    for piece in (16, 8, 4):
        if row_bytes % piece == 0 and all(p % piece == 0 for p in ptrs):
            return piece
    raise ValueError(f"a row of {row_bytes} bytes is not whole 4-byte words")


def gather_rows(tbl, idx):
    """``out[i, :] = tbl[idx[i], :]``: ``tbl`` is a contiguous [R, C]
    table of 4- or 8-byte elements, ``idx`` [N] int32 or int64 in [0, R).
    CPU tensors take ``gather_rows_plain``; CUDA tensors the kernel, after
    a check of the index range on the card (one reduction, one host
    sync)."""
    if tbl.dim() != 2 or idx.dim() != 1:
        raise ValueError("tbl must be [R, C] and idx [N]")
    if idx.dtype not in _INDEX_TAG:
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    if tbl.element_size() not in (4, 8):
        raise TypeError(f"tbl must hold 4- or 8-byte elements, got {tbl.dtype}")
    if tbl.device != idx.device:
        raise ValueError(f"idx is on {idx.device}, tbl on {tbl.device}")
    if not (tbl.is_contiguous() and idx.is_contiguous()):
        raise ValueError("tbl and idx must be contiguous")
    if tbl.device.type == "cpu":
        return gather_rows_plain(tbl, idx)
    if tbl.device.type != "cuda":
        raise ValueError(f"the gather runs on 'cuda' or 'cpu', not {tbl.device}")
    if idx.numel():
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()
        if lo < 0 or hi >= tbl.shape[0]:
            raise IndexError(f"indices must lie in [0, {tbl.shape[0]})")
    return gather_cuda(tbl, idx)


def _kernel(tag: str):
    """The C entry ``pumi_gather_<tag>`` with its argument types set."""
    fn = _FNS.get(tag)
    if fn is None:
        fn = _build.bind("gather", f"pumi_gather_{tag}", SYMBOLS)
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + (
            [ctypes.c_int] * 2) + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _FNS[tag] = fn
    return fn


def gather_cuda(tbl, idx):
    """Launch ``csrc/gather.cu`` on arguments ``gather_rows`` checked."""
    global LAUNCHES
    n = idx.numel()
    out = torch.empty((n, tbl.shape[1]), dtype=tbl.dtype, device=tbl.device)
    if n == 0 or tbl.shape[1] == 0:
        return out
    row_bytes = tbl.shape[1] * tbl.element_size()
    piece = piece_bytes(row_bytes, tbl.data_ptr(), out.data_ptr())
    fn = _kernel(_INDEX_TAG[idx.dtype])
    with torch.cuda.device(tbl.device):
        stream = torch.cuda.current_stream(tbl.device).cuda_stream
        err = fn(tbl.data_ptr(), idx.data_ptr(), n, row_bytes, piece,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gather kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return out
