"""Move-loop I/O staging: packed host↔device records for the facade.

Counterpart of the single-chip half of ``pumiumtally_tpu/ops/staging.py``.
A facade move under ``io_pipeline="packed"`` (or ``"overlap"``) makes one
host→device copy and one device→host copy:

  * **packed staging (H2D)**: destinations, weights, groups and flying
    flags are packed on the host into ONE ``[n, MOVE_COLS]`` record of
    carrier words (``pack_move_record``), in a pinned host buffer on the
    card, and copied with ``non_blocking=True``; ``unpack_move_record``
    bitcasts the columns back on the device.
  * **coalesced readback (D2H)**: positions, material ids, done flags,
    the walk-stats vector and, with convergence on, the [CONV_LEN]
    convergence summary (``obs/convergence.py``) are packed on the
    device into ONE flat record (``pack_trace_readback``), copied into a
    pinned host buffer and split on the host (``split_trace_readback``).

Encoding: every record is made of carrier words of the walk dtype's width
(``np_carrier``: uint32 for float32, uint64 for float64, as in the JAX
package; on the torch side the signed twin, int32 or int64, since the
card's unsigned integer ops are partial), so floats travel bit-exactly
(``Tensor.view`` / ``ndarray.view`` bitcasts) and int32 values travel
sign-extended. The records' bytes are the JAX package's. The float64 →
walk-dtype rounding of the destinations and weights happens on the host,
while packing, to nearest even as numpy's ``astype`` and JAX do: the
record holds walk-dtype words, so the device never sees the float64
values. Tail integers (the stats vector, or the segment count) are
widened to int64 before they are bitcast into carrier words; the
convergence summary's walk-dtype floats are bitcast as they are, so they
travel bit-exactly.

Host buffers come from :class:`HostStager`: pinned (page-locked) on the
card, a ring of ``depth`` buffers per record kind; fresh on the CPU,
where a "transfer" is the same memory.

Not ported here: the slot permutation of the element sort (``perm``; A5),
the integrity tail (A8), and the partitioned and megastep records (A9,
A7). Asking for them raises NotImplementedError.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..obs.convergence import CONV_LEN
from ..utils.platform import resolve_device

# Record column layouts (single-chip facade), the JAX package's.
MOVE_COLS = 6       # dest x,y,z | weight | group | flying
INIT_COLS = 4       # dest x,y,z | flying
READBACK_COLS = 5   # pos x,y,z | material_id | done

_TORCH_CARRIER = {4: torch.int32, 8: torch.int64}
_NP_FLOAT = {torch.float32: np.float32, torch.float64: np.float64}


# --------------------------------------------------------------------- #
# Carrier dtype helpers
# --------------------------------------------------------------------- #
def np_carrier(dtype) -> np.dtype:
    """Host carrier dtype for a walk dtype (numpy or torch): the unsigned
    int of equal width."""
    itemsize = _itemsize(dtype)
    if itemsize == 4:
        return np.dtype(np.uint32)
    if itemsize == 8:
        return np.dtype(np.uint64)
    raise NotImplementedError(
        f"packed staging needs a 4- or 8-byte walk dtype, got {dtype!r}"
    )


def torch_carrier(dtype) -> torch.dtype:
    """The torch dtype that holds a walk dtype's carrier words: the signed
    int of equal width (same bits as ``np_carrier``)."""
    np_carrier(dtype)  # refuses other widths
    return _TORCH_CARRIER[_itemsize(dtype)]


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


# Host-side decode (numpy views; int32 -1 round-trips through either
# carrier width).
def _dec_i32_host(col, carrier: np.dtype) -> np.ndarray:
    if carrier == np.uint32:
        return col.view(np.int32)
    return col.view(np.int64).astype(np.int32)


def _dec_f_host(cols, dtype) -> np.ndarray:
    return cols.view(np.dtype(dtype))


def _dec_i64_host(cols) -> np.ndarray:
    """Tail decode: carrier words back to the int64 values they encode
    (the byte stream is the int64 array's little-endian bytes)."""
    return np.ascontiguousarray(cols).view(np.int64)


# Device-side int32 encode/decode (floats are ``Tensor.view`` bitcasts;
# int32 values sign-extend into an int64 carrier, so -1 round-trips).
def _enc_i32_dev(x, carrier):
    return x.to(carrier)  # int32 → int64 sign-extends


def _dec_i32_dev(x):
    return x.to(torch.int32).contiguous()


# --------------------------------------------------------------------- #
# Host staging buffers
# --------------------------------------------------------------------- #
class HostStager:
    """Reusable host record buffers for the packed pipeline.

    On the card (``device`` a CUDA device) every buffer is a pinned host
    tensor, so its copy is a real asynchronous DMA; a failed pin raises.
    ``depth=1`` (packed) reuses one buffer per record kind: the facade
    waits on every move's readback, which orders the previous copy before
    the next pack. ``depth=2`` (overlap) alternates two, so packing move
    k+1 never writes the buffer of move k's copy. Each (tag, shape,
    dtype) has its own ring and rotation, and reuse hands back the
    oldest buffer. ``device`` defaults to the card, as every entry
    point's does (``utils/platform.py::resolve_device``: without CUDA
    that default raises; pass ``device="cpu"``). On the CPU a "copy" to
    the device is the same memory, so every call returns a fresh buffer,
    as the JAX stager does there.
    Buffers are not cleared: the packs write every word. A stager belongs
    to one facade or pipeline and is used from its calling thread."""

    def __init__(self, depth: int = 1, device=None):
        self.depth = max(1, int(depth))
        self.pinned = resolve_device(device).type == "cuda"
        self._bufs: dict = {}

    def buf(self, shape: tuple, dtype: torch.dtype, tag: str = ""
            ) -> torch.Tensor:
        shape = tuple(shape)
        if not self.pinned:
            return torch.empty(shape, dtype=dtype)
        key = (tag, shape, dtype)
        ring, turn = self._bufs.setdefault(key, ([], 0))
        if len(ring) < self.depth:
            ring.append(torch.empty(shape, dtype=dtype, pin_memory=True))
            return ring[-1]
        self._bufs[key] = (ring, turn + 1)
        return ring[turn % self.depth]


def host_tensor(a) -> torch.Tensor:
    """A CPU tensor over a numpy array's memory (a contiguous copy only if
    it is not contiguous). A read-only array is only read from."""
    a = np.ascontiguousarray(a)
    if a.flags.writeable:
        return torch.from_numpy(a)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable")
        return torch.from_numpy(a)


def to_host(stager: HostStager, t: torch.Tensor, tag: str = "readback"
            ) -> torch.Tensor:
    """The readback's one device→host copy, into a pinned buffer of the
    stager, waited on by a CUDA event on the current stream before it is
    returned. A CPU tensor is returned as it is."""
    if t.device.type == "cpu":
        return t
    host = stager.buf(t.shape, t.dtype, tag)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host


# --------------------------------------------------------------------- #
# Single-chip facade records
# --------------------------------------------------------------------- #
def pack_move_record(stager: HostStager, dest3, weights, groups, fly,
                     dtype) -> torch.Tensor:
    """ONE host record per move: ``[n, MOVE_COLS]`` carrier words in host
    particle order. ``dest3`` and ``weights`` are rounded to ``dtype``
    (torch's copy, to nearest even: numpy's ``astype`` bits). Groups are
    host-validated non-negative, so their value store round-trips through
    either carrier."""
    carrier = torch_carrier(dtype)
    n = dest3.shape[0]
    rec = stager.buf((n, MOVE_COLS), carrier, "move")
    words = rec.view(dtype)
    words[:, 0:3].copy_(host_tensor(np.asarray(dest3, np.float64)))
    words[:, 3].copy_(host_tensor(np.asarray(weights, np.float64)))
    rec[:, 4].copy_(host_tensor(groups))
    rec[:, 5].copy_(host_tensor(fly))
    return rec


def pack_init_record(stager: HostStager, dest3, fly, dtype) -> torch.Tensor:
    """Initial-search record: destinations and flying flags only (weight
    and group come from the device-resident state)."""
    carrier = torch_carrier(dtype)
    n = dest3.shape[0]
    rec = stager.buf((n, INIT_COLS), carrier, "init")
    rec.view(dtype)[:, 0:3].copy_(host_tensor(np.asarray(dest3, np.float64)))
    rec[:, 3].copy_(host_tensor(fly))
    return rec


def _no_perm(perm) -> None:
    if perm is not None:
        raise NotImplementedError(
            "the slot permutation of the element sort is not ported yet "
            "(ROADMAP.md A5, element sort); pass perm=None"
        )


def unpack_move_record(rec, dtype, perm, initial: bool):
    """Device-side inverse of ``pack_move_record`` / ``pack_init_record``:
    ``(dest [n,3], in_flight [n] bool, weight, group)``, each contiguous;
    weight and group are None for the initial search."""
    _no_perm(perm)
    words = rec.view(torch_carrier(dtype))
    dest = words[:, 0:3].view(dtype).contiguous()
    if initial:
        return dest, words[:, 3] != 0, None, None
    weight = words[:, 3].view(dtype).contiguous()
    group = _dec_i32_dev(words[:, 4])
    return dest, words[:, 5] != 0, weight, group


def _no_integrity() -> None:
    raise NotImplementedError(
        "the integrity tail is not ported yet (ROADMAP.md A8)")


def pack_trace_readback(position, material_id, done, stats, n_segments,
                        perm=None, integrity=None, convergence=None):
    """Device-side readback pack: the ``[n, READBACK_COLS]`` slot record,
    flattened, with the walk-stats vector (or, when walk stats are off,
    the segment count) appended as an int64-encoded tail and, when
    ``convergence`` (the [CONV_LEN] summary) is given, its walk-dtype
    floats appended last as carrier words; one carrier tensor, so ONE
    device→host copy carries what the facade needs per move."""
    _no_perm(perm)
    if integrity is not None:
        _no_integrity()
    carrier = torch_carrier(position.dtype)
    n = position.shape[0]
    tail_src = stats if stats is not None else n_segments.reshape(1)
    tail = tail_src.to(torch.int64).view(carrier)
    conv_words = 0 if convergence is None else convergence.numel()
    out = torch.empty(n * READBACK_COLS + tail.numel() + conv_words,
                      dtype=carrier, device=position.device)
    slot = out[: n * READBACK_COLS].view(n, READBACK_COLS)
    slot[:, 0:3] = position.view(carrier)
    slot[:, 3] = _enc_i32_dev(material_id, carrier)
    slot[:, 4] = done
    out[n * READBACK_COLS:n * READBACK_COLS + tail.numel()] = tail
    if convergence is not None:
        out[out.numel() - conv_words:] = (
            convergence.to(position.dtype).view(carrier))
    return out


def readback_views(host_rec, n: int, dtype, convergence: bool = False):
    """The parts of a host readback as views into it, with no pass over
    the lanes: ``(position [n,3] walk dtype, material ids [n] in the
    carrier's signed int, done words [n] (nonzero: done), tail int64
    array, convergence summary float64 copy or None)``."""
    carrier = np_carrier(dtype)
    if isinstance(host_rec, torch.Tensor):
        host_rec = host_rec.numpy()
    words = host_rec.view(carrier)
    slot = words[: n * READBACK_COLS].reshape(n, READBACK_COLS)
    npdt = _NP_FLOAT.get(dtype, dtype)
    position = _dec_f_host(slot[:, 0:3], npdt)
    material = slot[:, 3].view(np.int32 if carrier == np.uint32
                               else np.int64)
    tail_words = words[n * READBACK_COLS:]
    conv = None
    if convergence:
        conv = _dec_f_host(tail_words[-CONV_LEN:], npdt).astype(np.float64)
        tail_words = tail_words[:-CONV_LEN]
    return position, material, slot[:, 4], _dec_i64_host(tail_words), conv


def split_trace_readback(host_rec, n: int, dtype, integrity: bool = False,
                         convergence: bool = False):
    """Host-side inverse of ``pack_trace_readback``. Returns ``(position
    [n,3] walk dtype, material_id [n] int32, done [n] bool, tail int64
    array, None, convergence float64 vector or None)``, where ``tail`` is
    the stats vector (walk stats on) or ``[n_segments]`` (off); the fifth
    is the JAX package's integrity slot. Positions and (in float32)
    material ids are strided views into ``host_rec``."""
    if integrity:
        _no_integrity()
    position, material, done, tail, conv = readback_views(
        host_rec, n, dtype, convergence)
    material = _dec_i32_host(material.view(np_carrier(dtype)),
                             np_carrier(dtype))
    return position, material, done != 0, tail, None, conv
