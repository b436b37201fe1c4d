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
    the walk-stats vector and, with integrity on, the [INTEGRITY_LEN]
    integrity vector (``integrity/invariants.py``) and, with convergence
    on, the [CONV_LEN] convergence summary (``obs/convergence.py``) are
    packed on the device into ONE flat record (``pack_trace_readback``),
    copied into a pinned host buffer and split on the host
    (``split_trace_readback``).

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
integrity vector's and the convergence summary's walk-dtype floats are
bitcast as they are, so they travel bit-exactly.

Host buffers come from :class:`HostStager`: pinned (page-locked) on the
card, a ring of ``depth`` buffers per record kind; fresh on the CPU,
where a "transfer" is the same memory.

After an element sort the device holds the particles in slot order:
``unpack_move_record`` gathers the host-order record into slots and
``pack_trace_readback`` scatters the slots back into host order, both
with the slot permutation ``perm`` as torch index ops on the card (the
JAX package does them outside any kernel too).

The megastep's readback (``pack_megastep_tail``) is a tail alone: the
chunk's stats vector (or segment count) int64-encoded, the chunk's
integrity vector, the last convergence summary and the physics vector
(``ops/source.py``) as walk-dtype carrier words; per-lane state stays on
the card between chunks, so one device→host copy of a few words ends a
chunk.

The partitioned facade's records (``pack_partitioned_record``,
``pack_partitioned_readback``) are slot-major over the ``[n_parts·cap]``
slots of ``ops/walk_partitioned.py``, the JAX package's layouts: one
host→device copy of the distributed inputs and one device→host copy of
the per-slot outputs with a per-part int64 tail (stats, round stats,
rounds, drops, segments, and with integrity on the part's
``PART_INTEGRITY_FIELDS``) a move, the per-part convergence summaries
after it as walk-dtype words. The partitioned megastep's readback
(``pack_partitioned_megastep_tail``) is such a per-part tail with no slot
columns, and the chunk's physics vector.
"""
from __future__ import annotations

import threading
import warnings

import numpy as np
import torch

from ..integrity.invariants import INTEGRITY_LEN, PART_INTEGRITY_LEN
from ..obs.convergence import CONV_LEN
from ..utils import timing
from ..utils.platform import resolve_device

# Record column layouts (single-chip facade), the JAX package's.
MOVE_COLS = 6       # dest x,y,z | weight | group | flying
INIT_COLS = 4       # dest x,y,z | flying
READBACK_COLS = 5   # pos x,y,z | material_id | done
# Partitioned facade, slot-major over [n_parts * cap] slots.
PART_IN_COLS = 12   # origin(3) | dest(3) | weight | group | material |
#                     elem | particle_id | valid
PART_RB_SLOT_COLS = 9  # pos(3) | material | elem | done | track | pid | valid

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
    to one facade or pipeline. Under ``move_deadline_s`` its moves run on
    a watchdog's worker thread, so the ring rotation takes a lock (the
    facade replaces the stager of a worker it abandons)."""

    def __init__(self, depth: int = 1, device=None):
        self.depth = max(1, int(depth))
        self.pinned = resolve_device(device).type == "cuda"
        self._lock = threading.Lock()
        self._bufs: dict = {}  # guarded by: self._lock

    def buf(self, shape: tuple, dtype: torch.dtype, tag: str = ""
            ) -> torch.Tensor:
        shape = tuple(shape)
        if not self.pinned:
            return torch.empty(shape, dtype=dtype)
        key = (tag, shape, dtype)
        with self._lock:
            ring, turn = self._bufs.setdefault(key, ([], 0))
            if len(ring) < self.depth:
                ring.append(torch.empty(shape, dtype=dtype,
                                        pin_memory=True))
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
    returned (the host read ``tail`` of ``utils/timing.py::count``). A CPU
    tensor is returned as it is."""
    if t.device.type == "cpu":
        return t
    host = stager.buf(t.shape, t.dtype, tag)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    timing.count("tail")
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


def unpack_move_record(rec, dtype, perm, initial: bool):
    """Device-side inverse of ``pack_move_record`` / ``pack_init_record``:
    ``(dest [n,3], in_flight [n] bool, weight, group)``, each contiguous;
    weight and group are None for the initial search. The record's rows
    are in host particle order; with the slot permutation ``perm`` (int64
    [n] on the record's device, after an element sort) slot i takes
    particle ``perm[i]``'s row (one gather on the card)."""
    if perm is not None:
        rec = rec[perm]
    words = rec.view(torch_carrier(dtype))
    dest = words[:, 0:3].view(dtype).contiguous()
    if initial:
        return dest, words[:, 3] != 0, None, None
    weight = words[:, 3].view(dtype).contiguous()
    group = _dec_i32_dev(words[:, 4])
    return dest, words[:, 5] != 0, weight, group


def pack_trace_readback(position, material_id, done, stats, n_segments,
                        perm=None, integrity=None, convergence=None):
    """Device-side readback pack: the ``[n, READBACK_COLS]`` slot record,
    flattened, with the walk-stats vector (or, when walk stats are off,
    the segment count) appended as an int64-encoded tail, then the
    ``integrity`` vector (when given) and the ``convergence`` summary
    (when given) as walk-dtype floats in carrier words; one carrier
    tensor, so ONE device→host copy carries what the facade needs per
    move, as in the JAX package. With the slot permutation ``perm`` the
    slot rows are scattered back into host particle order (row
    ``perm[i]`` takes slot i) on the card."""
    dtype = position.dtype
    carrier = torch_carrier(dtype)
    n = position.shape[0]
    tail_src = stats if stats is not None else n_segments.reshape(1)
    tail = tail_src.to(torch.int64).view(carrier)
    floats = [v.to(dtype) for v in (integrity, convergence) if v is not None]
    n_floats = sum(v.numel() for v in floats)
    out = torch.empty(n * READBACK_COLS + tail.numel() + n_floats,
                      dtype=carrier, device=position.device)
    slot = out[: n * READBACK_COLS].view(n, READBACK_COLS)
    slot[:, 0:3] = position.view(carrier)
    slot[:, 3] = _enc_i32_dev(material_id, carrier)
    slot[:, 4] = done
    if perm is not None:
        slot[perm] = slot.clone()
    off = n * READBACK_COLS
    out[off:off + tail.numel()] = tail
    off += tail.numel()
    for v in floats:
        out[off:off + v.numel()] = v.view(carrier)
        off += v.numel()
    return out


def readback_views(host_rec, n: int, dtype, integrity: bool = False,
                   convergence: bool = False):
    """The parts of a host readback as views into it, with no pass over
    the lanes: ``(position [n,3] walk dtype, material ids [n] in the
    carrier's signed int, done words [n] (nonzero: done), tail int64
    array, integrity float64 copy or None, convergence summary float64
    copy or None)``."""
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
    tail_words, integ, conv = _split_floats(tail_words, npdt, integrity,
                                            convergence)
    return (position, material, slot[:, 4], _dec_i64_host(tail_words),
            integ, conv)


def _split_floats(words, npdt, integrity: bool, convergence: bool):
    """Split the float tails off the end of a record's words: ``(rest,
    integrity float64 or None, convergence float64 or None)``."""
    integ = conv = None
    if convergence:
        conv = _dec_f_host(words[-CONV_LEN:], npdt).astype(np.float64)
        words = words[:-CONV_LEN]
    if integrity:
        integ = _dec_f_host(words[-INTEGRITY_LEN:], npdt).astype(np.float64)
        words = words[:-INTEGRITY_LEN]
    return words, integ, conv


def split_trace_readback(host_rec, n: int, dtype, integrity: bool = False,
                         convergence: bool = False):
    """Host-side inverse of ``pack_trace_readback``. Returns ``(position
    [n,3] walk dtype, material_id [n] int32, done [n] bool, tail int64
    array, integrity float64 vector or None, convergence float64 vector
    or None)``, where ``tail`` is the stats vector (walk stats on) or
    ``[n_segments]`` (off). Positions and (in float32) material ids are
    strided views into ``host_rec``."""
    position, material, done, tail, integ, conv = readback_views(
        host_rec, n, dtype, integrity, convergence)
    material = _dec_i32_host(material.view(np_carrier(dtype)),
                             np_carrier(dtype))
    return position, material, done != 0, tail, integ, conv


# --------------------------------------------------------------------- #
# Megastep readback tail (device-sourced move loop)
# --------------------------------------------------------------------- #
def pack_megastep_tail(stats, n_segments, integrity, convergence, phys,
                       dtype):
    """The megastep's device-side readback: the chunk's stats reduction
    (or, walk stats off, the segment count) int64-encoded, then the
    chunk's integrity vector and the last convergence summary (each when
    given) and the [MEGA_PHYS_LEN] physics vector as walk-dtype floats,
    as ONE flat carrier tensor, the JAX package's layout."""
    carrier = torch_carrier(dtype)
    tail_src = stats if stats is not None else n_segments.reshape(1)
    parts = [tail_src.to(torch.int64).view(carrier)]
    for v in (integrity, convergence):
        if v is not None:
            parts.append(v.to(dtype).view(carrier))
    parts.append(phys.to(dtype).view(carrier))
    return torch.cat(parts)


def split_megastep_tail(host_vec, dtype, walk_stats: bool,
                        integrity: bool, convergence: bool):
    """Host-side inverse of ``pack_megastep_tail``. Returns ``(tail int64
    array: the stats vector or [n_segments], integrity float64 vector or
    None, convergence float64 vector or None, phys float64 vector)``."""
    from .source import MEGA_PHYS_LEN

    if isinstance(host_vec, torch.Tensor):
        host_vec = host_vec.numpy()
    npdt = np.dtype(_NP_FLOAT.get(dtype, dtype))
    words = np.asarray(host_vec).view(np_carrier(dtype))
    phys = _dec_f_host(words[-MEGA_PHYS_LEN:], npdt).astype(np.float64)
    words, integ, conv = _split_floats(words[:-MEGA_PHYS_LEN], npdt,
                                       integrity, convergence)
    return _dec_i64_host(words), integ, conv, phys


# --------------------------------------------------------------------- #
# Partitioned facade records
# --------------------------------------------------------------------- #
def pack_partitioned_record(partition, global_elem, fields: dict, cap: int,
                            dtype, stager: HostStager) -> torch.Tensor:
    """Slot-major host record ``[n_parts·cap, PART_IN_COLS]`` carrier
    words: the packed ``walk_partitioned.distribute_particles`` (the same
    slots), ONE host buffer instead of eight. Empty slots carry pid -1,
    valid 0 and zero bits elsewhere."""
    from .walk_partitioned import slot_layout

    carrier = torch_carrier(dtype)
    slot_of, cap = slot_layout(partition, global_elem, cap)
    n = slot_of.shape[0]
    rec = stager.buf((partition.n_parts * cap, PART_IN_COLS), carrier,
                     "part")
    rec.zero_()
    rec[:, 10] = -1
    so = torch.from_numpy(slot_of)
    words = rec.view(dtype)

    def real(name):
        return host_tensor(np.asarray(fields[name], np.float64)).to(dtype)

    words[so, 0:3] = real("origin")
    words[so, 3:6] = real("dest")
    words[so, 6] = real("weight")
    rec[so, 7] = host_tensor(np.asarray(fields["group"], np.int64)).to(carrier)
    rec[so, 8] = host_tensor(
        np.asarray(fields["material_id"], np.int32)).to(carrier)
    rec[so, 9] = torch.from_numpy(
        partition.global2local[np.asarray(global_elem)]).to(carrier)
    rec[so, 10] = torch.arange(n, dtype=torch.int32).to(carrier)
    rec[so, 11] = 1
    return rec


def unpack_partitioned_record(rec):
    """Device-side inverse of ``pack_partitioned_record`` (the walk dtype
    is the carrier's width): the step's per-slot inputs ``(origin, dest,
    elem, done, material_id, weight, group, pid, valid)``, done all
    False."""
    dtype = torch.float32 if rec.dtype == torch.int32 else torch.float64
    words = rec.view(dtype)
    valid = rec[:, 11] != 0
    return (words[:, 0:3].contiguous(), words[:, 3:6].contiguous(),
            _dec_i32_dev(rec[:, 9]), torch.zeros_like(valid),
            _dec_i32_dev(rec[:, 8]), words[:, 6].contiguous(),
            _dec_i32_dev(rec[:, 7]), _dec_i32_dev(rec[:, 10]), valid)


def pack_partitioned_readback(res, n_parts: int) -> torch.Tensor:
    """Device-side readback of a partitioned step: per slot
    ``[pos(3), material, elem, done, track, pid, valid]`` carrier words,
    then a per-part int64 tail (the stats vector, the round stats, rounds,
    drops, segments, and the integrity counters when the step has them)
    and the per-part convergence summary (when it has one) as walk-dtype
    words: ONE ``[n_parts, cap·COLS + tail]`` tensor."""
    dtype = res.position.dtype
    carrier = torch_carrier(dtype)
    cap = res.position.shape[0] // n_parts
    slot = torch.empty(n_parts * cap, PART_RB_SLOT_COLS, dtype=carrier,
                       device=res.position.device)
    slot[:, 0:3] = res.position.view(carrier)
    slot[:, 3] = _enc_i32_dev(res.material_id, carrier)
    slot[:, 4] = _enc_i32_dev(res.elem, carrier)
    slot[:, 5] = res.done.to(carrier)
    slot[:, 6] = res.track_length.view(carrier)
    slot[:, 7] = _enc_i32_dev(res.particle_id, carrier)
    slot[:, 8] = res.valid.to(carrier)
    cols = [res.stats, res.round_stats.reshape(n_parts, -1),
            res.n_rounds[:, None], res.n_dropped[:, None],
            res.n_segments[:, None]]
    if res.integrity is not None:
        cols.append(res.integrity)
    tail = torch.cat(cols, dim=1).to(torch.int64).contiguous()
    parts = [slot.view(n_parts, -1), tail.view(carrier).view(n_parts, -1)]
    if res.convergence is not None:
        parts.append(res.convergence.to(dtype).contiguous().view(carrier))
    return torch.cat(parts, dim=1)


def split_partitioned_readback(host_rec, n_parts: int, cap: int, dtype,
                               integrity: bool = False,
                               convergence: bool = False) -> dict:
    """Host-side inverse of ``pack_partitioned_readback`` (numpy); the
    round-stats bound is recovered from the tail's width. ``integrity``
    and ``convergence`` name the tails the step carried: the dict then
    has ``integrity`` ([n_parts, PART_INTEGRITY_LEN] int64) and
    ``convergence`` ([n_parts, CONV_LEN] float64)."""
    from ..obs.walk_stats import WALK_STATS_LEN

    carrier = np_carrier(dtype)
    npdt = np.dtype(_NP_FLOAT.get(dtype, dtype))
    if isinstance(host_rec, torch.Tensor):
        host_rec = host_rec.numpy()
    host_rec = np.asarray(host_rec).view(carrier)
    conv = None
    if convergence:
        conv = _dec_f_host(np.ascontiguousarray(host_rec[:, -CONV_LEN:]),
                           npdt).astype(np.float64)
        host_rec = host_rec[:, :-CONV_LEN]
    ilen = PART_INTEGRITY_LEN if integrity else 0
    w = 8 // carrier.itemsize
    width = host_rec.shape[1]
    rem = width - cap * PART_RB_SLOT_COLS
    if rem < 0 or rem % w:
        raise ValueError(
            f"cannot split a [{n_parts}, {width}] partitioned readback at "
            f"cap={cap}")
    ints = rem // w - WALK_STATS_LEN - 3 - ilen
    if ints < 0 or ints % 6:
        raise ValueError(
            f"partitioned readback tail of {rem // w} int64s does not "
            f"decode at cap={cap}")
    R = ints // 6
    slot = host_rec[:, : cap * PART_RB_SLOT_COLS].reshape(
        n_parts * cap, PART_RB_SLOT_COLS)
    tail = _dec_i64_host(host_rec[:, cap * PART_RB_SLOT_COLS:]).reshape(
        n_parts, -1)
    S = WALK_STATS_LEN
    out = {
        "position": _dec_f_host(np.ascontiguousarray(slot[:, 0:3]), npdt),
        "material_id": _dec_i32_host(np.ascontiguousarray(slot[:, 3]),
                                     carrier),
        "elem": _dec_i32_host(np.ascontiguousarray(slot[:, 4]), carrier),
        "done": slot[:, 5] != 0,
        "track_length": _dec_f_host(np.ascontiguousarray(slot[:, 6]), npdt),
        "particle_id": _dec_i32_host(np.ascontiguousarray(slot[:, 7]),
                                     carrier),
        "valid": slot[:, 8] != 0,
        "stats": tail[:, :S],
        "round_stats": tail[:, S: S + 6 * R].reshape(n_parts, 6, R),
        "n_rounds": tail[:, S + 6 * R],
        "n_dropped": tail[:, S + 6 * R + 1],
        "n_segments": tail[:, S + 6 * R + 2],
    }
    if integrity:
        base = S + 6 * R + 3
        out["integrity"] = tail[:, base: base + ilen]
    if conv is not None:
        out["convergence"] = conv
    return out


def pack_partitioned_megastep_tail(stats, n_rounds, n_dropped, n_segments,
                                   integrity, convergence, phys, dtype):
    """The partitioned megastep's device-side readback: ONE ``[n_parts,
    W]`` carrier tensor of each part's chunk stats vector, rounds, drops
    and segments (and integrity counters, when given) int64-encoded, its
    last convergence summary (when given) and the chunk's physics vector
    (the same in every row) as walk-dtype words."""
    carrier = torch_carrier(dtype)
    n_parts = stats.shape[0]
    cols = [stats, n_rounds[:, None], n_dropped[:, None],
            n_segments[:, None]]
    if integrity is not None:
        cols.append(integrity)
    tail = torch.cat(cols, dim=1).to(torch.int64).contiguous()
    parts = [tail.view(carrier).view(n_parts, -1)]
    if convergence is not None:
        parts.append(convergence.to(dtype).contiguous().view(carrier))
    parts.append(phys.to(dtype).expand(n_parts, -1).contiguous()
                 .view(carrier))
    return torch.cat(parts, dim=1)


def split_partitioned_megastep_tail(host_rec, dtype, integrity: bool,
                                    convergence: bool) -> dict:
    """Host-side inverse of ``pack_partitioned_megastep_tail``: ``stats``
    [n_parts, 8], ``n_rounds``, ``n_dropped``, ``n_segments`` [n_parts]
    int64, ``phys`` [MEGA_PHYS_LEN] float64, and ``integrity`` /
    ``convergence`` when asked for."""
    from ..obs.walk_stats import WALK_STATS_LEN
    from .source import MEGA_PHYS_LEN

    carrier = np_carrier(dtype)
    npdt = np.dtype(_NP_FLOAT.get(dtype, dtype))
    if isinstance(host_rec, torch.Tensor):
        host_rec = host_rec.numpy()
    rec = np.asarray(host_rec).view(carrier)
    phys = _dec_f_host(np.ascontiguousarray(rec[0, -MEGA_PHYS_LEN:]),
                       npdt).astype(np.float64)
    rec = rec[:, :-MEGA_PHYS_LEN]
    out = {}
    if convergence:
        out["convergence"] = _dec_f_host(
            np.ascontiguousarray(rec[:, -CONV_LEN:]), npdt).astype(
                np.float64)
        rec = rec[:, :-CONV_LEN]
    tail = _dec_i64_host(rec).reshape(rec.shape[0], -1)
    S = WALK_STATS_LEN
    out.update(stats=tail[:, :S], n_rounds=tail[:, S],
               n_dropped=tail[:, S + 1], n_segments=tail[:, S + 2],
               phys=phys)
    if integrity:
        out["integrity"] = tail[:, S + 3: S + 3 + PART_INTEGRITY_LEN]
    return out


def collect_packed(parsed: dict, n: int, partition) -> dict:
    """The packed per-slot outputs back in host particle order: the
    packed ``walk_partitioned.collect_by_particle_id`` (the same zero
    fills, ``elem_global`` through the holding part's local2global)."""
    pid = parsed["particle_id"]
    sel = parsed["valid"] & (pid >= 0)
    idx = pid[sel]
    out = {}
    for name in ("position", "material_id", "done", "elem",
                 "track_length"):
        arr = parsed[name]
        buf = np.zeros((n,) + arr.shape[1:], arr.dtype)
        buf[idx] = arr[sel]
        out[name] = buf
    cap = pid.shape[0] // partition.n_parts
    chip = (np.arange(pid.shape[0]) // cap)[sel]
    buf = np.full(n, -1, np.int64)
    buf[idx] = partition.local2global[chip, parsed["elem"][sel]]
    out["elem_global"] = buf
    return out
