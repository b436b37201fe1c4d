"""The tally scatter: ``(c, c²)`` records into the flat ``[nbins·2]`` flux.

Counterpart of the walk's matrixized tally, ``tally_peel`` in
``pumiumtally_tpu/ops/walk_pallas.py`` (an exact collision peel that lands
each bin's adds in ascending lane order, XLA's scatter-add order), and of
the two scatter probes of ``scripts/probe_pallas_gather.py::run_scatter``:
``outer`` (unordered) and ``peeled`` (ordered, bitwise).

A record is ``(bin, order, c)``: it adds ``c`` to ``flux[2·bin]`` and, when
squares are scored, ``c*c`` to ``flux[2·bin+1]``. ``order`` is an int64
key; the walk uses ``iteration · n_lanes + lane``, so a bin's adds land in
(iteration, lane) order, which is the JAX walk's order.

* ``scatter_atomic`` / ``scatter_atomic_plain``: each bin gets its adds in
  whatever order the device makes them (K3 ``outer``).
* ``scatter_ordered`` / ``scatter_ordered_plain``: each bin gets its adds
  in ascending ``order`` (ties in record order), bitwise, on any device
  (K3 ``peeled`` and the walk's tally).
* ``lane_order`` / ``lane_order_plain``: the permutation that orders a
  walk's lanes by an int32 key (their start elements, or in the initial
  search their destination cells), on the CPU. On the card the order is
  part of the walk's lane schedule (``walk_cuda.lane_records``), which
  writes each lane's record into its slot and keeps no permutation.

The ``*_plain`` functions are the PyTorch versions. The wrappers take them
for CPU tensors only; for CUDA tensors they launch the hand-written
kernels of ``csrc/scatter.cu`` (built at first use) or raise.

On the card the ordered scatter takes one of two paths, chosen by the
data. It counts the records of every bucket of ``2^shift`` consecutive
bins (``bucket_shift`` picks the shift) and reads the largest count and
the range of the order keys to the host once. The bucket path places
every record in its bucket's range as one 16 B record, a 63-bit key that
orders it by (bin, order, record index) beside its value
(``bucket_keys_plain`` is the key's plain version), and folds each bucket
in shared memory. A call takes the crowded path (``crowded_cuda``, a sort
by bin over all records) when a bucket holds more than
``BUCKET_CAPACITY`` records (``is_crowded``) or the keys do not fit 63
bits (``key_bits``).

``ATOMIC_LAUNCHES`` and ``ORDERED_LAUNCHES`` count the wrappers' kernel
launches (one per call that reaches the card), and
nothing else; ``BUCKET_LAUNCHES`` and ``CROWDED_LAUNCHES`` count the
ordered scatter's calls by path. ``LAST_BUCKETS`` describes the last
ordered call on the card: its shift, bucket count, largest bucket, the
capacity, the key's bits, the path taken and ``wait_s``, the host time
the call waited at its one host read.
"""
from __future__ import annotations

import ctypes
import time

import torch

from . import _build

ATOMIC_LAUNCHES = 0
ORDERED_LAUNCHES = 0
BUCKET_LAUNCHES = 0
CROWDED_LAUNCHES = 0
LAST_BUCKETS: dict = {}

# Records a bucket's block holds in shared memory, and the widest bucket
# (csrc/scatter.cu BUCKET_CAP, BUCKET_SHIFT_MAX).
BUCKET_CAPACITY = 2048
MAX_SHIFT = 10

_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}
_INT32_MAX = 2**31 - 1


def scatter_atomic_plain(flux, bin, c, score_squares: bool = True):
    """``index_add_`` of ``c`` into ``flux[2·bin]`` and of ``c*c`` into
    ``flux[2·bin+1]``. On CUDA ``index_add_`` adds atomically, so a bin's
    order of adds is the device's. Updates ``flux`` in place and returns
    it."""
    flux2 = flux.view(-1, 2)
    bin = bin.long()
    flux2[:, 0].index_add_(0, bin, c)
    if score_squares:
        flux2[:, 1].index_add_(0, bin, c * c)
    return flux


def lane_order_plain(keys):
    """The lanes ordered by key: ``argsort(keys, stable=True)``, as
    int32."""
    return torch.argsort(keys, stable=True).to(torch.int32)


def _ordered_ranks(bin, order):
    """For records ``(bin, order)``: the permutation that sorts them by
    (bin, order), stably, and each sorted record's rank within its bin."""
    by_order = torch.argsort(order, stable=True)
    perm = by_order[torch.argsort(bin[by_order], stable=True)]
    sbin = bin[perm]
    m = sbin.numel()
    pos = torch.arange(m, device=bin.device)
    start = torch.ones(m, dtype=torch.bool, device=bin.device)
    start[1:] = sbin[1:] != sbin[:-1]
    first = torch.cummax(torch.where(start, pos, 0), dim=0).values
    return perm, pos - first


def scatter_ordered_plain(flux, bin, order, c, score_squares: bool = True):
    """Land each bin's adds in ascending ``order`` (ties in record order),
    bitwise, whatever the device: a stable sort by (bin, order) ranks every
    record within its bin, then one round per rank adds every bin at most
    once, so each round is exact even where CUDA adds atomically. That is
    ``tally_peel``'s peel, round by round. Updates ``flux`` in place and
    returns it."""
    if bin.numel() == 0:
        return flux
    flux2 = flux.view(-1, 2)
    perm, rank = _ordered_ranks(bin.long(), order)
    by_rank = torch.argsort(rank, stable=True)
    sel = perm[by_rank]
    rbin = bin.long()[sel]
    rc = c[sel]
    counts = torch.bincount(rank).tolist()
    lo = 0
    for k in counts:
        b, v = rbin[lo:lo + k], rc[lo:lo + k]
        flux2[:, 0].index_add_(0, b, v)
        if score_squares:
            flux2[:, 1].index_add_(0, b, v * v)
        lo += k
    return flux


def n_buckets(nbins: int, shift: int) -> int:
    """Buckets of ``2^shift`` consecutive bins that cover ``nbins``; the
    last may be short."""
    return -(-nbins >> shift)


def bucket_shift(m: int, nbins: int) -> int:
    """The largest shift up to ``MAX_SHIFT`` for which the mean bucket,
    ``m / n_buckets(nbins, shift)`` records, holds at most a third of
    ``BUCKET_CAPACITY``; 0 when none does."""
    for shift in range(MAX_SHIFT, 0, -1):
        if 3 * m <= BUCKET_CAPACITY * n_buckets(nbins, shift):
            return shift
    return 0


def bucket_counts_plain(bin, nbins: int, shift: int):
    """Records per bucket (int64), the count pass of the bucket path."""
    return torch.bincount(bin.long() >> shift,
                          minlength=n_buckets(nbins, shift))


def is_crowded(largest: int) -> bool:
    """A call whose largest bucket holds more records than a bucket's
    block can: it takes the crowded path."""
    return largest > BUCKET_CAPACITY


def key_bits(m: int, span: int) -> tuple[int, int]:
    """Bits of a bucket key's order field (``span`` = the largest order
    less the least) and of its record index (indices below ``m``). With
    the local bin's ``shift`` bits above them, a key fits when the three
    come to at most 63."""
    return span.bit_length(), max(1, (m - 1).bit_length())


def bucket_keys_plain(bin, order, shift: int):
    """The bucket path's key of every record, as ``bucket_place`` makes
    it: ``(bin mod 2^shift) << (obits + ibits) | (order - min order) <<
    ibits | record index``. Within a bucket, keys order the records by
    (bin, order, index). Raises ValueError when they do not fit 63 bits."""
    m = bin.numel()
    lo, hi = (int(v) for v in torch.aminmax(order))
    obits, ibits = key_bits(m, hi - lo)
    if shift + obits + ibits > 63:
        raise ValueError(f"keys of {shift} + {obits} + {ibits} bits do not "
                         "fit 63")
    local = bin.long() & ((1 << shift) - 1)
    idx = torch.arange(m, dtype=torch.int64, device=bin.device)
    return local << (obits + ibits) | (order - lo) << ibits | idx


def check_counts(m: int, nbins: int) -> None:
    """The kernels count records and bins in int32: raises ValueError
    unless ``m`` records and ``nbins`` bins each fit."""
    if m > _INT32_MAX or nbins >= _INT32_MAX:
        raise ValueError(
            f"records ({m}) and bins ({nbins}) must each fit int32")


def _check(flux, bin, c, order=None):
    dtype, dev = flux.dtype, flux.device
    if dtype not in _DTYPE_TAG:
        raise ValueError(f"flux must be float32 or float64: {dtype}")
    if flux.dim() != 1 or flux.numel() % 2 or not flux.is_contiguous():
        raise ValueError("flux must be a contiguous flat [nbins*2] tensor")
    m = bin.numel()
    named = [("bin", bin, torch.int32), ("c", c, dtype)]
    if order is not None:
        named.append(("order", order, torch.int64))
    for name, t, dt in named:
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != (m,):
            raise ValueError(f"{name} must have shape ({m},), got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, flux on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the scatter runs on 'cuda' or 'cpu', not {dev}")
    nbins = flux.numel() // 2
    check_counts(m, nbins)
    if m and dev.type == "cuda":
        lo, hi = torch.aminmax(bin)
        if int(lo) < 0 or int(hi) >= nbins:
            raise IndexError(f"bins must lie in [0, {nbins})")
    return nbins


def scatter_atomic(flux, bin, c, score_squares: bool = True):
    """K3 ``outer``: records into ``flux`` in the device's order. ``bin``
    is int32, ``c`` has the flux's dtype. CPU tensors take
    ``scatter_atomic_plain``; CUDA tensors the kernel. In place; returns
    ``flux``."""
    _check(flux, bin, c)
    if flux.device.type == "cpu":
        return scatter_atomic_plain(flux, bin, c, score_squares)
    return atomic_cuda(flux, bin, c, score_squares)


def scatter_ordered(flux, bin, order, c, score_squares: bool = True):
    """K3 ``peeled`` and the walk's tally: each bin's adds in ascending
    ``order`` (int64; ties in record order), bitwise equal to
    ``scatter_ordered_plain``. CPU tensors take the plain version; CUDA
    tensors the kernel. In place; returns ``flux``."""
    nbins = _check(flux, bin, c, order)
    if flux.device.type == "cpu":
        return scatter_ordered_plain(flux, bin, order, c, score_squares)
    return ordered_cuda(flux, bin, order, c, score_squares, nbins)


def lane_order(keys, nbins: int):
    """The permutation of the lanes ``0..n-1`` that orders ``keys`` (int32,
    values in ``[0, nbins)``): ``lane_order_plain`` for a CPU tensor. A
    CUDA tensor raises: on the card the walk's lane schedule
    (``walk_cuda.lane_records``) orders the lanes and keeps no
    permutation."""
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise TypeError(f"keys must be a 1-D int32 tensor, got {keys.dtype}")
    if keys.device.type != "cpu":
        raise ValueError(
            f"the lane order runs on the CPU, not {keys.device}; on the card "
            "walk_cuda.lane_records orders the lanes inside the schedule")
    if keys.numel():
        lo, hi = torch.aminmax(keys)
        if int(lo) < 0 or int(hi) >= nbins:
            raise IndexError(f"keys must lie in [0, {nbins})")
    return lane_order_plain(keys)


#: The C entries of csrc/scatter.cu this module binds.
SYMBOLS = ("pumi_bucket_count",) + tuple(
    f"pumi_scatter_{name}_{tag}"
    for name in ("atomic", "bucket", "ordered", "ordered_large", "smem")
    for tag in _DTYPE_TAG.values())


def _entry(name: str, dtype=None):
    fn = _build.bind(
        "scatter", name if dtype is None else f"{name}_{_DTYPE_TAG[dtype]}",
        SYMBOLS)
    fn.restype = ctypes.c_int
    return fn


def bucket_dynamic_smem(dtype, cap: int, shift: int) -> int:
    """The dynamic shared memory bytes a bucket fold launch passes for
    buckets of at most ``cap`` records and 2^``shift`` bins
    (``pumi_scatter_smem_<t>``; analysis/costmodel.py checks its
    mirror)."""
    fn = _entry("pumi_scatter_smem", dtype)
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_longlong
    return int(fn(int(cap), int(shift)))


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def atomic_cuda(flux, bin, c, score_squares):
    """Launch the atomic scatter of ``csrc/scatter.cu`` on checked
    records: 4 records a thread, each float32 (c, c²) pair one vector
    add."""
    global ATOMIC_LAUNCHES
    m = bin.numel()
    if m == 0:
        return flux
    if flux.data_ptr() % 8:
        raise ValueError("flux must be 8-byte aligned for the pair adds")
    fn = _entry("pumi_scatter_atomic", flux.dtype)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    with torch.cuda.device(flux.device):
        err = fn(flux.data_ptr(), bin.data_ptr(), c.data_ptr(), m,
                 int(bool(score_squares)), _stream(flux.device))
    if err != 0:
        raise RuntimeError(f"scatter_atomic launch failed with cudaError_t {err}")
    ATOMIC_LAUNCHES += 1
    return flux


def ordered_cuda(flux, bin, order, c, score_squares, nbins: int):
    """Launch the ordered scatter of ``csrc/scatter.cu`` on records that
    were checked (or that the walk made): count the records per bucket,
    scan, read the largest count and the order range to the host (the
    call's one host sync), then either place them by bucket and fold each
    bucket in shared memory (the bucket path) or, if the call is crowded
    or its keys do not fit, ``crowded_cuda``."""
    global ORDERED_LAUNCHES, BUCKET_LAUNCHES, LAST_BUCKETS
    m = bin.numel()
    check_counts(m, nbins)
    if m == 0:
        return flux
    dev = flux.device
    i32 = dict(dtype=torch.int32, device=dev)
    shift = bucket_shift(m, nbins)
    nb = n_buckets(nbins, shift)
    counts = torch.zeros(nb, **i32)
    offsets = torch.empty(nb + 1, **i32)
    tile_sums = torch.empty((nb + 4095) // 4096, **i32)
    # Staged without waiting on the stream: the read below is the one sync.
    info = torch.tensor([0, 2**63 - 1, -2**63], dtype=torch.int64).to(
        dev, non_blocking=True)
    count = _entry("pumi_bucket_count")
    count.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 5
    with torch.cuda.device(dev):
        err = count(bin.data_ptr(), order.data_ptr(), m, nbins, shift,
                    counts.data_ptr(), offsets.data_ptr(),
                    tile_sums.data_ptr(), info.data_ptr(), _stream(dev))
        if err != 0:
            raise RuntimeError(
                f"scatter_ordered bucket count failed with cudaError_t {err}")
        t0 = time.perf_counter()
        largest, lo, hi = info.tolist()
        wait_s = time.perf_counter() - t0
        obits, ibits = key_bits(m, hi - lo)
        crowded = is_crowded(largest) or shift + obits + ibits > 63
        LAST_BUCKETS = dict(shift=shift, buckets=nb, largest=largest,
                            capacity=BUCKET_CAPACITY,
                            key_bits=shift + obits + ibits,
                            path="crowded" if crowded else "bucket",
                            wait_s=wait_s)
        if crowded:
            del counts, offsets, tile_sums
            crowded_cuda(flux, bin, order, c, score_squares, nbins)
            ORDERED_LAUNCHES += 1
            return flux
        rec = torch.empty(2 * m, dtype=torch.int64, device=dev)
        fold = _entry("pumi_scatter_bucket", flux.dtype)
        fold.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                         + [ctypes.c_longlong] + [ctypes.c_int] * 4
                         + [ctypes.c_void_p] * 4)
        err = fold(flux.data_ptr(), bin.data_ptr(), order.data_ptr(),
                   c.data_ptr(), m, nbins, shift, lo, obits, ibits, largest,
                   int(bool(score_squares)), offsets.data_ptr(),
                   counts.data_ptr(), rec.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"scatter_ordered bucket fold failed with cudaError_t {err}")
    BUCKET_LAUNCHES += 1
    ORDERED_LAUNCHES += 1
    return flux


def crowded_cuda(flux, bin, order, c, score_squares, nbins: int):
    """The ordered scatter by bin over all records, for a call in which
    some bucket is too large for a block: count per bin, exclusive scan,
    place, order and fold each bin of at most 32 records; then one host
    read of how many bins (and records) are larger, and only if there are
    any, their sort scratch and the block sort that folds them."""
    global CROWDED_LAUNCHES
    m = bin.numel()
    check_counts(m, nbins)
    if m == 0:
        return flux
    dev = flux.device
    i32 = dict(dtype=torch.int32, device=dev)
    tiles = (nbins + 4095) // 4096
    counts = torch.zeros(nbins, **i32)
    offsets = torch.empty(nbins + 1, **i32)
    tile_sums = torch.empty(tiles, **i32)
    large_info = torch.zeros(2, **i32)
    large = torch.empty(m // 33 + 1, **i32)
    large_beg = torch.empty(m // 33 + 1, **i32)
    idx = torch.empty(m, **i32)
    small = _entry("pumi_scatter_ordered", flux.dtype)
    small.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
    )
    with torch.cuda.device(dev):
        err = small(
            flux.data_ptr(), bin.data_ptr(), order.data_ptr(), c.data_ptr(),
            m, nbins, int(bool(score_squares)), counts.data_ptr(),
            offsets.data_ptr(), tile_sums.data_ptr(), large_info.data_ptr(),
            large.data_ptr(), large_beg.data_ptr(), idx.data_ptr(),
            _stream(dev),
        )
        n_large, large_records = large_info.tolist() if err == 0 else (0, 0)
        if n_large:
            key_a = torch.empty(large_records, dtype=torch.int64, device=dev)
            key_b = torch.empty(large_records, dtype=torch.int64, device=dev)
            idx_b = torch.empty(large_records, **i32)
            big = _entry("pumi_scatter_ordered_large", flux.dtype)
            big.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_int] + [ctypes.c_void_p] * 7
            )
            err = big(
                flux.data_ptr(), order.data_ptr(), c.data_ptr(),
                int(bool(score_squares)), offsets.data_ptr(), n_large,
                large.data_ptr(), large_beg.data_ptr(), idx.data_ptr(),
                key_a.data_ptr(), key_b.data_ptr(), idx_b.data_ptr(),
                _stream(dev),
            )
    if err != 0:
        raise RuntimeError(
            f"scatter_ordered launch failed with cudaError_t {err}"
        )
    CROWDED_LAUNCHES += 1
    return flux
