"""Wrapper of the partitioned exchange's kernels ``csrc/exchange.cu``.

One exchange round of the partitioned step (``walk_partitioned._exchange``)
on the card: ``bucket`` ranks each local part's emigrants by destination
in slot order and writes the send rows (three launches), the caller's
``Collectives`` moves the send blocks and their row counts, and
``adopt`` places each part's immigrants into its free slots (two
launches). Together they are the counterpart of the exchange of
``pumiumtally_tpu/ops/walk_partitioned.py::make_partitioned_step``
(:788-934), which the JAX package left to XLA; the plain version is
``walk_partitioned._exchange_plain``, bitwise equal. No host read, no
allocation in the kernels: ``workspace`` allocates a step's send buffer
and scratch once (``torch.empty``: a receiver reads only the counted rows
of a block), and the rounds reuse them.

``check`` holds a round's arguments to what the kernels take (dtypes,
shapes, contiguity, ``1 <= E <= cap``, the parts' count) and raises
``ValueError``; it runs on every device, before the dispatch.
``BUCKET_LAUNCHES`` and ``ADOPT_LAUNCHES`` count the wrapper's calls that
launched their kernels, and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

BUCKET_LAUNCHES = 0
ADOPT_LAUNCHES = 0

#: Slots a tile of the count, place and adopt passes (csrc TILE).
TILE = 256
#: The parts a round takes (csrc MAX_PARTS).
MAX_PARTS = 1024
#: A send row, which the kernels and ``walk_partitioned._exchange_plain``
#: both write: float columns cur(3) dest(3) weight pseg, then 3K points;
#: int32 columns pid group material target_elem marker done back-code,
#: then the point count (else padding).
FLOAT_COLS, INT_COLS = 8, 8

#: The slot state's fields in ``csrc/exchange.cu``'s ``Slots`` order:
#: (name, dtype or None for the walk's float type, trailing shape).
SLOT_FIELDS = (
    ("valid", torch.bool, ()), ("target", torch.int32, ()),
    ("elem", torch.int32, ()), ("stuck", torch.int32, ()),
    ("cur", None, (3,)), ("dest", None, (3,)), ("weight", None, ()),
    ("pseg", None, ()), ("pid", torch.int32, ()),
    ("group", torch.int32, ()), ("material_id", torch.int32, ()),
    ("target_elem", torch.int32, ()), ("done", torch.bool, ()),
    ("prev", torch.int32, ()), ("xp", None, None), ("kx", torch.int32, ()),
)

_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "bucket": [ctypes.POINTER(_P), _P] + [_I] * 7 + [_P] * 6,
    "adopt": [ctypes.POINTER(_P)] + [_I] * 5 + [_P] * 7,
}
#: The C entries of csrc/exchange.cu this module binds.
SYMBOLS = tuple(f"pumi_exchange_{k}_{t}" for k in ("bucket", "adopt")
                for t in _DTYPE_TAG.values()) + (
    "pumi_exchange_row_bytes", "pumi_exchange_smem")
_FNS: dict = {}


def _entry(kind: str, dtype):
    fn = _FNS.get((kind, dtype))
    if fn is None:
        fn = _build.bind("exchange",
                         f"pumi_exchange_{kind}_{_DTYPE_TAG[dtype]}", SYMBOLS)
        fn.argtypes = _ARGTYPES[kind]
        fn.restype = ctypes.c_int
        _FNS[kind, dtype] = fn
    return fn


def dynamic_smem(n_parts: int) -> int:
    """The dynamic shared memory bytes the largest launch of a round
    passes at ``n_parts`` parts (``pumi_exchange_smem``;
    analysis/costmodel.py checks its mirror)."""
    fn = _build.bind("exchange", "pumi_exchange_smem", SYMBOLS)
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return int(fn(int(n_parts)))


def row_bytes(dtype, K: int) -> int:
    """The bytes of a send row, which the buffer is allocated with (the
    kernels' stride is ``kernel_row_bytes``; the card checks they
    agree)."""
    return ((FLOAT_COLS + 3 * K) * torch.finfo(dtype).bits // 8
            + INT_COLS * 4)


def kernel_row_bytes(dtype, K: int) -> int:
    """The send row's bytes as the kernels address it
    (``pumi_exchange_row_bytes``)."""
    fn = _build.bind("exchange", "pumi_exchange_row_bytes", SYMBOLS)
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return int(fn(int(K), torch.finfo(dtype).bits // 8))


def check(s: dict, P: int, lo: int, P_l: int, cap: int, E: int,
          max_local: int, canon, dropped) -> int:
    """Raise ValueError unless a round's slot state ``s`` (the step's
    ``[P_l·cap]`` tensors, ``xp``/``kx`` None or both set), the halo's
    back codes ``canon``, the drop counts ``dropped`` and the sizes are
    what the kernels take; returns the points a slot carries (K)."""
    cur = s["cur"]
    dtype, dev = cur.dtype, cur.device
    if dtype not in _DTYPE_TAG:
        raise ValueError(f"the exchange is float32 or float64, not {dtype}")
    if not (1 <= P <= MAX_PARTS and 1 <= P_l <= P and 0 <= lo <= P - P_l):
        raise ValueError(
            f"parts {lo}..{lo + P_l} of {P}: the exchange takes 1 to "
            f"{MAX_PARTS} parts, this process's a block of them")
    if cap < 1 or not 1 <= E <= cap:
        raise ValueError(f"exchange_size E={E} must lie in [1, cap={cap}]")
    if max_local < 1:
        raise ValueError(f"max_local must be >= 1, not {max_local}")
    if (s["xp"] is None) != (s["kx"] is None):
        raise ValueError("xp and kx carry the points together")
    K = 0 if s["xp"] is None else s["xp"].shape[1]
    total = P_l * cap
    for name, dt, tail in SLOT_FIELDS:
        t = s[name]
        if t is None:
            continue
        want = (total, K, 3) if name == "xp" else (total,) + tail
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must have shape {want}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != (dtype if dt is None else dt):
            raise ValueError(f"{name} must be {dtype if dt is None else dt},"
                             f" got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cur on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if canon is not None and (
            tuple(canon.shape) != (P_l * max_local,)
            or canon.dtype != torch.int64 or canon.device != dev
            or not canon.is_contiguous()):
        raise ValueError(f"canon must be a contiguous int64 "
                         f"[{P_l * max_local}] tensor on {dev}")
    if (tuple(dropped.shape) != (P_l,) or dropped.dtype != torch.int64
            or dropped.device != dev or not dropped.is_contiguous()):
        raise ValueError(f"dropped must be a contiguous int64 [{P_l}] "
                         f"tensor on {dev}")
    return K


def workspace(s: dict, P: int, P_l: int, cap: int, E: int, K: int) -> dict:
    """A step's send buffer ``buf`` ``[P_l, P, E, row]`` bytes (never
    cleared), the blocks' row counts ``rows`` ``[P_l, P]`` int32 and the
    rounds' int32 scratch: the tiles' counts, the free slots' tile counts
    and the adopt's offsets. Allocated once a step, reused every round."""
    dev = s["cur"].device
    tiles = -(-cap // TILE)
    i32 = dict(dtype=torch.int32, device=dev)
    rb = row_bytes(s["cur"].dtype, K)
    return dict(
        buf=torch.empty(P_l, P, E, rb, dtype=torch.uint8, device=dev),
        rows=torch.empty(P_l, P, **i32),
        counts=torch.empty(P_l * (P + 1) * tiles, **i32),
        free=torch.empty(P_l * tiles, **i32),
        info=torch.empty(P_l * (P + 2), **i32))


def _fields(s: dict):
    return (ctypes.c_void_p * len(SLOT_FIELDS))(*(
        None if s[name] is None else s[name].data_ptr()
        for name, _, _ in SLOT_FIELDS))


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def bucket(s: dict, P: int, lo: int, P_l: int, cap: int, E: int,
           max_local: int, canon, ws: dict, stats: torch.Tensor) -> None:
    """The bucket half of a round on checked arguments: send rows into
    ``ws["buf"]``, block counts into ``ws["rows"]``, the sent slots
    freed in ``s``, pending and sent into ``stats[:, :2]`` (int64
    ``[P_l, 5]``)."""
    global BUCKET_LAUNCHES
    cur = s["cur"]
    K = 0 if s["xp"] is None else s["xp"].shape[1]
    fn = _entry("bucket", cur.dtype)
    with torch.cuda.device(cur.device):
        err = fn(_fields(s), None if canon is None else canon.data_ptr(),
                 P, lo, P_l, cap, E, max_local, K, ws["counts"].data_ptr(),
                 ws["buf"].data_ptr(), ws["rows"].data_ptr(),
                 ws["free"].data_ptr(), stats.data_ptr(), _stream(cur.device))
    if err != 0:
        raise RuntimeError(
            f"exchange bucket launch failed with cudaError_t {err}")
    BUCKET_LAUNCHES += 1


def adopt(s: dict, P: int, P_l: int, cap: int, E: int, recv: torch.Tensor,
          recv_rows: torch.Tensor, ws: dict, stats: torch.Tensor,
          dropped: torch.Tensor) -> None:
    """The adopt half of a round: ``recv`` ``[P, P_l, E, row]`` bytes and
    ``recv_rows`` ``[P, P_l]`` int32 as the all_to_all returned them;
    immigrants into the free slots of ``s``, received, free and adopted
    into ``stats[:, 2:]``, the rows that found no slot added to
    ``dropped`` (int64 ``[P_l]``)."""
    global ADOPT_LAUNCHES
    cur = s["cur"]
    K = 0 if s["xp"] is None else s["xp"].shape[1]
    rb = row_bytes(cur.dtype, K)
    if (tuple(recv.shape) != (P, P_l, E, rb) or recv.dtype != torch.uint8
            or not recv.is_contiguous()):
        raise ValueError(f"recv must be a contiguous uint8 [{P}, {P_l}, {E},"
                         f" {rb}] tensor, got {tuple(recv.shape)}")
    if (tuple(recv_rows.shape) != (P, P_l) or recv_rows.dtype != torch.int32
            or not recv_rows.is_contiguous()):
        raise ValueError(f"recv_rows must be a contiguous int32 [{P}, {P_l}]"
                         f" tensor, got {tuple(recv_rows.shape)}")
    fn = _entry("adopt", cur.dtype)
    with torch.cuda.device(cur.device):
        err = fn(_fields(s), P, P_l, cap, E, K, recv.data_ptr(),
                 recv_rows.data_ptr(), ws["free"].data_ptr(),
                 ws["info"].data_ptr(), stats.data_ptr(), dropped.data_ptr(),
                 _stream(cur.device))
    if err != 0:
        raise RuntimeError(
            f"exchange adopt launch failed with cudaError_t {err}")
    ADOPT_LAUNCHES += 1
