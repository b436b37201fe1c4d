"""Streaming of independent particle batches through the walk, on CUDA
streams.

Counterpart of ``pumiumtally_tpu/models/pipeline.py``. A pipeline accepts
independent particle batches (successive source batches or generations)
and keeps ``depth`` of them in flight: each batch's inputs are staged into
pinned host buffers and copied to the card on a copy stream of their own,
the walk runs on the current stream after an event that orders it behind
the copy, and the batch's outputs are copied back into pinned buffers and
read on the host only when the batch is ``depth`` submissions old. The
flux accumulates over all batches, each walk folding into it in place in
submission order.

What overlaps on the card: the ordered walk reads two numbers on the host
in the middle of each batch (its record count and the scatter's bucket
information, ``ops/walk_cuda.py`` and ``ops/scatter.py``), so ``submit``
returns only once the batch's walk kernel has run; the scatter's
placement and fold, the readback and the next batch's staging and copy
are what overlap. Merging the two reads is ROADMAP.md B2.

``submit_source`` takes a device-sourced batch instead: its whole event
loop (flight sampling, walk, physics; ``ops/walk.py::megastep``) runs
``n_moves`` moves on the card, and its result carries the physics
counters. It is done only when every particle is dead and no walk was
cut short.

Use ``PumiTally.move_to_next_location`` for the strictly sequential
per-event contract, where one event's output feeds the next.
"""
from __future__ import annotations

import collections
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..core.tally import make_flux
from ..obs.walk_stats import stats_to_dict
from ..ops import walk_cuda
from ..ops.staging import (
    HostStager,
    host_tensor,
    pack_trace_readback,
    readback_views,
)
from ..utils.config import TallyConfig
from ..utils.timing import StepClock, clock_step


def _owned(a, dtype=None) -> np.ndarray:
    """A contiguous copy of a host array or tensor in ``dtype`` (torch's
    threaded CPU copy, a cast where the dtype differs)."""
    t = torch.as_tensor(a)
    out = torch.empty(t.shape, dtype=dtype or t.dtype)
    return out.copy_(t).numpy()


class BatchResult(NamedTuple):
    """Host-side outputs for one streamed batch.

    ``stats`` is the named per-move stats dict (obs/walk_stats.py) when
    the config keeps walk_stats on; ``all_done`` then comes from its
    truncation counter, else from the done flags. ``xpoints`` [n, K, 3]
    and ``n_xpoints`` [n] are the batch's crossing points and counts when
    the config sets ``record_xpoints=K``, else None. ``physics`` holds a
    ``submit_source`` batch's counters (``ops/source.py``
    MEGA_PHYS_FIELDS), None for ``submit`` batches; ``shape_key`` is None
    until the tuning shapes are ported (A10)."""

    index: int
    position: np.ndarray
    elem: np.ndarray
    material_id: np.ndarray
    n_segments: int
    all_done: bool
    xpoints: np.ndarray | None = None
    n_xpoints: np.ndarray | None = None
    stats: dict | None = None
    physics: dict | None = None
    shape_key: str | None = None


class StreamingTallyPipeline:
    """Stream independent particle batches through the walk.

    Args:
      mesh: TetMesh; its device is the pipeline's.
      config: TallyConfig; n_groups, dtype, tolerance, max_crossings,
        score_squares, robust, ledger, walk_stats and record_xpoints apply
        (as in the JAX pipeline, checkify_invariants does not); sd_mode must
        be "segment"; the facade's convergence, truncation_retries and
        quarantine do not apply (as in the JAX pipeline).
      depth: submissions kept in flight before the oldest result is read
        back (2 = double buffering).
      want_outputs: when False, per-batch positions and material ids are
        never copied back; only the flux accumulates.
    """

    def __init__(self, mesh, config: TallyConfig | None = None,
                 depth: int = 2, want_outputs: bool = True):
        self.mesh = mesh
        self.config = config or TallyConfig()
        if self.config.sd_mode != "segment":
            raise NotImplementedError(
                "StreamingTallyPipeline supports sd_mode='segment' only "
                "(batches overlap in flight, so a per-move even-entry "
                "snapshot would serialize the pipeline); use PumiTally "
                f"for sd_mode={self.config.sd_mode!r}"
            )
        if self.config.compact_stages == "adaptive":
            raise NotImplementedError(
                "compact_stages='adaptive' replans via PumiTally's "
                "post-move hook; the pipeline resolves its schedule "
                "once — use 'plan' or an explicit schedule"
            )
        self.depth = max(1, int(depth))
        self.want_outputs = want_outputs
        self.device = mesh.device
        self._kernel_policy = self.config.resolve_kernel()
        self._src_tables = None
        self.flux = make_flux(mesh.ntet, self.config.n_groups,
                              self.config.dtype, device=self.device)
        self._cuda = self.device.type == "cuda"
        # A staging buffer is written again depth + 1 submissions later,
        # after the copy event of the submission depth + 1 back has been
        # waited on (``_h2d``); a readback buffer is read at the drain,
        # depth submissions later.
        self._stager = HostStager(depth=self.depth + 1, device=self.device)
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)
        self._h2d: collections.deque = collections.deque()
        self._inflight: collections.deque = collections.deque()
        self._n_submitted = 0
        self._results: list[BatchResult] = []
        self._face_rate: float | None = None
        self._records: int | None = None  # the last walk's tally records
        # Set to a StepClock to time each host step of the calls.
        self.step_clock: StepClock | None = None

    # ------------------------------------------------------------------ #
    def submit(self, origin, dest, elem, weight=None, group=None,
               in_flight=None, material_id=None) -> None:
        """Stage one batch (host arrays) and walk it; returns once its walk
        kernel has run, before its scatter and readback are done (on the
        card)."""
        cfg = self.config
        dt, i32 = cfg.dtype, torch.int32
        n = np.asarray(origin).shape[0]
        given = {
            "origin": (origin, dt, (n, 3)), "dest": (dest, dt, (n, 3)),
            "elem": (elem, i32, (n,)), "weight": (weight, dt, (n,)),
            "group": (group, i32, (n,)),
            "in_flight": (in_flight, torch.bool, (n,)),
            "material_id": (material_id, i32, (n,)),
        }
        step = self._step
        with step("capacity"):
            cap = self._capacity(n, origin, dest, in_flight)
        t = self._stage({k: v for k, v in given.items() if v[0] is not None})
        dev = self.device
        if "weight" not in t:
            t["weight"] = torch.ones(n, dtype=dt, device=dev)
        if "group" not in t:
            t["group"] = torch.zeros(n, dtype=i32, device=dev)
        if "in_flight" not in t:
            t["in_flight"] = torch.ones(n, dtype=torch.bool, device=dev)
        if "material_id" not in t:
            t["material_id"] = torch.full((n,), -1, dtype=i32, device=dev)
        with step("walk"):
            r = walk_cuda.trace(
                self.mesh, t["origin"], t["dest"], t["elem"], t["in_flight"],
                t["weight"], t["group"], t["material_id"], self.flux,
                initial=False,
                max_crossings=cfg.resolve_max_crossings(self.mesh.ntet),
                n_groups=cfg.n_groups, score_squares=cfg.score_squares,
                tolerance=cfg.tolerance, robust=cfg.robust,
                ledger=cfg.ledger, stats=cfg.walk_stats, capacity=cap,
                record_xpoints=cfg.record_xpoints,
            )
        self._records = r.n_records
        entry = (self._n_submitted, n, None, None, None, None, None, None)
        if self.want_outputs:
            with step("readback"):
                entry = (self._n_submitted, n, *self._read_back(r), "walk")
        self._inflight.append(entry)
        self._n_submitted += 1
        while len(self._inflight) > self.depth:
            self._drain_one()

    def _step(self, name: str):
        """The context of one timed host step (nothing without a clock)."""
        return clock_step(self.step_clock, name)

    def _capacity(self, n, origin, dest, in_flight) -> int | None:
        """The walk's record buffers on the card: from the last batch's
        records, or for the first batch from its paths (host arrays)."""
        if not self._cuda:
            return None
        if self._records is not None:
            return walk_cuda.record_capacity(n, self._records)
        if self._face_rate is None:
            self._face_rate = walk_cuda.face_rate(self.mesh)
        fly = np.ones(n, bool) if in_flight is None else in_flight
        return walk_cuda.record_capacity(n, walk_cuda.path_records(
            self._face_rate, origin, dest, fly))

    def _stage(self, given: dict) -> dict:
        """The batch's arrays in the walk's dtypes on the pipeline's
        device: cast into pinned host buffers, copied on the copy stream,
        the current stream made to wait for the copy. Each device tensor
        is marked as used on the current stream (``record_stream``), since
        the copy stream allocated it."""
        with self._step("stage"):
            if len(self._h2d) > self.depth:  # its submission's buffers return
                self._h2d.popleft().synchronize()
            host = {}
            for name, (a, dt, shape) in given.items():
                buf = self._stager.buf(shape, dt, name)
                buf.copy_(host_tensor(a).reshape(shape))
                host[name] = buf
        if not self._cuda:
            return host
        with self._step("copy"):
            walk_stream = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                out = {k: b.to(self.device, non_blocking=True)
                       for k, b in host.items()}
                copied = torch.cuda.Event()
                copied.record(self._copy_stream)
            walk_stream.wait_event(copied)
            for t in out.values():
                t.record_stream(walk_stream)
            self._h2d.append(copied)
        return out

    def _read_back(self, r):
        """The batch's readback (``staging.pack_trace_readback``), elements
        and, with ``record_xpoints``, crossing points and counts, copied
        into pinned buffers on the current stream without waiting, and the
        event that marks the copies' end (None on the CPU, where they are
        the outputs themselves)."""
        rb = pack_trace_readback(r.position, r.material_id, r.done, r.stats,
                                 r.n_segments)
        outs = [rb, r.elem, r.xpoints, r.n_xpoints]
        if not self._cuda:
            return (*outs, None)
        hosts = []
        for name, t in zip(("readback", "elem_out", "xp_out", "kx_out"),
                           outs):
            if t is None:
                hosts.append(None)
                continue
            buf = self._stager.buf(t.shape, t.dtype, name)
            buf.copy_(t, non_blocking=True)
            hosts.append(buf)
        done = torch.cuda.Event()
        done.record()
        return (*hosts, done)

    def _drain_one(self) -> None:
        idx, n, host_rb, host_elem, host_xp, host_kx, done, kind = (
            self._inflight.popleft())
        if host_rb is None:
            return
        if kind == "source":
            self._drain_megastep(idx, host_rb, host_elem, host_xp, host_kx,
                                 done)
            return
        with self._step("drain"):
            if done is not None:
                done.synchronize()
            pos, mats, done_words, tail, _, _ = readback_views(
                host_rb, n, self.config.dtype)
            if self.config.walk_stats:
                stats = stats_to_dict(tail)
                all_done, segs = stats["truncated"] == 0, stats["segments"]
            else:
                stats, segs = None, int(tail[0])
                all_done = not (done_words == 0).any()
            # Owned copies (the buffers return to the ring), made with
            # torch's threaded CPU copies.
            self._results.append(BatchResult(
                index=idx,
                position=_owned(pos),
                elem=_owned(host_elem),
                material_id=_owned(mats, torch.int32),
                n_segments=segs,
                all_done=all_done,
                xpoints=None if host_xp is None else _owned(host_xp),
                n_xpoints=None if host_kx is None else _owned(host_kx),
                stats=stats,
            ))

    # ------------------------------------------------------------------ #
    def shape_keys(self) -> dict:
        """{shape-class key: batches submitted}: empty until the tuning
        shapes are ported (ROADMAP.md A10)."""
        return {}

    def submit_source(self, origin, elem, n_moves: int, source=None,
                      weight=None, group=None) -> None:
        """Stage one device-sourced batch (host ``origin`` [n,3] and
        ``elem`` [n], optional ``weight`` and ``group``) and run its whole
        ``n_moves`` event loop on the card (``ops/walk.py::megastep``,
        from move 0 with the key of ``source.seed``); batches are
        independent, so give each its own seed. Its result drains like a
        ``submit`` batch's, with the physics counters attached."""
        cfg = self.config
        cfg.resolve_megastep()
        if self._kernel_policy == "pallas" and cfg.kernel == "pallas":
            raise NotImplementedError(
                "submit_source fuses source sampling + walk + physics "
                "into one scanned XLA program; kernel='pallas' does not "
                "ride it — use kernel='auto' (XLA fallback) or 'xla'"
            )
        from ..ops.source import (
            SourceParams,
            near_epsilon,
            prng_key,
            staged_tables,
        )
        from ..ops.walk import megastep

        src = source if source is not None else SourceParams()
        self._src_tables = staged_tables(src, self.mesh.class_values,
                                         cfg.dtype, self.device,
                                         self._src_tables)
        _, sig, ab = self._src_tables
        dt, i32 = cfg.dtype, torch.int32
        n = np.asarray(origin).shape[0]
        given = {"origin": (origin, dt, (n, 3)), "elem": (elem, i32, (n,)),
                 "weight": (weight, dt, (n,)), "group": (group, i32, (n,))}
        with self._step("capacity"):
            cap = self._source_capacity(n, src)
        t = self._stage({k: v for k, v in given.items() if v[0] is not None})
        dev = self.device
        if "weight" not in t:
            t["weight"] = torch.ones(n, dtype=dt, device=dev)
        if "group" not in t:
            t["group"] = torch.zeros(n, dtype=i32, device=dev)
        with self._step("megastep"):
            out = megastep(
                self.mesh, t["origin"], t["elem"],
                torch.full((n,), -1, dtype=i32, device=dev), t["weight"],
                t["group"], torch.ones(n, dtype=torch.bool, device=dev),
                torch.arange(n, dtype=i32, device=dev), self.flux, 0,
                prng_key(src.seed), sig, ab, n_moves=int(n_moves),
                n_groups=cfg.n_groups,
                survival_weight=float(src.survival_weight),
                downscatter=float(src.downscatter),
                eps_near=near_epsilon(self.mesh.coords),
                max_crossings=cfg.resolve_max_crossings(self.mesh.ntet),
                score_squares=cfg.score_squares, tolerance=cfg.tolerance,
                robust=cfg.robust, ledger=cfg.ledger, stats=cfg.walk_stats,
                capacity=cap,
            )
        if out.n_records is not None:
            self._records = out.n_records
        entry = (self._n_submitted, n, None, None, None, None, None, None)
        if self.want_outputs:
            with self._step("readback"):
                entry = (self._n_submitted, n,
                         *self._read_back_source(out))
        self._inflight.append(entry)
        self._n_submitted += 1
        while len(self._inflight) > self.depth:
            self._drain_one()

    def _source_capacity(self, n: int, src) -> int | None:
        """The first walk's record buffers of a source batch on the card:
        from the last walk's records, or from the least Σt of the mesh's
        regions (each lane's mean flight crosses ``face_rate / Σt``
        faces)."""
        if not self._cuda:
            return None
        if self._records is not None:
            return walk_cuda.record_capacity(n, self._records)
        from ..ops.source import least_sigma_t

        if self._face_rate is None:
            self._face_rate = walk_cuda.face_rate(self.mesh)
        return walk_cuda.record_capacity(n, walk_cuda.source_records(
            self._face_rate, n, least_sigma_t(src, self.mesh.class_values)))

    def _read_back_source(self, out):
        """A source batch's tail, positions, elements and material ids,
        copied into pinned buffers without waiting (as ``_read_back``)."""
        outs = [out.readback, out.position, out.elem, out.material_id]
        if not self._cuda:
            return (*outs, None, "source")
        hosts = []
        for name, t in zip(("tail", "pos_out", "elem_out", "mat_out"), outs):
            buf = self._stager.buf(t.shape, t.dtype, name)
            buf.copy_(t, non_blocking=True)
            hosts.append(buf)
        done = torch.cuda.Event()
        done.record()
        return (*hosts, done, "source")

    def _drain_megastep(self, idx, tail, pos, elem, mats, done) -> None:
        """Drain one ``submit_source`` batch: its tail's stats and physics,
        and its per-lane outputs. A batch is done only when every particle
        terminated (absorbed, escaped or rouletted) and no walk was cut
        short: lanes alive when ``n_moves`` ran out are unfinished work."""
        from ..ops.source import phys_to_dict
        from ..ops.staging import split_megastep_tail

        cfg = self.config
        with self._step("drain"):
            if done is not None:
                done.synchronize()
            stail, _, _, phys = split_megastep_tail(
                tail, cfg.dtype, cfg.walk_stats, False, False)
            if cfg.walk_stats:
                stats = stats_to_dict(stail)
                segs = stats["segments"]
            else:
                stats, segs = None, int(stail[0])
            p = phys_to_dict(phys)
            self._results.append(BatchResult(
                index=idx,
                position=_owned(pos),
                elem=_owned(elem),
                material_id=_owned(mats),
                n_segments=segs,
                all_done=p["alive"] == 0 and p["truncated"] == 0,
                stats=stats,
                physics=p,
            ))

    def results(self) -> Iterator[BatchResult]:
        """Results read back so far (lagging submissions by ``depth``)."""
        return iter(self._results)

    def finish(self) -> np.ndarray:
        """Drain the queue and return the accumulated raw flux
        ``[ntet, n_groups, 2]`` (a host copy)."""
        while self._inflight:
            self._drain_one()
        with self._step("flux"):
            return self.flux.to("cpu", copy=True).numpy().reshape(
                self.mesh.ntet, self.config.n_groups, 2
            )
