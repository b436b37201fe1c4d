"""Program contracts of the port's move loop (the runner's third layer).

The JAX package asserts its hardest-won invariants on the traced program
of each public family (``pumiumtally_tpu/analysis/contracts.py``). The
port has no traced program: its move loop is eager torch code around
hand-written kernels. So a family is *run* here, at the JAX contract's
tiny problem, under a ``TorchFunctionMode`` (the torch calls the
package's own code makes, not aten's decompositions, which differ from
one torch release to the next) and ``sys.monitoring`` (the calls of the
kernel wrappers and their plain versions, by function), and the census
counts what matters semantically:

  * kernel-wrapper calls by name (``walk_cuda.trace``, ``walk_rows``,
    ``scatter.ordered_cuda``, ``source_cuda.sample_flight``, ...) and the
    plain versions they fall back to on CPU tensors;
  * host reads (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``.nonzero()``, ``int()``/``float()``/``bool()`` of a tensor), each
    placed at its innermost frame in the package, as PUMI001 reads the
    source;
  * copies across devices, by direction and site;
  * outputs of dtype float64, by site;
  * outputs as large as the flux or larger that are not the flux itself,
    the copies of the flux among them (its shape and dtype, another
    storage), and whether the flux kept its storage across the window;
  * the family's input and output shapes and dtypes.

Families, each a window of a facade run on one problem (a 2-cell box of
48 tets in two regions, 16 particles, 2 groups, ``max_crossings`` 64):

  trace         ``PumiTally`` under ``io_pipeline="legacy"``, move 2;
  trace_packed  the default packed path, move 2;
  megastep      ``run_source_moves`` at K = 8, the first chunk (the
                source tables staged in it);
  partitioned   ``PartitionedTally`` in 8 parts stacked on one device,
                move 2;
  cuda          the kernel path on the card (``capture_cuda``): a packed
                move and a megastep chunk; it never runs on the CPU.

``check_structural`` asserts what must hold with no committed capture
(see its docstring); ``diff_baseline`` compares a capture against the
committed ``CONTRACTS_TORCH.json`` field by field; ``write_contracts``
regenerates it (``python -m pumiumtally_tpu_torch.analysis
--write-contracts``, and say why in the PR). The capture holds no torch
version: the same tree gives the same capture under any torch release
on the CPU.
"""
from __future__ import annotations

import collections
import gc
import json
import os
import sys

from . import Finding
from .astlint import (
    APPROVED_TRANSFER_MODULES,
    F64_EXEMPT_MODULES,
    MOVE_LOOP_SCOPE,
    MOVE_LOOP_SCOPE_EXCLUDED,
    PACKAGE,
    PLAIN_VERSIONS,
)

CONTRACTS_FILE = "CONTRACTS_TORCH.json"

# The JAX contract's problem (pumiumtally_tpu/analysis/contracts.py:51-55);
# the cost layer (analysis/costmodel.py) runs the same families at a
# ladder of (n, cells) rungs whose first rung is this one.
_N = 16
_CELLS = 2  # box subdivisions per axis -> ntet = 6 * cells**3
_G = 2
_MAX_CROSSINGS = 64
_N_PARTS = 8
_K = 8  # moves of a megastep chunk
_TOL = 1e-6

FAMILIES = ("megastep", "partitioned", "trace", "trace_packed")

#: The functions whose calls a family counts: the kernel wrappers, the
#: kernel launch points, the plain versions and the round's stop test.
WATCHED = (
    ("ops/walk_cuda.py", "trace"),
    ("ops/walk_cuda.py", "trace_packed"),
    ("ops/walk_cuda.py", "walk_rows"),
    ("ops/walk_cuda.py", "_launch"),
    ("ops/walk_cuda.py", "lane_records_plain"),
    ("ops/walk.py", "trace"),
    ("ops/walk.py", "megastep"),
    ("ops/walk_partitioned.py", "walk_rows_plain"),
    ("ops/walk_partitioned.py", "_exchange"),
    ("ops/walk_partitioned.py", "_exchange_plain"),
    ("ops/integrity_cuda.py", "integrity_vector"),
    ("ops/walk.py", "integrity_vector"),
    ("ops/walk_partitioned.py", "Collectives.stop_test"),
    ("ops/scatter.py", "ordered_cuda"),
    ("ops/scatter.py", "crowded_cuda"),
    ("ops/scatter.py", "atomic_cuda"),
    ("ops/scatter.py", "scatter_ordered_plain"),
    ("ops/scatter.py", "scatter_atomic_plain"),
    ("ops/source_cuda.py", "sample_flight"),
    ("ops/source.py", "sample_flight_plain"),
    ("ops/gather.py", "gather_rows_plain"),
)

#: The read heads of PUMI001, as torch functions.
_READ_NAMES = frozenset({"item", "tolist", "cpu", "numpy", "nonzero",
                         "__int__", "__float__", "__bool__", "__index__"})


def environment() -> dict:
    """What a capture depends on: the device the families ran on and the
    problem. No torch version: the census reads the package's own torch
    calls, which a torch release does not change."""
    return {"device": "cpu", "problem": dict(
        n=_N, cells=_CELLS, n_groups=_G, max_crossings=_MAX_CROSSINGS,
        n_parts=_N_PARTS, megastep=_K, dtype="float32")}


def _name(rel: str, qual: str) -> str:
    """``walk_cuda.trace`` for (``ops/walk_cuda.py``, ``trace``)."""
    return f"{os.path.splitext(os.path.basename(rel))[0]}.{qual}"


#: The plain versions' names as the census counts them.
PLAIN_NAMES = frozenset(
    _name(p.removeprefix(f"{PACKAGE}/"), q) for p, q in PLAIN_VERSIONS)


# --------------------------------------------------------------------- #
# The census
# --------------------------------------------------------------------- #
class _Frames:
    """Places a torch call or a watched call in the package's source."""

    def __init__(self):
        import importlib

        self.root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self.pkg = os.path.join(self.root, PACKAGE) + os.sep
        self.watched: dict = {}
        for rel, qual in WATCHED:
            mod = importlib.import_module(
                f"{PACKAGE}." + rel[:-3].replace("/", "."))
            obj = mod
            for part in qual.split("."):
                obj = getattr(obj, part)
            self.watched[obj.__code__] = _name(rel, qual)
        self.plain = {c for c, n in self.watched.items() if n in PLAIN_NAMES}

    def site(self, frame) -> tuple:
        """(``path:symbol`` of the innermost package frame at or above
        ``frame``, whether a plain version is on the stack)."""
        f, site = frame, None
        while f is not None:
            if site is None and f.f_code.co_filename.startswith(self.pkg):
                rel = os.path.relpath(f.f_code.co_filename, self.root)
                symbol = ".".join(p for p in f.f_code.co_qualname.split(".")
                                  if not p.startswith("<"))
                site = f"{rel}:{symbol}"
            if f.f_code in self.plain:
                return site or "<torch>", True
            f = f.f_back
        return site or "<torch>", False


def _tensors(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _devices(args) -> set:
    return {t.device.type for t in _tensors(list(args))}


class Census:
    """``with Census(flux) as c: <a window>``: the counts of one window
    (module docstring). ``flux`` is the accumulator the window must
    update in place; ``c.record()`` is the window's census."""

    def __init__(self, flux, frames: _Frames | None = None):
        self.frames = frames or _Frames()
        self.flux = flux
        self.flux_numel = int(flux.numel())
        self.flux_ptr = flux.untyped_storage().data_ptr()
        self.flux_like = (tuple(flux.shape), flux.dtype)
        self.calls = collections.Counter()
        self.plain_callees: set = set()
        self.reads = collections.Counter()
        self.plain_reads = 0
        self.transfers = collections.Counter()
        self.f64 = collections.Counter()
        self.large = collections.Counter()
        self.copies = collections.Counter()
        self.ops = 0
        self.bytes_out = 0
        self.live = 0
        self.peak = 0
        self._live: dict = {}
        self._mode = None
        self._tool = None

    # -- sys.monitoring: the watched functions' calls ------------------ #
    def _on_start(self, code, offset):
        name = self.frames.watched.get(code)
        if name is None:
            return None
        _, under_plain = self.frames.site(sys._getframe(1).f_back)
        if under_plain:
            self.plain_callees.add(name)
        else:
            self.calls[name] += 1
        return None

    # -- the torch calls ------------------------------------------------ #
    def _on_torch(self, func, args, kwargs, out):
        import torch

        self.ops += 1
        name = getattr(func, "__name__", "")
        if name in _READ_NAMES and args and isinstance(args[0],
                                                       torch.Tensor):
            site, plain = self.frames.site(sys._getframe(2))
            if plain:
                self.plain_reads += 1
            else:
                self.reads[site] += 1
        src = (_devices(args[1:2]) if name == "copy_"
               else _devices(list(args) + list(kwargs.values())))
        if not src and name in ("tensor", "as_tensor"):
            src = {"cpu"}  # host data
        for t in _tensors(out):
            dev = t.device.type
            if src and dev not in src:
                site, _ = self.frames.site(sys._getframe(2))
                way = "h2d" if src == {"cpu"} else "d2h"
                self.transfers[f"{way} {site}"] += 1
            if t.dtype == torch.float64:
                self.f64[self.frames.site(sys._getframe(2))[0]] += 1
            try:
                ptr = t.untyped_storage().data_ptr()
            except RuntimeError:
                continue
            if t.numel() >= self.flux_numel and ptr != self.flux_ptr:
                site = self.frames.site(sys._getframe(2))[0]
                self.large[site] += 1
                if (tuple(t.shape), t.dtype) == self.flux_like:
                    self.copies[site] += 1
            if not t._is_view() and name != "__get__":
                nbytes = t.numel() * t.element_size()
                self.bytes_out += nbytes
                if ptr and ptr not in self._live:
                    self._track(t, ptr, nbytes)

    def _track(self, t, ptr, nbytes):
        """Live bytes of the window's fresh outputs, by storage."""
        import weakref

        self._live[ptr] = nbytes
        self.live += nbytes
        self.peak = max(self.peak, self.live)

        def gone(ptr=ptr, nbytes=nbytes, live=self._live):
            if live.pop(ptr, None) is not None:
                self.live -= nbytes

        weakref.finalize(t, gone)

    def __enter__(self):
        from torch.overrides import TorchFunctionMode

        census = self

        class _Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                census._on_torch(func, args, kwargs, out)
                return out

        mon = sys.monitoring
        self._tool = next(i for i in range(6) if mon.get_tool(i) is None)
        mon.use_tool_id(self._tool, "pumiumtally-contracts")
        mon.register_callback(self._tool, mon.events.PY_START,
                              self._on_start)
        for code in self.frames.watched:
            mon.set_local_events(self._tool, code, mon.events.PY_START)
        # No cycle collection inside the window: what is alive at each
        # output is then a function of the code alone.
        gc.collect()
        self._gc = gc.isenabled()
        gc.disable()
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        mon = sys.monitoring
        self._mode.__exit__(*exc)
        for code in self.frames.watched:
            mon.set_local_events(self._tool, code, 0)
        mon.register_callback(self._tool, mon.events.PY_START, None)
        mon.free_tool_id(self._tool)
        self._live.clear()
        if self._gc:
            gc.enable()
        return False

    def record(self, flux_after, moves: int) -> dict:
        """The window's census as the capture stores it."""
        return {
            "moves": moves,
            "calls": dict(sorted(self.calls.items())),
            "plain_callees": sorted(self.plain_callees),
            "host_reads": dict(sorted(self.reads.items())),
            "transfers": dict(sorted(self.transfers.items())),
            "f64_outputs": dict(sorted(self.f64.items())),
            "large_outputs": dict(sorted(self.large.items())),
            "flux_copies": dict(sorted(self.copies.items())),
            "flux_kept": bool(
                flux_after.untyped_storage().data_ptr() == self.flux_ptr),
        }

    def cost(self) -> dict:
        """The window's torch-op cost (analysis/costmodel.py)."""
        return {"ops": self.ops, "bytes_written": self.bytes_out,
                "peak_live_bytes": self.peak}


def _spec(x) -> str:
    """``float32[16,3]`` of a numpy array or a tensor."""
    dt = str(x.dtype).removeprefix("torch.")
    return f"{dt}[{','.join(map(str, x.shape))}]"


# --------------------------------------------------------------------- #
# The families
# --------------------------------------------------------------------- #
def problem(n=_N, cells=_CELLS, device="cpu", dtype=None):
    """The contracts' mesh and move inputs: a ``cells``^3 box in two
    regions split at x = 0.5, ``n`` particles, origins and two moves'
    destinations uniform in [0.2, 0.8]^3 (numpy seed 7, the JAX
    contract's)."""
    import numpy as np
    import torch

    from ..mesh.box import build_box_arrays
    from ..mesh.core import TetMesh

    coords, t2v = build_box_arrays(1.0, 1.0, 1.0, cells, cells, cells)
    centroids = coords[t2v].mean(axis=1)
    class_id = np.where(centroids[:, 0] < 0.5, 1, 2).astype(np.int32)
    mesh = TetMesh.from_numpy(coords, t2v, class_id=class_id,
                              dtype=dtype or torch.float32, device=device)
    rng = np.random.default_rng(7)
    return mesh, dict(
        origin=rng.uniform(0.2, 0.8, (n, 3)),
        dests=[rng.uniform(0.2, 0.8, (n, 3)) for _ in range(2)],
        groups=rng.integers(0, _G, n).astype(np.int32),
    )


def _config(**kw):
    import torch

    from ..utils.config import TallyConfig

    return TallyConfig(n_groups=_G, max_crossings=_MAX_CROSSINGS,
                       tolerance=_TOL, dtype=kw.pop("dtype", torch.float32),
                       **kw)


def source_params():
    from ..ops.source import SourceParams

    # The JAX contract's megastep physics (contracts.py:187-189).
    return SourceParams(sigma_t={1: 4.0, 2: 9.0}, absorption={1: 0.3, 2: 0.5},
                        survival_weight=0.2, downscatter=0.1, seed=13)


def _move_args(p, i):
    import numpy as np

    n = p["origin"].shape[0]
    return (p["dests"][i].reshape(-1).copy(), np.ones(n, np.int8),
            np.ones(n), p["groups"].copy(), np.zeros(n, np.int32))


def run_family(family, *, n=_N, cells=_CELLS, device="cpu", frames=None):
    """Run one family's window under a census; returns ``(record, cost,
    tally)``: the capture's record, the torch-op cost of the window and
    the facade."""
    import numpy as np

    from ..api import PumiTally
    from ..parallel.partitioned_api import PartitionedTally

    mesh, p = problem(n, cells, device)
    frames = frames or _Frames()
    if family == "partitioned":
        t = PartitionedTally(mesh, n, _config(), n_parts=_N_PARTS,
                             device=device)
        flux = lambda: t.flux_slabs  # noqa: E731
    else:
        io = "legacy" if family == "trace" else "packed"
        t = PumiTally(mesh, n, _config(io_pipeline=io, megastep=_K),
                      device=device)
        flux = lambda: t.flux  # noqa: E731
    t.initialize_particle_location(p["origin"].reshape(-1).copy())
    if family == "megastep":
        src = source_params()
        kw = dict(weights=np.ones(n), groups=p["groups"].copy(),
                  alive=np.ones(n, bool))
        inputs = [_spec(v) for v in kw.values()]
        with Census(flux(), frames) as c:
            out = t.run_source_moves(_K, src, **kw)
        moves = int(out["moves"])
        outputs = [_spec(flux())]
    else:
        t.move_to_next_location(*_move_args(p, 0))
        args = _move_args(p, 1)
        inputs = [_spec(a) for a in args]
        with Census(flux(), frames) as c:
            t.move_to_next_location(*args)
        moves = 1
        outputs = [_spec(flux())] + [_spec(a) for a in (args[0], args[4])]
    rec = dict(inputs=inputs, outputs=outputs, **c.record(flux(), moves))
    return rec, c.cost(), t


def capture(families=None, frames=None, run=None) -> dict:
    """The CPU families' census at the contracts' problem. ``run`` runs a
    family (``run_family``'s arguments); the runner passes one that keeps
    the runs for the cost layer, whose ladder starts at this problem."""
    frames = frames or _Frames()
    run = run or run_family
    return {"environment": environment(), "families": {
        fam: run(fam, n=_N, cells=_CELLS, frames=frames)[0]
        for fam in sorted(families or FAMILIES)}}


def capture_cuda(frames=None) -> dict:
    """The ``cuda`` family on the card: a packed move (move 2 of the
    problem) and a megastep chunk (the first), each a window, with the
    kernels' launch counters read around it."""
    import numpy as np
    import torch

    from ..api import PumiTally
    from ..ops import scatter, source_cuda, walk_cuda

    frames = frames or _Frames()
    mesh, p = problem(device="cuda")
    n = _N

    def launches():
        return dict(walk=walk_cuda.LAUNCHES, scatter=scatter.ORDERED_LAUNCHES,
                    bucket=scatter.BUCKET_LAUNCHES,
                    crowded=scatter.CROWDED_LAUNCHES,
                    flight=source_cuda.LAUNCHES,
                    schedule=walk_cuda.SCHEDULE_LAUNCHES)

    windows = {}
    t = PumiTally(mesh, n, _config(megastep=_K), device="cuda")
    t.initialize_particle_location(p["origin"].reshape(-1).copy())
    t.move_to_next_location(*_move_args(p, 0))
    args = _move_args(p, 1)
    io0, l0 = dict(t.io), launches()
    torch.cuda.synchronize()
    with Census(t.flux, frames) as c:
        t.move_to_next_location(*args)
        torch.cuda.synchronize()
    l1 = launches()
    windows["move"] = dict(c.record(t.flux, 1),
                           io={k: t.io[k] - io0[k] for k in t.io},
                           launches={k: l1[k] - l0[k] for k in l0})
    src = source_params()
    l0 = launches()
    torch.cuda.synchronize()
    with Census(t.flux, frames) as c:
        out = t.run_source_moves(_K, src, weights=np.ones(n),
                                 groups=p["groups"].copy(),
                                 alive=np.ones(n, bool))
        torch.cuda.synchronize()
    l1 = launches()
    windows["chunk"] = dict(c.record(t.flux, int(out["moves"])),
                            launches={k: l1[k] - l0[k] for k in l0})
    return {"environment": dict(environment(), device="cuda"),
            "families": {"cuda": windows}}


# --------------------------------------------------------------------- #
# Invariants
# --------------------------------------------------------------------- #
def _finding(invariant: str, family: str, message: str) -> Finding:
    return Finding(rule="CONTRACT", path=CONTRACTS_FILE, line=0,
                   symbol=f"{invariant}.{family}", message=message)


def allowances(baseline_entries) -> dict:
    """What the lint allows a window, from LINT_BASELINE_TORCH.json: the
    counted host reads (PUMI001 entries, ``path:symbol``) and the
    sanctioned float64 sites (PUMI005 entries)."""
    out = {"PUMI001": set(), "PUMI005": set()}
    for e in baseline_entries:
        if e["rule"] in out:
            out[e["rule"]].add(f"{e['path']}:{e['symbol']}")
    return out


def _module(site: str) -> str:
    return site.split(":", 1)[0]


def _device_op(site: str) -> bool:
    """Whether a site lies in the modules that run device operations
    (PUMI001's scope); the facades and the stager are the transfer layer,
    whose float64 tensors are the caller's host arrays."""
    m = _module(site)
    return m.startswith(MOVE_LOOP_SCOPE) and m not in MOVE_LOOP_SCOPE_EXCLUDED


def _check_window(fam: str, w: dict, allow: dict, out: list,
                  expect: dict) -> None:
    """The invariants of one window; ``expect`` holds the wrapper calls a
    move (``calls``) and whether a move scatters (``scatter``)."""
    moves = max(int(w.get("moves", 1)), 1)
    bad_reads = {s: c for s, c in w["host_reads"].items()
                 if s not in allow["PUMI001"]
                 and _module(s) not in APPROVED_TRANSFER_MODULES}
    if bad_reads:
        out.append(_finding(
            "io.host_reads", fam,
            f"host reads outside the counted PUMI001 sites and the "
            f"transfer modules: {bad_reads} — each one leaves the card "
            "idle until the host queues the next kernel"))
    if not w["flux_kept"]:
        out.append(_finding(
            "inplace.flux", fam,
            "the flux accumulator lost its storage across the window — "
            "an out-of-place update doubles its memory and breaks the "
            "re-arm contract"))
    if w["flux_copies"]:
        out.append(_finding(
            "inplace.flux", fam,
            f"op outputs of the flux's shape and dtype that are not the "
            f"flux: {w['flux_copies']} — the accumulator must be updated "
            "in place"))
    bad_f64 = {s: c for s, c in w["f64_outputs"].items()
               if _device_op(s) and s not in allow["PUMI005"]
               and _module(s) not in F64_EXEMPT_MODULES}
    if bad_f64:
        out.append(_finding(
            "dtype.f32_purity", fam,
            f"float64 outputs in a float32 configuration at {bad_f64} "
            "(PUMI005's baselined sites are the sanctioned ones)"))
    calls = w["calls"]
    for name, per_move in expect.get("calls", {}).items():
        got = calls.get(name, 0)
        if got != per_move * moves:
            out.append(_finding(
                _SYMBOL[name], fam,
                f"{name} ran {got} time(s) over {moves} move(s), expected "
                f"{per_move} a move"))
    scatters = sum(calls.get(n, 0) for n in (
        "scatter.ordered_cuda", "scatter.crowded_cuda",
        "scatter.scatter_ordered_plain")) + sum(
        1 for n in w["plain_callees"] if n.startswith("scatter."))
    if expect.get("scatter") and not scatters:
        out.append(_finding(
            "structure.scatter", fam,
            "no ordered scatter a move — the tally moved off the walk"))


# What each family runs a move (or a chunk): {name: calls a move}, and
# the invariant a miscount is named by.
_EXPECT = {
    "trace": dict(calls={"walk_cuda.trace": 1, "walk.trace": 1},
                  scatter=True),
    "trace_packed": dict(calls={"walk_cuda.trace_packed": 1,
                                "walk_cuda.trace": 1, "walk.trace": 1},
                         scatter=True),
    "megastep": dict(calls={"walk_cuda.trace": 1, "walk.trace": 1,
                            "source_cuda.sample_flight": 1,
                            "source.sample_flight_plain": 1},
                     scatter=True),
    "partitioned": dict(calls={}, scatter=True),
}
_SYMBOL = {"walk_cuda.trace": "structure.walk",
           "walk_cuda.trace_packed": "structure.walk",
           "walk.trace": "structure.walk",
           "source_cuda.sample_flight": "structure.walk",
           "source.sample_flight_plain": "structure.walk",
           "scatter.ordered_cuda": "structure.scatter",
           "walk_cuda._launch": "structure.kernel"}


def check_structural(sigs: dict, baseline_entries=()) -> list[Finding]:
    """The invariants that hold with no committed capture, each named by
    the JAX invariant it replaces:

      io.host_reads.<family>   (io.callbacks) every host read of a window
                      lies at a counted PUMI001 site of
                      LINT_BASELINE_TORCH.json, or in a module PUMI002
                      approves for transfers; the plain versions' own
                      reads (CPU tensors only) are outside the window's
                      move loop, as PUMI001 reads them.
      io.transfers.cuda  (io.transfers) a packed move makes one H2D and
                      one D2H, the staging layer's (the facade's own
                      ``io`` counters and the census agree).
      inplace.flux.<family>  (donation) the flux keeps its storage across
                      the window, and no other op output is a copy of it
                      (its shape and dtype in another storage).
      dtype.f32_purity.<family>  no float64 output in a float32
                      configuration in the modules that run device
                      operations, but at PUMI005's baselined sites (the
                      facades' float64 tensors wrap the caller's arrays).
      structure.walk.<family>, structure.scatter.<family>
                      (structure.walk_loop, structure.scatter) the
                      expected wrapper calls a move.
      structure.chunk.megastep  (structure.scan) K moves in one
                      ``megastep`` call.
      structure.stacked.partitioned  (structure.shard_map) one stacked
                      ``walk_rows`` a round: as many walk launches as stop
                      tests, and no per-part walk.
      structure.kernel.cuda  (structure.pallas_call) the launch counters
                      of the walk, the scatter and the flight kernel move
                      and no plain version is called: the guard against a
                      silent fallback.
    """
    allow = allowances(baseline_entries)
    out: list[Finding] = []
    for fam, sig in sorted(sigs["families"].items()):
        if fam == "cuda":
            _check_cuda(sig, allow, out)
            continue
        _check_window(fam, sig, allow, out, _EXPECT.get(fam, {}))
        calls = sig["calls"]
        if fam == "megastep":
            if calls.get("walk.megastep", 0) != 1 or sig["moves"] != _K:
                out.append(_finding(
                    "structure.chunk", fam,
                    f"{calls.get('walk.megastep', 0)} megastep call(s) for "
                    f"{sig['moves']} move(s): a chunk must run its K = "
                    f"{_K} moves in one megastep call"))
        if fam == "partitioned":
            rounds = calls.get("walk_partitioned.Collectives.stop_test", 0)
            # walk_rows sends CPU tensors to walk_rows_plain
            walks = calls.get("walk_cuda.walk_rows") or calls.get(
                "walk_partitioned.walk_rows_plain", 0)
            if not rounds or walks != rounds or calls.get(
                    "walk_cuda.trace", 0):
                out.append(_finding(
                    "structure.stacked", fam,
                    f"{walks} stacked walk(s) for {rounds} round(s) and "
                    f"{calls.get('walk_cuda.trace', 0)} per-part walk(s): "
                    "every round walks all parts in one stacked launch"))
    return out


def _check_cuda(sig: dict, allow: dict, out: list) -> None:
    fam = "cuda"
    move, chunk = sig["move"], sig["chunk"]
    _check_window(fam, move, allow, out, dict(
        calls={"walk_cuda.trace_packed": 1, "walk_cuda.trace": 1,
               "walk_cuda._launch": 1, "scatter.ordered_cuda": 1},
        scatter=True))
    _check_window(fam, chunk, allow, out, dict(
        calls={"walk_cuda.trace": 1, "walk_cuda._launch": 1,
               "scatter.ordered_cuda": 1, "source_cuda.sample_flight": 1},
        scatter=True))
    io = move.get("io", {})
    staged = collections.Counter(
        k.split(" ", 1)[0] for k in move["transfers"]
        if _module(k.split(" ", 1)[1]) in (f"{PACKAGE}/ops/staging.py",
                                           f"{PACKAGE}/api.py"))
    if (io.get("h2d_transfers"), io.get("d2h_transfers")) != (1, 1) or (
            staged.get("h2d", 0), staged.get("d2h", 0)) != (1, 1):
        out.append(_finding(
            "io.transfers", fam,
            f"a packed move made {io.get('h2d_transfers')} H2D and "
            f"{io.get('d2h_transfers')} D2H by the facade's count, "
            f"{dict(staged)} by the census at the staging layer: the "
            "contract is one of each"))
    for name, w in (("move", move), ("chunk", chunk)):
        plain = [n for n in w["calls"] if n in PLAIN_NAMES] + w[
            "plain_callees"]
        moved = w.get("launches", {})
        want = ("walk", "scatter", "schedule") + (
            ("flight",) if name == "chunk" else ())
        idle = [k for k in want if not moved.get(k)]
        if plain or idle:
            out.append(_finding(
                "structure.kernel", fam,
                f"the {name} window called plain versions {sorted(plain)} "
                f"and launched no {idle} kernel — the kernel path silently "
                "fell back"))


_COUNTED = ("calls", "host_reads", "transfers", "f64_outputs",
            "large_outputs", "flux_copies")


def diff_baseline(current: dict, baseline: dict) -> list[Finding]:
    """Compare a capture against the committed CONTRACTS_TORCH.json; any
    difference is a named finding. Regenerate with ``python -m
    pumiumtally_tpu_torch.analysis --write-contracts``."""
    out: list[Finding] = []
    if current["environment"] != baseline.get("environment"):
        out.append(_finding(
            "environment", "all",
            f"capture environment {current['environment']} != baseline "
            f"{baseline.get('environment')} — contracts are compared at "
            "one problem on the CPU"))
        return out
    cur_f, base_f = current["families"], baseline.get("families", {})
    for fam in sorted(set(cur_f) | set(base_f)):
        if fam not in base_f:
            out.append(_finding(
                "family.added", fam, "family captured but absent from "
                f"{CONTRACTS_FILE} — regenerate the baseline"))
            continue
        if fam not in cur_f:
            out.append(_finding(
                "family.removed", fam,
                f"family in {CONTRACTS_FILE} but no longer captured"))
            continue
        c, b = cur_f[fam], base_f[fam]
        for field in sorted(set(c) | set(b)):
            if field in _COUNTED and isinstance(c.get(field), dict):
                cf, bf = c.get(field, {}), b.get(field, {})
                for key in sorted(set(cf) | set(bf)):
                    if cf.get(key, 0) != bf.get(key, 0):
                        out.append(_finding(
                            f"{field}.{key}", fam,
                            f"{field} drifted at {key}: baseline "
                            f"{bf.get(key, 0)} -> current {cf.get(key, 0)}"))
            elif c.get(field) != b.get(field):
                out.append(_finding(
                    f"signature.{field}", fam,
                    f"{field} drifted: baseline {b.get(field)!r} -> "
                    f"current {c.get(field)!r}"))
    return out


def load_contracts(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def write_contracts(path, cap: dict | None = None) -> dict:
    from ..utils.checkpoint import atomic_write_json

    cap = cap or capture()
    # The committed capture is state every later run diffs against:
    # atomic write (PUMI008), so a torn regeneration never shows.
    atomic_write_json(path, cap)
    return cap
