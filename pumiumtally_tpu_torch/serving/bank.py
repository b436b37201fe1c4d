"""The library bank: built kernel libraries kept on disk for the next
server process.

Counterpart of ``pumiumtally_tpu/serving/bank.py``. The JAX bank
serializes compiled XLA executables so that a warm server process
compiles nothing. The port has no XLA programs: its compile cost is
``nvcc`` building ``csrc/<name>.cu`` (``ops/_build.py``), and its
kernels do not depend on the shape. So its bank holds built libraries,
one entry a source, keyed by the same content hash ``_build`` names its
libraries by (the source and the nvcc flags) and sectioned by the
environment (``tuning.db.env_key``: a library built for one card means
nothing to another)::

  <root>/<env key, e.g. torch-cuda-d1-NVIDIA-H100-80GB-HBM3>/
      <name>-<hash>/lib<name>-<hash>.so   the library
      <name>-<hash>/lib<name>-<hash>.log  ptxas's report
      <name>-<hash>/META.json             schema, environment, source
                                          sha256, nvcc flags and version,
                                          library sha256, the symbols the
                                          wrappers bind, ptxas's registers,
                                          shared memory and spills by
                                          instantiation, build seconds

Load-time validation, in the role of JAX's ``cost.donation.aot`` and
``cost.io.aot``: an entry is rebuilt and rewritten, its cause counted in
``pumi_aot_rewrites_total{cause=}`` and named in ``bank.findings``, when

  * ``stale``: its META does not match today's schema, environment,
    source, flags or nvcc;
  * ``torn``: its META does not parse, or the library's bytes do not
    match their sha256;
  * ``unloadable``: ``ctypes`` cannot load it, or a bound symbol is
    missing.

``pumi_aot_hits_total``, ``pumi_aot_misses_total`` and
``pumi_compile_seconds_total`` count the resolutions, each inside an
``aot_resolve`` span (in the current job's trace through the scheduler's
binding). ``PUMI_TPU_AOT_FAULT=torn`` writes the next entry torn (its
META records a library sha256 the bytes do not have; this process loads
the whole library), so the next process's loader must name it and
rewrite it.

The build step is ``_build.build_many`` into the entries' directories.
A bank that cannot build raises as ``_build`` does; there is nothing to
fall back to, since every library can be banked. ``build`` and
``loader`` replace the build and the load check (the CPU tests drive the
bookkeeping with toy bytes). ``PumiTally(..., program_bank=)`` on the
card loads its libraries through ``load``. A process holds one copy of
each library (``_build.load``): one that loaded a library from elsewhere
first (the package's own build, another bank) cannot load the bank's
entry of it, and ``load`` raises. The
load check maps each whole entry into the process, so another writer
must replace an entry's files (write and rename), never cut one in
place: a library cut under a process that maps it faults that process.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import threading
import time

from ..ops import _build

BANK_SCHEMA = 1
META_FILE = "META.json"

#: "torn": the next entry is written with a sha256 its library fails.
ENV_FAULT = "PUMI_TPU_AOT_FAULT"

#: The libraries a facade's main path and source loop run.
FACADE_LIBRARIES = ("walk", "scatter", "source")

def environment() -> dict:
    """The bank's environment: the tuning database's."""
    from ..tuning.db import environment as _env

    return _env()


def section_key(env: dict | None = None) -> str:
    from ..tuning.db import env_key

    return env_key(env or environment())


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def ptxas_summary(log_text: str) -> dict:
    """ptxas's registers, barriers, shared memory, stack and spills,
    instantiation by instantiation, from nvcc's ``-Xptxas=-v`` report
    (``analysis/costmodel.py::parse_ptxas``, the resource contracts'
    parser: ``cost.bank`` holds an entry's summary to the committed
    capture)."""
    from ..analysis.costmodel import parse_ptxas, summary

    return summary(parse_ptxas(log_text))


def nvcc_build(names: list, dirs: list) -> list[str]:
    """Build ``csrc/<name>.cu`` into each ``dirs`` entry, all together."""
    return _build.build_many(names, build_dir=dirs)


def ctypes_loader(path: str, symbols: list) -> None:
    """Load a library and look every bound symbol up; raises OSError or
    AttributeError."""
    lib = ctypes.CDLL(path)
    for sym in symbols:
        getattr(lib, sym)


class ProgramBank:
    """Disk bank of built kernel libraries (module docstring). Attach to
    a facade with ``PumiTally(..., program_bank=bank)`` or to a
    scheduler with ``TallyScheduler(..., bank=bank or root)``."""

    def __init__(self, root: str, *, registry=None, recorder=None,
                 tracer=None, build=None, loader=None):
        from ..obs import FlightRecorder, MetricsRegistry, SpanTracer

        self.root = str(root)
        self.env = environment()
        self.section = section_key(self.env)
        self.section_dir = os.path.join(self.root, self.section)
        self.registry = (
            registry if registry is not None else MetricsRegistry()
        )
        self.recorder = (
            recorder if recorder is not None else FlightRecorder()
        )
        self.tracer = tracer if tracer is not None else SpanTracer()
        self._build_fn = build or nvcc_build
        self._loader = loader or ctypes_loader
        r = self.registry
        self._hits = r.counter(
            "pumi_aot_hits_total",
            "library-bank resolutions served from a validated entry "
            "(no nvcc build)",
        )
        self._misses = r.counter(
            "pumi_aot_misses_total",
            "library-bank resolutions that built (entry absent)",
        )
        self._compile_s = r.counter(
            "pumi_compile_seconds_total",
            "wall seconds the library bank spent in nvcc builds",
        )
        self._rewrites = r.counter(
            "pumi_aot_rewrites_total",
            "bank entries rebuilt and rewritten after load-time "
            "validation (labeled by cause: stale, torn, unloadable)",
        )
        self._lock = threading.Lock()
        # Libraries resolved this process: {name: path}.
        self._resolved: dict[str, str] = {}
        #: Load-time validation findings: {"cause", "entry", "message"}.
        self.findings: list[dict] = []
        self._fault = os.environ.get(ENV_FAULT, "").strip() or None
        if self._fault not in (None, "torn"):
            raise ValueError(
                f"{ENV_FAULT}={self._fault!r}: expected 'torn' or unset")

    # -- counter views -------------------------------------------------- #
    @property
    def hits(self) -> int:
        return int(self._hits.value())

    @property
    def misses(self) -> int:
        return int(self._misses.value())

    @property
    def rewrites(self) -> int:
        return int(sum(s["value"]
                       for s in self._rewrites.snapshot()["series"]))

    @property
    def compile_seconds(self) -> float:
        return float(self._compile_s.value())

    def stats(self) -> dict:
        return {
            "root": self.root,
            "section": self.section,
            "hits": self.hits,
            "misses": self.misses,
            "rewrites": self.rewrites,
            "compile_seconds": round(self.compile_seconds, 3),
            "entries": len(self._resolved),
        }

    # ------------------------------------------------------------------ #
    def entry_key(self, name: str) -> str:
        return f"{name}-{_build.source_digest(name)[:16]}"

    def entry_dir(self, name: str) -> str:
        return os.path.join(self.section_dir, self.entry_key(name))

    def library_file(self, name: str) -> str:
        return _build.library_path(name, self.entry_dir(name))

    def _expected_meta(self, name: str) -> dict:
        return {
            "schema": BANK_SCHEMA,
            "environment": self.env,
            "source_sha256": _build.source_digest(name),
            "flags": list(_build.NVCC_FLAGS),
            "nvcc": _build.nvcc_version(),
        }

    def library(self, name: str) -> str:
        """The validated library path of ``csrc/<name>.cu``, built into
        the bank on a miss or a failed validation."""
        return self.libraries([name])[0]

    def libraries(self, names) -> list[str]:
        """``library`` for several sources; the ones to build are built
        together."""
        names = list(names)
        with self._lock:
            todo = [n for n in names if n not in self._resolved]
            if todo:
                key = ",".join(self.entry_key(n) for n in todo)
                with self.tracer.span("aot_resolve", family="library",
                                      key=key) as sp:
                    outcomes = self._resolve(todo)
                    sp["outcome"] = ",".join(outcomes[n] for n in todo)
            return [self._resolved[n] for n in names]

    def load(self, names=FACADE_LIBRARIES) -> dict:
        """Resolve ``names`` through the bank and load them into this
        process (``_build.load(name, path=)``)."""
        paths = self.libraries(names)
        return {n: _build.load(n, path=p) for n, p in zip(names, paths)}

    # ------------------------------------------------------------------ #
    def _resolve(self, names: list) -> dict:
        outcomes, build = {}, []
        for n in names:
            cause = self._validate(n)
            if cause is None:
                self._hits.inc()
                outcomes[n] = "hit"
                self._resolved[n] = self.library_file(n)
            else:
                if cause == "miss":
                    self._misses.inc()
                outcomes[n] = cause
                build.append(n)
        if build:
            self._build_entries(build)
        for n in names:
            self.recorder.record(
                "aot", family="library", key=self.entry_key(n),
                outcome=outcomes[n], job_id=self.tracer.current[1],
            )
        return outcomes

    def _validate(self, name: str) -> str | None:
        """None for a whole entry; else "miss" (absent) or the rewrite
        cause, counted and named."""
        entry = self.entry_dir(name)
        meta_path = os.path.join(entry, META_FILE)
        lib = self.library_file(name)
        if not os.path.exists(meta_path):
            return "miss"
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            if not isinstance(meta, dict):
                raise ValueError(f"META is a {type(meta).__name__}")
        except (OSError, ValueError) as e:
            return self._note_rewrite(name, "torn", f"META unreadable: {e}")
        want = self._expected_meta(name)
        drift = sorted(k for k, v in want.items() if meta.get(k) != v)
        if drift:
            return self._note_rewrite(
                name, "stale", f"META differs from today's in {drift}")
        if (not os.path.exists(lib)
                or sha256_file(lib) != meta.get("library_sha256")):
            return self._note_rewrite(
                name, "torn", "library bytes fail their sha256")
        try:
            self._loader(lib, meta.get("symbols") or [])
        except (OSError, AttributeError) as e:
            return self._note_rewrite(name, "unloadable", str(e)[:200])
        return None

    def _note_rewrite(self, name: str, cause: str, message: str) -> str:
        from ..utils.log import log_warn

        key = self.entry_key(name)
        self._rewrites.inc(cause=cause)
        self.findings.append({"cause": cause, "entry": key,
                              "message": message})
        self.recorder.record(
            "aot_rewrite", family="library", key=key, cause=cause,
            message=message, job_id=self.tracer.current[1],
        )
        log_warn(f"library bank: rewriting entry {key} ({cause}): {message}")
        return cause

    def _build_entries(self, names: list) -> None:
        """Build ``names`` into their entries (stale files removed
        first), then write each META last: an entry without META is
        absent."""
        dirs = [self.entry_dir(n) for n in names]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
            for f in os.listdir(d):
                os.remove(os.path.join(d, f))
        t0 = time.perf_counter()
        with self.tracer.span("aot_compile", family="library",
                              key=",".join(self.entry_key(n) for n in names)):
            libs = self._build_fn(names, dirs)
        dt = time.perf_counter() - t0
        self._compile_s.inc(dt)
        from ..utils.checkpoint import atomic_write_json

        for name, d, lib in zip(names, dirs, libs):
            log = lib[:-3] + ".log"
            log_text = open(log).read() if os.path.exists(log) else ""
            meta = dict(
                self._expected_meta(name),
                name=name,
                key=self.entry_key(name),
                library=os.path.basename(lib),
                library_sha256=sha256_file(lib),
                symbols=_build.bound_symbols(name),
                ptxas=ptxas_summary(log_text),
                build_seconds=round(dt, 3),
                built_together=list(names),
            )
            if self._fault == "torn":
                self._fault = None
                meta["library_sha256"] = hashlib.sha256(
                    meta["library_sha256"].encode()).hexdigest()
            atomic_write_json(os.path.join(d, META_FILE), meta)
            self._resolved[name] = lib

    def entries_on_disk(self) -> list[str]:
        """Committed entry keys in this environment's section."""
        if not os.path.isdir(self.section_dir):
            return []
        return sorted(
            d for d in os.listdir(self.section_dir)
            if os.path.exists(os.path.join(self.section_dir, d, META_FILE))
        )
