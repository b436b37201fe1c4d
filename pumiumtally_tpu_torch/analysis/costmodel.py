"""Kernel resource contracts (the runner's fourth layer).

The JAX package reads its programs' costs from XLA
(``pumiumtally_tpu/analysis/costmodel.py``). The port's compiled objects
are the nvcc-built libraries of ``csrc/`` and the eager torch code
around them, so this layer reads two things.

**ptxas's report of every instantiation.** Every build runs with
``-Xptxas=-v`` and keeps its log beside the library
(``ops/_build.py``). ``parse_ptxas`` reads one record per *entry*
function (keyed by its ``Compiling entry function`` line: a ``Function
properties for`` block may belong to a non-entry device function, such
as the math library's slow paths): registers, barriers, static shared
memory, stack frame and spill stores and loads. ``capture_ptxas``
parses every source's log with its environment (the nvcc release,
``sm_90a`` and a digest of ``NVCC_FLAGS``) and each source's digest
(``_build.source_digest``); ``sass_census`` counts each
instantiation's float64 instructions in ``cuobjdump -sass`` (on the
card, when the capture is written and in chip_smoke.py's phase 26; the
runner reads the logs alone). Baseline-free invariants
(``check_cost``):

  cost.spill.<inst>     no spill bytes, but the spills recorded as a
                        baselined finding (LINT_BASELINE_TORCH.json).
  cost.regfile.<inst>   registers x the threads the kernel is launched
                        at fit 65,536 registers; static shared memory
                        within 48 KB; the dynamic bytes within the card's
                        opt-in limit.
  cost.smem.<kernel>    a deliberately duplicated mirror of the walk's
                        ``batch_bytes`` / ``dynamic_bytes``
                        (``csrc/walk.cu``, ``Lane<T>`` of 48 and 80 B) and
                        of the bucket fold's fixed arrays and
                        ``bucket_smem`` (``csrc/scatter.cu``) and of the
                        exchange's count and place passes
                        (``place_smem``, ``csrc/exchange.cu``) agrees with
                        the static bytes ptxas reports for each
                        instantiation (0 where the launch passes them as
                        dynamic bytes); on the card also with the bytes
                        the launch passes, read through each source's
                        ``pumi_*_smem`` entry (``check_smem_entries``).
  cost.f64.<inst>       the float64 instructions (``D*`` ALU ops, any
                        opcode on F64) in the SASS of every instantiation
                        that is not a float64 one equal ``F64_EXPECTED``
                        (0 unless the design needs them, with its reason).
  cost.stale.<source>   the committed capture's source digest is not the
                        tree's: a PR that edits ``csrc/<source>.cu``
                        regenerates the capture on the card. Runs on the
                        CPU.

``diff_cost`` diffs a fresh capture against the committed
``PERF_CONTRACTS_TORCH.json`` exactly (ptxas is deterministic for one
nvcc and one set of flags), one ``cost.drift.<metric>.<inst>`` finding a
changed value, and refuses to compare across environments.

**The torch-op cost of the CPU families.** The program contracts'
census (``analysis/contracts.py``) counts, over the families' windows,
the torch calls, the bytes their fresh outputs hold and the peak of
those bytes alive, on the JAX ladder (``LADDER_N`` x ``LADDER_CELLS``):
``fit_exponent`` fits the scaling exponents, held to ``SCALING_MAX`` as
``cost.scaling.<axis>.<family>``, and ``cost.peak.<family>`` holds the
peak to ``allowance_bytes`` of ``family_analytic``. On the card,
``cost.peak.cuda`` holds ``torch.cuda.max_memory_allocated`` of the main
cell to the same allowance at that size.

``cost.bank.<source>`` (``check_bank``): a ``ProgramBank`` entry's
recorded ptxas summary equals the capture for its source digest.

The roofline coefficients of the autotuner (``NOMINAL_COEFFS``,
``predict_seconds``, ``calibrate_points``) live here as in the JAX
module; ``tuning/costmodel.py`` imports them.

The ptxas half imports no torch: ``python -m pumiumtally_tpu_torch.analysis
--no-contracts`` runs it without torch.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import re
import subprocess

from . import Finding

PERF_CONTRACTS_FILE = "PERF_CONTRACTS_TORCH.json"
SOURCES = ("walk", "scatter", "gather", "source", "exchange", "integrity")
ARCH = "sm_90a"

# The card's limits (an H100): the register file of an SM, the static
# shared memory a block may declare, the dynamic bytes it may opt into.
REGFILE = 65536
STATIC_SMEM_MAX = 48 * 1024
OPTIN_SMEM_MAX = 227 * 1024

# -- the mirror of the kernels' launch widths and shared memory --------- #
# Deliberately DUPLICATED from csrc/ (walk.cu SCHED_THREADS, Lane<T>,
# batch_bytes, dynamic_bytes; scatter.cu's launches, BUCKET_CAP, SMALL,
# bucket_smem; gather.cu and source.cu BLOCK; exchange.cu TILE,
# SCAN_THREADS, MAX_PARTS, place_smem; integrity.cu BLOCK): a kernel edit
# that changes them must change this mirror in the same PR, or cost.smem /
# cost.regfile name it.
_SCHED_THREADS = 256
_LANE_BYTES = {"f": 48, "d": 80}
_BUCKET_THREADS = 256
_BUCKET_CAP = 2048
_BUCKET_SHIFT_MAX = 10
_SMALL = 32
_ITEM = {"f": 4, "d": 8}
_EXCHANGE_TILE = 256
_EXCHANGE_SCAN = 1024
_EXCHANGE_MAX_PARTS = 1024

#: Threads a block of each kernel is launched with (the walk kernel's is
#: its BLOCK template value).
LAUNCH_THREADS = {
    "lane_count": _SCHED_THREADS, "lane_scan": _SCHED_THREADS,
    "lane_place": _SCHED_THREADS,
    "atomic_kernel": 256, "count_kernel": 256, "order_count": 256,
    "bucket_stats": 256, "add_sums": 256, "place_kernel": 256,
    "fold_small": 256, "bucket_place": 256, "bucket_fold": _BUCKET_THREADS,
    "scan_tiles": 1024, "scan_sums": 1024, "sort_fold_large": 1024,
    "gather_kernel": 256, "sample_flight_kernel": 256,
    "exchange_count": _EXCHANGE_TILE, "exchange_scan": _EXCHANGE_SCAN,
    "exchange_place": _EXCHANGE_TILE, "adopt_scan": _EXCHANGE_SCAN,
    "adopt_place": _EXCHANGE_TILE, "integrity_kernel": 256,
}


def walk_batch_bytes(t: str, block: int) -> int:
    """``batch_bytes<T>(block)``: two batches of 32 lanes a warp."""
    return _LANE_BYTES[t] * 2 * block


def walk_dynamic_bytes(t: str, block: int) -> int:
    """``dynamic_bytes<T>(block)``: the batches, when they pass the static
    limit (else 0)."""
    b = walk_batch_bytes(t, block)
    return b if b > STATIC_SMEM_MAX else 0


def bucket_smem(t: str, cap: int, shift: int) -> int:
    """``bucket_smem<T>(cap, shift)``: the bucket fold's dynamic bytes."""
    return cap * (8 + _ITEM[t] + 2 * 2) + (2 * (1 << shift) + 1) * 4


def bucket_static_bytes() -> int:
    """The bucket fold's fixed arrays (``nbig``, ``big``, the block scan's
    ``warp_sums``), laid out 16 B aligned."""
    raw = 4 * (1 + _BUCKET_CAP // (_SMALL + 1) + 32)
    return -(-raw // 16) * 16


def exchange_smem(n_parts: int) -> int:
    """``place_smem(n_parts)``: the exchange's place pass counts each
    warp's emigrants to each destination (its count pass passes
    ``(n_parts + 1)`` ints, fewer)."""
    return _EXCHANGE_TILE // 32 * n_parts * 4


def expected_smem(kernel: str, targs: str) -> tuple[int, int] | None:
    """(static bytes ptxas must report, the most dynamic bytes a launch
    passes) of an instantiation the mirror covers, or None."""
    if kernel == "exchange_count":
        return 0, (_EXCHANGE_MAX_PARTS + 1) * 4
    if kernel == "exchange_place":  # the warps' free counts, static
        return _EXCHANGE_TILE // 32 * 4, exchange_smem(_EXCHANGE_MAX_PARTS)
    if kernel == "walk_kernel":
        t, block = targs[0], _walk_block(targs)
        dyn = walk_dynamic_bytes(t, block)
        return (0 if dyn else walk_batch_bytes(t, block)), dyn
    if kernel == "bucket_fold":
        return bucket_static_bytes(), bucket_smem(
            targs[0], _BUCKET_CAP, _BUCKET_SHIFT_MAX)
    return None


def _walk_block(targs: str) -> int:
    return int(re.findall(r"Li(\d+)E", targs)[-1])


def launch_threads(kernel: str, targs: str) -> int | None:
    if kernel == "walk_kernel":
        return _walk_block(targs)
    return LAUNCH_THREADS.get(kernel)


# --------------------------------------------------------------------- #
# ptxas
# --------------------------------------------------------------------- #
_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:, used (\d+) barriers)?")
_SMEM = re.compile(r"(\d+) bytes smem")


def split_name(mangled: str) -> tuple[str, str]:
    """(kernel name, its mangled template arguments or "") of an entry
    function. The enclosing namespaces are left out (the anonymous one's
    name carries a per-file hash), so that an instantiation keeps its
    name across edits of its source."""
    nested = mangled.startswith("_ZN")
    s = mangled[3:] if nested else mangled.removeprefix("_Z")
    name = None
    while True:
        m = re.match(r"\d+", s)
        if not m:
            break
        k = int(m.group())
        name, s = s[m.end():m.end() + k], s[m.end() + k:]
        if not nested:
            break
    if name is None:
        return mangled, ""
    close = "EEv" if nested else "Ev"  # targs' E, the nested name's E, void
    if s.startswith("I") and close in s:
        return name, s[1:s.index(close)]
    return name, ""


def instantiation(mangled: str) -> str:
    """``walk_kernel<fLb1ELb0ELb1ELb0ELi0ELi128E>``, or the bare kernel
    name of a function that is not a template."""
    name, targs = split_name(mangled)
    return f"{name}<{targs}>" if targs else name


def parse_ptxas(log_text: str) -> dict:
    """{instantiation: record} of every entry function in an
    ``-Xptxas=-v`` report: ``registers``, ``barriers``, ``smem`` (static
    bytes), ``stack`` (frame bytes), ``spill_stores``, ``spill_loads``
    and ``mangled``. The ``Used`` line belongs to the entry being
    compiled; the frame line to the function its ``Function properties
    for`` header names, and is kept only when that is the entry (a
    non-entry function's block is skipped)."""
    out: dict = {}
    cur = props = None
    for line in log_text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = m.group(1)
            props = None
            out[instantiation(cur)] = dict(
                mangled=cur, registers=0, barriers=0, smem=0, stack=0,
                spill_stores=0, spill_loads=0)
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1) if m.group(1) == cur else None
            continue
        rec = out.get(instantiation(cur)) if cur else None
        m = _FRAME.search(line)
        if m:
            if rec is not None and props == cur:
                rec.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            continue
        m = _USED.search(line)
        if m and rec is not None:
            rec["registers"] = int(m.group(1))
            rec["barriers"] = int(m.group(2) or 0)
            s = _SMEM.search(line)
            rec["smem"] = int(s.group(1)) if s else 0
    return out


def ptxas_lines(rec: dict) -> list[str]:
    """One record as ptxas's two report lines (its wording)."""
    used = (f"Used {rec['registers']} registers, used {rec['barriers']} "
            "barriers")
    return [f"{rec['stack']} bytes stack frame, {rec['spill_stores']} bytes "
            f"spill stores, {rec['spill_loads']} bytes spill loads",
            used + (f", {rec['smem']} bytes smem" if rec["smem"] else "")]


def summary(records: dict) -> dict:
    """The records without their mangled names (what a bank entry and
    the capture store)."""
    return {k: {f: v for f, v in r.items() if f != "mangled"}
            for k, r in sorted(records.items())}


def flags_digest() -> str:
    from ..ops import _build

    flags = " ".join(_build.NVCC_FLAGS).encode()
    return hashlib.sha256(flags).hexdigest()[:16]


def ptxas_environment(nvcc: str | None = None) -> dict:
    from ..ops import _build

    return {"nvcc": nvcc or _build.nvcc_version(), "arch": ARCH,
            "flags": flags_digest()}


def find_logs(ptxas_dir: str | None = None) -> dict:
    """{source: (log path, library path or None)} of the tree's current
    builds: in ``ptxas_dir`` (its ``lib<name>-<hash>.log`` files, by the
    tree's digests), else beside the package's own libraries. Sources
    without a log are left out."""
    from ..ops import _build

    out = {}
    for name in SOURCES:
        lib = _build.library_path(name, ptxas_dir)
        log = lib[:-3] + ".log"
        if os.path.exists(log):
            out[name] = (log, lib if os.path.exists(lib) else None)
    return out


def cuobjdump() -> str | None:
    from ..ops import _build

    try:
        tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    except RuntimeError:
        return None
    return tool if os.access(tool, os.X_OK) else None


_F64_OP = re.compile(r"^D(ADD|MUL|FMA|MNMX|SETP|SET|RCP|RSQ)\b|F64")


def sass_f64(text: str) -> dict:
    """{instantiation: float64 instructions} of every function in the
    text of ``cuobjdump -sass``: ``D*`` ALU opcodes and every opcode on
    F64 (conversions, reductions)."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = instantiation(m.group(1))
            out[cur] = 0
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                      line)
        if m and cur and _F64_OP.search(m.group(1)):
            out[cur] += 1
    return out


def sass_census(logs: dict) -> dict:
    """{source: sass_f64} of the libraries beside ``logs``
    (``find_logs``), one ``cuobjdump -sass`` each, all running together;
    {} without cuobjdump."""
    from concurrent.futures import ThreadPoolExecutor

    tool = cuobjdump()
    libs = {name: lib for name, (_, lib) in logs.items() if lib}
    if tool is None or not libs:
        return {}

    def dump(lib):
        return subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, check=True).stdout

    with ThreadPoolExecutor(len(libs)) as pool:
        texts = dict(zip(libs, pool.map(dump, libs.values())))
    return {name: sass_f64(text) for name, text in sorted(texts.items())}


def capture_ptxas(logs: dict, *, f64: dict | None = None,
                  nvcc: str | None = None) -> dict:
    """The ptxas section of PERF_CONTRACTS_TORCH.json from ``logs``
    (``find_logs``): per source its digest and instantiations, each with
    its float64 SASS instructions where ``f64`` (``sass_census``) has
    them."""
    from ..ops import _build

    sources = {}
    for name, (log, _) in sorted(logs.items()):
        with open(log) as f:
            recs = summary(parse_ptxas(f.read()))
        for inst, n in (f64 or {}).get(name, {}).items():
            if inst in recs:
                recs[inst]["f64"] = n
        sources[name] = {"digest": _build.source_digest(name),
                         "instantiations": recs}
    return {"environment": ptxas_environment(nvcc), "sources": sources}


# The float64 instructions the design needs in an instantiation that is
# not a float64 one, with the reason.
F64_EXPECTED = {
    "sample_flight_kernel<f>": (
        6, "sinf/cosf's large-argument reduction in CUDA's math library "
           "(two int64 -> float64 conversions, multiplies by 2pi/2^62 and "
           "conversions back); taken only for |phi| >= 105615, never for "
           "phi = 2pi u"),
}


def _finding(symbol: str, message: str) -> Finding:
    return Finding(rule="COST", path=PERF_CONTRACTS_FILE, line=0,
                   symbol=symbol, message=message)


def check_cost(cap: dict, optin: int = OPTIN_SMEM_MAX) -> list[Finding]:
    """The baseline-free invariants of a ptxas capture (module
    docstring); ``optin`` is the card's opt-in shared memory per block."""
    out: list[Finding] = []
    smem_bad: dict = {}
    for src, entry in sorted(cap.get("sources", {}).items()):
        for inst, r in sorted(entry["instantiations"].items()):
            kernel = inst.split("<", 1)[0]
            targs = inst[len(kernel) + 1:-1] if "<" in inst else ""
            if r["spill_stores"] or r["spill_loads"]:
                out.append(_finding(
                    f"cost.spill.{inst}",
                    f"csrc/{src}.cu {inst}: {r['spill_stores']} bytes spill "
                    f"stores, {r['spill_loads']} bytes spill loads "
                    f"({r['stack']} bytes stack frame)"))
            threads = launch_threads(kernel, targs)
            mirror = expected_smem(kernel, targs)
            dyn = mirror[1] if mirror else 0
            bad = []
            if threads is None:
                bad.append("no launch width in the mirror "
                           "(LAUNCH_THREADS)")
            elif r["registers"] * threads > REGFILE:
                bad.append(f"{r['registers']} registers x {threads} "
                           f"threads > {REGFILE}")
            if r["smem"] > STATIC_SMEM_MAX:
                bad.append(f"{r['smem']} B static shared memory > "
                           f"{STATIC_SMEM_MAX}")
            if dyn > optin:
                bad.append(f"{dyn} B dynamic shared memory > the opt-in "
                           f"{optin}")
            if bad:
                out.append(_finding(f"cost.regfile.{inst}",
                                    f"csrc/{src}.cu {inst}: "
                                    + "; ".join(bad)))
            if mirror and r["smem"] != mirror[0]:
                smem_bad.setdefault(kernel, []).append(
                    f"{inst} ptxas {r['smem']} B, mirror {mirror[0]} B")
            if "f64" in r and not targs.startswith("d"):
                want = F64_EXPECTED.get(inst, (0, ""))[0]
                if r["f64"] != want:
                    out.append(_finding(
                        f"cost.f64.{inst}",
                        f"csrc/{src}.cu {inst}: {r['f64']} float64 SASS "
                        f"instruction(s), expected {want} — float64 on "
                        "the path of a float32 kernel"))
    for kernel, lines in sorted(smem_bad.items()):
        out.append(_finding(
            f"cost.smem.{kernel}",
            "static shared memory differs from the mirror of csrc/: "
            + "; ".join(lines)))
    return out


def check_stale(cap: dict) -> list[Finding]:
    """``cost.stale.<source>``: the committed capture's digest against the
    tree's ``csrc/<source>.cu`` (and flags), on any box."""
    from ..ops import _build

    out = []
    have = cap.get("sources", {})
    for name in SOURCES:
        entry = have.get(name)
        cur = _build.source_digest(name)
        if entry is None or entry.get("digest") != cur:
            out.append(_finding(
                f"cost.stale.{name}",
                f"{PERF_CONTRACTS_FILE} holds csrc/{name}.cu at digest "
                f"{(entry or {}).get('digest', 'none')[:16]}, the tree's is "
                f"{cur[:16]}: rebuild on the card and regenerate it "
                "(--write-perf-contracts)"))
    return out


def diff_cost(current: dict, baseline: dict) -> list[Finding]:
    """A fresh ptxas capture against the committed one: exact, one
    finding a changed value; no comparison across environments."""
    out: list[Finding] = []
    if current["environment"] != baseline.get("environment"):
        return [_finding(
            "cost.environment.all",
            f"capture environment {current['environment']} != baseline "
            f"{baseline.get('environment')} — ptxas's counts are pinned "
            "for one nvcc, one architecture and one set of flags")]
    cur, base = current["sources"], baseline.get("sources", {})
    for src in sorted(set(cur) & set(base)):
        ci, bi = cur[src]["instantiations"], base[src]["instantiations"]
        for inst in sorted(set(ci) | set(bi)):
            if inst not in bi:
                out.append(_finding(
                    f"cost.instantiation.added.{inst}",
                    f"csrc/{src}.cu {inst} is built but absent from "
                    f"{PERF_CONTRACTS_FILE}"))
                continue
            if inst not in ci:
                out.append(_finding(
                    f"cost.instantiation.removed.{inst}",
                    f"csrc/{src}.cu {inst} is in {PERF_CONTRACTS_FILE} but "
                    "no longer built"))
                continue
            for metric in sorted(set(ci[inst]) & set(bi[inst])):
                old, new = bi[inst][metric], ci[inst][metric]
                if old != new:
                    out.append(_finding(
                        f"cost.drift.{metric}.{inst}",
                        f"csrc/{src}.cu {inst}: {metric} {old} -> {new}"))
    return out


def check_bank(metas: list, cap: dict) -> list[Finding]:
    """``cost.bank.<source>``: each bank entry's META (``ptxas`` and
    ``source_sha256``) against the capture, where the capture holds its
    source at that digest."""
    out = []
    for meta in metas:
        name = meta.get("name")
        entry = cap.get("sources", {}).get(name)
        if entry is None or entry.get("digest") != meta.get(
                "source_sha256"):
            continue
        want = {k: {f: v for f, v in r.items() if f != "f64"}
                for k, r in entry["instantiations"].items()}
        if meta.get("ptxas") != want:
            out.append(_finding(
                f"cost.bank.{name}",
                f"the bank entry {meta.get('key')} records ptxas counts "
                f"other than {PERF_CONTRACTS_FILE}'s for csrc/{name}.cu"))
    return out


def entry_smem(source: str, t: str, *args) -> int:
    """The dynamic shared memory bytes a launch of ``csrc/<source>.cu``
    passes, through its C entry (on the card): the walk at a block width,
    the bucket fold at a cap and shift, the exchange at a part count,
    the gather, the flight and the integrity vector."""
    import torch

    from ..ops import (
        exchange_cuda,
        gather,
        integrity_cuda,
        scatter,
        source_cuda,
        walk_cuda,
    )

    dt = {"f": torch.float32, "d": torch.float64}[t]
    if source == "walk":
        return walk_cuda.dynamic_smem(dt, *args)
    if source == "scatter":
        return scatter.bucket_dynamic_smem(dt, *args)
    if source == "exchange":
        return exchange_cuda.dynamic_smem(*args)
    return {"gather": gather, "source": source_cuda,
            "integrity": integrity_cuda}[source].dynamic_smem()


def check_smem_entries() -> list[Finding]:
    """``cost.smem`` on the card: the dynamic bytes a launch passes, read
    through each source's C entry (``entry_smem``), against the mirror at
    every walk width and at the bucket fold's extremes."""
    dynamic = entry_smem
    out = []
    for t in ("f", "d"):
        for block in (64, 128, 256, 512):
            got = dynamic("walk", t, block)
            if got != walk_dynamic_bytes(t, block):
                out.append(_finding(
                    "cost.smem.walk_kernel",
                    f"pumi_walk_smem_{t}: {got} B at block {block}, the "
                    f"mirror {walk_dynamic_bytes(t, block)} B"))
        for cap, shift in ((1, 0), (_BUCKET_CAP, _BUCKET_SHIFT_MAX),
                           (1000, 6)):
            got = dynamic("scatter", t, cap, shift)
            if got != bucket_smem(t, cap, shift):
                out.append(_finding(
                    "cost.smem.bucket_fold",
                    f"pumi_scatter_smem_{t}({cap}, {shift}) = {got} B, the "
                    f"mirror {bucket_smem(t, cap, shift)} B"))
    for parts in (1, 4, 64, _EXCHANGE_MAX_PARTS):
        got = dynamic("exchange", "f", parts)
        if got != exchange_smem(parts):
            out.append(_finding(
                "cost.smem.exchange_place",
                f"pumi_exchange_smem({parts}) = {got} B, the mirror "
                f"{exchange_smem(parts)} B"))
    for src in ("gather", "source", "integrity"):
        if dynamic(src, "f") != 0:
            out.append(_finding(f"cost.smem.{src}",
                                f"csrc/{src}.cu passes dynamic shared "
                                "memory; the mirror has none"))
    return out


# --------------------------------------------------------------------- #
# The torch-op cost of the CPU families
# --------------------------------------------------------------------- #
LADDER_N = (16, 64, 256)
LADDER_CELLS = (2, 3, 4)  # box(c) -> ntet = 6 * c**3
SCALING_MAX = {"n_particles": 1.35, "ntet": 1.35}
SCALING_METRICS = ("ops", "bytes_written", "peak_live_bytes")
# Relative drift bands of the committed families' metrics: the census is
# deterministic on one tree, the bands absorb the plain walk's iteration
# count moving with a rounding change.
DRIFT_TOL = {"ops": 0.02, "bytes_written": 0.05, "peak_live_bytes": 0.10}
SCALING_TOL = 0.10

# The allowance's terms: fixed slack (the allocator's and the host
# staging's small buffers), a lane's state (positions, destination,
# direction, the four faces' planes and distances, neighbor and class
# codes, counters, the schedule's 64 B record), a tally record (the
# walk's bin, order and contribution, and the bucket path's 16 B packed
# record), an exchange row of the partitioned step.
SLACK_BYTES = 64 * 1024
LANE_BYTES = 128
RECORD_BYTES = 32
EXCHANGE_ROW = 64


def family_analytic(family, *, n, ntet, n_groups, itemsize, table_bytes,
                    records, n_parts=1, max_local=None) -> dict:
    """The memory a family's window may hold: its flux, its lanes (the
    partitioned step's ``n_parts · n`` slots), its tally records, the
    mesh's tables and the partitioned exchange's send and receive rows."""
    if family == "partitioned":
        if max_local is None:
            raise ValueError("the partitioned analytic needs max_local "
                             "(owned + halo rows a part)")
        flux = n_parts * max_local * n_groups * 2 * itemsize
        slots = n_parts * n
        exchange = 2 * n_parts * max(slots // (2 * n_parts), 64) * (
            EXCHANGE_ROW)
    else:
        flux = ntet * n_groups * 2 * itemsize
        slots, exchange = n, 0
    return dict(family=family, n=n, ntet=ntet, n_groups=n_groups,
                itemsize=itemsize, flux_bytes=flux,
                lane_bytes=slots * LANE_BYTES, table_bytes=table_bytes,
                record_bytes=records * RECORD_BYTES,
                exchange_bytes=exchange)


def allowance_bytes(a: dict) -> int:
    """The ceiling on a window's peak: a few copies of the flux and the
    lane state (the step's inputs, outputs and staging), the tables and
    the records twice (a walk's buffers and the scatter's), the
    exchange's buffers four times, and the fixed slack."""
    return (SLACK_BYTES + 4 * (a["flux_bytes"] + a["lane_bytes"])
            + 2 * (a["table_bytes"] + a["record_bytes"])
            + 4 * a["exchange_bytes"])


def mesh_bytes(mesh) -> int:
    """Bytes of the mesh's tensors (its tables on the device)."""
    import torch

    return sum(v.numel() * v.element_size() for v in vars(mesh).values()
               if isinstance(v, torch.Tensor))


def fit_exponent(sizes, values) -> float:
    """Least-squares slope of log(value) against log(size)."""
    if len(sizes) != len(values) or len(sizes) < 2:
        raise ValueError("need >= 2 ladder rungs to fit an exponent")
    if min(values) <= 0 or min(sizes) <= 0:
        raise ValueError("exponent fit needs positive sizes and values")
    ls = [math.log(s) for s in sizes]
    lv = [math.log(v) for v in values]
    k = len(ls)
    sx, sy = sum(ls), sum(lv)
    sxx = sum(a * a for a in ls)
    sxy = sum(a * b for a, b in zip(ls, lv))
    return (k * sxy - sx * sy) / (k * sxx - sx * sx)


def rung(family, n, cells, frames=None, run=None) -> dict:
    """One family's window at one rung: its cost and the analytic memory
    it is held to."""
    from . import contracts as C

    run = run or C.run_family
    _, cost, t = run(family, n=n, cells=cells, frames=frames)
    segs = int(t.total_segments) if hasattr(t, "total_segments") else 0
    mesh = t.mesh
    part = getattr(t, "partition", None)
    a = family_analytic(
        family, n=n, ntet=6 * cells ** 3, n_groups=C._G,
        itemsize=4, table_bytes=mesh_bytes(mesh) + (
            mesh_bytes(part) if part is not None else 0),
        records=max(segs, 4 * n),
        n_parts=C._N_PARTS if part is not None else 1,
        max_local=part.max_local if part is not None else None)
    return {"metrics": cost, "analytic": a}


def capture_families(families=None, run=None) -> dict:
    """The families' section of PERF_CONTRACTS_TORCH.json: each family's
    base rung (the contracts' problem), its top ``n`` rung and its
    scaling exponents over the ladder."""
    from . import contracts as C

    assert LADDER_N[0] == C._N and LADDER_CELLS[0] == C._CELLS
    frames = C._Frames()
    out = {}
    for fam in sorted(families or C.FAMILIES):
        n_axis = [rung(fam, n, LADDER_CELLS[0], frames, run)
                  for n in LADDER_N]
        t_axis = [n_axis[0]] + [rung(fam, LADDER_N[0], c, frames, run)
                                for c in LADDER_CELLS[1:]]
        scaling = {}
        for axis, sizes, rungs in (
                ("n_particles", LADDER_N, n_axis),
                ("ntet", [6 * c ** 3 for c in LADDER_CELLS], t_axis)):
            scaling[axis] = {
                m: round(fit_exponent(list(sizes), [
                    r["metrics"][m] for r in rungs]), 3) + 0.0
                for m in SCALING_METRICS
                if min(r["metrics"][m] for r in rungs) > 0}
        out[fam] = {"base": n_axis[0], "top": n_axis[-1],
                    "scaling": scaling}
    return {"environment": C.environment(),
            "ladder": {"n_particles": list(LADDER_N),
                       "ntet": [6 * c ** 3 for c in LADDER_CELLS]},
            "families": out}


def check_families(cap: dict) -> list[Finding]:
    """``cost.peak.<family>`` at the base and top rungs, and
    ``cost.scaling.<axis>.<family>``."""
    out = []
    for fam, entry in sorted(cap.get("families", {}).items()):
        for rung_name in ("base", "top"):
            r = entry.get(rung_name)
            if r is None:
                continue
            peak, allow = (r["metrics"]["peak_live_bytes"],
                           allowance_bytes(r["analytic"]))
            if peak > allow:
                out.append(_finding(
                    f"cost.peak.{fam}",
                    f"peak live bytes {peak} > the analytic allowance "
                    f"{allow} at the {rung_name} rung (n={r['analytic']['n']}"
                    ") — an intermediate outgrew the flux, lane, record and "
                    "table envelope"))
                break
        for axis, exps in sorted(entry.get("scaling", {}).items()):
            bad = {k: v for k, v in sorted(exps.items())
                   if v > SCALING_MAX[axis]}
            if bad:
                out.append(_finding(
                    f"cost.scaling.{axis}.{fam}",
                    f"superlinear growth in {axis}: "
                    + ", ".join(f"{k}~O(size^{v})" for k, v in bad.items())
                    + f" exceeds {SCALING_MAX[axis]} — an accidental "
                    "quadratic broadcast scales with the ladder"))
    return out


def diff_families(current: dict, baseline: dict) -> list[Finding]:
    """The families' section against the committed one, within
    ``DRIFT_TOL`` and ``SCALING_TOL``."""
    if current["environment"] != baseline.get("environment") or current[
            "ladder"] != baseline.get("ladder"):
        return [_finding(
            "cost.environment.families",
            "the families' environment or ladder changed — regenerate "
            f"{PERF_CONTRACTS_FILE}")]
    out = []
    cur, base = current["families"], baseline.get("families", {})
    for fam in sorted(set(cur) | set(base)):
        if fam not in cur or fam not in base:
            out.append(_finding(f"cost.family.{fam}",
                                f"family {fam} captured on one side only"))
            continue
        for rung_name in ("base", "top"):
            cm, bm = cur[fam][rung_name]["metrics"], base[fam][rung_name][
                "metrics"]
            tag = "" if rung_name == "base" else "top."
            for metric, tol in sorted(DRIFT_TOL.items()):
                old, new = bm.get(metric, 0), cm.get(metric, 0)
                if abs(new - old) > tol * max(abs(old), abs(new), 1):
                    out.append(_finding(
                        f"cost.drift.{tag}{metric}.{fam}",
                        f"{metric} {old} -> {new} at the {rung_name} rung, "
                        f"outside the ±{tol:.0%} band"))
        cs, bs = cur[fam].get("scaling", {}), base[fam].get("scaling", {})
        for axis in sorted(set(cs) | set(bs)):
            for metric in sorted(set(cs.get(axis, {})) | set(
                    bs.get(axis, {}))):
                old = bs.get(axis, {}).get(metric, 0.0)
                new = cs.get(axis, {}).get(metric, 0.0)
                if abs(new - old) > SCALING_TOL:
                    out.append(_finding(
                        f"cost.drift.scaling.{axis}.{metric}.{fam}",
                        f"{axis} exponent of {metric} {old} -> {new}"))
    return out


def check_peak_cuda(peak: int, analytic: dict) -> list[Finding]:
    """``cost.peak.cuda``: the card's ``max_memory_allocated`` of a run
    against ``allowance_bytes`` of its analytic."""
    allow = allowance_bytes(analytic)
    if peak <= allow:
        return []
    return [_finding("cost.peak.cuda",
                     f"max_memory_allocated {peak} B > the analytic "
                     f"allowance {allow} B at n={analytic['n']}, "
                     f"ntet={analytic['ntet']}")]


# --------------------------------------------------------------------- #
# The committed capture
# --------------------------------------------------------------------- #
def load_perf_contracts(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def write_perf_contracts(path, cap: dict) -> dict:
    from ..utils.checkpoint import atomic_write_json

    # Committed state every later run diffs against: atomic (PUMI008).
    atomic_write_json(path, cap)
    return cap


# --------------------------------------------------------------------- #
# The autotuner's roofline (the JAX module's hardware calibration)
# --------------------------------------------------------------------- #
# Nominal coefficients of the tuner's rehearsal ranking: they only order
# candidates against each other and are not a measurement of any card.
NOMINAL_COEFFS = {
    "flops_per_s": 2.0e11,   # effective throughput
    "bytes_per_s": 5.0e10,   # effective memory rate
    "dispatch_s": 5.0e-5,    # per launch
}


def predict_seconds(metrics: dict, coeffs: dict, *,
                    dispatches: float = 0.0) -> float:
    """Roofline-style seconds of one program from its ``flops`` and
    ``bytes_accessed``: compute time + memory time + ``dispatches``
    launches. A coefficient ``calibrate_points`` could not fit (None)
    contributes no term."""
    t = dispatches * (coeffs.get("dispatch_s") or 0.0)
    f = coeffs.get("flops_per_s")
    if f:
        t += metrics["flops"] / f
    b = coeffs.get("bytes_per_s")
    if b:
        t += metrics["bytes_accessed"] / b
    return t


def calibrate_points(points: list[dict]) -> dict | None:
    """Fit effective throughput and memory rate from measured
    ``(flops, bytes_accessed, seconds)`` points of one shape class:
    ``t ≈ flops·x + bytes·y`` by 2×2 least squares. A degenerate or
    unphysical fit (singular system, a coefficient <= 0, as when every
    candidate has the same counts) falls back to the single-term fit that
    explains the timings best, the other coefficient None. None with no
    points."""
    pts = [
        (float(p["flops"]), float(p["bytes_accessed"]),
         float(p["seconds"]))
        for p in points
        if p.get("seconds") and p["seconds"] > 0
    ]
    if not pts:
        return None

    def _one_term(idx):
        # t ≈ v·x, so x = Σ v·t / Σ v² (least squares through 0)
        num = sum(p[idx] * p[2] for p in pts)
        den = sum(p[idx] * p[idx] for p in pts)
        return (num / den) if den > 0 and num > 0 else None

    def _rmse(x, y):
        err = [
            (f * (x or 0.0) + b * (y or 0.0) - t) ** 2
            for f, b, t in pts
        ]
        return math.sqrt(sum(err) / len(err))

    x = y = None
    if len(pts) >= 2:
        sff = sum(f * f for f, _, _ in pts)
        sbb = sum(b * b for _, b, _ in pts)
        sfb = sum(f * b for f, b, _ in pts)
        sft = sum(f * t for f, _, t in pts)
        sbt = sum(b * t for _, b, t in pts)
        det = sff * sbb - sfb * sfb
        if det > 0 and abs(det) > 1e-12 * max(sff * sbb, 1.0):
            x = (sft * sbb - sbt * sfb) / det
            y = (sbt * sff - sft * sfb) / det
    if x is None or y is None or x <= 0 or y <= 0:
        xf, yb = _one_term(0), _one_term(1)
        cand = []
        if xf is not None:
            cand.append((xf, None))
        if yb is not None:
            cand.append((None, yb))
        if not cand:
            return None
        x, y = min(cand, key=lambda c: _rmse(*c))
    return {
        "flops_per_s": (1.0 / x) if x else None,
        "bytes_per_s": (1.0 / y) if y else None,
        "rmse_s": _rmse(x, y),
        "points": len(pts),
        "model": "seconds = flops/flops_per_s + bytes/bytes_per_s",
    }
