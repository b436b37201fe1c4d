"""Effect-ordering protocol analyzer (the port's second lint layer).

The crash-safety surface is a set of ORDERING promises: the two-phase
sharded checkpoint commits its manifest LAST; the scheduler journals a
job's terminal record BEFORE deleting its checkpoint; a signal flush
uninstalls its own handlers BEFORE chaining the previous one.  Each of
these was caught (or nearly missed) in review as a hand-verified
property of one function body — the exact kind of invariant a refactor
silently reorders.  This module makes them machine-checked:

  * **Effect points** are recognized by CALLEE on the AST — e.g. a
    call whose head is ``_flush_journal`` / ``*.journal.flush`` is the
    effect ``journal.flush``; ``atomic_write_bytes(manifest_path,…)``
    is ``manifest.commit``; ``os.remove``/``shutil.rmtree`` on a
    checkpoint path is ``checkpoint.delete``.  A call handed a nested
    worker def (the executor pattern ``ex.map(_write, …)``) carries
    the worker's effects at the call site.
  * **Protocols** (the declarations below) bind happens-before
    constraints to the functions that OWN them —
    ``TallyScheduler._finish``/``._poison``/``._quantum``/``._preempt``
    /``._signal_flush``, ``SchedulerJournal.flush``/``write_flux``,
    ``save_sharded_checkpoint``, ``CheckpointStore.save``/``._rotate``,
    ``ResilientRunner._on_signal``, ``FleetRouter.submit``/``._place``
    (the fleet's idempotency-record-before-accept and
    assignment-record-before-dispatch) — and are verified along ALL paths
    of the function's CFG (if/else branches, loops at 0/1 iterations,
    try bodies and handlers; a path that ends in return/raise stops).
  * Constraint kinds: ``before`` (on any path containing the *after*
    effect, the *before* effect precedes it — with ``required`` the
    *after* effect may never appear unpreceded), ``require`` (the
    effect must exist in the function at all), ``forbid`` (it must
    not — e.g. no raw write inside the journal's atomic flush).

The committed capture (``PROTOCOLS_TORCH.json``) pins the discovered
effect inventory per protocol: drift in what a crash-safety function
DOES is a named finding until the baseline is intentionally regenerated
with ``python -m pumiumtally_tpu_torch.analysis --write-protocols``, and
a capture from another environment (another package, or another Python
minor version, whose ``ast`` differs) is refused outright.

The port's one departure from the JAX declarations: the scheduler's
``_preempt`` skips the save when the job's quantum checkpoint is
already on disk at the same boundary (a fleet migration reuses it). The
check is one helper, ``_checkpoint_current``, recognized as the effect
``checkpoint.current``; ``preempt-checkpoint-before-journal-flush``
accepts it in place of a save before the flush (the constraint's
``"also"``) and requires the save to stay in the function.

Findings carry ``rule="PROTO"`` and route to this layer's
LINT_BASELINE_TORCH.json entries by that prefix.  CFG approximations (loops
bounded at one iteration, exceptions modeled at statement granularity)
are deliberately conservative for the straight-line, small functions
that own these protocols.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import textwrap

from . import Finding
from .astlint import (
    PACKAGE,
    PackageIndex,
    _dotted,
    _parse,
    _scope_file_bindings,
    collect_sources,
    raw_write_head,
)

PROTOCOLS_FILE = "PROTOCOLS_TORCH.json"
PROTOCOLS_SCHEMA = 1

#: Cap on enumerated CFG paths per function — the owning functions are
#: small; hitting the cap means the CFG grew beyond what hand-audits
#: ever covered, which is itself worth a finding.
MAX_PATHS = 512


def _finding(symbol: str, message: str, path: str = PROTOCOLS_FILE,
             line: int = 0) -> Finding:
    return Finding(
        rule="PROTO", path=path, line=line, symbol=symbol,
        message=message,
    )


# --------------------------------------------------------------------- #
# Effect recognition
# --------------------------------------------------------------------- #
#: last call-chain component → effect name (context-free heads).
_SIMPLE_EFFECTS = {
    "_flush_journal": "journal.flush",
    "write_flux": "flux.persist",
    "_remove_checkpoint": "checkpoint.delete",
    "remove_sidefiles": "checkpoint.delete",
    "save_checkpoint": "checkpoint.save",
    "_journal_checkpoint": "checkpoint.save",
    "save_sharded_checkpoint": "checkpoint.save",
    "_write_checkpoint": "checkpoint.save",
    "checkpoint": "checkpoint.save",
    # The port's scheduler: the check that a job's checkpoint on disk
    # is already this boundary's (the preemption's skipped save).
    "_checkpoint_current": "checkpoint.current",
    "install_preemption_handlers": "handler.install",
    "_install_signal_handlers": "handler.install",
    "uninstall_preemption_handlers": "handler.uninstall",
    "_uninstall_signal_handlers": "handler.uninstall",
    "resume_previous_handler": "handler.resume",
    "_rotate": "generation.rotate",
    "fsync_dir": "dir.fsync",
    "atomic_savez": "atomic.write",
    "atomic_write_json": "atomic.write",
    # Fleet routing (serving/fleet.py): the FLEET.json flush and the
    # two router actions its write-ahead orderings fence.
    "_flush_fleet": "fleet.record",
    "_place": "job.place",
    "_dispatch_job": "job.dispatch",
    # Supervisor eviction (serving/supervisor.py): the FLEET.json
    # eviction record and the two drain flavors it must precede.
    "record_eviction": "eviction.record",
    "drain_member": "member.drain",
    "drain_member_from_journal": "member.drain",
    # SLO advisory (obs/slo.py → serving/supervisor.py): the
    # FLEET.json breach record and the quarantine it must precede.
    "record_breach": "breach.record",
    "_quarantine": "member.quarantine",
}

#: fully-dotted deletion heads (``remove`` alone would match
#: ``list.remove``).
_DELETE_HEADS = frozenset({"os.remove", "os.unlink", "shutil.rmtree"})


def _arg_text(call: ast.Call, i: int) -> str:
    if len(call.args) <= i:
        return ""
    try:
        return ast.unparse(call.args[i]).lower()
    except Exception:
        return ""


def classify_call(call: ast.Call, opened: set[str],
                  buffers: set[str]) -> str | None:
    """The effect one call performs, or None.  ``opened``/``buffers``
    are the scope's file bindings for the raw-write classifier."""
    d = _dotted(call.func)
    if d is None:
        return None
    last = d.split(".")[-1]
    if d.endswith("journal.flush"):
        return "journal.flush"
    if d.endswith("store.save"):
        return "checkpoint.save"
    if last in ("atomic_write_bytes", "_atomic_write_bytes"):
        if "manifest" in _arg_text(call, 0):
            return "manifest.commit"
        return "atomic.write"
    if d in _DELETE_HEADS:
        a = _arg_text(call, 0)
        if "manifest" in a:
            return "manifest.uncommit"
        if "checkpoint" in a or "ckpt" in a:
            return "checkpoint.delete"
        return "generation.delete"
    if last in _SIMPLE_EFFECTS:
        return _SIMPLE_EFFECTS[last]
    if raw_write_head(call, opened, buffers) is not None:
        return "raw.write"
    return None


# --------------------------------------------------------------------- #
# Protocol declarations
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Protocol:
    """One declared happens-before protocol, owned by one function."""

    name: str
    path: str
    function: str  # qualname within the module
    constraints: tuple[dict, ...]
    #: local effect label → base effect name (so ``terminal.record``
    #: can name the journal flush of a terminal-outcome function).
    aliases: tuple[tuple[str, str], ...] = ()
    rationale: str = ""


PROTOCOLS: tuple[Protocol, ...] = (
    Protocol(
        name="terminal-record-before-checkpoint-delete",
        path=f"{PACKAGE}/serving/scheduler.py",
        function="TallyScheduler._finish",
        aliases=(("terminal.record", "journal.flush"),),
        constraints=(
            {"kind": "require", "effect": "terminal.record"},
            {"kind": "before", "before": "terminal.record",
             "after": "checkpoint.delete", "required": True},
            {"kind": "before", "before": "flux.persist",
             "after": "terminal.record", "required": False},
        ),
        rationale=(
            "A finished job's terminal record (flux name included) "
            "must be journaled BEFORE its checkpoint side-files are "
            "deleted: a crash between the two may cost a redundant "
            "file, never the finished work.  Reversed, the crash "
            "window re-runs (or loses) a completed job — the exact "
            "bug a review of the reference caught by hand."
        ),
    ),
    Protocol(
        name="poison-record-before-checkpoint-delete",
        path=f"{PACKAGE}/serving/scheduler.py",
        function="TallyScheduler._poison",
        aliases=(("terminal.record", "journal.flush"),),
        constraints=(
            {"kind": "require", "effect": "terminal.record"},
            {"kind": "before", "before": "terminal.record",
             "after": "checkpoint.delete", "required": True},
        ),
        rationale=(
            "Poisoning is a terminal outcome like completion: the "
            "journal must mark the job done before its checkpoint is "
            "removed, or a crash in between recovers the job as "
            "pending with no checkpoint — replaying a job the server "
            "already declared poisoned."
        ),
    ),
    Protocol(
        name="quantum-checkpoint-before-journal-flush",
        path=f"{PACKAGE}/serving/scheduler.py",
        function="TallyScheduler._quantum",
        constraints=(
            {"kind": "before", "before": "checkpoint.save",
             "after": "journal.flush", "required": True},
        ),
        rationale=(
            "Write-ahead discipline: the quantum-boundary checkpoint "
            "is written BEFORE the journal flush that references it.  "
            "Flushed first, a crash leaves a journal pointing at a "
            "checkpoint that does not exist (recovery then replays "
            "from move 0 — correct but a silently widened loss "
            "window)."
        ),
    ),
    Protocol(
        name="preempt-checkpoint-before-journal-flush",
        path=f"{PACKAGE}/serving/scheduler.py",
        function="TallyScheduler._preempt",
        constraints=(
            {"kind": "require", "effect": "checkpoint.save"},
            {"kind": "before", "before": "checkpoint.save",
             "after": "journal.flush", "required": True,
             "also": ["checkpoint.current"]},
        ),
        rationale=(
            "A preempted job's checkpoint must be on disk before the "
            "journal records the preemption — same write-ahead edge "
            "as the quantum boundary.  The port skips the save when "
            "the job's checkpoint on disk is already this boundary's "
            "(a fleet migration reuses it), a check made by one "
            "helper (checkpoint.current), which stands in for the save "
            "on that path; the save itself must stay."
        ),
    ),
    Protocol(
        name="scheduler-uninstall-before-resume",
        path=f"{PACKAGE}/serving/scheduler.py",
        function="TallyScheduler._signal_flush",
        constraints=(
            {"kind": "require", "effect": "handler.uninstall"},
            {"kind": "before", "before": "handler.uninstall",
             "after": "handler.resume", "required": True},
        ),
        rationale=(
            "The signal flush must restore the previous handlers "
            "BEFORE resuming (chaining/exiting through) them: dying "
            "through the chain with our handler still installed "
            "leaves a stale handler a later signal routes into a "
            "dead scheduler — the stale-handler clobber."
        ),
    ),
    Protocol(
        name="runner-uninstall-before-resume",
        path=f"{PACKAGE}/resilience/runner.py",
        function="ResilientRunner._on_signal",
        constraints=(
            {"kind": "require", "effect": "handler.uninstall"},
            {"kind": "before", "before": "handler.uninstall",
             "after": "handler.resume", "required": True},
        ),
        rationale=(
            "Same stale-handler clobber as the scheduler flush: the "
            "runner's preemption flush uninstalls its own handlers "
            "before behaving as the process would have without them."
        ),
    ),
    Protocol(
        name="manifest-commit-last",
        path=f"{PACKAGE}/utils/checkpoint.py",
        function="save_sharded_checkpoint",
        aliases=(("shard.write", "checkpoint.save"),),
        constraints=(
            {"kind": "require", "effect": "manifest.commit"},
            {"kind": "before", "before": "shard.write",
             "after": "manifest.commit", "required": True},
            {"kind": "before", "before": "manifest.uncommit",
             "after": "shard.write", "required": False},
        ),
        rationale=(
            "Two-phase commit: every shard is written (phase 1) "
            "before MANIFEST.json is committed (phase 2), and a "
            "pre-existing manifest is removed before any shard is "
            "touched.  A manifest committed early names shards that "
            "may be half-written — the Frankenstein restore the "
            "sharded layout exists to prevent."
        ),
    ),
    Protocol(
        name="store-rotate-after-write",
        path=f"{PACKAGE}/resilience/store.py",
        function="CheckpointStore.save",
        constraints=(
            {"kind": "require", "effect": "checkpoint.save"},
            {"kind": "before", "before": "checkpoint.save",
             "after": "generation.rotate", "required": True},
        ),
        rationale=(
            "The keep-N rotation runs only after the new generation "
            "is durably written: rotating first can delete the last "
            "good generation before its replacement exists."
        ),
    ),
    Protocol(
        name="store-rotation-fsync",
        path=f"{PACKAGE}/resilience/store.py",
        function="CheckpointStore._rotate",
        constraints=(
            {"kind": "require", "effect": "dir.fsync"},
            {"kind": "before", "before": "generation.delete",
             "after": "dir.fsync", "required": False},
        ),
        rationale=(
            "Rotation deletions must be made durable with a directory "
            "fsync: without it a power cut can "
            "resurrect a rotated-out generation while losing the "
            "newest rename, handing find_latest a stale view."
        ),
    ),
    Protocol(
        name="journal-document-atomic",
        path=f"{PACKAGE}/serving/journal.py",
        function="SchedulerJournal.flush",
        constraints=(
            {"kind": "require", "effect": "atomic.write"},
            {"kind": "forbid", "effect": "raw.write"},
        ),
        rationale=(
            "The JOBS.json document is the single source of truth a "
            "recovery reads — it must only ever be produced by the "
            "atomic tmp+fsync+rename writer; any raw write path here "
            "reintroduces torn-journal states the whole design rules "
            "out."
        ),
    ),
    Protocol(
        name="idempotency-record-before-accept",
        path=f"{PACKAGE}/serving/fleet.py",
        function="FleetRouter.submit",
        constraints=(
            {"kind": "require", "effect": "fleet.record"},
            {"kind": "before", "before": "fleet.record",
             "after": "job.place", "required": True},
        ),
        rationale=(
            "The FLEET.json acceptance record (idempotency key map + "
            "request payload) is flushed BEFORE the job is placed on "
            "any member.  Placed first, a crash in between runs a job "
            "the router never journaled accepting — the client's "
            "retried POST then starts a SECOND execution of the same "
            "work, the exact double-run the idempotent ingress exists "
            "to rule out."
        ),
    ),
    Protocol(
        name="assignment-record-before-dispatch",
        path=f"{PACKAGE}/serving/fleet.py",
        function="FleetRouter._place",
        constraints=(
            {"kind": "require", "effect": "fleet.record"},
            {"kind": "require", "effect": "job.dispatch"},
            {"kind": "before", "before": "fleet.record",
             "after": "job.dispatch", "required": True},
        ),
        rationale=(
            "The FLEET.json assignment record is flushed BEFORE the "
            "member's scheduler sees the job.  A crash between the "
            "two leaves an assignment whose member journal does not "
            "know the job — recovery re-dispatches it from the "
            "journaled request.  Reversed, the crash window leaves a "
            "job some member owns that the router cannot attribute: "
            "on restart the router would place it AGAIN elsewhere "
            "(double-run), and migration's adopt-before-drop overlap "
            "would have no arbiter naming which copy survives."
        ),
    ),
    Protocol(
        name="eviction-record-before-drain",
        path=f"{PACKAGE}/serving/supervisor.py",
        function="FleetSupervisor._evict",
        constraints=(
            {"kind": "require", "effect": "eviction.record"},
            {"kind": "require", "effect": "member.drain"},
            {"kind": "before", "before": "eviction.record",
             "after": "member.drain", "required": True},
        ),
        rationale=(
            "The FLEET.json eviction record is flushed BEFORE the "
            "member's jobs are drained onto survivors.  A supervisor "
            "crash mid-drain then leaves a journaled eviction whose "
            "drain recovery replays from the member's on-disk "
            "journal (assignments arbitrate the already-moved "
            "copies).  Reversed, a crash after the drain but before "
            "the record leaves re-placed jobs under a member the "
            "routing journal still calls healthy — recovery would "
            "rebuild its device state and re-adopt jobs that now "
            "live (and run) elsewhere: the double-run the eviction "
            "machinery exists to rule out."
        ),
    ),
    Protocol(
        name="breach-record-before-quarantine",
        path=f"{PACKAGE}/serving/supervisor.py",
        function="FleetSupervisor._advise_slo",
        constraints=(
            {"kind": "require", "effect": "breach.record"},
            {"kind": "require", "effect": "member.quarantine"},
            {"kind": "before", "before": "breach.record",
             "after": "member.quarantine", "required": True},
        ),
        rationale=(
            "An SLO-driven quarantine is advisory, not observed: no "
            "probe failed, the member was convicted by burn-rate "
            "attribution (obs/slo.py).  The FLEET.json breach record "
            "is flushed BEFORE the quarantine takes effect, so a "
            "supervisor crash mid-advice leaves a journal that says "
            "WHY the member stopped taking placements — the operator "
            "(and fleetview --check) can audit the conviction.  "
            "Reversed, a crash after the quarantine but before the "
            "record leaves a member mysteriously sidelined with no "
            "journaled cause: an unexplained capacity loss the "
            "observability plane exists to rule out."
        ),
    ),
    Protocol(
        name="journal-flux-atomic",
        path=f"{PACKAGE}/serving/journal.py",
        function="SchedulerJournal.write_flux",
        constraints=(
            {"kind": "require", "effect": "atomic.write"},
            {"kind": "forbid", "effect": "raw.write"},
        ),
        rationale=(
            "Persisted fluxes are results that outlive the process; "
            "they ride the same atomic writer as the journal "
            "document (serialize to an in-memory buffer, then one "
            "atomic byte write)."
        ),
    ),
)

PROTOCOLS_BY_NAME = {p.name: p for p in PROTOCOLS}


# --------------------------------------------------------------------- #
# Effect extraction + CFG path enumeration
# --------------------------------------------------------------------- #
class _FnContext:
    def __init__(self, fn: ast.AST, aliases: dict[str, str]):
        #: flipped when path enumeration hits MAX_PATHS — the ordering
        #: checks then covered only a prefix of the CFG, which must
        #: surface as a finding, never as a silent clean.
        self.truncated = False
        # nested worker defs (the executor pattern): name -> def node
        self.nested = {
            n.name: n
            for n in ast.walk(fn)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n is not fn
        }
        self.opened, self.buffers = _scope_file_bindings(
            list(ast.walk(fn))
        )
        # reverse alias map: base effect -> local label
        self.relabel = {base: label for label, base in aliases.items()}

    def effect_of(self, call: ast.Call) -> str | None:
        eff = classify_call(call, self.opened, self.buffers)
        return self.relabel.get(eff, eff) if eff is not None else None


def _expr_effects(node, ctx: _FnContext, _seen=None) -> list[tuple]:
    """(effect, lineno) of every call under ``node`` in source order,
    including the effects of nested worker defs passed as call
    arguments (``ex.map(_write, …)`` performs ``_write``'s effects)."""
    if _seen is None:
        _seen = set()
    calls = [
        n
        for n in ast.walk(node)
        if isinstance(n, ast.Call)
    ]
    calls.sort(key=lambda c: (c.lineno, c.col_offset))
    out: list[tuple] = []
    for call in calls:
        eff = ctx.effect_of(call)
        if eff is not None:
            out.append((eff, call.lineno))
        for arg in list(call.args) + [k.value for k in call.keywords]:
            if (
                isinstance(arg, ast.Name)
                and arg.id in ctx.nested
                and arg.id not in _seen
            ):
                worker = ctx.nested[arg.id]
                out.extend(
                    _expr_effects(
                        ast.Module(body=worker.body, type_ignores=[]),
                        ctx, _seen | {arg.id},
                    )
                )
    return out


def _cap(paths: list, ctx: "_FnContext") -> list:
    seen = set()
    out = []
    for p in paths:
        key = (tuple(e for e, _ in p[0]), p[1])
        if key in seen:
            continue
        if len(out) >= MAX_PATHS:
            # A DISTINCT path was dropped: the checks below cover only
            # a prefix of the CFG — flagged, never silently clean.
            ctx.truncated = True
            break
        seen.add(key)
        out.append(p)
    return out


def _seq_paths(stmts, ctx) -> list[tuple[tuple, str | None]]:
    """Paths through a statement list: list of (effects, terminator)
    where terminator is None, "return" (return/raise) or "loopjump"
    (break/continue — converted back to fallthrough at the loop)."""
    paths: list[tuple[tuple, str | None]] = [((), None)]
    for stmt in stmts:
        new = []
        for eff, term in paths:
            if term is not None:
                new.append((eff, term))
                continue
            for e2, t2 in _stmt_paths(stmt, ctx):
                new.append((eff + e2, t2))
        paths = _cap(new, ctx)
    return paths


def _stmt_paths(stmt, ctx) -> list[tuple[tuple, str | None]]:
    if isinstance(stmt, (ast.Return, ast.Raise)):
        eff = tuple(_expr_effects(stmt, ctx))
        return [(eff, "return")]
    if isinstance(stmt, (ast.Break, ast.Continue)):
        return [((), "loopjump")]
    if isinstance(stmt, ast.If):
        test = tuple(_expr_effects(stmt.test, ctx))
        out = []
        for branch in (stmt.body, stmt.orelse or []):
            for eff, term in _seq_paths(branch, ctx):
                out.append((test + eff, term))
        return _cap(out, ctx)
    if isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
        head = tuple(
            _expr_effects(
                stmt.iter if hasattr(stmt, "iter") else stmt.test, ctx
            )
        )
        out = [(head, None)]  # zero iterations
        for eff, term in _seq_paths(stmt.body, ctx):
            # one iteration; break/continue fall through the loop
            out.append((head + eff, None if term == "loopjump" else term))
        for eff, term in _seq_paths(stmt.orelse or [], ctx):
            out.append((head + eff, term))
        return _cap(out, ctx)
    if isinstance(stmt, ast.Try):
        out = list(_seq_paths(stmt.body + (stmt.orelse or []), ctx))
        for handler in stmt.handlers:
            out.extend(_seq_paths(handler.body, ctx))
        if stmt.finalbody:
            final = _seq_paths(stmt.finalbody, ctx)
            merged = []
            for eff, term in out:
                for fe, ft in final:
                    merged.append((eff + fe, ft or term))
            out = merged
        return _cap(out, ctx)
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        head = tuple(
            e
            for item in stmt.items
            for e in _expr_effects(item.context_expr, ctx)
        )
        return _cap(
            [(head + eff, term) for eff, term in _seq_paths(stmt.body, ctx)],
            ctx,
        )
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [((), None)]  # a def is not an execution of its body
    return [(tuple(_expr_effects(stmt, ctx)), None)]


def function_paths(fn, aliases: dict[str, str]) -> tuple[list, bool]:
    """All (bounded) effect paths through ``fn`` — (paths, truncated):
    each path a tuple of (effect, lineno); ``truncated`` True when the
    MAX_PATHS bound dropped a distinct path (the caller must surface
    it — a partially-checked protocol is not a clean one)."""
    ctx = _FnContext(fn, aliases)
    paths = [eff for eff, _term in _seq_paths(fn.body, ctx)]
    return paths, ctx.truncated


def function_effects(fn, aliases: dict[str, str]) -> dict[str, int]:
    """Order-free effect inventory of ``fn`` (the capture's drift
    unit): effect → occurrence count over unique call sites."""
    ctx = _FnContext(fn, aliases)
    sites = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            eff = ctx.effect_of(node)
            if eff is not None:
                sites.add((eff, node.lineno, node.col_offset))
    out: dict[str, int] = {}
    for eff, _l, _c in sites:
        out[eff] = out.get(eff, 0) + 1
    return out


# --------------------------------------------------------------------- #
# Checking
# --------------------------------------------------------------------- #
def build_index(root) -> PackageIndex:
    """The shared astlint index over the real tree."""
    return index_from_sources(collect_sources(root))


def index_from_sources(sources: dict[str, str]) -> PackageIndex:
    return PackageIndex({p: _parse(p, s) for p, s in sources.items()})


def _locate(index: PackageIndex, proto: Protocol):
    return index.defs.get((proto.path, proto.function))


def _check_protocol(index: PackageIndex, proto: Protocol) -> list[Finding]:
    fn = _locate(index, proto)
    if fn is None:
        return [
            _finding(
                f"missing.{proto.name}",
                f"protocol owner {proto.path}:{proto.function} not "
                "found — the function moved or was renamed; update "
                "the protocol declaration (analysis/protolint.py) "
                "and regenerate PROTOCOLS_TORCH.json",
                path=proto.path,
            )
        ]
    aliases = dict(proto.aliases)
    paths, truncated = function_paths(fn, aliases)
    inventory = function_effects(fn, aliases)
    out: list[Finding] = []
    if truncated:
        out.append(
            _finding(
                f"paths.{proto.name}",
                f"{proto.function} exceeded the {MAX_PATHS}-path CFG "
                "bound — the ordering constraints were checked on a "
                "prefix only; split the function (it has outgrown "
                "what any review could audit) or raise MAX_PATHS",
                path=proto.path, line=fn.lineno,
            )
        )
    for c in proto.constraints:
        if c["kind"] == "require":
            if c["effect"] not in inventory:
                out.append(
                    _finding(
                        f"require.{proto.name}",
                        f"{proto.function} no longer performs "
                        f"'{c['effect']}' — {proto.rationale}",
                        path=proto.path, line=fn.lineno,
                    )
                )
        elif c["kind"] == "forbid":
            if c["effect"] in inventory:
                out.append(
                    _finding(
                        f"forbid.{proto.name}",
                        f"{proto.function} performs forbidden "
                        f"'{c['effect']}' — {proto.rationale}",
                        path=proto.path, line=fn.lineno,
                    )
                )
        elif c["kind"] == "before":
            out.extend(
                _check_before(proto, fn, paths, c)
            )
    return out


def _check_before(proto: Protocol, fn, paths, c) -> list[Finding]:
    before, after = c["before"], c["after"]
    required = bool(c.get("required"))
    # Effects that stand in for *before* on a path (the port's
    # checkpoint.current); a later *before* is still a reorder.
    also = set(c.get("also", ()))
    for path_effects in paths:
        seen_before = False
        for i, (eff, line) in enumerate(path_effects):
            if eff == before or eff in also:
                seen_before = True
            elif eff == after:
                # (i) any *before* occurring later on this path is a
                # reorder; (ii) with ``required``, an *after* with no
                # *before* yet is an unpreceded effect.
                later = [
                    (e, ln)
                    for e, ln in path_effects[i + 1:]
                    if e == before
                ]
                if later:
                    return [
                        _finding(
                            f"order.{proto.name}",
                            f"'{after}' at line {line} precedes "
                            f"'{before}' at line {later[0][1]} on a "
                            f"path through {proto.function} — the "
                            f"declared happens-before is "
                            f"'{before}' -> '{after}'. "
                            f"{proto.rationale}",
                            path=proto.path, line=line,
                        )
                    ]
                if required and not seen_before:
                    return [
                        _finding(
                            f"order.{proto.name}",
                            f"'{after}' at line {line} is reachable "
                            f"with no preceding '{before}' on a path "
                            f"through {proto.function}. "
                            f"{proto.rationale}",
                            path=proto.path, line=line,
                        )
                    ]
    return []


def check(index: PackageIndex) -> list[Finding]:
    """Verify every declared protocol against the indexed tree."""
    out: list[Finding] = []
    for proto in PROTOCOLS:
        out.extend(_check_protocol(index, proto))
    out.sort(key=lambda f: (f.path, f.line, f.symbol))
    return out


def check_sources(sources: dict[str, str]) -> list[Finding]:
    """Convenience for tests: check a {relpath: source} mapping."""
    return check(index_from_sources(sources))


# --------------------------------------------------------------------- #
# The committed capture (PROTOCOLS_TORCH.json)
# --------------------------------------------------------------------- #
def environment() -> dict:
    """The capture's environment: the package it reads and the Python
    minor version whose ``ast`` parsed it (node shapes, and so the CFG,
    differ between minors)."""
    import sys

    return {"package": PACKAGE,
            "python": f"{sys.version_info[0]}.{sys.version_info[1]}"}


def capture(index: PackageIndex) -> dict:
    protocols = {}
    for proto in PROTOCOLS:
        fn = _locate(index, proto)
        protocols[proto.name] = {
            "path": proto.path,
            "function": proto.function,
            "constraints": [dict(c) for c in proto.constraints],
            "effects": (
                function_effects(fn, dict(proto.aliases))
                if fn is not None else None
            ),
        }
    return {
        "schema": PROTOCOLS_SCHEMA,
        "environment": environment(),
        "protocols": protocols,
    }


def load_protocols(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def write_protocols(path, cap: dict) -> None:
    from ..utils.checkpoint import atomic_write_json

    atomic_write_json(path, cap)


def diff_baseline(current: dict, baseline: dict) -> list[Finding]:
    """Diff a fresh capture against the committed PROTOCOLS_TORCH.json —
    cross-environment captures are refused outright, and any
    effect-inventory drift is a named finding until the baseline is
    intentionally regenerated."""
    out: list[Finding] = []
    if baseline.get("schema") != PROTOCOLS_SCHEMA:
        out.append(
            _finding(
                "schema.all",
                f"{PROTOCOLS_FILE} schema {baseline.get('schema')!r} != "
                f"{PROTOCOLS_SCHEMA} — regenerate with python -m "
                "pumiumtally_tpu_torch.analysis --write-protocols",
            )
        )
        return out
    if current["environment"] != baseline.get("environment"):
        out.append(
            _finding(
                "environment.all",
                f"capture environment {current['environment']} != "
                f"baseline {baseline.get('environment')} — protocol "
                "captures are checked under the environment that "
                "wrote them; regenerate with --write-protocols",
            )
        )
        return out
    cur, base = current["protocols"], baseline.get("protocols", {})
    for name in sorted(set(cur) | set(base)):
        if name not in base:
            out.append(
                _finding(
                    f"protocol.added.{name}",
                    "protocol declared but absent from "
                    f"{PROTOCOLS_FILE} — regenerate the baseline",
                )
            )
            continue
        if name not in cur:
            out.append(
                _finding(
                    f"protocol.removed.{name}",
                    f"protocol in {PROTOCOLS_FILE} but no longer "
                    "declared — regenerate the baseline (and say why "
                    "the ordering promise is gone)",
                )
            )
            continue
        for field in ("path", "function", "constraints", "effects"):
            if cur[name].get(field) != base[name].get(field):
                out.append(
                    _finding(
                        f"drift.{name}",
                        f"{field} drifted: baseline "
                        f"{base[name].get(field)!r} -> current "
                        f"{cur[name].get(field)!r} — an intentional "
                        "change regenerates with --write-protocols",
                    )
                )
                break
    return out


# --------------------------------------------------------------------- #
# --explain
# --------------------------------------------------------------------- #
_OVERVIEW = """\
protocol analyzer (pumiumtally_tpu_torch/analysis/protolint.py)

Rationale: the crash-safety surface is a set of effect-ORDERING
promises (manifest committed last, terminal record journaled before
checkpoint delete, handlers uninstalled before chaining) that reviews
verified by hand.  The analyzer recognizes named effect points by
callee and verifies declared happens-before constraints along all CFG
paths of the owning functions, diffing the effect inventory against
the committed PROTOCOLS_TORCH.json (cross-environment captures
refused).

Example finding: PROTO [order.terminal-record-before-checkpoint-delete]
after TallyScheduler._finish deletes the checkpoint before flushing
the terminal journal record.

Fix pattern: restore the declared order (write-ahead: record first,
delete after); if the protocol itself changed intentionally, update
the declaration in analysis/protolint.py and regenerate with
python -m pumiumtally_tpu_torch.analysis --write-protocols.

Declared protocols:
"""


def explain(name: str) -> str | None:
    """Rationale + constraints + fix pattern for ``protocol`` (the
    overview) or one protocol by name."""
    key = name.strip().lower()
    if key in ("proto", "protocol", "protocols"):
        lines = [_OVERVIEW]
        for p in PROTOCOLS:
            lines.append(f"  {p.name}  ({p.path}:{p.function})")
        return "\n".join(lines)
    proto = PROTOCOLS_BY_NAME.get(key)
    if proto is None:
        return None
    cons = "\n".join(f"  {c}" for c in proto.constraints)
    return (
        f"{proto.name}\nOwner: {proto.path}:{proto.function}\n"
        f"Rationale: {textwrap.fill(proto.rationale, 70)}\n"
        f"Constraints:\n{cons}\n"
        "Fix pattern: restore the declared effect order in the owning "
        "function; for an intentional protocol change, edit the "
        "declaration in analysis/protolint.py and regenerate "
        "PROTOCOLS_TORCH.json with python -m "
        "pumiumtally_tpu_torch.analysis --write-protocols."
    )
