"""AST lint engine with the port's rules (the codebase half of the
analysis, beside :mod:`analysis.protolint`).

The rules encode promises that runtime tests can only witness by
executing a failure; here they are properties of the source tree:

  PUMI001 host-sync-on-move-loop  ``.item()`` / ``.tolist()`` /
      ``.cpu()`` / ``.numpy()`` / ``.nonzero()`` of a tensor, ``int()`` /
      ``float()`` / ``bool()`` of a tensor-tainted name, ``torch.nonzero``
      and ``torch.cuda.synchronize`` in a function of the move loop: each
      waits for the card with the card's queue drained. The move loop's
      counted reads stand in LINT_BASELINE_TORCH.json, each with what it
      waits for and the ROADMAP item that would remove it.
  PUMI002 transfer-outside-staging  ``.cuda()`` / ``.cpu()`` /
      ``.pin_memory()`` / ``.to(<device>)`` (a device, a device string,
      ``x.device`` or ``device=``; ``.to(torch.float32)`` is a cast, not
      a transfer) / ``.copy_(..., non_blocking=...)`` / ``torch.tensor``
      or ``torch.as_tensor`` with ``device=``, outside the approved
      staging and facade modules: the packed move makes one H2D and one
      D2H, so transfers are a structural property of a handful of files,
      and a transfer anywhere else is a hole in that count.
  PUMI004 global-rng-on-move-loop  ``torch.rand`` / ``rand_like`` /
      ``randn`` / ``randint`` / ``randperm`` / ``bernoulli`` /
      ``multinomial`` / ``normal`` (and the in-place samplers
      ``.uniform_()`` ...) without ``generator=``, and the global state
      of ``np.random.<fn>`` and ``random.*``, in a function of the move
      loop: the port draws from explicit generators and keyed counters,
      and its flux is promised bitwise on replay (checkpoint resume,
      retry re-arm).
  PUMI005 f64-on-device-path      ``torch.float64`` / ``torch.double`` /
      ``.double()`` outside a dtype dispatch (and a ``"float64"`` dtype
      literal in a move-loop function of the device-op modules, where the
      JAX rule looked in traced bodies) outside
      ``integrity/audit.py``: the float32 configurations must stay
      float64-free on the card (the shadow audit is the one sanctioned
      float64 surface).
  PUMI007 guarded-by              attributes annotated
      ``# guarded by: <lock>`` must only be touched under ``with
      <lock>:`` outside ``__init__``; locals annotated
      ``# guarded by: <event> (event)`` must be written only by worker
      closures that ``<event>.set()`` and read only after
      ``<event>.wait(...)``.

Layer-4 codebase rules (the durability & concurrency half; the
effect-ordering protocols live in :mod:`analysis.protolint`):

  PUMI008 raw-durable-write       ``open(..., "w")`` / ``np.save`` /
      ``json.dump`` / ``Path.write_*`` outside the approved
      atomic-write modules (``utils/checkpoint.py``,
      ``serving/journal.py``, ``serving/bank.py``,
      ``resilience/store.py``, ``tuning/db.py``) — a raw write can
      tear under crash/ENOSPC, and torn state is exactly what the
      crash-safety layer exists to rule out.
  PUMI009 signal-handler-safety   handler bodies reachable from
      ``utils/signals.install_preemption_handlers`` must not flush the
      journal without the mid-dispatch deferral guard, take locks
      annotated ``# guarded by:``, or call into the move loop; every
      install needs a matching uninstall, and a handler that chains
      the previous handler must uninstall its own first.
  PUMI010 unguarded-thread-shared  state written from functions
      reachable from ``threading.Thread`` targets / executor workers
      without a ``# guarded by:`` annotation — PUMI007 only enforces
      *annotated* state; this closes the inference gap.
  PUMI011 swallowed-retryable     an ``except`` catching a RETRYABLE /
      ``Transient*`` type must re-raise, route through
      ``ResilienceCoordinator.classify``, or count the swallow into a
      metric — silently absorbing a retryable error erases the
      resilience layer's signal.

PUMI003 (use after donate) and PUMI006 (jit hygiene) of the JAX
package's lint have no meaning here: the port donates no buffer and
builds no jit. Their ids are not reused.

The move loop is a package-wide closure: from ``MOVE_LOOP_ROOTS`` (the
facades' ``initialize_particle_location``, ``move_to_next_location`` and
``run_source_moves``), every function a move-loop function calls or
names (``self`` methods of its class, module-level defs, intra-package
imports, function-local imports included) is on the move loop, and
nested defs inherit it. The plain versions in ``PLAIN_VERSIONS`` run on
the CPU only: the closure does not enter them. PUMI001 reports in the
modules that run device operations (``MOVE_LOOP_SCOPE``: ``ops/``
without ``ops/staging.py``, ``core/``, ``models/``); the facades and the
stager are the transfer layer, whose reads PUMI002 places.

A tensor-tainted name is one bound from a ``torch.*`` call (other than
the metadata calls ``torch.device``, ``torch.finfo`` ...), from a call
of a package function that returns a tainted value, from an expression
over a tainted name, or by a loop over one; ``.shape``,
``.dtype``, ``.device``, ``.numel()``, ``.size()``, ``.data_ptr()`` ...
of a tensor are host values, and so is the result of a read head or of a
``np.*`` call. A parameter counts as a tensor only where a read head is
applied to it or to an item or attribute of it (``a.cpu()``,
``ph["slots"].cpu()``): its value taints no other name, and ``int()`` of
a bare parameter is a host knob (a block width, a tolerance).

Entry-point modules keep the rule subset of their JAX script
counterparts: ``serving/__main__.py`` (scripts/serve.py),
``chaos/serve.py`` and ``chaos/fleet.py`` (chaos_serve.py,
chaos_fleet.py) get the value-safety subset plus PUMI008/PUMI009;
``chaos/campaign.py`` (chaos.py), ``tuning/__main__.py`` (tune.py) and
``probes/`` (probe_pallas_gather.py) get the value-safety subset
(PUMI001, PUMI004, PUMI005) alone. ``chip_smoke.py`` and ``turns.py`` at
the root are not linted: they are the card's measurement harness, which
stages its own transfers and compares in float64 on purpose, and none
of their functions joins the move loop, so the value-safety rules would
have nothing of theirs to check.

Findings are suppressed per (rule, path, symbol) through
``LINT_BASELINE_TORCH.json`` (analysis.apply_baseline) — justification
required.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path

from . import Finding

PACKAGE = "pumiumtally_tpu_torch"

# Modules allowed to move tensors between the host and the card: the
# staging layer itself, the facades that own the one-H2D-one-D2H move,
# the partitioned exchange, the sharding and checkpoint plumbing, the
# pipeline and the health probe (the JAX list, file for file).
APPROVED_TRANSFER_MODULES = frozenset(
    {
        f"{PACKAGE}/ops/staging.py",
        f"{PACKAGE}/ops/source.py",
        f"{PACKAGE}/ops/walk_partitioned.py",
        f"{PACKAGE}/api.py",
        f"{PACKAGE}/parallel/partitioned_api.py",
        f"{PACKAGE}/parallel/particle_sharding.py",
        f"{PACKAGE}/utils/checkpoint.py",
        f"{PACKAGE}/models/pipeline.py",
        # The per-card health probe stages a tiny round trip on every
        # device by design (a dead card fails the copy).
        f"{PACKAGE}/resilience/coordinator.py",
    }
)

# The one module allowed to hold float64 on purpose: the shadow-audit
# reference walker is DEFINED as a float64 NumPy oracle.
F64_EXEMPT_MODULES = frozenset({f"{PACKAGE}/integrity/audit.py"})

# Modules allowed to perform raw persistent writes: they ARE the
# atomic-write layer (tmp + fsync + rename) every other module must
# route durable state through.  A raw write anywhere else can tear
# under crash/ENOSPC — the exact failure mode the crash-safety surface
# (journal, two-phase checkpoints) exists to rule out.
APPROVED_DURABLE_MODULES = frozenset(
    {
        f"{PACKAGE}/utils/checkpoint.py",
        f"{PACKAGE}/serving/journal.py",
        f"{PACKAGE}/serving/bank.py",
        f"{PACKAGE}/resilience/store.py",
        f"{PACKAGE}/tuning/db.py",
    }
)

# The move loop's roots: the facades' three calls, single-device and
# partitioned.
MOVE_LOOP_ROOTS = (
    (f"{PACKAGE}/api.py", "PumiTally.initialize_particle_location"),
    (f"{PACKAGE}/api.py", "PumiTally.move_to_next_location"),
    (f"{PACKAGE}/api.py", "PumiTally.run_source_moves"),
    (f"{PACKAGE}/parallel/partitioned_api.py",
     "PartitionedTally.initialize_particle_location"),
    (f"{PACKAGE}/parallel/partitioned_api.py",
     "PartitionedTally.move_to_next_location"),
    (f"{PACKAGE}/parallel/partitioned_api.py",
     "PartitionedTally.run_source_moves"),
)

# Where PUMI001 reports: the modules that run device operations.
MOVE_LOOP_SCOPE = (f"{PACKAGE}/ops/", f"{PACKAGE}/core/",
                   f"{PACKAGE}/models/")
MOVE_LOOP_SCOPE_EXCLUDED = frozenset({f"{PACKAGE}/ops/staging.py"})

# The plain versions: each kernel wrapper calls its plain version only
# when its tensors lie on the CPU, so their host reads never wait for
# the card. The move-loop closure does not enter them.
PLAIN_VERSIONS = frozenset(
    {
        # walk_cuda.trace's plain walk (imported there as trace_plain)
        (f"{PACKAGE}/ops/walk.py", "trace"),
        (f"{PACKAGE}/ops/walk_cuda.py", "lane_records_plain"),
        (f"{PACKAGE}/ops/walk_partitioned.py", "walk_rows_plain"),
        (f"{PACKAGE}/ops/walk_partitioned.py", "_exchange_plain"),
        # integrity_cuda.integrity_vector's plain version
        (f"{PACKAGE}/ops/walk.py", "integrity_vector"),
        (f"{PACKAGE}/ops/scatter.py", "scatter_ordered_plain"),
        (f"{PACKAGE}/ops/scatter.py", "scatter_atomic_plain"),
        (f"{PACKAGE}/ops/gather.py", "gather_rows_plain"),
        (f"{PACKAGE}/ops/source.py", "sample_flight_plain"),
    }
)

# The value-safety subset: the rules about what runs on the move loop,
# which hold wherever the move loop is driven from.
SCRIPT_RULES = frozenset({"PUMI001", "PUMI004", "PUMI005"})

# The port's counterparts of the JAX package's scripts with a rule
# subset: the journal-owning ones additionally get the durability and
# signal-handler rules.
JOURNAL_SCRIPTS = frozenset({
    f"{PACKAGE}/serving/__main__.py",
    f"{PACKAGE}/chaos/serve.py",
    f"{PACKAGE}/chaos/fleet.py",
})
JOURNAL_SCRIPT_RULES = SCRIPT_RULES | frozenset({"PUMI008", "PUMI009"})
ENTRY_SCRIPTS = JOURNAL_SCRIPTS | frozenset({
    f"{PACKAGE}/chaos/campaign.py",
    f"{PACKAGE}/tuning/__main__.py",
})
ENTRY_SCRIPT_DIRS = (f"{PACKAGE}/probes/",)


def rules_for_path(path: str) -> frozenset | None:
    """The rule subset applied to ``path`` (None = every rule)."""
    if path in JOURNAL_SCRIPTS:
        return JOURNAL_SCRIPT_RULES
    if path in ENTRY_SCRIPTS or path.startswith(ENTRY_SCRIPT_DIRS):
        return SCRIPT_RULES
    if path.startswith(f"{PACKAGE}/"):
        return None
    return SCRIPT_RULES


# PUMI001's heads: builtins of a tainted value, methods of a tainted
# receiver, and calls that wait whatever their arguments.
_HOST_SYNC_FUNCS = frozenset({"float", "int", "bool"})
_HOST_SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy", "nonzero"})
_HOST_SYNC_CALLS = frozenset({"torch.nonzero", "torch.cuda.synchronize"})

# PUMI002's heads.
_TRANSFER_ATTRS = frozenset({"cuda", "cpu", "pin_memory"})
_TENSOR_FACTORIES = frozenset({"torch.tensor", "torch.as_tensor"})

# PUMI004's heads: torch samplers that draw from the global generator
# unless handed ``generator=``, and the host's global random state.
_TORCH_SAMPLERS = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "bernoulli", "multinomial", "normal", "poisson",
})
_INPLACE_SAMPLERS = frozenset({
    "uniform_", "normal_", "random_", "exponential_", "bernoulli_",
    "geometric_", "cauchy_", "log_normal_",
})
# Explicit generators: constructing one with a seed is the sanctioned
# idiom, so only a call without arguments draws from the host's entropy.
_EXPLICIT_GENERATORS = frozenset({
    "default_rng", "Generator", "SeedSequence", "PCG64", "Philox",
    "Random",
})

_GUARD_RE = re.compile(r"#\s*guarded by:\s*(?P<lock>[^#]+?)\s*$")
_EVENT_SUFFIX_RE = re.compile(r"\(event\)\s*$")


def _walk_shallow(fn):
    """Walk a function body WITHOUT descending into nested defs: each
    def is analyzed as its own scope (it has its own entry in
    ``PackageIndex.defs``), so a deep walk would double-report and
    cross-taint sibling scopes.  Lambdas stay in scope — they share the
    enclosing function's locals."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            stack.extend(ast.iter_child_nodes(node))


def _dotted(node) -> str | None:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _const_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


@dataclass
class Module:
    path: str
    tree: ast.Module
    lines: list[str]
    comments: dict[int, str] = field(default_factory=dict)


def _parse(path: str, source: str) -> Module:
    tree = ast.parse(source, filename=path)
    comments: dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(
            io.StringIO(source).readline
        ):
            if tok.type == tokenize.COMMENT:
                comments[tok.start[0]] = tok.string
    except tokenize.TokenError:
        pass
    return Module(path, tree, source.splitlines(), comments)


# --------------------------------------------------------------------- #
# Package index: defs, imports, the move-loop closure
# --------------------------------------------------------------------- #
def _module_of_import(cur_path: str, level: int, module: str | None,
                      known: set[str]) -> str | None:
    """Resolve a (possibly relative) import to a known package relpath
    (``a/b.py`` or ``a/b/__init__.py``), else None."""
    if level == 0:
        base = (module or "").split(".")
        if base and base[0] != PACKAGE.split("/")[0]:
            return None
        parts = base
    else:
        here = cur_path.split("/")[:-1]  # directory of current module
        up = level - 1
        if up:
            here = here[: len(here) - up] if up <= len(here) else []
        parts = here + ([p for p in (module or "").split(".") if p])
    cand = "/".join(parts) + ".py"
    if cand in known:
        return cand
    cand = "/".join(parts) + "/__init__.py"
    if cand in known:
        return cand
    return None


class PackageIndex:
    """Cross-module name resolution + the move-loop closure."""

    def __init__(self, modules: dict[str, Module]):
        self.modules = modules
        known = set(modules)
        # (path, qualname) -> def node
        self.defs: dict[tuple[str, str], ast.AST] = {}
        # (path, qualname) of every class
        self.classes: set[tuple[str, str]] = set()
        # path -> {local name -> ("def", qualname) |
        #          ("name", path2, remote_name) | ("mod", path2)}
        self.scope: dict[str, dict] = {}
        self.parents: dict[str, dict[ast.AST, ast.AST]] = {}
        for path, mod in modules.items():
            env: dict = {}
            parent: dict[ast.AST, ast.AST] = {}
            for node in ast.walk(mod.tree):
                for child in ast.iter_child_nodes(node):
                    parent[child] = node
            self.parents[path] = parent
            for node in ast.walk(mod.tree):
                if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    q = self._qualname(path, node, parent)
                    self.defs[(path, q)] = node
                    if "." not in q:
                        env[node.name] = ("def", q)
                elif isinstance(node, ast.ClassDef):
                    self.classes.add(
                        (path, self._qualname(path, node, parent)))
                elif isinstance(node, ast.ImportFrom):
                    tgt = _module_of_import(
                        path, node.level, node.module, known
                    )
                    for alias in node.names:
                        name = alias.asname or alias.name
                        if tgt is None:
                            continue
                        # `from . import staging` resolves the NAME as a
                        # submodule when one exists.
                        sub = _module_of_import(
                            path, node.level,
                            f"{node.module}.{alias.name}"
                            if node.module else alias.name,
                            known,
                        )
                        if sub is not None:
                            env.setdefault(name, ("mod", sub))
                        else:
                            env.setdefault(
                                name, ("name", tgt, alias.name)
                            )
                elif isinstance(node, ast.Import):
                    pass  # absolute external imports — not package code
            self.scope[path] = env
        self.move_loop: set[tuple[str, str]] = self._close_move_loop()

    # -- qualnames ---------------------------------------------------- #
    def _qualname(self, path, node, parent) -> str:
        parts = [node.name]
        cur = parent.get(node)
        while cur is not None:
            if isinstance(
                cur,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                parts.append(cur.name)
            cur = parent.get(cur)
        return ".".join(reversed(parts))

    def qualname(self, path, node) -> str:
        return self._qualname(path, node, self.parents[path])

    def enclosing_symbol(self, path, node) -> str:
        cur = node
        parent = self.parents[path]
        while cur is not None:
            if isinstance(
                cur,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                return self._qualname(path, cur, parent)
            cur = parent.get(cur)
        return "<module>"

    def _resolve(self, path: str, name_node,
                 local_env: dict | None = None):
        """Resolve a Name/Attribute to a (path, qualname) def key."""
        if isinstance(name_node, ast.Name):
            name = name_node.id
            for env in (local_env or {},):
                if name in env:
                    return env[name]
            entry = self.scope[path].get(name)
            if entry is None:
                return None
            if entry[0] == "def":
                return ("def@", path, entry[1])
            if entry[0] == "name":
                _, p2, remote = entry
                if (p2, remote) in self.defs:
                    return ("def@", p2, remote)
                return None
            return None
        if isinstance(name_node, ast.Attribute):
            base = name_node.value
            if isinstance(base, ast.Name):
                entry = self.scope[path].get(base.id)
                if entry and entry[0] == "mod":
                    p2 = entry[1]
                    if (p2, name_node.attr) in self.defs:
                        return ("def@", p2, name_node.attr)
        return None

    def _local_defs_env(self, path, fn) -> dict:
        env = {}
        for node in ast.walk(fn):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) and node is not fn:
                env[node.name] = (
                    "def@", path, self.qualname(path, node)
                )
        return env

    def _enclosing_fn(self, path, node):
        cur = node
        parent = self.parents[path]
        while cur is not None:
            cur = parent.get(cur)
            if isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                return cur
        return None

    def _fn_import_env(self, path, fn) -> dict:
        """Function-local `from .x import y` imports (idiomatic here for
        cycle avoidance) resolved like module-level ones; a submodule
        imported by name (`from ..ops import walk_cuda`) resolves its
        attributes too."""
        env = {}
        known = set(self.modules)
        for node in ast.walk(fn):
            if isinstance(node, ast.ImportFrom):
                tgt = _module_of_import(
                    path, node.level, node.module, known
                )
                if tgt is None:
                    continue
                for alias in node.names:
                    name = alias.asname or alias.name
                    if (tgt, alias.name) in self.defs:
                        env[name] = ("def@", tgt, alias.name)
                        continue
                    sub = _module_of_import(
                        path, node.level,
                        f"{node.module}.{alias.name}"
                        if node.module else alias.name,
                        known,
                    )
                    if sub is not None:
                        env[name] = ("mod", sub)
        return env

    # -- the move loop ------------------------------------------------ #
    def _class_of_call(self, path, value, env):
        """(path, qualname) of the package class that ``value`` calls
        (``Collectives(lay)``), else None."""
        if not isinstance(value, ast.Call):
            return None
        f = value.func
        if isinstance(f, ast.Name):
            entry = env.get(f.id) or self.scope[path].get(f.id)
            if (path, f.id) in self.classes:
                return (path, f.id)
            if entry and entry[0] == "name" and (
                (entry[1], entry[2]) in self.classes
            ):
                return (entry[1], entry[2])
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            entry = env.get(f.value.id)
            if entry and entry[0] == "mod" and (
                (entry[1], f.attr) in self.classes
            ):
                return (entry[1], f.attr)
        return None

    def _instances(self, path, fn, env) -> dict:
        """Names bound to an instance of a package class in ``fn`` or
        the functions around it (``comm = Collectives(lay)``)."""
        out: dict = {}
        scope = fn
        while scope is not None:
            for node in _walk_shallow(scope):
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    cls = self._class_of_call(path, node.value, env)
                    if cls is not None:
                        out.setdefault(node.targets[0].id, cls)
            scope = self._enclosing_fn(path, scope)
        return out

    def _ref_key(self, path, node, cls_q, env, instances=None):
        """The def a Name/Attribute names: a ``self`` method of the
        class ``cls_q``, a method of a package class's instance, a local
        or module def, an imported package def, or an attribute of an
        imported package module."""
        if isinstance(node, ast.Attribute) and isinstance(
            node.value, ast.Name
        ):
            base = node.value.id
            if base == "self" and cls_q is not None:
                key = (path, f"{cls_q}.{node.attr}")
                return key if key in self.defs else None
            inst = (instances or {}).get(base)
            if inst is not None:
                key = (inst[0], f"{inst[1]}.{node.attr}")
                return key if key in self.defs else None
            entry = env.get(base)
            if entry and entry[0] == "mod":
                key = (entry[1], node.attr)
                return key if key in self.defs else None
        if isinstance(node, ast.Name) and node.id in env:
            entry = env[node.id]
            return (entry[1], entry[2]) if entry[0] == "def@" else None
        key = self._resolve(path, node)
        return (key[1], key[2]) if key and key[0] == "def@" else None

    def _close_move_loop(self) -> set[tuple[str, str]]:
        """Every def on the move loop: the roots, what a move-loop def
        calls or names, and the defs nested in one; never a plain
        version."""
        seen: set[tuple[str, str]] = set()
        stack = [r for r in MOVE_LOOP_ROOTS if r in self.defs]
        while stack:
            key = stack.pop()
            if key in seen or key in PLAIN_VERSIONS:
                continue
            seen.add(key)
            path, q = key
            fn = self.defs[key]
            cls = _enclosing_class(self, path, fn)
            cls_q = self.qualname(path, cls) if cls is not None else None
            env = dict(self._local_defs_env(path, fn))
            env.update(self._fn_import_env(path, fn))
            for name, entry in self.scope[path].items():
                if entry[0] == "mod":
                    env.setdefault(name, entry)
            instances = self._instances(path, fn, env)
            prefix = q + "."
            stack.extend(k for k in self.defs
                         if k[0] == path and k[1].startswith(prefix))
            for node in ast.walk(fn):
                if isinstance(node, (ast.Name, ast.Attribute)) and (
                    isinstance(node.ctx, ast.Load)
                ):
                    ref = self._ref_key(path, node, cls_q, env, instances)
                    if ref is not None and ref not in seen:
                        stack.append(ref)
                elif isinstance(node, ast.Call):
                    cls = self._class_of_call(path, node, env)
                    if cls is not None:
                        init = (cls[0], f"{cls[1]}.__init__")
                        if init in self.defs and init not in seen:
                            stack.append(init)
        return seen


# --------------------------------------------------------------------- #
# Tensor taint (names bound from torch values)
# --------------------------------------------------------------------- #
# Host values read off a tensor: metadata attributes and methods.
_STATIC_ATTRS = frozenset({
    "shape", "ndim", "dtype", "device", "is_cuda", "itemsize", "layout",
    "requires_grad", "is_leaf",
})
_STATIC_METHODS = frozenset({
    "numel", "dim", "size", "element_size", "data_ptr", "stride",
    "is_contiguous", "nelement", "get_device", "storage_offset",
    "is_floating_point", "is_complex", "untyped_storage",
})
_STATIC_CALLS = frozenset({
    "len", "isinstance", "getattr", "hasattr", "type", "id",
    "torch.device", "torch.finfo", "torch.iinfo", "torch.Size",
    "torch.get_default_dtype", "torch.is_tensor", "torch.promote_types",
    "torch.result_type", "torch.is_floating_point",
})


def _taint_set(fn: ast.FunctionDef, returns=None,
               params: bool = False) -> set[str]:
    """Names in ``fn`` that (syntactically) hold tensors on the card or
    values computed from them: anything bound from an expression that
    calls into ``torch`` or mentions a tainted name, and the targets of
    a loop over one. Metadata (``.shape``, ``.numel()``, ``len()`` ...)
    is a host value and taints nothing. ``returns`` maps a call to
    whether the package function it calls returns a tensor (None: not a
    package function). ``params`` seeds the positional parameters as
    tensors (how a function's return is judged for a tensor argument)."""
    tainted: set[str] = set(_params(fn)) if params else set()

    def expr_tainted(e) -> bool:
        return _expr_tainted(e, tainted, returns)

    changed = True
    while changed:
        changed = False
        for node in _walk_shallow(fn):
            tgt_names: list[str] = []
            if isinstance(node, (ast.Assign, ast.AnnAssign)) and (
                node.value is not None and expr_tainted(node.value)
            ):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    tgt_names.extend(_bound_names(t))
            elif isinstance(node, ast.AugAssign) and expr_tainted(
                node.value
            ):
                tgt_names.extend(_bound_names(node.target))
            elif isinstance(node, ast.For) and expr_tainted(node.iter):
                tgt_names.extend(_bound_names(node.target))
            for n in tgt_names:
                if n not in tainted:
                    tainted.add(n)
                    changed = True
    return tainted


def _params(fn) -> frozenset:
    """``fn``'s positional parameters but ``self``/``cls``."""
    return frozenset(a.arg for a in fn.args.posonlyargs + fn.args.args
                     if a.arg not in ("self", "cls"))


def _bound_names(target) -> list[str]:
    """The names an assignment target binds or mutates: the names of a
    tuple target, and the base of a subscript or attribute target
    (``x[i] = v`` stores into ``x``; ``i`` is only read)."""
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _bound_names(e)]
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    while isinstance(target, (ast.Subscript, ast.Attribute)):
        target = target.value
    return [target.id] if isinstance(target, ast.Name) else []


def _expr_tainted(e, tainted: set[str], returns=None) -> bool:
    """Whether expression ``e`` holds a tensor value (or one computed
    from a tensor), given the function's tainted names; a call of a
    package function holds one when that function returns one."""
    if isinstance(e, ast.Attribute) and e.attr in _STATIC_ATTRS:
        return False
    if isinstance(e, ast.Call) and returns is not None:
        known = returns(e, tainted)
        if known is not None:
            return known
    if isinstance(e, ast.Call):
        d = _dotted(e.func) or ""
        if d in _STATIC_CALLS or d.startswith("torch.cuda."):
            return False
        if isinstance(e.func, ast.Attribute) and (
            e.func.attr in _STATIC_METHODS
            or e.func.attr in _HOST_SYNC_ATTRS - {"nonzero"}
        ):
            return False  # metadata, or a value read to the host
        if isinstance(e.func, ast.Name) and e.func.id in _HOST_SYNC_FUNCS:
            return False
        if d.startswith(("np.", "numpy.")):
            return False  # a numpy array lives on the host
        if d.startswith("torch.") and d not in _HOST_SYNC_CALLS:
            return True
    if isinstance(e, ast.Name):
        return e.id in tainted and isinstance(e.ctx, ast.Load)
    if isinstance(e, (ast.Lambda, ast.FunctionDef)):
        return False
    return any(
        _expr_tainted(sub, tainted, returns)
        for sub in ast.iter_child_nodes(e)
    )


def _is_tainted_ref(node, tainted: set[str]) -> bool:
    """Direct reference to a tainted value: a tainted Name, or an
    attribute or subscript chain rooted at one (``counts[0]``)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return False
        node = node.value
    return isinstance(node, ast.Name) and node.id in tainted


# --------------------------------------------------------------------- #
# Rules
# --------------------------------------------------------------------- #
def _in_move_loop_scope(path: str) -> bool:
    return path.startswith(MOVE_LOOP_SCOPE) and (
        path not in MOVE_LOOP_SCOPE_EXCLUDED
    )


class _Returns:
    """Whether a call of a package function returns a tensor: when the
    function's return value is tainted in its own body with no tensor
    handed in (it makes one), or with its parameters taken as tensors
    and a tensor among the call's arguments (it computes one from them).
    Memoized; a recursive call counts as host."""

    def __init__(self, index: PackageIndex):
        self.index = index
        self.memo: dict = {}

    def resolver(self, path, fn):
        """``returns`` for ``_taint_set`` inside ``fn``."""
        index = self.index
        cls = _enclosing_class(index, path, fn)
        cls_q = index.qualname(path, cls) if cls is not None else None
        env = dict(index._local_defs_env(path, fn))
        env.update(index._fn_import_env(path, fn))
        for name, entry in index.scope[path].items():
            if entry[0] == "mod":
                env.setdefault(name, entry)
        instances = index._instances(path, fn, env)

        def returns(call, tainted=None):
            if not isinstance(call.func, (ast.Name, ast.Attribute)):
                return None
            key = index._ref_key(path, call.func, cls_q, env, instances)
            if key is None:
                return None
            makes, passes = self(key)
            return makes or (passes and tainted is not None and any(
                _expr_tainted(a, tainted, returns)
                for a in list(call.args)
                + [k.value for k in call.keywords]))
        return returns

    def __call__(self, key) -> tuple[bool, bool]:
        """(returns a tensor it makes, returns one computed from a
        tensor argument)."""
        if key not in self.memo:
            self.memo[key] = (False, False)
            fn = self.index.defs[key]
            returns = self.resolver(key[0], fn)
            self.memo[key] = tuple(
                any(isinstance(n, ast.Return) and n.value is not None
                    and _expr_tainted(n.value, tainted, returns)
                    for n in _walk_shallow(fn))
                for tainted in (_taint_set(fn, returns),
                                _taint_set(fn, returns, params=True)))
        return self.memo[key]


def _rule_host_sync(index: PackageIndex, out: list[Finding]):
    """PUMI001 — the move loop's host syncs are counted.

    Rationale: a read of a device value to the host (``.item()``,
    ``.tolist()``, ``int(t)``, ``if t:``, ``torch.nonzero`` ...) waits
    for every kernel queued before it, with the card idle until the host
    queues the next. The move loop's reads are a known, counted set
    (each baselined with what it waits for and the ROADMAP item that
    would remove it); a new one costs every move a round trip that only
    a profile would show.
    Example finding: ``n = int(counts.sum().item())`` in an ``ops/``
    function that ``PumiTally.move_to_next_location`` reaches.
    Fix pattern: keep the value on the card (size buffers from a bound,
    pass counts to the next kernel), fold the read into the move's one
    readback, or, if the wait is the design, baseline it with what it
    waits for and the ROADMAP item that would remove it.
    """
    tensor_returns = _Returns(index)
    for (path, q), fn in index.defs.items():
        if (path, q) not in index.move_loop or not _in_move_loop_scope(
            path
        ):
            continue
        returns = tensor_returns.resolver(path, fn)
        tainted = _taint_set(fn, returns)
        params = _params(fn)
        for node in _walk_shallow(fn):
            msg = (_sync_head(node, tainted, returns, params)
                   if isinstance(node, ast.Call) else None)
            if msg:
                out.append(Finding("PUMI001", path, node.lineno, q, msg))


def _sync_head(node: ast.Call, tainted: set[str], returns=None,
               params: frozenset = frozenset()) -> str | None:
    """The message for a call that waits for the card, else None."""
    d = _dotted(node.func)
    if d in _HOST_SYNC_CALLS:
        return (f"{d}() on the move loop — waits for the card")
    if (
        isinstance(node.func, ast.Name)
        and node.func.id in _HOST_SYNC_FUNCS
        and node.args
        and _is_tainted_ref(node.args[0], tainted)
    ):
        return (
            f"{node.func.id}() of tensor '{ast.unparse(node.args[0])}' on "
            "the move loop — blocks on device readback"
        )
    if (
        isinstance(node.func, ast.Attribute)
        and node.func.attr in _HOST_SYNC_ATTRS
        and (_expr_tainted(node.func.value, tainted, returns)
             or _is_tainted_ref(node.func.value, params))
    ):
        return (
            f".{node.func.attr}() of tensor "
            f"'{ast.unparse(node.func.value)}' on the move loop — blocks "
            "on device readback"
        )
    return None


def _is_device_arg(node) -> bool:
    """Whether ``node``, the first argument of ``.to(...)``, names a
    device: a device string, ``torch.device(...)``, ``x.device`` or a
    name that says device; a dtype (``torch.float32``, ``dt``) is a
    cast."""
    if _const_str(node) is not None:
        return True
    if isinstance(node, ast.Call):
        return (_dotted(node.func) or "") == "torch.device"
    d = _dotted(node)
    if d is None:
        return False
    last = d.split(".")[-1].lower()
    return last == "device" or last.startswith("dev") or last.endswith(
        "device")


def _transfer_head(node: ast.Call) -> str | None:
    d = _dotted(node.func)
    if d in _TENSOR_FACTORIES:
        return f"{d}(..., device=)" if any(
            kw.arg == "device" for kw in node.keywords) else None
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    if attr in _TRANSFER_ATTRS:
        return f".{attr}()"
    if attr == "to" and (
        any(kw.arg == "device" for kw in node.keywords)
        or (node.args and _is_device_arg(node.args[0]))
    ):
        return ".to(<device>)"
    if attr == "copy_" and any(
        kw.arg == "non_blocking" for kw in node.keywords
    ):
        return ".copy_(..., non_blocking=)"
    return None


def _rule_transfers(index: PackageIndex, out: list[Finding]):
    """PUMI002 — host<->card copies stay in the staging layer.

    Rationale: the packed move makes one H2D of its carrier record and
    one D2H of its readback (``tally.io`` counts them); that count holds
    because every copy between the host and the card lives in a handful
    of staging and facade modules. A copy anywhere else is a transfer
    no counter sees.
    Example finding: ``t.to(device)`` or ``t.cpu()`` in ``obs/``.
    Fix pattern: stage through ``ops/staging.py`` or the facade, or
    baseline a transfer that is set-up or export (mesh tables placed
    once, a result written to disk) with a justification.
    """
    for path, mod in index.modules.items():
        if path in APPROVED_TRANSFER_MODULES:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                head = _transfer_head(node)
                if head is not None:
                    out.append(
                        Finding(
                            "PUMI002",
                            path,
                            node.lineno,
                            index.enclosing_symbol(path, node),
                            f"{head} outside the approved staging "
                            "modules — every host<->device edge must "
                            "live in the staging/facade layer so the "
                            "1 H2D + 1 D2H move contract stays "
                            "structural",
                        )
                    )


def _rule_global_rng(index: PackageIndex, out: list[Finding]):
    """PUMI004 — the move loop draws from explicit generators.

    Rationale: the port's random numbers are keyed (threefry counters,
    seeded ``np.random.default_rng``, a ``torch.Generator``), so a
    replay (checkpoint resume, retry re-arm, a re-run) gives the flux
    bit for bit. A draw from a global generator on the move loop depends
    on whatever drew before it in the process.
    Example finding: ``torch.rand(n, device=dev)`` or
    ``np.random.random(n)`` in a function the facade's move reaches.
    Fix pattern: pass ``generator=`` (a seeded ``torch.Generator``), use
    a seeded ``np.random.default_rng(seed)``, or derive the draws from
    the keyed counters of ``ops/source.py``.
    """
    for (path, q), fn in index.defs.items():
        if (path, q) not in index.move_loop:
            continue
        for node in _walk_shallow(fn):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func) or ""
            parts = d.split(".")
            has_gen = any(kw.arg == "generator" for kw in node.keywords)
            what = None
            if (len(parts) == 2 and parts[0] == "torch"
                    and parts[1] in _TORCH_SAMPLERS and not has_gen):
                what = "the global torch generator"
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _INPLACE_SAMPLERS
                  and not has_gen):
                what = "the global torch generator"
            elif (d.startswith(("np.random.", "numpy.random."))
                  or (len(parts) == 2 and parts[0] == "random")):
                if parts[-1] not in _EXPLICIT_GENERATORS or not (
                    node.args or node.keywords
                ):
                    what = "the host's global random state"
            if what:
                out.append(
                    Finding(
                        "PUMI004", path, node.lineno, q,
                        f"{d or ast.unparse(node.func)}() on the move "
                        f"loop draws from {what} — the flux is promised "
                        "bitwise on replay (checkpoint resume, retry "
                        "re-arm); pass generator= or use a seeded "
                        "generator or the keyed counters",
                    )
                )


_DTYPE_CALL_HEADS = frozenset(
    {
        "array",
        "asarray",
        "tensor",
        "as_tensor",
        "zeros",
        "ones",
        "full",
        "empty",
        "arange",
        "astype",
        "to",
        "dtype",
        "zeros_like",
        "ones_like",
        "full_like",
        "empty_like",
    }
)


_DTYPE_DISPATCH_RE = re.compile(
    r"dtype|float64|double|u?int64|u?int32|itemsize|element_size|x64"
)
_DTYPE_NAMES = frozenset({"torch.float32", "torch.float", "torch.float64",
                          "torch.double", "float32", "float64"})


def _in_dtype_dispatch(parents, node) -> bool:
    """True when the usage sits under an ``if``/ternary whose test is a
    dtype/carrier-width dispatch (``if dtype == torch.float64:``,
    ``... if rec.element_size() == 4 else ...``) — the codebase's
    sanctioned pattern for dtype-polymorphic helpers, where the float64
    branch only executes for float64 configs. A dict literal that maps
    both float widths (``{torch.float32: "f32", torch.float64: "f64"}``)
    is the same dispatch as a table."""
    cur = node
    while cur is not None:
        if isinstance(cur, ast.Dict):
            names = {_dotted(k) or _const_str(k)
                     for k in list(cur.keys) + list(cur.values)
                     if k is not None}
            if len(names & _DTYPE_NAMES) >= 2:
                return True
        if isinstance(cur, (ast.If, ast.IfExp)):
            try:
                if _DTYPE_DISPATCH_RE.search(ast.unparse(cur.test)):
                    return True
            except Exception:
                pass
        cur = parents.get(cur)
    return False


def _rule_f64(index: PackageIndex, out: list[Finding]):
    """PUMI005 — float64 stays off the card's float32 path.

    Rationale: the float32 configurations must stay float64-free on the
    card (H100's float64 rate is half its float32 rate outside the
    tensor cores, and a float64 temporary doubles the bytes); the shadow
    audit (``integrity/audit.py``) is the one sanctioned float64
    surface. A float64 configuration reaches float64 through a dtype
    dispatch, never through a constant.
    Example finding: ``acc = torch.zeros(n, dtype=torch.float64)`` on a
    path every configuration runs.
    Fix pattern: take the dtype from the configuration (``cfg.dtype``,
    the flux's dtype), or put the float64 branch under a dtype dispatch
    (``if dtype == torch.float64:``).
    """
    for path, mod in index.modules.items():
        if path in F64_EXEMPT_MODULES:
            continue
        # torch.float64 / torch.double / .double() anywhere in the
        # package (a device dtype by construction); "float64" literals
        # only in the move loop's device-op modules. np.float64 is a
        # host dtype here: a numpy array reaches the card only through a
        # torch call, which names its dtype.
        for node in ast.walk(mod.tree):
            d = None
            if isinstance(node, ast.Attribute):
                d = _dotted(node)
                if d not in ("torch.float64", "torch.double"):
                    d = None
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "double" and not node.args):
                d = ".double()"
            if d is None or _in_dtype_dispatch(index.parents[path], node):
                continue
            out.append(
                Finding(
                    "PUMI005",
                    path,
                    node.lineno,
                    index.enclosing_symbol(path, node),
                    f"{d} makes a float64 tensor — the float32 "
                    "configurations must stay float64-free on the card "
                    "(integrity/audit.py is the sanctioned float64 "
                    "surface)",
                )
            )
    for (path, q), fn in index.defs.items():
        if (path in F64_EXEMPT_MODULES or (path, q) not in index.move_loop
                or not _in_move_loop_scope(path)):
            continue
        for node in _walk_shallow(fn):
            if _in_dtype_dispatch(index.parents[path], node):
                continue
            if isinstance(node, ast.Call):
                d = _dotted(node.func) or ""
                if d.split(".")[-1] not in _DTYPE_CALL_HEADS:
                    continue
                for a in list(node.args) + [
                    kw.value for kw in node.keywords
                ]:
                    if _const_str(a) == "float64":
                        out.append(
                            Finding(
                                "PUMI005", path, node.lineno, q,
                                f'"float64" dtype literal in '
                                f"{d}() on the move loop",
                            )
                        )


# --------------------------------------------------------------------- #
# PUMI007: # guarded by: <lock> concurrency lint
# --------------------------------------------------------------------- #
def _guard_annotations(mod: Module):
    """Map line number → lock expression for every ``# guarded by:``
    comment in the module; the callers associate each with the
    assignment statement on that line (a ``self.X = ...`` attribute or,
    with the ``(event)`` suffix, a guarded local)."""
    annotated_lines: dict[int, str] = {}
    for lineno, comment in mod.comments.items():
        m = _GUARD_RE.search(comment)
        if m:
            annotated_lines[lineno] = m.group("lock").strip()
    return annotated_lines


def _with_lock_stack(parents, node) -> list[str]:
    """Lock expressions of every enclosing ``with`` block."""
    locks = []
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.With):
            for item in cur.items:
                try:
                    locks.append(ast.unparse(item.context_expr))
                except Exception:
                    pass
        cur = parents.get(cur)
    return locks


def _class_attr_guards(mod: Module, cls: ast.ClassDef) -> dict[str, str]:
    """``self.<attr>`` → lock expression for every annotated attribute
    assignment inside ``cls`` (shared by PUMI007's enforcement and
    PUMI010's is-it-annotated-at-all check)."""
    annotated = _guard_annotations(mod)
    attr_guards: dict[str, str] = {}
    if not annotated:
        return attr_guards
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        lock = annotated.get(node.lineno)
        if lock is None:
            continue
        targets = (
            node.targets
            if isinstance(node, ast.Assign)
            else [node.target]
        )
        for t in targets:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                attr_guards[t.attr] = lock
    return attr_guards


def _rule_guarded_by(index: PackageIndex, out: list[Finding]):
    """PUMI007 — declared lock protocols, enforced.

    Rationale: the threaded surface (FlightRecorder, HostStager,
    exporter, watchdog) declares its discipline as ``# guarded by:
    <lock>`` comments; an access outside ``with <lock>:`` is a data
    race a test only sees when the interleaving cooperates.
    Example finding: ``self._records`` annotated ``# guarded by:
    self._lock`` appended without the lock held.
    Fix pattern: wrap the access in ``with <lock>:`` (or, for
    event-guarded handoffs, add the missing ``set()``/``wait()`` edge).
    """
    for path, mod in index.modules.items():
        annotated = _guard_annotations(mod)
        if not annotated:
            continue
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            attr_guards = _class_attr_guards(mod, cls)
            if attr_guards:
                _check_attr_guards(
                    index, path, cls, attr_guards, out
                )
        # Event-guarded locals: annotations on plain local assignments
        # inside any function ("<name> (event)").
        for fn_key, fn in index.defs.items():
            if fn_key[0] != path:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                lock = annotated.get(node.lineno)
                if lock is None or not _EVENT_SUFFIX_RE.search(lock):
                    continue
                event = _EVENT_SUFFIX_RE.sub("", lock).strip()
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        _check_event_guard(
                            index, path, fn_key[1], fn, t.id,
                            event, node.lineno, out,
                        )


def _check_attr_guards(index, path, cls, attr_guards, out):
    parents = index.parents[path]
    for method in cls.body:
        if not isinstance(
            method, (ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            continue
        if method.name in ("__init__", "__del__"):
            # Construction precedes thread visibility; finalizers run
            # after every worker is joined.
            continue
        q = index.qualname(path, method)
        for node in ast.walk(method):
            if not (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in attr_guards
            ):
                continue
            lock = attr_guards[node.attr]
            held = _with_lock_stack(parents, node)
            if lock not in held:
                out.append(
                    Finding(
                        "PUMI007",
                        path,
                        node.lineno,
                        q,
                        f"self.{node.attr} is annotated "
                        f"'# guarded by: {lock}' but is accessed "
                        f"outside 'with {lock}:'",
                    )
                )


def _check_event_guard(index, path, q, fn, local, event, ann_line, out):
    """Writes to ``local`` inside nested defs must also call
    ``<event>.set()`` there; reads of ``local`` in the outer body must
    come after an ``<event>.wait(...)`` call."""
    nested = [
        n
        for n in ast.walk(fn)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and n is not fn
    ]
    in_nested = set()
    for nf in nested:
        for sub in ast.walk(nf):
            in_nested.add(id(sub))

    def writes_local(node):
        if isinstance(node, ast.Subscript) and isinstance(
            node.value, ast.Name
        ):
            return (
                node.value.id == local
                and isinstance(node.ctx, ast.Store)
            )
        return (
            isinstance(node, ast.Name)
            and node.id == local
            and isinstance(node.ctx, ast.Store)
        )

    def calls(tree, dotted_suffix):
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                d = _dotted(node.func) or ""
                if d == dotted_suffix:
                    yield node

    for nf in nested:
        if any(writes_local(n) for n in ast.walk(nf)):
            if not any(calls(nf, f"{event}.set")):
                out.append(
                    Finding(
                        "PUMI007",
                        path,
                        nf.lineno,
                        q,
                        f"worker '{nf.name}' writes "
                        f"'{local}' (guarded by {event}) without "
                        f"calling {event}.set() — the reader's "
                        "happens-before edge is missing",
                    )
                )
    wait_lines = [
        c.lineno
        for c in calls(fn, f"{event}.wait")
        if id(c) not in in_nested
    ]
    first_wait = min(wait_lines) if wait_lines else None
    for node in ast.walk(fn):
        if id(node) in in_nested or not isinstance(node, ast.Name):
            continue
        if (
            node.id == local
            and isinstance(node.ctx, ast.Load)
            and node.lineno > ann_line
            and (first_wait is None or node.lineno <= first_wait)
        ):
            out.append(
                Finding(
                    "PUMI007",
                    path,
                    node.lineno,
                    q,
                    f"'{local}' (guarded by {event}) read before "
                    f"{event}.wait(...) — the worker may still be "
                    "writing it",
                )
            )


# --------------------------------------------------------------------- #
# Shared layer-4 machinery: raw-write classification + reachability
# --------------------------------------------------------------------- #
#: Write heads that serialize straight to a path: head dotted name →
#: index of the file/path argument.
_RAW_WRITE_HEADS = {
    "np.save": 0, "numpy.save": 0,
    "np.savez": 0, "numpy.savez": 0,
    "np.savez_compressed": 0, "numpy.savez_compressed": 0,
    "np.savetxt": 0, "numpy.savetxt": 0,
    "json.dump": 1, "pickle.dump": 1,
}
_PATH_WRITE_ATTRS = frozenset({"write_text", "write_bytes"})


def _open_mode(call: ast.Call) -> str | None:
    mode = None
    if len(call.args) >= 2:
        mode = _const_str(call.args[1])
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = _const_str(kw.value)
    return mode


def _scope_file_bindings(nodes) -> tuple[set[str], set[str]]:
    """(names bound from ``open(...)``, names bound from in-memory
    buffers like ``io.BytesIO()``/``StringIO()``) within one scope —
    derivative writes through them are attributed to the ``open`` (or
    are in-memory and durable-irrelevant), not double-reported."""
    opened: set[str] = set()
    buffers: set[str] = set()
    def note(name, value):
        if not isinstance(value, ast.Call):
            return
        d = _dotted(value.func) or ""
        last = d.split(".")[-1]
        if last in ("open", "fdopen"):
            opened.add(name)
        elif last in ("BytesIO", "StringIO"):
            buffers.add(name)
    for node in nodes:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    note(t.id, node.value)
        elif isinstance(node, ast.withitem):
            if isinstance(node.optional_vars, ast.Name):
                note(node.optional_vars.id, node.context_expr)
        elif isinstance(node, ast.With):
            for item in node.items:
                if isinstance(item.optional_vars, ast.Name):
                    note(item.optional_vars.id, item.context_expr)
    return opened, buffers


def raw_write_head(call: ast.Call, opened: set[str],
                   buffers: set[str]) -> str | None:
    """Classify one call as a raw persistent write; returns the head
    description, or None.  ``opened``/``buffers`` are the scope's file
    bindings (``_scope_file_bindings``): writes through an already-
    reported ``open`` handle or into an in-memory buffer are skipped."""
    d = _dotted(call.func)
    if d is None:
        return None
    last = d.split(".")[-1]
    if last == "open" and d in ("open", "io.open"):
        mode = _open_mode(call)
        if mode is not None and any(c in mode for c in "wax"):
            return f'open(..., "{mode}")'
        return None
    if d in _RAW_WRITE_HEADS:
        i = _RAW_WRITE_HEADS[d]
        arg = call.args[i] if len(call.args) > i else None
        if isinstance(arg, ast.Name) and arg.id in (opened | buffers):
            return None
        if isinstance(arg, ast.Call):
            inner = (_dotted(arg.func) or "").split(".")[-1]
            if inner in ("open", "fdopen", "BytesIO", "StringIO"):
                # json.dump(obj, open(p, "w")) is ONE write — the
                # inline open reports it (or it's an in-memory buffer).
                return None
        return f"{d}()"
    if isinstance(call.func, ast.Attribute) and (
        call.func.attr in _PATH_WRITE_ATTRS
    ):
        return f".{call.func.attr}()"
    return None


def _enclosing_class(index: PackageIndex, path, node) -> ast.ClassDef | None:
    cur = node
    parent = index.parents[path]
    while cur is not None:
        cur = parent.get(cur)
        if isinstance(cur, ast.ClassDef):
            return cur
    return None


def _class_method(cls: ast.ClassDef | None, name: str):
    if cls is None:
        return None
    for stmt in cls.body:
        if isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
        ) and stmt.name == name:
            return stmt
    return None


def _resolve_callable(index: PackageIndex, path, expr, cls,
                      local_env=None):
    """Resolve a callable expression to (path, fn_node, class) — a
    ``self.X`` method of ``cls``, a local/module def, or an imported
    package def.  None when not statically resolvable."""
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        m = _class_method(cls, expr.attr)
        return (path, m, cls) if m is not None else None
    key = index._resolve(path, expr, local_env)
    if key and key[0] == "def@":
        fn = index.defs.get((key[1], key[2]))
        if fn is not None:
            return (key[1], fn, _enclosing_class(index, key[1], fn))
    return None


def _reachable_callables(index: PackageIndex, start):
    """Transitive closure of statically-resolvable calls from ``start``
    = (path, fn_node, class): self-methods, module defs, and imported
    package defs.  The layer-4 rules walk this instead of the move-loop
    closure — signal handlers and thread workers are HOST code."""
    seen: dict = {}
    stack = [start]
    while stack:
        path, fn, cls = stack.pop()
        qkey = (path, index.qualname(path, fn))
        if qkey in seen:
            continue
        seen[qkey] = (path, fn, cls)
        local = index._local_defs_env(path, fn)
        local.update(index._fn_import_env(path, fn))
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                r = _resolve_callable(index, path, node.func, cls, local)
                if r is not None:
                    stack.append(r)
    return list(seen.values())


# --------------------------------------------------------------------- #
# PUMI008: raw persistent writes outside the atomic-write modules
# --------------------------------------------------------------------- #
def _rule_raw_durable_write(index: PackageIndex, out: list[Finding]):
    """PUMI008 — durable state must ride the atomic writers.

    Rationale: the crash-safety layer (journal, two-phase checkpoints,
    library bank) is built on tmp+fsync+rename writes; a raw
    ``open(..., "w")`` / ``np.save`` / ``json.dump`` / ``Path.write_*``
    anywhere else can leave a TORN file under the real name on
    crash/ENOSPC — and a restart then reads garbage where the recovery
    path expected committed state.
    Example finding: ``json.dump(state, open(path, "w"))`` in a module
    outside utils/checkpoint.py, serving/journal.py, serving/bank.py,
    resilience/store.py, tuning/db.py.
    Fix pattern: route the write through
    ``utils.checkpoint.atomic_write_bytes`` / ``atomic_savez`` (or
    baseline a genuinely one-shot, re-creatable export with a
    justification).
    """
    def scan_scope(path, nodes, symbol_of):
        opened, buffers = _scope_file_bindings(nodes)
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            head = raw_write_head(node, opened, buffers)
            if head is None:
                continue
            out.append(
                Finding(
                    "PUMI008", path, node.lineno, symbol_of(node),
                    f"{head} outside the approved atomic-write modules "
                    "— a raw write can tear under crash/ENOSPC; route "
                    "durable state through utils/checkpoint.py's "
                    "atomic writers (tmp+fsync+rename), or baseline a "
                    "one-shot re-creatable export with a justification",
                )
            )

    for path, mod in index.modules.items():
        if path in APPROVED_DURABLE_MODULES:
            continue
        # Module-level statements, plus class-body statements (run at
        # import time); defs are scanned below through index.defs.
        scan_scope(
            path, list(_walk_shallow(mod.tree)),
            lambda node, path=path: index.enclosing_symbol(path, node),
        )
        for cls in ast.walk(mod.tree):
            if isinstance(cls, ast.ClassDef):
                scan_scope(
                    path, list(_walk_shallow(cls)),
                    lambda node, path=path: index.enclosing_symbol(
                        path, node
                    ),
                )
    for (path, q), fn in index.defs.items():
        if path in APPROVED_DURABLE_MODULES:
            continue
        scan_scope(path, list(_walk_shallow(fn)), lambda node, q=q: q)


# --------------------------------------------------------------------- #
# PUMI009: signal-handler safety
# --------------------------------------------------------------------- #
def _handler_has_deferral_guard(handler_fn) -> bool:
    """The sanctioned mid-dispatch idiom: an ``if`` that parks the
    signum (``self._pending_signal = signum``) and returns, so the
    flush runs at a consistent quantum/move boundary instead of inside
    a half-completed dispatch."""
    params = [
        a.arg
        for a in list(handler_fn.args.posonlyargs)
        + list(handler_fn.args.args)
        if a.arg not in ("self", "cls")
    ]
    signum = params[0] if params else None
    if signum is None:
        return False
    for node in ast.walk(handler_fn):
        if not isinstance(node, ast.If):
            continue
        body_nodes = [n for s in node.body for n in ast.walk(s)]
        stores = any(
            isinstance(n, ast.Assign)
            and isinstance(n.value, ast.Name)
            and n.value.id == signum
            and any(
                isinstance(t, (ast.Attribute, ast.Name))
                for t in n.targets
            )
            for n in body_nodes
        )
        returns = any(isinstance(n, ast.Return) for n in body_nodes)
        if stores and returns:
            return True
    return False


def _rule_signal_handler_safety(index: PackageIndex, out: list[Finding]):
    """PUMI009 — preemption-signal handlers stay async-signal-safe.

    Rationale: a SIGTERM/SIGINT handler interrupts the main thread at
    an ARBITRARY bytecode boundary.  Flushing the journal from there
    without the deferral guard can interleave with a half-finished
    flush on the interrupted frame; taking a ``# guarded by:`` lock
    can deadlock against the thread it interrupted; launching the move
    loop's device work can wedge inside the CUDA runtime.  And an install
    without a matching uninstall leaves a STALE handler that a later
    signal routes into a dead supervisor (the stale-handler clobber).
    Example finding: a handler reachable from
    ``install_preemption_handlers`` calling ``self._flush_journal()``
    with no ``if self._in_step: self._pending_signal = signum; return``
    guard.
    Fix pattern: add the deferral guard (park the signum, flush at the
    next quantum/move boundary); keep locks and the move loop out of
    handler-reachable code; pair every install with an uninstall on
    every exit path, uninstalling before chaining the previous handler.
    """
    locks_by_module = {
        path: {
            lock
            for lock in _guard_annotations(mod).values()
            if not _EVENT_SUFFIX_RE.search(lock)
        }
        for path, mod in index.modules.items()
    }

    def calls_uninstall(fn, cls) -> bool:
        """Direct uninstall, or one level through a self-method."""
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func) or ""
            last = d.split(".")[-1]
            if last == "uninstall_preemption_handlers":
                return True
            if (
                isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"
            ):
                m = _class_method(cls, node.func.attr)
                if m is not None and any(
                    isinstance(n, ast.Call)
                    and (_dotted(n.func) or "").split(".")[-1]
                    == "uninstall_preemption_handlers"
                    for n in ast.walk(m)
                ):
                    return True
        return False

    for path, mod in index.modules.items():
        if path == f"{PACKAGE}/utils/signals.py":
            continue  # the plumbing itself, not a supervisor
        for node in ast.walk(mod.tree):
            if not (
                isinstance(node, ast.Call)
                and (_dotted(node.func) or "").split(".")[-1]
                == "install_preemption_handlers"
            ):
                continue
            cls = _enclosing_class(index, path, node)
            install_symbol = index.enclosing_symbol(path, node)
            # Matching uninstall must exist in the installing scope.
            scope = cls if cls is not None else mod.tree
            if not any(
                isinstance(n, ast.Call)
                and (_dotted(n.func) or "").split(".")[-1]
                == "uninstall_preemption_handlers"
                for n in ast.walk(scope)
            ):
                out.append(
                    Finding(
                        "PUMI009", path, node.lineno, install_symbol,
                        "install_preemption_handlers without any "
                        "matching uninstall_preemption_handlers in "
                        f"{'class ' + cls.name if cls else 'the module'}"
                        " — the handler outlives its supervisor and a "
                        "later signal routes into dead state",
                    )
                )
            handler_expr = node.args[0] if node.args else None
            if handler_expr is None:
                continue
            resolved = _resolve_callable(
                index, path, handler_expr, cls
            )
            if resolved is None:
                continue
            handler_fn = resolved[1]
            guarded = _handler_has_deferral_guard(handler_fn)
            for p2, fn, cls2 in _reachable_callables(index, resolved):
                q2 = index.qualname(p2, fn)
                for sub in ast.walk(fn):
                    if isinstance(sub, ast.With):
                        for item in sub.items:
                            try:
                                expr = ast.unparse(item.context_expr)
                            except Exception:
                                continue
                            if expr in locks_by_module.get(p2, ()):
                                out.append(
                                    Finding(
                                        "PUMI009", p2, sub.lineno, q2,
                                        f"signal-handler path takes "
                                        f"'{expr}' (a '# guarded by:' "
                                        "lock) — the interrupted "
                                        "thread may hold it: deadlock",
                                    )
                                )
                    if not isinstance(sub, ast.Call):
                        continue
                    d = _dotted(sub.func) or ""
                    last = d.split(".")[-1]
                    if (
                        last == "_flush_journal"
                        or d.endswith("journal.flush")
                    ) and not guarded:
                        out.append(
                            Finding(
                                "PUMI009", p2, sub.lineno, q2,
                                "signal-handler path flushes the "
                                "journal but the installed handler "
                                "has no mid-dispatch deferral guard "
                                "(park the signum and flush at the "
                                "next quantum/move boundary)",
                            )
                        )
                    local = index._local_defs_env(p2, fn)
                    local.update(index._fn_import_env(p2, fn))
                    key = index._resolve(p2, sub.func, local)
                    if (
                        key is not None
                        and key[0] == "def@"
                        and (key[1], key[2]) in index.move_loop
                    ):
                        out.append(
                            Finding(
                                "PUMI009", p2, sub.lineno, q2,
                                f"signal-handler path calls '{d}' "
                                "which launches the move loop's device "
                                "work — a handler wedged inside the "
                                "runtime cannot be recovered",
                            )
                        )
                    if last == "resume_previous_handler" and (
                        not calls_uninstall(fn, cls2)
                    ):
                        out.append(
                            Finding(
                                "PUMI009", p2, sub.lineno, q2,
                                "resume_previous_handler without "
                                "uninstalling this supervisor's "
                                "handlers first — dying through the "
                                "chain leaves a stale handler "
                                "installed for the next signal",
                            )
                        )


# --------------------------------------------------------------------- #
# PUMI010: thread-shared state without a guard annotation
# --------------------------------------------------------------------- #
def _thread_entry_points(index: PackageIndex):
    """(path, target_def, class) for every statically-resolvable
    ``threading.Thread(target=...)`` and executor ``submit``/``map``
    worker."""
    entries = []
    for (path, q), fn in index.defs.items():
        shallow = list(_walk_shallow(fn))
        executors = set()
        for node in shallow:
            if isinstance(node, ast.Assign):
                if isinstance(node.value, ast.Call) and (
                    _dotted(node.value.func) or ""
                ).split(".")[-1] == "ThreadPoolExecutor":
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            executors.add(t.id)
            elif isinstance(node, ast.With):
                for item in node.items:
                    if (
                        isinstance(item.context_expr, ast.Call)
                        and (_dotted(item.context_expr.func) or "")
                        .split(".")[-1] == "ThreadPoolExecutor"
                        and isinstance(
                            item.optional_vars, ast.Name
                        )
                    ):
                        executors.add(item.optional_vars.id)
        cls = _enclosing_class(index, path, fn)
        local = index._local_defs_env(path, fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func) or ""
            last = d.split(".")[-1]
            target_expr = None
            if last == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        target_expr = kw.value
            elif (
                last in ("submit", "map")
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in executors
                and node.args
            ):
                target_expr = node.args[0]
            if target_expr is None:
                continue
            resolved = _resolve_callable(
                index, path, target_expr, cls, local
            )
            if resolved is not None:
                entries.append(resolved)
    return entries


def _rule_thread_shared_state(index: PackageIndex, out: list[Finding]):
    """PUMI010 — thread-shared state must be annotated.

    Rationale: PUMI007 enforces the lock discipline of ANNOTATED
    state; state a worker thread writes WITHOUT an annotation is
    invisible to it — the inference gap a racing write slips through.
    Anything written from code reachable from a ``threading.Thread``
    target (or an executor worker) must either carry ``# guarded by:
    <lock>`` (PUMI007 then enforces the lock) or be provably
    thread-confined (local to the worker).
    Example finding: a watchdog worker writing ``self._last_beat``
    when no assignment of ``_last_beat`` is annotated.
    Fix pattern: annotate the attribute's assignment with
    ``# guarded by: <lock>`` and take that lock at every access — or
    restructure so the worker publishes through an Event-guarded
    handoff (PUMI007's ``(event)`` form).
    """
    for resolved in _thread_entry_points(index):
        tpath, tfn, _tcls = resolved
        # Worker closures: stores to enclosing-scope locals need the
        # event-guard annotation (or any guard comment on the line
        # that binds them in the enclosing function).
        parents = index.parents[tpath]
        encl = parents.get(tfn)
        while encl is not None and not isinstance(
            encl, (ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            encl = parents.get(encl)
        outer_names: dict[str, bool] = {}  # name -> annotated?
        if encl is not None:
            mod = index.modules[tpath]
            annotated_lines = _guard_annotations(mod)
            for node in _walk_shallow(encl):
                if isinstance(node, ast.Assign):
                    ann = node.lineno in annotated_lines
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            outer_names[t.id] = (
                                outer_names.get(t.id, False) or ann
                            )
        for p2, fn, cls2 in _reachable_callables(index, resolved):
            q2 = index.qualname(p2, fn)
            if q2.split(".")[-1] == "__init__":
                continue
            mod2 = index.modules[p2]
            guards = (
                _class_attr_guards(mod2, cls2)
                if cls2 is not None else {}
            )
            # A plain-name rebind in the worker creates a WORKER-LOCAL
            # unless the worker declares it nonlocal — only then (or on
            # subscript mutation, which reads the closure cell) is the
            # enclosing function's state actually shared.
            nonlocals = {
                name
                for sub in ast.walk(fn)
                if isinstance(sub, ast.Nonlocal)
                for name in sub.names
            }
            for node in ast.walk(fn):
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AugAssign):
                    targets = [node.target]
                for t in targets:
                    base = t
                    shares_cell = False
                    if isinstance(base, ast.Subscript):
                        base = base.value
                        shares_cell = True  # mutates the shared object
                    elif isinstance(base, ast.Name):
                        shares_cell = base.id in nonlocals
                    if (
                        isinstance(base, ast.Attribute)
                        and isinstance(base.value, ast.Name)
                        and base.value.id == "self"
                        and base.attr not in guards
                    ):
                        out.append(
                            Finding(
                                "PUMI010", p2, t.lineno, q2,
                                f"self.{base.attr} is written on a "
                                "thread-worker path but carries no "
                                "'# guarded by:' annotation — "
                                "annotate it (PUMI007 then enforces "
                                "the lock) or make it worker-local",
                            )
                        )
                    elif (
                        p2 == tpath
                        and fn is tfn
                        and encl is not None
                        and isinstance(base, ast.Name)
                        and shares_cell
                        and isinstance(
                            getattr(t, "ctx", ast.Store()), ast.Store
                        )
                        and outer_names.get(base.id) is False
                    ):
                        out.append(
                            Finding(
                                "PUMI010", p2, t.lineno, q2,
                                f"worker closure writes '{base.id}' "
                                "shared with the enclosing function "
                                "but no '# guarded by:' annotation "
                                "covers it — declare the handoff "
                                "(e.g. '# guarded by: <event> "
                                "(event)') so PUMI007 can check the "
                                "happens-before edge",
                            )
                        )


# --------------------------------------------------------------------- #
# PUMI011: swallowed retryable exceptions
# --------------------------------------------------------------------- #
_RETRYABLE_EXC_NAMES = frozenset(
    {
        "RETRYABLE",
        "InjectedTransientFault",
        "TransientIntegrityViolation",
        "DispatchTimeoutError",
        "JaxRuntimeError",
        "_JaxRuntimeError",
    }
)


def _rule_swallowed_retryable(index: PackageIndex, out: list[Finding]):
    """PUMI011 — retryable failures must stay visible.

    Rationale: the resilience layer's whole contract is that
    RETRYABLE / ``Transient*`` errors are CLASSIFIED and replayed (or
    counted) — an ``except`` that silently absorbs one erases the
    signal: no retry, no rollback, no metric, and the chaos campaigns
    can no longer prove the failure was handled.
    Example finding: ``except InjectedTransientFault: pass``.
    Fix pattern: re-raise after local cleanup, route the exception
    through ``ResilienceCoordinator.classify`` and act on the verdict,
    or count the deliberate swallow into a ``pumi_*`` metric
    (``counter.inc(...)``) inside a bounded retry loop.
    """
    for path, mod in index.modules.items():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                continue
            names = {
                (sub.id if isinstance(sub, ast.Name) else sub.attr)
                for sub in ast.walk(node.type)
                if isinstance(sub, (ast.Name, ast.Attribute))
            }
            retryable = {
                n
                for n in names
                if n in _RETRYABLE_EXC_NAMES
                or n.startswith("Transient")
            }
            if not retryable:
                continue
            body_nodes = [
                n for s in node.body for n in ast.walk(s)
            ]
            reraises = any(
                isinstance(n, ast.Raise) for n in body_nodes
            )
            classifies = any(
                isinstance(n, ast.Call)
                and (_dotted(n.func) or "").split(".")[-1]
                == "classify"
                for n in body_nodes
            )
            counts = any(
                isinstance(n, ast.Call)
                and (_dotted(n.func) or "").split(".")[-1] == "inc"
                for n in body_nodes
            )
            if not (reraises or classifies or counts):
                out.append(
                    Finding(
                        "PUMI011", path, node.lineno,
                        index.enclosing_symbol(path, node),
                        f"except clause catches retryable "
                        f"{sorted(retryable)} and swallows it — "
                        "re-raise, route through "
                        "ResilienceCoordinator.classify, or count "
                        "the deliberate swallow into a pumi_* "
                        "metric inside a bounded loop",
                    )
                )


# --------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------- #
_RULES = (
    _rule_host_sync,
    _rule_transfers,
    _rule_global_rng,
    _rule_f64,
    _rule_guarded_by,
    _rule_raw_durable_write,
    _rule_signal_handler_safety,
    _rule_thread_shared_state,
    _rule_swallowed_retryable,
)


def lint_index(index: PackageIndex) -> list[Finding]:
    """Run every rule over an already-built index (shared with the
    protocol layer by the runner, so one full run parses the tree and
    closes the move loop exactly once)."""
    out: list[Finding] = []
    for rule in _RULES:
        rule(index, out)

    def keep(f: Finding) -> bool:
        subset = rules_for_path(f.path)
        return subset is None or f.rule in subset

    out = [f for f in out if keep(f)]
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def lint_sources(sources: dict[str, str]) -> list[Finding]:
    """Lint a {relpath: source} mapping (the test fixtures' entry).

    Entry-point modules participate fully in the index and the move-loop
    closure, but only their subset's findings are reported
    (``rules_for_path``)."""
    modules = {p: _parse(p, s) for p, s in sources.items()}
    return lint_index(PackageIndex(modules))


def collect_sources(root) -> dict[str, str]:
    """{relpath: source} for the linted tree: the port's package
    (shared with :mod:`analysis.protolint`, which builds its index over
    the same file set)."""
    root = Path(root)
    sources = {}
    for p in sorted((root / PACKAGE).rglob("*.py")):
        rel = p.relative_to(root).as_posix()
        sources[rel] = p.read_text()
    return sources


def lint_package(root) -> list[Finding]:
    """Lint every module of the port under ``root`` (the repo checkout:
    ``root/pumiumtally_tpu_torch/**/*.py``), entry points under their
    ``rules_for_path`` subsets."""
    return lint_sources(collect_sources(root))


#: Rule id → rule function; ``explain`` renders the docstring
#: (rationale / example finding / fix pattern) for self-serve CI
#: failures via ``python -m pumiumtally_tpu_torch.analysis --explain
#: <RULE>``.
RULES_BY_ID = {
    "PUMI001": _rule_host_sync,
    "PUMI002": _rule_transfers,
    "PUMI004": _rule_global_rng,
    "PUMI005": _rule_f64,
    "PUMI007": _rule_guarded_by,
    "PUMI008": _rule_raw_durable_write,
    "PUMI009": _rule_signal_handler_safety,
    "PUMI010": _rule_thread_shared_state,
    "PUMI011": _rule_swallowed_retryable,
}

#: One-line summaries for rules whose functions predate the structured
#: docstrings — ``explain`` falls back to the module docstring's
#: catalogue entry for these.
_MODULE_DOC_RULES = re.compile(
    r"^  (?P<rule>PUMI\d{3}) .*?(?=^  PUMI|\Z)", re.M | re.S
)


def explain(rule: str) -> str | None:
    """Human-readable rationale + example + fix pattern for one rule
    id, pulled from the rule function's docstring (falling back to the
    module docstring's catalogue entry).  None for unknown rules."""
    rule = rule.strip().upper()
    fn = RULES_BY_ID.get(rule)
    if fn is None:
        return None
    import textwrap

    doc = fn.__doc__ or ""
    first, _, rest = doc.partition("\n")
    doc = (first.strip() + "\n" + textwrap.dedent(rest)).strip()
    if "Rationale" in doc:
        return f"{rule}\n{doc}"
    for m in _MODULE_DOC_RULES.finditer(__doc__ or ""):
        if m.group("rule") == rule:
            return textwrap.dedent(m.group(0)).strip()
    return f"{rule}\n{doc}"
