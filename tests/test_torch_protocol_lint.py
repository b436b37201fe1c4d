"""The port's durability and concurrency lint: the layer-4 AST rules
(PUMI008..PUMI011 in ``pumiumtally_tpu_torch/analysis/astlint.py``) and
the effect-ordering protocol analyzer (``analysis/protolint.py``).

Mirrors tests/test_protocol_lint.py case by case:

  * each layer-4 rule fires on its positive fixture and stays quiet on
    the sanctioned idiom beside it;
  * the protocols hold on the port's real tree, and the injected
    regressions on the port's own source text (the ``_finish`` reorder,
    the stale-handler clobber, the early manifest commit, the raw journal
    flush, the reordered eviction record, the stripped deferral guard)
    each give their named finding; the path cap, a missing owner, the
    capture's drift and cross-environment refusal, the committed
    PROTOCOLS_TORCH.json against the declarations, the runner with
    --protocols-only, and --explain.

Against the JAX package: the same fixtures go through both packages'
lints (under each package's paths), and PUMI008..PUMI011 and every
protocol give the same findings; PROTOCOLS_TORCH.json declares the same
15 protocols with the same constraints and effect inventories as
PROTOCOLS.json but for the one departure the port makes, which
``test_committed_protocols_match_the_jax_capture`` names: the scheduler's
``_preempt`` may skip its save when the job's checkpoint on disk is
already this boundary's (``checkpoint.current``).

Left out: nothing of test_protocol_lint.py. Its ``slow``-marked runner
cases run here unmarked, in this process, on one parse of the tree.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from pumiumtally_tpu_torch.analysis import (
    Finding,
    apply_baseline,
    load_baseline,
)
from pumiumtally_tpu_torch.analysis import __main__ as runner
from pumiumtally_tpu_torch.analysis import astlint as A
from pumiumtally_tpu_torch.analysis import protolint as P
from pumiumtally_tpu_torch.analysis.astlint import explain, lint_sources

ROOT = Path(__file__).resolve().parents[1]
PKG = "pumiumtally_tpu_torch"
BASELINE = ROOT / "LINT_BASELINE_TORCH.json"


def at(findings, rule):
    return [f for f in findings if f.rule == rule]


def both_lints(sources: dict, only: str | None = None):
    """(rule, line, symbol) of the JAX lint and of the port's on the same
    {relpath-in-package: source} fixtures, for the findings in ``only``
    (a relpath) or in every fixture."""
    from pumiumtally_tpu.analysis.astlint import lint_sources as jax_lint

    def key(fs, pkg):
        return sorted((f.rule, f.line, f.symbol) for f in fs
                      if only is None or f.path == f"{pkg}/{only}")

    jax = jax_lint({f"pumiumtally_tpu/{r}": s for r, s in sources.items()})
    port = lint_sources({f"{PKG}/{r}": s for r, s in sources.items()})
    return key(jax, "pumiumtally_tpu"), key(port, PKG)


# --------------------------------------------------------------------- #
# PUMI008: raw durable writes
# --------------------------------------------------------------------- #
_RAW_WRITE = """
import json

def persist(path, state):
    with open(path, "w") as fh:
        json.dump(state, fh)
"""

_BYTESIO = """
import io
import numpy as np

def pack(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()
"""

_SAVE_AND_TEXT = """
import numpy as np

def persist(path, arr, meta):
    np.save(path, arr)
    path.write_text(meta)
"""

_INLINE_OPEN = """
import json

def persist(path, state):
    json.dump(state, open(path, "w"))
"""

_CLASS_BODY = """
import json

class Config:
    _default = json.dump({"x": 1}, open("cfg.json", "w"))
"""

_READ_MODE = """
import json

def load(path):
    with open(path) as fh:
        return json.load(fh)
"""


def test_raw_write_fires_outside_approved_modules():
    fs = lint_sources({f"{PKG}/serving/fake.py": _RAW_WRITE})
    found = at(fs, "PUMI008")
    # ONE finding — the open; the json.dump through the handle is the
    # same write.
    assert len(found) == 1, [f.render() for f in found]
    assert found[0].symbol == "persist"
    assert 'open(..., "w")' in found[0].message


def test_raw_write_quiet_in_approved_module():
    fs = lint_sources({f"{PKG}/serving/journal.py": _RAW_WRITE})
    assert at(fs, "PUMI008") == []


def test_np_save_to_bytesio_is_in_memory_and_clean():
    assert at(lint_sources({f"{PKG}/serving/fake.py": _BYTESIO}),
              "PUMI008") == []


def test_np_save_to_path_and_write_text_fire():
    fs = lint_sources({f"{PKG}/obs/fake.py": _SAVE_AND_TEXT})
    assert len(at(fs, "PUMI008")) == 2


def test_inline_open_oneliner_reports_once():
    found = at(lint_sources({f"{PKG}/serving/fake.py": _INLINE_OPEN}),
               "PUMI008")
    assert len(found) == 1, [f.render() for f in found]
    assert 'open(..., "w")' in found[0].message


def test_class_body_raw_write_fires():
    fs = lint_sources({f"{PKG}/serving/fake.py": _CLASS_BODY})
    assert len(at(fs, "PUMI008")) == 1, [f.render() for f in fs]


def test_read_mode_open_is_clean():
    assert at(lint_sources({f"{PKG}/serving/fake.py": _READ_MODE}),
              "PUMI008") == []


def test_journal_entry_points_get_durability_rule_others_dont():
    """The port's counterparts of the JAX journal scripts (serve.py,
    chaos_serve.py, chaos_fleet.py) keep PUMI008; the tuner's CLI
    (tune.py's) keeps the value-safety subset only."""
    for rel in ("serving/__main__.py", "chaos/serve.py", "chaos/fleet.py"):
        fs = lint_sources({f"{PKG}/{rel}": _RAW_WRITE})
        assert len(at(fs, "PUMI008")) == 1, rel
    fs = lint_sources({f"{PKG}/tuning/__main__.py": _RAW_WRITE})
    assert at(fs, "PUMI008") == []


# --------------------------------------------------------------------- #
# PUMI009: signal-handler safety
# --------------------------------------------------------------------- #
_HANDLER_TMPL = """
from ..utils.signals import (
    install_preemption_handlers,
    uninstall_preemption_handlers,
    resume_previous_handler,
)

class Supervisor:
    def __init__(self):
        self._in_step = False
        self._pending_signal = None
        self._prev = install_preemption_handlers(self._on_signal, "S")

    def _flush_journal(self):
        pass

    def _on_signal(self, signum, frame):
{guard}        self._flush(signum, frame)

    def _flush(self, signum, frame):
        self._flush_journal()
        uninstall_preemption_handlers(self._prev, mine=self._on_signal)
        resume_previous_handler(self._prev.get(signum), signum, frame)

    def close(self):
        uninstall_preemption_handlers(self._prev, mine=self._on_signal)
"""

_GUARD = (
    "        if self._in_step:\n"
    "            self._pending_signal = signum\n"
    "            return\n"
)

_LOCKED_HANDLER = """
import threading

from ..utils.signals import (
    install_preemption_handlers,
    uninstall_preemption_handlers,
)

class Supervisor:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = 0  # guarded by: self._lock
        self._prev = install_preemption_handlers(self._on_signal, "S")

    def _on_signal(self, signum, frame):
        with self._lock:
            self._state += 1

    def close(self):
        uninstall_preemption_handlers(self._prev, mine=self._on_signal)
"""

_NO_UNINSTALL = """
from ..utils.signals import install_preemption_handlers

class Supervisor:
    def __init__(self):
        self._prev = install_preemption_handlers(self._on_signal, "S")

    def _on_signal(self, signum, frame):
        pass
"""

_RESUME_NO_UNINSTALL = """
from ..utils.signals import (
    install_preemption_handlers,
    uninstall_preemption_handlers,
    resume_previous_handler,
)

class Supervisor:
    def __init__(self):
        self._prev = install_preemption_handlers(self._on_signal, "S")

    def _on_signal(self, signum, frame):
        resume_previous_handler(self._prev.get(signum), signum, frame)

    def close(self):
        uninstall_preemption_handlers(self._prev, mine=self._on_signal)
"""


def _signal_modules(pkg=PKG):
    return {
        f"{pkg}/utils/signals.py": (ROOT / pkg / "utils/signals.py"
                                    ).read_text(),
        f"{pkg}/utils/log.py": (ROOT / pkg / "utils/log.py").read_text(),
    }


def _with_signals(rel, src):
    return lint_sources({**_signal_modules(), f"{PKG}/{rel}": src})


def test_handler_journal_flush_without_deferral_guard_fires():
    fs = _with_signals("serving/fake.py", _HANDLER_TMPL.format(guard=""))
    found = at(fs, "PUMI009")
    assert found, [f.render() for f in fs]
    assert any("deferral guard" in f.message for f in found)


def test_handler_journal_flush_with_deferral_guard_is_clean():
    fs = _with_signals("serving/fake.py", _HANDLER_TMPL.format(guard=_GUARD))
    assert at(fs, "PUMI009") == [], [f.render() for f in fs]


def test_handler_taking_annotated_lock_fires():
    found = at(_with_signals("obs/fake.py", _LOCKED_HANDLER), "PUMI009")
    assert any("deadlock" in f.message for f in found)


def test_install_without_any_uninstall_fires():
    found = at(_with_signals("obs/fake.py", _NO_UNINSTALL), "PUMI009")
    assert any("matching uninstall" in f.message for f in found)


def test_resume_without_uninstall_fires():
    found = at(_with_signals("obs/fake.py", _RESUME_NO_UNINSTALL), "PUMI009")
    assert any("stale handler" in f.message for f in found)


def test_handler_launching_the_move_loop_fires():
    """A handler path that calls into the move loop (the port's stand-in
    for the JAX rule's jit dispatch) is a finding."""
    src = _HANDLER_TMPL.format(guard=_GUARD).replace(
        "    def _flush(self, signum, frame):\n",
        "    def _flush(self, signum, frame):\n"
        "        step(signum)\n",
    ).replace("class Supervisor:", "from ..ops.fake import step\n\n"
              "class Supervisor:")
    facade = ("from .ops.fake import step\n\nclass PumiTally:\n"
              "    def move_to_next_location(self, d):\n"
              "        return step(d)\n")
    fs = lint_sources({**_signal_modules(), f"{PKG}/api.py": facade,
                       f"{PKG}/ops/fake.py": "def step(x):\n    return x\n",
                       f"{PKG}/serving/fake.py": src})
    assert any("move loop" in f.message for f in at(fs, "PUMI009"))


def test_real_scheduler_without_deferral_guard_fires():
    """Injected regression on the port's scheduler: strip the handler's
    mid-quantum deferral — its journal flush becomes a PUMI009 finding."""
    sched = f"{PKG}/serving/scheduler.py"
    srcs = {**_signal_modules(), sched: (ROOT / sched).read_text()}
    guard = (
        "        if self._in_step:\n"
        "            # Mid-quantum: defer to the quantum boundary so the\n"
        "            # flushed checkpoints are consistent post-dispatch states.\n"
        "            self._pending_signal = signum\n"
        "            return\n"
    )
    assert guard in srcs[sched]
    fs = lint_sources({**srcs, sched: srcs[sched].replace(guard, "")})
    assert [f for f in at(fs, "PUMI009") if "deferral" in f.message]
    assert at(lint_sources(srcs), "PUMI009") == []


# --------------------------------------------------------------------- #
# PUMI010: unguarded thread-shared state
# --------------------------------------------------------------------- #
_THREAD_ATTR = """
import threading

class Watcher:
    def __init__(self):
        self._beat = 0
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        self._beat += 1
"""

_THREAD_ATTR_OK = """
import threading

class Watcher:
    def __init__(self):
        self._lock = threading.Lock()
        self._beat = 0  # guarded by: self._lock
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        with self._lock:
            self._beat += 1
"""

_CLOSURE_BAD = """
import threading

def run(fn):
    outcome = {}

    def target():
        outcome["value"] = fn()

    threading.Thread(target=target).start()
    return outcome
"""

_CLOSURE_GOOD = _CLOSURE_BAD.replace(
    "    outcome = {}",
    "    finished = threading.Event()\n"
    "    outcome = {}  # guarded by: finished (event)",
).replace(
    'outcome["value"] = fn()',
    'outcome["value"] = fn()\n        finished.set()',
).replace(
    "    return outcome",
    "    finished.wait(1.0)\n    return outcome",
)

_SHADOW = """
import threading

def run(fn):
    buf = None

    def target():
        buf = []
        buf.append(fn())

    threading.Thread(target=target).start()
    return buf
"""

_NONLOCAL = """
import threading

def run(fn):
    result = None

    def target():
        nonlocal result
        result = fn()

    threading.Thread(target=target).start()
    return result
"""

_EXECUTOR = """
from concurrent.futures import ThreadPoolExecutor

class Sharder:
    def write_all(self, n):
        with ThreadPoolExecutor(max_workers=4) as ex:
            list(ex.map(self._write_one, range(n)))

    def _write_one(self, i):
        self._last_written = i
"""


def test_unannotated_attr_written_from_thread_target_fires():
    found = at(lint_sources({f"{PKG}/obs/fake.py": _THREAD_ATTR}), "PUMI010")
    assert len(found) == 1 and "_beat" in found[0].message


def test_annotated_attr_written_from_thread_target_is_clean():
    assert at(lint_sources({f"{PKG}/obs/fake.py": _THREAD_ATTR_OK}),
              "PUMI010") == []


def test_worker_closure_writing_shared_local_fires_unless_annotated():
    found = at(lint_sources({f"{PKG}/obs/fake.py": _CLOSURE_BAD}), "PUMI010")
    assert len(found) == 1 and "outcome" in found[0].message
    fs = lint_sources({f"{PKG}/obs/fake.py": _CLOSURE_GOOD})
    assert at(fs, "PUMI010") == [], [f.render() for f in fs]


def test_worker_shadowing_local_is_thread_confined_and_clean():
    assert at(lint_sources({f"{PKG}/obs/fake.py": _SHADOW}), "PUMI010") == []


def test_worker_nonlocal_rebind_fires():
    found = at(lint_sources({f"{PKG}/obs/fake.py": _NONLOCAL}), "PUMI010")
    assert len(found) == 1 and "result" in found[0].message


def test_executor_worker_writing_attr_fires():
    found = at(lint_sources({f"{PKG}/obs/fake.py": _EXECUTOR}), "PUMI010")
    assert len(found) == 1 and "_last_written" in found[0].message


# --------------------------------------------------------------------- #
# PUMI011: swallowed retryables
# --------------------------------------------------------------------- #
_SWALLOW = """
from ..resilience.faultinject import InjectedTransientFault

def run(body):
    try:
        return body()
    except InjectedTransientFault:
        return None
"""

_ROUTES = [
    "        raise",
    "        verdict = coordinator.classify(e)\n        return verdict",
    "        counter.inc(cause='transient')\n        return None",
]


def _routed(handler):
    return f"""
from ..resilience.faultinject import InjectedTransientFault

def run(body, coordinator, counter):
    try:
        return body()
    except InjectedTransientFault as e:
{handler}
"""


_NONRETRYABLE = """
def run(body):
    try:
        return body()
    except (OSError, ValueError):
        return None
"""


def test_swallowed_retryable_fires():
    found = at(lint_sources({f"{PKG}/serving/fake.py": _SWALLOW}), "PUMI011")
    assert len(found) == 1
    assert "InjectedTransientFault" in found[0].message


@pytest.mark.parametrize("handler", _ROUTES,
                         ids=["reraise", "classify", "metric"])
def test_retryable_with_sanctioned_route_is_clean(handler):
    fs = lint_sources({f"{PKG}/serving/fake.py": _routed(handler)})
    assert at(fs, "PUMI011") == [], [f.render() for f in fs]


def test_nonretryable_except_is_not_flagged():
    assert at(lint_sources({f"{PKG}/serving/fake.py": _NONRETRYABLE}),
              "PUMI011") == []


# --------------------------------------------------------------------- #
# PUMI008..PUMI011 against the JAX lint, fixture for fixture
# --------------------------------------------------------------------- #
_SHARED = {
    "raw-write": ("serving/fake.py", _RAW_WRITE),
    "raw-write-approved": ("serving/journal.py", _RAW_WRITE),
    "bytesio": ("serving/fake.py", _BYTESIO),
    "save-and-text": ("obs/fake.py", _SAVE_AND_TEXT),
    "inline-open": ("serving/fake.py", _INLINE_OPEN),
    "class-body": ("serving/fake.py", _CLASS_BODY),
    "read-mode": ("serving/fake.py", _READ_MODE),
    "handler-unguarded": ("serving/fake.py", _HANDLER_TMPL.format(guard="")),
    "handler-guarded": ("serving/fake.py", _HANDLER_TMPL.format(guard=_GUARD)),
    "handler-lock": ("obs/fake.py", _LOCKED_HANDLER),
    "no-uninstall": ("obs/fake.py", _NO_UNINSTALL),
    "resume-no-uninstall": ("obs/fake.py", _RESUME_NO_UNINSTALL),
    "thread-attr": ("obs/fake.py", _THREAD_ATTR),
    "thread-attr-ok": ("obs/fake.py", _THREAD_ATTR_OK),
    "closure-bad": ("obs/fake.py", _CLOSURE_BAD),
    "closure-good": ("obs/fake.py", _CLOSURE_GOOD),
    "shadow": ("obs/fake.py", _SHADOW),
    "nonlocal": ("obs/fake.py", _NONLOCAL),
    "executor": ("obs/fake.py", _EXECUTOR),
    "swallow": ("serving/fake.py", _SWALLOW),
    **{f"route-{k}": ("serving/fake.py", _routed(h))
       for k, h in zip(("reraise", "classify", "metric"), _ROUTES)},
    "nonretryable": ("serving/fake.py", _NONRETRYABLE),
}


@pytest.mark.parametrize("name", sorted(_SHARED))
def test_layer4_rules_match_the_jax_lint(name):
    """The same fixture under each package's paths gives the same
    (rule, line, symbol) in both lints."""
    rel, src = _SHARED[name]
    sig = {"utils/signals.py": None, "utils/log.py": None}
    sources = {rel: src}
    if "signals" in src:
        # Each package's own signal plumbing beside the fixture.
        sources.update({k: (ROOT / "pumiumtally_tpu" / k).read_text()
                        for k in sig})
        jax, _ = both_lints(sources, only=rel)
        sources.update({k: (ROOT / PKG / k).read_text() for k in sig})
        _, port = both_lints(sources, only=rel)
    else:
        jax, port = both_lints(sources, only=rel)
    assert port == jax


# --------------------------------------------------------------------- #
# Protocol analyzer: injected regressions on the port's real tree
# --------------------------------------------------------------------- #
SCHED = f"{PKG}/serving/scheduler.py"
CKPT = f"{PKG}/utils/checkpoint.py"

#: The protocol owners' modules: every declared protocol lives in one.
_CRASH_SAFETY_MODULES = tuple(f"{PKG}/{m}" for m in (
    "serving/scheduler.py", "serving/journal.py", "serving/fleet.py",
    "serving/supervisor.py", "resilience/runner.py", "resilience/store.py",
    "utils/checkpoint.py", "utils/signals.py", "utils/log.py",
))


@pytest.fixture(scope="module")
def real_sources():
    return {p: (ROOT / p).read_text() for p in _CRASH_SAFETY_MODULES}


def test_protocols_hold_on_the_real_tree(real_sources):
    assert P.check_sources(real_sources) == []


def test_reordered_finish_is_a_named_protocol_finding(real_sources):
    """Swap _finish's terminal journal flush and checkpoint delete: the
    ordering bug the reference's review caught by hand is a named
    finding on the port's source too."""
    good = (
        "        self._flush_journal()\n"
        "        self._remove_checkpoint(job)\n"
    )
    src = real_sources[SCHED]
    assert good in src
    bad = src.replace(good, "        self._remove_checkpoint(job)\n"
                            "        self._flush_journal()\n")
    fs = P.check_sources({**real_sources, SCHED: bad})
    assert "order.terminal-record-before-checkpoint-delete" in {
        f.symbol for f in fs}, [f.render() for f in fs]


def test_stale_handler_clobber_is_a_named_protocol_finding(real_sources):
    src = real_sources[SCHED]
    pair = (
        "        self._uninstall_signal_handlers()\n"
        "        resume_previous_handler(prev, signum, frame)"
    )
    assert pair in src
    bad = src.replace(pair,
                      "        resume_previous_handler(prev, signum, frame)")
    syms = {f.symbol for f in P.check_sources({**real_sources, SCHED: bad})}
    assert "order.scheduler-uninstall-before-resume" in syms or (
        "require.scheduler-uninstall-before-resume" in syms), syms


def test_early_manifest_commit_is_a_named_protocol_finding(real_sources):
    src = real_sources[CKPT]
    anchor = "    from concurrent.futures import ThreadPoolExecutor"
    assert anchor in src
    bad = src.replace(
        anchor,
        "    atomic_write_bytes(\n"
        "        manifest_path, json.dumps({}).encode()\n"
        "    )\n" + anchor,
    )
    fs = P.check_sources({**real_sources, CKPT: bad})
    assert "order.manifest-commit-last" in {f.symbol for f in fs}, [
        f.render() for f in fs]


def test_raw_journal_flush_is_a_named_protocol_finding(real_sources):
    """Replace the journal document's atomic write with a raw one: both
    the forbid (raw.write) and the require (atomic.write) halves of
    journal-document-atomic fire."""
    jr = f"{PKG}/serving/journal.py"
    src = real_sources[jr]
    atomic = "            atomic_write_bytes(self.path, (text + \"\\n\").encode())"
    assert atomic in src
    bad = src.replace(
        atomic,
        "            with open(self.path, \"w\") as fh:\n"
        "                fh.write(text)",
    )
    syms = {f.symbol for f in P.check_sources({**real_sources, jr: bad})}
    assert "forbid.journal-document-atomic" in syms, syms
    assert "require.journal-document-atomic" in syms


def test_reordered_eviction_record_is_a_named_protocol_finding(real_sources):
    """Move the supervisor's FLEET.json eviction record after the drain:
    a named finding on every CFG path through ``_evict``."""
    sup = f"{PKG}/serving/supervisor.py"
    src = real_sources[sup]
    record = "        self.router.record_eviction(member.index, cause)\n"
    counter = "        self._evictions_total.inc(cause=cause)\n"
    assert record in src and counter in src
    bad = src.replace(record, "").replace(counter, record + counter)
    fs = P.check_sources({**real_sources, sup: bad})
    assert "order.eviction-record-before-drain" in {f.symbol for f in fs}, [
        f.render() for f in fs]


def test_path_explosion_is_flagged_not_silently_truncated():
    branches = "".join(
        "        if job:\n"
        "            fsync_dir(self.dir)\n"
        "        else:\n"
        "            atomic_savez(self.dir)\n"
        for _ in range(10)  # 2**10 distinct effect paths > MAX_PATHS
    )
    src = (
        "import os\n\n"
        "class TallyScheduler:\n"
        "    def _finish(self, job, outcome):\n"
        + branches
        + "        self._flush_journal()\n"
        "        self._remove_checkpoint(job)\n"
    )
    fs = P.check_sources({SCHED: src})
    assert "paths.terminal-record-before-checkpoint-delete" in {
        f.symbol for f in fs}, [f.render() for f in fs]


def test_missing_owner_function_is_reported(real_sources):
    bad = real_sources[SCHED].replace("    def _poison(",
                                      "    def _poison_renamed(")
    fs = P.check_sources({**real_sources, SCHED: bad})
    assert "missing.poison-record-before-checkpoint-delete" in {
        f.symbol for f in fs}


# --------------------------------------------------------------------- #
# The port's departure: the preemption's skipped save
# --------------------------------------------------------------------- #
_PREEMPT = """
import os

class TallyScheduler:
    def _preempt(self, job):
        path = job.path
{body}        self._flush_journal()
"""


@pytest.mark.parametrize("body,want", [
    # the save, then the flush: clean
    ("        job.tally.save_checkpoint(path)\n", set()),
    # the save skipped when the checkpoint on disk is current: clean
    ("        if not self._checkpoint_current(job, path):\n"
     "            job.tally.save_checkpoint(path)\n", set()),
    # neither the save nor the check before the flush: fires
    ("        job.moves = 0\n",
     {"order.preempt-checkpoint-before-journal-flush",
      "require.preempt-checkpoint-before-journal-flush"}),
    # the check alone, with the save gone: the save is still required
    ("        self._checkpoint_current(job, path)\n",
     {"require.preempt-checkpoint-before-journal-flush"}),
], ids=["save", "skip-when-current", "neither", "check-without-save"])
def test_preempt_accepts_a_current_checkpoint_in_place_of_a_save(body,
                                                                 want):
    fs = P.check_sources({SCHED: _PREEMPT.format(body=body)})
    got = {f.symbol for f in fs
           if f.symbol.endswith("preempt-checkpoint-before-journal-flush")}
    assert got == want, [f.render() for f in fs]


def test_real_preempt_skip_is_one_recognized_helper(real_sources):
    """The port's ``_preempt`` reaches its flush through the save or the
    ``_checkpoint_current`` check; inlining the check again (the form
    the lint cannot read) fires the protocol."""
    src = real_sources[SCHED]
    call = "        if not self._checkpoint_current(job, path):\n"
    assert call in src
    inlined = src.replace(
        call,
        "        if not (job.checkpoint == path\n"
        "                and job.checkpoint_moves == job.moves_done\n"
        "                and os.path.exists(path)):\n")
    fs = P.check_sources({**real_sources, SCHED: inlined})
    assert "order.preempt-checkpoint-before-journal-flush" in {
        f.symbol for f in fs}


# --------------------------------------------------------------------- #
# Every protocol against the JAX analyzer, on shared fixtures
# --------------------------------------------------------------------- #
#: One call spelling per effect (the classifier's heads).
_SPELL = {
    "journal.flush": "self._flush_journal()",
    "terminal.record": "self._flush_journal()",
    "checkpoint.delete": "self._remove_checkpoint(job)",
    "flux.persist": "self.journal.write_flux(job.id, flux)",
    "checkpoint.save": "save_checkpoint(path)",
    "shard.write": "save_checkpoint(path)",
    "handler.uninstall": "self._uninstall_signal_handlers()",
    "handler.resume": "resume_previous_handler(prev, signum, frame)",
    "manifest.commit": "atomic_write_bytes(manifest_path, b'')",
    "manifest.uncommit": "os.remove(manifest_path)",
    "generation.rotate": "self._rotate()",
    "generation.delete": "os.remove(gen_path)",
    "dir.fsync": "fsync_dir(directory)",
    "atomic.write": "atomic_write_json(self.path, doc)",
    "raw.write": "open(self.path, 'w')",
    "fleet.record": "self._flush_fleet()",
    "job.place": "self._place(job)",
    "job.dispatch": "self._dispatch_job(job)",
    "eviction.record": "self.router.record_eviction(i, cause)",
    "member.drain": "self.drain_member(member)",
    "breach.record": "self.router.record_breach(breach)",
    "member.quarantine": "self._quarantine(member)",
}


def _owner_source(proto, order: str) -> str:
    """A module holding ``proto``'s owner whose body performs each effect
    its constraints name once: in an order that meets every ``before``
    (``good``), in the reverse order (``bad``), or without the effects
    that must come first (``bare``)."""
    pairs = [(c["before"], c["after"]) for c in proto.constraints
             if c["kind"] == "before"]
    effects = list(dict.fromkeys(
        [c["effect"] for c in proto.constraints if c["kind"] == "require"]
        + [e for pair in pairs for e in pair]))
    # Each effect once, every *before* ahead of its *after*.
    ordered = []
    while len(ordered) < len(effects):
        ordered += [e for e in effects if e not in ordered and all(
            b in ordered for b, a in pairs if a == e)][:1]
    if order == "bad":
        ordered = ordered[::-1]
    elif order == "bare":
        ordered = [e for e in ordered if e not in {b for b, _ in pairs}]
    calls = [_SPELL[e] for e in ordered]
    body = "".join(f"{'    ' * 2 if '.' in proto.function else '    '}"
                   f"{c}\n" for c in calls)
    if "." in proto.function:
        cls, meth = proto.function.split(".")
        return (f"import os\n\nclass {cls}:\n    def {meth}(self, job):\n"
                + body)
    return f"import os\n\ndef {proto.function}(job):\n" + body


@pytest.mark.parametrize("order", ["good", "bad", "bare"])
@pytest.mark.parametrize("name", sorted(P.PROTOCOLS_BY_NAME))
def test_protocols_match_the_jax_analyzer(name, order):
    """The same owner fixture, under each package's path, gives the same
    protocol findings in both analyzers (every other owner is missing in
    both); the port's preempt declaration departs where the fixture
    leaves the save out (``bare``: the port also requires the save)."""
    from pumiumtally_tpu.analysis import protolint as JP

    proto = P.PROTOCOLS_BY_NAME[name]
    rel = proto.path.split("/", 1)[1]
    src = _owner_source(proto, order)
    jax = {f.symbol for f in JP.check_sources({f"pumiumtally_tpu/{rel}": src})}
    port = {f.symbol for f in P.check_sources({f"{PKG}/{rel}": src})}
    if name == "preempt-checkpoint-before-journal-flush" and order == "bare":
        assert port - jax == {f"require.{name}"}
        port.discard(f"require.{name}")
    assert port == jax
    if order == "good":
        assert not {s for s in port if s.endswith(name)}


# --------------------------------------------------------------------- #
# PROTOCOLS_TORCH.json: capture, drift, cross-environment refusal
# --------------------------------------------------------------------- #
def test_diff_baseline_names_drift_and_refuses_cross_env(real_sources):
    cap = P.capture(P.index_from_sources(real_sources))
    base = json.loads(json.dumps(cap))
    assert P.diff_baseline(cap, base) == []

    tampered = json.loads(json.dumps(base))
    name = "terminal-record-before-checkpoint-delete"
    tampered["protocols"][name]["effects"]["checkpoint.delete"] = 7
    assert f"drift.{name}" in {
        f.symbol for f in P.diff_baseline(cap, tampered)}

    for key, value in (("python", "3.11"), ("package", "pumiumtally_tpu")):
        other_env = json.loads(json.dumps(base))
        other_env["environment"][key] = value
        assert {f.symbol for f in P.diff_baseline(cap, other_env)} == {
            "environment.all"}

    removed = json.loads(json.dumps(base))
    del removed["protocols"][name]
    assert f"protocol.added.{name}" in {
        f.symbol for f in P.diff_baseline(cap, removed)}


def test_committed_protocols_json_matches_declarations():
    committed = json.loads((ROOT / "PROTOCOLS_TORCH.json").read_text())
    assert committed["schema"] == P.PROTOCOLS_SCHEMA
    assert committed["environment"]["package"] == PKG
    assert set(committed["protocols"]) == {p.name for p in P.PROTOCOLS}
    for name, rec in committed["protocols"].items():
        assert rec["effects"], f"{name} captured no effects"


def test_committed_protocols_match_the_jax_capture():
    """The same 15 protocols, owners, constraints and effect inventories
    as the JAX capture but for the port's one departure: the preemption
    checks ``checkpoint.current`` (its inventory's one extra effect),
    which may stand in for the save before the flush, and the save must
    stay in the function (two constraints' difference)."""
    port = json.loads((ROOT / "PROTOCOLS_TORCH.json").read_text())
    jax = json.loads((ROOT / "PROTOCOLS.json").read_text())
    assert port["schema"] == jax["schema"]
    assert set(port["protocols"]) == set(jax["protocols"])
    assert len(port["protocols"]) == 15
    preempt = "preempt-checkpoint-before-journal-flush"
    for name, rec in port["protocols"].items():
        ref = jax["protocols"][name]
        assert rec["path"] == ref["path"].replace("pumiumtally_tpu/",
                                                  f"{PKG}/", 1)
        assert rec["function"] == ref["function"]
        if name != preempt:
            assert rec["effects"] == ref["effects"], name
            assert rec["constraints"] == ref["constraints"], name
    assert port["protocols"][preempt]["effects"] == dict(
        jax["protocols"][preempt]["effects"], **{"checkpoint.current": 1})
    cons = port["protocols"][preempt]["constraints"]
    assert cons == [{"kind": "require", "effect": "checkpoint.save"}] + [
        dict(c, also=["checkpoint.current"])
        for c in jax["protocols"][preempt]["constraints"]]


# --------------------------------------------------------------------- #
# Runner integration: baseline routing, --explain, the repo stays clean
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def real_index():
    return P.build_index(ROOT)


def test_protocols_only_runner_exits_clean(real_index, capsys):
    """The runner's --protocols-only exits 0 against the committed
    PROTOCOLS_TORCH.json."""
    rc = runner.run(["--protocols-only"], index=real_index)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "protolint: clean" in out


def test_stale_proto_baseline_entry_hard_fails(tmp_path, real_index, capsys):
    committed = json.loads(BASELINE.read_text())["suppressions"]
    stale = {"rule": "PROTO", "path": "PROTOCOLS_TORCH.json",
             "symbol": "order.long-gone-protocol",
             "justification": "retired long ago"}
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"suppressions": committed + [stale]}))
    rc = runner.run(["--protocols-only", "--baseline", str(p)],
                    index=real_index)
    out = capsys.readouterr().out
    assert rc == 1, out
    assert "stale baseline entry" in out
    assert "long-gone-protocol" in out


def test_proto_baseline_entry_routes_to_protocol_layer():
    f = Finding("PROTO", "PROTOCOLS_TORCH.json", 0,
                "order.terminal-record-before-checkpoint-delete", "m")
    entries = [{"rule": "PROTO", "path": "PROTOCOLS_TORCH.json",
                "symbol": "order.terminal-record-before-checkpoint-delete",
                "justification": "test"}]
    kept, suppressed, unused = apply_baseline([f], entries)
    assert kept == [] and len(suppressed) == 1 and unused == []
    assert runner._layer_entries(entries, "protolint") == entries
    assert runner._layer_entries(entries, "astlint") == []


def test_explain_rule_and_protocol(capsys):
    assert runner.run(["--explain", "PUMI008"]) == 0
    out = capsys.readouterr().out
    for token in ("Rationale", "Example finding", "Fix pattern"):
        assert token in out
    assert runner.run(
        ["--explain", "terminal-record-before-checkpoint-delete"]) == 0
    out = capsys.readouterr().out
    assert "Rationale" in out and "Constraints" in out
    assert runner.run(["--explain", "protocol"]) == 0
    out = capsys.readouterr().out
    for p in P.PROTOCOLS:
        assert p.name in out
    assert runner.run(["--explain", "NOPE999"]) == 2
    assert "unknown rule" in capsys.readouterr().err


@pytest.mark.parametrize("topic", sorted(A.RULES_BY_ID) + sorted(
    P.PROTOCOLS_BY_NAME))
def test_explain_renders_every_kept_rule_and_protocol(topic, capsys):
    assert runner.run(["--explain", topic]) == 0
    out = capsys.readouterr().out
    assert topic in out and ("Rationale" in out or "PUMI007" in out)


def test_write_protocols_for_disabled_layer_is_rejected(capsys):
    with pytest.raises(SystemExit) as e:
        runner.main(["--ast-only", "--write-protocols"])
    assert e.value.code == 2
    assert "needs the" in capsys.readouterr().err


def test_repo_layer4_rules_clean_modulo_baseline(real_index):
    kept, _, _ = apply_baseline(A.lint_index(real_index),
                                load_baseline(BASELINE))
    layer4 = [f for f in kept
              if f.rule in ("PUMI008", "PUMI009", "PUMI010", "PUMI011")]
    assert layer4 == [], "\n".join(f.render() for f in layer4)


def test_explain_covers_every_rule():
    for rule in ("PUMI001", "PUMI002", "PUMI004", "PUMI005", "PUMI007",
                 "PUMI008", "PUMI009", "PUMI010", "PUMI011"):
        text = explain(rule)
        assert text and rule in text
    assert explain("PUMI999") is None
