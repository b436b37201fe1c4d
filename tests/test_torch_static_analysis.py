"""The port's AST lint (``pumiumtally_tpu_torch/analysis/astlint.py``) and
its runner (``python -m pumiumtally_tpu_torch.analysis``).

Mirrors the AST cases of tests/test_static_analysis.py one for one where a
case has a torch meaning: every kept rule fires on its positive fixture
and stays quiet on the sanctioned idiom beside it; the baseline semantics
(suppression by symbol, a stale entry as a hard failure, --allow-stale,
an entry with no justification or no layer as exit 2); the repo stays
clean modulo LINT_BASELINE_TORCH.json, its threaded surface annotated,
and the runner exits 0 on it in a fresh process. Beyond the mirror, the
real tree's PUMI001 findings before the baseline are pinned to the
counted sites, and PUMI007's findings on shared fixtures are held to the
JAX lint's (the same source under each package's paths).

Left out, and why:

* the PUMI003 cases (``test_use_after_donate_fires_on_kwarg_and_positional``,
  ``test_use_after_donate_quiet_after_rebind_and_via_wrapper``,
  ``test_use_after_donate_tracks_self_attributes``,
  ``test_scripts_use_after_donate_fires``) and the PUMI006 cases
  (``test_jit_inside_loop_fires``, ``test_static_loop_var_fires_and_hoisted_clean``):
  the port donates no buffer and builds no jit, and drops both rules;
* the contract-layer cases ``test_extract_signature_shape`` …
  ``test_diff_baseline_names_drift`` (test_static_analysis.py:644-775)
  and the JAX runner's ``test_lint_runner_exits_clean``: the kernel
  resource checks wait for their own slice (ROADMAP A14b); the port's
  runner has its own exit-clean case here.

The runner's cases run in this process on one index of the real tree
(``main(argv, index=...)``), so the tree is parsed once for the module.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from pumiumtally_tpu_torch.analysis import (
    Finding,
    apply_baseline,
    load_baseline,
)
from pumiumtally_tpu_torch.analysis import __main__ as runner
from pumiumtally_tpu_torch.analysis import astlint as A
from pumiumtally_tpu_torch.analysis.astlint import lint_sources

ROOT = Path(__file__).resolve().parents[1]
PKG = "pumiumtally_tpu_torch"
BASELINE = ROOT / "LINT_BASELINE_TORCH.json"

# The move loop's counted host reads: (path, symbol) -> sites.
COUNTED = {
    (f"{PKG}/ops/walk_cuda.py", "_launch"): 2,
    (f"{PKG}/ops/scatter.py", "ordered_cuda"): 1,
    (f"{PKG}/ops/scatter.py", "crowded_cuda"): 1,
    (f"{PKG}/ops/source.py", "_host"): 1,
    (f"{PKG}/ops/walk_partitioned.py",
     "make_partitioned_step.run.walk_phase"): 2,
    (f"{PKG}/ops/walk_partitioned.py", "make_partitioned_step.run.rounds"): 3,
    (f"{PKG}/ops/walk_partitioned.py", "Collectives.stop_test"): 1,
    (f"{PKG}/ops/walk_partitioned.py", "_first_active"): 1,
    (f"{PKG}/ops/walk_partitioned.py", "_exchange"): 3,
    (f"{PKG}/ops/walk_partitioned.py", "_halo_fold_rows"): 2,
}


def rules_of(findings):
    return sorted({f.rule for f in findings})


def at(findings, rule):
    return [f for f in findings if f.rule == rule]


@pytest.fixture(scope="module")
def real_index():
    """One index of the real tree for the module."""
    sources = A.collect_sources(ROOT)
    return A.PackageIndex({p: A._parse(p, s) for p, s in sources.items()})


@pytest.fixture(scope="module")
def real_findings(real_index):
    return A.lint_index(real_index)


# A facade whose move reaches ``ops/fake.py``'s ``step``; fixtures put
# their device code in ``ops/fake.py``.
_FACADE = '''
from .ops.fake import step


class PumiTally:
    def move_to_next_location(self, dest):
        return self._walk(dest)

    def _walk(self, dest):
        return step(dest)
'''


def lint_move_loop(ops_src, path=f"{PKG}/ops/fake.py", **extra):
    return lint_sources({f"{PKG}/api.py": _FACADE, path: ops_src, **extra})


# --------------------------------------------------------------------- #
# PUMI001: host syncs on the move loop
# --------------------------------------------------------------------- #
def test_host_sync_fires_on_move_loop():
    src = """
import torch

def step(x):
    n = torch.count_nonzero(x)
    return n.item()
"""
    fs = lint_move_loop(src)
    assert [f.rule for f in fs] == ["PUMI001"]
    assert fs[0].symbol == "step"
    assert ".item()" in fs[0].message


def test_host_sync_tolist_and_int_fire_via_call_graph():
    # helper() is not a root, but the move reaches it through step().
    src = """
import torch

def helper(v):
    counts = torch.bincount(v)
    return counts.tolist()

def step(x):
    total = torch.sum(x)
    n = int(total)
    return helper(x) + [n]
"""
    fs = lint_move_loop(src)
    assert len(at(fs, "PUMI001")) == 2
    assert {f.symbol for f in fs} == {"step", "helper"}


def test_host_sync_quiet_unreached_metadata_and_plain_version():
    src = """
import numpy as np
import torch

def host_reader(x):
    return torch.stack([x, x]).tolist()  # never on the move loop

def scatter_ordered_plain(x):
    return torch.bincount(x).tolist()    # the CPU-only plain version

def step(x, ids):
    n = x.shape[0]         # metadata of a tensor is a host value
    m = int(x.numel())     # so is its element count
    k = np.asarray(ids).tolist()         # a numpy array is on the host
    return scatter_ordered_plain(x) + [n * m] + k
"""
    fs = lint_move_loop(src, path=f"{PKG}/ops/scatter.py",
                        **{f"{PKG}/api.py": _FACADE.replace(
                            ".ops.fake", ".ops.scatter")})
    assert fs == [], [f.render() for f in fs]
    # The same plain body under a name not in PLAIN_VERSIONS fires.
    fs = lint_move_loop(src.replace("scatter_ordered_plain",
                                    "scatter_ordered_other"),
                        path=f"{PKG}/ops/scatter.py",
                        **{f"{PKG}/api.py": _FACADE.replace(
                            ".ops.fake", ".ops.scatter")})
    assert [f.symbol for f in fs] == ["scatter_ordered_other"]


def test_parameters_count_as_receivers_only():
    """A parameter read to the host (``a.cpu()``) waits like any tensor,
    but ``int()`` of a bare parameter is a host knob (a block width, a
    tolerance), and a parameter's value does not taint what it feeds."""
    src = """
import torch

def step(a, block, tolerance):
    host = a.cpu()
    width = int(block) * 2
    tol = 10.0 * float(tolerance)
    return host, width, tol
"""
    fs = lint_move_loop(src)
    assert [(f.rule, f.line) for f in at(fs, "PUMI001")] == [("PUMI001", 5)]


def test_nonzero_and_synchronize_always_fire():
    src = """
import torch

def step(mask):
    torch.cuda.synchronize()
    return torch.nonzero(mask)[:, 0]
"""
    fs = lint_move_loop(src)
    assert [f.rule for f in fs] == ["PUMI001", "PUMI001"]


def test_cpu_read_breaks_two_contracts():
    # .cpu() of a tensor on the move loop is a host sync (PUMI001) AND a
    # transfer outside the staging modules (PUMI002).
    src = """
import torch

def step(x):
    return torch.cumsum(x, 0).cpu()
"""
    fs = lint_move_loop(src)
    assert rules_of(fs) == ["PUMI001", "PUMI002"]
    assert at(fs, "PUMI001")[0].symbol == "step"


def test_move_loop_reaches_methods_of_package_instances():
    """The partitioned facade's root reaches a method of an instance it
    builds (``comm = Collectives(...)``), as the real step's stop test."""
    facade = '''
from ..ops.fake import make_step


class PartitionedTally:
    def move_to_next_location(self, dest):
        return make_step()(dest)
'''
    ops = """
import torch

class Collectives:
    def stop_test(self, pend):
        return torch.stack([pend.sum()]).tolist()

def make_step():
    comm = Collectives()

    def run(dest):
        return comm.stop_test(dest)
    return run
"""
    fs = lint_sources({f"{PKG}/parallel/partitioned_api.py": facade,
                       f"{PKG}/ops/fake.py": ops})
    assert [(f.rule, f.symbol) for f in fs] == [
        ("PUMI001", "Collectives.stop_test")]


def test_host_sync_outside_device_op_modules_is_not_pumi001():
    """The facades and the stager are the transfer layer: PUMI001 reports
    in ops/ (but staging), core/ and models/ only."""
    src = """
import torch

def step(x):
    return torch.count_nonzero(x).item()
"""
    fs = lint_move_loop(src, path=f"{PKG}/ops/staging.py",
                        **{f"{PKG}/api.py": _FACADE.replace(
                            ".ops.fake", ".ops.staging")})
    assert fs == []
    fs = lint_move_loop(src, path=f"{PKG}/core/fake.py",
                        **{f"{PKG}/api.py": _FACADE.replace(
                            ".ops.fake", ".core.fake")})
    assert [f.rule for f in fs] == ["PUMI001"]


# --------------------------------------------------------------------- #
# PUMI002: transfers outside the staging modules
# --------------------------------------------------------------------- #
def test_transfer_outside_staging_fires():
    src = """
import torch

def leak(x, host, dev):
    a = x.to(dev)
    b = x.to(device="cuda")
    c = x.cuda()
    d = x.cpu()
    e = host.pin_memory()
    host.copy_(x, non_blocking=True)
    f = torch.tensor([1, 2], device=dev)
    g = torch.as_tensor(host, device=x.device)
    return a, b, c, d, e, f, g
"""
    fs = lint_sources({f"{PKG}/obs/fake.py": src})
    assert [f.rule for f in fs] == ["PUMI002"] * 8


def test_transfer_in_approved_module_clean():
    src = """
def stage(x, dev):
    return x.to(dev, non_blocking=True)
"""
    assert lint_sources({f"{PKG}/api.py": src}) == []


def test_dtype_cast_is_not_a_transfer():
    src = """
import torch

def cast(x, dt, y):
    a = x.to(torch.float32)
    b = x.to(dt)
    c = x.to(y.dtype)
    d = torch.tensor([1.0])            # on the host: no device
    return a, b, c, d
"""
    assert lint_sources({f"{PKG}/obs/fake.py": src}) == []


# --------------------------------------------------------------------- #
# PUMI004: the global random state on the move loop
# --------------------------------------------------------------------- #
def test_global_rng_fires_only_on_move_loop():
    src = """
import random
import numpy as np
import torch

def step(x, gen, seed):
    a = torch.rand(4, device=x.device)
    b = np.random.random(4)
    c = random.random()
    d = x.clone().uniform_()
    ok = torch.rand(4, generator=gen)
    rng = np.random.default_rng(seed)
    return a, b, c, d, ok, rng.random(4)

def host_setup(x):
    return torch.rand(4), np.random.random(4)   # not the move loop
"""
    fs = lint_move_loop(src)
    assert [f.rule for f in fs] == ["PUMI004"] * 4
    assert all(f.symbol == "step" for f in fs)


# --------------------------------------------------------------------- #
# PUMI005: float64 on the card's path
# --------------------------------------------------------------------- #
def test_f64_fires_outside_dispatch_and_audit_exempt():
    bad = """
import torch

ACC = torch.zeros(4, dtype=torch.float64)
"""
    fs = lint_sources({f"{PKG}/ops/fake.py": bad})
    assert [f.rule for f in fs] == ["PUMI005"]
    # integrity/audit.py is the sanctioned float64 surface.
    assert lint_sources({f"{PKG}/integrity/audit.py": bad}) == []


def test_f64_quiet_in_dtype_dispatch():
    src = """
import torch

_TAG = {torch.float32: "f32", torch.float64: "f64"}

def widen(x):
    if x.dtype == torch.float64:
        return x.double()
    return x

def words(rec):
    dtype = torch.float32 if rec.dtype == torch.int32 else torch.float64
    return rec.view(dtype)
"""
    assert lint_sources({f"{PKG}/ops/fake.py": src}) == []


def test_f64_double_and_literal_fire():
    src = """
import numpy as np

def step(x):
    y = x.double()
    return np.zeros(3, dtype="float64"), y
"""
    fs = lint_move_loop(src)
    assert [f.rule for f in fs] == ["PUMI005", "PUMI005"]


# --------------------------------------------------------------------- #
# PUMI007: guarded-by (and the same findings as the JAX lint)
# --------------------------------------------------------------------- #
_GUARDED = """
import threading

class Rec:
    def __init__(self):
        self._lock = threading.Lock()
        self._seq = 0  # guarded by: self._lock

    def bad(self):
        self._seq += 1

    def good(self):
        with self._lock:
            self._seq += 1
            return self._seq
"""

_EVENT_BAD = """
import threading

def run(fn, seconds):
    outcome = {}  # guarded by: finished (event)
    finished = threading.Event()

    def target():
        outcome["value"] = fn()   # missing finished.set()

    t = threading.Thread(target=target)
    t.start()
    return outcome.get("value")   # read before finished.wait()
"""

_EVENT_GOOD = """
import threading

def run(fn, seconds):
    outcome = {}  # guarded by: finished (event)
    finished = threading.Event()

    def target():
        try:
            outcome["value"] = fn()
        finally:
            finished.set()

    t = threading.Thread(target=target)
    t.start()
    if not finished.wait(seconds):
        raise TimeoutError
    return outcome["value"]
"""


def test_guarded_attr_fires_outside_lock_quiet_inside():
    fs = lint_sources({f"{PKG}/obs/fake.py": _GUARDED})
    assert [f.rule for f in fs] == ["PUMI007"]
    assert fs[0].symbol == "Rec.bad"


def test_event_guard_requires_set_and_wait():
    fs = lint_sources({f"{PKG}/integrity/fake.py": _EVENT_BAD})
    msgs = [f.message for f in at(fs, "PUMI007")]
    assert len(msgs) == 2
    assert any("happens-before" in m for m in msgs)
    assert any("may still be writing" in m for m in msgs)


def test_event_guard_clean_pattern():
    assert lint_sources({f"{PKG}/integrity/fake.py": _EVENT_GOOD}) == []


def _both(rel: str, src: str):
    """(rule, line, symbol) of the JAX lint and of the port's on the same
    source, under each package's path."""
    from pumiumtally_tpu.analysis.astlint import lint_sources as jax_lint

    def key(fs):
        return sorted((f.rule, f.line, f.symbol) for f in fs)

    return (key(jax_lint({f"pumiumtally_tpu/{rel}": src})),
            key(lint_sources({f"{PKG}/{rel}": src})))


@pytest.mark.parametrize("rel,src", [
    ("obs/fake.py", _GUARDED),
    ("integrity/fake.py", _EVENT_BAD),
    ("integrity/fake.py", _EVENT_GOOD),
], ids=["attr", "event-bad", "event-good"])
def test_guarded_by_matches_the_jax_lint(rel, src):
    jax_keys, port_keys = _both(rel, src)
    assert port_keys == jax_keys
    if src is not _EVENT_GOOD:
        assert port_keys


# --------------------------------------------------------------------- #
# Entry points: the JAX scripts' rule subsets
# --------------------------------------------------------------------- #
def test_entry_point_value_safety_rules_fire():
    """The value-safety subset travels with the entry points: a float64
    constant in the tuner's CLI is a finding, as in the package."""
    src = """
import torch

def main(x):
    return x.to(torch.float64)
"""
    fs = lint_sources({f"{PKG}/tuning/__main__.py": src})
    assert [f.rule for f in fs] == ["PUMI005"]


def test_entry_point_package_scoped_rules_filtered():
    """PUMI002 (transfer placement) and the durability rule are package
    contracts: the tuner's CLI and the probes stage their own transfers
    and write their own reports; the journal-owning entry points keep
    PUMI008."""
    src = """
import json

def main(x, dev, path):
    staged = x.to(dev)
    with open(path, "w") as fh:
        json.dump({}, fh)
    return staged
"""
    for rel in ("tuning/__main__.py", "probes/gather_scatter.py",
                "chaos/campaign.py"):
        assert lint_sources({f"{PKG}/{rel}": src}) == [], rel
    for rel in ("serving/__main__.py", "chaos/serve.py", "chaos/fleet.py"):
        assert rules_of(lint_sources({f"{PKG}/{rel}": src})) == [
            "PUMI008"], rel
    # ... while the same source inside the package keeps both.
    fs = lint_sources({f"{PKG}/obs/fake.py": src})
    assert rules_of(fs) == ["PUMI002", "PUMI008"]


def test_repo_entry_points_clean_under_subset(real_findings):
    entries = load_baseline(BASELINE)
    kept, _, _ = apply_baseline(real_findings, entries)
    entry = [f for f in kept if A.rules_for_path(f.path) is not None]
    assert entry == [], "\n".join(f.render() for f in entry)
    # and the entry points really are in the index
    sources = A.collect_sources(ROOT)
    for rel in A.ENTRY_SCRIPTS:
        assert rel in sources, rel


# --------------------------------------------------------------------- #
# Baseline machinery
# --------------------------------------------------------------------- #
def test_baseline_suppresses_by_symbol_and_reports_stale():
    f1 = Finding("PUMI002", f"{PKG}/obs/x.py", 3, "leak", "m")
    entries = [
        {"rule": "PUMI002", "path": f"{PKG}/obs/x.py",
         "symbol": "leak", "justification": "test"},
        {"rule": "PUMI001", "path": f"{PKG}/obs/x.py",
         "symbol": "gone", "justification": "stale"},
    ]
    kept, suppressed, unused = apply_baseline([f1], entries)
    assert kept == [] and len(suppressed) == 1 and len(unused) == 1
    assert unused[0]["symbol"] == "gone"


def test_baseline_rejects_missing_justification(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"suppressions": [
        {"rule": "PUMI001", "path": "x.py", "symbol": "f",
         "justification": ""}
    ]}))
    with pytest.raises(ValueError, match="justification"):
        load_baseline(p)


def _lint_ast_only(tmp_path, real_index, capsys, extra_entries, *flags):
    """The runner's --ast-only exit code and output against the committed
    suppressions plus ``extra_entries``."""
    committed = json.loads(BASELINE.read_text())["suppressions"]
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps(
        {"suppressions": committed + list(extra_entries)}))
    capsys.readouterr()
    rc = runner.run(["--ast-only", "--baseline", str(p), *flags],
                    index=real_index)
    out = capsys.readouterr()
    return rc, out.out, out.err


_STALE = {"rule": "PUMI001", "path": f"{PKG}/ops/walk.py",
          "symbol": "long_gone_fn",
          "justification": "finding fixed long ago"}


def test_stale_baseline_entry_is_a_hard_failure(tmp_path, real_index,
                                                capsys):
    rc, out, err = _lint_ast_only(tmp_path, real_index, capsys, [_STALE])
    assert rc == 1, out + err
    assert "error: stale baseline entry" in out
    assert "long_gone_fn" in out


def test_allow_stale_escape_hatch_downgrades_to_warning(tmp_path,
                                                       real_index, capsys):
    rc, out, err = _lint_ast_only(tmp_path, real_index, capsys, [_STALE],
                                  "--allow-stale")
    assert rc == 0, out + err
    assert "warning: stale baseline entry" in out


def test_clean_baseline_still_exits_zero(tmp_path, real_index, capsys):
    rc, out, err = _lint_ast_only(tmp_path, real_index, capsys, [])
    assert rc == 0, out + err
    assert "astlint: clean" in out and "analysis:" in out


def test_unjustified_baseline_entry_is_a_config_error(tmp_path, real_index,
                                                      capsys):
    bare = dict(_STALE, justification=" ")
    rc, out, err = _lint_ast_only(tmp_path, real_index, capsys, [bare])
    assert rc == 2, out + err
    assert "justification" in err


@pytest.mark.parametrize("rule", ["UMI001", "CONTRACT", "COST"])
def test_unroutable_baseline_rule_is_a_config_error(tmp_path, real_index,
                                                    capsys, rule):
    """A typo'd rule, or an entry of the JAX package's contract layers,
    routes to no layer of the port: it would suppress nothing AND dodge
    the stale-entry failure."""
    typo = dict(_STALE, rule=rule)
    rc, out, err = _lint_ast_only(tmp_path, real_index, capsys, [typo])
    assert rc == 2, out + err
    assert "matches no lint layer" in err


@pytest.mark.parametrize("flags", [["--ast-only", "--write-protocols"],
                                   ["--no-protocols", "--write-protocols"]])
def test_write_flag_for_disabled_layer_is_rejected(flags, capsys):
    """A write flag aimed at a disabled layer is a usage error: exiting 0
    without regenerating the baseline would be a silent no-op."""
    with pytest.raises(SystemExit) as e:
        runner.main(flags)
    assert e.value.code == 2
    assert "needs the" in capsys.readouterr().err


# --------------------------------------------------------------------- #
# The repo itself stays clean
# --------------------------------------------------------------------- #
def test_repo_astlint_clean_modulo_baseline(real_findings):
    kept, _, unused = apply_baseline(real_findings, load_baseline(BASELINE))
    assert kept == [], "\n".join(f.render() for f in kept)
    unused_ast = [e for e in unused if e["rule"].startswith("PUMI")]
    assert unused_ast == []


def test_pumi001_findings_are_the_counted_sites(real_findings):
    """Before the baseline, the real tree's PUMI001 findings are exactly
    the move loop's counted reads, site for site; and each is one
    baseline entry that names what it waits for and the ROADMAP item
    that would remove it."""
    got: dict = {}
    for f in at(real_findings, "PUMI001"):
        got[(f.path, f.symbol)] = got.get((f.path, f.symbol), 0) + 1
    assert got == COUNTED
    entries = [e for e in load_baseline(BASELINE) if e["rule"] == "PUMI001"]
    assert {(e["path"], e["symbol"]) for e in entries} == set(COUNTED)
    assert len(entries) == len(COUNTED)
    for e in entries:
        assert "ROADMAP" in e["justification"], e


def test_threaded_surface_is_annotated():
    """The concurrency lint only protects what is annotated: the port's
    threaded classes each declare at least one guarded member."""
    for rel in ("obs/recorder.py", "ops/staging.py", "obs/exporter.py",
                "integrity/watchdog.py", "obs/trace.py",
                "serving/gateway.py"):
        text = (ROOT / PKG / rel).read_text()
        assert "# guarded by:" in text, f"{rel} lost its annotations"


def test_explain_covers_every_kept_rule():
    for rule in ("PUMI001", "PUMI002", "PUMI004", "PUMI005", "PUMI007",
                 "PUMI008", "PUMI009", "PUMI010", "PUMI011"):
        text = A.explain(rule)
        assert text and rule in text
        assert "Rationale" in text or rule in ("PUMI007",)
    for dropped in ("PUMI003", "PUMI006", "PUMI999"):
        assert A.explain(dropped) is None


def test_port_lint_runner_exits_clean():
    """``python -m pumiumtally_tpu_torch.analysis`` in a fresh process
    exits 0 on the repo: no finding outside LINT_BASELINE_TORCH.json, no
    stale entry, and PROTOCOLS_TORCH.json matches the tree."""
    proc = subprocess.run(
        [sys.executable, "-m", "pumiumtally_tpu_torch.analysis"],
        capture_output=True, text=True, cwd=str(ROOT), timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "astlint: clean" in proc.stdout
    assert "protolint: clean" in proc.stdout
