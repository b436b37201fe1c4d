"""Static analysis of the port's sources and programs, in four layers.

The port's promises that a runtime test sees only when a failure is
executed (the move loop's counted host syncs, transfers kept to the
staging and facade modules, explicit random generators on the move loop,
float32 hygiene, the lock protocols of the threaded observers, and the
durability and ordering promises of the crash-safety surface) are checked
here on the source text:

  * :mod:`analysis.astlint` - an AST lint engine with the port's rules
    PUMI001, PUMI002, PUMI004, PUMI005 and PUMI007..PUMI011: host syncs on
    the move loop, transfers outside the approved modules, the global
    random state on the move loop, stray float64, the ``# guarded by:
    <lock>`` concurrency lint, raw persistent writes outside the
    atomic-write modules, signal-handler safety, unguarded thread-shared
    state and swallowed retryables. PUMI003 (use after donate) and
    PUMI006 (jit hygiene) have no meaning without donation and jit, and
    their ids are not reused.
  * :mod:`analysis.protolint` - the effect-ordering protocol analyzer:
    named effect points (``checkpoint.save``, ``journal.flush``,
    ``manifest.commit``, ``checkpoint.delete``, ``handler.install`` /
    ``uninstall``, ...) are recognised by callee, and the declared
    happens-before protocols are verified along all CFG paths of the
    functions that own them, then diffed against the committed
    ``PROTOCOLS_TORCH.json``.
  * :mod:`analysis.contracts` - the program contracts: the move loop's
    families run on the CPU under a census of the package's torch calls
    (wrapper calls, host reads, transfers, float64 outputs, copies of the
    flux), checked and diffed against ``CONTRACTS_TORCH.json``.
  * :mod:`analysis.costmodel` - the kernel resource contracts: ptxas's
    record of every instantiation in ``csrc/`` (registers, shared memory,
    spills, float64 SASS) and the families' torch-op cost, checked and
    diffed against ``PERF_CONTRACTS_TORCH.json``.

``python -m pumiumtally_tpu_torch.analysis`` runs the four layers with
the ``LINT_BASELINE_TORCH.json`` suppression file: every suppression
carries a justification, and a stale entry is itself a failure unless
``--allow-stale``.
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis finding.

    ``symbol`` is the enclosing ``Class.method`` / function qualname (or
    ``"<module>"``) — baseline suppressions match on (rule, path, symbol)
    so they survive unrelated line-number drift.
    """

    rule: str
    path: str
    line: int
    symbol: str
    message: str

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: {self.rule} [{self.symbol}] "
            f"{self.message}"
        )


def load_baseline(path) -> list[dict]:
    """Read a LINT_BASELINE_TORCH.json suppression file.

    Schema: ``{"suppressions": [{"rule", "path", "symbol",
    "justification"}, ...]}``.  Every entry MUST carry a non-empty
    justification — an unexplained suppression is itself a finding.
    """
    with open(path) as fh:
        data = json.load(fh)
    entries = data.get("suppressions", [])
    for e in entries:
        for key in ("rule", "path", "symbol", "justification"):
            if not str(e.get(key, "")).strip():
                raise ValueError(
                    f"baseline entry {e!r} is missing a non-empty "
                    f"{key!r} — every suppression must name what it "
                    "hides and why"
                )
    return entries


def apply_baseline(findings: list[Finding], entries: list[dict]):
    """Split findings into (kept, suppressed) and report unused entries.

    Returns ``(kept, suppressed, unused_entries)``.  Unused entries are
    reported so a fixed finding retires its suppression instead of
    leaving a stale hole the next regression could slip through.
    """
    used = [False] * len(entries)

    def matches(e, f):
        return (
            e["rule"] == f.rule
            and e["path"] == f.path
            and e["symbol"] == f.symbol
        )

    kept, suppressed = [], []
    for f in findings:
        hit = None
        for i, e in enumerate(entries):
            if matches(e, f):
                hit = i
                break
        if hit is None:
            kept.append(f)
        else:
            used[hit] = True
            suppressed.append(f)
    unused = [e for i, e in enumerate(entries) if not used[i]]
    return kept, suppressed, unused
