"""The port's program contracts (``pumiumtally_tpu_torch/analysis/
contracts.py``).

Mirrors the contract cases of tests/test_static_analysis.py (the
signature's shape, the injected transfer, host read, dropped donation
and float64 leak, the degraded scan, the real family, the drift diff)
on the port's census of the move loop's families, and adds the port's
own: the committed CONTRACTS_TORCH.json equals a fresh capture (the same
capture the card's host gives under another torch release, which
chip_smoke.py phase 26 checks), the partitioned step's stacked walk, the
kernel path's silent fallback and its transfers (the ``cuda`` family is
captured on the card only, so its checks run here on tampered records;
tests/test_torch_cuda.py captures it). Left out: none of the JAX cases;
the callback and donation cases become a host read and an out-of-place
flux update.

An injected fault must sit where the census places it: a host read or a
float64 tensor in a module that runs device operations. The injections
are compiled under the file name of ``ops/walk_cuda.py`` and patched in
as the facade's walk wrapper, so their frames are that module's.
"""
from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest

from pumiumtally_tpu_torch.analysis import contracts as C
from pumiumtally_tpu_torch.analysis import load_baseline
from pumiumtally_tpu_torch.ops import walk_cuda

ROOT = Path(__file__).resolve().parents[1]
PKG = "pumiumtally_tpu_torch"
WALK_CUDA = str(ROOT / PKG / "ops" / "walk_cuda.py")


@pytest.fixture(scope="module")
def entries():
    return load_baseline(ROOT / "LINT_BASELINE_TORCH.json")


@pytest.fixture(scope="module")
def cap():
    """The CPU families' capture, once for the module."""
    return C.capture()


def _symbols(findings):
    return [f.symbol for f in findings]


def _structural(fam, sig, entries):
    return _symbols(C.check_structural({"families": {fam: sig}}, entries))


def _in_walk_cuda(src: str, name: str, real):
    """A function compiled from ``src`` as if it were in
    ops/walk_cuda.py, with ``real`` (the wrapper it wraps) in scope."""
    scope = {"real": real}
    exec(compile(src, WALK_CUDA, "exec"), scope)
    return scope[name]


def _run_injected(monkeypatch, src, name, family="trace"):
    fn = _in_walk_cuda(src, name, walk_cuda.trace)
    monkeypatch.setattr(walk_cuda, "trace", fn)
    return C.run_family(family)[0]


# --------------------------------------------------------------------- #
# The census
# --------------------------------------------------------------------- #
def test_census_record_shape():
    """A window of plain torch: its reads, float64 outputs and flux
    copies by site, the flux's storage, no watched call."""
    import torch

    flux = torch.zeros(8)
    with C.Census(flux) as c:
        flux.add_(1.0)
        n = int(flux.sum().item())
        _ = flux.double()
        _ = flux + 0
    rec = c.record(flux, moves=1)
    assert n == 8 and rec["moves"] == 1 and rec["flux_kept"]
    assert rec["calls"] == {} and rec["plain_callees"] == []
    assert sum(rec["host_reads"].values()) == 1
    assert sum(rec["f64_outputs"].values()) == 1
    assert sum(rec["flux_copies"].values()) == 1  # flux + 0
    cost = c.cost()
    assert cost["ops"] >= 4 and cost["bytes_written"] >= 8 * 4
    assert cost["peak_live_bytes"] > 0


def test_committed_contracts_equal_a_fresh_capture(cap):
    """CONTRACTS_TORCH.json is the tree's capture: no drift. The card's
    host checks the same file under its own torch (phase 26)."""
    committed = C.load_contracts(ROOT / C.CONTRACTS_FILE)
    assert [f.render() for f in C.diff_baseline(cap, committed)] == []
    assert cap == committed
    assert "torch" not in json.dumps(cap["environment"])


def test_real_families_satisfy_structural_invariants(cap, entries):
    assert [f.render() for f in C.check_structural(cap, entries)] == []
    fams = cap["families"]
    assert fams["trace"]["calls"]["walk_cuda.trace"] == 1
    assert fams["trace_packed"]["calls"]["walk_cuda.trace_packed"] == 1
    assert fams["megastep"]["calls"]["walk.megastep"] == 1
    assert fams["megastep"]["moves"] == C._K
    part = fams["partitioned"]["calls"]
    assert part["walk_cuda.walk_rows"] == part[
        "walk_partitioned.Collectives.stop_test"] >= 1
    for fam in fams.values():
        assert fam["flux_kept"] and fam["flux_copies"] == {}


# --------------------------------------------------------------------- #
# Injected regressions
# --------------------------------------------------------------------- #
_PEEK = '''
def trace_with_peek(*args, **kw):
    r = real(*args, **kw)
    if int(r.flux.sum().item()) < 0:
        raise AssertionError
    return r
'''


def test_injected_host_read_fires(monkeypatch, entries):
    """A host peek inside the walk wrapper: io.host_reads names it."""
    rec = _run_injected(monkeypatch, _PEEK, "trace_with_peek")
    site = f"{PKG}/ops/walk_cuda.py:trace_with_peek"
    assert rec["host_reads"].get(site) == 1
    assert "io.host_reads.trace" in _structural("trace", rec, entries)


_COPY = '''
import dataclasses

def trace_out_of_place(*args, **kw):
    r = real(*args, **kw)
    return dataclasses.replace(r, flux=r.flux * 1.0)
'''


def test_injected_out_of_place_flux_fires(monkeypatch, entries):
    """An out-of-place flux update (the port's dropped donation): the
    facade's accumulator changes storage and a copy of it appears."""
    rec = _run_injected(monkeypatch, _COPY, "trace_out_of_place")
    assert not rec["flux_kept"]
    assert rec["flux_copies"] == {
        f"{PKG}/ops/walk_cuda.py:trace_out_of_place": 1}
    assert "inplace.flux.trace" in _structural("trace", rec, entries)


_UPCAST = '''
def trace_upcast(*args, **kw):
    r = real(*args, **kw)
    if r.flux.double().sum() < 0:  # an audit sum taken in float64
        raise AssertionError
    return r
'''


def test_injected_f64_leak_fires(monkeypatch, entries):
    rec = _run_injected(monkeypatch, _UPCAST, "trace_upcast")
    assert rec["f64_outputs"].get(f"{PKG}/ops/walk_cuda.py:trace_upcast")
    assert rec["flux_kept"]
    syms = _structural("trace", rec, entries)
    assert "dtype.f32_purity.trace" in syms
    assert "inplace.flux.trace" not in syms


def test_baselined_f64_and_facade_f64_are_sanctioned(cap, entries):
    """The partitioned stop test's float64 sums are a PUMI005 baseline
    entry, and the packed facade's float64 tensors wrap the caller's
    arrays: neither is a purity finding."""
    part = cap["families"]["partitioned"]["f64_outputs"]
    assert f"{PKG}/ops/walk_partitioned.py:Collectives.stop_test" in part
    packed = cap["families"]["trace_packed"]["f64_outputs"]
    assert all(s.startswith(f"{PKG}/api.py:") for s in packed)
    assert "dtype.f32_purity.partitioned" not in _symbols(
        C.check_structural(cap, entries))
    bare = [e for e in entries if e["rule"] != "PUMI005"]
    assert "dtype.f32_purity.partitioned" in _symbols(
        C.check_structural(cap, bare))


def test_degraded_chunk_fires_on_megastep(cap, entries):
    """K moves that are no longer one megastep call, and a walk with no
    scatter."""
    sig = copy.deepcopy(cap["families"]["megastep"])
    sig["calls"]["walk.megastep"] = sig["moves"]
    sig["plain_callees"] = []
    syms = _structural("megastep", sig, entries)
    assert "structure.chunk.megastep" in syms
    assert "structure.scatter.megastep" in syms
    sig = copy.deepcopy(cap["families"]["megastep"])
    sig["calls"]["walk_cuda.trace"] -= 1
    assert "structure.walk.megastep" in _structural("megastep", sig, entries)


def test_per_part_walks_fire_on_partitioned(cap, entries):
    sig = copy.deepcopy(cap["families"]["partitioned"])
    sig["calls"]["walk_cuda.walk_rows"] *= C._N_PARTS
    assert "structure.stacked.partitioned" in _structural(
        "partitioned", sig, entries)


def _cuda_record(cap):
    """The CPU packed move and megastep chunk dressed as the kernel
    path's windows (their calls and counters as the card gives them)."""
    move = copy.deepcopy(cap["families"]["trace_packed"])
    move["calls"] = {"scatter.ordered_cuda": 1, "walk_cuda._launch": 1,
                     "walk_cuda.trace": 1, "walk_cuda.trace_packed": 1}
    move["plain_callees"] = []
    move["transfers"] = {f"h2d {PKG}/api.py:PumiTally._put_record": 1,
                         f"d2h {PKG}/ops/staging.py:to_host": 1,
                         f"h2d {PKG}/ops/scatter.py:ordered_cuda": 1}
    move["io"] = {"h2d_transfers": 1, "d2h_transfers": 1}
    move["launches"] = {"walk": 1, "scatter": 1, "schedule": 3, "flight": 0}
    chunk = copy.deepcopy(cap["families"]["megastep"])
    k = chunk["moves"]
    chunk["calls"] = {"scatter.ordered_cuda": k, "walk_cuda._launch": k,
                      "walk_cuda.trace": k, "source_cuda.sample_flight": k,
                      "walk.megastep": 1}
    chunk["plain_callees"] = []
    chunk["launches"] = {"walk": k, "scatter": k, "schedule": 3 * k,
                         "flight": k}
    return {"families": {"cuda": {"move": move, "chunk": chunk}}}


def test_kernel_fallback_and_extra_transfer_fire_on_cuda(cap, entries):
    rec = _cuda_record(cap)
    assert C.check_structural(rec, entries) == []
    fell = copy.deepcopy(rec)
    fell["families"]["cuda"]["move"]["calls"]["walk.trace"] = 1
    fell["families"]["cuda"]["move"]["launches"]["walk"] = 0
    assert "structure.kernel.cuda" in _symbols(
        C.check_structural(fell, entries))
    extra = copy.deepcopy(rec)
    extra["families"]["cuda"]["move"]["transfers"][
        f"h2d {PKG}/api.py:PumiTally._put"] = 3
    assert "io.transfers.cuda" in _symbols(C.check_structural(extra, entries))
    flight = copy.deepcopy(rec)
    flight["families"]["cuda"]["chunk"]["launches"]["flight"] = 0
    assert "structure.kernel.cuda" in _symbols(
        C.check_structural(flight, entries))


# --------------------------------------------------------------------- #
# The drift diff
# --------------------------------------------------------------------- #
def test_diff_baseline_names_drift(cap):
    base = copy.deepcopy(cap)
    assert C.diff_baseline(cap, base) == []
    t = copy.deepcopy(base)
    fam = t["families"]["trace"]
    fam["calls"]["walk_cuda.trace"] += 1
    fam["host_reads"][f"{PKG}/ops/walk.py:_walk"] = 2
    fam["flux_kept"] = False
    fam["inputs"] = fam["inputs"][:-1]
    syms = set(_symbols(C.diff_baseline(cap, t)))
    assert {"calls.walk_cuda.trace.trace",
            f"host_reads.{PKG}/ops/walk.py:_walk.trace",
            "signature.flux_kept.trace", "signature.inputs.trace"} <= syms
    gone = copy.deepcopy(base)
    gone["families"].pop("megastep")
    assert _symbols(C.diff_baseline(cap, gone)) == ["family.added.megastep"]
    assert _symbols(C.diff_baseline(gone, cap)) == ["family.removed.megastep"]
    other = copy.deepcopy(base)
    other["environment"]["device"] = "cuda"
    assert _symbols(C.diff_baseline(cap, other)) == ["environment.all"]
