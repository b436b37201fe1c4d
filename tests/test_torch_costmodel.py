"""The port's kernel resource contracts
(``pumiumtally_tpu_torch/analysis/costmodel.py``).

Mirrors tests/test_costmodel.py case by case where a case has a torch
meaning: the exponent fit (held to the JAX function on the same inputs),
the committed capture's invariants and rungs, the injected regressions
(a float64 instruction in a float32 kernel, a quadratic broadcast, a
drifted shared memory mirror, +8 registers, an edited source), the
drift diff and its refusal across environments, the capture's
determinism across fresh processes, perfdiff, the shared base rung and
the partitioned analytic. Left out: the dropped donation (the port
donates nothing; its counterpart, an out-of-place flux update, is
``inplace.flux`` in tests/test_torch_contracts.py) and the full write's
byte stability (the ptxas capture is written from a build on the card;
here the runner must refuse to write without build logs, which
tests/test_torch_static_analysis.py checks).

The parser cases read the real ptxas logs of the six sources recorded
on the card (``tests/ptxas_logs/``): the walk's float64 instantiation at
512 threads passes its batches as dynamic shared memory (static 0), and
the flight kernel's log has a non-entry function's properties block
(``__internal_trig_reduction_slowpathd``).
"""
from __future__ import annotations

import copy
import glob
import json
import re
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

from pumiumtally_tpu.analysis import costmodel as jcost
from pumiumtally_tpu_torch.analysis import contracts as C
from pumiumtally_tpu_torch.analysis import costmodel as M
from pumiumtally_tpu_torch.analysis import load_baseline

ROOT = Path(__file__).resolve().parents[1]
LOGS = ROOT / "tests" / "ptxas_logs"
CSRC = ROOT / "pumiumtally_tpu_torch" / "csrc"


def _symbols(findings):
    return [f.symbol for f in findings]


def _log(name: str) -> str:
    (path,) = glob.glob(str(LOGS / f"lib{name}-*.log"))
    return open(path).read()


@pytest.fixture(scope="module")
def committed():
    return M.load_perf_contracts(ROOT / M.PERF_CONTRACTS_FILE)


@pytest.fixture(scope="module")
def spills_baselined():
    """The COST symbols LINT_BASELINE_TORCH.json suppresses."""
    return {e["symbol"] for e in load_baseline(
        ROOT / "LINT_BASELINE_TORCH.json") if e["rule"] == "COST"}


def _tampered(cap, fn):
    t = copy.deepcopy(cap)
    fn(t)
    return t


# --------------------------------------------------------------------- #
# Exponent fitting (held to the JAX function)
# --------------------------------------------------------------------- #
def test_fit_exponent_recovers_powers():
    sizes = [16, 64, 256]
    for values, want in (([7 * s for s in sizes], 1.0),
                         ([s * s for s in sizes], 2.0),
                         ([5000] * 3, 0.0),
                         ([3.0, 11.0, 61.0], None)):
        got = M.fit_exponent(sizes, values)
        assert got == pytest.approx(jcost.fit_exponent(sizes, values),
                                    rel=1e-12, abs=1e-12)
        if want is not None:
            assert got == pytest.approx(want)


def test_fit_exponent_rejects_degenerate_input():
    for args in (([16], [100]), ([16, 64], [0, 100])):
        with pytest.raises(ValueError):
            M.fit_exponent(*args)
        with pytest.raises(ValueError):
            jcost.fit_exponent(*args)


# --------------------------------------------------------------------- #
# The ptxas parser on the card's logs
# --------------------------------------------------------------------- #
def test_parse_ptxas_reads_every_entry_of_the_real_logs():
    counts = {n: len(M.parse_ptxas(_log(n))) for n in M.SOURCES}
    assert counts == {"walk": 69, "scatter": 19, "gather": 12, "source": 2,
                      "exchange": 7, "integrity": 2}
    for n in M.SOURCES:
        text = _log(n)
        assert counts[n] == text.count("Compiling entry function")
    walk = M.parse_ptxas(_log("walk"))
    # float64 at 512 threads: 80 KB of batches, passed as dynamic bytes
    r = walk["walk_kernel<dLb1ELb0ELb1ELb0ELi0ELi512E>"]
    assert r["smem"] == 0 and r["registers"] > 0
    assert walk["walk_kernel<fLb1ELb0ELb1ELb0ELi0ELi512E>"]["smem"] == 49152
    fold = M.parse_ptxas(_log("scatter"))["bucket_fold<f>"]
    assert (fold["barriers"], fold["smem"]) == (1, M.bucket_static_bytes())


def test_parse_ptxas_skips_a_non_entry_properties_block():
    """The flight kernel's float64 instantiation is followed by the math
    library's slow path's own properties block: its frame line must not
    overwrite an entry's, whichever comes first."""
    text = _log("source")
    assert "Function properties for __internal_trig" in text
    recs = M.parse_ptxas(text)
    assert set(recs) == {"sample_flight_kernel<d>", "sample_flight_kernel<f>"}
    assert recs["sample_flight_kernel<d>"]["stack"] == 40
    assert recs["sample_flight_kernel<f>"]["stack"] == 0
    # The slow path's block moved inside the float32 entry, before its
    # own frame line and with a frame of its own: still skipped.
    lines = text.splitlines()
    i = next(k for k, ln in enumerate(lines)
             if "Compiling entry" in ln and "IfEE" in ln)
    odd = lines[:i + 1] + [
        "ptxas info    : Function properties for __internal_trig_x",
        "    99 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
    ] + lines[i + 1:]
    again = M.parse_ptxas("\n".join(odd))
    assert again["sample_flight_kernel<f>"] == recs["sample_flight_kernel<f>"]


def test_split_name_drops_the_anonymous_namespace():
    mangled = ("_ZN39_GLOBAL__N__b03c7047_7_walk_cu_3128608611walk_kernelI"
               "fLb1ELb0ELb1ELb0ELi0ELi128EEEvPKT_")
    assert M.split_name(mangled) == (
        "walk_kernel", "fLb1ELb0ELb1ELb0ELi0ELi128E")
    other = mangled.replace("b03c7047", "0badf00d").replace(
        "31286086", "99999999")
    assert M.instantiation(other) == M.instantiation(mangled)
    assert M.split_name("_Z4walkILi128EEvv") == ("walk", "Li128E")
    assert M.instantiation(
        "_ZN43_GLOBAL__N__44a40629_10_scatter_cu_2bd00b9512count_kernel"
        "EPKiiPi") == "count_kernel"


def test_sass_census_counts_float64_opcodes():
    sass = textwrap.dedent("""
        Function : _ZN39_GLOBAL__N__b03c7047_7_walk_cu_3128608610lane_countIfEEv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FADD R2, R2, R3 ;
        Function : _ZN39_GLOBAL__N__b03c7047_7_walk_cu_3128608610lane_countIdEEv
        /*0000*/                   DADD R2, R2, R4 ;
        /*0010*/              @!P0 DSETP.GT.AND P1, PT, R2, R4, PT ;
        /*0020*/                   F2F.F32.F64 R6, R2 ;
        /*0030*/                   REDG.E.ADD.F64.RN.STRONG.GPU [R8], R2 ;
    """)
    assert M.sass_f64(sass) == {"lane_count<f>": 0, "lane_count<d>": 4}


# --------------------------------------------------------------------- #
# The committed capture
# --------------------------------------------------------------------- #
def test_committed_perf_contracts_satisfy_invariants(committed,
                                                     spills_baselined):
    found = M.check_cost(committed["ptxas"])
    assert set(_symbols(found)) == spills_baselined
    assert all(s.startswith("cost.spill.") for s in spills_baselined)
    assert M.check_stale(committed["ptxas"]) == []
    assert M.check_families(committed["families"]) == []
    assert M.diff_cost(committed["ptxas"],
                       copy.deepcopy(committed["ptxas"])) == []
    assert M.diff_families(committed["families"],
                           copy.deepcopy(committed["families"])) == []


def test_committed_capture_covers_every_instantiation(committed):
    """The ptxas section holds every entry of every source at the tree's
    digests, with each one's float64 SASS census, in nvcc's
    environment for sm_90a and today's flags."""
    env = committed["ptxas"]["environment"]
    assert env["arch"] == "sm_90a" and env["nvcc"]
    assert env["flags"] == M.flags_digest()
    for name in M.SOURCES:
        entry = committed["ptxas"]["sources"][name]
        assert len(entry["instantiations"]) == len(M.parse_ptxas(_log(name)))
        assert all("f64" in r for r in entry["instantiations"].values())
    assert committed["ptxas"]["sources"]["source"]["instantiations"][
        "sample_flight_kernel<f>"]["f64"] == M.F64_EXPECTED[
        "sample_flight_kernel<f>"][0]


def test_committed_capture_carries_both_rungs(committed):
    fams = committed["families"]
    assert fams["ladder"] == {"n_particles": list(M.LADDER_N),
                              "ntet": [6 * c ** 3 for c in M.LADDER_CELLS]}
    assert set(fams["families"]) == set(C.FAMILIES)
    for fam, entry in fams["families"].items():
        assert set(entry) >= {"base", "top", "scaling"}, fam
        assert entry["base"]["analytic"]["n"] == M.LADDER_N[0]
        assert entry["top"]["analytic"]["n"] == M.LADDER_N[-1]


def test_committed_scaling_exponents_are_linear_or_better(committed):
    for fam, entry in committed["families"]["families"].items():
        for axis, exps in entry["scaling"].items():
            assert set(exps) == set(M.SCALING_METRICS), (fam, axis)
            for metric, e in exps.items():
                assert e <= M.SCALING_MAX[axis], (fam, axis, metric, e)


# --------------------------------------------------------------------- #
# Injected regressions
# --------------------------------------------------------------------- #
def test_injected_f64_instruction_names_cost_f64(committed):
    inst = "walk_kernel<fLb1ELb0ELb1ELb0ELi0ELi128E>"
    assert "cost.f64." + inst not in _symbols(M.check_cost(committed["ptxas"]))
    bad = _tampered(committed["ptxas"], lambda c: c["sources"]["walk"][
        "instantiations"][inst].__setitem__("f64", 2))
    assert "cost.f64." + inst in _symbols(M.check_cost(bad))
    # A float64 instantiation's own float64 instructions are its design.
    d = inst.replace("<f", "<d")
    ok = _tampered(committed["ptxas"], lambda c: c["sources"]["walk"][
        "instantiations"][d].__setitem__("f64", 999))
    assert "cost.f64." + d not in _symbols(M.check_cost(ok))
    # The flight kernel's expected six are the design; a seventh is not.
    seven = _tampered(committed["ptxas"], lambda c: c["sources"]["source"][
        "instantiations"]["sample_flight_kernel<f>"].__setitem__("f64", 7))
    assert "cost.f64.sample_flight_kernel<f>" in _symbols(
        M.check_cost(seven))


def _quadratic_run(family, *, n, cells, frames=None):
    """The trace family with an accidental [n, n, 3] broadcast in the
    walk wrapper (pairwise lane offsets, kept alive through the walk)."""
    from pumiumtally_tpu_torch.ops import walk_cuda

    real = walk_cuda.trace

    def trace(mesh, origin, dest, *a, **kw):
        pairs = origin[:, None, :] - origin[None, :, :]
        r = real(mesh, origin, dest, *a, **kw)
        del pairs
        return r

    walk_cuda.trace = trace
    try:
        return C.run_family(family, n=n, cells=cells, frames=frames)
    finally:
        walk_cuda.trace = real


def test_injected_quadratic_broadcast_names_cost_scaling():
    clean = M.capture_families(("trace",))
    bad = M.capture_families(("trace",), run=_quadratic_run)
    assert M.check_families(clean) == []
    exps = bad["families"]["trace"]["scaling"]["n_particles"]
    assert exps["peak_live_bytes"] > M.SCALING_MAX["n_particles"], exps
    found = M.check_families(bad)
    assert "cost.scaling.n_particles.trace" in _symbols(found)
    assert "superlinear" in [f for f in found if f.symbol.startswith(
        "cost.scaling")][0].message
    # At the top rung the [256, 256, 3] intermediate also overflows the
    # analytic allowance: the peak gate names the same regression.
    assert "cost.peak.trace" in _symbols(found)
    # The ntet axis stays clean: the broadcast grows with lanes only.
    assert "cost.scaling.ntet.trace" not in _symbols(found)


def test_injected_smem_mirror_drift_names_cost_smem(committed, monkeypatch):
    assert not [s for s in _symbols(M.check_cost(committed["ptxas"]))
                if s.startswith("cost.smem")]
    monkeypatch.setitem(M._LANE_BYTES, "f", 40)  # "forgot a field"
    syms = _symbols(M.check_cost(committed["ptxas"]))
    assert "cost.smem.walk_kernel" in syms
    monkeypatch.setitem(M._LANE_BYTES, "f", 48)
    monkeypatch.setattr(M, "_SMALL", 16)
    assert "cost.smem.bucket_fold" in _symbols(M.check_cost(
        committed["ptxas"]))


def test_smem_mirror_matches_the_sources_and_the_logs():
    """The mirror's constants are csrc's (read from the source text), and
    at every walk width and the bucket fold it gives the static bytes
    ptxas reported on the card."""
    walk, scatter = (CSRC / "walk.cu").read_text(), (
        CSRC / "scatter.cu").read_text()
    assert "sizeof(Lane<float>) == 48" in walk
    assert "sizeof(Lane<double>) == 80" in walk
    assert re.search(r"SCHED_THREADS = (\d+)", walk).group(1) == str(
        M._SCHED_THREADS)
    for name, value in (("BUCKET_CAP", M._BUCKET_CAP),
                        ("BUCKET_THREADS", M._BUCKET_THREADS),
                        ("BUCKET_SHIFT_MAX", M._BUCKET_SHIFT_MAX),
                        ("SMALL", M._SMALL)):
        assert re.search(rf"constexpr int {name} = (\d+)",
                         scatter).group(1) == str(value), name
    recs = M.parse_ptxas(_log("walk"))
    walks = [i for i in recs if i.startswith("walk_kernel<")]
    assert len(walks) == 64
    for inst in walks:
        kernel, targs = inst.split("<")[0], inst[len("walk_kernel<"):-1]
        assert recs[inst]["smem"] == M.expected_smem(kernel, targs)[0], inst
    from pumiumtally_tpu_torch.ops import walk_cuda

    assert {M.launch_threads("walk_kernel", i[len("walk_kernel<"):-1])
            for i in walks} == set(walk_cuda.BLOCKS)
    assert M.walk_dynamic_bytes("d", 512) == 81920
    assert M.bucket_smem("d", 2048, 10) > M.STATIC_SMEM_MAX


def test_injected_register_growth_names_cost_regfile(committed):
    inst = "sort_fold_large<f>"  # 1024 threads a block: 64 registers max
    bad = _tampered(committed["ptxas"], lambda c: c["sources"]["scatter"][
        "instantiations"][inst].__setitem__("registers", 72))
    assert "cost.regfile." + inst in _symbols(M.check_cost(bad))
    assert "cost.regfile." + inst not in _symbols(
        M.check_cost(committed["ptxas"]))


# --------------------------------------------------------------------- #
# The drift diff
# --------------------------------------------------------------------- #
def test_diff_cost_names_each_changed_value(committed):
    cap = committed["ptxas"]
    inst = "walk_kernel<fLb1ELb0ELb1ELb0ELi0ELi128E>"
    plus8 = _tampered(cap, lambda c: c["sources"]["walk"]["instantiations"][
        inst].__setitem__("registers", c["sources"]["walk"][
            "instantiations"][inst]["registers"] + 8))
    assert _symbols(M.diff_cost(plus8, cap)) == [
        f"cost.drift.registers.{inst}"]
    gone = _tampered(cap, lambda c: c["sources"]["scatter"][
        "instantiations"].pop("count_kernel"))
    assert _symbols(M.diff_cost(gone, cap)) == [
        "cost.instantiation.removed.count_kernel"]
    assert _symbols(M.diff_cost(cap, gone)) == [
        "cost.instantiation.added.count_kernel"]
    # The families within their bands: +1% ops is inside the 2% band.
    fams = committed["families"]
    base = fams["families"]["trace"]["base"]["metrics"]["ops"]
    near = _tampered(fams, lambda c: c["families"]["trace"]["base"][
        "metrics"].__setitem__("ops", int(base * 1.01)))
    assert M.diff_families(near, fams) == []
    far = _tampered(fams, lambda c: c["families"]["trace"]["base"][
        "metrics"].__setitem__("ops", int(base * 1.5)))
    assert _symbols(M.diff_families(far, fams)) == ["cost.drift.ops.trace"]


def test_diff_cost_refuses_cross_environment_and_ladder(committed):
    cap = committed["ptxas"]
    other = _tampered(cap, lambda c: c["environment"].__setitem__(
        "nvcc", "Build cuda_13.0"))
    assert _symbols(M.diff_cost(other, cap)) == ["cost.environment.all"]
    fams = committed["families"]
    short = _tampered(fams, lambda c: c["ladder"].__setitem__(
        "n_particles", [16, 64]))
    assert _symbols(M.diff_families(short, fams)) == [
        "cost.environment.families"]


def test_edited_source_digest_names_cost_stale(committed):
    assert M.check_stale(committed["ptxas"]) == []
    edited = _tampered(committed["ptxas"], lambda c: c["sources"][
        "gather"].__setitem__("digest", "0" * 64))
    assert _symbols(M.check_stale(edited)) == ["cost.stale.gather"]
    missing = _tampered(committed["ptxas"],
                        lambda c: c["sources"].pop("source"))
    assert _symbols(M.check_stale(missing)) == ["cost.stale.source"]


def test_bank_entry_ptxas_must_equal_the_capture(committed):
    from pumiumtally_tpu_torch.ops import _build

    recs = M.summary(M.parse_ptxas(_log("source")))
    meta = dict(name="source", key="source-x", ptxas=recs,
                source_sha256=_build.source_digest("source"))
    assert M.check_bank([meta], committed["ptxas"]) == []
    bad = dict(meta, ptxas=_tampered(recs, lambda r: r[
        "sample_flight_kernel<f>"].__setitem__("registers", 40)))
    assert _symbols(M.check_bank([bad], committed["ptxas"])) == [
        "cost.bank.source"]
    # An entry of another source digest is another build: not compared.
    assert M.check_bank([dict(bad, source_sha256="1" * 64)],
                        committed["ptxas"]) == []


def test_cost_peak_cuda_against_the_main_cell_allowance():
    """cost.peak.cuda at the main cell's size: the peak measured on the
    card with the flux, lanes, tables and a move's records passes; a
    second copy of every record buffer and table does not fit."""
    a = M.family_analytic("trace_packed", n=1_048_576, ntet=998_250,
                          n_groups=8, itemsize=4, table_bytes=185_785_396,
                          records=21_168_382)
    assert M.check_peak_cuda(1_191_723_008, a) == []
    assert _symbols(M.check_peak_cuda(M.allowance_bytes(a) + 1, a)) == [
        "cost.peak.cuda"]


# --------------------------------------------------------------------- #
# Determinism, perfdiff, the shared base rung
# --------------------------------------------------------------------- #
_CAPTURE = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {root!r})
    from pumiumtally_tpu_torch.analysis import costmodel as M
    print(json.dumps(M.capture_families(("trace",)), sort_keys=True))
""")


def test_capture_deterministic_across_fresh_processes(committed):
    outs = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-c", _CAPTURE.format(root=str(ROOT))],
            capture_output=True, text=True, cwd=str(ROOT), timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        outs.append(proc.stdout.strip().splitlines()[-1])
    assert outs[0] == outs[1]
    fresh = json.loads(outs[0])
    assert fresh["families"]["trace"] == committed["families"]["families"][
        "trace"]


def test_perfdiff_prints_delta_table(committed, tmp_path):
    inst = "walk_kernel<fLb1ELb0ELb1ELb0ELi0ELi128E>"
    regs = committed["ptxas"]["sources"]["walk"]["instantiations"][inst][
        "registers"]
    new = _tampered(committed, lambda c: c["ptxas"]["sources"]["walk"][
        "instantiations"][inst].__setitem__("registers", regs + 8))
    p = tmp_path / "new.json"
    p.write_text(json.dumps(new))
    proc = subprocess.run(
        [sys.executable, "-m", "pumiumtally_tpu_torch.analysis.perfdiff",
         str(ROOT / M.PERF_CONTRACTS_FILE), str(p)],
        capture_output=True, text=True, timeout=60, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert inst in proc.stdout and "registers" in proc.stdout
    assert f"{100 * 8 / regs:+.1f}%" in proc.stdout
    assert "sample_flight_kernel" not in proc.stdout  # unchanged rows hidden
    assert "1 changed value(s)" in proc.stdout


def test_perfdiff_reports_no_delta():
    path = str(ROOT / M.PERF_CONTRACTS_FILE)
    proc = subprocess.run(
        [sys.executable, "-m", "pumiumtally_tpu_torch.analysis.perfdiff",
         path, path], capture_output=True, text=True, timeout=60,
        cwd=str(ROOT))
    assert proc.returncode == 0
    assert "no per-instantiation or per-family deltas" in proc.stdout


def test_capture_reuses_the_contracts_runs():
    """The runner runs each family once at the contracts' problem: the
    cost layer's base rung takes the contracts layer's run."""
    from pumiumtally_tpu_torch.analysis.__main__ import Runs

    runs = Runs()
    cap = C.capture(("trace",), run=runs)
    first = runs.done[("trace", C._N, C._CELLS)]
    fams = M.capture_families(("trace",), run=runs)
    assert runs.done[("trace", C._N, C._CELLS)] is first
    assert len(runs.done) == 5  # the base rung shared by both axes
    assert cap["families"]["trace"] == first[0]
    assert fams["families"]["trace"]["base"]["metrics"] == first[1]


def test_family_analytic_partitioned_requires_max_local():
    kw = dict(n=16, ntet=48, n_groups=2, itemsize=4, table_bytes=0,
              records=0)
    with pytest.raises(ValueError, match="max_local"):
        M.family_analytic("partitioned", **kw)
    a = M.family_analytic("partitioned", n_parts=8, max_local=6, **kw)
    assert a["flux_bytes"] == 8 * 6 * 2 * 2 * 4
    assert a["lane_bytes"] == 8 * 16 * M.LANE_BYTES


def test_tuner_roofline_is_the_analysis_modules():
    """tuning/costmodel.py imports the roofline from analysis/costmodel.py
    (one definition), and the ptxas half imports no torch."""
    from pumiumtally_tpu_torch.tuning import costmodel as tcost

    for name in ("NOMINAL_COEFFS", "predict_seconds", "calibrate_points"):
        assert getattr(tcost, name) is getattr(M, name)
    code = ("import sys; from pumiumtally_tpu_torch.analysis import "
            "costmodel as M; M.parse_ptxas(''); M.check_cost("
            "{'sources': {}}); print('torch' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(ROOT), timeout=60)
    assert proc.stdout.strip() == "False", proc.stdout + proc.stderr
    assert isinstance(M.check_cost, types.FunctionType)
