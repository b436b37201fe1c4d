"""The check fails what it must: the timed path broken underneath a run,
once for each fault the cells can have (a step that returns its state
unchanged; half of the batch left out, the other half's weight doubled so
the total stays; an answer altered where it is produced; there is one chip
a cell, so no exchange to leave out), and, on the card at the cell's own
size, the control: the reference in the precision below the
configuration's, put in the program's place."""
from __future__ import annotations

import dataclasses

import pytest
import torch
from tb_small import CELLS, run_small, small

from tallybench import check, control
from tallybench.harness import lookup


def patch_walk(monkeypatch, wrap):
    from pumiumtally_tpu_torch.ops import walk_cuda

    orig = walk_cuda.trace

    def broken(*args, **kw):
        return wrap(orig, *args, **kw)

    def install(tally):
        monkeypatch.setattr(walk_cuda, "trace", broken)

    return install


def state_unchanged(orig, mesh, origin, dest, elem, in_flight, weight,
                    group, material_id, flux, **kw):
    """The step runs, but hands back the state it was given: no lane
    moved, nothing scored."""
    r = orig(mesh, origin, dest, elem, in_flight, weight, group,
             material_id, flux.clone(), **kw)
    return dataclasses.replace(r, position=origin.clone(), elem=elem.clone(),
                               flux=flux)


def half_left_out(orig, mesh, origin, dest, elem, in_flight, weight, group,
                  material_id, flux, **kw):
    """Every odd lane left out, the even lanes' weight doubled."""
    keep = torch.zeros_like(in_flight)
    keep[0::2] = True
    return orig(mesh, origin, dest, elem, in_flight & keep, weight * 2.0,
                group, material_id, flux, **kw)


def answer_altered(orig, *args, **kw):
    """One lane's written position and one scored bin altered where the
    walk produces them."""
    r = orig(*args, **kw)
    if not kw.get("initial"):
        r.position[0, 0] += 0.01
        r.flux[0] += 0.5
    return r


FAULTS = {"state_unchanged": state_unchanged, "half_left_out": half_left_out,
          "answer_altered": answer_altered}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_comes_out_incorrect(monkeypatch, workload, fault):
    res = run_small(workload, fault=patch_walk(monkeypatch, FAULTS[fault]))
    assert res["line"]["correct"] is False, (fault, res["nums"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_gives_every_number(workload):
    """The control runs at a small size and reads every compared number."""
    rows = control.readings(workload, [], [2 ** 32 + 3], device="cpu",
                            overrides=small(workload), emit=lambda s: None)
    (side, _, nums), = rows
    assert side == "control"
    assert set(lookup(workload)["limits"]) <= set(nums)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_cell_size(workload):
    """On the card, at the cell's own size: the reference in the precision
    below the configuration's, put in the program's place, is not
    correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    rows = control.readings(workload, [], [2 ** 33 + 17], device="cuda",
                            emit=lambda s: None)
    (_, _, nums), = rows
    assert not check.verdict(nums, lookup(workload)["limits"]), nums


@pytest.mark.parametrize("workload", CELLS)
def test_program_readings_pass(workload):
    rows = control.readings(workload, [2 ** 32 + 4], [], device="cpu",
                            overrides=small(workload), emit=lambda s: None)
    (_, _, nums), = rows
    assert check.verdict(nums, lookup(workload)["limits"]), nums
