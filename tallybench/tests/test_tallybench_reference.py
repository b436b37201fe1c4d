"""The reference against the port's CPU path at a small size: every cell's
small version runs end to end on the CPU and comes out correct, with its
numbers far under the limits."""
from __future__ import annotations

import pytest
from tb_small import CELLS, run_small


@pytest.mark.parametrize("workload", CELLS)
def test_small_cell_is_correct(workload):
    res = run_small(workload)
    line = res["line"]
    assert line["correct"] is True, res["nums"]
    for k, v in line["check"].items():
        assert v["value"] <= v["limit"] / 10, (k, v)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert res["segments"] > 0


def test_float64_cell_agrees_to_rounding():
    res = run_small("assembly17-casmo70-f64.source")
    assert res["nums"]["flux_l1"] < 1e-12
    assert res["nums"]["segments"] < 1e-12
