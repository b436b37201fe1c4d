"""The gather/scatter probe entry point of the port
(``python -m pumiumtally_tpu_torch.probes.gather_scatter``) on the CPU.

There it runs the plain versions only, at tiny walk shapes, and marks its
JSON ``"plain": true``; no times are recorded. Its probe inputs are the
JAX probe's (``scripts/probe_pallas_gather.py``, loaded by path).
"""
from __future__ import annotations

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from pumiumtally_tpu_torch.probes import gather_scatter as gs

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "probe_pallas_gather", ROOT / "scripts" / "probe_pallas_gather.py"
)
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)


def test_probe_main_runs_plain_on_cpu(tmp_path):
    out = tmp_path / "probe.json"
    rc = gs.main(["--device", "cpu", "--walk-cells", "2", "--walk-records",
                  "4000", "--out", str(out)])
    assert rc == 0
    payload = json.loads(out.read_text())
    assert payload["plain"] is True
    assert payload["device"] == {"name": "cpu"}
    probes = payload["probes"]
    assert len(probes) == 2 + 2 * (len(gs.SCATTER_SHAPES) + 1)
    assert all(p["ok"] and p["plain"] for p in probes), probes
    assert all(p["usec_per_call"] is None and p["gbps"] is None
               for p in probes)
    kinds = [p["probe"] for p in probes]
    assert kinds.count("gather") == 2
    assert kinds.count("scatter_ordered") == len(gs.SCATTER_SHAPES) + 1
    assert probes[1]["shape"] == [48, 20, 4000]  # geo20 of a 2³ box
    assert all(p["agree"] is True for p in probes
               if p["probe"] != "scatter_atomic")


def test_probe_writes_nothing_without_out(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert gs.main(["--device", "cpu", "--walk-cells", "1",
                    "--walk-records", "100"]) == 0
    assert list(tmp_path.iterdir()) == []


def test_probe_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert gs.main([]) == 2


@pytest.mark.parametrize("B,ntet,G", list(gs.SCATTER_SHAPES))
def test_probe_inputs_are_the_jax_probes(B, ntet, G):
    assert tuple(gs.SCATTER_SHAPES) == tuple(probe.SCATTER_SHAPES)
    assert (gs.T, gs.C, gs.N) == (probe.T, probe.C, probe.N)
    elem, group, contrib, acc0 = probe._scatter_inputs(B, ntet, G)
    r = gs.probe_scatter_inputs(B, ntet, G, "cpu")
    np.testing.assert_array_equal(
        r["bin"].numpy(), np.asarray(elem) * G + np.asarray(group))
    np.testing.assert_array_equal(r["c"].numpy(), np.asarray(contrib))
    np.testing.assert_array_equal(
        r["flux"].numpy().reshape(ntet, 2 * G), np.asarray(acc0))


def test_walk_stand_in_keys_are_a_permutation():
    r = gs.walk_stand_in(30, 500, "cpu", torch.float64)
    assert sorted(r["order"].tolist()) == list(range(500))
    assert r["bin"].dtype == torch.int32 and int(r["bin"].max()) < 30
    assert r["c"].dtype == torch.float64 and r["flux"].numel() == 60
