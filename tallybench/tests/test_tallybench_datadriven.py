"""A later change adds a configuration, a traffic mix, a drive, a per-layer
metric and a cell as files and entries alone; the harness finds them by
name and runs the new cell, with no existing file edited."""
from __future__ import annotations

import hashlib
import json
import shutil

import pytest
from tb_small import ROOT, run_small


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "tallybench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def tree(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "tallybench", tmp_path / "tallybench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


NEW_DRIVE = '''"""Device-sourced batches that all draw one source seed, the mix's
``seed``: the same physics draws from batch to batch, from other sites."""
from pathlib import Path

from tallybench.drive import load

base = load("source_batches", Path(__file__).resolve().parent.parent)
Driver, first, reference, compare = (base.Driver, base.first,
                                     base.reference, base.compare)
batch_seed = base.batch_seed


def draw(mix, cfg, rng):
    return {"seeds": [int(mix["seed"])]}
'''


def test_new_cell_from_files(tree):
    """A new configuration, mix, drive, metric, limits and cell, as files
    and entries alone."""
    before = digest(tree)
    here = tree / "tallybench"
    cfg = json.loads((here / "configs" / "pincell-casmo8-f64.json").read_text())
    cfg.update(name="pincell-wide", mesh=dict(cfg["mesh"], pin_radius=0.45))
    (here / "configs" / "pincell-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "source.json").read_text())
    mix.update(drive="source_one_seed", seed=12345, source_sites=2,
               site_box=[[0.3, 0.3, 0.3], [0.7, 0.7, 0.7]])
    (here / "traffic" / "one_seed.json").write_text(json.dumps(mix))
    (here / "drives" / "source_one_seed.py").write_text(NEW_DRIVE)
    (here / "limits" / "pincell-wide.one_seed.json").write_text(
        (here / "limits" / "pincell-casmo8-f64.source.json").read_text())
    (here / "metrics" / "walks.one_seed.py").write_text(
        '"""Walks in the traced window."""\n\n\n'
        "def read(ctx):\n    return float(len(ctx.walks)) or None\n")
    (here / "metrics" / "batches_per_s.py").write_text(
        '"""Whole batches a second of the window."""\n\n\n'
        "def read(ctx):\n    return ctx.batches / ctx.window_s\n")
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(
        name="pincell-wide", source="https://example.org/pincell-wide",
        file="tallybench/configs/pincell-wide.json", reduced=[],
        why="a wider pin"))
    bench["workloads"].append(dict(
        name="pincell-wide.one_seed", config="pincell-wide",
        traffic="one_seed", chips=1, why="one source seed, central sites"))
    bench["end_to_end"].insert(1, dict(
        name="batches_per_s", unit="batches/s", better="higher",
        bound=0.25, source="host_clock", workloads=["pincell-wide.one_seed"]))
    bench["per_layer"].append(dict(
        name="walks.one_seed", unit="walks", better="higher",
        source="program_counter", layer="walk wrapper",
        moves="batches_per_s", workloads=["pincell-wide.one_seed"]))
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))

    after = digest(tree)
    assert all(after[k] == v for k, v in before.items())   # nothing edited
    assert len(after) == len(before) + 6

    from tallybench import harness

    cell = harness.lookup("pincell-wide.one_seed", tree)
    assert cell["config"]["mesh"]["pin_radius"] == 0.45
    assert cell["drive"].draw(cell["mix"], cell["config"], None) == {
        "seeds": [12345]}
    assert [m["name"] for m in cell["per_layer"]] == ["walks.one_seed"]
    assert [m["name"] for m in cell["end_to_end"]] == [
        "batches_per_s", "setup_s"]
    res = run_small("pincell-wide.one_seed", root=tree, seconds=0.5)
    line = res["line"]
    assert line["correct"] is True, res["nums"]
    assert line["metrics"]["batches_per_s"]["value"] == pytest.approx(
        line["attempted"] / res["window_s"])
    res = run_small("pincell-wide.one_seed", trace=True, root=tree,
                    seconds=0.5)
    line = res["line"]
    assert line["correct"] is True, res["nums"]
    assert line["metrics"]["walks.one_seed"]["value"] >= 2   # init + moves
    assert line["attempted"] >= 1 and res["calls"] % 2 == 0


def test_unknown_drive_is_refused(tree):
    mix = json.loads((tree / "tallybench" / "traffic" / "source.json")
                     .read_text())
    mix["drive"] = "no_such_drive"
    (tree / "tallybench" / "traffic" / "source.json").write_text(
        json.dumps(mix))
    from tallybench import harness

    with pytest.raises(ValueError, match="no drive"):
        harness.lookup("pincell-casmo8-f64.source", tree)
