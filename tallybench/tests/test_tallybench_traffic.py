"""The traffic rings from a seed, and the benchmark's meshes against the
program's own generators."""
from __future__ import annotations

import json

import numpy as np
import pytest
from tb_small import ROOT, small

from tallybench import meshgen
from tallybench.drive import load
from tallybench.generator import Traffic


def mix_cfg(config, traffic="source"):
    cfg = dict(json.loads((ROOT / "tallybench" / "configs"
                           / f"{config}.json").read_text()),
               **small(config + ".source"))
    cfg["regions"] = 2
    mix = json.loads((ROOT / "tallybench" / "traffic"
                      / f"{traffic}.json").read_text())
    return mix, cfg, load(mix["drive"], ROOT / "tallybench")


@pytest.mark.parametrize("config", ["pincell-casmo8-f64",
                                    "assembly17-casmo70-f64"])
def test_rings_repeat_per_seed(config):
    mix, cfg, drive = mix_cfg(config)
    a, b, c = (Traffic(mix, cfg, s, drive) for s in (2 ** 33 + 1,
                                                     2 ** 33 + 1, 5))
    lo, hi = mix["site_box"]
    for x, y, z in zip(a.sites, b.sites, c.sites):
        assert np.array_equal(x, y) and not np.array_equal(x, z)
        assert x.shape == (cfg["particles"], 3)
        assert (x >= lo).all() and (x <= hi).all()
    assert len(a.sites) == mix["source_sites"]
    seeds = [drive.batch_seed(a, k) for k in range(9)]
    assert seeds == [drive.batch_seed(b, k) for k in range(9)]
    assert seeds != [drive.batch_seed(c, k) for k in range(9)]
    assert all(0 <= s < 2 ** 31 - 1 for s in seeds)
    assert len(a.rings["seeds"]) == mix["seeds"]
    assert drive.first(a) == dict(batch=0, site=0, seed=seeds[0], move0=0)


def test_point_source_from_data():
    """A mix whose site box has equal corners starts every lane at one
    point: a point source needs no code."""
    mix, cfg, drive = mix_cfg("pincell-casmo8-f64")
    mix = dict(mix, site_box=[[0.5, 0.25, 0.75]] * 2)
    t = Traffic(mix, cfg, 11, drive)
    for x in t.sites:
        assert (x == [0.5, 0.25, 0.75]).all()


def test_negative_and_large_seeds():
    mix, cfg, drive = mix_cfg("pincell-casmo8-f64")
    Traffic(mix, cfg, 2 ** 31 + 12345, drive)
    Traffic(mix, cfg, -3, drive)


@pytest.mark.parametrize("cells", [2, 5])
def test_box_matches_program_generator(cells):
    from pumiumtally_tpu_torch.mesh.box import build_box_arrays

    coords, tets = meshgen.box_arrays(cells)
    c2, t2 = build_box_arrays(1.0, 1.0, 1.0, cells, cells, cells)
    assert np.array_equal(coords, c2) and np.array_equal(tets, t2)


def test_regions_match_program_problems():
    import torch

    from pumiumtally_tpu_torch.models import problems

    pin = problems.pincell(cells=8, pin_radius=0.377, device="cpu",
                           dtype=torch.float64)
    _, _, cid = meshgen.build({"kind": "pincell", "cells": 8,
                               "pin_radius": 0.377})
    assert np.array_equal(cid, pin.class_id.numpy())
    asm = problems.assembly(cells=12, lattice=4, pin_radius_frac=0.377,
                            device="cpu", dtype=torch.float64)
    _, _, cid = meshgen.build({"kind": "assembly", "cells": 12, "lattice": 4,
                               "pin_radius_frac": 0.377})
    assert np.array_equal(cid, asm.class_id.numpy())


def test_candidates_hold_the_point():
    from tallybench.reference import mesh as ref_mesh

    coords, tets, cid = meshgen.build({"kind": "pincell", "cells": 4,
                                       "pin_radius": 0.3})
    import torch

    tab = ref_mesh.build(coords, tets, cid, torch.float64, "cpu")
    pts = np.random.default_rng(0).uniform(0, 1, (500, 3))
    el = ref_mesh.locate(tab, torch.as_tensor(pts),
                         torch.as_tensor(meshgen.candidates(pts, 4)))
    sd = ((tab.normals[el] * torch.as_tensor(pts)[:, None]).sum(-1)
          - tab.d[el])
    assert float(sd.max()) <= 1e-12
