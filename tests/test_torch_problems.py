"""The port's benchmark problems (``pumiumtally_tpu_torch/models/
problems.py``) against the JAX package's ``models/problems.py``: class
ids bit for bit, and the checks of tests/test_problems.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pumiumtally_tpu.models import problems as jproblems
from pumiumtally_tpu_torch.models import problems


@pytest.mark.parametrize("name,kw", [
    ("unit_cube", dict(cells=4)),
    ("pincell", dict(cells=8, pin_radius=0.3)),
    ("assembly", dict(cells=12, lattice=3)),
    ("assembly", dict(cells=10, lattice=4, pin_radius_frac=0.4)),
])
def test_class_ids_equal_jax(name, kw):
    got = getattr(problems, name)(device="cpu", **kw)
    want = getattr(jproblems, name)(**kw)
    np.testing.assert_array_equal(got.class_id.numpy(),
                                  np.asarray(want.class_id))
    np.testing.assert_array_equal(got.tet2vert.numpy(),
                                  np.asarray(want.tet2vert))
    assert got.ntet == want.ntet


def test_unit_cube_counts():
    m = problems.unit_cube(4, device="cpu")
    assert m.ntet == 6 * 4**3
    assert np.all(m.class_id.numpy() == 0)
    assert m.dtype == torch.float32


def test_pincell_regions():
    m = problems.pincell(8, pin_radius=0.3, dtype=torch.float64,
                         device="cpu")
    cid = m.class_id.numpy()
    assert set(np.unique(cid)) == {0, 1}
    frac = (cid == 1).mean()
    assert 0.5 * np.pi * 0.09 < frac < 1.6 * np.pi * 0.09


def test_assembly_lattice_ids():
    m = problems.assembly(cells=12, lattice=3, device="cpu")
    cid = m.class_id.numpy()
    pins = set(np.unique(cid)) - {0}
    assert pins == set(range(1, 10))
    centroids = m.centroids().numpy()
    for pid in pins:
        i, j = (pid - 1) // 3, (pid - 1) % 3
        c = centroids[cid == pid][:, :2]
        assert np.all(c[:, 0] >= i / 3 - 1e-6)
        assert np.all(c[:, 0] <= (i + 1) / 3 + 1e-6)
        assert np.all(c[:, 1] >= j / 3 - 1e-6)
        assert np.all(c[:, 1] <= (j + 1) / 3 + 1e-6)
