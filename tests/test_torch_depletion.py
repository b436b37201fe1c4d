"""The port's depletion loop (``models/depletion.py``) on
``device="cpu"``.

Mirrors tests/test_multitally_depletion.py's
``test_depletion_burns_density_down`` at a size that runs in seconds (a
two-region 3^3 box, 48 particles, three steps): both regions' densities
fall every step and their absorption rates and the total flux are
positive. Against the JAX ``DepletionLoop`` on the same inventory and
seed (float64, the twin mesh), step by step: densities, absorption rates
and total flux within the flux tolerances of tests/test_torch_transport.py
(tests/torch_twins.py TOL: rtol 1e-10, atol 1e-12), in both transport
modes.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import pumiumtally_tpu as jpt
from pumiumtally_tpu.models import depletion as jdepletion
from pumiumtally_tpu_torch import PumiTally, TallyConfig
from pumiumtally_tpu_torch.models.depletion import (
    DepletionLoop,
    DepletionStepResult,
    RegionNuclide,
)
from torch_twins import TOL, twin_meshes

N = 48
INVENTORY = {
    0: RegionNuclide(density=1.0, micro_total=3.0, micro_absorption=1.5),
    1: RegionNuclide(density=2.0, micro_total=5.0, micro_absorption=2.0),
}


@pytest.fixture(scope="module")
def meshes():
    return twin_meshes(torch.float64, nx=3, classes=(0, 1))


def _jax_inventory():
    return {r: jdepletion.RegionNuclide(i.density, i.micro_total,
                                        i.micro_absorption)
            for r, i in INVENTORY.items()}


@pytest.mark.parametrize("mode", ["host", "megastep"])
def test_depletion_burns_density_down_like_jax(meshes, mode):
    jm, pm = meshes
    t = PumiTally(pm, N, TallyConfig(n_groups=2, dtype=torch.float64,
                                     tolerance=1e-6), device="cpu")
    loop = DepletionLoop(t, copy.deepcopy(INVENTORY), dt=0.05, seed=7,
                         mode=mode)
    hist = loop.run(3)
    assert len(hist) == 3
    assert all(isinstance(h, DepletionStepResult) for h in hist)
    for rid in (0, 1):
        dens = [h.densities[rid] for h in hist]
        assert all(d2 < d1 for d1, d2 in zip(dens, dens[1:])), dens
        assert all(h.absorption_rate[rid] > 0 for h in hist)
    assert all(h.total_flux > 0 for h in hist)

    jt = jpt.PumiTally(jm, N, jpt.TallyConfig(n_groups=2, dtype=np.float64,
                                              tolerance=1e-6))
    jhist = jdepletion.DepletionLoop(jt, _jax_inventory(), dt=0.05, seed=7,
                                     mode=mode).run(3)
    _, rtol, atol = TOL[torch.float64]
    for h, jh in zip(hist, jhist):
        assert h.step == jh.step
        for rid in (0, 1):
            np.testing.assert_allclose(h.densities[rid], jh.densities[rid],
                                       rtol=rtol, atol=atol)
            np.testing.assert_allclose(h.absorption_rate[rid],
                                       jh.absorption_rate[rid], rtol=rtol,
                                       atol=atol)
        np.testing.assert_allclose(h.total_flux, jh.total_flux, rtol=rtol,
                                   atol=atol)
